"""The modular flow's press stage: PPO for the press agent against a frozen
sort agent (``ppo.spec_for("press", engine="fastb")`` with the agent
handed to ``make_train_iteration``), held to the benchmark's plain
reference (``portbench/reference/learner.py``) on the CPU.

Both agents take seeded random weights.  Three iterations at 64 envs ×
8 steps, minibatches of 128, 2 epochs, across the end of 10-step episodes:
each loss, Adam's first moment after the first iteration and the
parameters after the last are bit for bit the reference's.  Two faults
that only this path can have, the sorter set by its rules instead of by
the frozen agent and the agent's output bias shifted so that its argmax
changes for some envs, each exceed the ``train_press`` cell's limits
(``portbench.traffic.train.compare``).  The cell itself loads through the
benchmark's own lookup, finds its agent and its six metric readers, and
runs end to end on the CPU at a tiny size, correct.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import time
from pathlib import Path

import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as FB
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.models import mlp

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
CELL = "train_press.plant_paper"
N, SEED, ENV_SEED, SORT_KEY = 64, 7, 2**31 + 3, (0, 2024)
PPO = dict(n_steps=8, batch_size=128, n_epochs=2, shuffle_block=8)
ITERATIONS = 3
NEW_METRICS = ("learner.rollout_graph_share.train_press",
               "learner.eager_reset_share.train_press",
               "kernels_per_env_step.train_press",
               "sort_material_roofline.train_press",
               "idle_share.train_press", "mfu.train_press")

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


def _sim() -> dict:
    conf = json.loads((PB / "configs" / "plant_paper.json").read_text())
    return {**conf["sim"], "max_steps": 10}


def _limits() -> dict:
    return json.loads((PB / "traffic" / "train_press.json").read_text()
                      )["limits"]


def _sort_agent():
    return mlp.init_params(SORT_KEY, 13, 2, device="cpu"
                           ).requires_grad_(False)


def _program(sort):
    """The port's Record of the first iterations, with ``sort`` frozen."""
    from portbench.traffic.train import first_iterations
    cfg, pcfg = load_config(**_sim()), ppo.PPOConfig(**PPO)
    spec = ppo.spec_for("press", engine="fastb")
    ts = ppo.init_train_state(cfg, pcfg, spec, N, seed=SEED,
                              env_seed0=ENV_SEED, device="cpu")
    it = ppo.make_train_iteration(cfg, pcfg, spec, sort)
    return first_iterations(it, ts, ITERATIONS)[1]


def _reference():
    from portbench.reference import config as RC
    from portbench.reference import learner as RL
    from portbench.reference import mlp as RM
    from portbench.traffic.train import first_iterations
    sort = RM.init_params(SORT_KEY, 13, 2, device="cpu").requires_grad_(False)
    for a, b in zip(sort.parameters(), _sort_agent().parameters()):
        assert torch.equal(a, b)
    cfg, pcfg = RC.load_config(**_sim()), RL.PPOConfig(**PPO)
    spec = RL.spec_for("press")
    ts = RL.init_train_state(cfg, pcfg, spec, N, seed=SEED,
                             env_seed0=ENV_SEED, device="cpu")
    it = RL.make_train_iteration(cfg, pcfg, spec, sort)
    return first_iterations(it, ts, ITERATIONS)[1]


@pytest.fixture(scope="module")
def reference():
    return _reference()


def test_press_iteration_equals_the_reference(reference):
    prog = _program(_sort_agent())
    assert prog.losses == reference.losses
    assert torch.equal(prog.mu1, reference.mu1)
    assert torch.equal(prog.p0, reference.p0)
    assert torch.equal(prog.p_end, reference.p_end)
    assert not torch.equal(prog.p0, prog.p_end)


def _rule_sorter():
    """The sorter set by its rules, the frozen agent ignored."""
    sort = _sort_agent()

    def mode(cfg, st, sort_policy):
        return FB._sorting_rules(st)
    return sort, mode, None


def _shifted_bias():
    """The frozen agent's output bias shifted by the spread of its logit
    gaps over the first sort observations, so that its argmax changes for
    some envs and not for others."""
    sound = _sort_agent()
    cfg = load_config(**_sim())
    st = FB.reset_batch(cfg, ENV_SEED, N, device="cpu")
    gaps = []
    for _ in range(6):
        st, _ = FB.step_press(cfg, st, torch.zeros(N, dtype=torch.int32),
                              sound)
        lg = sound.policy_logits(FB.get_sort_obs(cfg, st))
        gaps.append(lg[:, 1] - lg[:, 0])
    gaps = torch.cat(gaps)
    bad = copy.deepcopy(sound)
    with torch.no_grad():
        bad.action_net.bias[0] += float(gaps.median())
    flips = {"steps": 0, "changed": 0}
    real = FB.frozen_sort_mode

    def mode(cfg, st, sort_policy):
        got = real(cfg, st, sort_policy)
        flips["steps"] += got.numel()
        flips["changed"] += int((got != real(cfg, st, sound)).sum())
        return got
    return bad, mode, flips


@pytest.mark.parametrize("fault", [_rule_sorter, _shifted_bias])
def test_press_fault_exceeds_the_cell_limits(fault, reference, monkeypatch):
    from portbench.traffic.train import compare
    sort, mode, flips = fault()
    monkeypatch.setattr(FB, "frozen_sort_mode", mode)
    checks = compare(_program(sort), reference, _limits())
    assert any(not c.ok for c in checks), [(c.name, c.value)
                                          for c in checks]
    if flips is not None:
        assert 0 < flips["changed"] < flips["steps"], flips


# -- the cell ---------------------------------------------------------------

def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_press_cell_layout():
    """The cell loads through the benchmark's lookup with the learner
    shapes of ``train_mono``, its ``sort_agent`` names an agent file of the
    configuration, and each new metric's file exposes ``read`` and is
    listed for this cell alone."""
    from portbench.lib import bench
    from portbench.lib.cell import Context
    cell = bench.load_cell(ROOT, CELL)
    p = cell.traffic
    assert cell.chips == 1 and cell.config_name == "plant_paper_modular"
    assert (p["driver"], p["variant"], p["sort_agent"]) == ("train", "press",
                                                            "sort")
    mono = json.loads((PB / "traffic" / "train_mono.json").read_text())
    assert {k: v for k, v in p.items() if k not in ("variant", "sort_agent")
            } == {k: v for k, v in mono.items()
                  if k not in ("variant", "sort_agent")}
    path = Path(Context(cell, 0, "cpu", False).agent_path(p["sort_agent"]))
    assert path.is_file() and path.suffix == ".npz"
    agent = mlp.load_npz(str(path), device="cpu")
    assert (agent.obs_dim, agent.n_actions) == (13, 2)
    per_layer = {m["name"]: m for m in cell.per_layer}
    assert "train_samples_per_s" in {m["name"] for m in cell.end_to_end}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [CELL], name
        read = bench.metric_reader(cell, name)
        assert callable(read), name


@pytest.mark.parametrize("key", ["sim", "policy", "agents", "precision"])
def test_modular_configuration_runs_the_paper_plant(key):
    """The modular stage's configuration is ``plant_paper``'s plant, policy,
    agents and precision unchanged; it adds only the stage it trains (press)
    and the agent it holds frozen (sort), which the cell's mix names."""
    from portbench.lib import bench
    cell = bench.load_cell(ROOT, CELL)
    paper = json.loads((PB / "configs" / "plant_paper.json").read_text())
    assert cell.config[key] == paper[key]
    stage = cell.config["stage"]
    assert (stage["trained"], stage["frozen"]) == (cell.traffic["variant"],
                                                   [cell.traffic["sort_agent"]])


def _tiny_root(tmp: Path) -> Path:
    tiny = _load(PB / "tests" / "conftest.py", "portbench_tests_conftest")
    root = tiny.tiny_root(tmp)
    f = root / "portbench" / "traffic" / "train_press.json"
    f.write_text(json.dumps({**json.loads(f.read_text()),
                             **tiny.TINY["train_mono"]}))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_train_press_cell_runs_correct_on_the_cpu(tmp_path, trace):
    """One run of the cell at a tiny size on the CPU comes out correct
    with every gap 0; traced, the rollout is the eager loop (graph share
    0, no graph spans to read a reset from) and the host-clock share is
    finite."""
    from portbench.lib import cell
    res = cell.run(_tiny_root(tmp_path), CELL, 2**33 + 11, 0.3, bool(trace),
                   time.perf_counter(), device="cpu")
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    metrics = res["metrics"]
    if not trace:
        assert set(metrics) == {"train_samples_per_s", "setup_s"}
        return
    assert metrics["learner.rollout_graph_share.train_press"]["value"] == 0
    assert "learner.eager_reset_share.train_press" not in metrics
    assert math.isfinite(metrics["mfu.train_press"]["value"])
