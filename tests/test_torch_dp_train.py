"""Data-parallel PPO at four ranks on the CPU over gloo: each rank's train
state built alone (``ppo.init_train_state(mesh=)``), two sharded
iterations bitwise against the unsharded iteration and the benchmark's
plain reference learner, the all-gather counters against their formula,
and the spans of the collectives under ``profiling.trace()`` only.

The four ranks are this file run as a script, once for the module, each
joined through ``env://`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) as a launcher such as ``torchrun``
starts them; each writes what it saw to ``rank<r>.npz``.  How
``initialize()`` takes a card under NCCL is checked in this process, with
the process group's start replaced.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.parallel import distributed as DI
from marl_sortingenv_tpu_torch.parallel import fastb_shard as FS
from marl_sortingenv_tpu_torch.parallel import mesh as M
from marl_sortingenv_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
WORLD, N_ENVS, ITERATIONS = 4, 32, 2
SEED, ENV_SEED = 11, 2**31 + 5
PPO = dict(n_steps=8, batch_size=64, n_epochs=2)
SIM = dict(max_steps=8, bale_mode="events")
OBS, ACTIONS = 29, 22


def _setup():
    spec = ppo.spec_for("mono", engine="fastb")
    return load_config(**SIM), ppo.PPOConfig(**PPO), spec


def _global_state():
    cfg, pcfg, spec = _setup()
    return ppo.init_train_state(cfg, pcfg, spec, N_ENVS, seed=SEED,
                                env_seed0=ENV_SEED, device="cpu")


def gathers_per_iteration() -> int:
    return PPO["n_steps"] + 1 + len(ppo.Transition._fields) + 3


def gather_bytes_per_iteration() -> int:
    """What one rank receives in one iteration: (dp - 1) times its shard
    of each gathered leaf, bools widened to a byte."""
    T, n = PPO["n_steps"], N_ENVS // WORLD
    # per env and step: gather_rollout's Transition (obs f32, mask bool,
    # action i32, logp, value, reward f32, done bool), advantages, returns
    per_step = OBS * 4 + ACTIONS * 1 + 4 + 4 + 4 + 4 + 1 + 4 + 4
    # the obs at each of the T + 1 forwards, those, the last returns
    shard = (T + 1) * n * OBS * 4 + T * n * per_step + n * 4
    return (WORLD - 1) * shard


def _leaves(ts) -> list:
    """Every tensor of a train state, None where a leaf is unused."""
    out = []
    for x in ts:
        if isinstance(x, torch.nn.Module):
            out.extend(p.detach() for p in x.parameters())
        elif isinstance(x, tuple):
            out.extend(x)
        else:
            out.append(x)
    return out


def _rank_main(out_dir: Path) -> None:
    """One rank: what it saw, to ``out_dir / f"rank{r}.npz"``."""
    torch.set_num_threads(1)
    DI.initialize(backend="gloo", timeout=120)
    try:
        mesh = DI.global_mesh()
        cfg, pcfg, spec = _setup()
        ts = ppo.init_train_state(cfg, pcfg, spec, N_ENVS, seed=SEED,
                                  env_seed0=ENV_SEED, device="cpu",
                                  mesh=mesh)
        want = FS.shard_train_state(mesh, _global_state())
        leaves_equal = [
            (a is None and b is None) or (a.dtype == b.dtype
                                          and torch.equal(a, b))
            for a, b in zip(_leaves(ts), _leaves(want))]
        it = ppo.make_train_iteration(cfg, pcfg, spec, mesh=mesh)
        g0, b0 = M.GATHERS, M.GATHER_BYTES
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                ts, stats = it(ts)
        traced = profiling.spans()
        g1, b1 = M.GATHERS, M.GATHER_BYTES
        ts, stats = it(ts)                     # outside any session
        names = [r.name for r in traced]
        np.savez(
            out_dir / f"rank{dist.get_rank()}.npz",
            leaves_equal=leaves_equal,
            params=ppo.flat_parameters(ts.params).detach().numpy(),
            **{f"stat_{k}": v.numpy() for k, v in stats.items()},
            gathers=np.array([g1 - g0, M.GATHERS - g1]),
            gather_bytes=np.array([b1 - b0, M.GATHER_BYTES - b1]),
            span_gathers=names.count("dp.all_gather"),
            span_gather_bytes=sum(r.attrs["bytes"] for r in traced
                                  if r.name == "dp.all_gather"),
            span_learner_gather=names.count("learner.gather"),
            gathers_inside_learner_gather=sum(
                1 for r in traced if r.name == "dp.all_gather"
                and traced[r.parent].name == "learner.gather"),
            records_after=len(profiling.spans()) - len(traced))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list:
    out = tmp_path_factory.mktemp("dp4")
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    got = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as d:
            got.append({k: d[k] for k in d.files})
    return got


def test_sharded_state_is_the_shard_of_the_global_state(ranks):
    n = len(_leaves(_global_state()))
    for r, got in enumerate(ranks):
        assert got["leaves_equal"].tolist() == [True] * n, r


def _unsharded():
    cfg, pcfg, spec = _setup()
    it, ts = ppo.make_train_iteration(cfg, pcfg, spec), _global_state()
    for _ in range(ITERATIONS):
        ts, stats = it(ts)
    return ppo.flat_parameters(ts.params).detach(), stats


def _reference():
    from portbench.reference import config as RC
    from portbench.reference import learner as RL
    cfg, pcfg = RC.load_config(**SIM), RL.PPOConfig(**PPO)
    spec = RL.spec_for("mono")
    ts = RL.init_train_state(cfg, pcfg, spec, N_ENVS, seed=SEED,
                             env_seed0=ENV_SEED, device="cpu")
    it = RL.make_train_iteration(cfg, pcfg, spec)
    for _ in range(ITERATIONS):
        ts, stats = it(ts)
    return RL.flat_parameters(ts.params).detach(), stats


@pytest.mark.parametrize("against", ["unsharded", "reference"])
def test_iterations_bitwise(ranks, against):
    params, stats = {"unsharded": _unsharded,
                     "reference": _reference}[against]()
    for r, got in enumerate(ranks):
        assert np.array_equal(got["params"], params.numpy()), r
        for k in ("loss", "policy_loss", "value_loss", "entropy",
                  "approx_kl", "clip_frac"):
            assert np.array_equal(got[f"stat_{k}"], stats[k].numpy()), (r, k)
    # the episodes end inside the rollouts (max_steps == n_steps)
    assert float(ranks[0]["stat_mean_episode_return"]) != 0.0


def test_gather_counters_follow_their_formula(ranks):
    for got in ranks:
        assert got["gathers"].tolist() == [gathers_per_iteration()] * 2
        assert got["gather_bytes"].tolist() == \
            [gather_bytes_per_iteration()] * 2


def test_collective_spans_under_trace_only(ranks):
    for got in ranks:
        assert int(got["span_gathers"]) == gathers_per_iteration()
        assert int(got["span_gather_bytes"]) == gather_bytes_per_iteration()
        assert int(got["span_learner_gather"]) == 1
        assert int(got["gathers_inside_learner_gather"]) == \
            len(ppo.Transition._fields) + 3
        assert int(got["records_after"]) == 0


def test_one_rank_gathers_nothing(monkeypatch):
    """Over one dp rank ``all_gather_dp`` returns its input, counts
    nothing and opens no span."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        dist.destroy_process_group()
    DI.initialize(backend="gloo")
    try:
        mesh = DI.global_mesh()
        x = torch.arange(6)
        g0, b0 = M.GATHERS, M.GATHER_BYTES
        with torch.profiler.profile():
            assert M.all_gather_dp(mesh, x, 0) is x
        assert (M.GATHERS, M.GATHER_BYTES) == (g0, b0)
        assert profiling.spans() == []
    finally:
        dist.destroy_process_group()


def test_sharded_state_needs_fastb():
    cfg, pcfg, _ = _setup()
    with pytest.raises(ValueError, match="fastb"):
        ppo.init_train_state(cfg, pcfg, ppo.spec_for("mono"), 8,
                             device="cpu", mesh=object())


@pytest.mark.parametrize("case", [
    # (environment, coordinator's process id, backend, card taken)
    ({"RANK": "2", "LOCAL_RANK": "1"}, None, "nccl", 1),
    ({"RANK": "6"}, None, "nccl", 2),
    ({}, 3, "nccl", 3),
    ({"RANK": "2", "LOCAL_RANK": "1"}, None, "gloo", None),
])
def test_initialize_takes_the_card_under_nccl(monkeypatch, case):
    """Under NCCL the process takes the card of ``LOCAL_RANK``, else of
    its rank modulo the cards (4 here), before the group starts; gloo
    takes none.  The timeout reaches the group as a timedelta."""
    env, process_id, backend, card = case
    for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if env:
        monkeypatch.setenv("WORLD_SIZE", "8")
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", a, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("card", d)))
    if process_id is None:
        DI.initialize(backend=backend, timeout=30)
    else:
        DI.initialize("localhost:1", 8, process_id, backend=backend,
                      timeout=30)
    taken = [c[1] for c in calls if c[0] == "card"]
    assert taken == ([] if card is None else [card])
    assert calls[-1][0] == "init" and calls[-1][1] == (backend,)
    assert calls[-1][2]["timeout"] == datetime.timedelta(seconds=30)


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
