"""Every cell runs end to end on the CPU at a tiny size, untraced and
traced, and comes out correct; each fault its driver can have, planted in
the program underneath, makes it come out not correct."""

import pytest

from portbench import faults as F

CELLS = {"train_mono.plant_paper": "train",
         "eval_5policy.plant_noise05": "eval_protocol",
         "gym_mono.plant_paper": "gym_loop"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(tiny, run_cpu, workload, trace):
    res = run_cpu(tiny, workload, trace=bool(trace))
    assert res["correct"], res["checks"]
    assert list(res)[0] == "correct" and list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, kind in sorted(CELLS.items()) for f in F.FAULTS[kind]])
def test_fault_is_caught(tiny, run_cpu, workload, fault):
    with F.FAULTS[CELLS[workload]][fault]():
        res = run_cpu(tiny, workload)
    assert not res["correct"], res["checks"]


def test_gym_control_is_caught(tiny):
    """The float32 parity engine, in the program's place, departs from the
    float64 reference (the train and eval cells' TF32 control needs the
    card: ``test_portbench_control.py``)."""
    from portbench.lib import bench
    from portbench.lib.cell import Context
    from portbench.traffic import gym_loop
    cell = bench.load_cell(tiny, "gym_mono.plant_paper")
    drv = gym_loop.Driver(Context(cell, 5, "cpu", False))
    drv.setup()
    drv.window(0.3)
    assert sum(drv.replay(e) for e in drv.episodes) == 0
    assert sum(drv.replay(e, float64=False) for e in drv.episodes) > 0


@pytest.mark.parametrize("step", ["step_mono_random", "step_mono_rule",
                                  "step_mono_model", "step_mono_external"])
def test_eval_holds_every_policy(tiny, run_cpu, step):
    """An observation altered in one policy's step alone (Random,
    Rule-Based, the two modular agents, Monolith) makes every run of the
    evaluation cell not correct, whatever it draws."""
    from marl_sortingenv_tpu_torch.core import fastb as FB

    def make(fn):
        def stepped(*a, **kw):
            st, out = fn(*a, **kw)
            obs = out.obs.clone()
            obs[:, 0] += 1.0
            return st, out._replace(obs=obs)
        return stepped
    for seed in (11, 2**32 + 5):
        with F._patched(FB, step, make):
            res = run_cpu(tiny, "eval_5policy.plant_noise05", seed=seed)
        assert res["checks"]["steps_apart"]["value"] > 0, res["checks"]
        assert not res["correct"]
