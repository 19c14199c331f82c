"""The port's spans (``utils/profiling.py``): off without a profiler, nested
records under one, a clock shared with the profiler's events, the Chrome
trace and the idle time by span of ``trace()``, and the spans of the
learner, the step dispatch, the evaluation and the Gym step with the
benchmark's readers of them, at the benchmark's tiny sizes
(``portbench/tests/conftest.py::TINY``).

On the card (marker ``cuda``): spans never reach the device's timeline,
and each kernel-1 launch lies inside its span (``rollout.graph`` around a
replayed rollout step, ``step_mono.launch`` around an eager one).  This
file imports no JAX; on the card:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest \
        -o addopts="" -q
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from marl_sortingenv_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"


def _names(records) -> set:
    return {r.name for r in records}


def test_span_is_off_without_a_profiler():
    with torch.profiler.profile():
        with P.span("kept"):
            pass
    before = P.spans()
    s = P.span("not_recorded", k=1)
    assert s is P.span("other") is P._NO_SPAN
    with s:
        with P.span("inner"):
            pass
    assert [r.name for r in P.spans()] == [r.name for r in before] == ["kept"]


def test_nested_spans_parents_counts_self_times():
    x = torch.randn(16, 16)
    with torch.profiler.profile():
        with P.span("outer", k=3):
            for _ in range(2):
                with P.span("mid"):
                    with P.span("leaf"):
                        x @ x
            x.sum()
        with P.span("outer"):
            pass
    recs = P.spans()
    assert [r.name for r in recs] == ["outer", "mid", "leaf", "mid", "leaf",
                                      "outer"]
    assert [r.parent for r in recs] == [None, 0, 1, 0, 3, None]
    assert recs[0].attrs == {"k": 3} and recs[5].attrs == {}
    assert all(r.start_ns <= r.end_ns for r in recs)
    dur = [r.end_ns - r.start_ns for r in recs]
    s = P.summary()
    assert {k: v["count"] for k, v in s.items()} == {"outer": 2, "mid": 2,
                                                      "leaf": 2}
    assert s["leaf"]["self_us"] == s["leaf"]["mean_us"]
    assert math.isclose(s["mid"]["self_us"] * 2e3,
                        dur[1] + dur[3] - dur[2] - dur[4])
    assert math.isclose(s["outer"]["self_us"] * 2e3,
                        dur[0] + dur[5] - dur[1] - dur[3])
    assert math.isclose(s["outer"]["mean_us"] * 2e3, dur[0] + dur[5])
    # a new session starts the list afresh
    with torch.profiler.profile():
        pass
    assert P.spans() == [] and P.summary() == {}


def test_recording_keeps_nothing_for_the_collector():
    """Spans recorded under the profiler leave no new object for Python's
    garbage collector to count: a kept object per span would bring on
    collections of the whole heap in a long profiled slice."""
    import gc
    with torch.profiler.profile():
        gc.disable()
        try:
            before = gc.get_count()[0]
            for i in range(2000):
                with P.span("outer", policy="Random"):
                    with P.span("inner"):
                        pass
            kept = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert len(P.spans()) == 4000 and kept < 100, kept


def test_spans_share_the_profilers_clock():
    """A span around three aten ops, on the profiler's time base, brackets
    their events at both ends within 50 us (best of five sessions, after
    one to warm the profiler)."""
    x = torch.randn(32, 32)
    gaps = []
    for _ in range(6):
        with torch.profiler.profile() as prof:
            x.sum()
            with P.span("ops"):
                y = torch.add(x, 1)
                y = torch.mul(y, 2)
                torch.neg(y)
            x.sum()
        base = prof.profiler.kineto_results.trace_start_ns()
        (rec,) = P.spans()
        ops = [e for e in prof.events() if e.name in
               ("aten::add", "aten::mul", "aten::neg")]
        assert len(ops) == 3
        first = min(e.time_range.start for e in ops)
        last = max(e.time_range.end for e in ops)
        gaps.append((first - P.trace_us(rec.start_ns, base),
                     P.trace_us(rec.end_ns, base) - last))
    assert any(0 <= a <= 50 and 0 <= b <= 50 for a, b in gaps[1:]), gaps


def test_idle_by_span_splits_the_idle_time():
    """Device intervals and nested spans on one clock: each idle stretch
    goes to the innermost span open over it."""
    def rec(name, s, e, parent=None):
        return P.Record(name, s, e, parent, {})
    recs = [rec("a", 10, 60), rec("b", 20, 40, 0), rec("c", 70, 90)]
    busy = [(0, 15), (30, 35), (38, 50), (85, 120)]
    out = P.idle_by_span(busy, recs, 0, 100)
    got = {k: round(v * 1e9) for k, v in out.items()}
    # idle: 15-30 (a 15-20, b 20-30), 35-38 (b), 50-85 (a 50-60,
    # outside 60-70, c 70-85)
    assert got == {"a": 15, "b": 13, P.OUTSIDE: 10, "c": 15}
    assert sum(got.values()) == 100 - 15 - 5 - 12 - 15


def test_trace_writes_the_spans_and_idle_by_span(tmp_path):
    x = torch.randn(64, 64)
    with P.trace(str(tmp_path)) as tr:
        with P.span("work", n=2):
            with P.span("half"):
                x @ x
            x @ x
    doc = json.loads(Path(tr.path).read_text())
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in mine) == ["half", "work"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in mine)
    assert [e["args"] for e in mine if e["name"] == "work"] == [
        {"parent": None, "n": 2}]
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm"]
    work = next(e for e in mine if e["name"] == "work")
    assert len(ops) == 2 and all(
        work["ts"] <= e["ts"] and e["ts"] + e["dur"] <= work["ts"]
        + work["dur"] for e in ops)
    # no card here: the whole block is idle
    assert set(tr.idle_s) <= {"work", "half", P.OUTSIDE}
    assert math.isclose(sum(tr.idle_s.values()), tr.window_s)


# -- the program's spans at the benchmark's tiny sizes ----------------------

def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(mix: str) -> dict:
    tiny = _load(PB / "tests" / "conftest.py", "portbench_tests_conftest")
    p = json.loads((PB / "traffic" / f"{mix}.json").read_text())
    return {**p, **tiny.TINY[mix]}


def _sim(config: str) -> dict:
    return json.loads((PB / "configs" / f"{config}.json").read_text())


def _train(device="cpu"):
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.learn import ppo
    p = _tiny("train_mono")
    cfg = load_config(**_sim("plant_paper")["sim"])
    pcfg = ppo.PPOConfig(n_steps=p["n_steps"], batch_size=p["batch_size"],
                         n_epochs=p["n_epochs"],
                         shuffle_block=p["shuffle_block"])
    spec = ppo.spec_for("mono", engine="fastb")
    ts = ppo.init_train_state(cfg, pcfg, spec, p["n_envs"], seed=3,
                              device=device)
    it = ppo.make_train_iteration(cfg, pcfg, spec)
    return lambda: it(ts)


def _eval(device="cpu", steps=2):
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.eval import harness
    from marl_sortingenv_tpu_torch.models import mlp
    p, conf = _tiny("eval_5policy"), _sim("plant_noise05")
    cfg = load_config(**conf["sim"])
    agents = [mlp.load_npz(str(ROOT / conf["agents"][a]), device=device)
              for a in ("sort", "press", "mono")]

    def run():
        for policy in p["policies"]:
            gen = harness.policy_steps(cfg, policy, "fastb", p["episodes"],
                                       p["steps"], *agents, p["masked"], 5,
                                       device)
            for _ in range(steps):
                next(gen)
            gen.close()
    return run


def _gym(device="cpu", steps=4):
    import numpy as np

    from marl_sortingenv_tpu_torch import envs
    s = _sim("plant_paper")["sim"]
    env = envs.Env_3_Monolith(max_steps=s["max_steps"], seed=7,
                              noise_sorting=s["noise_sorting"],
                              balesize=s["balesize"], device=device)
    rng = np.random.default_rng(7)

    def run():
        env.reset(seed=7)
        for _ in range(steps):
            a = int(rng.choice(np.flatnonzero(env.action_masks())))
            env.step(a)
    return run


def _reader(metric: str):
    return _load(PB / "metrics" / f"{metric}.py",
                 "reader_" + metric.replace(".", "_")).read


CASES = {
    "train": (_train, {"learner.iteration", "learner.rollout",
                       "rollout.policy", "rollout.env", "learner.gae",
                       "learner.update", "update.loss", "update.backward",
                       "update.optim", "fastb.eager"},
              ["learner.rollout_policy_us", "learner.rollout_env_us",
               "learner.update_loss_us", "learner.update_backward_us",
               "learner.update_optim_us"],
              ["dispatch.step_mono_host_us.train"]),
    "eval": (_eval, {"eval.step", "fastb.eager"},
             ["dispatch.eager_body_ms.eval",
              "dispatch.kernel_step_share.eval"],
             ["dispatch.sort_material_host_us.eval"]),
    "gym": (_gym, {"env.step", "env.engine", "env.action_masks",
                   "rng.host_read"},
            ["gym.engine_ms", "gym.read_wait_ms"], []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_cpu_step_records_every_span(case):
    """One traced step of each entry point on the CPU records its spans
    (the launch spans are the card's); each new reader reads a finite
    number from them, the launch readers None."""
    make, names, finite, card_only = CASES[case]
    run = make()
    with torch.profiler.profile():
        run()
    recs = P.spans()
    assert names <= _names(recs), names - _names(recs)
    assert not {"step_mono.launch", "sort_material.launch"} & _names(recs)
    for r in recs:
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    for metric in finite:
        v = _reader(metric)(None)
        assert v is not None and math.isfinite(v), metric
    for metric in card_only:
        assert _reader(metric)(None) is None, metric
    if case == "eval":
        bodies = {r.attrs["body"] for r in recs if r.name == "fastb.eager"}
        assert bodies == {"random", "model", "rule", "external"}
        policies = [r.attrs["policy"] for r in recs if r.name == "eval.step"]
        assert len(policies) == 10 and len(set(policies)) == 5


def test_rollout_graph_share_reader():
    """``learner.rollout_graph_share.train`` reads 0 on the CPU's eager
    rollout, 100 where every step is a ``rollout.graph`` span, and None
    where the slice recorded no rollout step."""
    read = _reader("learner.rollout_graph_share.train")
    run = _train()
    with torch.profiler.profile():
        run()
    assert read(None) == 0.0
    with torch.profiler.profile():
        for _ in range(3):
            with P.span("rollout.graph", variant="mono", batch=4):
                pass
    assert read(None) == 100.0
    with torch.profiler.profile():
        torch.zeros(2).sum()
    assert read(None) is None


def test_update_graph_share_reader():
    """``learner.update_graph_share.train`` reads 0 on the CPU's eager
    update, 100 where every minibatch is an ``update.graph`` span, and None
    where the slice recorded no minibatch."""
    read = _reader("learner.update_graph_share.train")
    run = _train()
    with torch.profiler.profile():
        run()
    assert read(None) == 0.0
    with torch.profiler.profile():
        for _ in range(3):
            with P.span("update.graph", batch=4):
                pass
    assert read(None) == 100.0
    with torch.profiler.profile():
        torch.zeros(2).sum()
    assert read(None) is None


def test_replayed_step_records_one_graph_span(monkeypatch):
    """A graphed step (``fastb.GraphedStep``) records one ``fastb.eager``
    span per replay, with its body and ``graph=True``, counts the replay
    and the kernel launches its capture recorded, and hands out outputs of
    their own.  Without a card the graph here replays nothing: its capture
    (``graphs.capture``) runs the step once, eagerly, outside the
    profiler."""
    from types import SimpleNamespace

    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import fastb as FB
    from marl_sortingenv_tpu_torch.ops import graphs, sort_cuda

    monkeypatch.setattr(graphs, "capture", lambda device, run: (
        SimpleNamespace(replay=lambda: None), run(), [0, 1, 0]))
    cfg = load_config(**_sim("plant_noise05")["sim"])
    st = FB.reset_batch(cfg, 3, 4, device="cpu")
    g = FB.GraphedStep(cfg, FB.step_mono_random, (True,), st, "random")
    replays, launches = graphs.REPLAYS, sort_cuda.LAUNCHES
    with torch.profiler.profile():
        with g.loaded(st):
            assert g.busy
            out = g.step()
    assert not g.busy
    (rec,) = P.spans()
    assert rec.name == "fastb.eager"
    assert rec.attrs == {"body": "random", "graph": True}
    assert graphs.REPLAYS == replays + 1
    assert sort_cuda.LAUNCHES == launches + 1
    for a, b in zip(out, g.graph.out):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _device_events(run) -> int:
    """Events on the device's timeline of one profiled ``run()``, the more
    of two profiles (the profiler on the card can drop a trace's kernel
    events now and then)."""
    counts = []
    for _ in range(2):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        counts.append(sum(
            1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA))
    return max(counts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["train", "eval"])
def test_cuda_spans_leave_the_device_timeline(cuda, case, monkeypatch):
    """One train iteration, and one step of each policy, put as many
    events on the device's timeline with the program's spans as with
    ``span`` forced to the no-op."""
    run = _train(cuda) if case == "train" else _eval(cuda, steps=1)
    run()
    torch.cuda.synchronize()
    with_spans = _device_events(run)
    assert P.spans()
    with monkeypatch.context() as m:
        m.setattr(P, "span", lambda name, **attrs: P._NO_SPAN)
        without = _device_events(run)
        assert P.spans() == []
    assert with_spans == without > 0


@pytest.mark.cuda
def test_cuda_launches_lie_inside_their_spans(cuda, tmp_path, monkeypatch):
    """Every host launch call of kernel 1 in a train iteration's Chrome
    trace lies inside its span: a ``rollout.graph`` span around the graph
    launch of each replayed rollout step, and, with the rollout stepped
    eagerly, a ``step_mono.launch`` span around each kernel launch."""
    from marl_sortingenv_tpu_torch.learn import ppo

    def launches_in(span, graphed):
        run = _train(cuda)
        run()
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(ppo, "graphed_rollout", lambda *a, **kw: None)
            with P.trace(str(tmp_path / span)) as tr:
                run()
        doc = json.loads(Path(tr.path).read_text())
        ev = doc["traceEvents"]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                       if e.get("cat") == "program_span"
                       and e["name"] == span)
        kernels = {e["args"]["correlation"] for e in ev
                   if e.get("cat") == "kernel" and "step_mono" in e["name"]}
        launches = [e for e in ev if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
                    and e["args"].get("correlation") in kernels]
        assert len(spans) == len(launches) == _tiny("train_mono")["n_steps"]
        for e in launches:
            assert any(s <= e["ts"] and e["ts"] + e["dur"] <= t
                       for s, t in spans), e
        return {e["name"] for e in launches}
    assert launches_in("rollout.graph", True) == {"cudaGraphLaunch"}
    assert "cudaGraphLaunch" not in launches_in("step_mono.launch", False)
