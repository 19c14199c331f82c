"""The learner's graphed rollout (``learn/ppo.py``: ``graphed_rollout``,
``GraphedRollout``, through ``ops/graphs.py``) and the device-key draws it
reads its keys through
(``core/threefry.py``: ``split_chain``, ``random_bits_at``,
``categorical_at``).

On the CPU: ``collect_rollout`` never graphs there, on ``fastb`` or on the
parity engine; the device-key draws equal the host-key draws bit for bit,
and ``split_chain`` the learner's chain of ``split_key`` calls;
and ``GraphedRollout`` itself, with a stand-in for ``graphs.capture``
whose replay runs the captured step again, gives every output of four
rollouts bit for bit as the eager loop does, and ``collect_rollout``
replays the press step with the frozen sort agent bit for bit through
it, its spans naming the agent and the eager reset.  On the card (marker
``cuda``): graphed and eager rollouts are bitwise equal over four rollouts
of 64 steps (mono masked and unmasked, sort, press with the frozen sort
agent), a second rollout only replays, TF32 keys a graph of its own, the
train state stays a value,
kernel 1 counts one launch a step, a traced rollout records one
``rollout.graph`` span a step, and a rollout on a world-1 mesh never
graphs.  This file imports no JAX; on the card:

    python -m pytest tests/test_torch_graphed_rollout.py -m cuda \
        --noconftest -o addopts="" -q
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import threefry as TF
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.ops import graphs
from marl_sortingenv_tpu_torch.utils import profiling as P

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SORT_NPZ = ROOT / "artifacts" / "models_tuned" / "PPO_Sorting_Tuned_100000.npz"
# (variant, masking): the rollouts a train state of each variant takes
CASES = [("mono", True), ("mono", False), ("sort", True), ("press", True)]
# (frozen agents, autoreset) the rollout step of each variant carries: mono
# takes kernel 1's fused reset, the others ``with_autoreset``'s
STEP_TAGS = {"mono": (0, "kernel"), "sort": (0, "eager"),
             "press": (1, "eager")}


def _cfg():
    conf = json.loads((ROOT / "portbench" / "configs" / "plant_paper.json")
                      .read_text())
    return load_config(**conf["sim"])


def _setup(name, masked, n, T, device, cfg=None):
    """(cfg, pcfg, spec, step_fn, ts) of one variant; press trains against
    the tuned sort agent."""
    cfg = cfg or _cfg()
    pcfg = ppo.PPOConfig(n_steps=T, batch_size=n * T // 4, n_epochs=2,
                         shuffle_block=min(128, n))
    spec = ppo.spec_for(name, "fastb")
    sp = (mlp.load_npz(str(SORT_NPZ), device=device).requires_grad_(False)
          if name == "press" else None)
    ts = ppo.init_train_state(cfg, pcfg, spec, n, seed=5, env_seed0=3,
                              device=device)
    return cfg, pcfg, spec, spec.step_fn(sp, masked), ts


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (floats as ints, so -0.0 is not 0.0)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


def _assert_rollouts_equal(got, want):
    """Every transition leaf, the last values, and every leaf of the train
    state after the rollout (env state, obs, key, accumulators), bitwise."""
    (ts_g, trs_g, lv_g), (ts_e, trs_e, lv_e) = got, want
    for name, a, b in zip(ppo.Transition._fields, trs_g, trs_e):
        _same(a, b, f"transition {name}")
    _same(lv_g, lv_e, "last_value")
    for name in ("obs", "key", "ep_return_acc", "last_ep_return"):
        _same(getattr(ts_g, name), getattr(ts_e, name), name)
    for name, a, b in zip(ts_e.env_state._fields, ts_g.env_state,
                          ts_e.env_state):
        assert (a is None) == (b is None), name
        if a is not None:
            _same(a, b, f"env_state.{name}")


def _counts():
    return graphs.CAPTURES, graphs.REPLAYS


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("engine", ["fastb", "parity"])
def test_cpu_rollout_never_graphs(engine):
    """On the CPU every rollout step is the eager loop's: no capture, no
    replay, and one ``rollout.policy`` and one ``rollout.env`` span a
    step."""
    cfg = load_config(max_steps=20)
    pcfg = ppo.PPOConfig(n_steps=3, batch_size=12, n_epochs=1)
    spec = ppo.spec_for("mono", engine)
    ts = ppo.init_train_state(cfg, pcfg, spec, 4, device="cpu")
    before = _counts()
    with torch.profiler.profile():
        ppo.collect_rollout(cfg, pcfg, spec, ts, spec.step_fn(None, True))
    names = [r.name for r in P.spans()]
    assert names.count("rollout.policy") == 3
    assert names.count("rollout.env") == 3
    assert "rollout.graph" not in names
    assert _counts() == before
    assert ppo.graphed_rollout(cfg, pcfg, spec, ts, spec.step_fn(),
                               True) is None


@pytest.mark.parametrize("shape,row0", [((7, 22), 0), ((7, 22), 3),
                                        ((64, 2), 0), ((5, 11), 1000),
                                        ((1, 22), 2**32 // 22)])
@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1, 2**63 + 12345])
def test_device_key_draws_equal_host_key_draws(seed, shape, row0):
    """``random_bits_at`` and ``categorical_at``, the key's words read from
    a tensor, give what ``random_bits`` and ``categorical`` give the same
    key as host ints, bit for bit."""
    key = TF.split_key(TF.prng_key(seed, "cpu"))[1]
    words = torch.tensor(TF.key_words(key), dtype=torch.int64)
    offset = row0 * shape[-1]
    assert torch.equal(TF.random_bits_at(words, shape, offset),
                       TF.random_bits(key, shape, "cpu", offset))
    logits = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    logits[:, 0] = torch.finfo(torch.float32).min
    assert torch.equal(TF.categorical_at(words, logits, row0),
                       TF.categorical(key, logits, row0))


@pytest.mark.parametrize("seed", [0, 7, 2**63 + 12345, 2**64 - 1])
def test_split_chain_equals_repeated_splits(seed):
    """``split_chain``, the rollout's keys on Python ints, gives the key
    and the subkeys of 64 successive ``split_key`` calls."""
    key = TF.prng_key(seed, "cpu")
    last, subs = TF.split_chain(key, 64)
    want = []
    for _ in range(64):
        key, sk = TF.split_key(key)
        want.append(TF.key_words(sk))
    assert last.dtype == key.dtype and torch.equal(last, key)
    assert subs == want


def _rerun(device, run):
    """``graphs.capture`` without a card: the step runs once (as the real
    warm-up does), and each replay runs it again on the same static
    buffers, as a replay of the real graph would."""
    return SimpleNamespace(replay=run), run(), [0, 0, 0]


@pytest.mark.parametrize("name,masked", CASES)
def test_graphed_rollout_equals_the_eager_loop(name, masked, monkeypatch):
    """Four rollouts of 8 steps with an update between them (new parameter
    storages), across the end of the 20-step episodes: the stand-in graph
    gives every output bit for bit as the eager loop, captures once,
    replays the 31 other steps and records one ``rollout.graph`` span a
    step; the train state it was given is left as it was."""
    cfg = load_config(max_steps=20)
    cfg, pcfg, spec, step_fn, ts = _setup(name, masked, 16, 8, "cpu", cfg)
    monkeypatch.setattr(graphs, "capture", _rerun)
    g = ppo.GraphedRollout(spec, ts, pcfg.n_steps, spec.batched_masks(cfg),
                           masked, len(getattr(step_fn, "_agents", ())))
    before, ends = _counts(), 0
    for i in range(4):
        want = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn, masked)
        kept = [x.clone() for x in (ts.obs, ts.key, *ts.env_state[:4])]
        batched = spec.batched_autoreset_step(cfg, step_fn, masked)
        with torch.no_grad(), torch.profiler.profile():
            ts_g, trs_g = g.run(batched, ts)
        recs = [r for r in P.spans() if r.parent is None]
        assert [r.name for r in recs] == ["rollout.graph"] * 8
        agents, reset = STEP_TAGS[name]
        assert recs[0].attrs == {"variant": name, "batch": 16,
                                 "agents": agents, "reset": reset}
        with torch.no_grad():
            lv_g = ppo._forward(ts.params, ts_g.obs)[1]
        _assert_rollouts_equal((ts_g, trs_g, lv_g), want)
        for a, b in zip(kept, (ts.obs, ts.key, *ts.env_state[:4])):
            assert torch.equal(a, b)
        ends += int(trs_g.done.sum())
        adv, ret = ppo.compute_gae(pcfg, *want[1:])
        ts, _ = ppo.ppo_update(pcfg, want[0], want[1], adv, ret)
    assert ends > 0
    assert _counts() == (before[0] + 1, before[1] + 31)


def test_press_collect_rollout_replays_bitwise(monkeypatch):
    """The press rollout with the frozen sort agent through
    ``collect_rollout``'s graphed path (``graphs.eligible`` made true, the
    stand-in capture): three rollouts across the end of the 20-step
    episodes, the first a capture and the others replays, each bit for bit
    the eager loop's, every step one ``rollout.graph`` span with
    ``agents`` 1 and ``reset`` "eager"."""
    cfg = load_config(max_steps=20)
    cfg, pcfg, spec, step_fn, ts = _setup("press", True, 16, 8, "cpu", cfg)
    before, ends = _counts(), 0
    for _ in range(3):
        with monkeypatch.context() as m:
            m.setattr(graphs, "eligible", lambda *a, **kw: True)
            m.setattr(graphs, "capture", _rerun)
            with torch.profiler.profile():
                got = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn)
            recs = [r for r in P.spans() if r.parent is None]
        assert [r.name for r in recs] == ["rollout.graph"] * 8
        assert {tuple(sorted(r.attrs.items())) for r in recs} == {
            (("agents", 1), ("batch", 16), ("reset", "eager"),
             ("variant", "press"))}
        want = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn)
        _assert_rollouts_equal(got, want)
        ends += int(got[1].done.sum())
        ts = got[0]
    assert ends > 0
    assert _counts() == (before[0] + 1, before[1] + 23)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name,masked,n", [(v, m, 256) for v, m in CASES]
                         + [("mono", True, 4096)])
def test_cuda_graphed_rollout_equals_the_eager_loop(cuda, name, masked, n,
                                                    monkeypatch):
    """Four rollouts of 64 steps, each from the same train state graphed
    and eagerly, with an update between them, across the 200-step
    episodes' end: every transition leaf, the last values, the env state,
    the obs, the key and the accumulators bit for bit.  The updates run
    eagerly, so that the graphs counted are the rollout's."""
    monkeypatch.setattr(ppo, "graphed_update", lambda *a, **kw: None)
    cfg, pcfg, spec, step_fn, ts = _setup(name, masked, n, 64, cuda)
    before, ends = _counts(), 0
    for _ in range(4):
        got = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn, masked)
        with monkeypatch.context() as m:
            m.setattr(ppo, "graphed_rollout", lambda *a, **kw: None)
            want = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn, masked)
        _assert_rollouts_equal(got, want)
        ends += int(got[1].done.sum())
        adv, ret = ppo.compute_gae(pcfg, *got[1:])
        ts, _ = ppo.ppo_update(pcfg, got[0], got[1], adv, ret)
    assert ends > 0
    assert _counts() == (before[0] + 1, before[1] + 4 * 64 - 1)


@pytest.mark.cuda
def test_cuda_second_rollout_only_replays(cuda, monkeypatch):
    """After the first rollout every step is a replay, also after
    ``ppo_update`` has handed back parameters in new storages; products
    allowed in TF32 key a graph of their own, and the first is replayed
    again once they are not.  The updates run eagerly, so that the graphs
    counted are the rollout's."""
    monkeypatch.setattr(ppo, "graphed_update", lambda *a, **kw: None)
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 256, 16, cuda)
    it = ppo.make_train_iteration(cfg, pcfg, spec)
    ts, _ = it(ts)
    captures, replays = _counts()
    old = [p.data_ptr() for p in ts.params.parameters()]
    ts, _ = it(ts)
    assert all(p.data_ptr() not in old for p in ts.params.parameters())
    ts, _ = it(ts)
    assert _counts() == (captures, replays + 32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ts, _ = it(ts)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert _counts() == (captures + 1, replays + 32 + 15)
    ts, _ = it(ts)
    assert _counts() == (captures + 1, replays + 32 + 15 + 16)


@pytest.mark.cuda
def test_cuda_train_state_stays_a_value(cuda):
    """A train state and transitions kept from one rollout hold their
    values after two later rollouts, and share no memory with them."""
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 256, 16, cuda)
    ts1, trs1, lv1 = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn)
    kept = [x.clone() for x in (*trs1, lv1, ts1.obs, ts1.ep_return_acc,
                                ts1.last_ep_return, *ts1.env_state)
            if x is not None]
    ts2, trs2, _ = ppo.collect_rollout(cfg, pcfg, spec, ts1, step_fn)
    ppo.collect_rollout(cfg, pcfg, spec, ts2, step_fn)
    now = [x for x in (*trs1, lv1, ts1.obs, ts1.ep_return_acc,
                       ts1.last_ep_return, *ts1.env_state) if x is not None]
    for a, b in zip(kept, now):
        assert torch.equal(_bits(a), _bits(b))
    assert trs1.obs.data_ptr() != trs2.obs.data_ptr()
    assert ts1.obs.data_ptr() != ts2.obs.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mono", "press"])
def test_cuda_launches_counted_per_step(cuda, name):
    """Kernel 1 (mono) or kernel 2 (press with the frozen sort agent)
    counts one launch a step, the first rollout (its capture) included, as
    on the eager path."""
    from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda
    cfg, pcfg, spec, step_fn, ts = _setup(name, True, 256, 16, cuda)
    mod = step_cuda if name == "mono" else sort_cuda
    k0, other = mod.LAUNCHES, (sort_cuda if name == "mono"
                               else step_cuda).LAUNCHES
    for r in range(3):
        ts, _, _ = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn)
        assert mod.LAUNCHES == k0 + 16 * (r + 1)
    assert (sort_cuda if name == "mono" else step_cuda).LAUNCHES == other


@pytest.mark.cuda
def test_cuda_traced_rollout_records_graph_spans(cuda):
    """Under the profiler a replayed rollout records one ``rollout.graph``
    span a step, with its variant and batch, and none of the eager loop's
    spans."""
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 256, 16, cuda)
    ts, _, _ = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn)
    with torch.profiler.profile():
        ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn)
    recs = P.spans()
    assert [r.name for r in recs] == ["rollout.graph"] * 16
    assert all(r.attrs == {"variant": "mono", "batch": 256, "agents": 0,
                           "reset": "kernel"} for r in recs)


@pytest.mark.cuda
def test_cuda_world1_mesh_never_graphs(cuda, monkeypatch):
    """A rollout on a mesh of one NCCL rank (as the dry run builds one)
    takes the eager loop: no capture, no replay, the eager spans."""
    import torch.distributed as dist

    from marl_sortingenv_tpu_torch.parallel import distributed as DI
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        dist.destroy_process_group()
    DI.initialize(backend="nccl")
    try:
        mesh = DI.global_mesh()
        cfg, pcfg, spec, step_fn, _ = _setup("mono", True, 256, 8, cuda)
        ts = ppo.init_train_state(cfg, pcfg, spec, 256, device=cuda,
                                  mesh=mesh)
        before = _counts()
        with torch.profiler.profile():
            ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn, mesh=mesh)
        names = [r.name for r in P.spans()]
        assert names.count("rollout.policy") == 8
        assert "rollout.graph" not in names
        assert _counts() == before
    finally:
        dist.destroy_process_group()
