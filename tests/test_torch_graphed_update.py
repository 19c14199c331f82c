"""The learner's graphed update (``learn/ppo.py``: ``graphed_update``,
``GraphedUpdate``, through ``ops/graphs.py``).

On the CPU: ``ppo_update`` never graphs there; and the graphed update
itself, let through the eligibility rule with a stand-in for
``graphs.capture`` whose replay runs the captured minibatch again, gives
the parameters, Adam's state, the key and every stat bit for bit as the
eager loop over two consecutive updates (mono masked and unmasked, sort,
press with the frozen sort agent; shuffle blocks of 1 and 128; 2 epochs
of 4 minibatches), captures once and then only replays, leaves the train
state it was given as it was, and captures anew for a patched loss,
another ``PPOConfig`` or products allowed in TF32.  On the card (marker
``cuda``): graphed and eager updates are bitwise equal over three
iterations (at the benchmark's 4096 envs x 64 steps, minibatches of
16384, 4 epochs, and smaller), a second update only replays, a traced
update records one ``update.graph`` span a minibatch and none of the
eager loop's, and an update on a world-1 mesh graphs.  This file imports
no JAX; on the card:

    python -m pytest tests/test_torch_graphed_update.py -m cuda \
        --noconftest -o addopts="" -q
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
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


def _cfg():
    conf = json.loads((ROOT / "portbench" / "configs" / "plant_paper.json")
                      .read_text())
    return load_config(**conf["sim"])


def _setup(name, masked, n, T, n_mb, n_epochs, block, device, cfg=None):
    """(cfg, pcfg, spec, step_fn, ts) of one variant, with ``n_mb``
    minibatches an epoch; press trains against the tuned sort agent."""
    cfg = cfg or _cfg()
    pcfg = ppo.PPOConfig(n_steps=T, batch_size=n * T // n_mb,
                         n_epochs=n_epochs, shuffle_block=block)
    spec = ppo.spec_for(name, "fastb")
    sp = (mlp.load_npz(str(SORT_NPZ), device=device).requires_grad_(False)
          if name == "press" else None)
    ts = ppo.init_train_state(cfg, pcfg, spec, n, seed=5, env_seed0=3,
                              device=device)
    return cfg, pcfg, spec, spec.step_fn(sp, masked), ts


def _rollout(cfg, pcfg, spec, ts, step_fn, masked):
    """(the train state after a rollout, the update's inputs)."""
    ts, trs, last_value = ppo.collect_rollout(cfg, pcfg, spec, ts, step_fn,
                                              masked)
    return ts, (trs, *ppo.compute_gae(pcfg, trs, last_value))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (floats as ints, so -0.0 is not 0.0)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


def _assert_updates_equal(got, want):
    """Every parameter, Adam's count and moments, the key, the update
    count and every stat, bitwise."""
    (ts_g, st_g), (ts_e, st_e) = got, want
    for (name, a), b in zip(ts_e.params.named_parameters(),
                            ts_g.params.parameters()):
        _same(b.detach(), a.detach(), f"params.{name}")
    for name, a, b in zip(ppo.AdamState._fields, ts_g.opt_state,
                          ts_e.opt_state):
        _same(a, b, f"opt_state.{name}")
    _same(ts_g.key, ts_e.key, "key")
    _same(ts_g.update_count, ts_e.update_count, "update_count")
    assert list(st_g) == list(st_e)
    for k in st_e:
        _same(st_g[k], st_e[k], f"stats.{k}")


def _eager(pcfg, ts, batch):
    """``ppo_update`` with the graphed update turned away."""
    saved = ppo.graphed_update
    ppo.graphed_update = lambda *a, **kw: None
    try:
        return ppo.ppo_update(pcfg, ts, *batch)
    finally:
        ppo.graphed_update = saved


def _counts():
    return graphs.CAPTURES, graphs.REPLAYS


def _since(before):
    return tuple(x - y for x, y in zip(_counts(), before))


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty graph cache for the test, so that its captures are its
    own; the entries it makes go with it."""
    monkeypatch.setattr(graphs, "_CACHE", weakref.WeakKeyDictionary())


@pytest.fixture
def standin(monkeypatch, fresh_cache):
    """The graphed update on the CPU: the eligibility rule lets it through,
    and ``graphs.capture`` runs the minibatch once (as the real warm-up
    does), each replay running it again on the same static buffers, as a
    replay of the real graph would."""
    monkeypatch.setattr(graphs, "eligible", lambda *a, **kw: True)
    monkeypatch.setattr(graphs, "capture", lambda device, run: (
        SimpleNamespace(replay=run), run(), [0, 0, 0]))


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("engine", ["fastb", "parity"])
def test_cpu_update_never_graphs(engine):
    """On the CPU every minibatch is the eager loop's: no capture, no
    replay, and one ``update.loss``, ``update.backward`` and
    ``update.optim`` span a minibatch."""
    cfg = load_config(max_steps=20)
    pcfg = ppo.PPOConfig(n_steps=3, batch_size=3, n_epochs=2)
    spec = ppo.spec_for("mono", engine)
    ts = ppo.init_train_state(cfg, pcfg, spec, 4, device="cpu")
    ts, batch = _rollout(cfg, pcfg, spec, ts, spec.step_fn(None, True), True)
    before = _counts()
    with torch.profiler.profile():
        ppo.ppo_update(pcfg, ts, *batch)
    names = [r.name for r in P.spans()]
    for name in ("update.loss", "update.backward", "update.optim"):
        assert names.count(name) == 8, name
    assert "update.graph" not in names
    assert _counts() == before


@pytest.mark.parametrize("block", [1, 128])
@pytest.mark.parametrize("name,masked", CASES)
def test_graphed_update_equals_the_eager_loop(name, masked, block, standin):
    """Two consecutive updates of 2 epochs x 4 minibatches, each from the
    same rollout graphed and eagerly: the parameters, Adam's state, the
    key and every stat bit for bit; the first update captures and replays
    its 7 other minibatches, the second replays all 8, each recording one
    ``update.graph`` span a minibatch and none of the eager loop's."""
    cfg, pcfg, spec, step_fn, ts = _setup(name, masked, 128, 8, 4, 2, block,
                                          "cpu", load_config(max_steps=20))
    for want_counts in ((1, 7), (0, 8)):
        ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, masked)
        want = _eager(pcfg, ts, batch)
        before = _counts()
        with torch.profiler.profile():
            got = ppo.ppo_update(pcfg, ts, *batch)
        recs = [r for r in P.spans() if r.parent is None]
        assert [r.name for r in recs] == ["update.graph"] * 8
        assert recs[0].attrs == {"batch": 256}
        assert _since(before) == want_counts
        _assert_updates_equal(got, want)
        ts = got[0]


def test_graphed_update_leaves_its_train_state(standin):
    """The train state an update is given, and the results of an update,
    hold their values through later updates and share no memory with
    them."""
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 16, 8, 4, 2, 1,
                                          "cpu", load_config(max_steps=20))
    ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, True)

    def leaves(ts):
        return [*ts.params.parameters(), *ts.opt_state, ts.key,
                ts.update_count]
    kept = [x.detach().clone() for x in leaves(ts)]
    ts1, st1 = ppo.ppo_update(pcfg, ts, *batch)
    kept1 = [x.detach().clone() for x in (*leaves(ts1), *st1.values())]
    ts2, _ = ppo.ppo_update(pcfg, ts1, *batch)
    for a, b in zip(kept, leaves(ts)):
        _same(a, b.detach(), "the given train state")
    for a, b in zip(kept1, (*leaves(ts1), *st1.values())):
        _same(a, b.detach(), "the first update's results")
    ptrs = {x.untyped_storage().data_ptr() for x in leaves(ts2)}
    assert not ptrs & {x.untyped_storage().data_ptr() for x in leaves(ts1)}


@pytest.mark.parametrize("change", ["loss", "config", "tf32"])
def test_a_new_loss_config_or_tf32_keys_a_capture(change, standin,
                                                  monkeypatch):
    """A patched ``_loss_fn`` (the benchmark's half-batch fault, looked up
    at each update), another ``PPOConfig`` of the same layout, and products
    allowed in TF32 each capture a graph of their own, which gives what the
    eager loop gives under the same change; the first graph is replayed
    again after."""
    from portbench import faults
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 16, 8, 4, 2, 1,
                                          "cpu", load_config(max_steps=20))
    ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, True)
    first = ppo.ppo_update(pcfg, ts, *batch)
    before = _counts()
    with contextlib.ExitStack() as stack:
        new = pcfg
        if change == "loss":
            stack.enter_context(faults.train_half_batch())
        elif change == "config":
            new = dataclasses.replace(pcfg, clip_range=0.1, ent_coef=0.2)
        else:
            stack.enter_context(monkeypatch.context()).setattr(
                torch.backends.cuda.matmul, "allow_tf32", True)
        got = ppo.ppo_update(new, ts, *batch)
        assert _since(before) == (1, 7)
        _assert_updates_equal(got, _eager(new, ts, batch))
    if change != "tf32":
        assert got[1]["loss"] != first[1]["loss"]
    before = _counts()
    _assert_updates_equal(ppo.ppo_update(pcfg, ts, *batch), first)
    assert _since(before) == (0, 8)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


# (variant, masking, envs, steps, minibatches, epochs): the benchmark's
# train_mono layout, and two smaller ones
CARD = [("mono", True, 4096, 64, 16, 4), ("sort", True, 256, 16, 4, 2),
        ("press", True, 256, 16, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,masked,n,T,n_mb,n_epochs", CARD)
def test_cuda_graphed_update_equals_the_eager_loop(cuda, fresh_cache, name,
                                                   masked, n, T, n_mb,
                                                   n_epochs):
    """Three iterations, each update from the same rollout graphed and
    eagerly: the parameters, Adam's state, the key and every stat bit for
    bit; the first update captures, the others only replay."""
    cfg, pcfg, spec, step_fn, ts = _setup(name, masked, n, T, n_mb, n_epochs,
                                          128, cuda)
    k = n_mb * n_epochs
    for want_counts in ((1, k - 1), (0, k), (0, k)):
        ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, masked)
        before = _counts()
        got = ppo.ppo_update(pcfg, ts, *batch)
        assert _since(before) == want_counts
        _assert_updates_equal(got, _eager(pcfg, ts, batch))
        ts = got[0]


@pytest.mark.cuda
def test_cuda_second_update_only_replays(cuda, fresh_cache):
    """At the benchmark's layout the first update captures and replays its
    63 other minibatches, and the next update, from parameters in new
    storages, replays all 64."""
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 4096, 64, 16, 4, 128,
                                          cuda)
    ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, True)
    before = _counts()
    ts, _ = ppo.ppo_update(pcfg, ts, *batch)
    assert _since(before) == (1, 63)
    ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, True)
    before = _counts()
    ppo.ppo_update(pcfg, ts, *batch)
    assert _since(before) == (0, 64)


@pytest.mark.cuda
def test_cuda_traced_update_records_graph_spans(cuda, fresh_cache):
    """Under the profiler a replayed update records one ``update.graph``
    span a minibatch, with its batch, and none of the eager loop's
    spans."""
    cfg, pcfg, spec, step_fn, ts = _setup("mono", True, 4096, 64, 16, 4, 128,
                                          cuda)
    ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, True)
    ts, _ = ppo.ppo_update(pcfg, ts, *batch)
    ts, batch = _rollout(cfg, pcfg, spec, ts, step_fn, True)
    with torch.profiler.profile():
        ppo.ppo_update(pcfg, ts, *batch)
    recs = P.spans()
    assert [r.name for r in recs] == ["update.graph"] * 64
    assert all(r.attrs == {"batch": 16384} for r in recs)


@pytest.mark.cuda
def test_cuda_world1_mesh_update_graphs(cuda, fresh_cache, monkeypatch):
    """An iteration on a mesh of one NCCL rank (as the dry run builds one)
    steps its rollout eagerly and replays its update from a graph."""
    import torch.distributed as dist

    from marl_sortingenv_tpu_torch.parallel import distributed as DI
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        dist.destroy_process_group()
    DI.initialize(backend="nccl")
    try:
        mesh = DI.global_mesh()
        cfg, pcfg, spec, _, _ = _setup("mono", True, 256, 8, 4, 2, 128, cuda)
        ts = ppo.init_train_state(cfg, pcfg, spec, 256, device=cuda,
                                  mesh=mesh)
        it = ppo.make_train_iteration(cfg, pcfg, spec, mesh=mesh)
        before = _counts()
        with torch.profiler.profile():
            it(ts)
        names = [r.name for r in P.spans()]
        assert names.count("rollout.policy") == 8
        assert "rollout.graph" not in names
        assert names.count("update.graph") == 8
        assert "update.loss" not in names
        assert _since(before) == (1, 7)
    finally:
        dist.destroy_process_group()
