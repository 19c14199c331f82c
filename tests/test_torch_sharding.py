"""Data parallelism of the port (marl_sortingenv_tpu_torch/parallel/) on
the CPU over gloo, against the unsharded runs, bitwise.

PyTorch has no single-process virtual mesh, so the 2-rank checks run
``python -m marl_sortingenv_tpu_torch.parallel.dryrun --world 2 --device
cpu`` (two spawned ranks on a tcp://localhost group), once for the
module, with a timeout: the ``fastb`` rule rollout sharded over dp in
events and full bale mode, the frozen-sort press rollout, one sharded PPO
iteration (its parameters and loss stats), each rank's
``make_global_bstate`` against the slice of the global reset and the
tp-sharded policy forward (rtol 1e-6), all held inside the ranks or here
against ``dryrun.unsharded``.  The single-process group, the refusals and
the devices are checked in this process.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as FB
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.parallel import distributed as DI
from marl_sortingenv_tpu_torch.parallel import dryrun as DR
from marl_sortingenv_tpu_torch.parallel import fastb_shard as FS
from marl_sortingenv_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

ARGV = ["--world", "2", "--device", "cpu", "--n-envs", "16",
        "--rollout-steps", "12", "--max-steps", "8", "--n-steps", "8",
        "--batch-size", "32", "--epochs", "2"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "run.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "marl_sortingenv_tpu_torch.parallel.dryrun",
         *ARGV, "--out", str(out)], capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}, proc.stdout


@pytest.mark.parametrize("leg", ["rollout_events", "rollout_full", "press",
                                 "train"])
def test_two_ranks_bitwise(two_ranks, leg):
    got, _ = two_ranks
    want = DR.unsharded(leg, DR.parse(ARGV), torch.device("cpu"))
    assert want
    for k, v in want.items():
        g, v = got[f"{leg}/{k}"], v.detach().numpy()
        assert (g.dtype, g.shape) == (v.dtype, v.shape), k
        assert np.array_equal(g, v), f"{leg}: {k} differs"


def test_two_ranks_tp_and_global_reset(two_ranks):
    got, stdout = two_ranks
    assert '"dryrun": "ok"' in stdout and '"backend": "gloo"' in stdout
    assert got["tp/max_abs_err"] < 1e-5
    # the ranks held make_global_bstate to the global reset's slices;
    # none of the CPU ranks launched a kernel; each held its 8 train
    # rollout steps (fewer than 2 x HOLD) to the plain step
    assert '"sort_material": 0' in stdout
    assert stdout.count('"held_to_plain": 8') == 2


def test_hold_refuses_a_differing_step():
    """``dryrun._hold``, which holds each rank's kernel steps to their
    plain version, refuses a step that differs in one output bit or that
    launches a kernel it was not told of."""
    cfg = load_config(max_steps=8, bale_mode="events")
    st = FB.reset_batch(cfg, 0, 4, device="cpu")
    a = torch.zeros(4, dtype=torch.int32)
    plain = FB.with_autoreset(cfg, FB.eager_step("external", True))
    none = {"step_mono": 0, "sort_material": 0, "sort_redistribute": 0}
    st1, out1 = DR._hold("ok", plain, plain, st, a, none)
    assert torch.equal(out1.obs, plain(st, a)[1].obs)

    def off(st, a):
        st, out = plain(st, a)
        return st, out._replace(reward=out.reward + 1e-6)
    with pytest.raises(AssertionError, match="differs"):
        DR._hold("off", off, plain, st, a, none)
    with pytest.raises(AssertionError, match="launches"):
        DR._hold("count", plain, plain, st, a, {**none, "step_mono": 1})


def test_single_process_group(monkeypatch):
    """``initialize()`` with no launcher: a group of one process; a mesh
    of it; the learner's sharded iteration over one rank equals the plain
    one bitwise; the parity engine's global state is its reset."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        dist.destroy_process_group()
    DI.initialize(backend="gloo")
    try:
        assert dist.get_world_size() == 1
        DI.initialize(backend="gloo")            # already started: kept
        mesh = DI.global_mesh()
        assert M.dp_size(mesh) == 1 and M.dp_rank(mesh) == 0
        args = DR.parse(ARGV)
        cfg, pcfg = DR._cfgs(args)
        spec = ppo.spec_for("mono", engine="fastb")
        ts0 = ppo.init_train_state(cfg, pcfg, spec, 8, device="cpu")
        ts1 = FS.shard_train_state(mesh, ts0)
        out0, st0 = ppo.make_train_iteration(cfg, pcfg, spec)(ts0)
        out1, st1 = ppo.make_train_iteration(cfg, pcfg, spec,
                                             mesh=mesh)(ts1)
        assert torch.equal(ppo.flat_parameters(out0.params),
                           ppo.flat_parameters(out1.params))
        for k in st0:
            assert torch.equal(st0[k], st1[k]), k
        pc = load_config(max_steps=20)
        st = DI.make_global_env_state(pc, 5, 4, mesh, device="cpu")
        for a, b in zip(S.to_numpy(st), S.to_numpy(S.reset(
                pc, np.arange(5, 9), device="cpu"))):
            assert np.array_equal(a, b)
        shard = M.shard_env_state(mesh, st)
        assert torch.equal(shard.cont_true, st.cont_true)
        assert FS.bstate_pspec(ts1.env_state).key == 0
        assert M.env_sharding(mesh)[0].dim == 0
        assert M.params_pspec(ts0.params, tp_shard=True)[
            "mlp_extractor.policy_net.2.weight"][0].dim == 1
    finally:
        dist.destroy_process_group()


def test_refusals():
    cfg = load_config(max_steps=8)
    spec = ppo.spec_for("mono", engine="fastb")
    pcfg = ppo.PPOConfig(n_steps=2, batch_size=8, n_epochs=1)
    ts = ppo.init_train_state(cfg, pcfg, spec, 4, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ppo.collect_rollout(cfg, pcfg, spec, ts, spec.step_fn(),
                            mesh=object())
    with pytest.raises(ValueError, match="coordinator_address"):
        DI.initialize(num_processes=2)
    with pytest.raises(ValueError, match="num_processes"):
        DI.initialize("localhost:1")
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="initialize"):
            M.make_mesh(1)


def test_entry_points_need_cuda_or_explicit_cpu():
    """The slice's entry points default to the card and refuse a missing
    one unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from marl_sortingenv_tpu_torch.eval import exact_scenarios as XS
    from marl_sortingenv_tpu_torch.models import mlp, mlp_exact as MX
    model = mlp.ActorCritic(13, 2, device="cpu")
    for call in (lambda: XS.run("traj", steps=1),
                 lambda: MX.quantize_policy(model),
                 lambda: DR.entry(),
                 lambda: DR.main(["--world", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    fn, (st, params) = DR.entry(device="cpu")
    st, obs, rew = fn(st, params)
    assert obs.shape == (64, 29) and torch.isfinite(rew).all()
    assert isinstance(FB.reset_batch(load_config(), 0, 2, device="cpu"),
                      FB.BState)
