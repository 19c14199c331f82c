"""One sharded PPO iteration on an n-rank mesh, and the checks of the
sharded paths: the port's ``entry()`` / ``dryrun_multichip``.

    python -m marl_sortingenv_tpu_torch.parallel.dryrun                # 2 ranks, the card
    python -m marl_sortingenv_tpu_torch.parallel.dryrun --device cpu   # 2 ranks, gloo
    python -m marl_sortingenv_tpu_torch.parallel.dryrun --world 1 --backend nccl \\
        --legs train --n-envs 4096 --n-steps 64 --batch-size 16384 --epochs 4 \\
        --out run.npz

The launcher spawns ``--world`` worker processes on this host, joined over
``tcp://localhost:<free port>``; each is one rank of a ("dp", "tp") mesh.
Unlike XLA, PyTorch has no single-process virtual mesh, so every mesh of
n ranks is n processes.  NCCL refuses two ranks on one card, so with more
ranks than cards the default backend is gloo, which takes CPU tensors: a
collective of CUDA tensors is then staged through host memory
(``parallel.mesh.all_gather_dp``).

Legs (``--legs``, comma-separated; all by default):

* ``rollout_events`` / ``rollout_full``: the rule step with autoreset on
  each rank's ``fastb`` shard, both bale modes; the rewards and the final
  state gathered;
* ``press``: the press step with a frozen sort agent on each shard; on
  CUDA every step's kernel-2 launch is held bitwise against its plain
  version (``fastb.eager_step(plain)``) on the same shard;
* ``train``: ``--iterations`` sharded PPO iterations (one by default) on
  ``fastb`` in events mode (``ppo.make_train_iteration(mesh=)``); the
  parameters and loss stats after them, and the last one's seconds.  In
  the first and the last ``HOLD`` steps of each rollout but the last,
  which is timed (of the only one, with one iteration), across the
  episode's end when the iterations outlast it, each rank's autoreset step
  with the PPO-sampled actions is held bitwise to its plain version
  (``fastb.eager_step``) on its shard, and launches kernel 1 once on CUDA
  (``HeldMonoSpec``);
* ``global_bstate``: ``distributed.make_global_bstate`` against the slice
  of the global reset, on every rank;
* ``tp``: the policy's forward with its hidden width tp-sharded against
  the replicated forward, rtol 1e-6 (the whole world on tp).

Rank 0 writes the gathered results to ``--out`` (an ``.npz``: keys
``<leg>/<name>``, plus ``launches`` per rank and leg: each kernel's
launches and ``held_to_plain``, the steps held to their plain version)
for the caller to hold against the unsharded run (``unsharded`` below
computes it), and prints one JSON summary line.  Any failed check raises in its rank and the
launcher exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import sys
import time

import numpy as np
import torch

from ..learn import ppo

LEGS = ("rollout_events", "rollout_full", "press", "train",
        "global_bstate", "tp")
HOLD = 12           # the train leg's steps held at each end of a rollout
HELD = 0            # steps held to their plain version in this process


def entry(device="cuda"):
    """(fn, example_args): one fused policy + env monolith step on the
    ``fast`` engine over 64 envs: the masked argmax of the actor-critic,
    then the external step."""
    from .. import resolve_device
    from ..config.config import load_config
    from ..core import fast as FE
    from ..core import threefry as TF
    from ..models import mlp
    dev = resolve_device(device)
    cfg = load_config()
    params = mlp.init_params(TF.prng_key(0, device="cpu"), 29, 22,
                             device=dev)
    state = FE.reset_batch(cfg, 1, 64, device=dev)

    @torch.no_grad()
    def fn(state, params):
        obs = FE.get_mono_obs(cfg, state)
        masks = FE.monolith_action_masks(cfg, state)
        logits = mlp.masked_logits(params.policy_logits(obs), masks)
        actions = torch.argmax(logits, dim=-1).to(torch.int32)
        state, out = FE.step_mono_external(cfg, state, actions)
        return state, out.obs, out.reward

    return fn, (state, params)


# ---------------------------------------------------------------------------
# the configurations of the legs
# ---------------------------------------------------------------------------

def _cfgs(args):
    from ..config.config import load_config
    cfg = load_config(max_steps=args.max_steps, bale_mode="events")
    pcfg = ppo.PPOConfig(n_steps=args.n_steps, batch_size=args.batch_size,
                         n_epochs=args.epochs,
                         shuffle_block=args.shuffle_block)
    return cfg, pcfg


def sort_agent(device):
    """The frozen sort agent of the press leg: the actor-critic drawn from
    ``PRNGKey(3)``, as the JAX package's sharding test draws it."""
    from ..core import threefry as TF
    from ..models import mlp
    return mlp.init_params(TF.prng_key(3, device="cpu"), 13, 2, device=device)


def _rule_rollout(cfg, st, steps):
    """``steps`` autoreset rule steps; (rewards [T, n], final state)."""
    from ..core import fastb as FB
    step = FB.with_autoreset(cfg, lambda c, s, a: FB.step_mono_rule(c, s))
    rews = []
    for _ in range(steps):
        st, out = step(st, None)
        rews.append(out.reward)
    return torch.stack(rews), st


def _hold(tag, kernel, plain, st, a, want_launches):
    """One step of ``kernel`` and of its ``plain`` version from the same
    state and action: every leaf and output bitwise, ``kernel`` launching
    ``want_launches`` (kernel name -> count) and ``plain`` none.  Returns
    the kernel step's (state, output)."""
    global HELD
    before = _launches()
    st_k, out_k = kernel(st, a)
    got = {k: v - before[k] for k, v in _launches().items()}
    if got != want_launches:
        raise AssertionError(f"{tag}: launches {got}, not {want_launches}")
    st_p, out_p = plain(st, a)
    if _launches() != {k: before[k] + n for k, n in want_launches.items()}:
        raise AssertionError(f"{tag}: the plain step launched a kernel")
    for x, y in zip(list(st_k) + list(out_k), list(st_p) + list(out_p)):
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{tag}: the kernel step on the shard "
                                 "differs from its plain version")
    HELD += 1
    return st_k, out_k


@dataclasses.dataclass(frozen=True)
class HeldMonoSpec(ppo.VariantSpec):
    """The monolith ``fastb`` spec whose rollout step (the fused-autoreset
    external step: kernel 1 on CUDA) is held by ``_hold`` to its plain
    version (``with_autoreset`` over ``fastb.eager_step``) at the first and
    the last ``HOLD`` of the ``n_steps`` steps of each of the first
    ``rollouts`` rollouts, on the PPO-sampled actions; between them, and
    after them, it steps alone.  ``seen`` counts the rollouts begun and
    the episode ends met in held steps."""
    n_steps: int = 0
    rollouts: int = 1
    seen: dict = dataclasses.field(
        default_factory=lambda: {"rollouts": 0, "ends": 0}, compare=False)

    def batched_autoreset_step(self, cfg, step_fn, use_action_masking=True):
        from ..core import fastb as FB
        kernel = super().batched_autoreset_step(cfg, step_fn,
                                                use_action_masking)
        self.seen["rollouts"] += 1
        if self.seen["rollouts"] > self.rollouts:
            return kernel
        plain = FB.with_autoreset(cfg, FB.eager_step("external",
                                                     use_action_masking))
        t = [0]

        def stepped(st, a):
            i, t[0] = t[0], t[0] + 1
            if HOLD <= i < self.n_steps - HOLD:
                return kernel(st, a)
            want = {"step_mono": int(st.key.is_cuda), "sort_material": 0,
                    "sort_redistribute": 0}
            st, out = _hold(f"train rollout step {i}", kernel, plain, st, a,
                            want)
            self.seen["ends"] += int(out.terminated.sum())
            return st, out
        return stepped


def _press_rollout(cfg, st, steps, agent, plain=None):
    """``steps`` autoreset press steps with the frozen ``agent`` and the
    no-op press action; (rewards [T, n], final state).  ``plain``: the
    step's plain version (``fastb.eager_step``), run beside each step on
    the same state and held bitwise to it; each step must then launch
    kernel 2 once and the plain version nothing."""
    from ..core import fastb as FB
    step = FB.with_autoreset(
        cfg, lambda c, s, a: FB.step_press(c, s, a, agent, True))
    a = torch.zeros(st.key.shape[0], dtype=torch.int32, device=st.key.device)
    want = {"step_mono": 0, "sort_material": 1, "sort_redistribute": 0}
    rews = []
    for t in range(steps):
        if plain is None:
            st, out = step(st, a)
        else:
            st, out = _hold(f"press step {t}", step,
                            FB.with_autoreset(cfg, plain), st, a, want)
        rews.append(out.reward)
    return torch.stack(rews), st


def _leaves(st) -> dict:
    from ..core.fastb import BState
    return {name: x for name, x in zip(BState._fields, st) if x is not None}


def unsharded(leg: str, args, device) -> dict:
    """The leg's results computed on one process over the global batch:
    what the sharded run must equal bit for bit."""
    from ..core import fastb as FB
    cfg, pcfg = _cfgs(args)
    n = args.n_envs
    if leg in ("rollout_events", "rollout_full"):
        mode = leg.split("_")[1]
        c = cfg.with_(bale_mode=mode)
        rew, st = _rule_rollout(c, FB.reset_batch(c, 0, n, device=device),
                                args.rollout_steps)
        return {"reward": rew, **_leaves(st)}
    if leg == "press":
        rew, st = _press_rollout(cfg, FB.reset_batch(cfg, 1, n, device=device),
                                 args.rollout_steps, sort_agent(device))
        return {"reward": rew, **_leaves(st)}
    if leg == "train":
        spec = ppo.spec_for("mono", engine="fastb")
        ts = ppo.init_train_state(cfg, pcfg, spec, n, device=device)
        it = ppo.make_train_iteration(cfg, pcfg, spec)
        for _ in range(args.iterations):
            ts, stats = it(ts)
        return {"params": ppo.flat_parameters(ts.params).detach().clone(),
                **{f"stat_{k}": v for k, v in stats.items()}}
    raise ValueError(f"no unsharded run for leg {leg!r}")


# ---------------------------------------------------------------------------
# the sharded legs (run in every rank)
# ---------------------------------------------------------------------------

def _sharded_rollout(mesh, leg, args, device) -> dict:
    from ..core import fastb as FB
    from . import distributed as DI
    from . import fastb_shard as FS
    from . import mesh as M
    cfg, _ = _cfgs(args)
    n = args.n_envs
    if leg == "press":
        agent = sort_agent(device)
        st = DI.make_global_bstate(cfg, 1, n, mesh, device)
        plain = (FB.eager_step("press", True, agent)
                 if device.type == "cuda" else None)
        rew, st = _press_rollout(cfg, st, args.rollout_steps, agent, plain)
    else:
        c = cfg.with_(bale_mode=leg.split("_")[1])
        st = DI.make_global_bstate(c, 0, n, mesh, device)
        rew, st = _rule_rollout(c, st, args.rollout_steps)
    return {"reward": M.all_gather_dp(mesh, rew, 1),
            **_leaves(FS.gather_bstate(mesh, st))}


def _sharded_train(mesh, args, device) -> dict:
    cfg, pcfg = _cfgs(args)
    held = max(1, args.iterations - 1)     # the last one timed alone
    spec = HeldMonoSpec(**dataclasses.asdict(
        ppo.spec_for("mono", engine="fastb")), n_steps=pcfg.n_steps,
        rollouts=held)
    # every rank draws the same parameters and key; the env state is its
    # own shard, built alone, not cut from a global one
    ts = ppo.init_train_state(cfg, pcfg, spec, args.n_envs, device=device,
                              mesh=mesh)
    it = ppo.make_train_iteration(cfg, pcfg, spec, mesh=mesh)
    for _ in range(args.iterations):        # the last one is timed
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, stats = it(ts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    loss = float(stats["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"sharded iteration: loss {loss}")
    if held * pcfg.n_steps > cfg.max_steps and not spec.seen["ends"]:
        raise AssertionError("the held steps met no episode end")
    return {"params": ppo.flat_parameters(ts.params).detach().clone(),
            **{f"stat_{k}": v for k, v in stats.items()},
            "seconds": torch.tensor(secs, dtype=torch.float64)}


def _check_global_bstate(mesh, args, device) -> dict:
    from ..core import fastb as FB
    from . import distributed as DI
    from . import fastb_shard as FS
    cfg, _ = _cfgs(args)
    for mode in ("events", "full"):
        c = cfg.with_(bale_mode=mode)
        mine = DI.make_global_bstate(c, 7, args.n_envs, mesh, device)
        want = FS.shard_bstate(mesh, FB.reset_batch(c, 7, args.n_envs,
                                                    device=device))
        for name, x in _leaves(mine).items():
            if not torch.equal(x, getattr(want, name)):
                raise AssertionError(f"make_global_bstate ({mode}): {name} "
                                     "is not the slice of the global reset")
    return {}


def _check_tp(world, args, device) -> dict:
    from ..core import threefry as TF
    from ..models import mlp
    from . import mesh as M
    mesh = M.make_mesh(world, tp=world)
    model = mlp.init_params(TF.prng_key(1, device="cpu"), 29, 22,
                            device=device)
    obs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 29)).astype(np.float32)).to(device)
    with torch.no_grad():
        base = model.policy_logits(obs)
        sharded = M.shard_params(mesh, model, tp_shard=True)
        out = sharded.policy_logits(obs)
        out = out.full_tensor() if hasattr(out, "full_tensor") else out
        val = sharded.value_fn(obs)
        val = val.full_tensor() if hasattr(val, "full_tensor") else val
    torch.testing.assert_close(out, base, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(val, model.value_fn(obs), rtol=1e-6,
                               atol=1e-6)
    return {"max_abs_err": torch.tensor(float((out - base).abs().max()),
                                        dtype=torch.float64)}


def dryrun_multichip(args, world: int, device) -> dict:
    """Every leg of ``args.legs`` in this rank over a (world, 1) mesh;
    returns the results ({leg/name: tensor}) gathered where sharded."""
    from . import mesh as M
    mesh = M.make_mesh(world, tp=1)
    results = {}
    for leg in args.legs:
        before, held = _launches(), HELD
        if leg in ("rollout_events", "rollout_full", "press"):
            res = _sharded_rollout(mesh, leg, args, device)
        elif leg == "train":
            res = _sharded_train(mesh, args, device)
        elif leg == "global_bstate":
            res = _check_global_bstate(mesh, args, device)
        elif leg == "tp":
            res = _check_tp(world, args, device)
        else:
            raise ValueError(f"unknown leg {leg!r}")
        after = _launches()
        res["launches"] = torch.tensor([after[k] - before[k] for k in after]
                                       + [HELD - held])
        results.update({f"{leg}/{k}": v for k, v in res.items()})
    return results


def _launches() -> dict:
    """The port's kernel launch counters (kernels 1, 2, 3)."""
    from ..ops import mvhg_cuda, sort_cuda, step_cuda
    return {"step_mono": step_cuda.LAUNCHES,
            "sort_material": sort_cuda.LAUNCHES,
            "sort_redistribute": mvhg_cuda.LAUNCHES}


def _worker(rank: int, world: int, port: int, args) -> None:
    import torch.distributed as dist
    from . import distributed as DI
    torch.set_num_threads(1)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    DI.initialize(f"localhost:{port}", world, rank, backend=args.backend,
                  timeout=args.timeout)
    try:
        results = dryrun_multichip(args, world, device)
        # each rank's kernel launches and held steps per leg
        keys = [*_launches(), "held_to_plain"]
        launches = {leg: dict(zip(keys, results[f"{leg}/launches"]
                                  .tolist())) for leg in args.legs}
        every = [None] * world
        dist.all_gather_object(every, launches)
        if rank == 0 and args.out:
            out = {k: v.detach().cpu().numpy() for k, v in results.items()}
            out["launches"] = np.asarray(json.dumps(every))
            np.savez(args.out, **out)
        if rank == 0:
            print(json.dumps({"dryrun": "ok", "world": world,
                              "backend": dist.get_backend(),
                              "device": str(device), "legs": args.legs,
                              "launches": every}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl when every rank has a "
                        "card of its own, else gloo)")
    p.add_argument("--legs", default=",".join(LEGS))
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--rollout-steps", type=int, default=12)
    p.add_argument("--max-steps", type=int, default=8)
    p.add_argument("--n-steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--iterations", type=int, default=1,
                   help="PPO iterations of the train leg (the last timed)")
    p.add_argument("--shuffle-block", type=int, default=1)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    args.legs = [x for x in args.legs.split(",") if x]
    return args


def main(argv=None) -> int:
    import torch.multiprocessing as tmp
    from .. import resolve_device
    args = parse(argv)
    dev = resolve_device(args.device)
    if args.backend is None:
        enough = dev.type == "cuda" and torch.cuda.device_count() >= args.world
        args.backend = "nccl" if enough else "gloo"
    port = _free_port()
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, args.world, port, args))
             for r in range(args.world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + args.timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    code = 0
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
            code = code or 124
        elif p.exitcode != 0:
            code = code or 1
    return code


if __name__ == "__main__":
    sys.exit(main())
