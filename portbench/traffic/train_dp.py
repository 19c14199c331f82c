"""Data-parallel PPO over ``world`` ranks, one per card: the generator of
the ``train_*_dp*`` mixes.

Parameters (``portbench/traffic/<mix>.json``): those of ``train.py``, with
``n_envs`` and ``batch_size`` global (each rank steps ``n_envs / world``
envs), plus ``world`` (the ranks) and ``backend`` ("nccl" on the cards,
"gloo" in the harness's CPU tests).

The harness process is rank 0, on card 0.  Set-up builds the kernels, then
starts ranks 1 .. world - 1 as processes of the same interpreter (this
file run with ``-m``), each given ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` gives them.
Every rank joins through the program's own ``distributed.initialize()``
and ``global_mesh()`` and builds its shard with ``ppo.init_train_state(
mesh=)`` and its iteration with ``ppo.make_train_iteration(mesh=)``.
Before each iteration rank 0 broadcasts a command over the group
(iterate, or stop), so every rank runs the same iterations; the others
only follow.

``train_samples_per_s`` counts the global samples (iterations x
``n_envs`` x ``n_steps``) over rank 0's window; ``--trace 1`` profiles
rank 0's slice only.  The check runs after the other ranks have exited:
``train.py``'s reference learner, unsharded, at the global ``n_envs`` and
``batch_size`` on rank 0's card, against rank 0's record of the first
iterations (``train.compare``).

No rank outlives the run: each collective has ``TIMEOUT_S``, a watcher in
rank 0 ends the run (exit 1) within a second of any other rank's early
exit, and each other rank dies with rank 0 (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from portbench.lib import bench
from portbench.lib.cell import Context, forbidden_modules
from portbench.traffic import train

# every collective of the group, and the ranks' start, end within this
TIMEOUT_S = 60.0
ITERATE, STOP = 1, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _program_root() -> str:
    import marl_sortingenv_tpu_torch
    return str(Path(marl_sortingenv_tpu_torch.__file__).resolve().parents[1])


def alter_one_step(step: int) -> None:
    """From now on in this process, every env's reward is off by one at the
    ``step``-th rollout step (from 0) and at no other."""
    from marl_sortingenv_tpu_torch.learn import ppo
    made = ppo.VariantSpec.batched_autoreset_step
    seen = [0]

    def batched(self, *a, **kw):
        inner = made(self, *a, **kw)

        def stepped(st, action):
            st, out = inner(st, action)
            if seen[0] == step:
                out = out._replace(reward=out.reward + 1.0)
            seen[0] += 1
            return st, out
        return stepped
    ppo.VariantSpec.batched_autoreset_step = batched


class Driver(train.Driver):
    """Rank ``rank`` of the mix.  ``plant``: (rank, step), one rank >= 1
    whose rewards are altered at one rollout step (``alter_one_step``), to
    show that the check catches a fault in a rank other than the one it
    reads."""

    def __init__(self, ctx, rank: int = 0):
        super().__init__(ctx)
        self.rank = rank
        self.world, self.backend = self.p["world"], self.p["backend"]
        self.port = None
        self.workers: list = []
        self.plant = None
        self.facts: dict = {}
        self._stopping = False

    # -- the group ------------------------------------------------------------
    def _cmd_device(self):
        return "cuda" if self.backend == "nccl" else "cpu"

    def _join(self):
        from marl_sortingenv_tpu_torch.parallel import distributed as DI
        if self.rank == 0:
            DI.initialize(f"localhost:{self.port}", self.world, 0,
                          backend=self.backend, timeout=TIMEOUT_S)
        else:
            DI.initialize(backend=self.backend, timeout=TIMEOUT_S)
        return DI.global_mesh()

    def _command(self, code: int) -> None:
        dist.broadcast(torch.full((1,), code, dtype=torch.int32,
                                  device=self._cmd_device()), src=0)

    def next_command(self) -> int:
        x = torch.empty(1, dtype=torch.int32, device=self._cmd_device())
        dist.broadcast(x, src=0)
        return int(x.item())

    def _program(self):
        """(the iteration, this rank's shard of the train state); rank 0's
        iteration first tells the other ranks to run theirs."""
        from marl_sortingenv_tpu_torch.config.config import load_config
        from marl_sortingenv_tpu_torch.learn import ppo
        from marl_sortingenv_tpu_torch.models import mlp
        mesh = self._join()
        p, dev = self.p, self.ctx.device
        cfg = load_config(**self.sim)
        pcfg = ppo.PPOConfig(n_steps=p["n_steps"], batch_size=p["batch_size"],
                             n_epochs=p["n_epochs"],
                             shuffle_block=p["shuffle_block"])
        spec = ppo.spec_for(p["variant"], engine="fastb")
        sort = None
        if p.get("sort_agent"):
            sort = mlp.load_npz(self.ctx.agent_path(p["sort_agent"]),
                                device=dev).requires_grad_(False)
        ts = ppo.init_train_state(cfg, pcfg, spec, p["n_envs"],
                                  seed=self.learn_seed,
                                  env_seed0=self.env_seed, device=dev,
                                  mesh=mesh)
        it = ppo.make_train_iteration(cfg, pcfg, spec, sort, mesh=mesh)
        if self.rank:
            return it, ts

        def commanded(ts):
            self._command(ITERATE)
            return it(ts)
        return commanded, ts

    # -- rank 0 ---------------------------------------------------------------
    def setup(self):
        if self.ctx.device == "cuda":
            # built once here, so that the other ranks only load them
            from marl_sortingenv_tpu_torch.ops import _build
            _build.build_all()
        self._spawn()
        super().setup()

    def _spawn(self):
        self.port = _free_port()
        path = os.pathsep.join(
            [str(self.ctx.cell.root), _program_root()]
            + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep)
               if x])
        base = dict(os.environ, MASTER_ADDR="localhost",
                    MASTER_PORT=str(self.port), WORLD_SIZE=str(self.world),
                    PYTHONPATH=path)
        argv = [sys.executable, "-m", "portbench.traffic.train_dp",
                "--root", str(self.ctx.cell.root),
                "--workload", self.ctx.cell.name, "--seed",
                str(self.ctx.seed), "--device", self.ctx.device,
                "--parent", str(os.getpid())]
        if self.plant is not None:
            rank, step = self.plant
            if rank < 1:
                raise ValueError("a fault is planted in a rank >= 1")
            argv += ["--alter", f"{rank}:{step}"]
        atexit.register(self._kill_workers)
        for r in range(1, self.world):
            self.workers.append(subprocess.Popen(
                argv, cwd=self.ctx.cell.root, stdout=2,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        """End the run the moment another rank exits before it was told to
        stop: rank 0 may be waiting in a collective that never ends."""
        while not self._stopping:
            for r, w in enumerate(self.workers, 1):
                code = w.poll()
                if code is not None and not self._stopping:
                    print(f"portbench: rank {r} exited ({code}) before the "
                          "run's end; ending the run", file=sys.stderr,
                          flush=True)
                    self._kill_workers()
                    os._exit(1)
            time.sleep(0.2)

    def _kill_workers(self):
        for w in self.workers:
            if w.poll() is None:
                w.kill()
                w.wait()

    def window(self, seconds: float):
        win = super().window(seconds)
        self.facts = win.facts
        return win

    def traced_slice(self):
        from marl_sortingenv_tpu_torch.parallel import mesh as M
        b0 = getattr(M, "GATHER_BYTES", None)
        super().traced_slice()
        n_local = self.p["n_envs"] // self.world
        self.launches = [(k, v, n_local, c) for k, v, _, c in self.launches]
        if b0 is not None:
            self.facts["slice_gather_bytes"] = M.GATHER_BYTES - b0

    def release(self):
        """Tell the other ranks to stop, leave the group, and wait for
        them; any that fails fails the run."""
        self._stopping = True
        if self.workers and dist.is_initialized():
            self._command(STOP)
            self._sync()
        if dist.is_initialized():
            dist.destroy_process_group()
        super().release()
        deadline = time.monotonic() + TIMEOUT_S
        codes = []
        for w in self.workers:
            try:
                codes.append(w.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._kill_workers()
        atexit.unregister(self._kill_workers)
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks 1..{self.world - 1} ended with "
                               f"{codes}")


# -- ranks 1 .. world - 1 -----------------------------------------------------

def _die_with(parent: int) -> None:
    """Be killed when rank 0 (the process that started this one) ends."""
    pr_set_pdeathsig = 1
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
    libc.prctl(pr_set_pdeathsig, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def serve(argv=None) -> int:
    """One rank other than 0: join, follow rank 0's commands, leave."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--parent", type=int, required=True)
    ap.add_argument("--alter", default=None)
    args = ap.parse_args(argv)
    _die_with(args.parent)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    cell = bench.load_cell(Path(args.root), args.workload)
    drv = Driver(Context(cell=cell, seed=args.seed, device=args.device,
                         trace=False), rank=rank)
    if args.alter is not None:
        r, step = (int(x) for x in args.alter.split(":"))
        if r == rank:
            alter_one_step(step)
    it, ts = drv._program()
    try:
        while drv.next_command() == ITERATE:
            ts, _ = it(ts)
        drv._sync()
    finally:
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"portbench: rank {rank} loaded {', '.join(found)}; nothing "
              "of JAX or of the JAX package may run here", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(serve())
