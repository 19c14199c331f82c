"""Multi-process glue over ``torch.distributed``.

The port of ``marl_sortingenv_tpu.parallel.distributed``.  Every process
runs the same program::

    from marl_sortingenv_tpu_torch.parallel import distributed
    distributed.initialize()            # the process group
    mesh = distributed.global_mesh()    # all ranks on ("dp", "tp")

and builds only its own env shard with ``make_global_env_state`` (the
parity engine) or ``make_global_bstate`` (``fastb``); each shard equals
the slice of the global reset.  Nothing tells a program of a cluster, so
the caller names the coordinator (or a launcher such as ``torchrun`` sets
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from . import mesh as M


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Start the process group, so that one program runs as one process
    or as many:

    * an explicit coordinator (``"host:port"`` or a ``tcp://`` URL) with
      ``num_processes`` and ``process_id``: that group;
    * no coordinator but the launcher's ``RANK`` and ``WORLD_SIZE`` in the
      environment: ``env://``;
    * neither, on a plain machine: a group of one process (an in-memory
      store, no port).

    ``backend`` defaults to NCCL where CUDA is present, else gloo.  A group
    already started is left as it is.  Errors are raised, not swallowed."""
    if dist.is_initialized():
        return
    backend = backend or _default_backend()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
        return
    if num_processes is not None and num_processes > 1:
        raise ValueError(
            "coordinator_address is required for multi-process init")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def global_mesh(tp: int = 1):
    """All ranks of the process group on a ("dp", "tp") mesh."""
    return M.make_mesh(dist.get_world_size(), tp=tp)


def make_global_env_state(cfg, seed0: int, n_envs_global: int, mesh,
                          device="cuda"):
    """The parity engine's dp-sharded global batch of envs seed0 ..
    seed0 + n_envs_global - 1: this rank builds only its own rows, each
    seeded as the global reset seeds it."""
    import numpy as np
    from ..core import state as S
    rows = M.local_rows(mesh, n_envs_global)
    seeds = np.arange(seed0 + rows.start, seed0 + rows.stop)
    return S.reset(cfg, seeds, device=resolve_device(device))


def make_global_bstate(cfg, key, n_envs_global: int, mesh, device="cuda"):
    """``fastb.reset_batch(cfg, key, n_envs_global)``'s dp shard for this
    rank, built alone: the env keys are rows of ``split(key, n_global)``,
    which depends on ``n_global``, so a rank draws the rows of its slice
    of that split (counter-based, so only those) rather than resetting
    ``n_local`` envs of its own."""
    from ..core import fastb as FB
    from ..core import threefry as TF
    dev = resolve_device(device)
    rows = M.local_rows(mesh, n_envs_global)
    if isinstance(key, int):
        key = TF.prng_key(key, dev)
    key = key.to(device=dev, dtype=torch.int32)
    keys = TF.split(key[None], rows.stop - rows.start, start=rows.start)[0]
    return FB._reset_from_keys(cfg, keys)
