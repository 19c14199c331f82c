"""Device mesh and sharding layout over ``torch.distributed``.

The port of ``marl_sortingenv_tpu.parallel.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (dp, tp) named
``("dp", "tp")``, one rank per process:

* ``dp``: env-batch data parallelism.  Every env is independent, so each
  rank holds and steps its own slice of the env batch, with no
  communication during the env step.  The learner gathers the rollout and
  every rank runs the same update on the global batch with replicated
  parameters (``learn/ppo.py``): the parameters stay bitwise equal to an
  unsharded run's, which an all-reduce of per-rank gradients (another
  summation order) would not keep.
* ``tp``: tensor-parallel hooks for the policy MLP, layer 0 split by
  columns (its output features) and layer 1 by rows (its input features),
  as DTensor ``Shard`` placements.  At the reference's 32x32 policy this
  does not pay; the axis exists so that larger policies drop in.

Unlike XLA, PyTorch has no single-process virtual mesh: a mesh of n ranks
needs n processes (``parallel/distributed.py`` starts the process group,
``parallel/dryrun.py`` spawns them).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Placement classes live in torch.distributed.tensor (imported lazily in
# the functions that need them: DTensor's import is slow)


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ("dp", "tp") mesh over the ``n_devices`` ranks of the process
    group (all of them by default); ``device_type`` defaults to "cuda"
    under NCCL and "cpu" under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call "
                           "parallel.distributed.initialize() first")
    if n_devices is None:
        n_devices = dist.get_world_size()
    if n_devices % tp:
        raise ValueError(f"{n_devices} ranks do not split into tp={tp}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_devices // tp, tp),
                            mesh_dim_names=("dp", "tp"))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a mesh with a "dp" axis; a clear refusal of
    anything else."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (see "
                        f"parallel.mesh.make_mesh), got {type(mesh).__name__}")
    if "dp" not in (mesh.mesh_dim_names or ()):
        raise ValueError("mesh has no 'dp' axis")
    return mesh


def dp_size(mesh: DeviceMesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("dp"))


def dp_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("dp")


def dp_group(mesh: DeviceMesh):
    return mesh.get_group("dp")


def env_sharding(mesh: DeviceMesh) -> list:
    """The placement of a batch-first env leaf: its leading axis split over
    dp (and replicated over tp)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0), Replicate()]


def local_rows(mesh: DeviceMesh, n_global: int) -> slice:
    """This rank's rows of a dp-sharded axis of ``n_global`` entries."""
    n = dp_size(mesh)
    if n_global % n:
        raise ValueError(f"{n_global} envs do not split over dp={n}")
    n_local = n_global // n
    r = dp_rank(mesh)
    return slice(r * n_local, (r + 1) * n_local)


def _narrow(x, axis: int, rows: slice):
    if x is None or not isinstance(x, torch.Tensor):
        return x
    return x.narrow(axis, rows.start, rows.stop - rows.start).contiguous()


def shard_env_state(mesh: DeviceMesh, state):
    """This rank's shard of a batch-first env state (a NamedTuple of
    tensors, nested, each with the env batch on its leading axis, as the
    parity engine's ``EnvState``)."""
    rows = local_rows(mesh, _batch(state))

    def cut(x):
        if isinstance(x, tuple):
            return type(x)(*(cut(y) for y in x))
        return _narrow(x, 0, rows)
    return cut(state)


def _batch(state) -> int:
    for x in state:
        if isinstance(x, tuple):
            return _batch(x)
        if isinstance(x, torch.Tensor):
            return x.shape[0]
    raise ValueError("state has no tensor leaf")


def params_pspec(model, tp_shard: bool = False) -> dict:
    """Placements over the tp axis per parameter name of an
    ``ActorCritic``: all replicated, or the hidden width tp-sharded (each
    tower's layer 0 by columns: its weight's rows [out, in] and its bias;
    layer 1 by rows: its weight's columns)."""
    from torch.distributed.tensor import Replicate, Shard
    specs = {}
    for name, _ in model.named_parameters():
        place = [Replicate()]
        if tp_shard and name.startswith("mlp_extractor."):
            layer = int(name.split(".")[2])
            if layer == 0:
                place = [Shard(0)]
            elif layer == 2 and name.endswith("weight"):
                place = [Shard(1)]
        specs[name] = place
    return specs


def shard_params(mesh: DeviceMesh, model, tp_shard: bool = False):
    """A copy of ``model`` laid out over the mesh's tp axis by
    ``params_pspec``: a layer whose weight is split by rows (``Shard(0)``)
    becomes ``ColwiseParallel``, one split by columns ``RowwiseParallel``
    (whose output is all-reduced over tp), so the forward takes and
    returns plain tensors; the rest stays replicated."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    model = copy.deepcopy(model)
    plan = {}
    for name, (place,) in params_pspec(model, tp_shard).items():
        if name.endswith(".weight") and isinstance(place, Shard):
            plan[name[:-len(".weight")]] = (ColwiseParallel() if place.dim == 0
                                            else RowwiseParallel())
    return parallelize_module(model, mesh["tp"], plan) if plan else model


def all_gather_dp(mesh: DeviceMesh, x: torch.Tensor, dim: int
                  ) -> torch.Tensor:
    """The dp ranks' shards of ``x`` concatenated along ``dim`` in rank
    order: the global tensor, on every rank.  Under gloo a CUDA tensor is
    staged through host memory (gloo's all-gather takes CPU tensors);
    bools travel as uint8 and int16 as int32 (gloo has neither), exactly."""
    n = dp_size(mesh)
    if n == 1:
        return x
    group = dp_group(mesh)
    staged = dist.get_backend(group) == "gloo" and x.is_cuda
    y = x.cpu() if staged else x
    wire = {torch.bool: torch.uint8, torch.int16: torch.int32}.get(y.dtype)
    if wire is not None:
        y = y.to(wire)
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=dim).to(x.dtype)
    return out.to(x.device) if staged else out
