"""Data parallelism for the batch-last ``fastb`` engine.

The port of ``marl_sortingenv_tpu.parallel.fastb_shard``.  ``fastb`` keeps
the env batch on the LAST axis of every state leaf (counts ``i32[4, N]``,
bales ``i16[5, MAX, N]``) except ``key`` (``i32[N, 2]``), so a dp shard
cuts each leaf on the axis ``bstate_pspec`` names.  Each rank holds its
shard as ordinary local tensors and steps it with the port's normal
dispatch, so on CUDA each rank launches the step kernel (kernel 1) or the
sorting-core kernel (kernel 2) on its own envs; ``lanes_for`` picks the
kernel design by the shard's width, and the designs are bitwise equal to
each other.  No collective is needed in the step: the envs are
independent, and every draw is keyed per env, so a shard computes the
bits the unsharded program computes for its slice.
"""

from __future__ import annotations

from ..core.fastb import BState
from . import mesh as M


def bstate_pspec(st: BState) -> BState:
    """The env axis of each leaf of a ``BState``: the trailing axis, but
    0 for ``key``; None for the unused bale leaves of the current mode."""
    kw = {}
    for name, x in zip(BState._fields, st):
        if x is None:
            kw[name] = None
        else:
            kw[name] = 0 if name == "key" else x.dim() - 1
    return BState(**kw)


def _cut(st, specs, rows):
    return type(st)(*(M._narrow(x, s, rows) if s is not None else None
                      for x, s in zip(st, specs)))


def shard_bstate(mesh, st: BState) -> BState:
    """This rank's shard of a global ``BState``."""
    rows = M.local_rows(mesh, st.key.shape[0])
    return _cut(st, bstate_pspec(st), rows)


def gather_bstate(mesh, st: BState) -> BState:
    """The global ``BState`` from every rank's shard (on every rank)."""
    specs = bstate_pspec(st)
    return BState(*(M.all_gather_dp(mesh, x, s) if s is not None else None
                    for x, s in zip(st, specs)))


def shard_train_state(mesh, ts):
    """This rank's view of a ``learn.ppo.TrainState`` built over the
    global batch: the env state, the obs and the per-env return
    accumulators cut to the shard; the parameters, the optimizer state,
    the key and the update count whole (replicated)."""
    rows = M.local_rows(mesh, ts.obs.shape[0])
    return ts._replace(
        env_state=shard_bstate(mesh, ts.env_state),
        obs=M._narrow(ts.obs, 0, rows),
        ep_return_acc=M._narrow(ts.ep_return_acc, 0, rows),
        last_ep_return=M._narrow(ts.last_ep_return, 0, rows))
