"""``EnvState``: the reference environment's mutable state for the
bit-exact parity engine, batch-first.

The port of ``marl_sortingenv_tpu.core.state``: the same fields in the
same order, each leaf with the env batch ``N`` on its first axis, so that
every leaf has the shape of the JAX package's ``vmap``\\ ped leaf.  Dtypes
follow JAX's where PyTorch has them (``int32``, ``float64``, ``bool``);
a u64 leaf (the PCG64 limbs, ``acc_*_bits``) is an ``int64`` holding its
bit pattern and a u32 leaf (``uinteger``) an ``int64`` in [0, 2**32).
``to_numpy`` / ``from_numpy`` convert to and from the JAX package's
leaves as numpy arrays, in its pytree order.

The JAX package keeps a ``fence`` leaf (always 0) in every PCG64 stream
and routes some f64 products and divisions through it, so that XLA can
neither fuse a multiply-add nor turn a division by a constant into a
reciprocal product.  Eager PyTorch rounds every op on its own, so the
port needs none of that arithmetic; it keeps the leaf, always 0, so that
the two states zip leaf for leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import SimConfig
from .rng import PCG64State, pcg64_init, random_interval32

I32 = torch.int32
F64 = torch.float64


class EnvState(NamedTuple):
    # pipeline stages (counts of A..D)
    input_counts: torch.Tensor   # i32[N, 4]
    belt_counts: torch.Tensor    # i32[N, 4]
    sort_counts: torch.Tensor    # i32[N, 4]
    # sorting machine
    acc_belt: torch.Tensor       # f64[N, 4]
    acc_sorter: torch.Tensor     # f64[N, 4]
    sensor_setting: torch.Tensor  # i32[N]
    input_occupancy: torch.Tensor  # f64[N]
    belt_occupancy: torch.Tensor   # f64[N]
    # containers: true A..D + E at [4]; false A..D
    cont_true: torch.Tensor      # i32[N, 5]
    cont_false: torch.Tensor     # i32[N, 4]
    # presses
    press_timer: torch.Tensor    # i32[N, 2]
    press_mat: torch.Tensor      # i32[N, 2]
    press_n: torch.Tensor        # i32[N, 2]
    press_q: torch.Tensor        # f64[N, 2]
    # bales (per material row: A..D,E)
    bale_size: torch.Tensor      # i32[N, 5, MAX_BALES]
    bale_qual: torch.Tensor      # i32[N, 5, MAX_BALES]
    bale_cnt: torch.Tensor       # i32[N, 5]
    # reward bookkeeping
    last_press_started: torch.Tensor  # bool[N]
    last_press_amount: torch.Tensor   # i32[N]
    press_penalty_flag: torch.Tensor  # i32[N]
    # input generator pattern machine
    gen_pattern_seq: torch.Tensor   # i32[N, 2]
    gen_pattern_idx: torch.Tensor   # i32[N]
    gen_step_counter: torch.Tensor  # i32[N]
    # counters / diagnostics
    current_step: torch.Tensor      # i32[N]
    total_input_units: torch.Tensor  # i32[N]
    error_flag: torch.Tensor        # i32[N]
    # RNG streams
    rng_input: PCG64State
    rng_sorting: PCG64State
    rng_pressing: PCG64State
    rng_noise: PCG64State
    rng: PCG64State
    gen_rng: PCG64State
    # the accuracies as IEEE-754 f64 bit patterns, kept for the
    # integer-exact engine (u64 as int64 [N, 4])
    acc_belt_bits: torch.Tensor
    acc_sorter_bits: torch.Tensor


def _pattern_seq(j: torch.Tensor) -> torch.Tensor:
    """The pattern permutation of Fisher-Yates on [1, 2] from one
    ``random_interval32(1)`` draw: j == 0 swaps."""
    base = torch.tensor([1, 2], dtype=I32, device=j.device)
    swapped = torch.tensor([2, 1], dtype=I32, device=j.device)
    return torch.where((j == 0)[:, None], swapped, base)


def _acc_bits(cfg: SimConfig, n: int, dev) -> torch.Tensor:
    bits = np.asarray(cfg.baseline_accuracy, np.float64).view(np.int64)
    return torch.from_numpy(bits.copy()).to(dev).expand(n, 4).contiguous()


def reset(cfg: SimConfig, seed, device="cuda") -> EnvState:
    """Seeded reset of one env per seed of ``seed`` (a scalar or 1-D
    array), equal to the reference's ``reset(seed=s)``: the five streams
    from seed + 1, 2, 3, 4 and 99, the input generator's stream from the
    raw seed, and its pattern permutation drawn from it."""
    dev = resolve_device(device)
    seeds = np.asarray(seed, dtype=np.int64).reshape(-1)
    n = seeds.shape[0]

    def z(*dims, dtype=I32):
        return torch.zeros((n,) + dims, dtype=dtype, device=dev)

    j, gen_rng = _vmapped_interval1(pcg64_init(seeds, dev))
    base_acc = torch.tensor(cfg.baseline_accuracy, dtype=F64,
                            device=dev).expand(n, 4).contiguous()
    return EnvState(
        input_counts=z(4), belt_counts=z(4), sort_counts=z(4),
        acc_belt=base_acc, acc_sorter=base_acc.clone(),
        sensor_setting=z(), input_occupancy=z(dtype=F64),
        belt_occupancy=z(dtype=F64),
        cont_true=z(5), cont_false=z(4),
        press_timer=z(2), press_mat=z(2), press_n=z(2),
        press_q=z(2, dtype=F64),
        bale_size=z(5, cfg.max_bales), bale_qual=z(5, cfg.max_bales),
        bale_cnt=z(5),
        last_press_started=z(dtype=torch.bool), last_press_amount=z(),
        press_penalty_flag=z(),
        gen_pattern_seq=_pattern_seq(j), gen_pattern_idx=z(),
        gen_step_counter=z(),
        current_step=z(), total_input_units=z(), error_flag=z(),
        rng_input=pcg64_init(seeds + 1, dev),
        rng_sorting=pcg64_init(seeds + 2, dev),
        rng_pressing=pcg64_init(seeds + 3, dev),
        rng_noise=pcg64_init(seeds + 4, dev),
        rng=pcg64_init(seeds + 99, dev),
        gen_rng=gen_rng,
        acc_belt_bits=_acc_bits(cfg, n, dev),
        acc_sorter_bits=_acc_bits(cfg, n, dev),
    )


def _vmapped_interval1(gen_rng: PCG64State):
    """One ``random_interval32(1)`` draw of every stream."""
    return random_interval32(gen_rng, 1)


# --- leaves, and conversion to and from the JAX package's leaves ----------

# leaves whose JAX dtype PyTorch does not have: u64 (as int64 bit
# patterns) and u32 (as int64 values; ``key`` is legacy_random.MTState's)
_U64 = {"state_hi", "state_lo", "inc_hi", "inc_lo", "fence",
        "acc_belt_bits", "acc_sorter_bits"}
_U32 = {"uinteger", "key"}


def named_leaves(st, prefix=""):
    """(dotted name, tensor) of every leaf of a state, in the JAX
    package's pytree order (NamedTuple fields, depth first)."""
    out = []
    for name, x in zip(type(st)._fields, st):
        if isinstance(x, tuple):
            out += named_leaves(x, prefix + name + ".")
        else:
            out.append((prefix + name, x))
    return out


def env_at(st, i: int = 0):
    """The state of env ``i`` alone, each leaf without the env axis (the
    shape of the JAX package's unbatched state), on the same device."""
    return type(st)(*(env_at(x, i) if isinstance(x, tuple) else x[i]
                      for x in st))


def to_numpy(st) -> list:
    """The leaves of ``st`` as numpy arrays with the JAX package's dtypes,
    in its pytree order (``jax.tree.leaves`` of its state)."""
    out = []
    for name, x in named_leaves(st):
        a = x.detach().cpu().numpy()
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _U64:
            a = a.view(np.uint64)
        elif leaf in _U32:
            a = a.astype(np.uint32)
        out.append(a)
    return out


def from_numpy(leaves, device="cuda", like=None):
    """The inverse of ``to_numpy``: an ``EnvState`` (or a state of the
    type of ``like``) from the JAX package's leaves as numpy arrays."""
    dev = resolve_device(device)
    it = iter(leaves)

    def build(cls):
        vals = []
        for name, ann in zip(cls._fields, _field_types(cls)):
            if ann is not None:
                vals.append(build(ann))
                continue
            a = np.asarray(next(it))
            if name in _U64:
                a = a.view(np.int64)
            elif name in _U32:
                a = a.astype(np.int64)
            vals.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
        return cls(*vals)

    return build(type(like) if like is not None else EnvState)


def _field_types(cls):
    """Per field of a state type: the nested state type, or None."""
    nested = {"rng_input", "rng_sorting", "rng_pressing", "rng_noise", "rng",
              "gen_rng"}
    return [PCG64State if f in nested else None for f in cls._fields]
