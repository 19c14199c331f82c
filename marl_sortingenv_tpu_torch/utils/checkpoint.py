"""Checkpointing: model ``.npz`` files with the reference's rotation and
find-latest semantics, and full-train-state checkpoints for resumable
runs — the port of ``marl_sortingenv_tpu.utils.checkpoint``.

* ``save_model`` / ``load_model`` write and read an ``ActorCritic`` as the
  JAX package writes an ``ACParams`` pytree: ``leaf_0 .. leaf_{n-1}`` in
  pytree order (pi (w, b) per layer, vf (w, b) per layer, action, value;
  ``w`` is ``[in, out]``) plus ``__num_leaves__``, so files pass between
  the two packages both ways.
* ``save_model`` rotates older files with the same prefix into
  ``models_dir/prev/`` (reference ``training.py:271-287``);
  ``find_latest_model`` is the newest by mtime (``training.py:31-45``).
* The full train state (parameters, optimizer state, env state, RNG key,
  counters and the trainer's bookkeeping) goes to
  ``ckpt_dir/step_<step>/state.pt`` through ``torch.save`` and comes back
  through ``torch.load(weights_only=True)``; the JAX package uses orbax.
"""

from __future__ import annotations

import copy
import glob
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..models import mlp


def save_model(params: mlp.ActorCritic, prefix: str, timesteps: int,
               models_dir: str = "./models") -> str:
    """Save with rotation (reference training.py:271-287)."""
    os.makedirs(models_dir, exist_ok=True)
    fpath = os.path.join(models_dir, f"{prefix}_{timesteps}.npz")
    existing = [f for f in os.listdir(models_dir)
                if f.startswith(prefix) and f.endswith(".npz")]
    if existing:
        prev_dir = os.path.join(models_dir, "prev")
        os.makedirs(prev_dir, exist_ok=True)
        for old in existing:
            shutil.move(os.path.join(models_dir, old),
                        os.path.join(prev_dir, old))
    leaves = mlp.params_leaves(mlp.params_to_jax(params))
    np.savez(fpath, **{f"leaf_{i}": x for i, x in enumerate(leaves)},
             __num_leaves__=np.asarray(len(leaves)))
    return fpath


def find_latest_model(prefix: str,
                      models_dir: str = "./models") -> Optional[str]:
    """Newest file with the prefix, by mtime (training.py:31-45)."""
    files = glob.glob(os.path.join(models_dir, f"{prefix}_*.npz"))
    if not files:
        return None
    return max(files, key=os.path.getmtime)


def load_model(path: str, like: Optional[mlp.ActorCritic] = None,
               device=None) -> mlp.ActorCritic:
    """The ``ActorCritic`` stored at ``path``, on ``like``'s device (or
    ``device``, default CUDA)."""
    if device is None:
        device = (next(like.parameters()).device if like is not None
                  else "cuda")
    model = mlp.load_npz(path, device)
    if like is not None and [p.shape for p in model.parameters()] != [
            p.shape for p in like.parameters()]:
        raise ValueError(f"{path} does not hold a model shaped like `like`")
    return model


# --- full train-state checkpoint ---------------------------------------------

def _encode(x):
    """A tree of NamedTuples, dicts, modules, tensors and scalars as plain
    dicts of CPU tensors and scalars (what ``weights_only`` loads)."""
    if isinstance(x, nn.Module):
        return {k: v.detach().cpu().clone() for k, v in x.state_dict().items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _encode(v) for f, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return x


def _decode(like, data):
    """Rebuild ``data`` into the structure of ``like``, each tensor on the
    device of ``like``'s tensor in its place."""
    if isinstance(like, nn.Module):
        model = copy.deepcopy(like)
        model.load_state_dict(data)
        return model
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**{f: _decode(getattr(like, f), data[f])
                             for f in like._fields})
    if isinstance(like, dict):
        return {k: _decode(v, data[k]) for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        return data.to(like.device)
    return data


def save_train_state(ckpt_dir: str, step: int, train_state) -> None:
    """Write ``train_state`` (any tree of the kinds ``_encode`` takes) to
    ``ckpt_dir/step_<step>``; the directory appears complete or not at
    all."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".step_{step}_", dir=ckpt_dir)
    torch.save(_encode(train_state), os.path.join(tmp, "state.pt"))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def restore_train_state(ckpt_dir: str, step: int, like) -> Any:
    """The tree saved at ``step``, in the structure of ``like``."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}",
                        "state.pt")
    data = torch.load(path, map_location="cpu", weights_only=True)
    return _decode(like, data)


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def prune_train_states(ckpt_dir: str, keep: int = 2) -> None:
    """Delete all but the ``keep`` newest ``step_*`` checkpoints."""
    steps = _steps(ckpt_dir)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None
