"""Faults planted in the program, to show that the check catches them.

Each is a context manager that breaks the timed path underneath while it
is open: the harness's tests run a cell through it and expect ``correct``
false, and ``control.py`` reads the training cells' numbers under it on
the card.  ``FAULTS[kind]`` lists the faults a cell of that driver can
have (one env has no batch to halve).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    saved = getattr(obj, name)
    setattr(obj, name, make(saved))
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _alter_reward(out):
    reward = out.reward.clone()
    reward[..., 0] += 1.0
    return out._replace(reward=reward)


# -- training ----------------------------------------------------------------

def train_unchanged():
    """The update returns the train state it was given."""
    from marl_sortingenv_tpu_torch.learn import ppo

    def make(fn):
        def update(pcfg, ts, *a, **kw):
            return ts, fn(pcfg, ts, *a, **kw)[1]
        return update
    return _patched(ppo, "ppo_update", make)


def train_half_batch():
    """The loss of every minibatch is the mean over its first half."""
    from marl_sortingenv_tpu_torch.learn import ppo

    def make(fn):
        def loss(params, pcfg, batch):
            half = batch[2].shape[-1] // 2
            return fn(params, pcfg, tuple(x[..., :half] for x in batch))
        return loss
    return _patched(ppo, "_loss_fn", make)


def train_altered():
    """The first env's reward is off by one at every rollout step."""
    from marl_sortingenv_tpu_torch.learn import ppo

    def make(fn):
        def batched(self, *a, **kw):
            step = fn(self, *a, **kw)

            def stepped(st, action):
                st, out = step(st, action)
                return st, _alter_reward(out)
            return stepped
        return batched
    return _patched(ppo.VariantSpec, "batched_autoreset_step", make)


# -- the 5-policy evaluation -------------------------------------------------

_STEPS = ("step_mono_random", "step_mono_rule", "step_mono_model",
          "step_mono_external")


@contextlib.contextmanager
def _each_step(wrap):
    from marl_sortingenv_tpu_torch.core import fastb as FB
    with contextlib.ExitStack() as stack:
        for name in _STEPS:
            stack.enter_context(_patched(FB, name, wrap))
        yield


def eval_unchanged():
    """Every policy's step returns the state it was given."""
    def wrap(fn):
        def step(cfg, st, *a, **kw):
            return st, fn(cfg, st, *a, **kw)[1]
        return step
    return _each_step(wrap)


def eval_altered():
    """The first episode's reward is off by one at every step."""
    def wrap(fn):
        def step(*a, **kw):
            st, out = fn(*a, **kw)
            return st, _alter_reward(out)
        return step
    return _each_step(wrap)


def eval_half_batch():
    """Half of the episodes are left out; their totals are the mean of
    the rest."""
    from marl_sortingenv_tpu_torch.eval import harness

    def make(fn):
        def totals(cfg, policy, engine, num_episodes, *a, **kw):
            import numpy as np
            half = fn(cfg, policy, engine, num_episodes // 2, *a, **kw)
            return np.concatenate(
                [half, np.full(num_episodes - half.size, half.mean())])
        return totals
    return _patched(harness, "policy_totals", make)


# -- the Gym env -------------------------------------------------------------

def gym_unchanged():
    """The env's step returns the state it was given."""
    from marl_sortingenv_tpu_torch.core import step as ST

    def make(fn):
        def step(cfg, st, *a, **kw):
            return st, fn(cfg, st, *a, **kw)[1]
        return step
    return _patched(ST, "step_mono_external", make)


def gym_altered():
    """Every step's reward is off by one."""
    from marl_sortingenv_tpu_torch.core import step as ST

    def make(fn):
        def step(*a, **kw):
            st, out = fn(*a, **kw)
            return st, out._replace(reward=out.reward + torch.ones_like(
                out.reward))
        return step
    return _patched(ST, "step_mono_external", make)


FAULTS = {
    "train": {"unchanged": train_unchanged, "half_batch": train_half_batch,
              "altered": train_altered},
    "eval_protocol": {"unchanged": eval_unchanged,
                      "half_batch": eval_half_batch,
                      "altered": eval_altered},
    "gym_loop": {"unchanged": gym_unchanged, "altered": gym_altered},
}
