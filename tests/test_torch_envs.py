"""The port's Gymnasium drop-in envs (marl_sortingenv_tpu_torch/envs.py)
against the JAX package's (marl_sortingenv_tpu/envs.py) on the CPU, same
seed, same actions: every class and action source (the monolith's
model and mono-agent modes in test_torch_envs_agents.py), 60 steps at
max_steps 20, with an unseeded ``reset()`` at each episode's end (so two resets fall
inside).  Each step's obs, reward, terminated, truncated and info equal,
types and dtypes included, and the action masks; at each episode's end
``reward_data``, the press log, the dashboard series and the accessors
equal.

The tuned agents' f32 forwards round differently in PyTorch and XLA, so an
agent may pick another action where its two largest logits lie within
ARGMAX_RTOL (``ArgmaxLog``): the test accepts a differing action only
there, and carries on from the JAX env's state and logs.  Any other
difference fails.

Also: ``utils.env_checker.check_env`` on the three classes, with
gymnasium and with the module's own shim (gymnasium hidden), and agents
given as the JAX package's ``ACParams`` with numpy leaves step as their
``ActorCritic`` does.
"""
import copy
import importlib.util
import sys

import jax
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu import envs as JE
from marl_sortingenv_tpu_torch import envs as E
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.utils.env_checker import check_env
from test_torch_fastb_model import agent, jax_agent
from test_torch_parity_engine import ArgmaxLog

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

MAX_STEPS, STEPS, SEED = 20, 60, 5
CLASSES = {"sort": (JE.Env_1_Sorting, E.Env_1_Sorting),
           "press": (JE.Env_2_Pressing, E.Env_2_Pressing),
           "mono": (JE.Env_3_Monolith, E.Env_3_Monolith)}
ACCESSORS = ("container_materials", "press_state", "bale_count",
             "current_step")

# (env, action source, masked, agents, check_overflow); the monolith's
# model and mono-agent modes are in test_torch_envs_agents.py (each file
# stays under 40 s on one worker: the JAX steps compile once per variant)
CASES = [
    ("sort", "action", True, {}, False),
    ("press", "action", True, {}, False),
    ("press", "action", True, {"sort_agent": "sort"}, False),
    ("mono", "action", True, {}, False),
    ("mono", "action", False, {}, False),
    ("mono", "rule_based", True, {}, False),
    ("mono", "random", True, {}, False),
    ("mono", "random", False, {}, False),
    # no press ever: the containers overflow before max_steps
    ("press", "idle", True, {}, True),
]

def ids(cases):
    return [_id(c) for c in cases]


def _id(case):
    env, src, masked, agents, over = case
    return (f"{env}-{src}-{'masked' if masked else 'unmasked'}"
            + ("-" + "+".join(agents) if agents else "")
            + ("-overflow" if over else ""))


def _step(env, name, src, masked, over, rng):
    """One step of ``env`` from the action source; the action drawn from
    ``rng`` among the valid ones when masked."""
    kw = {"use_action_masking": masked, "check_overflow": over}
    if src in ("action", "idle"):
        n = env.action_space.n
        valid = (np.flatnonzero(env.action_masks()) if masked
                 else np.arange(n))
        a = 0 if src == "idle" else int(valid[rng.integers(len(valid))])
        return env.step(a, **kw)
    return env.step(mode=None if src == "agent" else src, **kw)


def _logs(env):
    return (env.reward_data, env.press_actions_per_timestep,
            env._belt_counts_log, env._press_timer_log)


def _assert_logs_equal(je, pe, tag):
    for a, b in zip(_logs(je), _logs(pe)):
        if a and isinstance(a, list) and isinstance(a[0], np.ndarray):
            assert len(a) == len(b), tag
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), tag
        else:
            assert a == b, tag
    for name in ACCESSORS:
        assert getattr(je, name) == getattr(pe, name), (tag, name)
    assert je.detect_overflow() == pe.detect_overflow(), tag


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_env_equals_jax(monkeypatch, case):
    run_case(monkeypatch, case)


def run_case(monkeypatch, case):
    """Step the JAX env and the port's side by side (module docstring)."""
    name, src, masked, agents, over = case
    jcls, tcls = CLASSES[name]
    je = jcls(max_steps=MAX_STEPS, seed=SEED)
    pe = tcls(max_steps=MAX_STEPS, seed=SEED, device="cpu")
    je.set_agents(**{k: jax_agent(v)[1] for k, v in agents.items()})
    pe.set_agents(**{k: agent(v) for k, v in agents.items()})
    log = ArgmaxLog(monkeypatch)
    oj, ij = je.reset(seed=SEED)
    ot, it = pe.reset(seed=SEED)
    assert ij == it and oj.dtype == ot.dtype and np.array_equal(oj, ot)
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    ties = resets = 0
    for t in range(STEPS):
        assert np.array_equal(je.action_masks(), pe.action_masks()), t
        log.rows.clear()
        rj = _step(je, name, src, masked, over, rng_j)
        rt = _step(pe, name, src, masked, over, rng_t)
        if rj[4]["action"] != rt[4]["action"]:
            assert log.near_tie(0), (
                f"step {t}: action {rj[4]['action']} (JAX) vs "
                f"{rt[4]['action']} with no near-tie")
            ties += 1
            pe.state = S.from_numpy(
                [np.asarray(x)[None] for x in jax.tree.leaves(je.state)],
                device="cpu")
            for attr in ("reward_data", "press_actions_per_timestep",
                         "_belt_counts_log", "_press_timer_log"):
                setattr(pe, attr, copy.deepcopy(getattr(je, attr)))
            continue
        assert rj[0].dtype == rt[0].dtype == np.float32
        assert np.array_equal(rj[0], rt[0]), f"step {t}: obs"
        for x, y in zip(rj[1:], rt[1:]):
            assert type(x) is type(y) and x == y, (t, rj[1:], rt[1:])
        if rj[2]:
            _assert_logs_equal(je, pe, f"episode end at step {t}")
            oj, _ = je.reset()
            ot, _ = pe.reset()
            assert np.array_equal(oj, ot), f"reset at step {t}"
            resets += 1
    _assert_logs_equal(je, pe, "end")
    assert resets >= 1
    print(f"near-tie splits: {ties}, resets: {resets}")


@pytest.mark.parametrize("gym", [True, False], ids=["gymnasium", "shim"])
def test_check_env(monkeypatch, gym):
    mod = E
    if not gym:
        # a fresh copy of the module, imported with gymnasium hidden
        monkeypatch.setitem(sys.modules, "gymnasium", None)
        spec = importlib.util.find_spec("marl_sortingenv_tpu_torch.envs")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert mod._GYM is gym
    for cls in (mod.Env_1_Sorting, mod.Env_2_Pressing, mod.Env_3_Monolith):
        env = cls(max_steps=MAX_STEPS, seed=1, device="cpu")
        check_env(env, n_steps=MAX_STEPS + 2)
        assert env.observation_space.dtype == np.float32
        assert env.observation_space.shape == env.observation_space.low.shape


def test_jax_params_agent_steps_as_its_actor_critic():
    params = jax.tree.map(np.asarray, jax_agent("sort")[1])
    envs = []
    for a in (agent("sort"), params):
        env = E.Env_2_Pressing(max_steps=MAX_STEPS, seed=SEED, device="cpu")
        env.set_agents(sort_agent=a)
        env.reset(seed=SEED)
        envs.append(env)
    for t in range(MAX_STEPS):
        a, b = (env.step(t % 2 * 6 if env.action_masks()[6] else 0)
                for env in envs)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:], t
    assert envs[0].reward_data == envs[1].reward_data
