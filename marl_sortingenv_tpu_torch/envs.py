"""Gymnasium-compatible drop-in environments, on the port's bit-exact
parity engine.

The port of ``marl_sortingenv_tpu.envs``.  A user of the reference
(``src/envs_train/env_1_sort.py`` / ``env_2_press.py`` /
``env_monolith.py``) finds the same classes, the same constructor
signature (plus ``device``, ``"cuda"`` unless the CPU is asked for), the
same ``reset/step/action_masks/set_agents/render`` API and the same
``reward_data`` logging dict.  The env is a batch of one env of the parity
engine (``core/state.py``, ``core/step.py``, ``core/wrappers.py``), so its
trajectory under a seed is the JAX package's, bit for bit, on either
device.

A step reads what it returns and logs (its outputs, six state leaves and
the press mask) in one device-to-host copy (``rng.host_array``); every
value is an int32, f32, f64 or bool, all exact in the f64 of that copy.
The engine's own host reads come on top (``rng.HOST_SYNCS`` counts both).

Agents passed to ``set_agents`` may be ``models.mlp.ActorCritic`` modules
(copied, so later training of the caller's module does not reach the
env), the JAX package's ``ACParams`` with numpy leaves
(``mlp.params_from_jax``), SB3 policy state_dicts
(``mlp.from_torch_state_dict``) or SB3-style objects with a ``.policy``.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config.config import load_config
from .core import dynamics as D
from .core import legacy_random as LR
from .core import rng as R
from .core import state as S
from .core import step as ST
from .core import wrappers as W
from .models import mlp

try:
    import gymnasium as gym
    from gymnasium import spaces

    _GYM = True
except ImportError:  # gate: minimal shim
    _GYM = False

    class _Space:
        """Carries what ``utils/env_checker.check_env`` reads of a space:
        ``n`` of a Discrete, and ``low``, ``high``, ``dtype`` and
        ``shape`` of a Box (the JAX package's shim has ``n`` and ``shape``
        alone, and fails the checker where gymnasium is missing)."""

        def __init__(self, n=None, low=None, high=None, dtype=None):
            self.n = n
            self.dtype = np.dtype(np.int64 if dtype is None else dtype)
            self.low = None if low is None else np.asarray(low, self.dtype)
            self.high = None if high is None else np.asarray(high,
                                                             self.dtype)
            self.shape = () if low is None else self.low.shape

        def seed(self, s):
            pass

    class spaces:  # type: ignore
        @staticmethod
        def Discrete(n):
            return _Space(n=n)

        @staticmethod
        def Box(low, high, dtype=np.float32):
            return _Space(low=low, high=high, dtype=dtype)

    class gym:  # type: ignore
        class Env:
            pass


def _coerce_params(agent, device) -> Optional[mlp.ActorCritic]:
    if agent is None:
        return None
    if isinstance(agent, mlp.ActorCritic):
        return copy.deepcopy(agent).to(device).requires_grad_(False)
    if hasattr(agent, "policy"):  # SB3 model
        return mlp.from_torch_state_dict(
            {k: v.detach().cpu().numpy()
             for k, v in agent.policy.state_dict().items()}, device)
    if isinstance(agent, dict):  # raw state_dict
        return mlp.from_torch_state_dict(agent, device)
    if all(hasattr(agent, f) for f in ("pi", "vf", "action", "value")):
        return mlp.params_from_jax(agent, device)  # the JAX ACParams
    raise TypeError(f"unsupported agent type: {type(agent)}")


def _read(tensors) -> list:
    """Tensors of one env in one counted device-to-host copy: each as an
    f64 numpy array of its shape."""
    vec = R.host_array(torch.cat([t.reshape(-1).to(torch.float64)
                                  for t in tensors]))
    out, i = [], 0
    for t in tensors:
        out.append(vec[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _overflow(cfg, cont_true, cont_false):
    """(whether a container is over capacity, the first such material)
    from the container counts on the host."""
    levels = np.concatenate([cont_true[:4] + cont_false, cont_true[4:5]])
    over = levels > cfg.container_capacity
    if not over.any():
        return False, None
    return True, "ABCDE"[int(np.argmax(over))]


# what a step reads of its outputs and of the state after it
_OUT_READ = ("reward", "terminated", "action", "press_log", "purity",
             "sort_reward", "press_reward")
_STATE_READ = ("sensor_setting", "belt_occupancy", "belt_counts",
               "cont_true", "cont_false", "press_timer")


class _EnvBase(gym.Env):
    """Shared host wrapper around the parity engine."""

    name = "base"

    def __init__(self, max_steps: int = 50, seed: Optional[int] = None,
                 noise_sorting: Optional[float] = 0.05,
                 balesize: Optional[int] = 200, simulation: bool = False,
                 config_path: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.config = load_config(
            config_path,
            max_steps=max_steps,
            noise_sorting=noise_sorting,
            balesize=balesize,
        )
        self.max_steps = max_steps
        self.seed_value = seed if seed is not None else 0
        self._initialize_spaces()
        if hasattr(self.action_space, "seed"):
            self.action_space.seed(self.seed_value)
            self.observation_space.seed(self.seed_value)
        self.state = S.reset(self.config, self.seed_value, self.device)
        self._mask = (None, None)
        self._reset_logs()

    # -- reference API ----------------------------------------------------
    def reset(self, seed=None, options=None):
        if seed is not None:
            self.seed_value = seed
            self.state = S.reset(self.config, seed, self.device)
        else:
            # reference reset(seed=None) keeps the live RNG streams and
            # re-seeds only the input generator (env_super.py:375-378);
            # autoreset resets plant state on the *current* streams, so
            # consecutive unseeded episodes differ (deterministically —
            # see core/wrappers docstring) while reset(seed=k) replays.
            self.state = W.autoreset(self.config, self.state)
        self._reset_logs()
        obs, mask = _read([self._obs(self.state)[0],
                           D.press_action_masks(self.config,
                                                self.state)[0]])
        self._mask = (self.state, mask.astype(bool))
        return obs.astype(np.float32), {}

    def _reset_logs(self):
        self.reward_data = {
            "Accuracy": [], "Setting": [], "Belt_Occupancy": [],
            "Reward": [], "Total": [], "Belt_Proportions": [],
        }
        for m in "ABCDE":
            self.reward_data[f"{m}_True"] = []
            self.reward_data[f"{m}_False"] = []
        self.press_actions_per_timestep = []
        # dashboard-only per-step series (not part of the reference's
        # reward_data keys): raw belt counts and press timers, so render()
        # feeds real data to panels 7/9 (plotting.py:28-692) instead of
        # placeholders — matches eval/harness.episode_series
        self._belt_counts_log = []
        self._press_timer_log = []

    def _log(self, h):
        r_sort = float(h["sort_reward"])
        r_press = float(h["press_reward"])
        self.reward_data["Reward"].append((r_sort, r_press))
        self.reward_data["Total"].append(r_sort + r_press)
        self.reward_data["Accuracy"].append(float(h["purity"]))
        self.reward_data["Setting"].append(int(h["sensor_setting"]))
        self.reward_data["Belt_Occupancy"].append(
            float(h["belt_occupancy"]))
        belt = h["belt_counts"]
        tot = belt.sum()
        props = belt / tot if tot > 0 else np.zeros(4)
        self.reward_data["Belt_Proportions"].append(
            dict(zip("ABCD", props.tolist())))
        ct, cf = h["cont_true"], h["cont_false"]
        for i, m in enumerate("ABCD"):
            self.reward_data[f"{m}_True"].append(int(ct[i]))
            self.reward_data[f"{m}_False"].append(int(cf[i]))
        self.reward_data["E_True"].append(int(ct[4]))
        self.reward_data["E_False"].append(0)
        self.press_actions_per_timestep.append(int(h["press_log"]))
        self._belt_counts_log.append(belt.astype(np.int64))
        self._press_timer_log.append(h["press_timer"].astype(np.int64))

    def _leaves(self, *names):
        """Leaves of the state, read in one host copy (f64 numpy)."""
        return _read([getattr(self.state, n)[0] for n in names])

    @property
    def container_materials(self):
        ct, cf = self._leaves("cont_true", "cont_false")
        d = {m: int(ct[i]) for i, m in enumerate("ABCD")}
        d.update({f"{m}_False": int(cf[i]) for i, m in enumerate("ABCD")})
        d["E"] = int(ct[4])
        return d

    @property
    def press_state(self):
        t, m, n, q = self._leaves("press_timer", "press_mat", "press_n",
                                  "press_q")
        mats = "ABCDE"
        return {
            "press_1": int(t[0]), "material_1": mats[int(m[0])] if n[0] else 0,
            "n_1": int(n[0]), "q_1": float(q[0]),
            "press_2": int(t[1]), "material_2": mats[int(m[1])] if n[1] else 0,
            "n_2": int(n[1]), "q_2": float(q[1]),
        }

    @property
    def bale_count(self):
        cnt, sizes, quals = self._leaves("bale_cnt", "bale_size",
                                         "bale_qual")
        return {
            m: [(int(sizes[i, b]), int(quals[i, b]))
                for b in range(int(cnt[i]))]
            for i, m in enumerate("ABCDE")
        }

    @property
    def current_step(self):
        return int(self._leaves("current_step")[0])

    def press_action_masks(self):
        """The press mask of the current state (read with the step that
        made the state, or afresh if the state was replaced since)."""
        state, mask = self._mask
        if state is not self.state:
            mask = _read([D.press_action_masks(self.config,
                                               self.state)[0]])[0] > 0
            self._mask = (self.state, mask)
        return mask.copy()

    def monolith_action_masks(self):
        m = self.press_action_masks()
        return np.concatenate([m, m])

    def detect_overflow(self):
        return _overflow(self.config, *self._leaves("cont_true",
                                                    "cont_false"))

    def get_obs(self):
        return _read([self._obs(self.state)[0]])[0].astype(np.float32)

    def render(self, mode="human", save=False, show=False,
               log_dir="./img/log", filename="plot", title="",
               format="svg", checksum=True, steps_test=None):
        from .viz.dashboard import plot_env

        rd = self.reward_data
        T = len(rd["Total"])
        series = {
            "sort_reward": np.array([r[0] for r in rd["Reward"]]),
            "press_reward": np.array([r[1] for r in rd["Reward"]]),
            "purity": np.array(rd["Accuracy"]),
            "press_log": np.array(self.press_actions_per_timestep),
            "setting": np.array(rd["Setting"]),
            "belt_occupancy": np.array(rd["Belt_Occupancy"]),
            "belt_counts": (np.stack(self._belt_counts_log)
                            if self._belt_counts_log else np.zeros((0, 4))),
            "cont_true": np.column_stack(
                [rd[f"{m}_True"] for m in "ABCDE"]) if T else np.zeros((0, 5)),
            "cont_false": np.column_stack(
                [rd[f"{m}_False"] for m in "ABCD"]) if T else np.zeros((0, 4)),
            "press_timer": (np.stack(self._press_timer_log)
                            if self._press_timer_log else np.zeros((0, 2))),
        }
        plot_env(self.config, series, S.env_at(self.state), save=save,
                 show=show, log_dir=log_dir, filename=filename, title=title,
                 fmt=format, checksum=checksum, seed=self.seed_value)

    def _step(self, fn, action, check_overflow=False):
        """Run ``fn(cfg, state, action) -> (state, StepOut)`` (through
        ``with_overflow_termination`` when asked: the reference's
        env_1_sort.py:133-142, env_2_press.py:145-153,
        env_monolith.py:265-272), log the step and return the Gymnasium
        5-tuple."""
        act = torch.full((1,), int(action), dtype=torch.int32,
                         device=self.device)
        if check_overflow:
            fn = W.with_overflow_termination(self.config, fn, self.name)
            self.state, out = fn(self.state, act)
        else:
            self.state, out = fn(self.config, self.state, act)
        names = _OUT_READ + _STATE_READ + ("press_mask", "obs")
        vals = _read([getattr(out, f)[0] for f in _OUT_READ]
                     + [getattr(self.state, f)[0] for f in _STATE_READ]
                     + [D.press_action_masks(self.config, self.state)[0],
                        out.obs[0]])
        h = dict(zip(names, vals))
        self._mask = (self.state, h["press_mask"].astype(bool))
        self._log(h)
        info = {"action": int(h["action"])}
        terminated = bool(h["terminated"])
        if check_overflow and terminated:
            over, mat = _overflow(self.config, h["cont_true"],
                                  h["cont_false"])
            if over:
                info.update({"overflow": True, "overflow_material": mat})
        return (h["obs"].astype(np.float32), float(h["reward"]), terminated,
                False, info)


class Env_1_Sorting(_EnvBase):
    """Reference env_1_sort.py: Discrete(2) sort mode; random masked
    pressing side."""

    name = "sort"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.press_agent = None

    def _initialize_spaces(self):
        low = np.concatenate([np.zeros(9), np.full(4, -1.0)]).astype(np.float32)
        high = np.ones(13, np.float32)
        self.observation_space = spaces.Box(low, high, dtype=np.float32)
        self.action_space = spaces.Discrete(2)

    def set_agents(self, press_agent=None):
        self.press_agent = _coerce_params(press_agent, self.device)

    def action_masks(self):
        return np.array([True, True])

    def _obs(self, st):
        return D.get_sort_obs(self.config, st)

    def step(self, action=None, use_action_masking=True,
             check_overflow=False):
        return self._step(ST.step_sort, action, check_overflow)


class Env_2_Pressing(_EnvBase):
    """Reference env_2_press.py: Discrete(11) press actions; sort side by
    frozen agent (hierarchical) or rule."""

    name = "press"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sort_agent = None

    def _initialize_spaces(self):
        self.observation_space = spaces.Box(
            np.zeros(16, np.float32), np.ones(16, np.float32),
            dtype=np.float32)
        self.action_space = spaces.Discrete(11)

    def set_agents(self, sort_agent=None):
        self.sort_agent = _coerce_params(sort_agent, self.device)

    def action_masks(self):
        return self.press_action_masks()

    def _obs(self, st):
        return D.get_press_obs(self.config, st)

    def step(self, action, use_action_masking=True, check_overflow=False):
        def fn(c, s, a):
            return ST.step_press(c, s, a, self.sort_agent,
                                 use_action_masking)

        return self._step(fn, action, check_overflow)


class Env_3_Monolith(_EnvBase):
    """Reference env_monolith.py: Discrete(22) joint space; five action
    sources (external / internal mono agent / random / rule_based /
    modular model)."""

    name = "mono"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sort_agent = None
        self.press_agent = None
        self.mono_agent = None
        self._legacy = LR.mt19937_init(self.seed_value, self.device)

    def _initialize_spaces(self):
        low = np.concatenate(
            [np.zeros(9), np.full(4, -1.0), np.zeros(16)]).astype(np.float32)
        high = np.ones(29, np.float32)
        self.observation_space = spaces.Box(low, high, dtype=np.float32)
        self.action_space = spaces.Discrete(22)

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed=seed, options=options)
        if seed is not None:
            self._legacy = LR.mt19937_init(seed, self.device)
        return obs, info

    def set_agents(self, sort_agent=None, press_agent=None, mono_agent=None):
        self.sort_agent = _coerce_params(sort_agent, self.device)
        self.press_agent = _coerce_params(press_agent, self.device)
        self.mono_agent = _coerce_params(mono_agent, self.device)

    def action_masks(self):
        return self.monolith_action_masks()

    def _obs(self, st):
        return D.get_mono_obs(self.config, st)

    def step(self, action=None, mode=None, use_action_masking=True,
             check_overflow=False):
        m = use_action_masking
        if action is not None:
            def fn(c, s, a):
                return ST.step_mono_external(c, s, a, m)
        elif self.mono_agent is not None:
            def fn(c, s, a):
                return ST.step_mono_agent(c, s, self.mono_agent, m)
        elif mode == "random":
            def fn(c, s, a):
                s, self._legacy, out = ST.step_mono_legacy_random(
                    c, s, self._legacy, m)
                return s, out
        elif mode == "rule_based":
            def fn(c, s, a):
                return ST.step_mono_rule(c, s)
        elif mode == "model":
            def fn(c, s, a):
                return ST.step_mono_model(c, s, self.sort_agent,
                                          self.press_agent, m, True)
        else:
            raise ValueError(
                "Invalid action source: Provide 'action', set 'mode' to "
                "'random', 'rule_based', or 'model', or assign a mono_agent.")
        return self._step(fn, 0 if action is None else action,
                          check_overflow)
