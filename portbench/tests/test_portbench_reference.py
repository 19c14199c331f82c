"""The plain reference agrees with the port bit for bit at a tiny size on
the CPU: the learner's first iterations, the five policies' episode
totals, the Gym env's steps."""

from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

AGENT = {a: str(ROOT / "portbench" / "agents" / f"PPO_{n}_Tuned_100000.npz")
         for a, n in (("sort", "Sorting"), ("press", "Pressing"),
                      ("mono", "Monolith"))}
SIM = {"max_steps": 200, "noise_sorting": 0.05, "balesize": 200,
       "bale_mode": "events"}


@pytest.mark.parametrize("variant", ["mono", "press"])
def test_learner(variant):
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.learn import ppo
    from marl_sortingenv_tpu_torch.models import mlp

    from portbench.reference import config as RC
    from portbench.reference import learner as RL
    from portbench.reference import mlp as RM
    from portbench.traffic.train import first_iterations
    kw = dict(n_steps=8, batch_size=32, n_epochs=2, shuffle_block=4)
    sort = rsort = None
    if variant == "press":
        sort = mlp.load_npz(AGENT["sort"], device="cpu")
        rsort = RM.load_npz(AGENT["sort"], device="cpu")
    spec = ppo.spec_for(variant, engine="fastb")
    cfg, pcfg = load_config(**SIM), ppo.PPOConfig(**kw)
    ts = ppo.init_train_state(cfg, pcfg, spec, 16, seed=11, env_seed0=5,
                              device="cpu")
    _, prog = first_iterations(ppo.make_train_iteration(cfg, pcfg, spec,
                                                        sort), ts, 3)
    rcfg, rpcfg, rspec = RC.load_config(**SIM), RL.PPOConfig(**kw), \
        RL.spec_for(variant)
    rts = RL.init_train_state(rcfg, rpcfg, rspec, 16, seed=11, env_seed0=5,
                              device="cpu")
    _, ref = first_iterations(RL.make_train_iteration(rcfg, rpcfg, rspec,
                                                      rsort), rts, 3)
    assert prog.losses == ref.losses
    assert torch.equal(prog.mu1, ref.mu1)
    assert torch.equal(prog.p0, ref.p0) and torch.equal(prog.p_end,
                                                        ref.p_end)


@pytest.mark.parametrize("policy", ["Random", "Rule-Based", "PPO Sort-Only",
                                    "PPO Modular", "PPO Monolith"])
def test_policy_totals(policy):
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.eval import harness
    from marl_sortingenv_tpu_torch.models import mlp

    from portbench.reference import config as RC
    from portbench.reference import mlp as RM
    from portbench.reference import policies as RP
    agents = [mlp.load_npz(AGENT[a], device="cpu") for a in AGENT]
    ragents = [RM.load_npz(AGENT[a], device="cpu") for a in AGENT]
    got = harness.policy_totals(load_config(**SIM), policy, "fastb", 6, 15,
                                *agents, True, 9, "cpu")
    want = RP.policy_totals(RC.load_config(**SIM), policy, 6, 15, *ragents,
                            True, 9, "cpu")
    np.testing.assert_array_equal(got, want)


def test_gym_steps():
    from marl_sortingenv_tpu_torch import envs

    from portbench.reference import config as RC
    from portbench.reference.parity.env import MonolithEnv
    env = envs.Env_3_Monolith(max_steps=200, seed=3, noise_sorting=0.0,
                              balesize=200, device="cpu")
    ref = MonolithEnv(RC.load_config(max_steps=200, noise_sorting=0.0,
                                     balesize=200))
    rng = np.random.default_rng(1)
    obs, _ = env.reset(seed=21)
    robs, rmask = ref.reset(21)
    np.testing.assert_array_equal(obs, robs)
    for _ in range(60):
        mask = env.action_masks()
        np.testing.assert_array_equal(mask, rmask)
        a = int(rng.choice(np.flatnonzero(mask)))
        o, r, term, trunc, _ = env.step(a)
        ro, rr, rterm, rtrunc, rmask = ref.step(a)
        np.testing.assert_array_equal(o, ro)
        assert (r, term, trunc) == (rr, rterm, rtrunc)
