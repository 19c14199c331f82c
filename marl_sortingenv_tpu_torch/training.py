"""Signature-compatible shims over ``learn.trainer`` mirroring reference
``src/training.py``'s public names (``Train_Agent``, ``RL_Trainer``,
``save_model``, ``find_latest_model``).

The port of ``marl_sortingenv_tpu.training``; both trainers take the
port's ``device`` (``"cuda"`` unless the CPU is asked for)."""

from __future__ import annotations

from .learn import trainer as _trainer
from .utils.checkpoint import find_latest_model, save_model  # noqa: F401


def Train_Agent(model_type, env, total_timesteps, use_action_masking,
                save_prefix=None, experiment=None, logpath=None,
                n_envs: int = 16, engine: str = "fastb", device="cuda"):
    """Reference training.py:51-213.  ``env`` is one of the host wrappers
    (its ``name``/config select the variant, its ``sort_agent`` is the
    press stage's frozen agent); only PPO is supported, as in the
    reference (training.py:145-146).  Returns the trained
    ``ActorCritic``."""
    if model_type != "PPO":
        raise ValueError(f"Unsupported model type: {model_type}")
    if env is None:
        raise ValueError("Environment must be provided")
    variant = env.name
    sort_params = getattr(env, "sort_agent", None)
    res = _trainer.train_agent(
        env.config, variant, total_timesteps, n_envs=n_envs,
        use_action_masking=use_action_masking, sort_params=sort_params,
        engine=engine, save_prefix=save_prefix or f"PPO_{variant}",
        verbose=True, device=device)
    return res.params


def RL_Trainer(env, env_class, model_list, max_steps, total_timesteps,
               noise_sorting, tag, seed, use_action_masking,
               test_steps=None, test_dir="./img/figures/", test_save=False,
               experiment=None, n_envs: int = 16, engine: str = "fastb",
               device="cuda"):
    """Reference training.py:220-265: loop over algos (PPO only)."""
    trained = {}
    for algo in model_list:
        if algo not in ("PPO", "DQN"):
            print(f"⏭️  Unsupported (or removed) algo '{algo}' – skipping.")
            continue
        if algo == "DQN":
            # unreachable in the reference too (Train_Agent raises)
            print("⏭️  DQN path not supported (as in the reference).")
            continue
        print(f"\n🏋🏽 Training {algo} - {env_class} ...")
        trained[algo] = Train_Agent(
            algo, env, total_timesteps, use_action_masking,
            save_prefix=f"{algo}_{env_class}", n_envs=n_envs, engine=engine,
            device=device)
    return trained
