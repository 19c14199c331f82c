"""The port's fastb variants against the JAX engine on the CPU: short runs
(128 envs, 42 steps at max_steps=36, across an episode boundary) of the
sort env, the press env (masked and sanitize), the unmasked monolith, and
the press-completion config (press times 1/2, balesize 16) where the event
log takes real writes, and unmasked actions outside the action space.
Tolerances as in test_torch_fastb."""
import os

import pytest
import torch

from test_torch_fastb import run_pair

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

STEPS = 42
BASE = dict(bale_mode="events", max_steps=36, balesize=24)
PRESS_DONE = dict(bale_mode="events", max_steps=36, press_time_1=1,
                  press_time_2=2, balesize=16)


@pytest.mark.parametrize("variant,masked,autoreset", [
    ("sort", True, True),
    ("press", True, False),
    ("press", False, True),
    ("external", False, False),
])
def test_variant_short_run_bitwise(variant, masked, autoreset):
    run_pair(BASE, variant, masked, STEPS, seed=11, autoreset=autoreset)


@pytest.mark.parametrize("variant", ["external", "press", "sort"])
def test_out_of_range_actions_bitwise(variant):
    """Unmasked actions outside the action space, negative ones and the
    int32 extremes included, decode with floor // and % in both engines."""
    run_pair(BASE, variant, False, STEPS, seed=23, autoreset=True,
             action_range=(-40, 40))


@pytest.mark.parametrize("variant", ["rule", "sort"])
def test_press_completion_events_bitwise(variant):
    st = run_pair(PRESS_DONE, variant, True, STEPS, seed=19,
                  autoreset=False)
    assert int(st.ev_cnt.max()) > 0, "no press completed"


def test_unported_paths_raise(tmp_path):
    """Sharded training, ported since, refuses a ``mesh`` that is not a
    ``DeviceMesh`` with a clear ``TypeError``.  The episode dashboard,
    which raised until it was ported, draws."""
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.eval import harness
    from marl_sortingenv_tpu_torch.learn import ppo

    cfg = load_config(**BASE)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ppo.make_train_iteration(cfg, ppo.PPOConfig(),
                                 ppo.spec_for("mono", "fastb"),
                                 mesh=object())
    harness.run_episode(cfg, 1, 2, render=True, device="cpu",
                        render_kwargs={"save": True, "fmt": "png",
                                       "log_dir": str(tmp_path)})
    assert os.listdir(tmp_path) == ["plot.png"]
