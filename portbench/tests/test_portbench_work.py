"""The frozen work counts give the figures the port's kernel bounds were
first stated with (the chip smoke script's, at the default plant and 4096
envs)."""

import math

from portbench.work import counts as W

PAPER = {"max_steps": 200, "noise_sorting": 0.0, "balesize": 200}


def test_step_bytes_per_env():
    # kernel 1 (the external variant): 887 bytes per env at E = 33
    assert W.press_events(PAPER) == 33
    assert W.step_bytes_per_env(PAPER, "external") == 887
    # the rule step reads no action
    assert W.step_bytes_per_env(PAPER, "rule") == 883
    assert W.SORT_BYTES_PER_ENV == 96


def test_bounds_at_4096_envs():
    n = 4096
    step = W.kernel_bound_s(PAPER, "step_mono", "external", n)
    assert math.isclose(step * 1e6, 1.085, abs_tol=5e-4)      # bytes bound
    assert step == 887 * n / W.HBM_BYTES_PER_S
    sort = W.kernel_bound_s(PAPER, "sort_material", None, n)
    assert math.isclose(sort * 1e6, 0.549, abs_tol=5e-4)      # int ops
    assert W.sort_ops(PAPER, n) == (9175040, 22020096)
    assert W.step_ops(PAPER, "external", n) == (11755520, 22020096)


def test_noise_adds_four_blocks():
    noisy = dict(PAPER, noise_sorting=0.05)
    d = W.step_ops(noisy, "external", 1)[0] - W.step_ops(PAPER, "external",
                                                          1)[0]
    assert d == 4 * W.TF_BLOCK_OPS
    assert W.support_for(PAPER) == W.support_for(noisy) == 16


def test_model_flops():
    # SB3's (32, 32) towers: pi and vf forwards of the mono agent
    assert W.pi_flops("mono") == 2 * (29 * 32 + 32 * 32 + 32 * 22)
    assert W.vf_flops("mono") == 2 * (29 * 32 + 32 * 32 + 32)
    it = W.train_iteration_flops("mono", 4096, 64, 4, False)
    assert math.isclose(it / 1e9, 31.64, abs_tol=0.01)
    assert W.eval_step_flops("Random", 10) == 0
    assert W.eval_step_flops("PPO Modular", 1) == (W.pi_flops("sort")
                                                   + W.pi_flops("press"))
