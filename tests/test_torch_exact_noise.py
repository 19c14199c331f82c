"""The port's integer-exact engine against the JAX package's at the
reference's default noise 0.05, where the accuracies come from the
soft-float noise pipeline and the split from a soft-float product: the
rule, sort and press steps, 3 seeds x 25 steps, every state leaf and
output bitwise after each step (helpers in test_torch_exact_engine.py;
the monolith's external and random steps in
test_torch_exact_noise_mono.py).
"""
import pytest
import torch

from test_torch_exact_engine import CASES, run_case

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["rule", "sort", "press_masked",
                                  "press_unmasked"])
def test_steps_noise005(case):
    run_case(0.05, *CASES[case])
