"""The port's integer-exact engine against the JAX package's at noise
0.05: the monolith's external and legacy-random steps, masked and not,
3 seeds x 25 steps, every state leaf and output bitwise after each step
(helpers in test_torch_exact_engine.py).
"""
import pytest
import torch

from test_torch_exact_engine import CASES, run_case

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["external_masked", "external_unmasked",
                                  "random_masked", "random_unmasked"])
def test_steps_noise005(case):
    run_case(0.05, *CASES[case])
