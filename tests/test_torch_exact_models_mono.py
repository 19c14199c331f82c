"""The port's exact monolith 'model' step (the PPO Sort-Only and PPO
Modular benchmark scenarios) against the JAX package's: integer sort and
press agents, or the reference's random fallbacks from rng_sorting /
rng_pressing in their place, masked and not, at noise 0 and 0.05; 3 seeds
x 25 steps, every state leaf and output bitwise after each step.
"""
import pytest
import torch

from marl_sortingenv_tpu.core import exact_dynamics as JXD
from marl_sortingenv_tpu_torch.core import exact_dynamics as XD
from test_torch_exact_engine import run_case
from test_torch_exact_models import Q

torch.set_num_threads(1)


@pytest.mark.parametrize("noise,sort,press,masked", [
    (0.0, True, True, True), (0.0, True, False, True),
    (0.0, False, True, False), (0.0, False, False, True),
    (0.05, True, True, True), (0.05, False, False, False)])
def test_mono_model(noise, sort, press, masked):
    qs, qp = (Q["sort"] if sort else (None, None),
              Q["press"] if press else (None, None))
    run_case(noise,
             lambda c, s, a: JXD.step_mono_model_exact(c, s, qs[0], qp[0],
                                                       masked),
             lambda c, s, a: XD.step_mono_model_exact(c, s, qs[1], qp[1],
                                                      masked),
             None)
