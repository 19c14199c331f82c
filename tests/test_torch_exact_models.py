"""The port's integer-policy exact steps against the JAX package's, on the
CPU, with no tolerance: the press step with the frozen integer sort agent
and the monolith-agent benchmark step, masked and not, at noise 0 and
0.05, with the agents of ``artifacts/models_masked`` quantized by each
package; 3 seeds x 25 steps, every state leaf and output (the agents'
actions included) bitwise after each step.  The monolith 'model' step is
in test_torch_exact_models_mono.py.
"""
import pytest
import torch

from marl_sortingenv_tpu.core import exact_dynamics as JXD
from marl_sortingenv_tpu_torch.core import exact_dynamics as XD
from test_torch_exact_engine import run_case
from test_torch_mlp_exact import pair

torch.set_num_threads(1)

Q = {name: pair(name) for name in ("sort", "press", "mono")}


def press_case(masked):
    qj, qt = Q["sort"]
    return (lambda c, s, a: JXD.step_press_model_exact(c, s, a, qj, masked),
            lambda c, s, a: XD.step_press_model_exact(c, s, a, qt, masked),
            "press")


def policy_case(masked):
    qj, qt = Q["mono"]
    return (lambda c, s, a: JXD.step_mono_policy_exact(c, s, qj, masked),
            lambda c, s, a: XD.step_mono_policy_exact(c, s, qt, masked),
            None)


@pytest.mark.parametrize("noise,masked", [(0.0, True), (0.0, False),
                                          (0.05, True)])
def test_press_model(noise, masked):
    run_case(noise, *press_case(masked))


@pytest.mark.parametrize("noise,masked", [(0.0, True), (0.0, False),
                                          (0.05, False)])
def test_mono_policy(noise, masked):
    run_case(noise, *policy_case(masked))
