"""The port's fastb engine against the JAX engine at sampler supports above
16 (``fastb._support_for``): 24 (noise 0.2), 40 (baseline accuracy 0.2) and
88 (batches of 250 units at accuracy 0.2), the supports whose kernel designs
of caps 32, 64 and 128 the card's tests hold against the plain version.
128 envs x 42 steps at max_steps=36, across an episode's end, in the rule,
unmasked external, masked press and sort variants; every state leaf and
output as in test_torch_fastb (bitwise, the sorting reward's tanh to 4
ulp)."""
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from test_torch_fastb import run_pair

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

# configs by sampler support, as tests/test_torch_step_kernel.py's
SUPPORT_CFGS = {24: {"noise_sorting": 0.2},
                40: {"baseline_accuracy": (0.2, 0.2, 0.2, 0.2)},
                88: {"input_batch_size": 250,
                     "baseline_accuracy": (0.2, 0.2, 0.2, 0.2)}}


@pytest.mark.parametrize("variant,masked,autoreset", [
    ("rule", True, True), ("external", False, True), ("press", True, False),
    ("sort", True, True)])
@pytest.mark.parametrize("support", sorted(SUPPORT_CFGS))
def test_support_bitwise(support, variant, masked, autoreset):
    kw = dict(bale_mode="events", max_steps=36, **SUPPORT_CFGS[support])
    assert TB._support_for(load_config(**kw)) == support
    run_pair(kw, variant, masked, 42, seed=5, autoreset=autoreset)
