"""The port's parity engine against the JAX package's on the CPU, as in
test_torch_parity_engine.py, on the noise-0.05 config (the accuracies
then carry the uniform noise draws): the unmasked external step and the
model step with the tuned sort agent, 4 seeds x 60 steps, every leaf and
output bitwise but at counted argmax near-ties of the agent."""
import pytest
import torch

from marl_sortingenv_tpu.core import step as JST
from marl_sortingenv_tpu_torch.core import step as ST
from test_torch_fastb_model import agent, jax_agent
from test_torch_parity_engine import run_case

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["external_unmasked", "model"])
def test_noise_config(monkeypatch, kind):
    kw = dict(noise_sorting=0.05)
    if kind == "model":
        jp, tp = jax_agent("sort"), agent("sort")
        run_case(monkeypatch, kw,
                 lambda c, s, a: JST.step_mono_model(c, s, jp, None, True),
                 lambda c, s, a: ST.step_mono_model(c, s, tp, None, True))
    else:
        run_case(monkeypatch, kw,
                 lambda c, s, a: JST.step_mono_external(c, s, a, False),
                 lambda c, s, a: ST.step_mono_external(c, s, a, False),
                 "mono")
