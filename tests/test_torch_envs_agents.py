"""The port's ``Env_3_Monolith`` in its model mode (the tuned sort and
press agents) and its mono-agent mode (the tuned mono agent), masked and
unmasked, against the JAX package's on the CPU, as test_torch_envs.py
holds the other modes: 60 steps at max_steps 20 with an unseeded reset at
each episode's end, every output, info, mask, log and accessor equal, an
agent's action differing only at a counted argmax near-tie.
"""
import pytest
import torch

from test_torch_envs import ids, run_case

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

BOTH = {"sort_agent": "sort", "press_agent": "press"}
CASES = [("mono", "model", True, BOTH, False),
         ("mono", "model", False, BOTH, False),
         ("mono", "agent", True, {"mono_agent": "mono"}, False),
         ("mono", "agent", False, {"mono_agent": "mono"}, False)]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_agent_modes_equal_jax(monkeypatch, case):
    run_case(monkeypatch, case)
