"""The port's mono agent learning floor (tests/test_ppo.py:79-161 on the
port): the JAX package's settings and floor, the setup of
tests/test_torch_ppo.py.  One floor per file, so that workers that take
whole files run the three floors side by side."""
import torch

from test_torch_ppo import _learn

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


def test_mono_agent_learning_floor():
    r0, r1 = _learn("mono", 15)
    assert r1 >= -70.0, (r0, r1)
    assert r1 > r0 + 20.0, (r0, r1)
