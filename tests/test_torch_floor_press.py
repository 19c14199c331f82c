"""The port's press agent learning floor, with the frozen tuned sort agent
(tests/test_ppo.py:79-161 on the port): the JAX package's settings and
floor, the setup of tests/test_torch_ppo.py.  One floor per file, so that
workers that take whole files run the three floors side by side."""
import torch

from marl_sortingenv_tpu_torch.models import mlp
from test_torch_ppo import SORT_NPZ, _learn

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


def test_press_agent_learning_floor():
    """With the frozen tuned sort agent in the env step."""
    sp = mlp.load_npz(SORT_NPZ, device="cpu").requires_grad_(False)
    r0, r1 = _learn("press", 15, sort_policy=sp)
    assert r1 >= -100.0, (r0, r1)
    assert r1 > r0 + 20.0, (r0, r1)
