"""The port's rounding helpers (marl_sortingenv_tpu_torch/core/dynamics.py:
``py_round2``, ``np_round2``, ``py_round_int``) against Python's and
NumPy's ``round`` and the JAX package's helpers, at the edge values of
tests/test_round_parity.py (1/40, 370/400, halves, negatives, subnormals)
and over the purity and occupancy domains the dynamics reach.  Bitwise."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from marl_sortingenv_tpu.core import dynamics as JD
from marl_sortingenv_tpu_torch.core import dynamics as D

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

Z = np.uint64(0)
EDGES = np.array([0.0, 0.005, 0.015, 0.025, 1 / 40, 0.125, 1.0,
                  370 / 400, 0.925, -0.04999999999999993, -0.125, -0.025,
                  -1 / 40, 0.9999999999999999, 5e-324, 1e-300, 200.0,
                  0.5, 1.5, 2.5, 74.5, -0.5, 0.4999999999999999, 399.995])


def test_py_round2_matches_python():
    x = np.concatenate([EDGES, np.arange(401) / 100.0])
    got = D.py_round2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [round(float(v), 2) for v in x])
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(JD.py_round2)(jnp.asarray(x), Z)))


def test_np_round2_matches_numpy():
    pairs = [(t, n) for n in range(1, 401) for t in range(0, n + 1, 3)]
    x = np.array([t / n for t, n in pairs] + [1.0 - (n - t) / n
                                            for t, n in pairs])
    x = np.concatenate([EDGES, x, np.arange(101) / 100 - 0.9])
    got = D.np_round2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [round(np.float64(v), 2) for v in x])
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(JD.np_round2)(jnp.asarray(x), Z)))


def test_semantics_differ_at_370_over_400():
    x = torch.tensor([370.0], dtype=torch.float64) / 400.0
    assert float(D.np_round2(x)) == 0.92
    assert float(D.py_round2(x)) == 0.93


def test_py_round_int_bankers():
    x = np.array([0.5, 1.5, 2.5, 3.5, 4.5, 0.4999999999999999, 74.5, 75.5,
                  -0.5, -1.5, 30.000000000000004, 29.999999999999996])
    got = D.py_round_int(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert got.tolist() == [round(float(v)) for v in x]
    assert got.tolist() == np.asarray(JD.py_round_int(jnp.asarray(x))
                                      ).tolist()
