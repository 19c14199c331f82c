"""The port's copy of the reward tables (marl_sortingenv_tpu_torch/core/
reward_tables.py) equals the JAX package's array by array, for the
default config and a second grid threshold; an off-grid threshold is
refused by both, and the port's sorting reward then falls back to
``torch.tanh`` within 4 ulp of NumPy's."""
import dataclasses

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import reward_tables as JRT
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import dynamics as D
from marl_sortingenv_tpu_torch.core import reward_tables as RT
from marl_sortingenv_tpu_torch.core import state as S

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [{}, {"purity_threshold_theta": 0.7,
                                     "quality_threshold": 0.85}])
def test_tables_equal_jax(kw):
    for build in ("build_sorting_table", "build_press_table"):
        got = getattr(RT, build)(load_config(**kw))
        want = getattr(JRT, build)(jload(**kw))
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


def test_off_grid_threshold_falls_back_to_tanh():
    cfg = load_config(quality_threshold=0.905)
    with pytest.raises(AssertionError):
        RT.build_sorting_table(cfg)
    st = S.reset(cfg, np.arange(6), device="cpu")
    true = torch.tensor([[50, 0, 7, 700], [1, 2, 3, 4], [9, 9, 9, 9],
                         [0, 0, 0, 0], [120, 33, 0, 5], [3, 0, 1, 0]],
                        dtype=torch.int32)
    false = torch.tensor([[5, 0, 1, 2], [0, 2, 1, 0], [1, 3, 0, 9],
                          [0, 1, 0, 0], [9, 0, 2, 5], [0, 0, 0, 1]],
                         dtype=torch.int32)
    e = torch.zeros(6, 1, dtype=torch.int32)
    st = st._replace(cont_true=torch.cat([true, e], 1), cont_false=false)
    got = D.calculate_sorting_reward(cfg, st).numpy()
    d = D.container_purities(cfg, st).numpy() - cfg.purity_threshold_theta
    score = ((d[:, 0] + d[:, 1]) + d[:, 2]) + d[:, 3]
    want = np.tanh(((score / 4.0) * cfg.purity_scaling_factor)
                   / cfg.tanh_temperature)
    ulp = np.spacing(np.abs(want))
    assert (np.abs(got - want) <= 4 * ulp).all()
