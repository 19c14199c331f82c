"""The control on the card, at the cells' own sizes: the reference with
TF32 products, put in the program's place, comes out not correct.  These
need an NVIDIA GPU and skip without one; on the card:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda \
        -o addopts="" -q
"""

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


def _ctx(workload, seed):
    from portbench.lib import bench
    from portbench.lib.cell import Context
    return Context(bench.load_cell(ROOT, workload), seed, "cuda", False)


@pytest.mark.cuda
def test_train_control():
    _card()
    from portbench.traffic import train
    ctx = _ctx("train_mono.plant_paper", 4000000001)
    drv = train.Driver(ctx)
    ref = drv.reference_record()
    checks = train.compare(drv.reference_record(tf32=True), ref,
                           ctx.cell.traffic["limits"])
    assert not all(c.ok for c in checks), checks


@pytest.mark.cuda
def test_eval_control():
    _card()
    from portbench.traffic import eval_protocol as E
    ctx = _ctx("eval_5policy.plant_noise05", 4000000001)
    drv = E.Driver(ctx)
    drv.rows = drv._rows()
    ref = drv.reference_pass(drv.base)
    ctl = drv.reference_pass(drv.base, tf32=True)
    checks = E.compare(*ctl, *ref, ctx.cell.traffic)
    assert not all(c.ok for c in checks), checks
