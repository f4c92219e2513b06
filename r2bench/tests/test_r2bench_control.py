"""The control, at a size a test run holds: the reference put in the
program's place in the nearest lower precision, and the planted faults, each
fail one of the tiny cells' numbers, which the program's runs pass
(``test_r2bench_faults.py``).  At the cells' own size ``r2bench/control.py``
reads the same on the card."""

import time

import pytest
import torch

from r2bench import control, harness
from r2bench.drivers import serve
from tiny import SERVE_LIMITS, TRAIN_LIMITS, serve_cell, train_cell


@pytest.mark.parametrize("seed", [5, 2**31 + 1, 77])
def test_training_control_and_faults_fail_a_number(seed):
    readings = control.train_readings(train_cell(), seed, torch.device("cpu"))
    for name, numbers in readings.items():
        failed = [k for k, v in numbers.items() if v > TRAIN_LIMITS[k]]
        assert failed, (name, numbers)


@pytest.mark.parametrize("seed", [5, 2**31 + 1])
def test_serving_control_is_read_on_the_same_tokens(seed):
    """A float8 residual stream moves tokens far past the limit; at this size
    TF32 products move no token's argmax (nor do they at the cell's size
    past the program's own reordering: PERF.md)."""
    ctx = harness.Context(cell=serve_cell(), seed=seed, seconds=1.5, trace=False,
                          t_process=time.time(), device="cpu", control=True)
    checks = serve.run(ctx)["checks"]
    assert checks["logit_gap"][0] <= SERVE_LIMITS["logit_gap"]
    assert checks["tf32_products_logit_gap"][0] >= 0.0
    assert checks["float8_residual_logit_gap"][0] > SERVE_LIMITS["logit_gap"], checks
