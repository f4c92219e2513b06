"""A run of each driver with the chip look skipped, at a tiny size on the
CPU: sound, it is correct; with each fault the cell can have planted under
its timed path, from the first step or only after the steps the set-up check
follows, ``correct`` comes out false; with the JAX package in a rank, the run
exits 3 and prints no result."""

import time

import pytest
import torch

from r2bench import harness, run as run_py
from r2bench.drivers import serve, train
from tiny import serve_cell, train_cell

TRAIN_FAULTS = ["state_unchanged", "half_batch", "no_exchange"]
LATE_FAULTS = [f"late_{f}" for f in TRAIN_FAULTS]


@pytest.fixture(autouse=True)
def float32_products():
    yield
    torch.set_float32_matmul_precision("highest")


def run(module, cell, fault=None, seed=2**31 + 11):
    ctx = harness.Context(cell=cell, seed=seed, seconds=1.5, trace=False, t_process=time.time(),
                          device="cpu", fault=fault and f"r2bench.tests.faults:{fault}")
    out = module.run(ctx)
    line, lines = harness.result(ctx, out)
    assert list(line)[-1] == "checks" and len(lines) == len(out["checks"])
    return line


@pytest.mark.parametrize("traffic", ["dp4-ring", "dp4-nicfail"])
def test_sound_training_run_is_correct(traffic):
    line = run(train, train_cell(traffic))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"} or not line["metrics"]


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_training_fault_is_caught(fault):
    line = run(train, train_cell(), fault)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("traffic", ["dp4-ring", "dp4-nicfail"])
@pytest.mark.parametrize("fault", LATE_FAULTS)
def test_training_fault_after_the_set_up_steps_is_caught(fault, traffic):
    line = run(train, train_cell(traffic), fault)
    assert not line["correct"], (fault, line["checks"])
    setup = [k for k in line["checks"] if not k.startswith("after_")
             and k not in ("ranks_param_mismatch", "precision_departures")]
    assert all(line["checks"][k]["value"] <= line["checks"][k]["limit"] for k in setup)


def test_training_tf32_products_are_caught():
    line = run(train, train_cell(), "tf32_products")
    assert not line["correct"] and line["checks"]["precision_departures"]["value"] > 0


def test_jax_package_in_a_rank_stops_the_run(capsys):
    ctx = harness.Context(cell=train_cell(), seed=2**31 + 11, seconds=1.0, trace=False,
                          t_process=time.time(), device="cpu",
                          fault="r2bench.tests.faults:jax_package_loaded")
    assert run_py.measure(ctx) == 3
    out, err = capsys.readouterr()
    assert out == "" and "repro.planted" in err


def test_sound_serving_run_is_correct():
    line = run(serve, serve_cell())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_serving_token_fault_is_caught():
    line = run(serve, serve_cell(), "token_altered")
    assert not line["correct"], line["checks"]


def test_serving_tf32_products_are_caught():
    line = run(serve, serve_cell(), "tf32_serving")
    assert not line["correct"] and line["checks"]["precision_departures"]["value"] > 0
