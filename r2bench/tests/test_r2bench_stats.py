"""The window's statistics: the percentile helper, the union of intervals and
the idle gaps, the guard against JAX in the process."""

import math

import pytest

from r2bench import harness


def test_percentile_nearest_rank():
    values = list(range(1, 101))          # 1..100
    assert harness.percentile(values, 90) == 90
    assert harness.percentile(values, 50) == 50
    assert harness.percentile(values, 100) == 100
    assert harness.percentile([7.0], 90) == 7.0
    # ten values: the 90th percentile is the 9th smallest, one value beyond it
    assert harness.percentile([float(v) for v in range(10, 0, -1)], 90) == 9.0


def test_percentile_counts_failed_requests_as_misses():
    served = [0.1] * 89
    assert harness.percentile(served + [math.inf] * 11, 90) == math.inf
    assert harness.percentile(served + [0.2] + [math.inf] * 10, 90) == 0.2


def test_ttft_reader_takes_the_p90_over_every_request():
    read = harness.load_reader("ttft_p90_ms.serve")
    assert read({}) is None and read({"serve": {"ttft_s": []}}) is None
    assert read({"serve": {"ttft_s": [0.001 * v for v in range(1, 101)]}}) == pytest.approx(90.0)
    assert read({"serve": {"ttft_s": [0.1] * 89 + [math.inf] * 11}}) == math.inf


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        harness.percentile([], 90)


def test_union_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 10), (8, 9)]
    assert harness.merge_intervals(iv) == [(0, 3), (5, 7), (8, 9)]
    assert harness.union_length(iv) == 3 + 2 + 1
    assert harness.union_length([]) == 0


def test_idle_gaps_and_busy_share():
    busy = [(1, 3), (2, 4), (6, 7), (-5, 0.5)]
    assert harness.idle_gaps(busy, 0, 10) == [(0.5, 1), (4, 6), (7, 10)]
    clipped = harness.clip_intervals(busy, 0, 10)
    assert harness.union_length(clipped) == 0.5 + 3 + 1
    assert harness.idle_gaps([], 0, 2) == [(0, 2)]
    # four ranks whose kernels overlap count once
    ranks = [[(0, 4)], [(2, 6)], [(5, 7)], [(9, 10)]]
    flat = [iv for r in ranks for iv in r]
    assert 1 - harness.union_length(harness.clip_intervals(flat, 0, 10)) / 10 == pytest.approx(0.2)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax", "repro", "repro.core",
            "repro_torch", "repro_torch.core", "jaxtyping", "reprobe", "numpy"]
    assert harness.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "repro", "repro.core"])
