"""The dry run's whole sweep on the meta device: every registered arch
(``launch/dryrun.py``'s ``--all``: the 11 of the port's registry, where JAX's
``--all`` leaves out paper-7b) x the four input shapes x both production
meshes, at full width and depth, one test an arch.  Each completes without
a card; the encoder-only hubert-xlarge's decode shapes are skipped as JAX's
``skip_reason`` skips them and nothing else is; no plain scan walks its time
loop (the plain recurrences may run only at T = 1, RWKV-6's decode); every
count is positive and the per-device counts of the multi-pod mesh are half
the single-pod ones; the sharded step's collectives are counted by kind on
both meshes (the step on meta DTensors, on cuts of 1 and 2 pattern
groups), the wire bytes their sum with the gradient sync.
"""

import pytest

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DR
from repro_torch.launch.cost_analysis import COLLECTIVE_KINDS
from repro_torch.models import get_config, init_model
from repro_torch.models.registry import list_architectures


@pytest.fixture
def plain_scan_steps(monkeypatch):
    """The time steps each plain recurrence is asked to walk."""
    steps = []
    for name in ("reference_lru_scan", "reference_wkv", "reference_lru_scan_bwd",
                 "reference_wkv_bwd"):
        fn = getattr(ref, name)

        def spy(*args, _fn=fn, **kw):
            steps.append(args[0].shape[1])
            return _fn(*args, **kw)
        monkeypatch.setattr(ref, name, spy)
    return steps


@pytest.mark.parametrize("arch", list_architectures())
def test_sweep_completes_on_the_meta_device(arch, plain_scan_steps):
    cfg = get_config(arch)
    params = init_model(cfg, device="meta")
    for shape_name, shape in INPUT_SHAPES.items():
        trace = None if DR.skip_reason(cfg, shape) else DR.trace_step(cfg, shape, params=params)
        res = [DR.dryrun_one(arch, shape_name, multi_pod=mp, params=params, trace=trace,
                             verbose=False) for mp in (False, True)]
        if cfg.encoder_only and shape.mode == "decode":
            assert all(r["skipped"] == "encoder-only architecture has no decode step"
                       for r in res)
            continue
        sp, mp = res
        assert (sp["mesh"], sp["chips"], mp["mesh"], mp["chips"]) == ("16x16", 256,
                                                                     "2x16x16", 512)
        assert sp["flops_per_device"] > 0 and sp["hbm_bytes_per_device"] > 0
        assert mp["flops_per_device"] == pytest.approx(sp["flops_per_device"] / 2)
        assert sp["memory_analysis"]["argument_size_in_bytes"] > 0
        assert sp["roofline"]["bound_s"] > 0 and sp["scan_corrected"] is False
        for r in (sp, mp):
            wire = r["collective_wire_bytes"]
            assert set(wire) == {*COLLECTIVE_KINDS, "gradient-sync"}
            assert sum(r["collective_op_counts"].values()) > 0
            assert r["wire_bytes_per_device"] == pytest.approx(sum(wire.values()))
    assert all(t <= 1 for t in plain_scan_steps), plain_scan_steps
