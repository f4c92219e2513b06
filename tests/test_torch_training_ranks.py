"""The port's data-parallel training on 4 gloo ranks (``launch.ranks``, on
the CPU), against the JAX package, and its failover mid-training (the
counterparts of ``tests/test_multidevice.py``'s training tests), plus the
training CLI.  Each run starts its ranks once.

Tolerance: loss and params within 5e-3 of the JAX package's ``sync="xla"``
training after 4 steps — the bound ``tests/test_multidevice.py`` holds the
JAX package's own r2ccl sync to (the wire is bf16).
"""

import json

import jax
import numpy as np
import pytest

from _torch_model_parity import converted_params
from _torch_ranks import train_rank
from _torch_train_ref import jax_losses_and_params
from repro_torch.launch import ranks
from repro_torch.launch import train as train_cli

TOL = 5e-3
R2CCL = dict(mode="r2ccl", degraded_rank=1, lost_fraction=0.5, devices_per_node=2)


def _spec(arch, **kw):
    _, jp, _ = converted_params(arch)
    spec = dict(arch=arch, params=jax.tree_util.tree_map(np.asarray, jp), lr=1e-3,
                warmup=1, total=100, steps=4, seq_len=16, batch=8)
    spec.update(kw)
    spec.setdefault("cycle", spec["steps"])
    return spec


def test_r2ccl_sync_on_4_ranks_matches_jax():
    spec = _spec("smollm-360m", phases=[(0, "r2ccl", R2CCL)])
    out = ranks.run(train_rank, 4, "cpu", args=(spec,), timeout=600)
    jl, jparams = jax_losses_and_params("smollm-360m", steps=4, seq_len=16, batch=8)
    for r in range(4):
        assert max(abs(a - b) for a, b in zip(out[r]["losses"], jl)) <= TOL
    ours = list(out[0]["params"].values())      # leaves in JAX order
    assert len(ours) == len(jparams)
    assert max(float(np.abs(a - b).max()) for a, b in zip(ours, jparams)) <= TOL


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_r2ccl_sync_on_4_ranks_matches_jax_recurrent(arch):
    """The recurrent families trained data-parallel with ``sync="r2ccl"``
    (degraded rank 1): losses and params after 4 steps against the JAX
    package's ``sync="xla"`` training of the same smoke config."""
    spec = _spec(arch, phases=[(0, "r2ccl", R2CCL)])
    out = ranks.run(train_rank, 4, "cpu", args=(spec,), timeout=600)
    jl, jparams = jax_losses_and_params(arch, steps=4, seq_len=16, batch=8)
    for r in range(4):
        assert max(abs(a - b) for a, b in zip(out[r]["losses"], jl)) <= TOL
    ours = list(out[0]["params"].values())      # leaves in JAX order
    assert len(ours) == len(jparams)
    assert max(float(np.abs(a - b).max()) for a, b in zip(ours, jparams)) <= TOL


def test_failover_mid_training():
    """Switch the gradient-sync schedule mid-run (hot repair): a ring for 8
    steps, then the degraded R2CCL program; the loss stays finite and keeps
    falling.  The run cycles over 4 batches, so the first and the last 4
    losses are on the same data (16 steps of fresh synthetic batches move
    the loss less than the batches differ)."""
    spec = _spec("smollm-360m", lr=3e-3, warmup=5, total=200, steps=16, seq_len=32,
                 cycle=4,
                 phases=[(0, "r2ccl", dict(mode="ring")),
                         (8, "r2ccl", dict(mode="r2ccl", degraded_rank=2,
                                           lost_fraction=0.5))])
    out = ranks.run(train_rank, 4, "cpu", args=(spec,), timeout=600)
    losses = out[0]["losses"]
    assert all(o["losses"] == losses for o in out)      # ranks agree exactly
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_train_cli_smoke_on_cpu(tmp_path, capsys):
    res = train_cli.main(["--smoke", "--device", "cpu", "--world-size", "4",
                          "--steps", "4", "--seq-len", "16", "--batch", "8",
                          "--sync", "r2ccl", "--fail-at-step", "2", "--fail-node", "1",
                          "--nics-per-node", "2", "--log-every", "1",
                          "--checkpoint-dir", str(tmp_path)])
    closing = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(closing) == {"first_loss", "last_loss", "decreased"}
    assert res["scheds"] == ["healthy"] * 2 + ["degraded"] * 2
    assert res["located"] is not None and np.isfinite(res["history"]).all()
    assert len(res["ranks"]) == 4 and res["launches"]["chunk_combine"] == 0   # CPU
    assert (tmp_path / "step_4.npz").exists()
