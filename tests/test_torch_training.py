"""The port's training step, data and checkpoints against the JAX package's
(single process; the multi-rank runs are in ``test_torch_training_ranks.py``).

Both sides start from the same weights (JAX ``init_model``, converted) and
see the same batches.  Tolerances: loss and params within 5e-3 after 4 steps
(the bound of ``tests/test_multidevice.py``'s training parity).  The gaps
come from bf16 roundings of the residual stream (``_torch_grad_parity.py``),
which Adam turns into up to one learning-rate step (1e-3) per step on
weights whose gradient is near zero: measured 1.7e-4 in loss and 2.1e-3 in
params against the jitted JAX step.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_parity import converted_params
from _torch_train_ref import jax_losses_and_params
from repro.data import make_batch as jax_make_batch
from repro.models import get_smoke_config as jax_smoke
from repro.training import init_train_state as jax_init_train_state
from repro.training import restore_checkpoint
from repro_torch.data import make_batch
from repro_torch.models import get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step, save_checkpoint
from repro_torch.tree import leaves

TOL = 5e-3
STEPS, SEQ, BATCH = 4, 16, 4


def test_make_batch_matches_jax():
    for arch in ("smollm-360m", "glm4-9b", "paper-7b"):
        for step in (0, 3):
            a = make_batch(get_smoke_config(arch), seq_len=24, batch_size=3, step=step, seed=1)
            b = jax_make_batch(jax_smoke(arch), seq_len=24, batch_size=3, step=step, seed=1)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_xla_sync_steps_match_jax():
    """4 steps of ``sync="xla"`` in one process (no data axis) against the
    JAX package's; step 0 has lr scale 0 (warm-up), the later ones move."""
    cfg, jp, _ = converted_params("smollm-360m")
    jl, jparams = jax_losses_and_params("smollm-360m", steps=STEPS, seq_len=SEQ,
                                        batch=BATCH)
    tcfg = get_smoke_config("smollm-360m")
    state = init_train_state(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                             device="cpu"))
    step = make_train_step(tcfg, AdamWConfig(lr=1e-3), sync="xla", warmup_steps=1,
                           total_steps=100)
    tl = []
    for i in range(STEPS):
        b = make_batch(tcfg, seq_len=SEQ, batch_size=BATCH, step=i)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(m) == {"loss", "aux_loss", "mtp_loss", "grad_norm", "lr"}
        tl.append(float(m["loss"]))
    assert state.step == STEPS and state.opt_state["count"] == STEPS
    assert max(abs(a - b) for a, b in zip(tl, jl)) <= TOL
    diff = max(float(np.abs(a.detach().numpy() - b).max())
               for a, b in zip(leaves(state.params), jparams))
    assert diff <= TOL


def test_checkpoint_reads_back_in_jax(tmp_path):
    """A checkpoint the port writes loads with the JAX package's
    ``restore_checkpoint`` into a JAX train state, value for value."""
    cfg, jp, tp = converted_params("glm4-9b")
    tcfg = get_smoke_config("glm4-9b")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    state = init_train_state(params)
    step = make_train_step(tcfg, AdamWConfig(lr=1e-3), sync="xla", warmup_steps=0,
                           total_steps=10)
    for i in range(2):
        b = make_batch(tcfg, seq_len=8, batch_size=2, step=i)
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    save_checkpoint(str(tmp_path), state, 2, extra={"arch": "glm4-9b"})
    meta = json.loads((tmp_path / "step_2.json").read_text())
    assert meta["step"] == 2 and meta["arch"] == "glm4-9b"
    assert "params/embed/embedding" in meta["keys"] and "opt_state/count" in meta["keys"]

    template = jax_init_train_state(jp)
    restored, at = restore_checkpoint(str(tmp_path), template)
    assert at == 2 and int(restored.step) == 2 and int(restored.opt_state["count"]) == 2
    for a, b in zip(leaves(state.params), jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for key in ("mu", "nu"):
        for a, b in zip(leaves(state.opt_state[key]),
                        jax.tree_util.tree_leaves(restored.opt_state[key])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_step_refuses_bad_sync():
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(ValueError, match="sync"):
        make_train_step(cfg, AdamWConfig(), sync="nccl")
    with pytest.raises(ValueError, match="axis"):
        make_train_step(cfg, AdamWConfig(), sync="r2ccl")
    assert dataclasses.is_dataclass(init_train_state({"w": torch.zeros(2)}))


def test_port_restores_a_checkpoint_jax_writes(tmp_path):
    """The port's ``restore_checkpoint`` (the quickstart example's round
    trip) reads a checkpoint the JAX package writes into a port train
    state: tensors value for value in the template's dtype, the step and
    the optimizer count as ints."""
    from repro.training import save_checkpoint as jax_save_checkpoint
    from repro_torch.training import restore_checkpoint as port_restore_checkpoint

    _, jp, _ = converted_params("glm4-9b")
    jstate = jax_init_train_state(jax.tree_util.tree_map(lambda x: x + 1.0, jp))
    jstate = dataclasses.replace(jstate, step=jnp.asarray(5, jnp.int32),
                                 opt_state=dict(jstate.opt_state,
                                                count=jnp.asarray(5, jnp.int32)))
    jax_save_checkpoint(str(tmp_path), jstate, 5)
    template = init_train_state(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                                device="cpu"))
    restored, at = port_restore_checkpoint(str(tmp_path), template)
    assert at == 5 and restored.step == 5 and restored.opt_state["count"] == 5
    for a, b in zip(leaves(restored.params), jax.tree_util.tree_leaves(jstate.params)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
