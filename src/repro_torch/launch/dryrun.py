"""Dry run: count every (arch x shape x mesh) step on the meta device.

The port of the JAX package's ``launch/dryrun.py``.  Where JAX lowers and
compiles each step with production shardings and reads XLA's analyses, the
port runs the step itself on the ``meta`` device, where tensors carry shapes
and dtypes and no values: ``init_model`` and ``init_caches`` build the tree
without a generator, each kernel's dispatcher op runs its fake, and
``torch.utils.flop_counter.FlopCounterMode`` with ``cost_analysis.CostCounter``
counts the ops as they are dispatched.  It needs no card.  Each result is
written to ``experiments/dryrun_torch/`` with these keys:

* ``flops_per_device`` — the global FLOPs ``FlopCounterMode`` counts over
  the port's train step (forward and backward under remat, and AdamW),
  prefill or decode, divided by the chips; ``flops_per_device_by_class``
  splits them by the peak each runs at (``cost_analysis.Hardware``).  This
  is an even share of the global work, counted on the unsharded step; XLA's
  per-device count also holds the work each device repeats (replicated
  norms, a replicated router), and its FLOPs include elementwise ops, which
  ``FlopCounterMode`` does not count.
* ``hbm_bytes_per_device`` — each dispatched op's inputs read and outputs
  written, the kernels by their byte formulas, divided by the chips: an
  unfused count, not XLA's fused ``bytes accessed``.
* ``memory_analysis.argument_size_in_bytes`` — exact, per device: the
  tensors ``init_model`` and ``init_caches`` make and the batch, each
  divided by the extents of the mesh axes ``launch/sharding.py`` shards it
  over (params, AdamW's ``mu``, ``nu`` and ``count`` and the step in train
  mode; the caches, each with its int32 ``index`` as the JAX package holds
  it, in prefill and decode).  ``ModelConfig.param_count()`` is not used.
* ``memory_analysis.temp_size_in_bytes`` (train mode) — an estimate: the
  bytes of the tensors autograd saves for the backward on the meta device
  (``saved_tensors_hooks``; under remat, each layer's inputs), divided by
  the data ways.
* ``wire_bytes_per_device`` — the sum of two counts
  (``collectives_counted``), each byte in one of them:

  - ``gradient-sync``, the data-parallel gradient sync
    (:func:`wire_bytes`): ``sync="r2ccl"`` the bytes of the program
    ``core/collectives.py`` runs (``cost_analysis.program_wire_bytes``) in
    ``CommConfig.comm_dtype``, then a ring over the pods, over every leaf
    whole (JAX's ``shard_map`` takes the params with ``in_specs=P()``);
    ``sync="xla"`` a ring all-reduce of the fp32 gradients of the leaves no
    data axis splits.
  - the collectives of the production shardings (tensor-, FSDP- and
    expert-parallel), by kind in ``collective_op_bytes`` (operand bytes,
    ``collective_op_counts`` beside them), and their wire bytes by
    ``parse_collectives``' factors (:func:`sharded_collectives`): the step
    run a second time on meta DTensors over a fake process group of the
    mesh's size, placed by ``launch/sharding.py``'s specs, counting the
    collectives DTensor issues (``cost_analysis.CollectiveCounter``).  In a
    train step the gradients of the leaves a data axis does not split stay
    ``Partial`` over the data axes (that sum is ``gradient-sync``); under
    ``sync="xla"`` the reduce-scatter the backward issues for a leaf a data
    axis splits (FSDP) is that leaf's sync, as GSPMD's; under
    ``sync="r2ccl"`` the split leaves are first gathered whole over the data
    axes (``shard_map``'s entry).  GSPMD and DTensor pick their collectives
    each by its own rules (DTensor all-gathers where GSPMD may
    reduce-scatter), so the kinds can differ from the compiled HLO's
    (``tests/test_torch_dryrun_collectives.py`` states the readings).
    Those choices also change between DTensor's releases (smollm-360m's
    train_4k on 16 x 16: 54.8 GB a device on torch 2.13, 29.9 on 2.11), so
    ``collectives_torch`` records the release that counted.
* ``scan_corrected`` is always false: JAX corrects XLA's count of a
  scanned layer stack (a loop body counted once); the meta run of the FLOPs
  and bytes goes through every layer, so there is nothing to correct.  The
  DTensor count of the collectives runs on cuts of 1 and 2 pattern groups
  and extrapolates them by the groups, as JAX corrects its count
  (``collectives_extrapolated`` true when it did).

Usage (``--all`` runs the 11 registered archs; JAX's ``--all`` leaves out
paper-7b)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch X --shape Y --sync r2ccl
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES, CommConfig, InputShape, ModelConfig
from repro_torch.core.collectives import program_for
from repro_torch.models import apply_model, get_config, init_caches, init_model, model_axes
from repro_torch.models.registry import list_architectures
from repro_torch.optim import AdamWConfig
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn
from repro_torch.models.transformer import _lead_layers, _pattern_split
from repro_torch.training.train_step import (compute_loss, init_train_state,
                                             make_train_step, param_grads)
from repro_torch.tree import leaves, tree_map
from . import sharding as SH
from .cost_analysis import (COLLECTIVE_KINDS, H100_SXM, CollectiveCounter, CostCounter,
                            Hardware, all_reduce_wire_bytes, model_flops,
                            program_wire_bytes, roofline_terms)
from .mesh import MeshShape, data_axis_names, production_mesh_shape, rules_for

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
COLLECTIVES_COUNTED = ("the data-parallel gradient sync (gradient-sync) and, by kind, "
                       "the collectives DTensor issues for the shardings on the mesh")


# ---------------------------------------------------------------------------
# skip rules (the JAX package's)
# ---------------------------------------------------------------------------

def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    if cfg.encoder_only and shape.mode == "decode":
        return "encoder-only architecture has no decode step"
    return None


def long_context_window(cfg: ModelConfig, shape: InputShape) -> int | None:
    """Sliding-window substitution for dense archs at 500k (sub-quadratic
    requirement); native-state archs (ssm/hybrid/MLA) need no override."""
    if shape.name != "long_500k":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None                      # recurrent state / local attn native
    if cfg.attention is not None and cfg.attention.kind == "mla":
        return None                      # latent cache is linear in context
    return cfg.long_context_window


def cache_context_len(cfg: ModelConfig, shape: InputShape) -> int:
    w = long_context_window(cfg, shape)
    if w is not None:
        return w
    if cfg.attention is not None and cfg.attention.kind == "mla":
        return shape.seq_len
    if cfg.family in ("ssm",):
        return 1                         # state caches ignore this
    return shape.seq_len


# ---------------------------------------------------------------------------
# input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: InputShape,
                device: str | torch.device = "meta") -> dict[str, torch.Tensor]:
    """The batch of ``shape`` as empty tensors on ``device``: the JAX
    package's ``input_specs`` with meta tensors in place of
    ``ShapeDtypeStruct``s."""
    B, T = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def t(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    if cfg.modality.kind == "audio_frames":
        batch = {"frames": t((B, T, cfg.modality.frontend_dim), f32),
                 "labels": t((B, T), i32), "loss_mask": t((B, T), f32)}
    elif cfg.modality.kind == "vision_text":
        p = cfg.modality.num_prefix_tokens
        tlen = max(T - p, 1)
        batch = {"patches": t((B, p, cfg.modality.frontend_dim), f32),
                 "tokens": t((B, tlen), i32), "labels": t((B, tlen), i32)}
    else:
        batch = {"tokens": t((B, T), i32), "labels": t((B, T), i32)}
    if shape.mode == "decode":
        batch = {"tokens": t((B, 1), i32)}
    if shape.mode == "prefill":
        batch.pop("labels", None)
        batch.pop("loss_mask", None)
    return batch


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """The global counts of one step: FLOPs (``FlopCounterMode``'s total, and
    by peak class and by op from ``CostCounter``), unfused bytes, the
    kernels' dispatches, the bytes autograd saved, and the host seconds the
    count took."""

    flops: int
    flops_by_class: dict[str, int]
    flops_by_op: dict[str, int]
    hbm_bytes: int
    kernel_calls: dict[str, int]
    saved_bytes: int
    seconds: float


def count(step) -> Trace:
    """Run ``step()`` under ``FlopCounterMode`` and ``CostCounter``, with a
    hook that sums the bytes of the tensors autograd saves (leaves, the
    params, are arguments and left out).  Raises if the two FLOP counts
    differ: every counted op must fall in a peak class."""
    saved = [0]

    def pack(t: torch.Tensor):
        if not (t.is_leaf and t.requires_grad):
            saved[0] += t.numel() * t.element_size()
        return t

    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, CostCounter() as cc, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step()
    total = fc.get_total_flops()
    if total != cc.total_flops:
        raise RuntimeError(f"FlopCounterMode counted {total} FLOPs, CostCounter "
                           f"{cc.total_flops}: an op fell outside the peak classes")
    return Trace(int(total), {k: int(v) for k, v in cc.flops.items()},
                 {k: int(v) for k, v in cc.flops_by_op.items()}, int(cc.nbytes),
                 dict(cc.kernel_calls), saved[0], time.perf_counter() - t0)


def step_fn(cfg: ModelConfig, mode: str, batch: dict, params, *, caches=None,
            window_override: int | None = None):
    """The port's step as a user runs it, on ``params``' device: one
    ``make_train_step`` step on one process (forward, backward, AdamW; no
    sync), the engine's prefill, or its decode.  Returns a callable."""
    if mode == "train":
        step = make_train_step(cfg, AdamWConfig())
        state = init_train_state(params)
        return lambda: step(state, batch)
    if window_override is None:
        fn = (make_prefill_fn if mode == "prefill" else make_decode_fn)(cfg)
        if mode == "prefill":
            return lambda: fn(params, batch, caches)
        return lambda: fn(params, batch["tokens"][:, 0], caches)

    @torch.no_grad()
    def windowed():
        logits, _, _ = apply_model(params, cfg, batch, mode=mode, caches=caches,
                                   window_override=window_override)
        return torch.argmax(logits[:, -1], dim=-1)
    return windowed


def trace_step(cfg: ModelConfig, shape: InputShape, *, params=None,
               cache_dtype: torch.dtype = torch.bfloat16,
               context_len: int | None = None) -> Trace:
    """Count one step of ``shape`` (its mode, batch and length) on the meta
    device; ``params`` from ``init_model(cfg, device="meta")`` if given.
    The caches hold ``context_len`` positions (default: the shape's,
    :func:`cache_context_len`) in ``cache_dtype``."""
    params = init_model(cfg, device="meta") if params is None else params
    batch = input_specs(cfg, shape)
    caches, w = None, long_context_window(cfg, shape)
    if shape.mode != "train":
        caches = init_caches(cfg, shape.global_batch,
                             context_len or cache_context_len(cfg, shape),
                             window_override=w, dtype=cache_dtype, device="meta")
    return count(step_fn(cfg, shape.mode, batch, params, caches=caches,
                         window_override=w))


def one_card_bound(cfg: ModelConfig, mode: str, batch: int, length: int, *,
                   context_len: int | None = None,
                   cache_dtype: torch.dtype = torch.bfloat16, params=None,
                   hw: Hardware = H100_SXM) -> tuple[Trace, dict]:
    """(the count, its roofline terms) of one step on one card: ``mode``
    at ``batch`` sequences of ``length`` positions (a vision_text model's
    include its image patches), the caches of ``context_len`` positions."""
    shape = InputShape(f"{mode}_{batch}x{length}", length, batch, mode)
    trace = trace_step(cfg, shape, params=params, cache_dtype=cache_dtype,
                       context_len=context_len)
    return trace, roofline_terms(flops_per_device=trace.flops_by_class,
                                 hbm_bytes_per_device=trace.hbm_bytes,
                                 wire_bytes_per_device=0.0, chips=1, hw=hw)


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------

def _shard_bytes(t: torch.Tensor, spec: tuple, mesh: MeshShape,
                 skip: tuple[str, ...] = ()) -> int:
    """Bytes of one device's shard of ``t`` under ``spec`` (the divisibility
    rule has made every sharded extent divide its dimension), not dividing
    by the mesh axes in ``skip``."""
    ways = 1
    for entry in spec:
        for a in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            if a not in skip:
                ways *= mesh.shape[a]
    return t.numel() * t.element_size() // ways


def _cache_bytes(caches: dict, specs: dict, mesh: MeshShape) -> tuple[int, int]:
    """Per-device bytes of an ``init_caches`` dict under its specs: (its
    tensors, its indices).  A cache's ``index`` (a Python int in the port)
    counts as the JAX package holds it: an int32 scalar a layer, one a group
    in the stacked blocks."""
    tensors = index = 0
    for name, group in caches.items():
        for cache, spec in zip(group, specs[name]):
            fields = [(getattr(cache, f.name), getattr(spec, f.name))
                      for f in dataclasses.fields(cache)
                      if isinstance(getattr(cache, f.name), torch.Tensor)]
            tensors += sum(_shard_bytes(t, sp, mesh) for t, sp in fields)
            if hasattr(cache, "index"):
                index += 4 * (fields[0][0].shape[0] if name == "blocks" else 1)
    return tensors, index


def argument_bytes(cfg: ModelConfig, shape: InputShape, mesh: MeshShape, rules: dict,
                   params, *, cache_dtype: torch.dtype = torch.bfloat16,
                   context_len: int | None = None) -> dict[str, int]:
    """Per-device bytes of the step's arguments, by part, from the tensors
    ``init_model`` and ``init_caches`` make on the meta device and the specs
    of ``launch/sharding.py`` (``total`` their sum)."""
    baxes = data_axis_names(mesh)
    pspecs = SH.param_specs(mesh, rules, model_axes(cfg), params)
    per = leaves(tree_map(lambda p, s: _shard_bytes(p, s, mesh), params, pspecs))
    out = {"params": sum(per)}
    batch = input_specs(cfg, shape)
    bspecs = SH.batch_specs(mesh, batch, baxes)
    out["batch"] = sum(_shard_bytes(batch[k], bspecs[k], mesh) for k in batch)
    if shape.mode == "train":
        out["opt_state"] = 2 * out["params"] + 4        # mu, nu (fp32 like p), count
        out["step"] = 4
    else:
        caches = init_caches(cfg, shape.global_batch,
                             context_len or cache_context_len(cfg, shape),
                             window_override=long_context_window(cfg, shape),
                             dtype=cache_dtype, device="meta")
        out["caches"], out["cache_index"] = _cache_bytes(
            caches, SH.cache_specs(mesh, caches, baxes), mesh)
    out["total"] = sum(out.values())
    return out


def _axes_of(spec: tuple) -> set[str]:
    return {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}


def wire_bytes(cfg: ModelConfig, params, mesh: MeshShape, rules: dict, sync: str,
               comm: CommConfig | None) -> float:
    """Per-device bytes of the data-parallel gradient sync: each gradient
    leaf's shard over the model axes (the data axes hold it whole, as
    ``shard_map`` over them does), synced over the data axes.  Under
    ``sync="xla"`` a leaf a data axis splits (FSDP) is left out: its sync
    is the reduce-scatter of the backward, which :func:`sharded_collectives`
    counts."""
    baxes = data_axis_names(mesh)
    pspecs = SH.param_specs(mesh, rules, model_axes(cfg), params)
    elems = leaves(tree_map(lambda p, s: _shard_bytes(p, s, mesh, skip=baxes)
                            // p.element_size(), params, pspecs))
    if sync == "xla":
        ways = math.prod(mesh.shape[a] for a in baxes)
        data_split = leaves(tree_map(lambda p, s: bool(_axes_of(s) & set(baxes)),
                                     params, pspecs))
        return sum(all_reduce_wire_bytes(4 * n, ways)
                   for n, split in zip(elems, data_split) if not split)
    comm = comm or CommConfig(mode="ring")
    item = 2 if comm.comm_dtype == "bfloat16" else 4
    inner = program_for(mesh.shape[baxes[-1]], **comm.kwargs())
    wire = 0.0
    for n in elems:
        if inner is None:
            wire += all_reduce_wire_bytes(item * n, mesh.shape[baxes[-1]])
        else:
            wire += program_wire_bytes(inner, item * n, comm.comm_dtype)
        for ax in baxes[:-1]:         # the pods: a ring (the library's under xla)
            ring = None if comm.mode == "xla" else program_for(mesh.shape[ax], mode="ring")
            wire += (all_reduce_wire_bytes(item * n, mesh.shape[ax]) if ring is None
                     else program_wire_bytes(ring, item * n, comm.comm_dtype))
    return wire


# ---------------------------------------------------------------------------
# the sharded step's collectives (DTensor on a fake process group)
# ---------------------------------------------------------------------------

def mesh_order(mesh: MeshShape, specs) -> tuple[str, ...]:
    """The mesh's dims, permuted (if need be) so that every spec entry
    naming several axes names them in mesh order, which DTensor needs
    (``ep2d``'s ``("model", "pod", "data")``)."""
    entries = {e for spec in specs for e in spec if isinstance(e, tuple)}
    for order in itertools.permutations(mesh.axis_names):
        if all([order.index(a) for a in e] == sorted(order.index(a) for a in e)
               for e in entries):
            return order
    raise ValueError(f"no order of {mesh.axis_names} fits the specs {sorted(entries)}")


def _spec_without(spec: tuple, axes: tuple[str, ...]) -> tuple:
    """``spec`` with the mesh ``axes`` taken out of every entry."""
    def keep(e):
        kept = tuple(a for a in ((e,) if isinstance(e, str) else e or ()) if a not in axes)
        return None if not kept else kept[0] if len(kept) == 1 else kept
    return tuple(keep(e) for e in spec)


def _merge_data_axes(mesh: MeshShape) -> tuple[MeshShape, Callable]:
    """The mesh with its data axes (``pod``, ``data``) merged into one
    ``data`` axis of their product, and a function that rewrites a spec
    for it.  Every rule splits over ``pod`` and ``data`` together, so a
    split keeps its shard size, and a gather over both is one collective
    of the merged group, as XLA's replica groups span both."""
    baxes = data_axis_names(mesh)
    if len(baxes) < 2:
        return mesh, lambda spec: spec
    names = tuple(a for a in mesh.axis_names if a not in baxes)
    merged = MeshShape(("data", *names), {"data": math.prod(mesh.shape[a] for a in baxes),
                                          **{a: mesh.shape[a] for a in names}})

    def rewrite(spec: tuple) -> tuple:
        out = []
        for e in spec:
            axes = (e,) if isinstance(e, str) else e or ()
            if any(a in baxes for a in axes) and not set(baxes) <= set(axes):
                raise ValueError(f"spec {spec} splits over some of {baxes} only")
            kept = tuple(dict.fromkeys("data" if a in baxes else a for a in axes))
            out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
        return tuple(out)
    return merged, rewrite


def _reduce_over_model(grad, placements, names, baxes):
    """A gradient redistributed to its param's placements over the mesh
    dims that are not data axes; over the data axes it stays as it is."""
    target = [grad.placements[i] if n in baxes else p
              for i, (n, p) in enumerate(zip(names, placements))]
    return grad.redistribute(grad.device_mesh, target)


def count_collectives(cfg: ModelConfig, shape: InputShape, mesh: MeshShape, rules: dict,
                      sync: str = "xla", *, cache_dtype: torch.dtype = torch.bfloat16,
                      context_len: int | None = None) -> CollectiveCounter:
    """The collectives of one step of ``cfg`` (its whole depth) run on meta
    DTensors placed by ``rules`` on a fake ``mesh`` (:func:`SH.fake_mesh`,
    its data axes merged into one by :func:`_merge_data_axes`: DTensor's
    redistribute planner searches minutes a layer on three mesh dims):
    a train step's forward and backward (the gradients reduced over the
    model axes to their params' placements, left ``Partial`` over the data
    axes, and the metrics replicated), or a prefill or decode with the
    caches placed by their specs.  The serve step's pick of the next token
    (an argmax over vocab-split logits: a few bytes a sequence in GSPMD) is
    left out: DTensor's gathers the values and indices, which a fake group
    of meta tensors cannot run."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    merged, rewrite = _merge_data_axes(mesh)
    params = init_model(cfg, device="meta")
    pspecs = tree_map(lambda p, s: rewrite(s), params,
                      SH.param_specs(mesh, rules, model_axes(cfg), params))
    batch = input_specs(cfg, shape)
    bspecs = {k: rewrite(s) for k, s in
              SH.batch_specs(mesh, batch, data_axis_names(mesh)).items()}
    w = long_context_window(cfg, shape)
    caches = cspecs = None
    if shape.mode != "train":
        caches = init_caches(cfg, shape.global_batch,
                             context_len or cache_context_len(cfg, shape),
                             window_override=w, dtype=cache_dtype, device="meta")
        cspecs = SH.cache_specs(mesh, caches, data_axis_names(mesh))
        cspecs = {name: type(group)(
            type(c)(**{f.name: rewrite(getattr(c, f.name)) for f in dataclasses.fields(c)})
            for c in group) for name, group in cspecs.items()}
    baxes = data_axis_names(merged)
    specs = list(bspecs.values())
    tree_map(lambda p, s: specs.append(s), params, pspecs)
    with SH.fake_mesh(merged, mesh_order(merged, specs)) as dm, SH.counting_rules(), \
            implicit_replication():
        names = dm.mesh_dim_names
        counter = CollectiveCounter()
        dparams = SH.distribute(params, dm, pspecs)
        dbatch = {k: distribute_tensor(v, dm, SH.placements(dm, bspecs[k]))
                  for k, v in batch.items()}
        if shape.mode != "train":
            dcaches = SH.distribute_caches(caches, dm, cspecs)
            with counter, torch.no_grad():
                apply_model(dparams, cfg, dbatch, mode=shape.mode, caches=dcaches,
                            window_override=w)
            return counter
        with counter:
            if sync == "r2ccl":
                # shard_map(in_specs=P()) over the data axes: every leaf whole
                dparams = tree_map(
                    lambda p, s: SH.constrain(p, _spec_without(s, baxes)).detach(),
                    dparams, pspecs)
            flat = leaves(dparams)
            for p in flat:
                p.requires_grad_(True)
            total, metrics = compute_loss(dparams, cfg, dbatch)
            grads = param_grads(total, flat)
            for g, p in zip(grads, flat):
                if isinstance(g, DTensor):       # else a leaf the loss does not reach
                    _reduce_over_model(g, p.placements, names, baxes)
            for m in metrics.values():
                if isinstance(m, DTensor):
                    m.redistribute(dm, [Replicate()] * dm.ndim)
    return counter


def sharded_collectives(cfg: ModelConfig, shape: InputShape, mesh: MeshShape, rules: dict,
                        sync: str = "xla") -> dict[str, Any]:
    """:func:`count_collectives` of a stack of ``n_groups`` pattern groups,
    as JAX's dry run counts a scanned stack: on cuts of 1 and 2 groups (with
    the lead and remainder layers), extrapolated as ``c1 + (n_groups - 1)
    * (c2 - c1)`` kind by kind; a stack of one group is counted whole.
    Returns ``op_bytes``, ``op_counts`` and ``wire`` (by kind), the
    ``wire_bytes`` total and whether it ``extrapolated``."""
    n_groups, pattern, remainder = _pattern_split(cfg)

    def one(groups: int | None) -> dict[str, dict]:
        c = cfg if groups is None else dataclasses.replace(
            cfg, num_layers=_lead_layers(cfg) + groups * len(pattern) + len(remainder))
        counter = count_collectives(c, shape, mesh, rules, sync)
        return {"op_bytes": counter.op_bytes(), "op_counts": counter.op_counts(),
                "wire": counter.wire_by_kind()}

    if n_groups <= 1:
        out = one(None)
    else:
        c1, c2 = one(1), one(2)
        out = {key: {k: c1[key][k] + (n_groups - 1) * max(c2[key][k] - c1[key][k], 0)
                     for k in COLLECTIVE_KINDS} for key in c1}
    return dict(out, wire_bytes=sum(out["wire"].values()), extrapolated=n_groups > 1)


# ---------------------------------------------------------------------------
# one dry run
# ---------------------------------------------------------------------------

def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               sync: str = "xla", comm: CommConfig | None = None,
               sharding_mode: str = "auto", verbose: bool = True,
               cfg_override: ModelConfig | None = None, mesh: MeshShape | None = None,
               params=None, trace: Trace | None = None,
               hw: Hardware = H100_SXM) -> dict[str, Any]:
    """The dry run of ``arch`` at ``shape_name`` on the production mesh
    (``mesh`` overrides it).  ``params`` (meta) and ``trace`` may be passed
    in when the caller has them: a step's global counts do not depend on
    the mesh."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = mesh or production_mesh_shape(multi_pod=multi_pod)
    result: dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "sync": sync if shape.mode == "train" else "n/a",
    }
    reason = skip_reason(cfg, shape)
    if reason:
        result["skipped"] = reason
        return result
    chips = math.prod(mesh.shape.values())
    rules = rules_for(cfg, sharding_mode)
    params = init_model(cfg, device="meta") if params is None else params
    trace = trace_step(cfg, shape, params=params) if trace is None else trace
    args = argument_bytes(cfg, shape, mesh, rules, params)
    mem = {"argument_size_in_bytes": args["total"], "argument_bytes_by_part": args}
    grad_sync = 0.0
    if shape.mode == "train":
        grad_sync = wire_bytes(cfg, params, mesh, rules, sync, comm)
        ways = math.prod(mesh.shape[a] for a in data_axis_names(mesh))
        mem["temp_size_in_bytes"] = trace.saved_bytes // ways
        mem["temp_estimate"] = "bytes autograd saves on the meta device / data ways"
    mem["total_bytes"] = mem["argument_size_in_bytes"] + mem.get("temp_size_in_bytes", 0)
    sharded = sharded_collectives(cfg, shape, mesh, rules, sync)
    wire = grad_sync + sharded["wire_bytes"]
    by_class = {c: n / chips for c, n in trace.flops_by_class.items()}
    terms = roofline_terms(flops_per_device=by_class,
                           hbm_bytes_per_device=trace.hbm_bytes / chips,
                           wire_bytes_per_device=wire, chips=chips, hw=hw)
    tokens = shape.global_batch * (1 if shape.mode == "decode" else shape.seq_len)
    mflops = model_flops(cfg, tokens, "train" if shape.mode == "train" else "infer")
    result.update({
        "chips": chips,
        "mode": shape.mode,
        "hardware": hw.name,
        "scan_corrected": False,
        "collectives_extrapolated": sharded["extrapolated"],
        "trace_s": trace.seconds,
        "flops_per_device": trace.flops / chips,
        "flops_per_device_by_class": by_class,
        "hbm_bytes_per_device": trace.hbm_bytes / chips,
        "collectives_counted": COLLECTIVES_COUNTED,
        "collective_op_bytes": dict(sharded["op_bytes"], **{"gradient-sync": grad_sync}),
        "collective_op_counts": sharded["op_counts"],
        "collective_wire_bytes": dict(sharded["wire"], **{"gradient-sync": grad_sync}),
        "collectives_torch": torch.__version__,
        "wire_bytes_per_device": wire,
        "roofline": terms,
        "model_flops_global": mflops,
        "useful_flops_ratio": mflops / trace.flops if trace.flops else None,
        "kernel_calls": trace.kernel_calls,
        "memory_analysis": mem,
        "fits_hbm": mem["total_bytes"] <= hw.hbm_bytes,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    })
    if verbose:
        r = terms
        print(f"[{arch} x {shape_name} x {result['mesh']}] mode={shape.mode} "
              f"trace={trace.seconds:.1f}s compute={r['compute_s'] * 1e3:.2f}ms "
              f"mem={r['memory_s'] * 1e3:.2f}ms coll={r['collective_s'] * 1e3:.2f}ms "
              f"-> {r['bottleneck']}", flush=True)
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def variant_config(arch: str, variant: str | None) -> tuple[ModelConfig, str]:
    """(config, sharding mode) for a ``--variant`` string, as the JAX
    package's CLI reads it: ``expert_axis=<axis>``, ``sharding=<mode>``,
    ``remat=<bool>``, comma-separated."""
    cfg, sharding_mode = get_config(arch), "auto"
    for kv in (variant.split(",") if variant else ()):
        k, v = kv.split("=")
        if k == "expert_axis" and cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, expert_axis=v))
        elif k == "sharding":
            sharding_mode = v
        elif k == "remat":
            cfg = dataclasses.replace(cfg, remat=v.lower() == "true")
        else:
            raise SystemExit(f"unknown variant key {k}")
    return cfg, sharding_mode


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sync", default="xla", choices=["xla", "r2ccl"])
    ap.add_argument("--comm-mode", default="ring",
                    choices=["xla", "ring", "r2ccl", "recursive"])
    ap.add_argument("--degraded-rank", type=int, default=None)
    ap.add_argument("--lost-fraction", type=float, default=0.0)
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="config variant, e.g. 'expert_axis=model', "
                         "'sharding=fsdp_tp' or 'remat=false' (comma-separated)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_architectures() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    comm = None
    if args.sync == "r2ccl":
        comm = CommConfig(mode=args.comm_mode, degraded_rank=args.degraded_rank,
                          lost_fraction=args.lost_fraction)

    failures = []
    for arch in archs:
        params = None
        for shape in shapes:
            trace = None                  # one count serves every mesh
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}__{args.sync}"
                if args.variant:
                    tag += "__" + args.variant.replace("=", "-").replace(",", "_")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                try:
                    cfg, sharding_mode = variant_config(arch, args.variant)
                    if params is None:
                        params = init_model(cfg, device="meta")
                    if trace is None and not skip_reason(cfg, INPUT_SHAPES[shape]):
                        trace = trace_step(cfg, INPUT_SHAPES[shape], params=params)
                    res = dryrun_one(arch, shape, multi_pod=mp, sync=args.sync, comm=comm,
                                     sharding_mode=sharding_mode, cfg_override=cfg,
                                     params=params, trace=trace)
                    res["variant"] = args.variant
                except Exception as e:  # noqa: BLE001 — record and continue
                    res = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {e}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
