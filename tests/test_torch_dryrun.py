"""The port's dry run (``launch/dryrun.py``, ``launch/roofline.py``) held to
the JAX package's where both count the same work.

* ``init_model`` and ``init_caches`` on the meta device give the CPU's tree,
  shapes and dtypes (every arch's smoke config).
* ``FlopCounterMode`` counts the same FLOPs for a smoke model on the meta
  device (the ops' fakes) and on the CPU through the ops (their plain
  versions, ``ops.use("op")``), in prefill and in a training step's
  forward and backward, with remat on; exact (integer counts).
* Per-device argument bytes equal XLA's ``argument_size_in_bytes`` of JAX's
  compiled step on a (4, 2) ``("data", "model")`` mesh, for glm4-smoke,
  dbrx-smoke (MoE) and paligemma-smoke, in prefill and train mode; exact
  (JAX's prefill without its unread caches, as its dry run jits it; with
  them under ``keep_unused=True``).
* Ring and r2ccl wire bytes equal ``parse_collectives(...).wire_bytes`` of
  JAX's ``all_reduce`` under ``shard_map`` on 8 devices (both run the same
  schedule IR); exact, bf16 against half the CPU backend's f32 operands.
* Matmul FLOPs outside attention and the scans equal the ``dot_general``
  FLOPs of ``jax.make_jaxpr(apply_model)`` at full width (prefill, layers
  unrolled, depth cut to one pattern group), JAX's attention and scans
  separated as the ``dot_general``s inside its loops (``scan`` / ``while``:
  blockwise attention's key-block loop, the recurrences); exact.  What XLA
  counts beyond (elementwise FLOPs, fused bytes) the port does not count.
* ``skip_reason``, ``long_context_window``, ``cache_context_len`` equal
  JAX's for every arch and shape (JAX's module is imported only in a
  subprocess: it sets ``XLA_FLAGS`` at import).
* The CLI writes its JSON and ``roofline`` prints the three tables.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import apply_model as jax_apply_model
from repro.models import get_config as jax_get_config
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.models import list_architectures
from repro_torch.configs.base import INPUT_SHAPES, CommConfig, InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.cost_analysis import COLLECTIVE_KINDS, CostCounter, program_wire_bytes
from repro_torch.core.collectives import program_for
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MeshShape, rules_for
from repro_torch.models import apply_model, get_config, get_smoke_config, init_caches, init_model
from repro_torch.tree import leaves, leaves_with_path
from repro_torch.training import compute_loss, param_grads

ARCHS = list_architectures()


def _sig(tree):
    return [(p, tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else (p, t)
            for p, t in leaves_with_path(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trees_match_the_cpu_s(arch):
    cfg = get_smoke_config(arch)
    assert _sig(init_model(cfg, device="meta")) == _sig(init_model(cfg, device="cpu"))
    assert all(t.device.type == "meta" for t in leaves(init_model(cfg, device="meta")))
    for kw in (dict(), dict(window_override=8, dtype=torch.float32)):
        assert _sig(init_caches(cfg, 3, 24, device="meta", **kw)) == \
            _sig(init_caches(cfg, 3, 24, device="cpu", **kw))


def _batch(cfg, B, T, dev, mode):
    rng = np.random.default_rng(0)
    shape = InputShape("t", T, B, mode)
    batch = DR.input_specs(cfg, shape, device=dev)
    for k, t in batch.items():
        if t.dtype == torch.int32:
            t.copy_(torch.as_tensor(rng.integers(0, cfg.vocab_size, t.shape)))
        elif dev != "meta":
            t.copy_(torch.as_tensor(rng.standard_normal(t.shape).astype(np.float32)))
    return batch


def _flops(fn) -> tuple[int, int]:
    with FlopCounterMode(display=False) as fc, CostCounter() as cc:
        fn()
    return fc.get_total_flops(), int(cc.total_flops)


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b", "rwkv6-1.6b",
                                  "paligemma-3b", "deepseek-v3-671b", "hubert-xlarge"])
def test_flop_counter_same_on_meta_and_through_the_ops(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
    B, T = 2, 24
    counts = {}
    for dev, impl in (("meta", "auto"), ("cpu", "op")):
        params = init_model(cfg, device=dev)
        if not cfg.encoder_only:
            caches = init_caches(cfg, B, 32, device=dev)
            batch = _batch(cfg, B, T, dev, "prefill")
            with torch.no_grad(), ops.use(impl):
                pre = _flops(lambda: apply_model(params, cfg, batch, mode="prefill",
                                                 caches=caches))
        else:
            pre = None
        for p in leaves(params):
            p.requires_grad_(True)
        batch = _batch(cfg, B, T, dev, "train")

        def fwd_bwd():
            with ops.use(impl):
                total, _ = compute_loss(params, cfg, batch)
            # remat's recompute runs here, outside the ``use``
            param_grads(total, leaves(params))
        counts[dev] = (pre, _flops(fwd_bwd))
    assert counts["meta"] == counts["cpu"]
    for pair in counts["meta"]:
        assert pair is None or (pair[0] == pair[1] and pair[0] > 0)


# ---------------------------------------------------------------------------
# JAX in a subprocess: argument bytes, wire bytes, the skip and window rules
# ---------------------------------------------------------------------------

PARITY_ARCHS = ("glm4-9b", "dbrx-132b", "paligemma-3b")
PARITY_B, PARITY_T = 8, 32

ARGUMENT_BYTES_JAX = r"""
import os, json
flags = os.environ["XLA_FLAGS"]
import repro.launch.dryrun as D               # sets XLA_FLAGS at import: put ours back
os.environ["XLA_FLAGS"] = flags
import jax
import repro.launch.sharding as SH
from jax.sharding import PartitionSpec as P
from repro.configs.base import InputShape
from repro.launch.mesh import data_axis_names, rules_for
from repro.models import apply_model, get_smoke_config, init_caches
from repro.optim import AdamWConfig
from repro.training import init_train_state, make_train_step
from repro.training.train_step import TrainState

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
baxes = data_axis_names(mesh)
out = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    rules = rules_for(cfg, "auto")
    params_shape, axes = D._eval_init(cfg)
    pspecs = SH.param_pspecs(mesh, rules, axes, params_shape)
    for mode in ("prefill", "train"):
        shape = InputShape(mode, T, B, mode)
        batch = D.input_specs(cfg, shape)
        bspecs = SH.batch_pspecs(mesh, batch, baxes)
        if mode == "train":
            state_shape = jax.eval_shape(lambda: init_train_state(params_shape))
            sspecs = TrainState(params=pspecs,
                                opt_state={"mu": pspecs, "nu": pspecs, "count": P()}, step=P())
            fn = make_train_step(cfg, AdamWConfig(), sync="xla", mesh=mesh, data_axes=baxes)
            fn_in = (SH.named(mesh, sspecs), SH.named(mesh, bspecs))
            fn_out = (SH.named(mesh, sspecs), None)
            args = (state_shape, batch)
        else:
            caches = jax.eval_shape(lambda: init_caches(cfg, B, T))
            cspecs = SH.cache_pspecs(mesh, caches, baxes)
            def serve(params, batch, caches):
                logits, caches, _ = apply_model(params, cfg, batch, mode="prefill",
                                                caches=caches)
                return jax.numpy.argmax(logits[:, -1], -1), caches
            fn = serve
            fn_in = (SH.named(mesh, pspecs), SH.named(mesh, bspecs), SH.named(mesh, cspecs))
            fn_out = (None, SH.named(mesh, cspecs))
            args = (params_shape, batch, caches)
        for key, keep in (("", False), ("/keep_unused", True)):
            jitted = jax.jit(fn, in_shardings=fn_in, out_shardings=fn_out,
                             keep_unused=keep)
            with jax.set_mesh(mesh):
                compiled = jitted.lower(*args).compile()
            out[f"{arch}/{mode}{key}"] = int(compiled.memory_analysis().argument_size_in_bytes)
print("RESULT" + json.dumps(out))
"""


def _result(out: str) -> dict:
    return json.loads(out.split("RESULT", 1)[1].strip().splitlines()[0])


def test_argument_bytes_equal_xla_s_on_a_4x2_mesh(multidevice):
    """Tolerance 0: both count each array's per-device shard (divisible
    extents, no padding on the CPU) over the same specs.  JAX's step is
    jitted as its dry run jits it, and again with ``keep_unused=True``: by
    default jit drops the arguments a step never reads, and JAX's prefill
    writes every cache leaf without reading it, so its dry run's count
    leaves the caches out there; the port's prefill writes them in place
    and counts them (``argument_bytes_by_part`` has them apart)."""
    code = f"ARCHS, B, T = {PARITY_ARCHS!r}, {PARITY_B}, {PARITY_T}\n" + ARGUMENT_BYTES_JAX
    jax_bytes = _result(multidevice(code))
    mesh = MeshShape(("data", "model"), {"data": 4, "model": 2})
    for arch in PARITY_ARCHS:
        cfg = get_smoke_config(arch)
        params = init_model(cfg, device="meta")
        for mode in ("prefill", "train"):
            shape = InputShape(mode, PARITY_T, PARITY_B, mode)
            got = DR.argument_bytes(cfg, shape, mesh, rules_for(cfg), params)
            assert got["total"] == jax_bytes[f"{arch}/{mode}/keep_unused"], (arch, mode, got)
            assert got["total"] - got.get("caches", 0) - got.get("cache_index", 0) == \
                jax_bytes[f"{arch}/{mode}"]


WIRE_JAX = r"""
import json
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.collectives import all_reduce
from repro.launch.hlo_analysis import parse_collectives
mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
out = {}
for name, mode, kw in CASES:
    for n, dtype in SIZES:
        x = jax.ShapeDtypeStruct((8, n), np.dtype(dtype))
        f = jax.shard_map(lambda v: all_reduce(v[0], "data", mode=mode, **kw)[None],
                          mesh=mesh, in_specs=P("data", None), out_specs=P("data", None),
                          check_vma=False)
        hlo = jax.jit(f).lower(x).compile().as_text()
        out[f"{name}/{n}/{dtype}"] = parse_collectives(hlo).wire_bytes
print("RESULT" + json.dumps(out))
"""

WIRE_CASES = [("ring", "ring", {}),
              ("r2ccl", "r2ccl", dict(degraded=2, lost_fraction=0.5)),
              ("r2ccl_g2", "r2ccl", dict(degraded=1, lost_fraction=0.5, g=2))]
WIRE_SIZES = [(1000, "float32"), (4099, "bfloat16"), (65536, "bfloat16")]


def test_wire_bytes_equal_parse_collectives_on_8_devices(multidevice):
    """Tolerance 0: one ppermute operand a step in both counts.  XLA's CPU
    backend widens a bf16 collective-permute to f32 (the compiled HLO's
    operands read f32), so a bf16 payload is held to half its count."""
    code = f"CASES, SIZES = {WIRE_CASES!r}, {WIRE_SIZES!r}\n" + WIRE_JAX
    jax_wire = _result(multidevice(code))
    for name, mode, kw in WIRE_CASES:
        prog = program_for(8, mode=mode, **kw)
        for n, dtype in WIRE_SIZES:
            item = 2 if dtype == "bfloat16" else 4
            got = program_wire_bytes(prog, n * item, dtype)
            assert got == jax_wire[f"{name}/{n}/{dtype}"] * item / 4, (name, n, dtype)


RULES_JAX = r"""
import os, json
flags = os.environ["XLA_FLAGS"]
import repro.launch.dryrun as D
os.environ["XLA_FLAGS"] = flags
from repro.configs.base import INPUT_SHAPES
from repro.launch.hlo_analysis import model_flops
from repro.models import get_config
from repro.models.registry import list_architectures
out = {}
for arch in list_architectures():
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        tokens = shape.global_batch * (1 if shape.mode == "decode" else shape.seq_len)
        out[f"{arch}/{name}"] = [D.skip_reason(cfg, shape), D.long_context_window(cfg, shape),
                                 D.cache_context_len(cfg, shape),
                                 model_flops(cfg, tokens,
                                             "train" if shape.mode == "train" else "infer"),
                                 {k: list(v.shape) for k, v in D.input_specs(cfg, shape).items()}]
print("RESULT" + json.dumps(out))
"""


def test_skip_and_window_rules_and_model_flops_are_jax_s(multidevice):
    jax_rules = _result(multidevice(RULES_JAX, devices=1))
    assert len(jax_rules) == len(ARCHS) * len(INPUT_SHAPES)
    for arch in ARCHS:
        cfg = get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            tokens = shape.global_batch * (1 if shape.mode == "decode" else shape.seq_len)
            got = [DR.skip_reason(cfg, shape), DR.long_context_window(cfg, shape),
                   DR.cache_context_len(cfg, shape),
                   DR.model_flops(cfg, tokens, "train" if shape.mode == "train" else "infer"),
                   {k: list(v.shape) for k, v in DR.input_specs(cfg, shape).items()}]
            assert got == jax_rules[f"{arch}/{name}"], (arch, name)


# ---------------------------------------------------------------------------
# matmul FLOPs outside attention and the scans vs JAX's jaxpr
# ---------------------------------------------------------------------------

LOOPS = ("scan", "while")


def _dot_flops(eqn) -> int:
    (lc, rc), (lb, _) = eqn.params["dimension_numbers"]
    lhs, rhs = (v.aval.shape for v in eqn.invars)
    contract = math.prod(lhs[d] for d in lc)
    batch = math.prod(lhs[d] for d in lb)
    free_l = math.prod(s for d, s in enumerate(lhs) if d not in lc and d not in lb)
    free_r = math.prod(s for d, s in enumerate(rhs)
                       if d not in rc and d not in eqn.params["dimension_numbers"][1][1])
    return 2 * batch * contract * free_l * free_r


def _jaxpr_dot_flops(jaxpr, in_loop: bool = False) -> int:
    """dot_general FLOPs of ``jaxpr`` outside any loop (the loops hold JAX's
    blockwise attention and its recurrences).  A dot_general that contracts
    no dimension is an elementwise product (``jnp.einsum`` emits one for the
    MoE combine's "btke,btkc,btk->btec"), which ``FlopCounterMode`` does not
    count as a matmul in the port's einsum either: left out."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and not in_loop \
                and eqn.params["dimension_numbers"][0][0]:
            total += _dot_flops(eqn)
        loop = in_loop or eqn.primitive.name in LOOPS
        for sub in jax.core.jaxprs_in_params(eqn.params):
            total += _jaxpr_dot_flops(sub, loop)
    return total


KERNEL_OPS = ("flash_attention_fwd", "flash_attention_bwd", "lru_scan", "lru_scan_bwd",
              "wkv_scan", "wkv_scan_bwd")


@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_flops_outside_attention_and_scans_are_jax_s(arch):
    """At full width, depth cut to the lead layers and one pattern group
    (JAX unrolled: ``scan_layers=False``), prefill of 2 x 64 positions.
    The port's count leaves out its kernel ops and its plain decode
    attention (absent in prefill).  RG-LRU's depthwise causal conv is an
    einsum in JAX and ``conv_width`` shifted multiply-adds in the port,
    which ``FlopCounterMode`` does not count: its 2 * B * T * W *
    conv_width FLOPs a layer are added to the port's side."""
    cfg = get_config(arch)
    lead = cfg.moe.first_k_dense if cfg.moe and cfg.moe.first_k_dense else 0
    cut = dict(num_layers=lead + len(cfg.block_pattern), mtp=False)
    cfg = dataclasses.replace(cfg, **cut)
    jcfg = dataclasses.replace(jax_get_config(arch), scan_layers=False, **cut)
    B, T = 2, 64 + (cfg.modality.num_prefix_tokens if cfg.modality.kind == "vision_text" else 0)
    shape = InputShape("p", T, B, "prefill")
    trace = DR.trace_step(cfg, shape, context_len=T)
    port = trace.flops - sum(trace.flops_by_op.get(k, 0) for k in KERNEL_OPS)
    if cfg.rglru is not None:
        port += (2 * B * T * (cfg.rglru.lru_width or cfg.d_model) * cfg.rglru.conv_width
                 * cfg.pattern_layers.count("rglru"))

    batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32 if v.dtype == torch.int32
                                     else jnp.float32)
             for k, v in DR.input_specs(cfg, shape).items()}
    params = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0), jcfg)[0])
    caches = jax.eval_shape(lambda: jax_init_caches(jcfg, B, T))
    jaxpr = jax.make_jaxpr(lambda p, b, c: jax_apply_model(p, jcfg, b, mode="prefill",
                                                           caches=c)[0])(params, batch, caches)
    assert port == _jaxpr_dot_flops(jaxpr.jaxpr) > 0


# ---------------------------------------------------------------------------
# the CLI and the report
# ---------------------------------------------------------------------------

def test_cli_writes_results_and_roofline_prints_the_tables(tmp_path, capsys):
    DR.main(["--arch", "hubert-xlarge", "--both-meshes", "--out", str(tmp_path)])
    DR.main(["--arch", "smollm-360m", "--shape", "train_4k", "--sync", "r2ccl",
             "--comm-mode", "r2ccl", "--degraded-rank", "3", "--lost-fraction", "0.5",
             "--out", str(tmp_path)])
    res = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert len(res) == 9
    skipped = {n for n, r in res.items() if "skipped" in r}
    assert skipped == {f"hubert-xlarge__{s}__{m}__xla.json" for s in ("decode_32k", "long_500k")
                       for m in ("sp", "mp")}
    r = res["smollm-360m__train_4k__sp__r2ccl.json"]
    assert r["scan_corrected"] is False and r["chips"] == 256 and r["mode"] == "train"
    assert r["collectives_counted"] == DR.COLLECTIVES_COUNTED
    assert "gradient-sync" in r["collectives_counted"] and "by kind" in r["collectives_counted"]
    assert set(r["collective_op_counts"]) == set(COLLECTIVE_KINDS)
    assert r["collectives_extrapolated"] is True
    assert r["collectives_torch"] == torch.__version__
    assert r["wire_bytes_per_device"] > 0 and r["memory_analysis"]["temp_size_in_bytes"] > 0
    assert r["flops_per_device"] == pytest.approx(sum(r["flops_per_device_by_class"].values()))
    assert r["roofline"]["bound_s"] > 0 and r["fits_hbm"] in (True, False)
    xla = res["hubert-xlarge__train_4k__sp__xla.json"]
    assert xla["kernel_calls"]["flash_attention_bwd"] == 48
    capsys.readouterr()
    RL.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "fits 80GB" in text and "H100" in text and "Multi-pod" in text
    assert "| hubert-xlarge | decode_32k | — |" in text


def test_r2ccl_wire_bytes_follow_the_program(tmp_path):
    """sync="r2ccl" counts the program of ``CommConfig``'s mode in its wire
    dtype: the ring in bf16 moves half the fp32 ring's bytes, and a pod axis
    adds a ring over the pods."""
    cfg = get_smoke_config("glm4-9b")
    params = init_model(cfg, device="meta")
    mesh = MeshShape(("data", "model"), {"data": 4, "model": 2})
    pods = MeshShape(("pod", "data", "model"), {"pod": 2, "data": 4, "model": 2})
    rules = rules_for(cfg)
    ring = DR.wire_bytes(cfg, params, mesh, rules, "r2ccl", CommConfig(mode="ring"))
    ring32 = DR.wire_bytes(cfg, params, mesh, rules, "r2ccl",
                           CommConfig(mode="ring", comm_dtype="float32"))
    xla = DR.wire_bytes(cfg, params, mesh, rules, "xla", None)
    assert ring32 == pytest.approx(2 * ring, rel=1e-3) and xla == pytest.approx(ring32, rel=1e-3)
    assert DR.wire_bytes(cfg, params, pods, rules, "r2ccl", CommConfig(mode="ring")) > ring
