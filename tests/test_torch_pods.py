"""The port's hierarchical gradient sync on 8 gloo ranks laid out as 2 pods
x 4 (``launch.mesh.make_data_axes(4, 1, 2)``), against the JAX package's
``shard_map`` over a ``Mesh(devices.reshape(2, 4), ("pod", "data"))``: the
configured schedule over ``data``, then a ring over ``pod``, as
``src/repro/training/train_step.py`` chains them.

The port's ranks start once per group of cases (the collectives; the
training; the CLI), and the JAX reference runs once, in one subprocess of 8
virtual devices.

  * the all-reduce modes of ``tests/test_torch_collectives.py::MODES`` with
    the inner axis of 4, on integer-valued fp32 data: equal to JAX's and to
    ``x.sum(0)`` exactly (every partial sum is exact in float32);
  * a bf16 tree's mean through the degraded R2CCL program and the pod ring:
    equal to JAX's bit for bit (each partial sum is rounded once to bf16 on
    both sides, and the divisions by 4 and 2 are exact);
  * smollm-360m's smoke config trained 4 steps, a ring for 2 then the
    degraded program: losses and params within 5e-3 of JAX's
    ``make_train_step(sync="r2ccl", data_axes=("pod", "data"))`` (the bound
    of ``tests/test_multidevice.py::test_r2ccl_training_parity``), and each
    leaf's update within 5e-2 of JAX's, relative;
  * the bytes each rank sends in a step: the IR's count, and for the ring
    ``launch.dryrun.wire_bytes`` of the (2, 4, 1) mesh exactly;
  * the training CLI with ``--pods 2`` (and ``--layers``), and its
    refusals.
"""

import functools
import json
import os
import tempfile

import jax
import numpy as np
import pytest

from _torch_model_parity import converted_params
from _torch_ranks import pods_rank, train_rank
from conftest import run_multidevice
from repro_torch.configs.base import CommConfig
from repro_torch.core.collectives import program_for
from repro_torch.launch import ranks
from repro_torch.launch import train as train_cli
from repro_torch.launch.dryrun import wire_bytes
from repro_torch.launch.mesh import MeshShape, rules_for
from repro_torch.models import get_smoke_config, init_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import make_train_step
from repro_torch.tree import leaves
from test_torch_collectives import MODES

PODS, PER_POD = 2, 4
WORLD = PODS * PER_POD
L = 37                                   # not a multiple of any chunk count
TREE_SEED = 100
TOL = 5e-3
#: each leaf's update over the 4 steps, ||(p_port - p0) - (p_jax - p0)|| /
#: ||p_jax - p0||; read 0.0096-0.026 (global 0.017): the ranks' gradients
#: differ from JAX's by fp32 roundings, a few of which cross a bf16 step of
#: the wire, and AdamW's normalized update carries a gradient's sign whatever
#: its size.  An update of no step reads 1, one step of the three short ~0.3.
UPDATE_TOL = 5e-2
RING = dict(mode="ring")
DEGRADED = dict(mode="r2ccl", degraded_rank=1, lost_fraction=0.5, devices_per_node=2)
TRAIN = dict(steps=4, seq_len=16, batch=16, lr=1e-3, warmup=1, total=100, fail_at=2)


def _mode_data(i: int) -> np.ndarray:
    return np.random.default_rng(i).integers(-50, 50, size=(WORLD, L)).astype(np.float32)


def _tree_data() -> dict:
    out = {"w": [], "b": []}
    for r in range(WORLD):
        rng = np.random.default_rng(TREE_SEED + r)
        out["w"].append(rng.normal(size=(5, 7)).astype(np.float32))
        out["b"].append(rng.normal(size=3).astype(np.float32))
    return {k: np.stack(v) for k, v in out.items()}


JAX_REF = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.collectives import sync_gradients
from repro.core.planner import CommConfig
from repro.data import make_batch
from repro.models import get_smoke_config, init_model
from repro.optim import AdamWConfig
from repro.training import init_train_state, make_train_step

inp = np.load({inp!r})
modes, train = {modes!r}, {train!r}
mesh = Mesh(np.array(jax.devices()).reshape({pods}, {per_pod}), ("pod", "data"))
rows = P(("pod", "data"))
out = {{}}

def hierarchical(x, mode, mean, **kw):
    y = sync_gradients(x, "data", mode=mode, mean=mean, **kw)
    return sync_gradients(y, "pod", mode="xla" if mode == "xla" else "ring",
                          mean=mean, g=kw.get("g", 8))

for i, (mode, kw) in enumerate(modes):
    f = jax.shard_map(lambda v: hierarchical(v[0], mode, False, **kw)[None],
                      mesh=mesh, in_specs=rows, out_specs=rows, check_vma=False)
    out[f"mode{{i}}"] = np.asarray(jax.jit(f)(inp[f"mode{{i}}"]))

tree = {{k: jnp.asarray(inp["tree_" + k]).astype(jnp.bfloat16) for k in ("w", "b")}}
f = jax.shard_map(
    lambda t: jax.tree_util.tree_map(lambda v: v[None], hierarchical(
        jax.tree_util.tree_map(lambda v: v[0], t), "r2ccl", True,
        degraded=1, lost_fraction=0.5, g=2)),
    mesh=mesh, in_specs=({{"w": rows, "b": rows}},),
    out_specs={{"w": rows, "b": rows}}, check_vma=False)
for k, v in jax.jit(f)(tree).items():
    out["tree_" + k] = np.asarray(v).view(np.int16)

cfg = get_smoke_config("smollm-360m")
state = init_train_state(jax.jit(lambda k: init_model(k, cfg)[0])(jax.random.PRNGKey(0)))
steps = [jax.jit(make_train_step(cfg, AdamWConfig(lr=train["lr"]), sync="r2ccl",
                                 comm=CommConfig(**c), mesh=mesh, data_axes=("pod", "data"),
                                 warmup_steps=train["warmup"], total_steps=train["total"]))
         for c in (train["ring"], train["degraded"])]
losses = []
for i in range(train["steps"]):
    b = make_batch(cfg, seq_len=train["seq_len"], batch_size=train["batch"], step=i)
    batch = {{k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, rows))
             for k, v in b.items()}}
    state, m = steps[i >= train["fail_at"]](state, batch)
    losses.append(float(m["loss"]))
out["losses"] = np.asarray(losses)
for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
    out[f"param{{i}}"] = np.asarray(leaf, np.float32)
np.savez({out!r}, **out)
print("POD_REF_OK")
"""


@functools.lru_cache(maxsize=None)
def _jax_reference() -> dict:
    with tempfile.TemporaryDirectory(prefix="torch_pods_ref_") as tmp:
        inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        tree = _tree_data()
        np.savez(inp, **{f"mode{i}": _mode_data(i) for i in range(len(MODES))},
                 **{"tree_" + k: v for k, v in tree.items()})
        code = JAX_REF.format(inp=inp, out=out, pods=PODS, per_pod=PER_POD,
                              modes=[(m, dict(kw)) for m, kw in MODES],
                              train=dict(TRAIN, ring=RING, degraded=DEGRADED))
        assert "POD_REF_OK" in run_multidevice(code, devices=WORLD)
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def _collectives():
    modes = [(m, dict(kw), _mode_data(i)) for i, (m, kw) in enumerate(MODES)]
    return ranks.run(pods_rank, WORLD, "cpu", args=(PODS, modes, TREE_SEED), timeout=600)


@functools.lru_cache(maxsize=None)
def _training():
    _, jp, _ = converted_params("smollm-360m")
    spec = dict(arch="smollm-360m", params=jax.tree_util.tree_map(np.asarray, jp),
                pods=PODS, cycle=TRAIN["steps"],
                phases=[(0, "r2ccl", RING), (TRAIN["fail_at"], "r2ccl", DEGRADED)],
                **{k: v for k, v in TRAIN.items() if k != "fail_at"})
    return ranks.run(train_rank, WORLD, "cpu", args=(spec,), timeout=600)


def _merges(prog, total: int) -> int:
    """chunk_combine launches of one rank running ``prog`` on ``total``
    elements: one per step of every non-empty segment."""
    if prog is None:
        return 0
    count, start = 0, 0
    for i, seg in enumerate(prog.segments):
        end = total if i == len(prog.segments) - 1 else start + int(round(seg.frac * total))
        if max(end, start) > start:
            count += len(seg.schedule.steps)
        start = end
    return count


def _sent(prog, total: int, rank: int, item: int) -> int:
    """Bytes ``rank`` sends running ``prog`` on ``total`` elements: a chunk
    (or the whole padded buffer) in every step where it is a source."""
    sent, start = 0, 0
    for i, seg in enumerate(prog.segments):
        end = total if i == len(prog.segments) - 1 else start + int(round(seg.frac * total))
        n, start = max(end - start, 0), end
        if n:
            C = seg.schedule.num_chunks
            M = -(-n // C)
            sent += sum(C * M if st.whole_buffer else M for st in seg.schedule.steps
                        if any(s == rank for s, _ in st.perm))
    return sent * item


def test_pod_axes_follow_the_mesh_order():
    """Global rank r is pod r // 4, data index r % 4; each axis lists its
    ranks' global ranks in group order; 3 pods of 8 ranks are refused."""
    for r, res in enumerate(_collectives()):
        (pod_rank, pod_size, pod_ranks), (data_rank, data_size, data_ranks) = res["axes"]
        assert (pod_rank, pod_size, data_rank, data_size) == (
            r // PER_POD, PODS, r % PER_POD, PER_POD)
        assert pod_ranks == [p * PER_POD + r % PER_POD for p in range(PODS)]
        assert data_ranks == [r // PER_POD * PER_POD + d for d in range(PER_POD)]
        assert "a (3, 2, 1) mesh does not take 8 ranks" in res["refused"]


@pytest.mark.parametrize("idx", range(len(MODES)), ids=[
    f"{m}-{i}" for i, (m, _) in enumerate(MODES)])
def test_hierarchical_all_reduce_matches_jax(idx):
    """The data axis's schedule, then the pod ring: equal to JAX's
    ``shard_map`` of the same chain and to the sum, exactly; one merge per
    step of both programs on every rank."""
    mode, kw = MODES[idx]
    want = _jax_reference()[f"mode{idx}"]
    x = _mode_data(idx)
    inner = program_for(PER_POD, mode=mode, **kw)
    outer = program_for(PODS, mode="xla" if mode == "xla" else "ring")
    for r, res in enumerate(_collectives()):
        got, merges = res["modes"][idx]
        np.testing.assert_array_equal(got, want[r])
        np.testing.assert_array_equal(got, x.sum(0))
        assert merges == _merges(inner, L) + _merges(outer, L)


def test_bf16_wire_mean_matches_jax_bits():
    """A bf16 tree's mean, degraded R2CCL inside the pods then the pod ring:
    the same bits as JAX's on every rank."""
    ref = _jax_reference()
    for r, res in enumerate(_collectives()):
        for k, (is_bf16, bits) in res["tree"].items():
            assert is_bf16
            np.testing.assert_array_equal(bits, ref["tree_" + k][r])


def test_pod_training_matches_jax():
    """2 pods x 4 ranks, sync r2ccl: a ring for 2 steps, then the degraded
    R2CCL program inside every pod; losses on every rank and rank 0's
    params within 5e-3 of JAX's step over data_axes=("pod", "data"), each
    leaf's update within UPDATE_TOL of JAX's (the updates, ~3e-3 at most,
    are under the absolute bound themselves), and every rank's params the
    same (the pods train on different rows, so an unsynced pod axis would
    part them)."""
    ref, out = _jax_reference(), _training()
    assert len({o["checksum"] for o in out}) == 1
    for r in range(WORLD):
        assert max(abs(a - b) for a, b in zip(out[r]["losses"], ref["losses"])) <= TOL
    _, jp, _ = converted_params("smollm-360m")
    start = [np.asarray(p, np.float32) for p in jax.tree_util.tree_leaves(jp)]
    ours = list(out[0]["params"].values())      # leaves in JAX order
    theirs = [ref[f"param{i}"] for i in range(len(ours))]
    assert f"param{len(ours)}" not in ref and len(start) == len(ours)
    assert max(float(np.abs(a - b).max()) for a, b in zip(ours, theirs)) <= TOL
    for p0, a, b in zip(start, ours, theirs):
        want = (b - p0).ravel()
        assert np.linalg.norm((a - p0).ravel() - want) <= UPDATE_TOL * np.linalg.norm(want)


def test_sent_bytes_equal_the_dry_runs_wire_bytes():
    """Each rank's bytes on the wire in a step: the IR's count of its sends
    (inner program, then the pod ring, leaf by leaf); a ring step's equals
    ``dryrun.wire_bytes`` of the (2, 4, 1) mesh, and a degraded step's is at
    most that function's count, which takes every rank as a source of every
    step."""
    cfg = get_smoke_config("smollm-360m")
    meta = init_model(cfg, seed=0, device="meta")
    mesh = MeshShape(("pod", "data", "model"), {"pod": PODS, "data": PER_POD, "model": 1})
    sizes = [p.numel() for p in leaves(meta)]
    ring = program_for(PODS, mode="ring")
    out = _training()
    for name, comm, steps in (("ring", RING, range(TRAIN["fail_at"])),
                              ("degraded", DEGRADED, range(TRAIN["fail_at"], TRAIN["steps"]))):
        c = CommConfig(**comm)
        dry = wire_bytes(cfg, meta, mesh, rules_for(cfg), "r2ccl", c)
        inner = program_for(PER_POD, **c.kwargs())
        for r in range(WORLD):
            want = sum(_sent(inner, n, r % PER_POD, 2) + _sent(ring, n, r // PER_POD, 2)
                       for n in sizes)
            for i in steps:
                got = out[r]["sent_bytes"][i]
                assert got == want, (name, r, i)
                assert got == dry if name == "ring" else got <= dry


@pytest.mark.parametrize("sync, layers, scheds", [
    ("r2ccl", 1, ["healthy"] * 2 + ["degraded"] * 2),   # depth cut from 2
    ("xla", 0, ["healthy"] * 4),           # one all-reduce over every rank
])
def test_train_cli_with_pods_on_cpu(sync, layers, scheds, capfd):
    """``--pods 2`` on 8 CPU ranks: rank 0 prints the layout and the depth
    (``--layers``, 0 the config's), r2ccl sync switches to the degraded
    program at step 2 (xla sync cannot adapt), the ranks agree on every
    loss, the loss falls, and the closing line is the JAX package's."""
    res = train_cli.main(["--smoke", "--device", "cpu", "--world-size", str(WORLD),
                          "--pods", str(PODS), "--layers", str(layers), "--steps", "4",
                          "--seq-len", "16", "--batch", "16", "--sync", sync,
                          "--fail-at-step", "2", "--fail-node", "1", "--nics-per-node", "2",
                          "--log-every", "1"])
    out = capfd.readouterr().out
    closing = json.loads(out.strip().splitlines()[-1])
    assert set(closing) == {"first_loss", "last_loss", "decreased"}
    assert closing["decreased"] is True
    assert "pods=2x4" in out
    assert f"layers={layers or get_smoke_config('smollm-360m').num_layers} " in out
    assert res["scheds"] == scheds
    assert res["located"] is not None and np.isfinite(res["history"]).all()
    assert len(res["ranks"]) == WORLD
    assert all(r["history"] == res["history"] for r in res["ranks"])


@pytest.mark.parametrize("argv, why", [
    (["--world-size", "8", "--pods", "3"], "--pods 3 must divide --world-size 8"),
    (["--world-size", "8", "--pods", "0"], "--pods 0 must divide --world-size 8"),
    (["--world-size", "8", "--pods", "2", "--batch", "12"],
     "--batch 12 must divide over 8 ranks"),
    (["--layers", "-1"], "--layers -1 must be at least 0"),
    (["--world-size", "8", "--pods", "2", "--data-par", "4"],
     "pods with a model axis is not a layout of this CLI"),
    (["--world-size", "8", "--data-par", "3"], "--data-par 3 must divide --world-size 8"),
    (["--world-size", "8", "--data-par", "4", "--batch", "6"],
     "--batch 6 must divide over 4 ranks"),
])
def test_train_cli_refuses_a_layout_it_cannot_run(argv, why, capsys):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--smoke", "--device", "cpu"] + argv)
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("kw, why", [
    (dict(axes=()), "needs the data axis"),
])
def test_make_train_step_refuses_an_ambiguous_axis(kw, why):
    """r2ccl sync needs at least one data axis."""
    with pytest.raises(ValueError, match=why):
        make_train_step(get_smoke_config("smollm-360m"), AdamWConfig(), sync="r2ccl", **kw)
