"""The training CLI's model axis on 8 gloo ranks laid out as 4 data x 2
model (``--world-size 8 --data-par 4``), against the JAX package's CLI
with ``--data-par 4`` on 8 virtual devices, which builds
``make_host_mesh(data=4, model=2)`` and shards the batch over ``data``
alone: both syncs, 4 steps of smollm-360m's smoke config from the same
(JAX-initialised) params, ``--sync r2ccl`` across a NIC failure at step 2
(``--nics-per-node 2``: the degraded R2CCL program).

  * the closing JSON line has the JAX CLI's keys, and every step's loss is
    within 5e-3 of JAX's (the bound of ``test_torch_pods.py``);
  * each leaf's update over the 4 steps is within ``UPDATE_TOL`` of JAX's,
    relative, as ``test_torch_pods.py::test_pod_training_matches_jax``
    holds it;
  * every rank ends with the same params checksum, and the model ranks of
    a data index have identical histories (they take the same rows);
  * each rank's bytes sent in a ring step equal ``dryrun.wire_bytes`` of
    the replicated (4, 2) layout, which syncs each leaf whole over ``data``;
  * the layout is named in rank 0's header line, and ``launch.mesh.
    make_data_axes`` gives each rank the data ranks of its model index.

The JAX CLI runs once (both syncs) in one subprocess of 8 virtual devices,
and the port's CLI once a sync.
"""

import functools
import json
import tempfile

import jax
import numpy as np
import pytest

from _torch_model_parity import converted_params
from _torch_ranks import axes_rank, cli_rank
from conftest import run_multidevice
from repro_torch.configs.base import CommConfig
from repro_torch.launch import ranks
from repro_torch.launch import train as train_cli
from repro_torch.launch.dryrun import wire_bytes
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import get_smoke_config, init_model
from repro_torch.tree import leaves_with_path

WORLD, DATA, MODEL = 8, 4, 2
TOL = 5e-3
#: each leaf's update over the 4 steps, ||(p_port - p0) - (p_jax - p0)|| /
#: ||p_jax - p0||, as ``test_torch_pods.py`` bounds it (its reading there:
#: 0.0096-0.026); read here up to 0.0228 (xla) and 0.0144 (r2ccl), both on
#: the embedding.
UPDATE_TOL = 5e-2
ARGV = ["--smoke", "--data-par", str(DATA), "--steps", "4", "--seq-len", "16",
        "--batch", "8", "--log-every", "1", "--fail-at-step", "2", "--nics-per-node", "2"]

JAX_CLI = """
import contextlib, io, json, sys
import numpy as np
from repro.launch import train

out = {{}}
for sync in ("xla", "r2ccl"):
    ckpt = {ckpt!r} + "/" + sync
    sys.argv = ["train"] + {argv!r} + ["--sync", sync, "--checkpoint-dir", ckpt]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main()
    lines = buf.getvalue().strip().splitlines()
    out[sync] = {{"lines": lines}}
    with np.load(ckpt + "/step_4.npz") as z:
        out[sync]["params"] = {{k: z[k].tolist() for k in z.files if k.startswith("params/")}}
print("JAX_CLI_OK" + json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _jax_cli() -> dict:
    with tempfile.TemporaryDirectory(prefix="torch_model_axis_ref_") as tmp:
        text = run_multidevice(JAX_CLI.format(ckpt=tmp, argv=ARGV), devices=WORLD)
    return json.loads(text.split("JAX_CLI_OK", 1)[1])


@functools.lru_cache(maxsize=None)
def _port_cli(sync: str) -> list[dict]:
    _, jp, _ = converted_params("smollm-360m")
    a = vars(train_cli.parse_args(ARGV + ["--world-size", str(WORLD), "--device", "cpu",
                                          "--sync", sync]))
    return ranks.run(cli_rank, WORLD, "cpu",
                     args=(a, jax.tree_util.tree_map(np.asarray, jp)), timeout=600)


def _losses(lines: list[str]) -> list[float]:
    return [float(ln.split()[3]) for ln in lines if ln.startswith("step ") and " loss " in ln]


@pytest.mark.parametrize("sync", ["xla", "r2ccl"])
def test_model_axis_cli_matches_jax(sync):
    """Losses within 5e-3 of JAX's CLI at every step, each leaf's update
    within UPDATE_TOL of JAX's, the same closing keys, one checksum on all
    8 ranks, and the model ranks' histories identical; r2ccl switches to
    the degraded program at the failure."""
    ref, out = _jax_cli()[sync], _port_cli(sync)
    assert set(json.loads(ref["lines"][-1])) == {"first_loss", "last_loss", "decreased"}
    want = _losses(ref["lines"])
    assert len(want) == 4
    for res in out:
        assert max(abs(a - b) for a, b in zip(res["history"], want)) <= TOL
    assert len({res["checksum"] for res in out}) == 1
    for d in range(DATA):
        histories = [out[d * MODEL + m]["history"] for m in range(MODEL)]
        assert all(h == histories[0] for h in histories)
    scheds = ["healthy"] * 2 + (["degraded"] * 2 if sync == "r2ccl" else ["healthy"] * 2)
    assert all(res["scheds"] == scheds for res in out)
    _, _, tp = converted_params("smollm-360m")
    start = {"/".join(p): t.numpy() for p, t in leaves_with_path(tp)}
    ours = out[0]["params"]
    assert sorted(ours) == sorted(start) == sorted(k[len("params/"):] for k in ref["params"])
    for key, theirs in ref["params"].items():
        key = key[len("params/"):]
        a, b, p0 = ours[key], np.asarray(theirs, np.float32), start[key]
        assert float(np.abs(a - b).max()) <= TOL, key
        want_update = (b - p0).ravel()
        rel = np.linalg.norm((a - p0).ravel() - want_update) / np.linalg.norm(want_update)
        assert rel <= UPDATE_TOL, key


def test_model_axis_sent_bytes_equal_the_dry_runs_wire_bytes():
    """A ring step's bytes on every rank equal ``dryrun.wire_bytes`` of the
    (4, 2) ``("data", "model")`` mesh with the params replicated (no rule
    maps a logical axis), the CLI's layout; a degraded step's are at most
    it (that count takes every rank as a source of every step)."""
    cfg = get_smoke_config("smollm-360m")
    meta = init_model(cfg, device="meta")
    mesh = MeshShape(("data", "model"), {"data": DATA, "model": MODEL})
    ring = wire_bytes(cfg, meta, mesh, {}, "r2ccl", CommConfig(mode="ring"))
    degraded = wire_bytes(cfg, meta, mesh, {}, "r2ccl", CommConfig(
        mode="r2ccl", degraded_rank=0, lost_fraction=0.5, devices_per_node=2))
    assert ring > 0
    for res in _port_cli("r2ccl"):
        sent = [s["sent_bytes"] for s in res["stats"]]
        assert sent[:2] == [ring, ring]
        assert all(0 < s <= degraded for s in sent[2:])


def test_data_axes_follow_the_mesh_order():
    """Global rank r is data index r // 2, model index r % 2: its data axis
    lists the global ranks of its model index in data order (and a layout
    that does not take the world, or pods with a model axis, is refused)."""
    for r, (axes, refused) in enumerate(ranks.run(axes_rank, WORLD, "cpu",
                                                  args=(DATA, MODEL), timeout=300)):
        assert axes == [(r // MODEL, DATA, [d * MODEL + r % MODEL for d in range(DATA)])]
        assert refused == ["a (1, 3, 2) mesh does not take 8 ranks",
                           "2 pods with a model axis of 2 is not a layout of the "
                           "training CLI"]


def test_model_axis_cli_prints_the_layout(capfd):
    """Rank 0 names the 4 x 2 layout; the closing line is the JAX CLI's."""
    res = train_cli.main(["--smoke", "--device", "cpu", "--world-size", str(WORLD),
                          "--data-par", str(DATA), "--steps", "2", "--seq-len", "16",
                          "--batch", "8", "--sync", "xla"])
    out = capfd.readouterr().out
    assert f"ranks={WORLD} mesh={DATA}x{MODEL} " in out
    assert set(json.loads(out.strip().splitlines()[-1])) == {"first_loss", "last_loss",
                                                             "decreased"}
    assert len(res["ranks"]) == WORLD and np.isfinite(res["history"]).all()
