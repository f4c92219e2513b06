"""Training launcher: data-parallel training on local ranks.

The port of the JAX package's ``launch/train.py``, with its flags plus
``--world-size`` (ranks, started by ``launch.ranks``), ``--pods``,
``--layers`` (a cut of depth), ``--device`` and ``--trace-out`` (rank 0's
spans of the training loop as Chrome trace JSON, ``tracing``).  On a machine with one card
every rank runs on ``cuda:0`` and the gradient wire is host-staged gloo
(``core.collectives``).  ``--data-par D`` below ``--world-size N`` lays the
ranks out as the JAX package's ``make_host_mesh(data=D, model=N // D)``:
global rank ``r`` is data index ``r // M`` and model index ``r % M``
(``launch.mesh.make_data_axes``); the global batch splits over the ``D``
data indices, the model ranks of one data index take the same rows and
compute the same values (the JAX package's step is manual over the data
axes with the params replicated), and each rank's data axis spans the
``D`` ranks of its model index.  With ``--pods P`` the ranks form a
``("pod", "data")`` mesh of P pods: the schedule runs inside each pod, a
ring across the pods, as the JAX package's step does over
``data_axes=("pod", "data")``; ``--fail-node`` is a rank of the innermost
data axis, and every pod (and every model index) runs the degraded program.

  python -m repro_torch.launch.train --arch smollm-360m --world-size 4 \\
      --seq-len 512 --batch 8 --steps 4 --sync r2ccl --comm-mode ring \\
      --fail-at-step 2 --fail-node 1
  python -m repro_torch.launch.train --smoke --device cpu --steps 6 \\
      --seq-len 32 --batch 8 --sync r2ccl --fail-at-step 3
  python -m repro_torch.launch.train --smoke --device cpu --world-size 8 \\
      --pods 2 --steps 4 --seq-len 16 --batch 16 --sync r2ccl \\
      --fail-at-step 2 --fail-node 1 --nics-per-node 2
  python -m repro_torch.launch.train --smoke --device cpu --world-size 8 \\
      --data-par 4 --steps 4 --seq-len 16 --batch 8 --sync r2ccl \\
      --fail-at-step 2 --nics-per-node 2
  python -m repro_torch.launch.train --arch smollm-360m --layers 16 \\
      --world-size 8 --pods 2 --seq-len 512 --batch 16 --steps 4 \\
      --sync r2ccl --fail-at-step 2 --fail-node 1 --nics-per-node 2

Rank 0 prints the progress lines; the launcher prints the JAX package's
closing JSON line (first and last loss, whether it decreased).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import tracing
from repro_torch.configs.base import CommConfig
from repro_torch.core.detection import FailureDetector
from repro_torch.core.failures import Failure, FailureState, FailureType
from repro_torch.core.topology import make_cluster
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_data_axes
from repro_torch.models import get_config, get_smoke_config, init_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step, save_checkpoint
from repro_torch.tree import leaves


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=0,
                    help="layers of the model (0 = the config's): a cut of "
                         "depth at full width, for ranks that share a card")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sync", default="xla", choices=["xla", "r2ccl"])
    ap.add_argument("--comm-mode", default="ring",
                    choices=["xla", "ring", "r2ccl", "recursive"])
    ap.add_argument("--world-size", type=int, default=4,
                    help="ranks, started as local processes")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods of --world-size / --pods ranks each: the "
                         "schedule runs inside a pod, a ring across pods")
    ap.add_argument("--data-par", type=int, default=0,
                    help="data-parallel degree (0 = --world-size); the other "
                         "--world-size / --data-par ranks form the model axis")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--fail-node", type=int, default=0)
    ap.add_argument("--fail-rail", type=int, default=0)
    ap.add_argument("--nics-per-node", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--trace-out", default=None,
                    help="write rank 0's spans of the training loop to this "
                         "file as Chrome trace JSON")
    args = ap.parse_args(argv)
    args.data_par = args.data_par or args.world_size
    if args.data_par < 1 or args.world_size % args.data_par:
        ap.error(f"--data-par {args.data_par} must divide --world-size {args.world_size}")
    if args.layers < 0:
        ap.error(f"--layers {args.layers} must be at least 0")
    if args.pods < 1 or args.world_size % args.pods:
        ap.error(f"--pods {args.pods} must divide --world-size {args.world_size}")
    if args.pods > 1 and args.data_par != args.world_size:
        ap.error(f"--pods {args.pods} with --data-par {args.data_par} below --world-size "
                 f"{args.world_size}: pods with a model axis is not a layout of this CLI")
    if args.batch % args.data_par:
        ap.error(f"--batch {args.batch} must divide over {args.data_par} ranks")
    return args


def params_checksum(params) -> float:
    return float(sum(p.detach().double().sum() for p in leaves(params)))


def run_rank(rank: int, world: int, device: str, a: dict) -> dict:
    """One rank's training loop (``launch.ranks.run`` calls it)."""
    log = print if rank == 0 else (lambda *_, **__: None)
    cfg = get_smoke_config(a["arch"]) if a["smoke"] else get_config(a["arch"])
    if a["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=a["layers"])
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    dp, model = a["data_par"], world // a["data_par"]
    axes = make_data_axes(dp // a["pods"], model, a["pods"])
    layout = (f"pods={axes[0].size}x{axes[1].size}" if len(axes) > 1
              else f"mesh={dp}x{model}")
    log(f"arch={cfg.name} layers={cfg.num_layers} ranks={world} {layout} device={dev} "
        f"sync={a['sync']}", flush=True)

    params = init_model(cfg, seed=0, device=dev)
    # every rank must start from the same weights (same seed, same device)
    sums = torch.tensor([params_checksum(params)], dtype=torch.float64)
    lo, hi = sums.clone(), sums.clone()
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
    if lo.item() != hi.item():
        raise RuntimeError(f"ranks start from different params: checksums "
                           f"{lo.item()} .. {hi.item()}")
    state = init_train_state(params)
    log(f"params: {sum(p.numel() for p in leaves(params)):,}", flush=True)

    # Two pre-built steps: healthy and degraded — the analogue of the
    # paper's pre-established backup connections (nothing is planned on the
    # failure path; the degraded program is built here and cached).
    opt = AdamWConfig(lr=a["lr"])
    comm_healthy = CommConfig(mode=a["comm_mode"] if a["sync"] == "r2ccl" else "xla")
    steps = {"healthy": make_train_step(cfg, opt, sync=a["sync"],
                                        comm=comm_healthy, axes=axes)}
    if a["fail_at_step"] is not None and a["sync"] == "r2ccl":
        x = 1.0 / a["nics_per_node"]
        comm_deg = CommConfig(mode="r2ccl", degraded_rank=a["fail_node"],
                              lost_fraction=max(x, 0.34),
                              devices_per_node=a["nics_per_node"])
        steps["degraded"] = make_train_step(cfg, opt, sync="r2ccl",
                                            comm=comm_deg, axes=axes)

    detector = FailureDetector(FailureState())
    # the nodes of one pod, as the JAX package's cluster of mesh.shape["data"]
    cluster = make_cluster(max(axes[-1].size, 2), a["nics_per_node"])
    # this rank's rows: those of its data index, shared by its model ranks
    lb, row = a["batch"] // dp, rank // model
    active = "healthy"
    history, scheds, step_stats = [], [], []
    located = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    trace_out = a["trace_out"] if rank == 0 else None
    if trace_out:
        tracing.enable()
    t_start = time.time()
    for step in range(a["steps"]):
        if a["fail_at_step"] is not None and step == a["fail_at_step"]:
            node, rail = a["fail_node"], a["fail_rail"]
            failure = Failure(FailureType.NIC_HARDWARE, node, rail,
                              at_time=time.time() - t_start)
            with tracing.span("recovery.detect"):
                tracing.count("recovery.detect")
                diag = detector.detect(failure, (node, rail),
                                       ((node + 1) % cluster.num_nodes, rail),
                                       aux=((node + 2) % cluster.num_nodes, 0))
            located = diag.location.value
            if "degraded" in steps:
                log(f"step {step}: NIC failure injected -> located {located} "
                    f"in {diag.localize_latency*1e3:.2f}ms; switching to "
                    f"degraded schedule", flush=True)
                active = "degraded"
            else:
                log(f"step {step}: failure injected (xla sync cannot adapt)",
                    flush=True)
        b = make_batch(cfg, seq_len=a["seq_len"], batch_size=a["batch"], step=step)
        batch = {k: torch.from_numpy(v[row * lb:(row + 1) * lb]).to(dev)
                 for k, v in b.items()}
        stats: dict[str, float] = {}
        t0 = time.perf_counter()
        state, metrics = steps[active](state, batch, stats=stats)
        loss = float(metrics["loss"])
        stats["step_s"] = time.perf_counter() - t0
        history.append(loss)
        scheds.append(active)
        step_stats.append(stats)
        if step % a["log_every"] == 0 or step == a["steps"] - 1:
            log(f"step {step:4d} loss {loss:.4f} gnorm "
                f"{float(metrics['grad_norm']):.3f} sched={active} "
                f"step {stats['step_s']:.3f} s", flush=True)

    if trace_out:
        tracing.disable()
        rec = tracing.drain()
        tracing.write_chrome_trace(trace_out, rec)
        log(f"trace: {len(rec['spans'])} spans written to {trace_out}", flush=True)
    if a["checkpoint_dir"] and rank == 0:
        save_checkpoint(a["checkpoint_dir"], state, a["steps"])
        log(f"checkpoint saved to {a['checkpoint_dir']}", flush=True)
    return {"history": history, "scheds": scheds, "stats": step_stats,
            "located": located, "launches": ops.launch_counts(),
            "checksum": params_checksum(state.params),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, train on ``--world-size`` ranks, print the closing
    JSON line, and return rank 0's result with the other ranks' under
    ``"ranks"``."""
    args = parse_args(argv)
    results = ranks.run(run_rank, args.world_size, args.device, args=(vars(args),))
    history = results[0]["history"]
    print(json.dumps({"first_loss": history[0], "last_loss": history[-1],
                      "decreased": history[-1] < history[0]}), flush=True)
    return dict(results[0], ranks=results)


if __name__ == "__main__":
    main()
