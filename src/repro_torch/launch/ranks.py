"""Start the ranks of a data-parallel run as local processes.

The port's counterpart of the JAX package's host mesh (``launch/mesh.py``)
and of its tests' multi-device subprocess: ``run(fn, world_size, device)``
starts ``world_size`` processes under the ``spawn`` start method (CUDA cannot
start in a forked child), joins them into one gloo process group, calls
``fn(rank, world_size, device, *args)`` in each, and returns the results in
rank order.

  * The group meets through a file in a fresh temporary directory
    (``init_method="file://..."``), so concurrent runs never contend for a
    port.
  * ``device="cuda"``: every rank runs on ``cuda:0`` (a machine with one card
    hosts all ranks; the wire is host-staged gloo, ``core.collectives``).  The
    kernels are built once here, before the ranks start; the ranks then load
    the built libraries.  ``device="cpu"``: each rank uses one thread.
  * A rank's exception, or a rank that dies, fails the caller with the rank's
    traceback; the other ranks are then stopped.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

#: sources under ``kernels/csrc`` that a training rank launches
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "chunk_combine",
                 "lru_scan", "lru_scan_bwd", "wkv_scan", "wkv_scan_bwd")


class RankError(RuntimeError):
    """A rank raised or died; the message carries its traceback."""


def _worker(fn: Callable, rank: int, world_size: int, init_method: str,
            device: str, args: tuple, results) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
        try:
            out = fn(rank, world_size, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                      # reported to the caller, re-raised there
        results.put((rank, False, traceback.format_exc()))


def run(fn: Callable, world_size: int, device: str = "cuda", args: tuple = (),
        timeout: float = 1800.0) -> list[Any]:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks.

    ``fn`` and ``args`` must be picklable (a module-level function, plain
    data); so must each rank's return value.  Raises :class:`RankError` if a
    rank raises or exits without a result, and ``TimeoutError`` after
    ``timeout`` seconds.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels.build import load_libraries
        load_libraries(list(TRAIN_KERNELS))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(fn, r, world_size, init_method, dev.type,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RankError(f"rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks did not finish in {timeout} s")
                    continue
                if not ok:
                    raise RankError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
    return [out[r] for r in range(world_size)]
