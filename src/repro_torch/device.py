"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card that default raises: the port never moves to the CPU unless the caller
asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import time

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            "device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(stats: dict | None, key: str, device: torch.device):
    """Add the host seconds of the block to ``stats[key]``, after
    synchronizing ``device`` so that the block's kernels are counted
    (nothing is timed or synchronized when ``stats`` is None)."""
    if stats is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    synchronize(device)
    stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0
