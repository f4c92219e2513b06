"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card that default raises: the port never moves to the CPU unless the caller
asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch

from repro_torch import tracing


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


def timed(stats: dict | None, key: str, device: torch.device, span: str | None = None):
    """A context that adds the host seconds of its block to ``stats[key]``,
    after synchronizing ``device`` so that the block's kernels are counted
    (nothing is timed or synchronized when ``stats`` is None).  While
    tracing is on the block is also the span ``span`` (``tracing``), which
    ends after that synchronize; with ``stats`` None it ends without one,
    so it times what the host did."""
    if stats is None:
        return tracing.span(span)
    return _Timed(stats, key, device, span)


class _Timed:
    __slots__ = ("stats", "key", "device", "span", "t0")

    def __init__(self, stats: dict, key: str, device: torch.device, span: str | None):
        self.stats, self.key, self.device = stats, key, device
        self.span = tracing.span(span)

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            synchronize(self.device)
            self.stats[self.key] = self.stats.get(self.key, 0.0) + time.perf_counter() - self.t0
        self.span.__exit__(exc_type, exc, tb)
        return False
