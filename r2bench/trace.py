"""The traced run: ``torch.profiler`` over the window, summarised in memory.

Kineto's timestamps are nanoseconds on the host's wall clock (the device's
are converted to it), so intervals of several processes, and the window's
bounds taken with ``time.time_ns()``, share one time line.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from r2bench import harness


def profiler(cpu: bool) -> profile:
    """Device activity always; host operators, with their shapes and
    arguments, when ``cpu``."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    return profile(activities=acts, record_shapes=cpu)


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def device_events(prof: profile, lo_ns: int, hi_ns: int) -> list[tuple[int, int, str]]:
    """Every operation on the device (kernels, copies, fills) inside
    [lo_ns, hi_ns], as (start, end, name), in order of start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if b > lo_ns and a < hi_ns:
                out.append((max(a, lo_ns), min(b, hi_ns), e.name()))
    out.sort()
    return out


def host_ops(prof: profile, name: str) -> list:
    """The host events of operator ``name`` in order of start."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if not _is_device(e) and e.name() == name]
    return sorted(evs, key=lambda e: e.start_ns())


def host_spans(prof: profile) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Every host operator as arrays of starts and ends and a list of names
    (to name what the host did while the device idled)."""
    evs = [e for e in prof.profiler.kineto_results.events() if not _is_device(e)]
    starts = np.array([e.start_ns() for e in evs], dtype=np.int64)
    ends = starts + np.array([e.duration_ns() for e in evs], dtype=np.int64)
    return starts, ends, [e.name() for e in evs]


def by_name(events) -> dict[str, float]:
    """Device seconds by operation name."""
    total: dict[str, float] = collections.defaultdict(float)
    for a, b, n in events:
        total[n] += (b - a) * 1e-9
    return dict(total)


def name_gap(gap, starts: np.ndarray, ends: np.ndarray, names: list[str]) -> str:
    """The shortest host operator spanning the whole gap, else the shortest
    one running at its middle, else ``host``."""
    a, b = gap
    for cond in ((starts <= a) & (ends >= b), (starts <= (a + b) // 2) & (ends >= (a + b) // 2)):
        idx = np.flatnonzero(cond)
        if idx.size:
            return names[idx[np.argmin(ends[idx] - starts[idx])]]
    return "host"


def breakdown(ops: dict[str, float], gaps, label) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each named by ``label(gap)``."""
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[label(g), (g[1] - g[0]) * 1e-9] for g in longest]}


def busy(intervals, lo_ns: int, hi_ns: int) -> tuple[float, list]:
    """(seconds the device was busy, idle gaps) inside [lo_ns, hi_ns]."""
    clipped = harness.clip_intervals(intervals, lo_ns, hi_ns)
    return harness.union_length(clipped) * 1e-9, harness.idle_gaps(clipped, lo_ns, hi_ns)
