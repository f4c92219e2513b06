"""Open-loop request schedules from a traffic mix's parameters.

The mix fixes the inter-arrival gaps (exponential, at ``rate`` requests a
second: Poisson arrivals) and the sizes (prompt lengths lognormal around
``prompt.median`` with ``prompt.sigma``, clipped to
``prompt.min``..``prompt.max``; output lengths uniform over
``output.min``..``output.max``), in order, all drawn from ``base_seed``: every
run offers the same work at the same times, and a run's seed draws only the
prompts' tokens (``tokens.py``) and the weights.  Dealing the same gaps and
sizes out in another order for each seed moved the p90 TTFT of one cell
from 2.5 to 6.2 s between seeds, against at most 7% between two runs of one
seed: at four fifths of the knee the order of bursts sets the queue.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    due: float          # seconds after the window opens
    prompt_len: int
    output_len: int


def schedule(mix: dict, seconds: float, rate: float | None = None) -> list[Request]:
    """The requests due in a window of ``seconds``, in order of arrival;
    ``rate`` overrides the mix's (the knee sweep)."""
    rate = float(mix["rate"] if rate is None else rate)
    base = np.random.default_rng(mix["base_seed"])
    gaps = []
    t = 0.0
    while True:
        g = float(base.exponential(1.0 / rate))
        if t + g >= seconds:
            break
        gaps.append(g)
        t += g
    n = len(gaps)
    p = mix["prompt"]
    prompts = np.clip(np.round(np.exp(np.log(p["median"]) + p["sigma"] * base.standard_normal(n))),
                      p["min"], p["max"]).astype(int)
    o = mix["output"]
    outputs = base.integers(o["min"], o["max"] + 1, size=n)
    due = np.cumsum(gaps)
    return [Request(i, float(due[i]), int(prompts[i]), int(outputs[i])) for i in range(n)]
