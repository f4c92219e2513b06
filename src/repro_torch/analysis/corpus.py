"""Builder corpus: every schedule/program builder over a seeded parameter
sweep, for the property tests (the port's copy of the JAX package's
``analysis/corpus.py``).

``builder_corpus`` enumerates (label, schedule-or-program) pairs covering
all builders in ``core/schedule.py`` / ``core/allreduce.py`` /
``core/recursive.py`` across sizes, rotated and shuffled ring orders,
roots, degraded-bandwidth fractions, and bandwidth spectra.  Deterministic
for a given seed (shuffles use a local ``random.Random(seed)``).
"""

from __future__ import annotations

import random
from typing import Iterator

from repro_torch.core.allreduce import build_partial_all_reduce, build_r2ccl_all_reduce
from repro_torch.core.recursive import build_recursive_all_reduce
from repro_torch.core.schedule import (
    ChunkSchedule,
    CollectiveProgram,
    build_ring_all_gather,
    build_ring_all_reduce,
    build_ring_broadcast,
    build_ring_reduce_scatter,
    build_tree_all_reduce,
    build_tree_broadcast,
    build_tree_reduce,
)

__all__ = ["builder_corpus", "corpus_orders"]

Entry = "tuple[str, ChunkSchedule | CollectiveProgram]"


def corpus_orders(n: int, rng: random.Random) -> list[list[int]]:
    """Identity, one rotation, one reversal, one shuffle of range(n)."""
    base = list(range(n))
    rot = base[1:] + base[:1]
    shuf = list(base)
    rng.shuffle(shuf)
    orders = [base, rot, base[::-1], shuf]
    uniq: list[list[int]] = []
    for o in orders:
        if o not in uniq:
            uniq.append(o)
    return uniq


def builder_corpus(seed: int = 0, max_n: int = 8) -> Iterator[Entry]:
    """Yield (label, schedule-or-program) for every builder sweep point."""
    rng = random.Random(seed)

    for n in range(2, max_n + 1):
        for oi, order in enumerate(corpus_orders(n, rng)):
            tag = f"n{n}.o{oi}"
            yield (f"ring_rs/{tag}", build_ring_reduce_scatter(order, n))
            yield (f"ring_ag/{tag}", build_ring_all_gather(order, n))
            yield (f"ring_ar/{tag}", build_ring_all_reduce(order, n))
            root = order[rng.randrange(n)]
            yield (f"ring_bcast/{tag}.r{root}",
                   build_ring_broadcast(order, n, root))
            yield (f"tree_reduce/{tag}.r{root}",
                   build_tree_reduce(order, n, root))
            yield (f"tree_bcast/{tag}.r{root}",
                   build_tree_broadcast(order, n, root))
            yield (f"tree_ar/{tag}.r{root}",
                   build_tree_all_reduce(order, n, root=root))

    # degraded-node family: partial AllReduce + the full R2CCL program
    for n in range(3, max_n + 1):
        order = list(range(n))
        rng.shuffle(order)
        degraded = order[rng.randrange(n)]
        healthy = [r for r in order if r != degraded]
        yield (f"partial_ar/n{n}.d{degraded}",
               build_partial_all_reduce(healthy, degraded, n))
        for x in (0.05, 0.4, 0.8):
            prog, _plan = build_r2ccl_all_reduce(order, degraded, x=x)
            yield (f"r2ccl/n{n}.d{degraded}.x{x}", prog)

    # recursive decomposition over bandwidth spectra (multi-segment,
    # exercises the multi-bridge subring builder when nodes drop out)
    spectra = [
        [1.0] * 4,                       # flat: single level
        [1.0, 1.0, 0.5, 1.0],            # one slow node
        [1.0, 0.6, 0.6, 0.3, 1.0],       # staircase
        [1.0, 1.0, 0.0, 1.0, 1.0, 0.7],  # dead node -> bridged subring
    ]
    for si, bw in enumerate(spectra):
        prog, _levels = build_recursive_all_reduce(bw)
        yield (f"recursive/s{si}", prog)
