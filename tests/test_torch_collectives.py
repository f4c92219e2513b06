"""The port's collectives (``core/collectives.py``) on gloo ranks, held to
the numpy oracle ``core.executor_np`` of the JAX package and to the
semantic sum.

The ranks start once per world size (2, 3 and 4 processes, ``launch.ranks``)
and run every case in one go; the tests read the results.

  * the all_reduce modes of ``tests/test_multidevice.py`` plus ``tree``,
    against ``x.sum(0)`` at atol 1e-4 (fp32 sums in another order);
  * every ``builder_corpus`` entry on 2 to 4 ranks against the JAX package's
    ``executor_np``, exactly, on integer-valued inputs (every partial sum is
    exact in float32);
  * the merges: one ``chunk_combine`` per step of every non-empty segment,
    on every rank;
  * the staging buffers, which receive a row at the phase of the row it
    merges into.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

from _torch_ranks import collectives_rank
from repro.core import executor_np as jexec
from repro.core.schedule import ChunkSchedule as JChunkSchedule
from repro.core.schedule import CollectiveProgram as JProgram
from repro.core.schedule import Segment as JSegment
from repro.core.schedule import Step as JStep
from repro_torch.analysis.corpus import builder_corpus
from repro_torch.core.collectives import VEC_BYTES, StagingBuffers
from repro_torch.launch import ranks

L = 37                                   # not a multiple of any chunk count
CORPUS = [(label, prog) for label, prog in builder_corpus() if prog.n <= 4]
MODES = [("xla", {}), ("ring", {}), ("tree", {}),
         ("r2ccl", dict(degraded=3, lost_fraction=0.5)),
         ("r2ccl", dict(degraded=0, lost_fraction=0.9)),
         ("recursive", dict(bandwidths=(4, 2, 3, 4.0)))]


def _data(label: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    return rng.integers(-50, 50, size=(n, L)).astype(np.float32)


def _segments(prog):
    return prog.segments if hasattr(prog, "segments") else None


@functools.lru_cache(maxsize=None)
def _results(n: int):
    entries = [(prog, _data(label, n)) for label, prog in CORPUS if prog.n == n]
    modes = []
    if n == 4:
        x = np.random.default_rng(0).normal(size=(4, 53)).astype(np.float32)
        modes = [(mode, kw, x) for mode, kw in MODES]
    return ranks.run(collectives_rank, n, "cpu", args=(modes, entries), timeout=600)


def _to_jax(prog):
    """The same program as JAX package objects (field by field)."""
    def sched(s):
        return JChunkSchedule(s.name, s.n, s.num_chunks,
                              [JStep(st.perm, st.send_chunk, st.recv_chunk,
                                     st.accumulate, st.whole_buffer) for st in s.steps],
                              s.result_ranks)
    if hasattr(prog, "segments"):
        return JProgram(prog.name, prog.n, [JSegment(seg.frac, sched(seg.schedule))
                                            for seg in prog.segments])
    return sched(prog)


def _expected_merges(prog) -> int:
    segs = prog.segments if hasattr(prog, "segments") else [JSegment(1.0, prog)]
    total, start, count = L, 0, 0
    for i, seg in enumerate(segs):
        end = total if i == len(segs) - 1 else start + int(round(seg.frac * total))
        if max(end, start) > start:
            count += len(seg.schedule.steps)
        start = end
    return count


@pytest.mark.parametrize("mode_idx", range(len(MODES)), ids=[
    f"{m}-{i}" for i, (m, _) in enumerate(MODES)])
def test_all_reduce_modes_sum(mode_idx):
    res = _results(4)
    x = np.random.default_rng(0).normal(size=(4, 53)).astype(np.float32)
    mode = MODES[mode_idx][0]
    for r in range(4):
        got, merges = res[r]["modes"][mode_idx]
        np.testing.assert_allclose(got, x.sum(0), atol=1e-4)
        assert (merges == 0) == (mode == "xla")


@pytest.mark.parametrize("idx", range(len(CORPUS)), ids=[label for label, _ in CORPUS])
def test_corpus_matches_executor_np(idx):
    label, prog = CORPUS[idx]
    n = prog.n
    res = _results(n)
    k = [i for i, (_, p) in enumerate(CORPUS) if p.n == n].index(idx)
    data = _data(label, n)
    jprog = _to_jax(prog)
    if hasattr(jprog, "segments"):
        want = jexec.execute_program(jprog, list(data))
    else:
        want = jexec.execute_chunk_schedule(jprog, list(data))
    for r in range(n):
        got, merges = res[r]["programs"][k]
        np.testing.assert_array_equal(got.astype(np.float64), want[r])
        assert merges == _expected_merges(prog)


def test_sync_gradients_bf16_wire_mean():
    """A gradient tree in bf16 through the degraded R2CCL program: the mean
    over ranks, kept in bf16 (tolerance: a few bf16 roundings, 3e-2)."""
    res = _results(4)
    want = {k: np.mean([res[r]["tree"][0][k] for r in range(4)], axis=0)
            for k in ("w", "b")}
    for r in range(4):
        local, synced, is_bf16 = res[r]["tree"]
        assert is_bf16
        for k in ("w", "b"):
            np.testing.assert_allclose(synced[k], want[k], atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staging_buffer_takes_the_rows_phase(dtype):
    """A received row is staged at the 16-byte phase of the row it merges
    into, whatever the row's offset in its chunk buffer, and the buffer is
    reused while it is large enough."""
    pool = StagingBuffers()
    chunks = torch.zeros(3 * 37 + 8, dtype=dtype)
    first = None
    for off in range(9):
        row = chunks[off:off + 37]
        view = pool.get("recv", 37, dtype, row.device, phase_of=row)
        assert view.numel() == 37 and view.dtype == dtype
        assert (view.data_ptr() - row.data_ptr()) % VEC_BYTES == 0
        first = first or view.untyped_storage().data_ptr()
        assert view.untyped_storage().data_ptr() == first
    assert pool.get("recv", 37, dtype, chunks.device).numel() == 37
