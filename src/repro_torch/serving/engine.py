"""Batched serving engine with failure-aware continuation (PyTorch).

The port of the JAX package's ``serving/engine.py``: prefill builds
per-layer caches, decode iterates one token per step for the whole batch,
and a failure is handled by one of the paper's strategies:

  * ``restart``  — on failure, drop state, re-prefill and regenerate
                   (models the 35 s engine restart + reprocessing);
  * ``reroute``  — hand the batch to a healthy replica that also carries
                   its own load (service rate halves);
  * ``dejavu``   — KV replication: pay the replication overhead always and
                   a reconstruction penalty at failover;
  * ``r2ccl``    — transparent connection migration: the hiccup is the
                   recovery control plane's per-stage ledger total
                   (detect → diagnose → migrate → rebalance), then continue
                   at the residual rate.

Compute runs for real on ``device`` (prefill attention and the recurrent
scans in the Hopper kernels on the card); *network* failure costs are modelled in
virtual time by the port's copy of the control plane and the ``comm_sim``
constants, as in the JAX package.

Decode takes one path on every device: the engine keeps static buffers of
``G`` rows, the largest batch served so far (one cache set and a token
vector), and captures ``decode`` over their first ``r`` rows for each ``r``
of :func:`graph_rows` (``G`` and the powers of two below it), all at once
when ``G`` grows.  On the card a capture is one CUDA graph, replayed once a
token; elsewhere it is the call itself.  A batch of ``B`` rows runs prefill
eagerly in the first ``B`` rows and replays the capture of the fewest rows
that hold it; the padded rows carry what they last held and are thrown
away.  Every cache holds its position on the device
(``init_caches(device_index=True)``), so no step reads the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm_sim import (
    DEJAVU_OVERHEAD_RANGE,
    R2CCL_MIGRATION_LATENCY,
    VLLM_RESTART_DELAY,
    strategy_rate,
)
from repro_torch.core.failures import Failure, FailureState
from repro_torch.core.telemetry import TraceLog, stage_totals_from_trace
from repro_torch.core.topology import make_cluster
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import apply_model, cache_rows, init_caches, reset_caches
from repro_torch.runtime.control_plane import ControlPlane, LedgerEntry


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (T,) token ids
    max_new_tokens: int = 32
    rid: int | None = None             # the caller's id, in the engine.batch span


@dataclasses.dataclass
class RequestResult:
    tokens: list[int]
    ttft: float                        # virtual seconds
    tpot: float                        # mean time per output token
    total_latency: float
    failovers: int = 0


def make_prefill_fn(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill(params, batch, caches):
        logits, caches, _ = apply_model(params, cfg, batch, mode="prefill",
                                        caches=caches)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, caches
    return prefill


def make_decode_fn(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def decode(params, tokens, caches):
        logits, caches, _ = apply_model(
            params, cfg, {"tokens": tokens[:, None]}, mode="decode",
            caches=caches)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, caches
    return decode


def graph_rows(G: int) -> list[int]:
    """The row counts the decode step is captured at for static buffers of
    ``G`` rows: ``G`` and the powers of two below it.  The step reads the
    same weights at every count, but cuBLAS's float32 GEMMs take longer as
    the rows grow (deepseek-67b at 8 layers on an H100: 10.1 ms a step at 1
    row, 12.6 at 4, 15.9 at 16), so a small batch replays a small graph
    rather than padding up to ``G``."""
    return sorted({G, *(1 << i for i in range(G.bit_length()) if 1 << i < G)})


def cuda_graph(step: Callable[[], None]) -> Callable[[], None]:
    """Capture ``step``, a call on static buffers, as one CUDA graph after a
    warm-up call on a side stream; returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


class ServingEngine:
    """One model replica serving batched greedy decoding on ``device``."""

    def __init__(self, cfg: ModelConfig, params, *, context_len: int = 512,
                 strategy: str = "r2ccl", nics_per_node: int = 8,
                 pp: int = 2, cache_dtype=torch.float32,
                 trace: TraceLog | None = None,
                 clock: Callable[[], float] | None = None,
                 capture: Callable | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.context_len = context_len
        self.strategy = strategy
        self.nics = nics_per_node
        # Host-clock seam: real compute (prefill/decode) is *measured*, never
        # simulated, and the measurement enters through this injected timer —
        # the only wall-clock read the serving path makes (but the tracer's,
        # while tracing is on, which moves no result).  Tests inject a
        # fake clock to make the whole engine a pure function of its inputs.
        self.clock = clock if clock is not None else time.perf_counter
        self.prefill = make_prefill_fn(cfg)
        self.decode = make_decode_fn(cfg)
        self.cache_dtype = cache_dtype
        # Capture seam: ``capture(step)`` returns a call that replays
        # ``step``; on the card :func:`cuda_graph`, elsewhere the call itself.
        self.capture = capture or (cuda_graph if self.device.type == "cuda"
                                   else lambda step: step)
        self._replays: dict[int, Callable[[], None]] = {}   # by row count
        self._graph_rows = 0                   # G: the static buffers' rows
        self._graph_caches: dict | None = None
        self._graph_tokens: torch.Tensor | None = None
        self.failure_state = FailureState()
        self.failovers = 0
        # steady-state replication tax for DejaVu-style KV streaming
        self.dejavu_tax = float(np.mean(DEJAVU_OVERHEAD_RANGE))
        # The r2ccl hiccup is the recovery pipeline's ledger total, derived
        # per failure on this replica's node span (TP stays intra-node, so
        # the replica spans pp nodes; shared FailureState so the control
        # plane sees what the engine sees).  Serving has no collective
        # program to swap, so replanning is off.
        self.control_plane = ControlPlane(
            make_cluster(max(2, pp), nics_per_node), replan=False,
            state=self.failure_state)
        # Structured trace shared with the control plane: every recovery
        # pipeline run mirrors its per-stage spans here, so a serving
        # hiccup is attributable to the stage that caused it.
        self.trace = trace if trace is not None else TraceLog()
        self.control_plane.trace = self.trace
        self.last_recovery: LedgerEntry | None = None

    # -- failure plumbing ---------------------------------------------------
    def inject_failure(self, failure: Failure, at: float = 0.0) -> bool:
        """Apply a failure; returns whether serving can continue in-place."""
        ok = self.failure_state.apply(failure)
        self.trace.add("failure", at, node=failure.node, rail=failure.rail,
                       kind=failure.ftype.value, severity=failure.severity,
                       silent=failure.silent)
        return ok and self.strategy in ("r2ccl", "dejavu")

    def hiccup_attribution(self, *, normalize: bool = False) -> dict[str, float]:
        """Serving hiccup time per recovery-pipeline stage, reconstructed
        from the trace's ``stage`` spans alone (virtual seconds, or fractions
        of the hiccup total with ``normalize=True``); empty for strategies
        that never run the pipeline."""
        totals = stage_totals_from_trace(self.trace.records)
        if not normalize:
            return totals
        total = sum(totals.values())
        if total <= 0.0:
            return {}
        return {k: v / total for k, v in totals.items()}

    def _graph_for(self, B: int) -> tuple[Callable[[], None], dict]:
        """The replay that serves ``B`` rows, and the first ``B`` rows of the
        static caches, reset as ``init_caches`` makes them.  When ``B`` is
        more than the buffers hold, they are made anew at ``B`` rows and the
        step captured at each of ``graph_rows(B)``."""
        if B > self._graph_rows:
            # the old graphs and buffers go before the new ones are made
            self._replays, self._graph_caches, self._graph_tokens = {}, None, None
            caches = init_caches(self.cfg, B, self.context_len, dtype=self.cache_dtype,
                                 device=self.device, device_index=True)
            tokens = torch.zeros(B, dtype=torch.int64, device=self.device)
            decode, params = self.decode, self.params
            for rows in graph_rows(B):
                def step(toks=tokens[:rows], views=cache_rows(caches, rows)):
                    next_tok, _ = decode(params, toks, views)
                    toks.copy_(next_tok)

                self._replays[rows] = self.capture(step)
                tracing.count("engine.graph_capture")
            self._graph_rows, self._graph_caches, self._graph_tokens = B, caches, tokens
        caches = cache_rows(self._graph_caches, B)
        reset_caches(caches)
        return self._replays[min(r for r in self._replays if r >= B)], caches

    def _degraded_rate(self) -> float:
        """Residual comm-rate multiplier under the current failures."""
        lost = len(self.failure_state.failed_nics) / self.nics
        lost = min(lost, 0.99)
        if self.strategy == "r2ccl":
            return strategy_rate("balance", 1.0, lost, n_nodes=2, g=self.nics)
        return 1.0 - lost

    # -- serving ------------------------------------------------------------
    def run_batch(self, requests: list[Request], *,
                  fail_at_step: int | None = None,
                  failure: Failure | None = None) -> list[RequestResult]:
        """Serve a batch, optionally injecting ``failure`` at decode step
        ``fail_at_step``.  Returns per-request latency accounting in
        *virtual* time (real compute + modeled network events).  While
        tracing is on the call is the span ``engine.batch`` (attributes:
        the requests' ``rids``, ``B`` and the padded ``T``) and each decode
        step's call, before its synchronize, ``engine.decode_enqueue`` (the
        capture's replay); both read the tracer's clock, never ``clock``.
        The counters are ``engine.graph_capture`` (a capture) and
        ``engine.graph_replay`` (a decode step)."""
        with tracing.span("engine.batch") as span:
            if span:
                span.attrs.update(rids=[r.rid for r in requests], B=len(requests),
                                  T=max(len(r.prompt) for r in requests))
            return self._run_batch(requests, fail_at_step, failure)

    def _run_batch(self, requests: list[Request], fail_at_step: int | None,
                   failure: Failure | None) -> list[RequestResult]:
        B = len(requests)
        T = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, T), np.int64)
        for i, r in enumerate(requests):
            toks[i, T - len(r.prompt):] = r.prompt    # left-pad, no mask
        max_new = max(r.max_new_tokens for r in requests)

        replay, caches = self._graph_for(B)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}

        vtime = 0.0
        t0 = self.clock()
        next_tok, _ = self.prefill(self.params, batch, caches)
        synchronize(self.device)
        prefill_time = self.clock() - t0
        vtime += prefill_time
        ttft = vtime
        failovers = 0

        generated = [[t] for t in next_tok.tolist()]
        self._graph_tokens[:B].copy_(next_tok)
        decode_times: list[float] = []
        rate = 1.0
        step = 0
        while step < max_new - 1:
            if fail_at_step is not None and step == fail_at_step and failure is not None:
                can_continue = self.inject_failure(failure, at=vtime)
                if self.strategy == "restart":
                    vtime += VLLM_RESTART_DELAY
                    # reprocess everything generated so far
                    vtime += prefill_time + sum(decode_times)
                    failovers += 1
                elif self.strategy == "reroute":
                    rate = 0.5                        # doubled load on the peer
                    vtime += prefill_time             # re-prefill on the peer
                    failovers += 1
                elif self.strategy == "dejavu":
                    vtime += sum(decode_times) * 0.25  # reconstruct un-replicated tail
                    failovers += 1
                elif can_continue:                     # r2ccl hot repair
                    # Run the detect→diagnose→migrate→rebalance pipeline:
                    # the hiccup is its ledger total, not a constant.
                    outcome = None
                    if 0 <= failure.node < len(self.control_plane.cluster.nodes):
                        outcome = self.control_plane.handle_failure(
                            failure, vtime)
                    if outcome is not None:
                        self.last_recovery = outcome.entry
                        vtime += outcome.entry.total
                    else:          # outside this replica / out-of-pipeline
                        vtime += R2CCL_MIGRATION_LATENCY
                    rate = self._degraded_rate()
                    failovers += 1
            tracing.count("engine.graph_replay")
            t0 = self.clock()
            with tracing.span("engine.decode_enqueue"):
                replay()
                next_tok = self._graph_tokens[:B]
            synchronize(self.device)
            dt = self.clock() - t0
            base = dt * (1.0 + (self.dejavu_tax if self.strategy == "dejavu" else 0.0))
            decode_times.append(base / rate)
            vtime += base / rate
            for i, t in enumerate(next_tok.tolist()):
                if len(generated[i]) < requests[i].max_new_tokens:
                    generated[i].append(t)
            step += 1

        self.failovers += failovers
        results = []
        for i, r in enumerate(requests):
            n = max(len(generated[i]) - 1, 1)
            results.append(RequestResult(
                tokens=generated[i],
                ttft=ttft,
                tpot=(vtime - ttft) / n,
                total_latency=vtime,
                failovers=failovers,
            ))
        return results


@dataclasses.dataclass
class TraceResult:
    qps: float
    ttft_p50: float
    ttft_p95: float
    tpot_p50: float
    completed: int
    failovers: int


def serve_trace(
    engine: ServingEngine,
    *,
    qps: float,
    duration: float,
    prompt_len: int = 32,
    max_new_tokens: int = 8,
    batch_window: float = 0.05,
    fail_time: float | None = None,
    failure: Failure | None = None,
    seed: int = 0,
) -> TraceResult:
    """Arrival-driven serving on the real engine (virtual-time queueing).

    Fixed-rate arrivals are micro-batched in ``batch_window`` slices and fed
    through the engine; per-request TTFT = queue wait + measured prefill,
    TPOT from measured decode steps.  A failure can be injected at
    ``fail_time`` (virtual seconds) with the engine's configured strategy.
    """
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while t < duration:
        arrivals.append(t)
        t += 1.0 / max(qps, 1e-9)

    ttfts: list[float] = []
    tpots: list[float] = []
    server_free = 0.0
    injected = False
    i = 0
    while i < len(arrivals):
        # group arrivals within the batch window
        j = i
        while j + 1 < len(arrivals) and arrivals[j + 1] - arrivals[i] < batch_window:
            j += 1
        group = arrivals[i:j + 1]
        start = max(group[-1], server_free)
        fail_step = None
        fail_obj = None
        if (fail_time is not None and not injected and start >= fail_time
                and failure is not None):
            fail_step, fail_obj = 1, failure
            injected = True
        reqs = [Request(prompt=rng.integers(0, engine.cfg.vocab_size, prompt_len),
                        max_new_tokens=max_new_tokens) for _ in group]
        results = engine.run_batch(reqs, fail_at_step=fail_step, failure=fail_obj)
        for arr, r in zip(group, results):
            ttfts.append((start - arr) + r.ttft)
            tpots.append(r.tpot)
        server_free = start + results[0].total_latency
        i = j + 1

    ttfts.sort()
    tpots.sort()
    pct = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))] if xs else float("inf")
    return TraceResult(
        qps=qps,
        ttft_p50=pct(ttfts, 0.50), ttft_p95=pct(ttfts, 0.95),
        tpot_p50=pct(tpots, 0.50),
        completed=len(ttfts),
        failovers=engine.failovers,
    )
