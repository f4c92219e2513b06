"""Data-parallel training through ``repro_torch``: ranks started by
``launch.ranks.run``, each driving the step of ``make_train_step``.

The rank loop mirrors ``launch/train.py::run_rank`` through the program's
public functions (``make_data_axes``, ``init_train_state``,
``make_train_step``, ``FailureDetector``).  Set-up makes the weights from the
seed on the device, builds the healthy step (and, for a failure cell, the
degraded one, as the CLI does) and runs the first ``warm_steps`` steps
through the window's own call, on rows that all differ; those are the steps
the reference follows.  The window then runs whole steps until ``seconds``
have passed: rank 0 decides, before each step, whether another starts, and
tells the others, so every rank runs the same steps; the window ends with the
last step.  A failure cell injects its failure at the window's first step,
as the CLI does: ``FailureDetector.detect``, then the degraded step.

After the window the check reads the program once more: the ranks' params
must be equal to the bit (the ring hands every rank the same mean), and one
more step of the window's own call, on a new batch, is held against the
reference stepping once from the same state (params and AdamW's moments at
the window's end: the program's own state, which only that step can start
from).  Rank 0 runs that reference step once the program's state is freed.

Each rank's host threads run on cores of their own (the machine's cores
shared out evenly), so that one rank's staging and gloo threads do not take
another's core.

The traced run passes ``stats=`` to the step (each phase synchronised) and
profiles every rank over the window; the end-to-end run does neither.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from r2bench import checks, harness, trace
from r2bench.drivers.common import device_info, load_fault, port_config, precision_departures
from r2bench.formulas import chunk_combine_cost, train_flops
from r2bench.reference import llama
from r2bench.reference import train as ref_train
from r2bench.traffic.tokens import BigramTokens
from r2bench.weights import flatten, make_weights

#: elements of each leaf's first gradient that the check compares one by one
SAMPLE = 4096


def sample_index(seed: int, names, numels: dict[str, int]) -> dict[str, np.ndarray]:
    """Elements to compare in each leaf, drawn from the seed."""
    return {n: np.random.default_rng((seed, 3, i)).integers(0, numels[n], SAMPLE)
            for i, n in enumerate(sorted(names))}


def rank_rows(tokens: BigramTokens, mix: dict, step: int, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Rank ``rank``'s rows of step ``step``'s global batch."""
    rows = mix["rows_per_rank"]
    b = tokens.batch(step, mix["ranks"] * rows, mix["seq_len"])
    sl = slice(rank * rows, (rank + 1) * rows)
    return b["tokens"][sl], b["labels"][sl]


def sample(leaves: dict, index: dict) -> dict[str, np.ndarray]:
    """The sampled elements of each leaf, on the host (numpy: a tensor would
    go back to the launcher through shared memory)."""
    return {n: t.detach().reshape(-1)[torch.from_numpy(index[n]).to(t.device)].cpu().numpy()
            for n, t in leaves.items()}


def finish_check(params: dict, start: dict, before: dict, index: dict) -> dict:
    """After the last step the check follows: each leaf's change since the
    start (norm) and that step's update (sampled elements)."""
    after = sample(params, index)
    return {"change_norms": {n: float((params[n].detach() - start[n]).double().norm())
                             for n in params},
            "update_samples": {n: after[n] - before[n] for n in after}}


def pin_host_threads(rank: int, world: int) -> None:
    """Every thread of this rank's process on its own share of the cores."""
    cores = sorted(os.sched_getaffinity(0))
    k = len(cores) // world
    if k < 1:
        return
    mine = cores[rank * k:(rank + 1) * k]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except OSError:                        # a thread that ended meanwhile
            pass
    torch.set_num_threads(k)


def param_digest(params: dict) -> str:
    """A digest of every leaf's bits, in order of path."""
    h = hashlib.blake2b(digest_size=16)
    for n in sorted(params):
        h.update(params[n].detach().contiguous().cpu().numpy())
    return h.hexdigest()


def snapshot(state, nu: bool) -> dict:
    """A copy of the program's params and AdamW's first moment (the second
    too, ``nu``, where the reference will step from them), with the step
    counts."""
    copy = lambda tree: {n: t.detach().clone() for n, t in flatten(tree).items()}  # noqa: E731
    snap = {"params": copy(state.params), "mu": copy(state.opt_state["mu"]),
            "step": int(state.step), "count": int(state.opt_state["count"])}
    if nu:
        snap["nu"] = copy(state.opt_state["nu"])
    return snap


def after_step(state, step_fn, batch: dict, b1: float, index: dict, nu: bool):
    """One more step of the window's own call, from the state at the
    window's end: its loss, the gradient as AdamW got it (from the moments
    before and after) and its update.  Returns the new state, the records
    and the snapshot the step started from."""
    snap = snapshot(state, nu)
    state, met = step_fn(state, batch)
    params, mu = flatten(state.params), flatten(state.opt_state["mu"])
    g = {n: (mu[n].detach() - b1 * snap["mu"][n]) / (1.0 - b1) for n in mu}
    rec = {"losses": [float(met["loss"])],
           "grad_norms": {n: float(t.double().norm()) for n, t in g.items()},
           "grad_samples": sample(g, index)}
    rec.update(finish_check(params, snap["params"], sample(snap["params"], index), index))
    return state, rec, (snap if nu else None)


def rank_main(rank: int, world: int, device: str, spec: dict) -> dict:
    """One rank: set-up, the window, and what the check and the metrics
    read."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.detection import FailureDetector
    from repro_torch.core.failures import Failure, FailureState, FailureType
    from repro_torch.core.topology import make_cluster
    from repro_torch.launch.mesh import make_data_axes
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, mix, seed = spec["config"], spec["traffic"], spec["seed"]
    cfg = port_config(c)
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    if dev.type == "cuda":
        pin_host_threads(rank, world)
    axes = make_data_axes(world)
    state = init_train_state(make_weights(c, seed, dev))
    o = mix["optimizer"]
    opt = AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"], grad_clip_norm=o["grad_clip_norm"])
    wire = c["precision"]["gradient_wire"]

    def build(**kw):
        args = dict(sync=mix["sync"], comm=CommConfig(mode=mix["comm_mode"], comm_dtype=wire),
                    axes=axes, total_steps=o["total_steps"], warmup_steps=o["warmup_steps"])
        return make_train_step(cfg, opt, **{**args, **kw})

    step_fn = build()
    fault = load_fault(spec.get("fault"))
    if fault is not None:
        step_fn = fault(step_fn, build)
    fail = mix.get("failure")
    if fail:
        nics = fail["nics_per_node"]
        degraded = build(comm=CommConfig(mode="r2ccl", degraded_rank=fail["node"],
                                         lost_fraction=max(1.0 / nics, 0.34),
                                         devices_per_node=nics, comm_dtype=wire))
        if fault is not None:
            degraded = fault(degraded, build)
        detector = FailureDetector(FailureState())
        cluster = make_cluster(max(world, 2), nics)
    tokens = BigramTokens(c["vocab_size"], seed)

    def batch(step: int) -> dict:
        t, lab = rank_rows(tokens, mix, step, rank)
        return {"tokens": torch.from_numpy(t).to(dev), "labels": torch.from_numpy(lab).to(dev)}

    # set-up: the first steps, which the reference follows (with, in a
    # failure cell, the window's first step: the one that takes the failure)
    followed = mix["warm_steps"] + (1 if fail else 0)
    params = flatten(state.params)
    start = {n: p.detach().clone() for n, p in params.items()}
    index = sample_index(seed, params, {n: p.numel() for n, p in params.items()})
    out: dict = {"losses": []}
    for s in range(mix["warm_steps"]):
        if s == followed - 1:
            before = sample(params, index)
        state, met = step_fn(state, batch(s))
        out["losses"].append(float(met["loss"]))
        if s == 0:
            mu = flatten(state.opt_state["mu"])
            g = {n: mu[n].detach() / (1.0 - opt.b1) for n in mu}
            out["grad_norms"] = {n: float(t.double().norm()) for n, t in g.items()}
            out["grad_samples"] = sample(g, index)
            del mu, g
    if fail:
        before = sample(params, index)
    else:
        out.update(finish_check(params, start, before, index))
        del start

    # the window
    flag = torch.zeros(1, dtype=torch.int32)
    totals: dict[str, float] = {}
    steps, failover_s = 0, None
    prof = trace.profiler(cpu=True) if spec["trace"] else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    if prof is not None:
        prof.__enter__()
    win0_ns = time.time_ns()
    t0 = time.perf_counter()
    s = mix["warm_steps"]
    while True:
        if rank == 0:
            flag[0] = int(time.perf_counter() - t0 < spec["seconds"])
        dist.broadcast(flag, 0)
        if not flag[0]:
            break
        t_inject = None
        if fail and steps == 0:
            t_inject = time.perf_counter()
            node, rail = fail["node"], fail["rail"]
            failure = Failure(FailureType[fail["kind"]], node, rail, at_time=t_inject - t0)
            detector.detect(failure, (node, rail), ((node + 1) % cluster.num_nodes, rail),
                            aux=((node + 2) % cluster.num_nodes, 0))
            step_fn = degraded
        stats = {} if spec["trace"] else None
        state, met = step_fn(state, batch(s), stats=stats)
        loss = float(met["loss"])
        if t_inject is not None:
            failover_s = time.perf_counter() - t_inject
            out["losses"].append(loss)
            out.update(finish_check(params, start, before, index))
            del start
        for k, v in (stats or {}).items():
            totals[k] = totals.get(k, 0.0) + v
        s += 1
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    win1_ns = time.time_ns()
    if prof is not None:
        prof.__exit__(None, None, None)
    out.update(win0_ns=win0_ns, win1_ns=win1_ns, window_s=window_s, steps=steps,
               stats=totals, failover_s=failover_s,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if prof is not None:
        out["trace"] = summarise(prof, rank, win0_ns, win1_ns, wire)
        del prof

    # after the window: the ranks' params, then one more step of the same
    # call on a new batch, which the reference follows from the same state
    out["param_digest"] = param_digest(params)
    state, out["after"], snap = after_step(state, step_fn, batch(s), opt.b1, index, rank == 0)
    out["precision_departures"] = precision_departures(flatten(state.params))
    del state, step_fn, params
    if fail:
        del degraded
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if snap is not None:
        out["after_reference"] = reference_step(c, mix, seed, snap, dev)
    out["forbidden"] = harness.forbidden_modules()
    return out


def summarise(prof, rank: int, lo: int, hi: int, wire: str) -> dict:
    """A rank's trace in memory: its device intervals (merged), device time
    by name and, on rank 0, the merges' bound and device time and the host
    operators (to name the idle gaps)."""
    events = trace.device_events(prof, lo, hi)
    out = {"intervals": harness.merge_intervals((a, b) for a, b, _ in events),
           "by_name": trace.by_name(events)}
    if rank == 0:
        merges = [e for e in events if "chunk_combine" in e[2]]
        ops = [e for e in trace.host_ops(prof, "repro_torch::chunk_combine")
               if lo <= e.start_ns() < hi]
        if merges and len(merges) == len(ops):
            bound = 0.0
            for e in ops:
                masks = e.concrete_inputs()
                bound += chunk_combine_cost(e.shapes()[0], wire, masks[2], masks[3]).bound_s()
            out["merge"] = {"bound_s": bound, "device_s": sum((b - a) * 1e-9 for a, b, _ in merges),
                            "calls": len(ops)}
        else:
            print(f"r2bench: {len(merges)} merge kernels against {len(ops)} merge calls; "
                  "chunk_combine_roofline.train is not read", flush=True)
        out["host"] = trace.host_spans(prof)
    return out


def reference_trajectory(c: dict, mix: dict, seed: int, device, *,
                         precision: llama.Precision | None = None, wire: str | None = None,
                         rows=None) -> dict:
    """The reference over the steps the check follows, from the same weights
    and rows: the records a rank makes.  ``precision`` and ``wire`` default
    to the configuration's; ``rows(batches)`` rearranges the ranks' rows (a
    control or a fault put in the program's place)."""
    params = flatten(make_weights(c, seed, device))
    tokens = BigramTokens(c["vocab_size"], seed)
    followed = mix["warm_steps"] + (1 if mix.get("failure") else 0)
    batches = [[tuple(torch.from_numpy(a).to(device) for a in rank_rows(tokens, mix, s, r))
                for r in range(mix["ranks"])] for s in range(followed)]
    if rows is not None:
        batches = rows(batches)
    start = {n: p.clone() for n, p in params.items()}
    index = sample_index(seed, params, {n: p.numel() for n, p in params.items()})
    rec: dict = {}

    def on_step(s, g):
        if s == 0:
            rec["grad_norms"] = {n: float(t.double().norm()) for n, t in g.items()}
            rec["grad_samples"] = sample(g, index)
        if s == followed - 1:
            rec["before"] = sample(params, index)

    prec = precision or llama.Precision(residual=c["precision"]["residual"])
    rec["losses"] = ref_train.steps(params, c, mix["optimizer"], batches,
                                    wire=wire or c["precision"]["gradient_wire"],
                                    precision=prec, on_step=on_step)
    rec.update(finish_check(params, start, rec.pop("before"), index))
    return rec


def reference_step(c: dict, mix: dict, seed: int, snap: dict, device) -> dict:
    """The reference's step from the program's state at the window's end
    (``snap``: params and both moments, updated here in place) on the batch
    of step ``snap["step"]``: the records ``after_step`` makes."""
    s = snap["step"]
    if snap["count"] != s:
        raise ValueError(f"the optimizer counts {snap['count']} steps, the state {s}")
    params = snap["params"]
    before = {n: p.clone() for n, p in params.items()}
    index = sample_index(seed, params, {n: p.numel() for n, p in params.items()})
    tokens = BigramTokens(c["vocab_size"], seed)
    batch = [tuple(torch.from_numpy(a).to(device) for a in rank_rows(tokens, mix, s, r))
             for r in range(mix["ranks"])]
    rec: dict = {}

    def on_step(_, g):
        rec["grad_norms"] = {n: float(t.double().norm()) for n, t in g.items()}
        rec["grad_samples"] = sample(g, index)

    rec["losses"] = ref_train.steps(params, c, mix["optimizer"], [batch],
                                    wire=c["precision"]["gradient_wire"],
                                    precision=llama.Precision(residual=c["precision"]["residual"]),
                                    on_step=on_step, moments=(snap["mu"], snap["nu"]), first=s)
    rec.update(finish_check(params, before, sample(before, index), index))
    return rec


def compare(runs: list[dict], ref: dict) -> dict[str, float]:
    """Each number the check compares, the worst over ``runs`` (every rank's
    records) against the reference's."""
    moved = checks.moved_leaves(ref["grad_norms"])
    return {
        "loss_gap": max(checks.loss_gap(r["losses"], ref["losses"]) for r in runs),
        "grad_norm_gap": max(checks.leaf_gap(r["grad_norms"], ref["grad_norms"]) for r in runs),
        "grad_sample_gap": max(checks.sample_gap(r["grad_samples"], ref["grad_samples"])
                               for r in runs),
        "update_norm_gap": max(checks.leaf_gap(r["change_norms"], ref["change_norms"], keep=moved)
                               for r in runs),
        "update_sample_gap": max(checks.sample_gap(r["update_samples"], ref["update_samples"])
                                 for r in runs),
    }


def run(ctx: harness.Context) -> dict:
    from repro_torch.launch import ranks as launch_ranks

    c, mix = ctx.cell.config, ctx.cell.traffic
    spec = {"config": c, "traffic": mix, "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "fault": ctx.fault}
    results = launch_ranks.run(rank_main, mix["ranks"], ctx.device, args=(spec,),
                               timeout=ctx.seconds + 600)
    r0 = results[0]
    device = torch.device(ctx.device)
    tokens = r0["steps"] * mix["ranks"] * mix["rows_per_rank"] * mix["seq_len"]
    out = {"e2e": {"train_tokens_per_s": tokens / r0["window_s"],
                   "setup_s": r0["win0_ns"] * 1e-9 - ctx.t_process},
           "attempted": r0["steps"], "failed": 0,
           "device": device_info(device, ctx.cell.chips, sum(r["peak_bytes"] for r in results))}
    flops = train_flops(c, [mix["seq_len"]] * (mix["ranks"] * mix["rows_per_rank"]))
    records = {"train": {"steps": r0["steps"], "window_s": r0["window_s"], "stats": r0["stats"],
                         "failover_s": r0["failover_s"],
                         "model_flops": flops * r0["steps"]}}
    if ctx.trace:
        lo, hi = r0["win0_ns"], r0["win1_ns"]
        intervals = [iv for r in results for iv in r["trace"]["intervals"]]
        busy_s, gaps = trace.busy(intervals, lo, hi)
        ops: dict[str, float] = {}
        for r in results:
            for n, sec in r["trace"]["by_name"].items():
                ops[n] = ops.get(n, 0.0) + sec
        starts, ends, names = r0["trace"]["host"]
        out["breakdown"] = trace.breakdown(ops, gaps,
                                           lambda g: trace.name_gap(g, starts, ends, names))
        window_s = (hi - lo) * 1e-9
        out["device"].update(busy_s=busy_s, window_s=window_s)
        records["train"].update(busy_s=busy_s, trace_window_s=window_s,
                                merge=r0["trace"].get("merge"))
    out["records"] = records
    for r in results:
        r.pop("trace", None)
    out["forbidden"] = sorted({n for r in results for n in r["forbidden"]})
    ref = reference_trajectory(c, mix, ctx.seed, device)
    # the numbers a cell compares are those its workload file gives a limit;
    # two are exact: the ranks' params equal to the bit, and the products
    # and weights at the configuration's float32
    lim = ctx.cell.limits
    numbers = compare(results, ref)
    numbers.update({f"after_{k}": v for k, v in
                    compare([r["after"] for r in results], r0["after_reference"]).items()})
    out["checks"] = {k: (v, lim[k]) for k, v in numbers.items() if k in lim}
    out["checks"]["ranks_param_mismatch"] = (
        sum(r["param_digest"] != r0["param_digest"] for r in results), 0)
    out["checks"]["precision_departures"] = (sum(r["precision_departures"] for r in results), 0)
    return out
