"""Rank functions for the port's multi-process tests (``launch.ranks.run``
pickles them by module path, so they live in a module that imports no JAX:
each rank starts a fresh interpreter)."""

import numpy as np
import torch


def _count_merges():
    """Wrap ``ops.chunk_combine`` (which the collectives call once per step
    on every rank) with a call counter; returns the counter list."""
    from repro_torch.kernels import ops
    calls = [0]
    inner = ops.chunk_combine

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    ops.chunk_combine = counted
    return calls


def collectives_rank(rank, world, device, modes, programs):
    """``modes``: (mode, kwargs, (world, L) data) run through ``all_reduce``;
    ``programs``: (schedule or program, (world, L) data) run through
    ``execute_program`` / ``execute_schedule``.  Returns this rank's results
    and the merges each made."""
    from repro_torch.core.collectives import (DataAxis, all_reduce, execute_program,
                                              execute_schedule, sync_gradients)
    axis = DataAxis()
    calls = _count_merges()
    out = {"modes": [], "programs": []}
    for mode, kw, data in modes:
        calls[0] = 0
        y = all_reduce(torch.from_numpy(data[rank]).to(device), axis, mode=mode, **kw)
        out["modes"].append((y.cpu().numpy(), calls[0]))
    for prog, data in programs:
        calls[0] = 0
        x = torch.from_numpy(data[rank]).to(device)
        run = execute_program if hasattr(prog, "segments") else execute_schedule
        out["programs"].append((run(x, prog, axis).cpu().numpy(), calls[0]))
    # a gradient tree in the bf16 wire dtype, mean over the ranks
    rng = np.random.default_rng(rank)
    tree = {"w": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)),
            "b": (torch.from_numpy(rng.normal(size=3).astype(np.float32)),)}
    wire = {"w": tree["w"].bfloat16(), "b": (tree["b"][0].bfloat16(),)}
    synced = sync_gradients(wire, axis, mode="r2ccl", degraded=1, lost_fraction=0.5, g=2)
    out["tree"] = ({"w": tree["w"].numpy(), "b": tree["b"][0].numpy()},
                   {"w": synced["w"].float().numpy(), "b": synced["b"][0].float().numpy()},
                   synced["w"].dtype == torch.bfloat16)
    return out


def train_rank(rank, world, device, spec):
    """``spec``: arch, the JAX-initialised params (numpy tree), steps,
    seq_len, global batch, ``cycle`` (step i trains on batch i % cycle), lr,
    warmup/total steps, a list of (first step, sync, CommConfig kwargs)
    phases and, optionally, ``pods`` (the ranks as a ``("pod", "data")``
    mesh of that many pods, ``launch.mesh.make_data_axes(world // pods, 1,
    pods)``).  Returns the
    losses, the bytes this rank sent each step, the sum of this rank's final
    params and rank 0's final params as numpy arrays (by path)."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.collectives import DataAxis
    from repro_torch.data import make_batch
    from repro_torch.models import get_smoke_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import leaves_with_path

    cfg = get_smoke_config(spec["arch"])
    params = params_from_jax(spec["params"], device=device)
    state = init_train_state(params)
    if spec.get("pods", 1) > 1:
        from repro_torch.launch.mesh import make_data_axes
        axes = make_data_axes(world // spec["pods"], 1, spec["pods"])
    else:
        axes = (DataAxis(),)
    phases = [(start, make_train_step(cfg, AdamWConfig(lr=spec["lr"]), sync=sync,
                                      comm=CommConfig(**comm) if comm else None,
                                      axes=axes, warmup_steps=spec["warmup"],
                                      total_steps=spec["total"]))
              for start, sync, comm in spec["phases"]]
    lb = spec["batch"] // world
    losses, sent = [], []
    for i in range(spec["steps"]):
        step = [fn for start, fn in phases if start <= i][-1]
        b = make_batch(cfg, seq_len=spec["seq_len"], batch_size=spec["batch"],
                       step=i % spec["cycle"])
        batch = {k: torch.from_numpy(v[rank * lb:(rank + 1) * lb]) for k, v in b.items()}
        stats: dict = {}
        state, m = step(state, batch, stats=stats)
        losses.append(float(m["loss"]))
        sent.append(stats.get("sent_bytes", 0))
    flat = {"/".join(p): t.detach().numpy() for p, t in leaves_with_path(state.params)}
    return {"losses": losses, "sent_bytes": sent,
            "checksum": float(sum(v.astype(np.float64).sum() for v in flat.values())),
            "params": flat if rank == 0 else None}


def pods_rank(rank, world, device, pods, modes, tree_seed):
    """On a ``("pod", "data")`` layout of ``pods`` pods
    (``launch.mesh.make_data_axes(world // pods, 1, pods)``): each of ``modes`` — (mode, kwargs,
    (world, L) data) — through ``sync_over_axes`` (the data axis's schedule,
    then a ring over the pod axis, as the train step chains them), summing;
    then a bf16 tree (``np.random.default_rng(tree_seed
    + rank)``) through the degraded R2CCL program (degraded 1, lost 0.5, g 2)
    and the pod ring, mean.  Returns the sums and the merges each made, the
    tree, the axes' ranks, sizes and global ranks, and what ``make_data_axes``
    says of a pod count that does not divide the world."""
    from repro_torch.core.collectives import sync_over_axes
    from repro_torch.launch.mesh import make_data_axes

    pod, data = make_data_axes(world // pods, 1, pods)
    calls = _count_merges()
    out = {"modes": []}
    for mode, kw, x in modes:
        calls[0] = 0
        y = sync_over_axes(torch.from_numpy(x[rank]).to(device), (pod, data), mode=mode,
                           mean=False, **kw)
        out["modes"].append((y.cpu().numpy(), calls[0]))
    rng = np.random.default_rng(tree_seed + rank)
    tree = {"w": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)).bfloat16(),
            "b": torch.from_numpy(rng.normal(size=3).astype(np.float32)).bfloat16()}
    synced = sync_over_axes(tree, (pod, data), mode="r2ccl", mean=True, degraded=1,
                            lost_fraction=0.5, g=2)
    out["tree"] = {k: (v.dtype == torch.bfloat16, v.view(torch.int16).numpy())
                   for k, v in synced.items()}
    out["axes"] = [(a.rank, a.size, [a.global_rank(r) for r in range(a.size)])
                   for a in (pod, data)]
    try:
        make_data_axes(world // 3, 1, 3)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


def sharding_rank(rank, world, device, arch, modes):
    """Place ``arch``'s smoke params (seed 0, the same on every rank) on a
    (2, 2) ``("data", "model")`` host mesh by the specs of each rule set in
    ``modes``.  Returns, by mode, each leaf's spec, the shape of this rank's
    local shard and that of the whole tensor, and whether ``full_tensor()``
    gives the weights back bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh, rules_for
    from repro_torch.launch.sharding import distribute, param_specs
    from repro_torch.models import get_smoke_config, init_model, model_axes
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = get_smoke_config(arch)
    mesh = make_host_mesh(2, 2, device_type="cpu")
    params = init_model(cfg, seed=0, device="cpu")
    out = {}
    for mode in modes:
        specs = param_specs(mesh, rules_for(cfg, mode), model_axes(cfg), params)
        placed = distribute(params, mesh, specs)
        rows = []
        tree_map(lambda p, s, d: rows.append(
            (s, tuple(d.to_local().shape), tuple(p.shape),
             torch.equal(d.full_tensor(), p))), params, specs, placed)
        names = ["/".join(path) for path, _ in leaves_with_path(params)]
        out[mode] = dict(zip(names, rows))
    return out


def cli_rank(rank, world, device, a, params):
    """The training CLI's rank (``launch.train.run_rank`` with the parsed
    arguments ``a``) from the JAX-initialised ``params`` (numpy tree) in
    place of the port's own ``init_model``, so that its steps can be held
    to the JAX package's CLI; returns the rank's result with its final
    params as numpy arrays (by path)."""
    from repro_torch.launch import train
    from repro_torch.models.convert import params_from_jax
    from repro_torch.tree import leaves_with_path

    train.init_model = lambda cfg, seed=0, device="cpu": params_from_jax(params, device=device)
    final = {}
    make = train.make_train_step

    def keep_state(*args, **kw):
        step = make(*args, **kw)

        def run(state, batch, stats=None):
            state, metrics = step(state, batch, stats=stats)
            final["params"] = state.params
            return state, metrics
        return run
    train.make_train_step = keep_state
    out = train.run_rank(rank, world, device, a)
    out["params"] = {"/".join(p): t.detach().numpy()
                     for p, t in leaves_with_path(final["params"])}
    return out


def axes_rank(rank, world, device, data, model):
    """``launch.mesh.make_data_axes(data, model)``: this rank's axes as
    (rank, size, global ranks in group order), and what it says of a
    layout that does not take the world and of pods with a model axis."""
    from repro_torch.launch.mesh import make_data_axes

    axes = [(a.rank, a.size, [a.global_rank(r) for r in range(a.size)])
            for a in make_data_axes(data, model)]
    refused = []
    for args in ((3, model), (data // 2, model, 2)):
        try:
            make_data_axes(*args)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    return axes, refused


def tracing_rank(rank, world, device, data, cases):
    """Each (mode, kwargs) of ``cases`` through ``all_reduce`` on
    ``data[rank]``, three times: tracing on (a program new to the process:
    it is built), off, and on again (a cache hit).  Returns per case and run
    the result, the ``stats``, the drained spans as (name, the enclosing
    span's name) and the counters, and the result with ``stats`` None."""
    from repro_torch import tracing
    from repro_torch.core.collectives import DataAxis, all_reduce
    axis = DataAxis()
    x = torch.from_numpy(data[rank]).to(device)
    out = []
    for mode, kw in cases:
        runs = []
        for on in (True, False, True):
            if on:
                tracing.enable()
            stats = {}
            y = all_reduce(x, axis, mode=mode, stats=stats, **kw)
            tracing.disable()
            rec = tracing.drain()
            names = {s.index: s.name for s in rec["spans"]}
            runs.append({"y": y.numpy(), "stats": stats, "counters": rec["counters"],
                         "spans": [(s.name, names.get(s.parent)) for s in rec["spans"]],
                         "dropped": rec["dropped"]})
        plain = all_reduce(x, axis, mode=mode, **kw).numpy()
        out.append((runs, plain))
    return out
