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
    warmup/total steps and a list of (first step, sync, CommConfig kwargs)
    phases.  Returns the
    losses and rank 0's final params as numpy arrays (by path)."""
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
    axis = DataAxis()
    phases = [(start, make_train_step(cfg, AdamWConfig(lr=spec["lr"]), sync=sync,
                                      comm=CommConfig(**comm) if comm else None,
                                      axis=axis, warmup_steps=spec["warmup"],
                                      total_steps=spec["total"]))
              for start, sync, comm in spec["phases"]]
    lb = spec["batch"] // world
    losses = []
    for i in range(spec["steps"]):
        step = [fn for start, fn in phases if start <= i][-1]
        b = make_batch(cfg, seq_len=spec["seq_len"], batch_size=spec["batch"],
                       step=i % spec["cycle"])
        batch = {k: torch.from_numpy(v[rank * lb:(rank + 1) * lb]) for k, v in b.items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    flat = {"/".join(p): t.detach().numpy() for p, t in leaves_with_path(state.params)}
    return {"losses": losses, "params": flat if rank == 0 else None}


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
