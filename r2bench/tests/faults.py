"""Faults planted under the timed path: each must turn ``correct`` false.
A training fault wraps the step (``fault(step, build)``, ``build`` makes a
step of the program with other arguments); a serving fault rewrites the
tokens a batch produced.  A ``late_`` fault starts after the first
:data:`LATE` calls of the rank's steps: past every step the set-up check
follows (and, in a failure cell, the failing step), so only the check after
the window can see it."""

import sys
import types

import torch

from r2bench.weights import flatten

LATE = 4
_calls = [0]


def state_unchanged(step, build):
    """A step that returns its state unchanged."""
    def f(state, batch, stats=None):
        keep = [t.detach().clone() for t in _state_leaves(state)]
        new, met = step(state, batch, stats=stats)
        with torch.no_grad():
            for t, k in zip(_state_leaves(new), keep):
                t.copy_(k)
        return new, met
    return f


def half_batch(step, build):
    """Half of the rank's rows left out, the mean taken over the rest."""
    def f(state, batch, stats=None):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, stats=stats)
    return f


def no_exchange(step, build):
    """The exchange between ranks left out: each rank steps on its own
    gradient."""
    return build(sync="xla", axes=())


def _late(fault):
    def planted(step, build):
        bad = fault(step, build)

        def f(state, batch, stats=None):
            _calls[0] += 1
            return (bad if _calls[0] > LATE else step)(state, batch, stats=stats)
        return f
    planted.__doc__ = f"{fault.__name__}, from the rank's call {LATE + 1} on."
    return planted


late_state_unchanged = _late(state_unchanged)
late_half_batch = _late(half_batch)
late_no_exchange = _late(no_exchange)


def tf32_products(step, build):
    """The step's float32 products in TF32."""
    def f(state, batch, stats=None):
        torch.set_float32_matmul_precision("high")
        return step(state, batch, stats=stats)
    return f


def jax_package_loaded(step, build):
    """A module of the JAX package in the rank's process."""
    sys.modules.setdefault("repro.planted", types.ModuleType("repro.planted"))
    return step


def tf32_serving(tokens):
    """The serving process's float32 products switched to TF32 (the tokens
    are left as they are)."""
    torch.set_float32_matmul_precision("high")
    return tokens


def token_altered(tokens):
    """The second token of every request altered where it is produced."""
    return [[t ^ 1 if i == 1 else t for i, t in enumerate(toks)] for toks in tokens]


def _state_leaves(state):
    return (list(flatten(state.params).values()) + list(flatten(state.opt_state["mu"]).values())
            + list(flatten(state.opt_state["nu"]).values()))
