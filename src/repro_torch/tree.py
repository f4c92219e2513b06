"""Pytree helpers for the port's nested parameter containers.

Parameters, gradients and optimizer state are nested dicts, tuples and lists
of tensors, as the JAX package's pytrees are.  These helpers walk them in
JAX's order (dict keys sorted, sequences by index, dataclass fields in
declaration order) and name each leaf by its path the way the JAX package's
checkpoints do: dict keys as themselves, sequence positions as ``#i``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator


def leaves_with_path(tree: Any, prefix: tuple[str, ...] = ()
                     ) -> Iterator[tuple[tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (f"#{i}",))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_path(getattr(tree, f.name), prefix + (f.name,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in :func:`leaves_with_path`'s order; dicts, tuples and lists
    keep their structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template: Any, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), template)
