"""Bit-exact comparison of the JAX package's framework-free objects with the
port's copies.

The two packages define their own classes, so ``==`` between a JAX report
and a port report is never true.  :func:`plain` turns either into plain data
that compares equal only when every field is equal to the bit: dataclasses
and other objects by class name and field, enums by value, floats by their
``float.hex()``, arrays by dtype, shape and bytes, telemetry's ring buffers
by the samples they hold.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import types

import numpy as np


def plain(obj, _stack=None):
    """``obj`` as nested tuples of plain values (see the module docstring).
    An object met again inside itself becomes ``("<cycle>", class name)``."""
    stack = set() if _stack is None else _stack
    if obj is None or isinstance(obj, (bool, str, bytes)):
        return obj
    if isinstance(obj, enum.Enum):
        return ("enum", type(obj).__name__, plain(obj.value, stack))
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return ("float", float(obj).hex())
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape,
                np.ascontiguousarray(obj).tobytes())
    if isinstance(obj, (types.FunctionType, types.MethodType, type)):
        return ("callable", getattr(obj, "__qualname__", repr(obj)))
    if isinstance(obj, np.random.Generator):
        return ("rng", repr(obj.bit_generator.state))
    if isinstance(obj, random.Random):
        return ("random", obj.getstate())
    if type(obj).__name__ == "Series":
        # telemetry's ring buffer: its retained window, not the unwritten
        # tail of its np.empty storage
        return ("Series", plain(obj.times()), plain(obj.values()), obj.dropped)
    if id(obj) in stack:
        return ("<cycle>", type(obj).__name__)
    stack.add(id(obj))
    try:
        if isinstance(obj, (list, tuple)):
            return (type(obj).__name__, tuple(plain(x, stack) for x in obj))
        if isinstance(obj, dict):
            return ("dict", tuple((plain(k, stack), plain(v, stack))
                                  for k, v in obj.items()))
        if isinstance(obj, (set, frozenset)):
            return ("set", tuple(sorted((plain(x, stack) for x in obj), key=repr)))
        if dataclasses.is_dataclass(obj):
            return (type(obj).__name__,
                    tuple((f.name, plain(getattr(obj, f.name), stack))
                          for f in dataclasses.fields(obj)))
        if hasattr(obj, "__dict__"):
            return (type(obj).__name__,
                    tuple((k, plain(v, stack)) for k, v in vars(obj).items()))
        slots = [n for c in type(obj).__mro__ for n in getattr(c, "__slots__", ())]
        if slots:
            return (type(obj).__name__,
                    tuple((n, plain(getattr(obj, n), stack)) for n in slots
                          if hasattr(obj, n)))
        raise TypeError(f"no plain form for {type(obj).__name__}")
    finally:
        stack.discard(id(obj))


def assert_same(ours, theirs, what=""):
    """``plain(ours) == plain(theirs)``; on failure, name the first path
    where they part."""
    a, b = plain(ours), plain(theirs)
    if a != b:
        raise AssertionError(f"{what}: port and JAX differ at {_first_diff(a, b)}")


def _first_diff(a, b, path="$"):
    if type(a) is not type(b) or not isinstance(a, tuple):
        return f"{path}: {str(a)[:200]} != {str(b)[:200]}"
    if len(a) != len(b):
        return f"{path}: lengths {len(a)} != {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            label = x[0] if isinstance(x, tuple) and x and isinstance(x[0], str) else i
            return _first_diff(x, y, f"{path}/{label}")
    return path
