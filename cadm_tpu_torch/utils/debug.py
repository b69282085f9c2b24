"""Non-finite guards (counterpart of cadm_tpu/utils/debug.py).

What can go wrong silently on the card is NaN/Inf propagating through the
physics or the learned model. ``assert_finite`` raises with the path of the
offending leaf; ``checked`` wraps a function so that a non-finite float
output raises. Unlike the reference's ``checkify``, which checks every
intermediate of a jitted function, ``checked`` checks only the outputs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Tuple

import torch


def leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf of a tree of dataclasses, dicts, lists
    and tuples, e.g. ``.params['fwd'][0]['w']``."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves_with_path(getattr(tree, f.name),
                                        f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree: Any, where: str = "") -> None:
    """Raise ``FloatingPointError`` naming the first floating-point tensor
    leaf of ``tree`` (dataclasses, dicts, lists, tuples) that holds a NaN
    or an Inf. Reads the values back, so it waits for the device."""
    for path, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(
                f"non-finite values at {path or '<root>'} {where}".rstrip())


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped so that a non-finite float output raises
    ``FloatingPointError`` naming the output's path. Checks the outputs
    only, not the intermediates (the reference's checkify does both)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, f"in the output of {getattr(fn, '__name__', fn)}")
        return out

    return wrapper
