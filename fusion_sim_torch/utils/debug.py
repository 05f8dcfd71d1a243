"""Numerical sanitizers (port of ``fusion_sim_tpu/utils/debug.py``).

What is worth guarding is numerics: NaN/Inf escapes from division edges
and f32 overflow.

* ``debug_nans()`` — a scope in which the first operation whose float
  output holds a NaN raises ``FloatingPointError`` naming the operation
  (the reference's ``jax_debug_nans``), through a ``TorchDispatchMode``.
* ``checked(fn, errors=None)`` — ``wrapped(*args) -> (err, out)``: ``fn``
  runs to its end, ``err`` names the first NaN-producing operation and
  ``err.throw()`` raises it (the reference's ``checkify`` wrapper).
  ``errors`` takes the names of checkify's sets (``nan_checks``,
  ``div_checks``, ``index_checks``, ``float_checks``, ``all_checks`` here);
  only the NaN check is carried out.  A division by zero gives an inf,
  which it does not see, and an out-of-bounds index raises in PyTorch
  itself.
* ``assert_finite(tree, name)`` — finiteness sweep of dicts, NamedTuples
  and sequences of tensors or arrays, naming the offending leaf's path.

The NaN checks read one flag to the host after every operation: they are
for debugging, not for timed runs.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def leaves_with_path(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs of a tree of dicts, NamedTuples, lists and
    tuples; paths are written as JAX's ``keystr`` writes them
    (``['key']``, ``.field``, ``[index]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _first_nan(func, out) -> str | None:
    for _, leaf in leaves_with_path(out):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and bool(torch.isnan(leaf).any())):
            return f"invalid value (nan) encountered in {func}"
    return None


class _NanMode(TorchDispatchMode):
    """Checks every operation's float outputs for NaN: raises at the first
    (``raise_first``) or records it in ``error``."""

    def __init__(self, raise_first: bool):
        super().__init__()
        self.raise_first = raise_first
        self.error: str | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.error is None:
            self.error = _first_nan(func, out)
            if self.error is not None and self.raise_first:
                raise FloatingPointError(self.error)
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Raise ``FloatingPointError`` at the first operation inside the scope
    whose float output holds a NaN; ``enabled=False`` checks nothing."""
    if not enabled:
        yield
        return
    with _NanMode(raise_first=True):
        yield


class CheckError:
    """The error value of a ``checked`` call (checkify's ``Error``)."""

    def __init__(self, message: str | None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


# checkify's error sets, by name
nan_checks = frozenset({"nan"})
div_checks = frozenset({"div"})
index_checks = frozenset({"index"})
user_checks = frozenset({"user"})
float_checks = nan_checks | div_checks
all_checks = float_checks | index_checks | user_checks


def checked(fn, errors=None):
    """Wrap ``fn``: ``wrapped(*args, **kwargs) -> (err, out)``; call
    ``err.throw()`` to raise on the first NaN an operation produced.

    ``errors`` (default ``float_checks | index_checks``, the reference's)
    is a set of the names above; the NaN check runs when it holds
    ``'nan'``, and the other names are accepted but check nothing."""
    errors = float_checks | index_checks if errors is None \
        else frozenset(errors)
    unknown = errors - all_checks
    if unknown:
        raise ValueError(f"unknown error checks {sorted(unknown)}")
    nan = "nan" in errors

    def wrapped(*args, **kwargs):
        if not nan:
            return CheckError(None), fn(*args, **kwargs)
        mode = _NanMode(raise_first=False)
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.error), out

    return wrapped


def assert_finite(tree, name: str = "state") -> None:
    """Raise ``FloatingPointError`` with the offending leaf's path if any
    float value in ``tree`` is not finite."""
    for path, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            bad = int((~torch.isfinite(leaf)).sum())
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.inexact):
                continue
            bad = int((~np.isfinite(arr)).sum())
        if bad:
            raise FloatingPointError(
                f"{name}{path}: {bad} non-finite values")
