"""Kernel B2's share of its roofline (``rooflines/b2.py``), launch by
launch (two a step)."""

from ._kernel_roofline import share


def read(ctx):
    return share(ctx, "b2")
