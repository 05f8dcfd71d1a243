"""Kernel B5's share of its roofline (``rooflines/b5.py``)."""

from ._kernel_roofline import share


def read(ctx):
    return share(ctx, "b5")
