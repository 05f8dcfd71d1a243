"""Kernel B1's share of its roofline (``rooflines/b1.py``)."""

from ._kernel_roofline import share


def read(ctx):
    return share(ctx, "b1")
