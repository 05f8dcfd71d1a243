"""Kernel B4's share of its roofline (``rooflines/b4.py``)."""

from ._kernel_roofline import share


def read(ctx):
    return share(ctx, "b4")
