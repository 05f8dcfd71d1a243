"""Kernel B6's share of its roofline (``rooflines/b6.py``)."""

from ._kernel_roofline import share


def read(ctx):
    return share(ctx, "b6")
