"""The 2D3V node table in one launch.

``node_table_2d(e, b)`` averages the packed (X, Y, 3) Yee E and B to the
nodes: the (X, Y, 6) table (Ex, Ey, Ez, Bx, By, Bz) that the 2D EM shells'
centered gathers and kernel B4 read.  On CUDA tensors it launches the
hand-written kernel ``csrc/node_table2d.cu`` (counted in ``LAUNCHES``; each
launch adds 1 to the ``table_fused`` counter of ``utils/profiling`` while a
profiler records, as the 3D kernel's do), which reads E and B once and
writes the table once; on CPU tensors it runs ``node_table_2d_plain``, the
rolls and averages of ``ops/fdtd.center_fields``, which the kernel equals
bit for bit on the card.  The wrapper allocates the table and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import fdtd

LAUNCHES = 0  # launches of the node_table2d kernel (CUDA tensors only)


def node_table_2d_plain(e, b):
    """The (X, Y, 6) node table: ``fdtd.center_fields`` with the 2D Yee
    offsets."""
    return fdtd.center_fields(e, b, fdtd.E_OFFSETS_2D, fdtd.B_OFFSETS_2D)


def _library():
    from . import _build

    lib = _build.load("node_table2d")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.node_table2d.argtypes = [p] * 3 + [i] * 2 + [p]
        lib.node_table2d.restype = i
        lib.node_table2d_error_string.argtypes = [i]
        lib.node_table2d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(e, b) -> None:
    if e.dim() != 3 or e.shape[-1] != 3:
        raise ValueError(f"e must be (X, Y, 3), got {tuple(e.shape)}")
    for name, t in (("e", e), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.shape != e.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, e {tuple(e.shape)}")
    if b.device != e.device:
        raise ValueError(f"b is on {b.device}, e on {e.device}")
    if e.shape[0] * e.shape[1] * 6 >= 2 ** 31:
        raise ValueError(f"the kernel indexes the table with 32-bit ints: "
                         f"{tuple(e.shape)}")


def node_table_2d(e, b):
    """The (X, Y, 6) node table of the 2D3V Yee E and B: the kernel on CUDA
    tensors, ``node_table_2d_plain`` on CPU tensors."""
    global LAUNCHES
    _check(e, b)
    if e.device.type == "cpu":
        return node_table_2d_plain(e, b)
    if e.device.type != "cuda":
        raise ValueError(f"no node table kernel for device {e.device}")
    lib = _library()
    table = torch.empty((*e.shape[:2], 6), dtype=torch.float32,
                        device=e.device)
    err = lib.node_table2d(e.data_ptr(), b.data_ptr(), table.data_ptr(),
                           *e.shape[:2],
                           torch.cuda.current_stream(e.device).cuda_stream)
    if err:
        raise RuntimeError("node_table2d launch failed: "
                           + lib.node_table2d_error_string(err).decode())
    LAUNCHES += 1
    count("table_fused", 1)
    return table
