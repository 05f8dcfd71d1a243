"""The 3D Yee leapfrog in one launch.

``yee_update_3d(e, b, j, dt, cell_size, c, eps0)`` advances the packed
(X, Y, Z, 3) Yee fields one step: B half step, E full step with J, B half
step.  On CUDA tensors it launches the hand-written kernel
``csrc/yee3d.cu`` (counted in ``LAUNCHES``; each launch adds 1 to the
``yee_fused`` counter of ``utils/profiling`` while a profiler records),
which keeps the half-step B and the new E in shared memory and reads E, B
and J once; on CPU tensors it runs ``yee_update_3d_plain``, the rolls and
differences of ``ops/fdtd.py``, which the kernel equals bit for bit on the
card.  The wrapper allocates the two results and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import fdtd

LAUNCHES = 0  # launches of the yee3d kernel (CUDA tensors only)


def yee_update_3d_plain(e, b, j, dt: float, cell_size, c: float = 1.0,
                        eps0: float = 1.0):
    """``(e_new, b_new)``: ``fdtd.advance_b_half``, ``advance_e_full``,
    ``advance_b_half``; on a grid of any rank."""
    b_half = fdtd.advance_b_half(b, e, dt, cell_size)
    e_new = fdtd.advance_e_full(e, b_half, j, dt, cell_size, c=c, eps0=eps0)
    return e_new, fdtd.advance_b_half(b_half, e_new, dt, cell_size)


def _library():
    from . import _build

    lib = _build.load("yee3d")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.yee3d_update.argtypes = [p] * 5 + [i] * 3 + [d] * 6 + [p]
        lib.yee3d_update.restype = i
        lib.yee3d_error_string.argtypes = [i]
        lib.yee3d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(e, b, j, cell_size) -> None:
    if len(cell_size) != 3:
        raise ValueError(f"cell_size must have 3 entries, got {cell_size}")
    if e.dim() != 4 or e.shape[-1] != 3:
        raise ValueError(f"e must be (X, Y, Z, 3), got {tuple(e.shape)}")
    for name, t in (("e", e), ("b", b), ("j", j)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != e.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, e "
                             f"{tuple(e.shape)}")
        if t.device != e.device:
            raise ValueError(f"{name} is on {t.device}, e on {e.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if e.shape[1] * e.shape[2] * 3 >= 2 ** 31:
        raise ValueError(f"the kernel indexes a plane with 32-bit ints: "
                         f"{tuple(e.shape)}")


def yee_update_3d(e, b, j, dt: float, cell_size, c: float = 1.0,
                  eps0: float = 1.0):
    """``(e_new, b_new)`` of one leapfrog step on the 3D Yee grid: the
    kernel on CUDA tensors, ``yee_update_3d_plain`` on CPU tensors."""
    global LAUNCHES
    _check(e, b, j, cell_size)
    if e.device.type == "cpu":
        return yee_update_3d_plain(e, b, j, dt, cell_size, c, eps0)
    if e.device.type != "cuda":
        raise ValueError(f"no Yee kernel for device {e.device}")
    lib = _library()
    e_new, b_new = torch.empty_like(e), torch.empty_like(b)
    nx, ny, nz = e.shape[:3]
    err = lib.yee3d_update(
        e.data_ptr(), b.data_ptr(), j.data_ptr(), e_new.data_ptr(),
        b_new.data_ptr(), nx, ny, nz, float(dt), *map(float, cell_size),
        float(c), float(eps0), torch.cuda.current_stream(e.device).cuda_stream)
    if err:
        raise RuntimeError("yee3d launch failed: "
                           + lib.yee3d_error_string(err).decode())
    LAUNCHES += 1
    count("yee_fused", 1)
    return e_new, b_new
