"""The contraction-depth experiment's product (kernel X1 of the port).

Port of ``examples/mxu_experiment.py : make_bench``, the TPU's
microbenchmark of its matrix unit.  For s < S:

    o[s, 0, :] = sum_g colsum(A_g . B_g)

with ``B[s, g]`` (k, p) and ``A_g = A[s, g]`` (m, k) for order
``'lhs_k_lanes'``, or ``A_g = A[s, g]^T`` with ``A[s, g]`` (k, m) for
``'lhs_k_sublanes'`` (the contraction over A's first axis).  f32 in, f32
out (S, 1, p).

Precision mapping (the experiment's second variable):

* ``'default'`` is one bf16 pass of the TPU's matrix unit.  On the card:
  A and B rounded to bf16, one ``mma.sync.m16n8k16`` bf16 pass with an f32
  accumulator.
* ``'highest'`` is f32-accurate through several passes on the TPU.  On the
  card: 3xTF32, ``mma.sync.m16n8k8`` on the TF32 hi and lo parts
  (rounded to nearest, ties away, as ``cvt.rna.tf32.f32`` rounds),
  a_hi.b_hi + a_hi.b_lo + a_lo.b_hi.

Depth is the experiment's variable: the kernel pads k with zeros in
shared memory to the instruction's depth (``padded_depth``: 16 for bf16,
8 for TF32, so K = 24 runs 32 deep in bf16).  The padding applies inside
the kernel only; the plain version and the result do not see it.

The kernel (``csrc/contraction_depth.cu``) runs every one of the m x k x p
multiply-adds on the tensor cores, as the TPU kernel runs them on its
matrix unit: the algebraic shortcut ``(1^T A) . B``, a matrix-vector
product, gives the same numbers and measures nothing.  The plain version
here takes that shortcut: it is the reference for the numbers, not for the
work.

On a CUDA tensor ``contraction_depth`` launches the kernel (counted in
``LAUNCHES``) or raises; on a CPU tensor it runs
``contraction_depth_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_pic import _check
from .precision import f32_matmul

LAUNCHES = 0  # kernel launches by contraction_depth (CUDA tensors only)
ORDERS = ("lhs_k_lanes", "lhs_k_sublanes")
PRECISIONS = ("default", "highest")


def padded_depth(k: int, precision: str) -> int:
    """The depth the kernel runs a K-deep contraction at: k rounded up to
    the instruction's depth (16 for bf16 'default', 8 for TF32
    'highest')."""
    depth = 16 if precision == "default" else 8
    return -(-k // depth) * depth


def _validate(a, b, order, precision):
    if order not in ORDERS:
        raise ValueError(f"order {order!r} (one of {ORDERS})")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} (one of {PRECISIONS})")
    if a.dim() != 4 or b.dim() != 4:
        raise ValueError(f"a and b are (S, G, ., .); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    s, g, k, p = b.shape
    if order == "lhs_k_lanes":
        m = a.shape[2]
        want = (s, g, m, k)
    else:
        m = a.shape[3]
        want = (s, g, k, m)
    if tuple(a.shape) != want:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected {want} "
                         f"for order {order!r} and b {tuple(b.shape)}")
    return s, g, m, k, p


def contraction_depth_plain(a: torch.Tensor, b: torch.Tensor, order: str,
                            precision: str) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``'default'`` rounds A and B
    to bf16 first, then both precisions compute in f32 with TF32 off, by
    the shortcut sum_g (1^T A_g) . B_g.  Returns (S, 1, p) f32."""
    s, _, _, _, p = _validate(a, b, order, precision)
    if precision == "default":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    colsum = a.sum(dim=-2 if order == "lhs_k_lanes" else -1)     # (S, G, k)
    with f32_matmul():
        out = torch.einsum("sgk,sgkp->sp", colsum, b)
    return out.reshape(s, 1, p)


def _library():
    from . import _build

    lib = _build.load("contraction_depth")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.contraction_depth.argtypes = [p] * 3 + [i] * 7 + [p]
        lib.contraction_depth.restype = i
        lib.contraction_depth_smem.argtypes = [i] * 4
        lib.contraction_depth_smem.restype = ctypes.c_longlong
        lib.contraction_depth_error_string.argtypes = [i]
        lib.contraction_depth_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(a, b, order, precision, s, g, m, k, p):
    global LAUNCHES
    dev = b.device
    f32 = torch.float32
    _check("a", a, f32, tuple(a.shape), dev, align=16)
    _check("b", b, f32, (s, g, k, p), dev, align=16)
    # the kernel copies rows of A and B in 16-byte pieces: A's rows are k
    # long (lhs_k_lanes) or m long (lhs_k_sublanes), B's p long
    row = "k" if order == "lhs_k_lanes" else "m"
    if (k if row == "k" else m) % 4 or p % 4:
        raise ValueError(f"the kernel needs {row} and p multiples of 4; got "
                         f"m={m}, k={k}, p={p}")
    if m * k >= 2 ** 31 or s * -(-p // 256) >= 2 ** 31:
        raise ValueError("the kernel indexes a tile of A and its grid with "
                         "32-bit ints")
    bf16, sublanes = int(precision == "default"), int(order != "lhs_k_lanes")
    lib = _library()
    smem = lib.contraction_depth_smem(m, k, bf16, sublanes)
    if smem > 232448:
        raise ValueError(f"m={m}, k={k} need {smem} bytes of shared memory "
                         f"a block, more than the card's 232448")
    out = torch.empty((s, 1, p), dtype=f32, device=dev)
    err = lib.contraction_depth(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), s, g, m, k, p, bf16,
        sublanes, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("contraction_depth launch failed: "
                           + lib.contraction_depth_error_string(err).decode())
    LAUNCHES += 1
    return out


def contraction_depth(a: torch.Tensor, b: torch.Tensor, order: str,
                      precision: str) -> torch.Tensor:
    """``o[s, 0, :] = sum_g colsum(A_g . B_g)`` for ``a`` (S, G, m, k)
    (order 'lhs_k_lanes') or (S, G, k, m) ('lhs_k_sublanes'), ``b``
    (S, G, k, p), f32; ``precision`` 'default' (bf16) or 'highest'
    (3xTF32).  Returns (S, 1, p) f32.

    A CUDA ``b`` launches the Hopper kernel (or raises); a CPU one runs
    ``contraction_depth_plain``."""
    s, g, m, k, p = _validate(a, b, order, precision)
    if b.device.type == "cpu":
        return contraction_depth_plain(a, b, order, precision)
    return _launch(a, b, order, precision, s, g, m, k, p)
