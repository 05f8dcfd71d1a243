"""The one place that maps the reference's matmul-precision names onto the
card (counterpart of ``fusion_sim_tpu/ops/mxu.py``).

The JAX package names a matmul strategy per kernel: ``pallas_precision``
('highest', 'exact_bf16', 'exact_bf16_pack', 'exact_bf16_pack2',
'default'), ``ESConfig.solver_precision`` and ``Tiling2D.dtype``
('float32' | 'bfloat16').  Those hi/lo bf16 splits and packed matmuls
were only the TPU's route to f32 accuracy on its bf16 matrix unit.  The
port's kernels gather and deposit with plain f32 arithmetic on the CUDA
cores (no tensor-core matmul is involved), so every name maps to float32:
the names are accepted so configurations carry over unchanged, and they
change nothing in the result.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("highest", "exact_bf16", "exact_bf16_pack", "exact_bf16_pack2",
              "default")
TILING_DTYPES = ("float32", "bfloat16")


def resolve_precision(name: str | None = None,
                      tiling_dtype: str = "float32") -> torch.dtype:
    """Validate a precision name (None follows ``tiling_dtype``) and
    return the dtype the port computes in: always float32."""
    if name is not None and name not in PRECISIONS:
        raise ValueError(f"precision {name!r} (one of {PRECISIONS})")
    if tiling_dtype not in TILING_DTYPES:
        raise ValueError(f"tiling dtype {tiling_dtype!r} "
                         f"(one of {TILING_DTYPES})")
    return torch.float32


@contextlib.contextmanager
def f32_matmul():
    """f32 products with TF32 off (the card's matmul flag, restored after).

    The flag is global to the process: callers that share the card between
    threads hold their own lock around the scope."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
