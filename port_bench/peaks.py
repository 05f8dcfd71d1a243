"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3; NVIDIA's data
sheet, dense rates at the 700 W limit).  A card set to a lower
``power.limit`` reaches less; the benchmark reports shares against these
figures and the card's limit beside them."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores


def least_seconds(n_bytes: float, flops: float) -> float:
    """The least time of a piece of work: the larger of its bytes over the
    memory rate and its f32 operations over the f32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
