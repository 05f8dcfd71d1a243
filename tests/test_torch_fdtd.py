"""Port vs reference: the Yee FDTD ops (ops/fdtd.py), same numpy inputs
through both packages on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fdtd as tf
from fusion_sim_tpu.ops import fdtd as jf

# rolls, differences and one division in f32 on both sides: 1e-6 relative
# to the field scale (XLA may contract a*b + c into one FMA on the CPU)
RTOL = 1e-6


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*shape, 3)).astype(np.float32),
            rng.standard_normal((*shape, 3)).astype(np.float32))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=RTOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("name,shape,dx", [
    ("curl_e_2d", (16, 24), (0.5, 0.7)),
    ("curl_b_2d", (16, 24), (0.5, 0.7)),
    ("curl_e_3d", (8, 6, 10), (0.5, 0.7, 0.9)),
    ("curl_b_3d", (8, 6, 10), (0.5, 0.7, 0.9)),
    ("curl_e", (16, 24), (0.5, 0.7)),
    ("curl_b", (8, 6, 10), (0.5, 0.7, 0.9)),
])
def test_curls_match_reference(name, shape, dx):
    e, _ = _fields(shape, 1)
    _close(getattr(tf, name)(torch.tensor(e), dx),
           getattr(jf, name)(jnp.asarray(e), dx))


@pytest.mark.parametrize("shape,dx", [((16, 24), (0.5, 0.7)),
                                      ((8, 6, 10), (0.5, 0.7, 0.9))])
def test_advance_matches_reference(shape, dx):
    e, b = _fields(shape, 2)
    j = _fields(shape, 3)[0]
    _close(tf.advance_b_half(torch.tensor(b), torch.tensor(e), 0.1, dx),
           jf.advance_b_half(jnp.asarray(b), jnp.asarray(e), 0.1, dx))
    _close(tf.advance_e_full(torch.tensor(e), torch.tensor(b),
                             torch.tensor(j), 0.1, dx, c=1.5, eps0=0.8),
           jf.advance_e_full(jnp.asarray(e), jnp.asarray(b), jnp.asarray(j),
                             0.1, dx, c=1.5, eps0=0.8))


def test_offset_tables_match_reference():
    for name in ("E_OFFSETS_2D", "B_OFFSETS_2D", "E_OFFSETS_3D",
                 "B_OFFSETS_3D"):
        assert getattr(tf, name) == getattr(jf, name)


@pytest.mark.parametrize("dim", [2, 3])
def test_center_fields_matches_reference(dim):
    shape = (16, 24) if dim == 2 else (8, 6, 10)
    e, b = _fields(shape, 4)
    offs = [getattr(tf, f"{f}_OFFSETS_{dim}D") for f in "EB"]
    got = tf.center_fields(torch.tensor(e), torch.tensor(b), *offs)
    assert got.shape == (*shape, 6) and got.is_contiguous()
    _close(got, jf.center_fields(jnp.asarray(e), jnp.asarray(b), *offs))


@pytest.mark.parametrize("dim", [2, 3])
def test_gather_staggered_matches_reference(dim):
    shape = (16, 24) if dim == 2 else (8, 6, 10)
    e, _ = _fields(shape, 5)
    rng = np.random.default_rng(6)
    pos = (rng.random((500, dim)) * np.array(shape)).astype(np.float32)
    offs = getattr(tf, f"B_OFFSETS_{dim}D")
    _close(tf.gather_staggered(torch.tensor(e), torch.tensor(pos), offs,
                               shape),
           jf.gather_staggered(jnp.asarray(e), jnp.asarray(pos), offs,
                               shape))


def test_vacuum_wave_keeps_energy():
    """A plane wave advanced by the port's leapfrog keeps its energy: the
    update order (B half, E full, B half) is the reference's."""
    n, d, dt = 64, 0.5, 0.2
    x = np.arange(n) * d
    e = np.zeros((n, n, 3), np.float32)
    b = np.zeros((n, n, 3), np.float32)
    e[..., 1] = np.sin(2 * np.pi * x / (n * d))[:, None]
    b[..., 2] = np.sin(2 * np.pi * (x + d / 2) / (n * d))[:, None]
    e, b = torch.tensor(e), torch.tensor(b)
    j = torch.zeros_like(e)
    e0 = float((e ** 2).sum() + (b ** 2).sum())
    for _ in range(50):
        bh = tf.advance_b_half(b, e, dt, (d, d))
        e = tf.advance_e_full(e, bh, j, dt, (d, d))
        b = tf.advance_b_half(bh, e, dt, (d, d))
    assert abs(float((e ** 2).sum() + (b ** 2).sum()) - e0) < 1e-3 * e0
