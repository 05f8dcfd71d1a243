"""Port vs reference: the contraction-depth experiment (X1).

The port's plain version against ``examples/mxu_experiment.make_bench``,
whose Pallas kernel runs in interpret mode on the CPU, on the reference's
own inputs."""

import numpy as np
import pytest
import torch

from examples import mxu_experiment as jmx
from fusion_sim_torch.examples import mxu_experiment as tmx
from fusion_sim_torch.ops import contraction_depth as cd

SMALL = dict(m=8, p=128, n_g=4, nsteps=3)


def _abs_bound(a, b, order):
    """sum_g sum_i sum_k |A_g[i, k]| |B_g[k, j]| per output, in float64."""
    a, b = np.abs(np.asarray(a, np.float64)), np.abs(np.asarray(b, np.float64))
    colsum = a.sum(axis=2 if order == "lhs_k_lanes" else 3)
    return np.einsum("sgk,sgkp->sp", colsum, b)[:, None, :]


@pytest.mark.parametrize("k", [24, 128])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("order", ["lhs_k_lanes", "lhs_k_sublanes"])
def test_plain_matches_pallas_kernel(order, precision, k):
    """'highest': both f32, held at 1e-5 of max|ref|.  'default': the port
    rounds A and B to bf16 (the TPU's one bf16 pass) while JAX on the CPU
    computes 'default' in f32, so they are held at the bf16 rounding bound,
    2^-8 of sum |a||b| per output."""
    fn, a, b = jmx.make_bench(SMALL["m"], k, SMALL["p"], SMALL["n_g"],
                              SMALL["nsteps"], order, precision)
    ref = np.asarray(fn(a, b))
    got = cd.contraction_depth(torch.tensor(np.asarray(a)),
                               torch.tensor(np.asarray(b)), order, precision)
    assert got.shape == ref.shape == (SMALL["nsteps"], 1, SMALL["p"])
    err = np.abs(got.numpy() - ref)
    if precision == "highest":
        assert err.max() <= 1e-5 * np.abs(ref).max()
    else:
        assert (err <= 2.0 ** -8 * _abs_bound(a, b, order)).all()
        assert err.max() > 0          # the bf16 rounding is really applied


def test_padded_depth_and_validation():
    assert [cd.padded_depth(k, "default") for k in tmx.DEPTHS] == \
        [32, 32, 48, 96, 128]
    assert [cd.padded_depth(k, "highest") for k in tmx.DEPTHS] == \
        [24, 32, 48, 96, 128]
    a = torch.zeros((2, 3, 8, 24))
    b = torch.zeros((2, 3, 24, 16))
    with pytest.raises(ValueError, match="order"):
        cd.contraction_depth(a, b, "lanes", "highest")
    with pytest.raises(ValueError, match="precision"):
        cd.contraction_depth(a, b, "lhs_k_lanes", "tf32")
    with pytest.raises(ValueError, match="expected"):
        cd.contraction_depth(a, b, "lhs_k_sublanes", "highest")
    out = cd.contraction_depth(a.transpose(2, 3), b, "lhs_k_sublanes",
                               "default")
    assert out.shape == (2, 1, 16) and not out.any()


def test_example_runs_on_the_cpu(capsys):
    """The port's experiment script end to end on the plain version: the
    reference's lines, one per order, precision and K."""
    tmx.main(["--device", "cpu", "--m", "16", "--p", "128", "--n-g", "2",
              "--nsteps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("dev=cpu  m=16 p=128 blocks=4")
    assert len(lines) == 1 + 2 * 2 * 5
    assert lines[1].startswith("lhs_k_lanes      default  K= 24:")
    assert all("G rows/s" in ln for ln in lines[1:])
    fn, a, b = tmx.make_bench(16, 24, 128, 2, 2, "lhs_k_sublanes", "highest",
                              device="cpu")
    assert a.shape == (2, 2, 24, 16) and b.shape == (2, 2, 24, 128)
    np.testing.assert_allclose(
        fn(a, b).numpy(),
        np.einsum("sgkm,sgkp->sp", a.double().numpy(),
                  b.double().numpy())[:, None], rtol=1e-5, atol=1e-4)
