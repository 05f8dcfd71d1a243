"""Port vs reference: public names of same-named modules — the CODATA
constants, ``config.validate_dataclass``, ``ops/rng.step_uniforms`` and
``utils/debug.checked(fn, errors=...)``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from fusion_sim_torch import config as tcfg
from fusion_sim_torch import constants as tconst
from fusion_sim_torch.ops import rng as trng
from fusion_sim_torch.utils import debug as tdbg
from fusion_sim_tpu import config as jcfg
from fusion_sim_tpu import constants as jconst
from fusion_sim_tpu.ops import rng as jrng
from fusion_sim_tpu.utils import debug as jdbg

CODATA = ("C_EXACT", "MU0_EXACT", "EPS0", "ELEMENTARY_CHARGE",
          "ELECTRON_MASS", "PROTON_MASS", "BOLTZMANN")


@pytest.mark.parametrize("name", CODATA + ("SPEED_OF_LIGHT", "MU_0", "PI"))
def test_constants_match_reference(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def _spec_dataclass(cfg):
    @dataclasses.dataclass
    class Spec:
        n: int = dataclasses.field(metadata={"spec": "number"})
        name: str = dataclasses.field(metadata={"spec": "string"})
        note: object = dataclasses.field(
            default=None, metadata={"spec": cfg.Optional("string")})
        free: object = None
    return Spec


@pytest.mark.parametrize("kwargs", [
    dict(n=3, name="a"), dict(n=3, name="a", note="b"),
    dict(n=3, name="a", free=object()), dict(n="x", name="a"),
    dict(n=3, name=4), dict(n=3, name="a", note=5)])
def test_validate_dataclass_matches_reference(kwargs):
    """The same instances pass or fail in both, with the same message."""
    outcome = []
    for cfg in (jcfg, tcfg):
        try:
            cfg.validate_dataclass(_spec_dataclass(cfg)(**kwargs))
            outcome.append(None)
        except cfg.SpecError as exc:
            outcome.append(str(exc))
    assert outcome[0] == outcome[1]


def test_step_uniforms_match_in_distribution():
    """Torch's Philox cannot replay threefry: the same (2, N, 4) shape,
    dtype and range, and the same distribution per half-step and column
    (two-sample KS distance at 5e4 draws: below 0.015 fails with
    probability ~1e-4 under equality)."""
    n = 50_000
    got = trng.step_uniforms(torch.Generator().manual_seed(0), n, "cpu")
    ref = np.asarray(jrng.step_uniforms(jax.random.key(0), n)[0])
    assert got.shape == ref.shape == (2, n, 4)
    assert got.dtype == torch.float32
    g = got.numpy()
    assert g.min() >= 0.0 and g.max() < 1.0
    grid = np.linspace(0, 1, 201)
    for h in range(2):
        for c in range(4):
            cdf_g = np.searchsorted(np.sort(g[h, :, c]), grid) / n
            cdf_r = np.searchsorted(np.sort(ref[h, :, c]), grid) / n
            assert np.abs(cdf_g - cdf_r).max() < 0.015
    # the two half-steps are different draws, and the stream replays
    assert not np.array_equal(g[0], g[1])
    again = trng.step_uniforms(torch.Generator().manual_seed(0), n, "cpu")
    assert torch.equal(got, again)


@pytest.mark.parametrize("which", ["default", "float", "nan", "index",
                                   "div"])
def test_checked_errors_match_reference(which):
    """``errors=`` picks whether a NaN is reported, as checkify's sets do:
    the default and the float and NaN sets report it, the index and
    division sets alone do not (the division set checks integer division
    by zero in checkify, and nothing in the port)."""
    sets = {"default": (None, None),
            "float": (checkify.float_checks, tdbg.float_checks),
            "nan": (checkify.nan_checks, tdbg.nan_checks),
            "index": (checkify.index_checks, tdbg.index_checks),
            "div": (checkify.div_checks, tdbg.div_checks)}
    j_err, t_err = sets[which]
    err_j, out_j = jdbg.checked(lambda x: jnp.log(x) * 2.0, j_err)(
        jnp.float32(-1.0))
    err_t, out_t = tdbg.checked(lambda x: torch.log(x) * 2.0, t_err)(
        torch.tensor(-1.0))
    assert np.isnan(float(out_j)) and torch.isnan(out_t)
    assert (err_j.get() is None) == (err_t.get() is None)
    if err_t.get() is not None:
        with pytest.raises(FloatingPointError):
            err_t.throw()
    # a clean call reports nothing under any set
    err_t, out_t = tdbg.checked(lambda x: torch.log(x), t_err)(
        torch.tensor(1.0))
    assert err_t.get() is None and float(out_t) == 0.0


def test_checked_rejects_unknown_check_names():
    with pytest.raises(ValueError, match="unknown error checks"):
        tdbg.checked(lambda x: x, {"nan", "bogus"})
