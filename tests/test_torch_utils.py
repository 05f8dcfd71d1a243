"""Port vs reference: the utils layer (fusion_sim_torch/utils/: colormaps,
render.frame_to_uint8, figure, diagnostics, png, checkpoint, debug,
profiling, stepping), modelled on tests/test_utils.py."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.utils import checkpoint as tck
from fusion_sim_torch.utils import colormaps as tcm
from fusion_sim_torch.utils import diagnostics as tdg
from fusion_sim_torch.utils import figure as tfig
from fusion_sim_torch.utils import png as tpng
from fusion_sim_torch.utils import render as trn
from fusion_sim_torch.utils import stepping as tst
from fusion_sim_torch.utils.debug import assert_finite, checked, debug_nans
from fusion_sim_torch.utils.profiling import Timer, sync, trace
from fusion_sim_tpu.utils import colormaps as jcm
from fusion_sim_tpu.utils import diagnostics as jdg
from fusion_sim_tpu.utils import figure as jfig
from fusion_sim_tpu.utils import png as jpng
from fusion_sim_tpu.utils import render as jrn
from fusion_sim_tpu.utils import stepping as jst


@pytest.mark.parametrize("name", sorted(jcm.PRESETS))
def test_preset_lut_matches_reference(name):
    assert tcm.PRESETS[name] == jcm.PRESETS[name]
    got, ref = tcm.preset(name), jcm.preset(name)
    assert got.lut.dtype == np.uint8 and got.lut.shape == (256, 3)
    np.testing.assert_array_equal(got.lut, ref.lut)
    np.testing.assert_array_equal(tcm.preset(name, -1.0, 3.0, 17).lut,
                                  jcm.preset(name, -1.0, 3.0, 17).lut)


def test_range_and_preset_errors():
    assert len(tcm.PRESETS) == 25
    r = tcm.Range(min=2.0, max=4.0)
    assert r.norm(2.0) == 0.0 and r.norm(4.0) == 1.0 and r.norm(3.0) == 0.5
    assert r.norm(0.0) == 0.0 and r.norm(10.0) == 1.0
    np.testing.assert_array_equal(
        r.norm_device(torch.tensor([0.0, 3.0, 10.0])).numpy(), [0, 0.5, 1])
    with pytest.raises(KeyError, match="unknown colormap"):
        tcm.preset("nope")
    cm = tcm.preset("gray", 0, 1, 256)
    np.testing.assert_array_equal(cm.rgb(0.0), [0, 0, 0])
    np.testing.assert_array_equal(cm.rgb(np.linspace(0, 1, 7)),
                                  jcm.preset("gray").rgb(np.linspace(0, 1, 7)))


def test_colormap_apply_matches_reference():
    """The same uint8 RGB, bit for bit, from a tensor and from a numpy
    field (f64 taken as f32, as the reference takes it)."""
    f = np.random.default_rng(3).standard_normal((24, 40)).astype(np.float32)
    for name, lo, hi, n in (("hot", -1.0, 2.5, 64), ("jet", -3, 3, 256),
                            ("doppler", -0.7, 0.7, 256)):
        ref = np.asarray(jcm.preset(name, lo, hi, n).apply(jnp.asarray(f)))
        cm = tcm.preset(name, lo, hi, n)
        got = cm.apply(torch.tensor(f))
        assert got.dtype == torch.uint8 and got.shape == (24, 40, 3)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(cm.apply(f.astype(np.float64)).numpy(),
                                      ref)


def test_frame_to_uint8_matches_reference():
    f = np.random.default_rng(4).uniform(-0.5, 1.5, (16, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jrn.frame_to_uint8(jnp.asarray(f)))
    got = trn.frame_to_uint8(torch.tensor(f))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (32, 16, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def _figures(fig_mod, cm_mod):
    cm = cm_mod.preset("gray", 0, 1)
    field = np.linspace(0, 1, 30 * 20).reshape(30, 20)
    fig = fig_mod.CanvasFigure(40, 30, background=(10, 10, 10))
    fig.add_layer(fig_mod.Plot2DArea(0, 0, 20, 30, cm, field))
    fig.add_layer(fig_mod.Plot2DArea(20, 5, 4, 6, cm_mod.preset("jet"),
                                     lambda: field[:12, :9]))
    fig.add_layer(fig_mod.ColorBar(25, 0, 5, 30, cm))
    return fig


def test_figure_compositing_and_click_match_reference():
    canvas = _figures(tfig, tcm).redraw()
    np.testing.assert_array_equal(canvas, _figures(jfig, jcm).redraw())
    assert canvas.shape == (30, 40, 3)
    assert (canvas[:, 24:25] == 10).all()          # gap keeps background
    assert canvas[0, 26, 0] > canvas[-1, 26, 0]    # colorbar top = max

    fig = tfig.CanvasFigure(40, 30)
    a = tfig.ClickArea(0, 0, 10, 10, "a")
    b = tfig.ClickArea(20, 0, 10, 10, "b")
    fig.add_click_area(a).add_click_area(b)
    assert fig.click(5, 5) == [a]
    assert set(fig.click(25, 5, ctrl=True)) == {a, b}   # ctrl adds
    assert fig.click(25, 5) == [b]                      # plain click exclusive
    assert fig.click(5, 5, ctrl=True) == [a, b]
    assert fig.click(5, 5, ctrl=True) == [b]            # ctrl toggles off
    assert fig.click(15, 15, ctrl=True) == [b]          # ctrl miss keeps
    assert fig.click(15, 15) == []                      # miss clears


def test_image_click_area_mask():
    mask = np.zeros((10, 10), np.float32)
    mask[2:5, 2:5] = 1.0
    area = tfig.ImageClickArea(0, 0, 10, 10, "img", mask=mask)
    assert area.contains(3, 3)
    assert not area.contains(8, 8)
    assert not area.contains(15, 3)
    assert tfig.ImageClickArea(0, 0, 10, 10).contains(8, 8)


def test_animation_loop_runs_and_stops():
    fig = tfig.CanvasFigure(4, 4)
    seen, rates = [], []
    anim = tfig.Animation([fig], fps_callback=rates.append)
    assert anim.run(lambda t: seen.append(t), max_frames=5) == 5
    assert len(seen) == 5 and seen == sorted(seen) and not anim.running
    # a frame function that stops the loop; a duration that has passed
    anim = tfig.Animation([fig])
    assert anim.run(lambda t: anim.stop(), max_frames=100) == 1
    assert anim.run(lambda t: None, duration=0.0) == 0
    # the FPS window closes after a second of frames
    anim = tfig.Animation([fig], fps_callback=rates.append, max_fps=50)
    frames = anim.run(lambda t: None, duration=1.2)
    assert 20 <= frames <= 61 and len(rates) == 1 and rates[0] > 0


@pytest.mark.parametrize("masked", [False, True])
def test_pusher_diagnostics_match_reference(masked):
    rng = np.random.default_rng(5)
    n = 1000
    pos = rng.random((n, 3)).astype(np.float32)
    vel = (1e-3 * rng.standard_normal((n, 3))).astype(np.float32)
    alive = (rng.random(n) > 0.1).astype(np.float32)
    valid = rng.random(n) > 0.3 if masked else None
    ref = jdg.pusher_diagnostics(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
        None if valid is None else jnp.asarray(valid))
    got = tdg.pusher_diagnostics(
        torch.tensor(pos), torch.tensor(vel), torch.tensor(alive),
        None if valid is None else torch.tensor(valid))
    assert got.keys() == ref.keys()
    floats = tdg.to_floats(got)
    assert all(type(v) is float for v in floats.values())
    # f32 sums of 1000 terms in another order: 1e-6 of each value
    for k in ref:
        np.testing.assert_allclose(floats[k], float(ref[k]), rtol=1e-6,
                                   atol=1e-6 * abs(float(ref[k])) + 1e-12,
                                   err_msg=k)


def test_energy_drift_and_recorder():
    series = [1.0, 1.0005, 0.9995, 1.0002]
    assert tdg.energy_drift(series) == jdg.energy_drift(series)
    assert tdg.energy_drift([2.0]) == 0.0 and tdg.energy_drift([0, 1]) == 0.0
    rec = tdg.DiagnosticsRecorder(n_particles=100, window_seconds=0.0)
    d = tdg.pusher_diagnostics(torch.tensor([[0.3, 0.4, 0.5]]),
                               torch.tensor([[0.001, 0.0, 0.0]]),
                               torch.tensor([1.0]))
    rec.record(0, d)
    rec.record(5, {"kinetic": torch.tensor(2.0)})
    assert rec.series("kinetic")[0] == pytest.approx(0.5e-6)
    assert rec.series("kinetic")[1] == 2.0 and rec.series("r_mean")[0] > 0
    rate = rec.tick(10)
    assert rate["steps_per_sec"] > 0
    assert rate["pushes_per_sec"] == pytest.approx(
        2 * 100 * rate["steps_per_sec"])
    slow = tdg.DiagnosticsRecorder(n_particles=100, window_seconds=3600.0)
    assert slow.tick(10) == {"steps_per_sec": 0.0, "pushes_per_sec": 0.0}


def _image():
    rng = np.random.default_rng(1)
    img = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    img[:12] = np.arange(48, dtype=np.uint8)[None, :, None] * 3  # ramps: sub
    img[12:20] = 77                                               # flat: up
    return img


@pytest.mark.parametrize("encoder", ["native", "python"])
def test_png_bytes_match_reference(encoder):
    from PIL import Image

    img = _image()
    if encoder == "native":
        assert tpng.native_available() and jpng.native_available()
        data, ref = tpng.encode_png(img), jpng.encode_png(img)
    else:
        data, ref = tpng._encode_python(img, 3), jpng._encode_python(img, 3)
    assert data == ref
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(tpng.decode_png(data), img)


def test_png_validation_and_decoder_errors():
    with pytest.raises(ValueError, match=r"\(h, w, 3\)"):
        tpng.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.decode_png(b"GIF89a" + bytes(10))
    data = bytearray(tpng.encode_png(_image()))
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tpng.decode_png(bytes(data))


def test_checkpoint_npz_and_torch_roundtrip(tmp_path):
    blob = {"a": np.arange(5.0), "b.c": np.ones((2, 3), np.float32)}
    p = str(tmp_path / "sub" / "ck.npz")
    tck.save_npz(p, blob)
    out = tck.load_npz(p)
    assert set(out) == {"a", "b.c"}
    np.testing.assert_array_equal(out["a"], blob["a"])
    assert out["b.c"].dtype == np.float32

    state = {"pos": torch.arange(12.0).reshape(3, 4), "step": 7,
             "nested": {"gen": torch.Generator().manual_seed(3).get_state()}}
    p = str(tmp_path / "sub" / "ck.pt")
    tck.save_torch(p, state)
    back = tck.load_torch(p)
    assert torch.equal(back["pos"], state["pos"]) and back["step"] == 7
    assert torch.equal(back["nested"]["gen"], state["nested"]["gen"])
    assert tck.load_torch(p, map_location="cpu")["pos"].device.type == "cpu"


def test_debug_nans_raises_on_the_op_and_is_silent_otherwise():
    x = torch.tensor([1.0, 4.0])
    with debug_nans():
        y = torch.sqrt(x) + 1.0              # finite: nothing raised
        z = torch.tensor([1.0, float("inf")]) * 2.0   # inf is not a NaN
    assert torch.equal(y, torch.tensor([2.0, 3.0])) and torch.isinf(z[1])
    with pytest.raises(FloatingPointError, match="log"):
        with debug_nans():
            torch.log(torch.tensor([-1.0, 1.0]))
    with pytest.raises(FloatingPointError, match="sub"):
        with debug_nans():
            torch.tensor([float("inf")]) - torch.tensor([float("inf")])
    with debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))
    # the scope is gone after an exception
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_checked_and_assert_finite():
    def f(x):
        return torch.log(x) * 2.0

    err, out = checked(f)(torch.tensor(-1.0))
    assert torch.isnan(out) and "log" in err.get()
    with pytest.raises(FloatingPointError, match="log"):
        err.throw()
    err, out = checked(f)(torch.tensor(1.0))
    assert err.get() is None and float(out) == 0.0
    err.throw()

    good = {"a": torch.ones(3), "b": torch.zeros((2, 2)),
            "i": torch.arange(3), "n": np.ones(2)}
    assert_finite(good)
    tdg_state = tdg.pusher_diagnostics(torch.zeros((2, 3)),
                                       torch.zeros((2, 3)), torch.ones(2))
    assert_finite(tdg_state, "diag")
    bad = {"a": torch.ones(3), "b": torch.tensor([1.0, float("nan")])}
    with pytest.raises(FloatingPointError, match=r"state\['b'\]: 1 non"):
        assert_finite(bad)
    from fusion_sim_torch.models.pusher_sorted import SortedPusherState
    st = SortedPusherState(*(torch.zeros(2) for _ in range(6)))
    st = st._replace(velocity=torch.tensor([0.0, float("inf")]))
    with pytest.raises(FloatingPointError, match=r"s\.velocity: 1 non"):
        assert_finite(st, "s")
    with pytest.raises(FloatingPointError, match=r"x\[1\]\[0\]"):
        assert_finite([np.zeros(2), [np.array([np.inf])]], "x")


def test_timer_sync_and_trace(tmp_path):
    import time as _time

    t = Timer()
    with t.phase("work", fence=lambda: {"x": torch.ones(2)}):
        _time.sleep(0.01)
    with t.phase("work"):
        _time.sleep(0.01)
    rep = t.report()
    assert rep["work"]["count"] == 2 and rep["work"]["total_s"] >= 0.02
    assert rep["work"]["mean_ms"] >= 10.0
    sync({"a": torch.ones(3), "b": [torch.zeros(2), None]})   # CPU: no-op
    with trace(None):
        pass
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_stepping_helpers_match_reference():
    def step(s):
        return s * 2 + 1

    def resort(s):
        return -s

    assert tst.make_multi_step(step, 5)(torch.tensor(1.0)).item() == float(
        jst.make_multi_step(step, 5)(jnp.float32(1.0)))
    assert tst.make_window_step(step, resort, 3)(torch.tensor(2.0)).item() \
        == float(jst.make_window_step(step, resort, 3)(jnp.float32(2.0)))
    assert tst.make_multi_step(step, 0)(3) == 3
    for n in (0, 1, 2, 3, 7, 8, 9, 1000):
        assert tst.pow2_chunk(n) == jst.pow2_chunk(n)
