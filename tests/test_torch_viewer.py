"""Port vs reference: the HTTP viewer (fusion_sim_torch/viewer/server.py).

Both viewers, the port's on the CPU, serve the request sequences of
tests/test_utils.py's viewer tests side by side; models, step counts,
diagnostics keys and frame shapes must agree.  Where a sequence draws no
random numbers (positions set through /api/set and no respawn; the ES and
EM scenarios' numpy set-up), diagnostics agree at 1e-5 and frames within
one level."""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from fusion_sim_torch.utils.png import decode_png
from fusion_sim_torch.viewer import server as tsv
from fusion_sim_tpu.viewer import server as jsv

PUSHER = {"radius": 1.0, "height": 2.0, "nr": 16, "nz": 32, "dt": 2e-9,
          "nparticles": 8, "particle_mass": 1.67e-27,
          "particle_charge": 1.602e-19}


class Client:
    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"

    def post(self, path, obj=None, code=200):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(obj or {}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                got, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            got, body = e.code, json.loads(e.read())
        assert got == code, (path, got, body)
        return body

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.read()

    def state(self):
        return json.loads(self.get("/api/state"))

    def frame(self):
        return decode_png(self.get("/frame.png"))


@contextlib.contextmanager
def _serving(serve, **kw):
    srv = serve(port=0, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield Client(srv.server_address[1]), srv.service
    finally:
        srv.service.stop()
        srv.shutdown()
        t.join(timeout=30)
        srv.server_close()


@contextlib.contextmanager
def _both():
    with _serving(jsv.serve) as ref, _serving(tsv.serve, device="cpu") as out:
        yield ref[0], out[0], out[1]


def _same(ref, out, path, obj=None, code=200):
    """POST to both viewers: the same JSON answer, less the error text."""
    a, b = ref.post(path, obj, code), out.post(path, obj, code)
    if code == 200:
        assert a == b, (path, a, b)
    else:
        assert a["ok"] is b["ok"] is False
        assert a["error"].split(":")[0] == b["error"].split(":")[0]
    return b


def _close_diagnostics(got, want, rtol=1e-5):
    assert got.keys() == want.keys()
    scale = max(abs(v) for v in want.values()) or 1.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=1e-9 * scale, err_msg=k)


def _close_frames(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_viewer_http_api_matches_reference():
    """tests/test_utils.py:215-275 on both viewers: the default scenario,
    a uniform B_z, stepping, the fast-path and sorted-path toggles, the
    page and the 400 path."""
    with _both() as (ref, out, _):
        cfg = dict(PUSHER, scenario="default")
        assert _same(ref, out, "/api/config", cfg) == {"ok": True,
                                                       "model": "pusher"}
        _same(ref, out, "/api/add_bz", {"Bz": 0.01})
        _same(ref, out, "/api/precalc")
        assert _same(ref, out, "/api/step", {"n": 3})["steps"] == 3
        s_ref, s_out = ref.state(), out.state()
        assert s_out["configured"] and s_out["steps"] == 3
        assert s_out.keys() == s_ref.keys()
        assert s_out["diagnostics"].keys() == s_ref["diagnostics"].keys()
        assert out.frame().shape == ref.frame().shape == (32, 16, 3)
        assert b"fusion-sim tpu" in out.get("/")
        _same(ref, out, "/api/enable_fast_path", {})
        assert _same(ref, out, "/api/step", {"n": 2})["steps"] == 5
        _same(ref, out, "/api/disable_fast_path", {})
        _same(ref, out, "/api/enable_sorted_path", {"resort_every": 4})
        assert _same(ref, out, "/api/step", {"n": 2})["steps"] == 7
        assert out.state()["diagnostics"].keys() == ref.state()[
            "diagnostics"].keys()
        _same(ref, out, "/api/disable_sorted_path", {})
        _same(ref, out, "/api/bogus", {}, code=400)
        with pytest.raises(urllib.error.HTTPError) as e:
            out.get("/api/nope")
        assert e.value.code == 404


def test_viewer_registry_and_series_match_reference():
    """tests/test_utils.py:277-345 on both viewers: ES two_stream and EM
    weibel (numpy set-ups, no random draws while stepping: diagnostics at
    1e-5, frames within one level), /api/diagnostics?since=, and the
    spindle endpoint on the pusher."""
    with _both() as (ref, out, _):
        cfg = {"model": "es", "scenario": "two_stream", "n_particles": 2048,
               "n_cells": 32}
        assert _same(ref, out, "/api/config", cfg)["model"] == "es"
        assert _same(ref, out, "/api/step", {"n": 4})["steps"] == 4
        _close_frames(out.frame(), ref.frame())
        assert out.frame().shape == (200, 400, 3)
        d_ref = json.loads(ref.get("/api/diagnostics"))
        d_out = json.loads(out.get("/api/diagnostics"))
        assert len(d_out["series"]) == len(d_ref["series"]) >= 2
        assert d_out["sample_every"] == d_ref["sample_every"]
        for a, b in zip(d_ref["series"], d_out["series"]):
            assert a.keys() == b.keys() and a["step"] == b["step"]
            _close_diagnostics({k: b[k] for k in ("kinetic", "field",
                                                  "total")},
                               {k: a[k] for k in ("kinetic", "field",
                                                  "total")})
        since = json.loads(out.get("/api/diagnostics?since=3"))["series"]
        assert since and all(s["step"] > 3 for s in since)
        _close_diagnostics(out.state()["diagnostics"],
                           ref.state()["diagnostics"])

        cfg = {"model": "em", "scenario": "weibel", "n_particles": 4096,
               "n_cells": 16}
        assert _same(ref, out, "/api/config", cfg)["model"] == "em"
        assert _same(ref, out, "/api/step", {"n": 2})["steps"] == 2
        _close_frames(out.frame(), ref.frame())
        assert out.state()["model"] == "em"
        _close_diagnostics(out.state()["diagnostics"],
                           ref.state()["diagnostics"])
        _same(ref, out, "/api/config", {"model": "es", "scenario": "x"},
              code=400)
        _same(ref, out, "/api/config", {"model": "nope"}, code=400)

        assert _same(ref, out, "/api/config", PUSHER)["model"] == "pusher"
        _same(ref, out, "/api/add_spindle_cusp_plasma_field",
              {"coil_current": 1e6, "n_power": 2})
        _same(ref, out, "/api/enable_fast_path", {}, code=400)
        _same(ref, out, "/api/precalc")
        assert _same(ref, out, "/api/step", {"n": 1})["steps"] == 1


def test_viewer_pusher_without_draws_matches_reference():
    """Positions, velocities and B set through /api/set, no sink: no row
    dies, so no uniform is read, and both viewers compute the same steps.
    Diagnostics at 1e-5, frames within one level, on the grid path and
    the sorted path."""
    rng = np.random.default_rng(11)
    n = PUSHER["nparticles"] ** 2
    pos = np.stack([0.2 + 0.3 * rng.random(n), 0.1 * rng.random(n),
                    0.8 + 0.4 * rng.random(n)], axis=1)
    vel = 2e-3 * (rng.random((n, 3)) - 0.5)
    b = np.zeros((16, 32, 3))
    b[..., 2] = 0.02 + 0.01 * rng.random((16, 32))
    b[..., 0] = 0.005 * rng.standard_normal((16, 32))
    body = {"position": pos.tolist(), "velocity": vel.tolist(),
            "B": b.tolist()}
    with _both() as (ref, out, _):
        _same(ref, out, "/api/config", PUSHER)
        _same(ref, out, "/api/set", body)
        _same(ref, out, "/api/precalc")
        for _ in range(2):
            _same(ref, out, "/api/step", {"n": 3})
            s_ref, s_out = ref.state(), out.state()
            assert s_out["diagnostics"]["respawn_fraction"] == 0.0
            _close_diagnostics(s_out["diagnostics"], s_ref["diagnostics"])
            _close_frames(out.frame(), ref.frame())
        _same(ref, out, "/api/enable_sorted_path",
              {"resort_every": 4, "backend": "xla"})
        _same(ref, out, "/api/step", {"n": 5})
        _close_diagnostics(out.state()["diagnostics"],
                           ref.state()["diagnostics"])
        _close_frames(out.frame(), ref.frame())


def test_service_runs_counts_fps_and_resets_on_stop():
    """start/stop on the port's service: the run thread steps and renders,
    the 1 s window sets fps, stop waits for the thread and resets fps to
    0; a failing step stops the thread and is reported."""
    with _serving(tsv.serve, device="cpu") as (out, service):
        assert out.post("/api/start") == {"ok": False,
                                          "error": "not configured"}
        out.post("/api/config", dict(PUSHER, scenario="default"))
        assert out.post("/api/start") == {"ok": True}
        assert out.post("/api/start") == {"ok": True}   # one thread only
        deadline = time.time() + 60
        while out.state()["fps"] == 0.0 and time.time() < deadline:
            time.sleep(0.1)
        s = out.state()
        assert s["running"] and s["fps"] > 0 and s["steps"] > 0
        assert out.post("/api/stop") == {"ok": True}
        s = out.state()
        assert not s["running"] and s["fps"] == 0.0
        assert not service._thread.is_alive()
        steps = s["steps"]
        series = json.loads(out.get("/api/diagnostics"))["series"]
        assert [x["step"] for x in series[1:]] == list(
            range(10, steps + 1, 10))
        assert out.frame().shape == (32, 16, 3)

        def broken(n=1):
            raise RuntimeError("step failed")

        service.sim.step = broken
        out.post("/api/start")
        service._thread.join(timeout=30)
        s = out.state()
        assert not s["running"] and "step failed" in s["error"]
        assert s["steps"] == steps



def test_module_entry_point():
    """``python -m fusion_sim_torch.viewer.server``: its options, and off the
    card its refusal to serve (the service's device rule)."""
    import subprocess
    import sys

    import torch

    cmd = [sys.executable, "-m", "fusion_sim_torch.viewer.server"]
    out = subprocess.run(cmd + ["--help"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    assert "--host" in out.stdout and "--port" in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run(cmd + ["--port", "0"], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and "CUDA" in out.stderr
