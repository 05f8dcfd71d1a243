"""Thin HTTP viewer: the reference's browser app layer (port of
``fusion_sim_tpu/viewer/server.py``).

The L4-L6 application stack (fusionsim.js 'simulation' controller +
index.html shell, SURVEY.md §2.5) as a headless service: the simulation
runs server-side on the card; the browser shows streamed PNG frames and a
click-to-start/stop control with a live FPS counter (``$scope.start/stop/
fps``, fusionsim.js:162-210, index.html:13-14).

JSON API (the engine API surface, empic.js:1157-1526):

    POST /api/config            {spec..., scenario?: "default"} — or
                                {model: "es"|"em", scenario: "two_stream"|
                                 "landau"|"weibel", ...factory kwargs}
    POST /api/set               {position?, velocity?, sink_mask?, source_pdf?, E?, B?}
    POST /api/add_current_loop  {r, z, I}          (empic.js:1352)
    POST /api/add_current_z     {I}                (empic.js:1380)
    POST /api/add_bz            {Bz}               (empic.js:1391)
    POST /api/add_btheta        {Btheta}           (empic.js:1402)
    POST /api/add_spindle_cusp_plasma_field  {coil_current, n_power?}
                                                    (empic.js:1369)
    POST /api/precalc                               (empic.js:1413)
    POST /api/enable_fast_path  {sink_box?, source_box?, uniform_e?}
    POST /api/disable_fast_path
    POST /api/enable_sorted_path {resort_every?, spill_capacity?, backend?,
                                  rng_impl?, repair?, repair_free_slots?}
    POST /api/disable_sorted_path
    POST /api/start | /api/stop                     (fusionsim.js:162,207)
    POST /api/step              {n}                 single-shot stepping
    GET  /api/state             {running, fps, steps, diagnostics}
    GET  /api/diagnostics?since=S  recorded diagnostics time series
    GET  /frame.png             latest rendered frame
    GET  /                      HTML shell

Every touch of the model happens under the service's one lock, on the run
thread and on the handler threads alike; frames are made on the device and
copied to the host once a render.  The service runs on the CUDA card
unless given ``device="cpu"``.

    python -m fusion_sim_torch.viewer.server --host 127.0.0.1 --port 8612
"""

from __future__ import annotations

import collections
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .._device import resolve_device
from ..models.pusher import CylindricalParticlePusher
from ..scenarios import apply_default_scenario
from ..utils.colormaps import preset
from ..utils.diagnostics import pusher_diagnostics, to_floats
from ..utils.png import encode_png
from ..utils.render import frame_to_uint8

_PAGE = """<!DOCTYPE html>
<html><head><title>fusion-sim tpu</title><style>
body { background:#111; color:#ddd; font-family:monospace; }
#plot { image-rendering:pixelated; cursor:pointer; border:1px solid #333; }
</style></head><body>
<div>fps = <span id="fps">0</span> &middot; steps = <span id="steps">0</span>
 &middot; click the plot to start/stop</div>
<img id="plot" width="400" height="800" src="/frame.png"/>
<script>
const img = document.getElementById('plot');
let running = false;
img.onclick = async () => {
  running = !running;
  await fetch(running ? '/api/start' : '/api/stop', {method: 'POST'});
};
setInterval(async () => {
  img.src = '/frame.png?' + Date.now();
  const s = await (await fetch('/api/state')).json();
  document.getElementById('fps').textContent = s.fps.toFixed(0);
  document.getElementById('steps').textContent = s.steps;
  running = s.running;
}, 100);
</script></body></html>"""


def _phase_hist(pos: torch.Tensor, vel: torch.Tensor, v_lim: float,
                bins: tuple[int, int], cells: int) -> torch.Tensor:
    """(x, v) phase-space histogram on the device (no host copy of the
    particles): (bins[0], bins[1]) f32 counts."""
    bx = torch.clamp((pos / cells * bins[0]).to(torch.int32), 0, bins[0] - 1)
    v_lim = torch.tensor(v_lim, dtype=torch.float32, device=vel.device)
    by = torch.clamp(((vel + v_lim) / (2.0 * v_lim) * bins[1])
                     .to(torch.int32), 0, bins[1] - 1)
    flat = (bx * bins[1] + by).to(torch.int64)
    h = torch.bincount(flat, minlength=bins[0] * bins[1])
    return h.to(torch.float32).reshape(bins)


def _host_rgb(img: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy of a frame."""
    return img.contiguous().cpu().numpy()


class PusherAdapter:
    """The reference's live mode: cylindrical pusher + density/|B| frame."""

    model = "pusher"

    def __init__(self, sim: CylindricalParticlePusher):
        self.sim = sim

    def step(self, n: int = 1) -> None:
        self.sim.step(n)

    def render(self) -> np.ndarray:
        return _host_rgb(frame_to_uint8(self.sim.density()))

    def diagnostics(self) -> dict:
        st = self.sim._sorted_state
        if st is not None:  # tile-sorted path: mask filler rows
            d = pusher_diagnostics(st.position, st.velocity, st.alive,
                                   valid=st.valid)
        else:
            d = pusher_diagnostics(self.sim.state.position,
                                   self.sim.state.velocity,
                                   self.sim.state.alive)
        return to_floats(d)


class ESAdapter:
    """1D electrostatic PIC: (x, v) phase-space frame + energy diagnostics."""

    model = "es"

    def __init__(self, sim, bins=(400, 200)):
        self.sim = sim
        self.bins = bins
        v_max = float(torch.abs(sim.state.velocity).max())
        self.v_lim = max(3.0 * v_max, 1e-6)

    def step(self, n: int = 1) -> None:
        self.sim.step(n)

    def render(self) -> np.ndarray:
        cells = self.sim.config.grid_shape[0]
        h = _phase_hist(self.sim.state.position[:, 0],
                        self.sim.state.velocity[:, 0], self.v_lim,
                        self.bins, cells)
        # np.percentile's linear interpolation, in float64 on the device
        top = float(torch.quantile(h.reshape(-1).double(), 0.995)) or 1.0
        cm = preset("hot", 0.0, top)
        return _host_rgb(cm.apply(h.T.flip(0)))

    def diagnostics(self) -> dict:
        return {k: float(v) for k, v in self.sim.energies().items()}


class EMAdapter:
    """2D electromagnetic PIC: B_x filamentation frame + energy diagnostics."""

    model = "em"

    def __init__(self, sim):
        self.sim = sim

    def step(self, n: int = 1) -> None:
        self.sim.step(n)

    def render(self) -> np.ndarray:
        bx = self.sim.state.b[..., 0]
        lim = float(torch.abs(bx).max()) or 1.0
        cm = preset("doppler", -lim, lim)
        return _host_rgb(cm.apply(bx.T.flip(0)))

    def diagnostics(self) -> dict:
        return {k: float(v) for k, v in self.sim.energies().items()}


def _make_adapter(body: dict, device: torch.device):
    """Scenario registry: config body -> model adapter on ``device``."""
    model = body.get("model", "pusher")
    if model == "pusher":
        spec = {k: body[k] for k in ("radius", "height", "nr", "nz", "dt",
                                     "nparticles", "particle_mass",
                                     "particle_charge")}
        sim = CylindricalParticlePusher(spec, device=device)
        if body.get("scenario") == "default":
            apply_default_scenario(sim)
        return PusherAdapter(sim)
    kwargs = {k: v for k, v in body.items() if k not in ("model", "scenario")}
    if model == "es":
        from ..models import electrostatic as es

        scenario = body.get("scenario", "two_stream")
        factory = {"two_stream": es.two_stream, "landau": es.landau}[scenario]
        return ESAdapter(factory(**kwargs, device=device))
    if model == "em":
        from ..models import electromagnetic as em

        scenario = body.get("scenario", "weibel")
        factory = {"weibel": em.weibel}[scenario]
        return EMAdapter(factory(**kwargs, device=device))
    raise KeyError(f"unknown model {model!r} (pusher|es|em)")


class SimulationService:
    """Owns the simulation and its run thread; one lock guards the model.

    ``device`` None means the CUDA card (raising where there is none)."""

    def __init__(self, sample_every: int = 10, series_len: int = 4096,
                 device=None):
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.sim = None  # a *Adapter
        self.running = False
        self.fps = 0.0
        self.steps = 0
        self.run_error: str | None = None
        self.sample_every = sample_every
        self.series: collections.deque = collections.deque(maxlen=series_len)
        self._frame_png: bytes = encode_png(np.zeros((8, 8, 3), np.uint8))
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- commands
    def configure(self, body: dict) -> dict:
        adapter = _make_adapter(body, self.device)
        with self.lock:
            self.sim = adapter
            self.steps = 0
            self.series.clear()
            self._render_locked()
            self._sample_locked()
        return {"ok": True, "model": adapter.model}

    def set_values(self, body: dict) -> dict:
        with self.lock:
            self.sim.sim.set({k: np.asarray(v, np.float32)
                              for k, v in body.items()})
        return {"ok": True}

    def field_command(self, name: str, body: dict) -> dict:
        with self.lock:
            sim = self.sim.sim  # field commands are pusher-engine surface
            if name == "add_current_loop":
                sim.add_current_loop(body["r"], body["z"], body["I"])
            elif name == "add_current_z":
                sim.add_current_z(body["I"])
            elif name == "add_bz":
                sim.add_bz(body["Bz"])
            elif name == "add_btheta":
                sim.add_btheta(body["Btheta"])
            elif name == "add_spindle_cusp_plasma_field":
                # engine surface of empic.js:1369-1378 (the reference
                # ignores its own r/B_c/beta_c arguments and hard-codes the
                # BEM solve; here the physical inputs are explicit)
                sim.add_spindle_cusp_plasma_field(
                    body["coil_current"], int(body.get("n_power", 3)))
            elif name == "precalc":
                sim.precalc()
            elif name == "enable_fast_path":
                sim.enable_fast_path(**{
                    k: v for k, v in body.items()
                    if k in ("sink_box", "source_box", "uniform_e")})
            elif name == "disable_fast_path":
                sim.disable_fast_path()
            elif name == "enable_sorted_path":
                sim.enable_sorted_path(**{
                    k: v for k, v in body.items()
                    if k in ("resort_every", "spill_capacity", "backend",
                             "rng_impl", "repair", "repair_free_slots")})
            elif name == "disable_sorted_path":
                sim.disable_sorted_path()
            else:
                raise KeyError(name)
            self._render_locked()
        return {"ok": True}

    def step_once(self, n: int) -> dict:
        with self.lock:
            self.sim.step(n)
            self.steps += n
            self._render_locked()
            self._sample_locked()
        return {"ok": True, "steps": self.steps}

    # ------------------------------------------------------------- run loop
    def start(self) -> dict:
        if self.sim is None:
            return {"ok": False, "error": "not configured"}
        with self.lock:  # two concurrent POSTs must not spawn two run threads
            if not self.running:
                self.running = True
                self.run_error = None
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()
        return {"ok": True}

    def stop(self) -> dict:
        """Stop the run thread and wait for it, then reset fps to 0
        (fusionsim.js:197-199): a window closing during the last step
        cannot set it again."""
        self.running = False
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join()
        self.fps = 0.0
        return {"ok": True}

    def _run(self):
        win_start = time.perf_counter()
        win_frames = 0
        while self.running:
            with self.lock:
                try:
                    self.sim.step()
                    self.steps += 1
                    self._render_locked()
                    if self.steps % self.sample_every == 0:
                        self._sample_locked()
                except Exception:  # the run thread's boundary: report, stop
                    self.run_error = traceback.format_exc()
                    self.running = False
                    return
            win_frames += 1
            now = time.perf_counter()
            if now - win_start >= 1.0:  # 1 s FPS window, fusionsim.js:186-192
                self.fps = win_frames / (now - win_start)
                win_start = now
                win_frames = 0

    def _render_locked(self):
        self._frame_png = encode_png(self.sim.render())

    def _sample_locked(self):
        self.series.append({"step": self.steps, "time": time.time(),
                            **self.sim.diagnostics()})

    # -------------------------------------------------------------- queries
    def state(self) -> dict:
        out = {"running": self.running, "fps": self.fps, "steps": self.steps,
               "configured": self.sim is not None}
        if self.run_error is not None:
            out["error"] = self.run_error
        if self.sim is not None:
            out["model"] = self.sim.model
            with self.lock:
                out["diagnostics"] = self.sim.diagnostics()
        return out

    def diagnostics_series(self, since: int = -1) -> dict:
        with self.lock:
            samples = [s for s in self.series if s["step"] > since]
        return {"series": samples, "sample_every": self.sample_every}

    def frame_png(self) -> bytes:
        return self._frame_png


def make_handler(service: SimulationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                data = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/frame.png":
                data = service.frame_png()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/api/state":
                self._json(service.state())
            elif path == "/api/diagnostics":
                q = dict(p.split("=", 1) for p in
                         self.path.partition("?")[2].split("&") if "=" in p)
                self._json(service.diagnostics_series(
                    since=int(q.get("since", -1))))
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            path = self.path.split("?")[0]
            try:
                if path == "/api/config":
                    self._json(service.configure(body))
                elif path == "/api/set":
                    self._json(service.set_values(body))
                elif path == "/api/start":
                    self._json(service.start())
                elif path == "/api/stop":
                    self._json(service.stop())
                elif path == "/api/step":
                    self._json(service.step_once(int(body.get("n", 1))))
                elif path.startswith("/api/"):
                    self._json(service.field_command(path[len("/api/"):], body))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # surface errors as JSON, fail-fast style
                self._json({"ok": False, "error": f"{type(e).__name__}: {e}"}, 400)

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8080,
          device=None) -> ThreadingHTTPServer:
    """Build the viewer server on ``device`` (None: the CUDA card); call
    ``serve_forever`` on the result."""
    service = SimulationService(device=device)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service
    return server


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args()
    srv = serve(args.host, args.port)
    print(f"fusion-sim torch viewer on http://{args.host}:{args.port} "
          f"({srv.service.device})", flush=True)
    srv.serve_forever()
