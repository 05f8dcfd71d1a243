"""On-device scalar diagnostics (port of ``fusion_sim_tpu/utils/diagnostics.py``).

The reference's only observables are the rendered density/|B| canvas and an
FPS counter (fusionsim.js:180-199); the framework adds reductions computed
on the device without host round trips: kinetic energy, energy drift,
momentum, particle loss/respawn, mean position.  ``DiagnosticsRecorder``
keeps a host-side time series and the steps/s window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def pusher_diagnostics(position: torch.Tensor, velocity: torch.Tensor,
                       alive: torch.Tensor,
                       valid: torch.Tensor | None = None
                       ) -> dict[str, torch.Tensor]:
    """Scalar diagnostics of the cylindrical pusher's state, as 0-d tensors
    on its device.

    Velocities are the stored normalized values; kinetic energy is the
    normalized sum |v|^2 used for drift tracking.  ``valid`` (optional,
    (N,) bool) masks padded layouts: filler rows are left out of every
    reduction (the tile-sorted path passes its validity mask)."""
    if valid is None:
        vf = torch.ones(position.shape[0], dtype=torch.float32,
                        device=position.device)
    else:
        vf = valid.to(torch.float32)
    nv = torch.clamp(torch.sum(vf), min=1.0)
    v2 = torch.sum(velocity * velocity, dim=-1) * vf
    r = torch.sqrt(position[..., 0] ** 2 + position[..., 1] ** 2)
    return {
        "kinetic": 0.5 * torch.sum(v2),
        "v_max": torch.sqrt(torch.max(v2)),
        "momentum_x": torch.sum(velocity[..., 0] * vf),
        "momentum_y": torch.sum(velocity[..., 1] * vf),
        "momentum_z": torch.sum(velocity[..., 2] * vf),
        "respawn_fraction": torch.sum((1.0 - alive) * vf) / nv,
        "r_mean": torch.sum(r * vf) / nv,
        "z_mean": torch.sum(position[..., 2] * vf) / nv,
    }


def to_floats(values: dict[str, torch.Tensor]) -> dict[str, float]:
    """A dict of 0-d tensors as Python floats, in one host copy."""
    names = list(values)
    flat = torch.stack([values[k].to(torch.float32) for k in names])
    return dict(zip(names, flat.tolist()))


def energy_drift(kinetic_series) -> float:
    """Relative energy drift |E_n - E_0| / E_0 over a recorded series —
    the BASELINE.json target is < 1e-3 over 10k steps."""
    ks = np.asarray(kinetic_series, dtype=np.float64)
    if len(ks) < 2 or ks[0] == 0:
        return 0.0
    return float(np.abs(ks - ks[0]).max() / np.abs(ks[0]))


@dataclasses.dataclass
class DiagnosticsRecorder:
    """Host-side series of diagnostic samples with steps/s accounting.

    The reference's 1-second FPS window (fusionsim.js:180-199):
    ``tick(n_steps)`` after each batch returns steps/s and pushes/s over
    the last closed window."""

    n_particles: int
    window_seconds: float = 1.0

    def __post_init__(self):
        self.samples: list[dict] = []
        self._win_start = time.perf_counter()
        self._win_steps = 0
        self._last_rate = {"steps_per_sec": 0.0, "pushes_per_sec": 0.0}

    def record(self, step: int, values: dict) -> None:
        entry = {"step": step}
        entry.update({k: float(v) for k, v in values.items()})
        self.samples.append(entry)

    def tick(self, n_steps: int) -> dict:
        self._win_steps += n_steps
        now = time.perf_counter()
        elapsed = now - self._win_start
        if elapsed >= self.window_seconds:
            sps = self._win_steps / elapsed
            self._last_rate = {
                "steps_per_sec": sps,
                # two half-steps per step, like empic.js:1436-1469
                "pushes_per_sec": sps * 2 * self.n_particles,
            }
            self._win_start = now
            self._win_steps = 0
        return self._last_rate

    def series(self, key: str):
        return [s[key] for s in self.samples if key in s]
