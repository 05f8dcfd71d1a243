"""fusion_sim_torch — the PyTorch/CUDA port of ``fusion_sim_tpu``.

The JAX package stays the reference; this package keeps its module layout,
file names and public signatures so each function has an obvious
counterpart.  Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path becomes a hand-written Hopper kernel under ``csrc/`` (built
with ``nvcc`` at first use and bound with ``ctypes``), with a plain PyTorch
version of the same function beside it.

Ported so far:

* ``ops``    — CIC interpolation, spectral Poisson solve, the tile-sorted
  layout and its windowed gathers, the fused ES substep (kernel B1); the
  pusher's Boris rotation, field construction, inverse-CDF sampling,
  drift/sink/respawn, moment deposit, and its fused half-step (kernel B2)
  and windowed gather (kernel B3); Yee FDTD updates, Esirkepov current
  deposition (plain and tile-sorted) and the fused EM substep (kernel B4).
* ``models`` — ``electrostatic``: ``ElectrostaticPIC`` and
  ``SortedElectrostaticPIC(backend='pallas')``; ``pusher``:
  ``CylindricalParticlePusher`` (grid-parity path and the tile-sorted path,
  backends xla / pallas / fused); ``electromagnetic``:
  ``ElectromagneticPIC``, ``weibel`` and ``SortedElectromagneticPIC``
  (gather backends xla / pallas / fused).
* ``scenarios``, ``constants``, ``config``, ``utils.render``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``_device.resolve_device``).
"""

__version__ = "0.1.0"
