"""fusion_sim_torch — the PyTorch/CUDA port of ``fusion_sim_tpu``.

The JAX package stays the reference; this package keeps its module layout,
file names and public signatures so each function has an obvious
counterpart.  Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path becomes a hand-written Hopper kernel under ``csrc/`` (built
with ``nvcc`` at first use and bound with ``ctypes``), with a plain PyTorch
version of the same function beside it.

Ported so far (every Pallas kernel of the JAX package has its Hopper
counterpart):

* ``ops``    — CIC interpolation, spectral Poisson solve, the tile-sorted
  layout and its windowed gathers, the fused ES substeps in 2D and 3D
  (kernels B1, B5); the pusher's Boris rotation, field construction,
  inverse-CDF sampling, drift/sink/respawn, moment deposit, its fused
  half-step (kernel B2) and windowed gather (kernel B3), and the analytic
  fast path (``ops/analytic``, plain PyTorch); Yee FDTD updates, Esirkepov
  current deposition (plain and tile-sorted) and the fused EM substeps in
  2D3V and 3D3V (kernels B4, B6); incremental layout repair
  (``ops/repair``); the contraction-depth experiment's product (kernel X1,
  ``ops/contraction_depth``, driven by ``examples/mxu_experiment``); the
  iterative solvers (``ops/solvers``: ``weighted_jacobi``,
  ``SORIterative``, ``conjugate_gradient``) and the block reductions
  (``ops/reduce``), plain PyTorch.
* ``models`` — ``electrostatic``: ``ElectrostaticPIC`` and
  ``SortedElectrostaticPIC`` (backends xla / pallas, 2D and 3D, resort or
  ``repair=True``); ``pusher``: ``CylindricalParticlePusher`` (grid-parity
  path, the tile-sorted path with backends xla / pallas / fused and
  optional repair, ``enable_fast_path`` and
  ``add_spindle_cusp_plasma_field``); ``spindle``: the spindle-cusp BEM
  solve; ``electromagnetic``: ``ElectromagneticPIC``, ``weibel`` and
  ``SortedElectromagneticPIC`` (gather backends xla / pallas / fused,
  2D3V and 3D3V, resort or repair); ``electrostatic_sharded``:
  ``ShardedElectrostaticPIC``, the 1-axis domain-decomposed ES loop in
  2D and 3D (backends xla / pallas on kernels B1 / B5, resort or repair),
  one rank a slab; ``electromagnetic_sharded``:
  ``ShardedElectromagneticPIC``, the 1-axis EM loop in 2D3V and 3D3V
  (plain, sorted xla or fused on B4 / B6, resort or repair);
  ``electrostatic_sharded2d`` and ``electromagnetic_sharded2d``:
  ``ShardedElectrostaticPIC2D`` and ``ShardedElectromagneticPIC2D``, the
  same loops on a two-axis mesh, one rank an (x, y) block (B1 / B5 and
  B4 / B6 on the fused backends).
* ``parallel`` — meshes (``torch.distributed.device_mesh``), DTensor
  placements, halo exchange and particle migration on
  ``torch.distributed`` (NCCL on the card, gloo on the CPU); with the
  sharded solve (``ops/solvers.poisson_fft_sharded``) and the sharded
  repair (``ops/repair``).
* ``utils`` — render, colormaps, figure, diagnostics, png (the
  repository's ``native/`` encoder), checkpoint, debug, profiling,
  stepping.
* ``viewer.server`` — the HTTP viewer (the reference app's live mode):
  ``python -m fusion_sim_torch.viewer.server --port 8612``.
* ``scenarios``, ``constants``, ``config``.
* ``bench`` — the headline benchmark (``python -m fusion_sim_torch.bench``,
  one JSON line with the repository's ``bench.py`` keys); ``entry`` — the
  single-device entry point (``entry()``: the flagship step and its example
  arguments); ``examples`` — the users' scripts (default scenario,
  two-stream, Weibel, the ES / EM / 3D / pusher / slab benches, the drift
  control, the contraction-depth experiment, the one-chip sharded bench
  and the weak-scaling bench).

Not ported yet: ``dryrun_multichip`` and the probe / profiling examples
(ROADMAP.md Queue A5 and A6).

The package root exports what the JAX package's root exports: ``config``,
``constants``, ``CylindricalParticlePusher``, ``PusherSpec`` and
``make_cylindrical_particle_pusher``; and ``parallel``, which the
reference's layout lists beside ``models``, ``ops`` and ``utils``.  Importing it builds no kernel: each
kernel is compiled at its first launch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``_device.resolve_device``).
"""

from . import config, constants, parallel  # noqa: F401
from .models.pusher import (  # noqa: F401
    CylindricalParticlePusher,
    PusherSpec,
    make_cylindrical_particle_pusher,
)

__version__ = "0.1.0"
