"""Electrostatic PIC in 3D on the tile-sorted layout, rows ordered by cell
inside each tile: ``fusion_sim_torch.models.electrostatic.
SortedElectrostaticPIC`` on a 3D grid and a ``Tiling3D``, stepped by
kernel B5.

Everything is the 2D kind's (``electrostatic.py``): ``build`` takes the
``Tiling3D`` from the configuration's three-axis tile, ``snapshot`` reads
the real rows and the carried charge, ``reference_after`` steps
``reference/pic.es_step``, whose CIC deposit, gather and spectral solve
take the grid's rank from its shape, and the numbers are ES's: ``count``,
``dropped``, ``nonfinite``, ``start``, ``moments``, ``rho``, ``charge``
and ``momentum``.  No function of its own: the 3D case needs none.  It
is a kind apart so that its small configuration and its faults
(``port_bench/tests/kinds/electrostatic3d.py``) reach the 3D grid and
kernel B5.
"""

from __future__ import annotations

from .electrostatic import (build, dropped, end_numbers,  # noqa: F401
                            reference_after, snapshot, step_numbers)
