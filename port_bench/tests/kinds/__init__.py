"""One module per kind of model (``port_bench/kinds/<model>.py``) for the
CPU tests, found by a configuration's ``"model"`` (``of``).  Each holds:

- ``tiny(config) -> config``: the kind's configuration cut to a few
  tiles on the CPU (it gets a copy, changes it and returns it);
- ``FAULTS``: a fault's name -> a function of pytest's ``monkeypatch``
  that plants that fault in the kind's timed path.  A whole run with any
  of them planted has to come out with ``correct`` false.
"""

import importlib

import torch


def of(model: str):
    """The test module of the kind ``model``; None where there is none."""
    name = f"{__name__}.{model}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def altered_substep(orig):
    """A fused substep (``(table or E, pos, vel, weight or valid, ...)``
    -> ``(x1, v1, grid, in_win)``) with the first real row's new position
    moved a quarter cell."""
    def substep(*args, **kw):
        x1, v1, grid, in_win = orig(*args, **kw)
        real = int(torch.nonzero(args[3] != 0)[0])    # weight or valid
        x1 = x1.clone()
        x1[real] = x1[real] + 0.25
        return x1, v1, grid, in_win
    return substep
