"""One file per kind of model the configurations name (``"model"``): how
the harness builds it through the port's public constructor, what it
reads back from its state, and the numbers that decide ``correct``.

A kind module defines ``build(config, layout, pos, vel, device)`` (a
model with ``step(n)``), ``snapshot(sim)`` (the real rows as ``"x"`` and
``"v"`` in the grid frame, plus whatever the kind compares),
``dropped(sim)``, ``reference_after(config, before, fdtype)``,
``step_numbers(config, after, ref, before)`` and ``end_numbers(config,
end, x_in, v_in)``, and may define ``inputs(config, traffic, seed,
device)``: its own particle load, in place of ``inputs.make``, under the
contract written there.  A kind whose own coordinates differ from the
grid frame converts in ``inputs``, ``build`` and ``snapshot``.  Its
small configuration and planted faults for the CPU tests live in
``port_bench/tests/kinds/<model>.py``.
"""
