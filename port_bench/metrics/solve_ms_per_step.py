"""Device time of the field solve per step: the operations launched under
the program's ``fusion_sim.solve`` span.  In the EM shell that is
``yee_update``.  In the ES shell it is the whole solve phase: the
neutralising background taken off the carried charge, the FFT Poisson
solve and the gradient to E (``solve_fields``), about 0.052 ms a step at
512^2 on an H100, where ``poisson_fft`` alone took 0.021."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "solve")
