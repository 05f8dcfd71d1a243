"""Physical constants of the pusher (port of ``fusion_sim_tpu/constants.py``).

The reference fixes the speed of light at 2.998e8 m/s (empic.js:27) and uses
mu0 = 1.25663706e-6 and a truncated pi in its Biot-Savart kernels
(empic.js:314, 402).  The port keeps the same truncated values, so the
normalized quantities agree with the JAX package at f32 precision; the
CODATA values are exported too, for the paths that do not need parity.
"""

# Reference-truncated values (parity with empic.js:27,314)

SPEED_OF_LIGHT = 2.998e8          # m/s, empic.js:27
MU_0 = 1.25663706e-6              # T*m/A, empic.js:314
PI = 3.14159265359                # empic.js:314 (GLSL literal)

# CODATA-2018 values for the paths that do not need parity
C_EXACT = 299792458.0
MU0_EXACT = 1.25663706212e-6
EPS0 = 8.8541878128e-12
ELEMENTARY_CHARGE = 1.602176634e-19
ELECTRON_MASS = 9.1093837015e-31
PROTON_MASS = 1.67262192369e-27
BOLTZMANN = 1.380649e-23
