"""Physical constants of the pusher (port of ``fusion_sim_tpu/constants.py``).

The reference fixes the speed of light at 2.998e8 m/s (empic.js:27) and uses
mu0 = 1.25663706e-6 and a truncated pi in its Biot-Savart kernels
(empic.js:314, 402).  The port keeps the same truncated values, so the
normalized quantities agree with the JAX package at f32 precision.
"""

SPEED_OF_LIGHT = 2.998e8          # m/s, empic.js:27
MU_0 = 1.25663706e-6              # T*m/A, empic.js:314
PI = 3.14159265359                # empic.js:314 (GLSL literal)
