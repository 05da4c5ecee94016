"""The random smooth fields of ``tests/test_fuzz_parity.py`` (:21-41),
numpy only.

``tests/test_torch_fuzz.py`` (with the JAX package and the PyTorch port)
and ``chip_smoke.py`` (with the port) build them from the same seed, each
with its package's own Munk profile.
"""

import numpy as np
import numpy.polynomial.chebyshev as ncheb


def random_env(munk_ssp, rng, nz=400, nr=24, r_max=40e3):
    """``(c (nr, nz), r, z, bathy)``: a Munk profile plus a random smooth
    8-term Chebyshev structure in depth, a mild random range ramp, and a
    wavy sloped bottom, drawn from ``rng`` (a ``numpy.random.Generator``)
    in the order ``test_fuzz_parity.random_env`` draws them."""
    z = np.linspace(0.0, 5500.0, nz)
    r = np.linspace(0.0, r_max, nr)
    base = munk_ssp(z)
    # smooth random vertical structure
    u = (2 * z - (z[0] + z[-1])) / (z[-1] - z[0])
    coefs = rng.normal(0, 1, 8) * (8.0 / (1 + np.arange(8)))
    dc = ncheb.chebval(u, coefs)
    # mild random range dependence
    ramp = rng.normal(0, 0.5e-4)
    c2d = base[None, :] + dc[None, :] + ramp * r[:, None]
    # wavy, sloped bathymetry
    b0 = rng.uniform(4200.0, 5000.0)
    slope = rng.uniform(-0.004, 0.004)
    wav = rng.uniform(0, 60.0)
    bathy = b0 + slope * r + wav * np.sin(2 * np.pi * r / rng.uniform(15e3, 40e3))
    return c2d, r, z, bathy


def source_and_angles(rng):
    """The source depth and the 8 launch angles (ODE convention, degrees)
    that ``test_fuzz_parity.test_random_env_parity`` draws after the field."""
    z_src = float(rng.uniform(300.0, 2500.0))
    angles = np.concatenate(
        [rng.uniform(-8, 8, 4), rng.uniform(8, 16, 2), rng.uniform(-16, -8, 2)]
    )
    return z_src, angles
