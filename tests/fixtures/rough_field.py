"""The rough-field ensemble of ``bench.py`` (:562-582), numpy only.

``tests/fixtures/make_mc_fixture.py`` (with the JAX package),
``tests/test_torch_*.py`` and ``chip_smoke.py`` (with the PyTorch port)
build it from the same seed, each with its package's own Munk profile.
"""

import numpy as np


def rough_tables(munk_ssp, E, nz=2001, nr=16, r_max=100e3, seed=0):
    """``(c (E, nr, nz), r, z)``: a Munk profile plus eight sines of 15-60 m
    wavelength and 0.05-0.3 m/s amplitude with per-realization phases
    (``seed``), ramped 0.2 % over the range stations.  The amplitudes,
    wavelengths and the phases of realization e do not depend on E."""
    rng = np.random.RandomState(seed)
    z = np.linspace(0.0, 6000.0, nz)
    r = np.linspace(0.0, r_max, nr)
    amps = rng.uniform(0.05, 0.3, 8)
    lams = rng.uniform(15, 60, 8)
    # per-realization random phases (a sample roll of the non-periodic sum
    # would cut a discontinuity into the profile that no fit can represent)
    phs = rng.uniform(0, 2 * np.pi, (16, 8))
    ramp = 1.0 + 2e-3 * np.linspace(0, 1, nr)
    c = np.array([
        np.outer(ramp, munk_ssp(z) + sum(a * np.sin(2 * np.pi * z / lam + ph)
                                        for a, lam, ph in zip(amps, lams, phs[e])))
        for e in range(E)
    ])
    return c, r, z
