# Copied from pygenray_tpu/models/internal_waves.py (host numpy); tests pin it equal to the original.
"""Internal-wave sound-speed perturbations for Monte Carlo tomography.

Generates ensembles of range-dependent sound-speed perturbation fields
δc(r, z) with a Garrett–Munk-flavored spectrum: a sum of WKB-stretched
vertical modes with a j* mode-number rolloff and random horizontal phases,
scaled so the rms fractional perturbation matches ``mu_rms`` near the SOFAR
channel.  This supports the Monte-Carlo tomography benchmark configuration
(BASELINE.json configs[4]: 10^6 rays over internal-wave-perturbed SSP
realizations); the reference package has no equivalent — perturbed fields
would be passed in by the user as data.

This is a *statistical generator* for benchmarking and sensitivity studies,
not a full GM implementation (no buoyancy-profile dependence beyond an
exponential N(z), no frequency spectrum).
"""

from __future__ import annotations

import numpy as np

from ..environment import munk_ssp

__all__ = ["iw_perturbations", "perturbed_munk_tables"]


def iw_perturbations(
    z: np.ndarray,
    r: np.ndarray,
    n_realizations: int,
    mu_rms: float = 5e-4,
    n_modes: int = 12,
    j_star: float = 3.0,
    n_kr: int = 16,
    lambda_min: float = 5e3,
    lambda_max: float = 100e3,
    zn_scale: float = 1000.0,
    seed: int = 0,
):
    """Random internal-wave-like δc/c fields.

    Parameters
    ----------
    z, r : depth / range grids [m]
    n_realizations : ensemble size E
    mu_rms : target rms fractional sound-speed perturbation at the surface
        (canonical deep-ocean value ~5e-4; decays with depth via the
        exponential buoyancy profile)
    n_modes : number of vertical modes
    j_star : GM mode-number bandwidth (spectrum ∝ 1/(j² + j*²))
    n_kr : horizontal wavenumbers per mode
    lambda_min, lambda_max : horizontal wavelength band [m]
    zn_scale : e-folding depth of the buoyancy frequency N(z) [m]

    Returns
    -------
    mu : (E, nr, nz) fractional perturbation fields δc/c
    """
    rng = np.random.default_rng(seed)
    z = np.asarray(z, float)
    r = np.asarray(r, float)

    # exponential buoyancy profile; WKB amplitude scaling ~ N(z)
    Nz = np.exp(-z / zn_scale)  # normalized N(z)/N0

    # mode-number spectrum (GM rolloff)
    j = np.arange(1, n_modes + 1)
    Aj = 1.0 / (j**2 + j_star**2)
    Aj /= Aj.sum()

    # vertical structure: sin(j π ξ) in the WKB-stretched coordinate
    xi = np.cumsum(Nz) / Nz.sum()  # stretched vertical coordinate in [0,1]
    modes = np.sin(np.pi * j[:, None] * xi[None, :])  # (J, nz)

    kr = 2 * np.pi / np.exp(
        rng.uniform(np.log(lambda_min), np.log(lambda_max), (n_realizations, n_modes, n_kr))
    )
    phase = rng.uniform(0, 2 * np.pi, (n_realizations, n_modes, n_kr))
    amp = rng.normal(size=(n_realizations, n_modes, n_kr)) / np.sqrt(n_kr)

    # horizontal factor per (E, J, nr)
    horiz = np.einsum(
        "ejk,ejkr->ejr", amp, np.cos(kr[..., None] * r[None, None, None, :] + phase[..., None])
    )

    # combine: (E, nr, nz)
    mu = np.einsum("j,ejr,jz->erz", np.sqrt(Aj), horiz, modes)
    mu *= Nz[None, None, :]  # WKB depth decay

    # normalize rms at the reference depth band (upper ocean)
    band = z < 2 * zn_scale
    rms = np.sqrt(np.mean(mu[..., band] ** 2))
    if rms > 0:
        mu *= mu_rms / rms
    return mu


def perturbed_munk_tables(
    n_realizations: int,
    r_max: float = 100e3,
    nr: int = 64,
    nz: int = 1024,
    mu_rms: float = 5e-4,
    seed: int = 0,
):
    """Ensemble of Munk sound-speed tables with internal-wave perturbations.

    Returns (c_ensemble (E, nr, nz), r, z).
    """
    z = np.linspace(0.0, 6000.0, nz)
    r = np.linspace(0.0, r_max, nr)
    c0 = np.outer(np.ones(nr), munk_ssp(z))
    mu = iw_perturbations(z, r, n_realizations, mu_rms=mu_rms, seed=seed)
    return c0[None, :, :] * (1.0 + mu), r, z
