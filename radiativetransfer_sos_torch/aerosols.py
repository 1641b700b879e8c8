"""Aerosol phase-matrix truncation and Legendre/GSF expansion.

Copy of the expansion half of the JAX package's ``aerosols.py``
(reference ``SOS_DECOMPO_LEGENDRE``, ``src/SOS_AEROSOLS.F:3924``: forward-peak
truncation, log-linear between the Gauss angles bracketing mu = 0.8 / 0.94,
``inc/SOS.h:166-167``, and projection on Legendre / generalized spherical
functions); ``tests/test_torch_host.py`` pins it to the original.  Host-side
float64 NumPy.

The size-distribution integration (``integrate_granulometry``) needs the Mie
sweep and comes with the Mie port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as cte
from .legendre import alpha_zeta_from, gsf2_table, legendre_table


@dataclasses.dataclass(frozen=True)
class PhaseMatrix:
    """Size-integrated phase matrix on the Mie angle grid + cross sections."""
    p11: np.ndarray      # (D,) signed-axis phase function
    p12: np.ndarray
    p22: np.ndarray
    p33: np.ndarray
    sigma_ext: np.ndarray   # extinction cross-section (micron^2/particle)
    sigma_sca: np.ndarray   # scattering cross-section
    nb_particles: float     # integral of n(r) dr

    @property
    def single_scattering_albedo(self):
        return self.sigma_sca / self.sigma_ext


@dataclasses.dataclass(frozen=True)
class AerosolExpansion:
    """GSF expansion of the (possibly truncated) aerosol phase matrix.

    Coefficient naming follows the reference output (``Aerosols.txt``):
    alpha(k), beta(k), gamma(k), zeta(k) normalized by beta(0); plus the
    truncation coefficient and the single-scattering albedos before/after
    truncation (``src/SOS_PROC.F:481``, ``src/SOS.F:521-543``).
    """
    alpha: np.ndarray
    beta: np.ndarray
    gamma: np.ndarray
    zeta: np.ndarray
    coef_tronca: float
    piz: float           # single-scattering albedo (true)
    piz_tronc: float     # albedo after truncation adjustment
    sigma_ext: float
    sigma_sca: float


def truncate_phase(p11: np.ndarray, mu: np.ndarray, w: np.ndarray):
    """Forward-peak log-linear truncation (``src/SOS_AEROSOLS.F:4030-4087``).

    ``mu``/``w``: positive Mie-grid cosines/weights (ascending).  Returns the
    truncated p11 (signed axis) — the caller checks the resulting truncation
    coefficient against the cancel threshold.
    """
    n = mu.shape[0]
    p11 = np.array(p11)

    # last Gauss (weighted) angle with mu <= threshold, reference indexes the
    # first mu > threshold minus one (:4056-4070)
    def bracket(thr):
        for j in range(n):
            if mu[j] > thr and w[j] != 0.0:
                return j - 1
        return n - 1
    k = bracket(cte.AER_MU1_TRONCA)
    kk = bracket(cte.AER_MU2_TRONCA)

    def pos(j):          # signed-axis index of positive angle j (0-based)
        return n + 1 + j

    aa = (np.log10(p11[pos(kk)]) - np.log10(p11[pos(k)])) \
        / (np.arccos(mu[kk]) - np.arccos(mu[k]))
    x1 = np.log10(p11[pos(kk)])
    x2 = np.arccos(mu[kk])
    for j in range(kk + 1, n):
        coef = x1 + aa * (np.arccos(mu[j]) - x2)
        p11[pos(j)] = 10.0 ** coef
    return p11


def decompose_legendre(phase: PhaseMatrix, mu: np.ndarray, w: np.ndarray,
                       os_nb: int, itronc: bool) -> AerosolExpansion:
    """Truncation + GSF expansion (``SOS_DECOMPO_LEGENDRE``,
    ``src/SOS_AEROSOLS.F:3924-4270``).

    ``mu``/``w``: positive Mie-grid cosines/weights ascending; phase arrays
    are on the signed axis (size 2n+1, center slot unused).
    """
    n = mu.shape[0]
    mu_signed = np.concatenate([-mu[::-1], [0.0], mu])
    w_signed = np.concatenate([w[::-1], [0.0], w])

    ttt = np.array(phase.p11)
    p11 = np.array(phase.p11)

    def project(p11_t):
        pl = legendre_table(mu_signed, os_nb)
        beta11 = (pl * (w_signed * p11_t)).sum(axis=1)
        return beta11 * (2 * np.arange(os_nb + 1) + 1.0) * 0.5

    applied_tronc = bool(itronc)
    if applied_tronc:
        p11 = truncate_phase(p11, mu, w)
    beta11 = project(p11)
    if applied_tronc:
        coef_tronca = 2.0 * (1.0 - beta11[0])
        if coef_tronca < cte.PH_SEUIL_TRONCA:
            # truncation auto-cancel (:4125-4152)
            applied_tronc = False
            p11 = np.array(ttt)
            beta11 = project(p11)
            coef_tronca = 0.0
    else:
        coef_tronca = 0.0

    ratio = np.divide(p11, ttt, out=np.ones_like(p11), where=ttt != 0.0)
    pl = legendre_table(mu_signed, os_nb)
    pol = gsf2_table(mu_signed, os_nb)
    ll = 2 * np.arange(os_nb + 1) + 1.0

    gamma12 = (pol * (w_signed * phase.p12 * ratio)).sum(axis=1) * ll * 0.5
    beta22 = (pl * (w_signed * phase.p22 * ratio)).sum(axis=1) * ll * 0.5
    delta33 = (pl * (w_signed * phase.p33 * ratio)).sum(axis=1) * ll * 0.5

    # alpha(k), zeta(k) from beta22/delta33 (:4279-4304)
    alp, zet = alpha_zeta_from(beta22, delta33)

    z1 = beta11[0]
    piz = phase.single_scattering_albedo
    coef = coef_tronca if applied_tronc else 0.0
    # truncated-atmosphere albedo: piz' = piz(1-A/2)/(1-piz*A/2)
    # (the profile rescaling of src/SOS.F:521-543 uses piz and piztr)
    piz_tronc = piz * (1.0 - coef / 2.0) / (1.0 - piz * coef / 2.0)
    return AerosolExpansion(
        alpha=alp / z1, beta=beta11 / z1, gamma=gamma12 / z1, zeta=zet / z1,
        coef_tronca=float(coef), piz=float(piz), piz_tronc=float(piz_tronc),
        sigma_ext=float(phase.sigma_ext), sigma_sca=float(phase.sigma_sca))
