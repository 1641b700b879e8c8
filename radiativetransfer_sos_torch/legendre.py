"""Shared Legendre / generalized-spherical-function projection helpers.

Used by the aerosol expansion (``SOS_DECOMPO_LEGENDRE``,
``src/SOS_AEROSOLS.F:3924``) and the Fresnel-matrix expansion
(``SOS_MAT_FRESNEL``, ``src/SOS_SURFACE.F:1235``), which share the same
polynomial tables and the same alpha/zeta reconstruction from the beta22 /
delta33 coefficients (``src/SOS_AEROSOLS.F:4279-4304`` ==
``src/SOS_SURFACE.F:1520-1548``).

Copy of the JAX package's ``legendre.py``; ``tests/test_torch_host.py``
pins it to the original.
"""

from __future__ import annotations

import numpy as np


def legendre_table(x: np.ndarray, nb: int) -> np.ndarray:
    """P_l(x) for l = 0..nb, shape (nb+1, len(x))."""
    x = np.asarray(x)
    out = np.zeros((nb + 2,) + x.shape)
    out[0] = 1.0
    out[1] = x
    for k in range(1, nb + 1):
        out[k + 1] = ((2 * k + 1.0) * x * out[k] - k * out[k - 1]) / (k + 1.0)
    return out[: nb + 1]


def gsf2_table(x: np.ndarray, nb: int) -> np.ndarray:
    """Generalized Legendre function P^2_l(x) for l = 0..nb (s = 2 family).

    Recurrence of ``src/SOS_AEROSOLS.F:4230-4246`` / ``src/SOS_SURFACE.F``.
    """
    x = np.asarray(x)
    out = np.zeros((nb + 2,) + x.shape)
    if nb >= 2:
        out[2] = 3.0 * (1.0 - x ** 2) / (2.0 * np.sqrt(6.0))
    for k in range(2, nb + 1):
        d = (2.0 * k + 1.0) / np.sqrt((k + 3.0) * (k - 1.0))
        e = np.sqrt((k + 2.0) * (k - 2.0)) / (2.0 * k + 1.0)
        out[k + 1] = d * (x * out[k] - e * out[k - 1])
    return out[: nb + 1]


def alpha_zeta_from(beta22: np.ndarray, delta33: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """alpha(k), zeta(k) from the beta22/delta33 expansions.

    Exact combination of ``src/SOS_AEROSOLS.F:4279-4304``.
    """
    nb = beta22.shape[0] - 1
    alp = np.zeros(nb + 1)
    zet = np.zeros(nb + 1)
    for i in range(2, nb + 1):
        co1 = 4.0 * (2 * i + 1.0) / i / (i - 1.0) / (i + 1.0) / (i + 2.0)
        co2 = i * (i - 1.0) / ((i + 1.0) * (i + 2.0))
        co3 = co2 * delta33[i]
        co2b = co2 * beta22[i]
        som1 = som2 = som3 = som4 = 0.0
        for j in range(1, i // 2 + 1):
            x2 = (i - 1.0) ** 2 - 3.0 * (2 * j - 1.0) * (i - j)
            som1 += x2 * beta22[i - 2 * j]
            som2 += x2 * delta33[i - 2 * j]
        for j in range(0, (i - 1) // 2 + 1):
            x2 = (i - 1.0) ** 2 - 3.0 * j * (2 * i - 2 * j - 1.0)
            som3 += x2 * beta22[i - 2 * j - 1]
            som4 += x2 * delta33[i - 2 * j - 1]
        zet[i] = co3 - co1 * (som2 - som3)
        alp[i] = co2b - co1 * (som1 - som4)
    return alp, zet
