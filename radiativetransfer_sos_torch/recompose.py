"""Azimuth recomposition of the Fourier-decomposed Stokes field + outputs.

Copy of the NumPy half of the JAX package's ``recompose.py``
(reference ``SOS_TRPHI`` / ``SOS_TRPHI_OPTION`` / ``SOS_POLAR``,
``src/SOS_TRPHI.F:285,749,1843``); ``tests/test_torch_host.py`` pins it to
the original.  ``I(mu,phi) = I_0 + 2 sum_s I_s cos(s phi)`` (U with sin) is
one (n_phi x S) x (S x 3D) product on the stacked Fourier records.

The analytic sun-reflection add-back terms of the non-Lambertian surfaces
(glitter, Fresnel, Roujean, BPDF) come with the surface port (ROADMAP A7);
:func:`add_direct_terms` raises when one is requested.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import constants as cte


class DirectTerms(NamedTuple):
    """Which analytic sun-reflection terms to add back after recomposition.

    Mirrors the flag set of ``SOS_TRPHI`` (``src/SOS_TRPHI.F:749``).
    """
    igli: bool = False
    ifresnel: bool = False
    iroujean: bool = False
    irondeaux: bool = False
    ibreon: bool = False
    inadal: bool = False
    imaignan: bool = False
    wind: float = 0.0
    ind_surf: float = 1.34
    k0: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    alpha_nadal: float = 0.0
    beta_nadal: float = 0.0
    coef_c_maignan: float = 0.0


def scattering_angles(mu_signed, mus, phi):
    """Scattering angle (deg) per signed direction (``src/SOS_TRPHI.F:886-896``).

    ``C0 = RMU(N0) > 0`` in the reference; ``mus`` here is the (negative)
    incidence cosine, so ``c0 = -mus``.
    """
    c0 = -mus
    cosdif = -c0 * mu_signed + np.sqrt(1.0 - c0 ** 2) \
        * np.sqrt(np.clip(1.0 - mu_signed ** 2, 0.0, None)) * np.cos(phi)
    return np.degrees(np.arccos(np.clip(cosdif, -1.0, 1.0)))


def recompose_np(records, phi):
    """Fourier -> azimuth: ``records`` (S, 3, D) valid orders only,
    ``phi`` scalar or (P,) radians.  Returns (P, 3, D) (or (3, D) if scalar).

    Reference ``src/SOS_TRPHI.F:908-937``.
    """
    records = np.asarray(records)
    phi_arr = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    s = np.arange(records.shape[0], dtype=np.float64)
    coef = np.where(s == 0, 1.0, 2.0)
    ang = phi_arr[:, None] * s[None, :]
    wc = coef * np.cos(ang)
    # the IS = 0 record enters U unweighted (``XUT(J) = U3(J)``,
    # src/SOS_TRPHI.F:918); higher orders carry 2 sin(s phi)
    ws = np.where(s[None, :] == 0, 1.0, coef * np.sin(ang))
    out_iq = np.einsum("ps,scd->pcd", wc, records[:, :2])
    out_u = np.einsum("ps,scd->pcd", ws, records[:, 2:])
    out = np.concatenate([out_iq, out_u], axis=1)
    if np.ndim(phi) == 0:
        return out[0]
    return out


def add_direct_terms(xit, xqt, xut, mu_pos, n0_idx, mus, tau, tauout, phi,
                     terms: DirectTerms, ipolar: bool = True):
    """Finish the recomposed tables, vectorized over azimuths.

    ``phi``: scalar or (P,) radians; ``xit/xqt/xut``: signed arrays (D,) or
    (P, D) matching ``phi``.  Over a Lambertian ground there is no analytic
    sun-reflection term to add; the numerically negligible values are zeroed
    as the reference does (``src/SOS_TRPHI.F:1207-1218``).  Modified copies
    are returned with the input's shape.
    """
    if any(terms[:7]):
        raise NotImplementedError("direct sun-reflection add-back of "
                                  "non-Lambertian surfaces: ROADMAP A7")
    scalar = np.ndim(phi) == 0
    xit = np.atleast_2d(np.array(xit, dtype=float))              # (P, D)
    xqt = np.atleast_2d(np.array(xqt, dtype=float))
    xut = np.atleast_2d(np.array(xut, dtype=float))
    xit = np.where(xit <= 1.0e-99, 0.0, xit)
    xqt = np.where(np.abs(xqt) < cte.THRESHOLD_Q_U_NULL, 0.0, xqt)
    xut = np.where(np.abs(xut) < cte.THRESHOLD_Q_U_NULL, 0.0, xut)
    if scalar:
        return xit[0], xqt[0], xut[0]
    return xit, xqt, xut


def polar_params(xi, xq, xu):
    """(pol angle deg, pol rate %, polarized intensity) — ``SOS_POLAR``
    (``src/SOS_TRPHI.F:1843``)."""
    xi = np.asarray(xi, dtype=float)
    xq = np.asarray(xq, dtype=float)
    xu = np.asarray(xu, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        xt = np.where(xq != 0.0, xu / np.where(xq == 0.0, 1.0, xq), 0.0)
        at = np.degrees(np.arctan(xt)) / 2.0
        xan = np.where(
            xq > 0.0, at,
            np.where(xq < 0.0, np.where(xu > 0.0, 90.0 + at, -90.0 + at),
                     np.where(xu > 0.0, 45.0,
                              np.where(xu < 0.0, -45.0, cte.VALEUR_INDEF))))
        lpol = np.sqrt(xq * xq + xu * xu)
        tpol = np.where(xi != 0.0,
                        100.0 * lpol / np.where(xi == 0.0, 1.0, xi),
                        cte.VALEUR_INDEF)
    return xan, tpol, lpol
