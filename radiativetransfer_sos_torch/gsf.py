"""Generalized spherical functions PSL/RSL/TSL for all Fourier orders.

Re-design of the GSF part of reference ``SOS_NOYAUX`` (``src/SOS_OS.F:1857``,
initialisations ``:1966-2052``, L-recurrence ``:2058-2100``).

Copy of the JAX package's ``gsf.py`` (NumPy, float64, host side);
``tests/test_torch_host.py`` pins it to the original.  The whole basis tensor
``(n_fourier, L+1, n_dirs)`` is evaluated once per angle grid and the per-IS
phase kernels become einsums over it (``kernels.py``).

Direction layout ("signed axis"): index ``d`` in ``[0, 2N]`` maps to the
reference's signed Gauss index ``j = d - N`` (``RMU(-N..N)``), with the center
slot ``d = N`` holding the solar direction ``mu_s = RMU(0) < 0``
(``src/SOS_OS.F:712-715``).

Parity: for j > 0, ``PSL(L,-j) = (-1)**(L+IS) PSL(L,j)`` (same for RSL) and
``TSL(L,-j) = -(-1)**(L+IS) TSL(L,j)``, which reproduces both the explicit
init values and the alternating ``IG`` factor of the reference recurrence
(``src/SOS_OS.F:2064-2099``).
"""

from __future__ import annotations

import numpy as np


def _init_rows(is_order: int, c: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Initial GSF rows for one Fourier order at cosines ``c`` (c[0]=solar).

    Returns (psl, rsl, tsl) of shape (k+1, Nc) where k = max(2, IS) is the last
    initialised row, plus k.  Transcribes ``src/SOS_OS.F:1966-2052`` including
    the solar-slot (J=0) overwrite order, which makes the solar column the
    plain evaluation at mu_s for every IS.
    """
    nc = c.shape[0]
    k = max(2, is_order)
    psl = np.zeros((k + 1, nc))
    rsl = np.zeros((k + 1, nc))
    tsl = np.zeros((k + 1, nc))
    x26 = 2.0 * np.sqrt(6.0)

    if is_order == 0:                                   # src/SOS_OS.F:1970-1992
        psl[0] = 1.0
        psl[1] = c
        psl[2] = (3.0 * c * c - 1.0) * 0.5
        rsl[2] = 3.0 * (1.0 - c * c) / x26
    elif is_order == 1:                                 # src/SOS_OS.F:1997-2022
        x = 1.0 - c * c
        psl[1] = np.sqrt(x * 0.5)
        psl[2] = c * psl[1] * np.sqrt(3.0)
        rsl[2] = -c * np.sqrt(x) * 0.5
        tsl[2] = -np.sqrt(x) * 0.5
    else:                                               # src/SOS_OS.F:2027-2052
        a = 1.0
        for i in range(1, is_order + 1):
            a = a * np.sqrt((i + is_order) / float(i)) * 0.5
        b = a * np.sqrt(is_order / (is_order + 1.0)) \
              * np.sqrt((is_order - 1.0) / (is_order + 2.0))
        xx = 1.0 - c * c
        yy = is_order * 0.5 - 1.0
        psl[is_order] = a * xx ** (is_order * 0.5)
        rsl[is_order] = b * (1.0 + c * c) * xx ** yy
        tsl[is_order] = 2.0 * b * c * xx ** yy
    return psl, rsl, tsl, k


def gsf_positive(is_order: int, c: np.ndarray, nb_l: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PSL/RSL/TSL rows 0..nb_l at cosines ``c`` (solar first) for one IS.

    L-recurrence per ``src/SOS_OS.F:2058-2100``; rows below the first
    initialised order are zero (they are excluded from every kernel sum,
    which starts at L = IS, ``src/SOS_OS.F:2134``).
    """
    psl0, rsl0, tsl0, k = _init_rows(is_order, c)
    nc = c.shape[0]
    psl = np.zeros((nb_l + 1, nc))
    rsl = np.zeros((nb_l + 1, nc))
    tsl = np.zeros((nb_l + 1, nc))
    top = min(k, nb_l)
    psl[: top + 1] = psl0[: top + 1]
    rsl[: top + 1] = rsl0[: top + 1]
    tsl[: top + 1] = tsl0[: top + 1]

    s = is_order
    for l in range(k, nb_l):
        lp, lm = l + 1, l - 1
        a = (2 * l + 1.0) / np.sqrt((l + s + 1.0) * (l - s + 1.0))
        b = np.sqrt(float((l + s) * (l - s))) / (2.0 * l + 1.0)
        d = (l + 1.0) * (2 * l + 1.0) / np.sqrt(
            (l + 3.0) * (l - 1.0) * (l + s + 1.0) * (l - s + 1.0))
        e = np.sqrt((l + 2.0) * (l - 2.0) * (l + s) * (l - s)) / (l * (2.0 * l + 1.0))
        f = 2.0 * s / (l * (l + 1.0))
        psl[lp] = a * (c * psl[l] - b * psl[lm])
        rsl[lp] = d * (c * rsl[l] - f * tsl[l] - e * rsl[lm])
        tsl[lp] = d * (c * tsl[l] - f * rsl[l] - e * tsl[lm])
    return psl, rsl, tsl


def gsf_signed(is_order: int, mu_pos: np.ndarray, mus: float, nb_l: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full signed-axis GSF tables of shape (nb_l+1, 2N+1) for one IS.

    Axis layout: ``[:, N+j] = f(mu_j)`` for j=1..N, ``[:, N] = f(mu_s)``
    (solar), ``[:, N-j] = parity * f(mu_j)``.
    """
    n = mu_pos.shape[0]
    c = np.concatenate([[mus], mu_pos])
    psl_p, rsl_p, tsl_p = gsf_positive(is_order, c, nb_l)

    ll = np.arange(nb_l + 1)
    parity = np.where((ll + is_order) % 2 == 0, 1.0, -1.0)[:, None]

    def full(f, sign_neg):
        out = np.zeros((nb_l + 1, 2 * n + 1))
        out[:, n] = f[:, 0]
        out[:, n + 1:] = f[:, 1:]
        out[:, n - 1:: -1] = sign_neg * f[:, 1:]
        return out

    return (full(psl_p, parity), full(rsl_p, parity), full(tsl_p, -parity))


def gsf_basis(mu_pos: np.ndarray, mus: float, nb_l: int, n_fourier: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked GSF basis for IS = 0..n_fourier-1.

    Returns three arrays of shape (n_fourier, nb_l+1, 2N+1).  This is the
    constant tensor from which every Fourier phase kernel of the solver is a
    matmul (replaces per-IS calls to ``SOS_NOYAUX``, ``src/SOS_OS.F:949``).
    """
    tables = [gsf_signed(s, mu_pos, mus, nb_l) for s in range(n_fourier)]
    psl = np.stack([t[0] for t in tables])
    rsl = np.stack([t[1] for t in tables])
    tsl = np.stack([t[2] for t in tables])
    return psl, rsl, tsl
