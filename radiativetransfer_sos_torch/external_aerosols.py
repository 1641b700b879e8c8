"""User-supplied external phase functions (IMOD=4).

Copy of the IMOD=4 half of the JAX package's ``external_aerosols.py``
plus the spline it shares with the CKD interpolation
(``absorption/absprofile.py:_spline_second_derivs``);
``tests/test_torch_host.py`` pins it to the original.

Reference: the IMOD=4 branch of ``SOS_AEROSOLS`` reads a header-tagged ASCII
file — extinction coefficient, scattering coefficient, angle count, then
rows ``angle(deg)  F11  -F12/F11  F22/F11  F33/F11`` — and cubic-spline
resamples each matrix element onto the Mie angle grid
(``src/SOS_AEROSOLS.F:2143-2260``, spline ``SOS_INTERPO_SPLINT :4822``).
User mixtures (IMOD=5) need the Mie sweep and come with the Mie port.
"""

from __future__ import annotations

import numpy as np

from .aerosols import PhaseMatrix


def _spline_second_derivs(x, y):
    """Second derivatives with first-derivative end conditions equal to the
    end-segment secants (``SOS_INTERPO_SPLINT``,
    ``src/SOS_AEROSOLS.F:4880-4886`` + ``SOS_SPLINE :4952``).

    ``x``: (n,); ``y``: (..., n).  Returns (..., n).
    """
    n = x.shape[0]
    d2 = np.zeros_like(y)
    u = np.zeros_like(y)
    dy1 = (y[..., 1] - y[..., 0]) / (x[1] - x[0])
    dyn = (y[..., n - 1] - y[..., n - 2]) / (x[n - 1] - x[n - 2])
    d2[..., 0] = -0.5
    u[..., 0] = (3.0 / (x[1] - x[0])) * ((y[..., 1] - y[..., 0])
                                         / (x[1] - x[0]) - dy1)
    for k in range(1, n - 1):
        sig = (x[k] - x[k - 1]) / (x[k + 1] - x[k - 1])
        p = sig * d2[..., k - 1] + 2.0
        d2[..., k] = (sig - 1.0) / p
        u[..., k] = (6.0 * ((y[..., k + 1] - y[..., k]) / (x[k + 1] - x[k])
                            - (y[..., k] - y[..., k - 1]) / (x[k] - x[k - 1]))
                     / (x[k + 1] - x[k - 1]) - sig * u[..., k - 1]) / p
    qn = 0.5
    un = (3.0 / (x[n - 1] - x[n - 2])) * (dyn - (y[..., n - 1]
                                                 - y[..., n - 2])
                                          / (x[n - 1] - x[n - 2]))
    d2[..., n - 1] = (un - qn * u[..., n - 2]) / (qn * d2[..., n - 2] + 1.0)
    for k in range(n - 2, -1, -1):
        d2[..., k] = d2[..., k] * d2[..., k + 1] + u[..., k]
    return d2


def parse_external_file(path: str):
    """(kmat1, kmat2, ang_deg, f11, f12, f22, f33) from the user file.

    Header lines carry the value after the last ``:``
    (``src/SOS_AEROSOLS.F:2150-2162``); the ratio columns are converted to
    absolute elements ``F12 = -(−F12/F11)·F11`` etc. (``:2200-2206``).
    """
    with open(path) as f:
        kmat1 = float(f.readline().rsplit(":", 1)[1])
        kmat2 = float(f.readline().rsplit(":", 1)[1])
        n = int(f.readline().rsplit(":", 1)[1])
        f.readline()                                  # column header
        rows = np.array([[float(v) for v in f.readline().split()]
                         for _ in range(n)])
    ang = rows[:, 0]
    f11 = rows[:, 1]
    f12 = -rows[:, 2] * f11
    f22 = rows[:, 3] * f11
    f33 = rows[:, 4] * f11
    return kmat1, kmat2, ang, f11, f12, f22, f33


def spline_resample(mu_src: np.ndarray, y: np.ndarray,
                    mu_dst: np.ndarray) -> np.ndarray:
    """Natural-ish cubic spline (secant end conditions) resampling — the
    ``SOS_INTERPO_SPLINT`` scheme shared with the CKD T-interpolation."""
    order = np.argsort(mu_src)
    x = mu_src[order]
    yy = y[order]
    d2 = _spline_second_derivs(x, yy)
    klo = np.clip(np.searchsorted(x, mu_dst, side="right") - 1, 0,
                  x.shape[0] - 2)
    khi = klo + 1
    h = x[khi] - x[klo]
    a = (x[khi] - mu_dst) / h
    b = (mu_dst - x[klo]) / h
    return (a * yy[klo] + b * yy[khi]
            + ((a ** 3 - a) * d2[klo] + (b ** 3 - b) * d2[khi]) * h * h / 6.0)


def external_phase_matrix(path: str, mie_grid) -> PhaseMatrix:
    """PhaseMatrix on the signed Mie axis from a user external-data file."""
    kmat1, kmat2, ang, f11, f12, f22, f33 = parse_external_file(path)
    mu_src = np.cos(np.radians(ang))
    mu_dst = np.concatenate([-mie_grid.mu[::-1], [0.0], mie_grid.mu])
    vals = [spline_resample(mu_src, f, mu_dst) for f in (f11, f12, f22, f33)]
    return PhaseMatrix(p11=vals[0], p12=vals[1], p22=vals[2], p33=vals[3],
                       sigma_ext=np.float64(kmat1), sigma_sca=np.float64(kmat2),
                       nb_particles=1.0)
