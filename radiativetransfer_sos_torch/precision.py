"""The pinned demo-shape problem and the relative-error metric.

Port of ``demo_problem`` and ``rel_err`` of
the JAX package's ``precision.py``, built from the port's own
modules.  The port's float32 gate on the card is set from its own
measurements; the JAX package's thresholds were sized for the TPU's
bfloat16 matmul passes and do not carry over.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import angles, gsf, kernels, resolve, solver

#: radiances below this (in normalized sr^-1) are noise for the rel-error
#: metric — the reference itself zeroes |Q|,|U| < 1e-15 at output
#: (src/SOS_TRPHI.F:1212-1218) and demo fields are O(1e-2..1e-1)
REL_FLOOR = 1.0e-6


class DemoProblem(NamedTuple):
    inp: solver.SolveInputs     # term-batched
    opt: solver.SolveOptions
    n_terms: int


def demo_problem(dtype=None, device=None, n_gauss: int = 40, nt: int = 600,
                 os_nb: int = 80, igmax: int = 30, n_terms: int = 4,
                 rho: float = 0.1) -> DemoProblem:
    """Pinned demo-shape solve inputs (one CKD term of the reference demo,
    ``exe/runSOS-ABS_demo.ksh`` with ``src/SOS.F:546-550`` bounds).

    Setup math is float64; the GSF basis is cast to ``dtype`` before the
    kernel einsums and every operand lives on ``device``, as in the JAX
    package.  Deterministic: seeded profile jitter.
    """
    device, dtype = resolve(device, dtype)
    grid = angles.make_radiance_grid(35.0, n_gauss=n_gauss)
    psl, rsl, tsl = (torch.as_tensor(a, dtype=dtype, device=device)
                     for a in gsf.gsf_basis(grid.mu, grid.mus, os_nb,
                                            os_nb + 1))
    ll = np.arange(os_nb + 1)
    beta = (2 * ll + 1.0) * 0.7 ** ll
    gamma = np.where(ll >= 2, -0.1 * beta, 0.0)
    alpha = np.where(ll >= 2, 0.2 * beta, 0.0)
    zeta = np.where(ll >= 2, 0.05 * beta, 0.0)
    k_aer = kernels.aerosol_kernel(psl, rsl, tsl, alpha, beta, gamma, zeta)
    k_mol = kernels.molecular_kernel(psl, rsl, tsl, 0.0279)

    h0 = np.linspace(0.0, 1.0, nt + 1) ** 1.2 * 0.5
    rng = np.random.default_rng(0)
    h_b = h0[None, :] * (1.0 + 0.3 * rng.random((n_terms, 1)))
    xdel = np.full((n_terms, nt + 1), 0.45)
    ydel = 1.0 - xdel

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    inp = solver.SolveInputs(
        h=t(h_b), xdel=t(xdel), ydel=t(ydel), k_aer=k_aer, k_mol=k_mol,
        mu_pos=t(grid.mu), w_pos=t(grid.w), tab=t(grid.mus), n0=grid.imus,
        surface=solver.SurfaceInputs(rho=t(rho)))
    opt = solver.SolveOptions(igmax=igmax)
    return DemoProblem(inp=inp, opt=opt, n_terms=n_terms)


def rel_err(a: np.ndarray, b: np.ndarray,
            floor: float = REL_FLOOR) -> float:
    """Worst |a-b| / max(|b|, floor) over the Stokes records."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))
