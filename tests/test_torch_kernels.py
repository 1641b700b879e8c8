"""Phase kernels (``kernels.py``) and the flat-layout helpers of the solver:
the port in float64 on the CPU against the JAX package in float64.

Tolerance: rtol 1e-12 of the array's largest magnitude — the same einsums
in another summation order (OS_NB ~ 25 terms), so agreement is to a few
ulps of the largest term.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_sos_torch import kernels as tk
from radiativetransfer_sos_torch import solver as ts
from radiativetransfer_sos_tpu import angles, gsf
from radiativetransfer_sos_tpu import kernels as jk
from radiativetransfer_sos_tpu import solver as js
from torch_parity import RTOL_F64, to_np, tt


def _close(got, want, rtol=RTOL_F64):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def basis():
    grid = angles.make_radiance_grid(40.0, 6)
    os_nb = 14
    psl, rsl, tsl = gsf.gsf_basis(grid.mu, grid.mus, os_nb, os_nb + 1)
    ll = np.arange(os_nb + 1)
    rng = np.random.default_rng(3)
    beta = (2 * ll + 1.0) * 0.6 ** ll
    coefs = dict(alpha=np.where(ll >= 2, 0.2 * beta, 0.0), beta=beta,
                 gamma=np.where(ll >= 2, -0.1 * beta, 0.0),
                 zeta=np.where(ll >= 2, 0.05 * beta, 0.0) * rng.random(
                     os_nb + 1))
    return grid, (psl, rsl, tsl), coefs


@pytest.mark.parametrize("ipolar", [True, False])
def test_aerosol_and_molecular_kernels(basis, ipolar):
    grid, b, c = basis
    k_t = to_np(tk.aerosol_kernel(*map(tt, b), c["alpha"], c["beta"],
                                  c["gamma"], c["zeta"], ipolar))
    k_j = jk.aerosol_kernel(*map(jnp.asarray, b), c["alpha"], c["beta"],
                            c["gamma"], c["zeta"], ipolar)
    _close(k_t, k_j)
    m_t = to_np(tk.molecular_kernel(*map(tt, b), 0.0279, ipolar))
    m_j = jk.molecular_kernel(*map(jnp.asarray, b), 0.0279, ipolar)
    _close(m_t, m_j)
    assert np.all(m_t[3:] == 0.0)          # molecular matrix null for IS > 2
    assert tk.molecular_coeffs(0.0279) == jk.molecular_coeffs(0.0279)


def test_block_kernel_per_order_coefficients(basis):
    """(S, L+1) per-order coefficient rows, as the molecular kernel uses."""
    grid, b, c = basis
    s_n, n_l = b[0].shape[:2]
    rng = np.random.default_rng(9)
    coef = [rng.standard_normal((s_n, n_l)) for _ in range(4)]
    got = to_np(tk.block_kernel(*map(tt, b), *coef))
    want = jk.block_kernel(*map(jnp.asarray, b), *map(jnp.asarray, coef))
    _close(got, want)


def test_flat_layout_helpers(basis):
    """Flat operator, solar column and the signed-axis unpacking, against
    the JAX layout with its 128-lane hemisphere padding stripped."""
    grid, b, c = basis
    n = grid.mu.shape[0]
    k = np.asarray(jk.aerosol_kernel(*map(jnp.asarray, b), c["alpha"],
                                     c["beta"], c["gamma"], c["zeta"]))
    hp_j = js._half_pad(n)
    keep = np.concatenate([np.arange(3 * n), hp_j + np.arange(3 * n)])

    m_t = to_np(ts._flat_operator(tt(k), tt(grid.w)))
    m_j = np.asarray(js._flat_operator(jnp.asarray(k), jnp.asarray(grid.w)))
    _close(m_t, m_j[:, keep][:, :, keep])

    col_t = to_np(ts._flat_solar_col(tt(k)))
    col_j = np.asarray(js._flat_solar_col(jnp.asarray(k)))
    _close(col_t, col_j[:, keep])

    rng = np.random.default_rng(1)
    v = rng.standard_normal((4, 6 * n))
    v_j = np.zeros((4, 2 * hp_j))
    v_j[:, keep] = v
    np.testing.assert_array_equal(
        to_np(ts._signed_from_flat(tt(v), n)),
        np.asarray(js._signed_from_flat(jnp.asarray(v_j), n)))
    np.testing.assert_array_equal(
        to_np(ts._mu_half(tt(grid.mu))),
        np.asarray(js._mu_half(jnp.asarray(grid.mu), hp_j,
                               jnp.float64))[:3 * n])


def test_kernels_follow_tensor_device_and_dtype(basis):
    grid, b, c = basis
    k32 = tk.aerosol_kernel(*(tt(a, torch.float32) for a in b), c["alpha"],
                            c["beta"], c["gamma"], c["zeta"])
    assert k32.dtype == torch.float32 and k32.device.type == "cpu"
    k64 = to_np(tk.aerosol_kernel(*map(tt, b), c["alpha"], c["beta"],
                                  c["gamma"], c["zeta"]))
    np.testing.assert_allclose(to_np(k32), k64, rtol=0.0,
                               atol=1e-5 * float(np.max(np.abs(k64))))
