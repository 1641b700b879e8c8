"""The port's hot-path ops (``radiativetransfer_sos_torch.ops``) against the
JAX package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_pallas_sweep.py`` runs them.

The port keeps the physical layout (HP = 3N lanes, L = NT+1 levels, any
number of instances); the JAX kernels want the TPU layout (128-lane
hemispheres, 128-level chunks, 8-instance blocks).  Each test pads the
port's operands to the TPU layout for JAX and strips the padding from JAX's
outputs before comparing.

On the CPU the wrappers take their plain PyTorch versions; the
hand-written kernels are held to those plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from radiativetransfer_sos_torch import ops
from radiativetransfer_sos_tpu import pallas_ops
from radiativetransfer_sos_tpu.solver import _sweep_flat_scan
from torch_parity import RTOL_F64, scatter_case, sweep_case, to_np, tt

_LANES = 128


def _pad_to(a, axis, size):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - a.shape[axis])
    return np.pad(a, pad)


# ---------------------------------------------------------------------------
# scatter
# ---------------------------------------------------------------------------

def _scatter_jax(up, dn, xdel, ydel, mboth):
    """Port-layout operands -> pallas_ops.scatter_fused(interpret=True) ->
    port-layout (src_up, src_dn)."""
    s_n, t_n, l_n, hp = up.shape
    lp = pallas_ops.pad_levels(l_n - 1)
    b_n = s_n * t_n

    def field(a):
        a = _pad_to(_pad_to(a.reshape(b_n, l_n, hp), 1, lp), 2, _LANES)
        return jnp.asarray(a, jnp.float32)

    xy = np.stack([np.broadcast_to(xdel, (s_n, t_n, l_n)),
                   np.broadcast_to(ydel, (s_n, t_n, l_n))], axis=-1)
    xy = _pad_to(xy.reshape(b_n, l_n, 2), 1, lp)
    m = mboth.reshape(s_n, 4, hp, 2, hp)
    m = _pad_to(_pad_to(m, 2, _LANES), 4, _LANES).reshape(
        s_n, 4 * _LANES, 2 * _LANES)
    su, sd = pallas_ops.scatter_fused(
        field(up), field(dn), jnp.asarray(xy, jnp.float32),
        jnp.asarray(m, jnp.float32), t_n // pallas_ops._IB,
        precision=lax.Precision.HIGHEST, interpret=True)
    cut = (slice(None), slice(0, l_n), slice(0, hp))
    return tuple(np.asarray(a)[cut].reshape(s_n, t_n, l_n, hp)
                 for a in (su, sd))


@pytest.mark.parametrize("s_n,t_n,l_n,n", [(2, 8, 101, 10), (3, 8, 37, 7)])
def test_scatter_plain_matches_pallas_interpret(s_n, t_n, l_n, n):
    """At ``tests/test_pallas_sweep.py``'s float32 tolerance (rtol 2e-5,
    atol 2e-4 on unit-normal operands, HIGHEST-precision matmuls)."""
    args = scatter_case(s_n * 100 + l_n, s_n, t_n, l_n, 3 * n,
                        dtype=np.float32)
    got = ops.scatter(*(tt(a, torch.float32) for a in args))
    want = _scatter_jax(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), w, rtol=2e-5, atol=2e-4)


def test_scatter_plain_float64_is_the_mixed_matmul():
    """Float64: the plain version equals the explicit mix + per-order
    product to rounding (one term count that is not a multiple of 8)."""
    up, dn, x, y, m = scatter_case(5, 3, 5, 23, 18)
    su, sd = ops.scatter(tt(up), tt(dn), tt(x), tt(y), tt(m))
    f2 = np.concatenate([x[None, :, :, None] * up, x[None, :, :, None] * dn,
                         y[None, :, :, None] * up, y[None, :, :, None] * dn],
                        axis=-1)
    want = np.einsum("stlk,skj->stlj", f2, m)
    got = np.concatenate([to_np(su), to_np(sd)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=RTOL_F64 * np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

def _sweep_ref(h, muh, src_up, src_dn, bc, dtype):
    """``solver._sweep_flat_scan`` (associative scan) per instance, in
    ``dtype``; returns (up, dn) in the port layout."""
    s_n, t_n, l_n, hp = src_up.shape
    h_b = np.broadcast_to(h[None], (s_n, t_n, l_n)).reshape(-1, l_n)
    src = np.concatenate([src_up, src_dn], axis=-1).reshape(-1, l_n, 2 * hp)
    out = jax.vmap(_sweep_flat_scan, in_axes=(0, None, 0, 0))(
        jnp.asarray(h_b, dtype), jnp.asarray(muh, dtype),
        jnp.asarray(src, dtype), jnp.asarray(bc.reshape(-1, hp), dtype))
    out = np.asarray(out).reshape(s_n, t_n, l_n, 2 * hp)
    return out[..., :hp], out[..., hp:]


def _sweep_pallas(h, muh, src_up, src_dn, bc):
    """pallas_ops.sweep_scan_batched(interpret=True) through the TPU
    padding conventions, back in the port layout."""
    s_n, t_n, l_n, hp = src_up.shape
    nt = l_n - 1
    lp = pallas_ops.pad_levels(nt)
    b_n = s_n * t_n
    bp = -(-b_n // pallas_ops._IB) * pallas_ops._IB
    h_b = np.broadcast_to(h[None], (s_n, t_n, l_n)).reshape(b_n, l_n)
    h_b = np.pad(h_b, ((0, bp - b_n), (0, lp - l_n)), mode="edge")

    def field(a):
        a = _pad_to(_pad_to(_pad_to(a.reshape(b_n, l_n, hp), 0, bp), 1, lp),
                    2, _LANES)
        return jnp.asarray(a, jnp.float32)

    muh_p = np.concatenate([muh, np.ones(_LANES - hp)])
    bc_p = _pad_to(_pad_to(bc.reshape(b_n, hp), 0, bp), 1, _LANES)
    up, dn = pallas_ops.sweep_scan_batched(
        field(src_up), field(src_dn),
        pallas_ops.sweep_coeffs(jnp.asarray(h_b, jnp.float32), nt),
        jnp.asarray(muh_p, jnp.float32), jnp.asarray(bc_p, jnp.float32), nt,
        interpret=True)
    cut = (slice(0, b_n), slice(0, l_n), slice(0, hp))
    return tuple(np.asarray(a)[cut].reshape(s_n, t_n, l_n, hp)
                 for a in (up, dn))


def _port_sweep(h, muh, src_up, src_dn, bc, dtype):
    h_t = tt(h, dtype)
    up, dn = ops.sweep(tt(src_up, dtype), tt(src_dn, dtype),
                       ops.sweep_coeffs(h_t), tt(muh, dtype), tt(bc, dtype))
    return to_np(up), to_np(dn)


SWEEP_CASES = {
    "one-layer": (1, 1, 2, 12, ()),
    "ragged": (2, 3, 8, 21, ()),
    "profile": (1, 2, 121, 33, ()),
    "zero-thickness": (2, 3, 120, 21, (0, 40, 41, 42) + tuple(range(90, 119))),
}


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_sweep_plain_as_accurate_as_float32_scan(name):
    """``tests/test_pallas_sweep.py``'s rule: against the float64 scan, the
    port's float32 sweep and the Pallas kernel (interpret mode) must each be
    within a small factor of the float32 associative scan's own error."""
    s_n, t_n, l_n, hp, zl = SWEEP_CASES[name]
    case = sweep_case(len(name), s_n, t_n, l_n, hp, zl, dtype=np.float32)
    want = np.concatenate(_sweep_ref(*case, jnp.float64), axis=-1)
    scan32 = np.concatenate(_sweep_ref(*case, jnp.float32), axis=-1)
    err_scan = np.max(np.abs(scan32 - want))
    got = np.concatenate(_port_sweep(*case, torch.float32), axis=-1)
    assert np.max(np.abs(got - want)) <= 4.0 * err_scan + 1e-6
    pallas = np.concatenate(_sweep_pallas(*case), axis=-1)
    assert np.max(np.abs(pallas - want)) <= 4.0 * err_scan + 1e-6


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_sweep_plain_float64_matches_scan(name):
    """Float64: the sequential recurrence equals the associative scan to
    rounding; zero-thickness layers are exact identity steps."""
    s_n, t_n, l_n, hp, zl = SWEEP_CASES[name]
    case = sweep_case(len(name) + 7, s_n, t_n, l_n, hp, zl)
    up, dn = _port_sweep(*case, torch.float64)
    w_up, w_dn = _sweep_ref(*case, jnp.float64)
    scale = max(np.max(np.abs(w_up)), np.max(np.abs(w_dn)))
    np.testing.assert_allclose(up, w_up, rtol=0.0, atol=RTOL_F64 * scale)
    np.testing.assert_allclose(dn, w_dn, rtol=0.0, atol=RTOL_F64 * scale)
    assert np.all(dn[:, :, 0] == 0.0)
    np.testing.assert_array_equal(up[:, :, -1], case[4])
    for j in zl:                       # layer j joins levels j and j+1
        np.testing.assert_array_equal(dn[:, :, j + 1], dn[:, :, j])
        np.testing.assert_array_equal(up[:, :, j], up[:, :, j + 1])


def test_sweep_coeffs_match_pallas_ops():
    h = sweep_case(3, 1, 4, 50, 6, (10, 11, 48))[0]
    got = to_np(ops.sweep_coeffs(tt(h)))
    want = np.asarray(pallas_ops.sweep_coeffs(jnp.asarray(h), h.shape[1] - 1))
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 1, 2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.scatter(x, x, x[0, 0], x[0, 0], x)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.sweep(x, x, x, x, x)
