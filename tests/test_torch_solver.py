"""The port's solver in float64 on the CPU against the JAX package's
``solve_fourier_batch_jit`` in float64 on the CPU, on small
``precision.demo_problem`` shapes.

Tolerance: records at rtol 1e-10 (plus 1e-14 of the largest record for
the exact zeros of the signed axis); the JAX solver is held to its oracle at
the same level, and the two differ only in summation order (associative
scan vs sequential recurrence).  The per-order iteration counts and stop
reasons must be equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiativetransfer_sos_torch import precision as tp
from radiativetransfer_sos_torch import solver as ts
from radiativetransfer_sos_tpu import precision as jp
from radiativetransfer_sos_tpu import solver as js
from torch_parity import RTOL_F64, to_np, tt

RTOL_REC = 1e-10

#: (n_gauss, nt, os_nb, n_terms, rho, igmax)
PROBLEMS = {
    "three-terms": (5, 60, 10, 3, 0.1, 30),
    "black-ground-igmax": (4, 40, 8, 1, 0.0, 4),
    "bright-ground": (6, 80, 12, 2, 0.3, 30),
}


def _rec_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL_REC,
        atol=1e-14 * float(np.max(np.abs(want))))


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def solved(request):
    n_gauss, nt, os_nb, n_terms, rho, igmax = PROBLEMS[request.param]
    kw = dict(n_gauss=n_gauss, nt=nt, os_nb=os_nb, igmax=igmax,
              n_terms=n_terms, rho=rho)
    jprob = jp.demo_problem(jnp.float64, **kw)
    want = js.solve_fourier_batch_jit(jprob.inp, jprob.opt)
    inp = ts.inputs_from_numpy(jprob.inp, device="cpu", dtype=torch.float64)
    got = ts.solve_fourier_batch(inp, ts.SolveOptions(igmax=igmax))
    return kw, jprob, got, want


def test_solve_matches_jax(solved):
    kw, _, got, want = solved
    _rec_close(to_np(got.i3bnd), want.i3bnd)
    _rec_close(to_np(got.i3z), want.i3z)
    _rec_close(to_np(got.emoins), want.emoins)
    _rec_close(to_np(got.eplus), want.eplus)
    np.testing.assert_array_equal(to_np(got.ig_last), want.ig_last)
    np.testing.assert_array_equal(to_np(got.stop_code), want.stop_code)
    assert got.i3bnd.dtype == torch.float64
    assert got.i3bnd.shape == want.i3bnd.shape


def test_fourier_stop_mask_matches_jax(solved):
    _, _, got, want = solved
    mask_t = to_np(ts.fourier_stop_mask(got.i3bnd))
    mask_j = np.asarray(jax.vmap(js.fourier_stop_mask)(want.i3bnd))
    np.testing.assert_array_equal(mask_t, mask_j)
    # one (S, 3, D) record set, as the JAX function takes it
    np.testing.assert_array_equal(
        to_np(ts.fourier_stop_mask(got.i3bnd[0])), mask_j[0])


def test_port_demo_problem_matches_jax(solved):
    """``precision.demo_problem`` built from the port's own modules gives
    the JAX package's operands."""
    kw, jprob, _, _ = solved
    prob = tp.demo_problem(torch.float64, "cpu", **kw)
    for name in ("h", "xdel", "ydel", "mu_pos", "w_pos", "tab"):
        np.testing.assert_array_equal(to_np(getattr(prob.inp, name)),
                                      np.asarray(getattr(jprob.inp, name)))
    for name in ("k_aer", "k_mol"):
        want = np.asarray(getattr(jprob.inp, name))
        np.testing.assert_allclose(to_np(getattr(prob.inp, name)), want,
                                   rtol=0.0,
                                   atol=RTOL_F64 * np.max(np.abs(want)))
    assert prob.inp.n0 == jprob.inp.n0
    assert prob.opt.igmax == jprob.opt.igmax


def test_rel_err_metric():
    a = np.array([1.0, 2e-7, -3.0])
    b = np.array([1.1, 1e-7, -3.0])
    assert tp.rel_err(a, b) == jp.rel_err(a, b)
    assert tp.REL_FLOOR == jp.REL_FLOOR


def test_float32_solve_on_cpu_close_to_float64():
    """The working float32 path (plain versions on the CPU) stays within
    the port's loose float32 sanity bound of 5e-3 (``chip_smoke.py``)."""
    kw = dict(n_gauss=5, nt=60, os_nb=10, igmax=30, n_terms=2)
    r32 = ts.solve_fourier_batch(*tp.demo_problem(torch.float32, "cpu",
                                                  **kw)[:2])
    r64 = ts.solve_fourier_batch(*tp.demo_problem(torch.float64, "cpu",
                                                  **kw)[:2])
    assert r32.i3bnd.dtype == torch.float32
    assert tp.rel_err(to_np(r32.i3bnd).astype(np.float64),
                      to_np(r64.i3bnd)) < 5e-3


@pytest.mark.parametrize("branch", ["imat_surf", "ifresnel", "use_zout",
                                    "n0_col", "rmat"])
def test_unported_branches_raise(branch):
    prob = tp.demo_problem(torch.float64, "cpu", n_gauss=3, nt=20, os_nb=4,
                           n_terms=1)
    inp, opt = prob.inp, prob.opt
    if branch in ("imat_surf", "ifresnel", "use_zout"):
        opt = opt._replace(**{branch: True})
    elif branch == "n0_col":
        inp = inp._replace(n0_col=torch.tensor([3]))
    else:
        n_s, n = inp.k_aer.shape[0], inp.mu_pos.shape[0]
        inp = inp._replace(surface=inp.surface._replace(
            rmat=torch.zeros((n_s, 3, 3, n, n), dtype=torch.float64)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.solve_fourier_batch(inp, opt)


def test_inputs_from_numpy_places_and_casts():
    jprob = jp.demo_problem(jnp.float64, n_gauss=3, nt=20, os_nb=4,
                            n_terms=2)
    inp = ts.inputs_from_numpy(jprob.inp, device="cpu", dtype=torch.float32)
    assert inp.h.dtype == torch.float32 and inp.h.shape == (2, 21)
    assert inp.surface.rho.dtype == torch.float32
    assert inp.surface.rmat is None and inp.n0_col is None
    np.testing.assert_allclose(to_np(inp.k_aer), np.asarray(jprob.inp.k_aer),
                               rtol=1e-6, atol=1e-6)
    assert tt(np.ones(2)).dtype == torch.float64
