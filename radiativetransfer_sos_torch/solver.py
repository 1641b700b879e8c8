"""Core successive-orders-of-scattering solver (polarized, plane-parallel).

Port of the all-orders path of the JAX package's ``solver.py``
(reference ``SOS_OS``, ``src/SOS_OS.F:303``):

===============================  =============================================
reference                        here
===============================  =============================================
Fourier loop ``DO IS``           batch axis S — every order solved at once;
                                 the sequential early exit is reproduced
                                 post hoc in :func:`fourier_stop_mask`
``SOS_NOYAUX``                   GSF basis + ``kernels.py`` einsums
``SOS_FSOURCE_ORDRE1``           primary source, inline in ``_solve_st``
``SOS_FSOURCE_ORDREIG``          ``ops.scatter`` (``csrc/scatter.cu``)
``SOS_INTEGR_EPOPT``             ``ops.sweep`` (``csrc/sweep.cu``)
``DO 503`` scattering loop       host loop over IG with per-instance masks
``SOS_PARAM_CONV`` etc.          ``_param_conv`` / stop tests in the loop
``SOS_AJOUT_QUEUE``              ``_queue`` (geometric-series tail)
``SOS_ARRET_FOURIER``            :func:`fourier_stop_mask`
===============================  =============================================

**Flat field layout.**  The radiance field of one (Fourier order, term)
instance is held as two hemisphere halves of shape (NT+1, HP) with
``HP = 3N`` (no lane padding): lanes ``c = s*N + p``, Stokes-major, ``p``
the positive-mu index; the up half holds reference signed index ``j =
p+1``, the down half ``j = -(p+1)``.  ``W = 2 HP`` is the width of a whole
flat record.  The reference's exact solar direction (the signed center slot,
always zero in the diffuse field) is dropped.  Gauss weights and the 1/2
factor of the source integral are folded into the flat operator matrices
once per solve (``_flat_operator``).

The surface-matrix, flat-sea Fresnel, output-altitude and per-term incidence
branches raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import constants as cte
from . import full_precision_matmul, ops, resolve

#: scattering orders between two host reads of the all-done flag; the loop
#: body masks finished instances, so results do not depend on it
DONE_CHECK_EVERY = 4


class SurfaceInputs(NamedTuple):
    """Ground boundary description for one solve (see the JAX package).

    ``rho``: Lambertian albedo, scalar or (T,) per term.  The matrix and
    Fresnel fields exist for signature parity; the port's solver raises
    when they are set (ROADMAP A7).
    """
    rho: torch.Tensor
    rmat: Optional[torch.Tensor] = None
    f11: Optional[torch.Tensor] = None
    f12: Optional[torch.Tensor] = None
    f33: Optional[torch.Tensor] = None
    ind_surf: Optional[torch.Tensor] = None
    rmat_sun: Optional[torch.Tensor] = None


class SolveInputs(NamedTuple):
    h: torch.Tensor          # (T, NT+1) cumulative optical depth, 0 at TOA
    xdel: torch.Tensor       # (T, NT+1) aerosol scattering fraction
    ydel: torch.Tensor       # (T, NT+1) molecular scattering fraction
    k_aer: torch.Tensor      # (S, 3, 3, D, D) aerosol Fourier kernels
    k_mol: torch.Tensor      # (S, 3, 3, D, D) molecular Fourier kernels
    mu_pos: torch.Tensor     # (N,) positive direction cosines
    w_pos: torch.Tensor      # (N,) Gauss weights
    tab: torch.Tensor        # scalar mu_s = -cos(theta_s) < 0, or (T,)
    n0: int                  # 0-based index of the solar angle in mu_pos
    surface: SurfaceInputs = SurfaceInputs(rho=torch.tensor(0.0))
    zprof: Optional[torch.Tensor] = None
    zout_km: Optional[torch.Tensor] = None
    is0: Optional[torch.Tensor] = None      # (S,) 1.0 at absolute IS = 0
    n0_col: Optional[torch.Tensor] = None


class SolveOptions(NamedTuple):
    igmax: int = cte.DEFAULT_IGMAX
    imat_surf: bool = False      # BRDF/BPDF matrices present
    ifresnel: bool = False       # flat-sea Fresnel reflection
    ipolar: bool = True
    use_zout: bool = False       # output at zout_km instead of TOA/ground
    seuil_cv_sg: float = cte.PH_SEUIL_CV_SG
    seuil_sumdif: float = cte.PH_SEUIL_SUMDIF
    seuil_valdif: float = cte.PH_SEUIL_VALDIF
    seuil_sf: float = cte.PH_SEUIL_SF


class FourierResult(NamedTuple):
    """Per-Fourier-order radiances, (T, ...) per term."""
    i3z: torch.Tensor        # (T, S, 3, D) Stokes at the output level(s)
    i3bnd: torch.Tensor      # (T, S, 3, D) Stokes at TOA (+) / ground (-)
    emoins: torch.Tensor     # (T,) downward diffuse flux (IS=0 slice)
    eplus: torch.Tensor      # (T,) upward diffuse flux (IS=0 slice)
    tauout: Optional[torch.Tensor] = None
    # last computed order IG and the stop reason (0 = hit IGMAX,
    # 1 = geometric-series convergence + tail, 2 = |field| < SEUIL_VALDIF,
    # 3 = order/cumulative < SEUIL_SUMDIF), (T, S) int32
    ig_last: Optional[torch.Tensor] = None
    stop_code: Optional[torch.Tensor] = None


def inputs_from_numpy(inp, device=None, dtype=None) -> SolveInputs:
    """The port's :class:`SolveInputs` from any object with the JAX
    package's ``SolveInputs`` fields holding array-likes (numpy or anything
    ``np.asarray`` accepts), placed on ``device`` in ``dtype``.  This is how
    both packages solve the same problem in the tests."""
    device, dtype = resolve(device, dtype)

    def conv(v):
        if v is None:
            return None
        return torch.as_tensor(np.array(v, dtype=np.float64), dtype=dtype,
                               device=device)

    surf = inp.surface
    return SolveInputs(
        h=conv(inp.h), xdel=conv(inp.xdel), ydel=conv(inp.ydel),
        k_aer=conv(inp.k_aer), k_mol=conv(inp.k_mol),
        mu_pos=conv(inp.mu_pos), w_pos=conv(inp.w_pos), tab=conv(inp.tab),
        n0=int(inp.n0),
        surface=SurfaceInputs(**{f: conv(getattr(surf, f))
                                 for f in SurfaceInputs._fields}),
        zprof=conv(inp.zprof), zout_km=conv(inp.zout_km), is0=conv(inp.is0),
        n0_col=(None if inp.n0_col is None else torch.as_tensor(
            np.array(inp.n0_col), device=device)))


# ---------------------------------------------------------------------------
# Flat layout helpers
# ---------------------------------------------------------------------------

def _dir_select(n: int) -> np.ndarray:
    """Signed-axis indices of (up..., down...) in flat ``p`` ordering.

    Signed layout (size D = 2N+1): ``d = N + j``; up ``j = p+1``, down
    ``j = -(p+1)``.
    """
    idx_up = np.arange(1, n + 1) + n
    idx_dn = n - 1 - np.arange(n)
    return np.concatenate([idx_up, idx_dn])


def _signed_from_flat(v, n):
    """(..., W) flat -> (..., 3, D) signed-axis layout (center slot zero)."""
    lead = v.shape[:-1]
    up = v[..., :3 * n].reshape(lead + (3, n))
    dn = v[..., 3 * n:6 * n].reshape(lead + (3, n))
    out = torch.zeros(lead + (3, 2 * n + 1), dtype=v.dtype, device=v.device)
    out[..., n + 1:] = up
    out[..., :n] = dn.flip(-1)
    return out


def _flat_operator(k, w_pos):
    """Block phase kernels -> flat right-multiply operator matrices.

    ``k``: (S, 3, 3, D, D) with index [s, out-Stokes, in-Stokes, out-dir,
    in-dir] on the signed direction axis.  Returns M of shape (S, W, W) such
    that ``src_flat = field_flat @ M[s]`` realises the Gauss-weighted source
    contraction of ``SOS_FSOURCE_ORDREIG`` (``src/SOS_OS.F:2859-2905``),
    i.e. ``M[s][(hb,ti,pb), (ha,so,pa)] = 0.5 * w[pb] * K[s,so,ti,a,b]``.
    """
    s_n = k.shape[0]
    n = (k.shape[-1] - 1) // 2
    sel = torch.as_tensor(_dir_select(n), device=k.device)
    g = k.index_select(3, sel).index_select(4, sel)
    g = g.reshape(s_n, 3, 3, 2, n, 2, n)          # (S, so, ti, ha, pa, hb, pb)
    m = g.permute(0, 5, 2, 6, 3, 1, 4)            # (S, hb, ti, pb, ha, so, pa)
    m = m.reshape(s_n, 2, 3 * n, 2, 3 * n)
    wrow = 0.5 * w_pos.repeat(3).to(k.dtype)
    m = m * wrow[None, None, :, None, None]
    return m.reshape(s_n, 6 * n, 6 * n).contiguous()


def _flat_solar_col(k):
    """Per-order incidence columns ``P[so, 0](dir_out, sun)`` in flat layout:
    (S, 3, 3, D, D) -> (S, W) (``SOS_FSOURCE_ORDRE1``,
    ``src/SOS_OS.F:2431``)."""
    s_n = k.shape[0]
    n = (k.shape[-1] - 1) // 2
    col = k[:, :, 0, :, n]                        # (S, 3, D) over output dirs
    up = col[..., n + 1:].reshape(s_n, 3 * n)
    dn = col[..., :n].flip(-1).reshape(s_n, 3 * n)
    return torch.cat([up, dn], dim=-1)


def _mu_half(mu_pos):
    """Direction cosines along one hemisphere block, (HP,)."""
    return mu_pos.repeat(3).contiguous()


# ---------------------------------------------------------------------------
# Ground boundary conditions (Lambertian)
# ---------------------------------------------------------------------------

def _surface_reflect_st(ground_dn, inp: SolveInputs, is0):
    """Upward ground BC for orders IG >= 2 (``src/SOS_OS.F:1164-1239``),
    batched: ``ground_dn`` (S, T, HP) -> (S, T, HP)."""
    mu, w = inp.mu_pos, inp.w_pos
    n = mu.shape[0]
    gd = ground_dn.reshape(ground_dn.shape[:-1] + (3, n))
    # Lambertian: LSOL = 2 rho sum w mu I_dn(ground) at IS = 0 only
    lsol = (2.0 * inp.surface.rho * torch.sum(w * mu * gd[:, :, 0], dim=-1)
            * is0[:, None])
    bc = torch.zeros_like(gd)
    bc[:, :, 0] = lsol[..., None]
    return bc.reshape(ground_dn.shape)


def _order1_bc_st(inp: SolveInputs, is0, h, tab):
    """Ground BC for the primary interaction (``src/SOS_OS.F:968-992``),
    batched over (S, T): the Lambertian reflection of the attenuated direct
    beam.  ``h``: (T, NT+1); ``tab``: (T,).  Returns (S, T, HP)."""
    n = inp.mu_pos.shape[0]
    xr = -inp.surface.rho * tab * torch.exp(h[:, -1] / tab)    # (T,)
    xr = is0[:, None] * xr[None, :]                            # (S, T)
    bc = torch.zeros(xr.shape + (3, n), dtype=h.dtype, device=h.device)
    bc[:, :, 0] = xr[..., None]
    return bc.reshape(xr.shape + (3 * n,))


# ---------------------------------------------------------------------------
# Convergence machinery (src/SOS_OS.F:3377-3796 and 3871)
# ---------------------------------------------------------------------------

def _safe_div(a, b):
    nz = b != 0.0
    return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)


def _param_conv(a1, d1, g1, i3):
    """Geometric-series convergence parameter (``SOS_PARAM_CONV``),
    per (order, term) instance: (..., W) -> (...)."""
    ok = (a1 != 0.0) & (d1 != 0.0) & (i3 != 0.0)
    q2 = _safe_div(g1, d1)
    q1 = _safe_div(d1, a1)
    den = (1.0 - q2) ** 2
    y = _safe_div(q2 - q1, den) * _safe_div(g1, i3)
    y = torch.where(ok, torch.abs(y), 0.0)
    return torch.amax(y, dim=-1)


def _queue(d1, g1):
    """Geometric tail G1/(1 - G1/D1) (``SOS_AJOUT_QUEUE``)."""
    return torch.where(d1 != 0.0, g1 / (1.0 - _safe_div(g1, d1)), 0.0)


# ---------------------------------------------------------------------------
# The (Fourier order x term) grid: primary interaction + scattering loop
# ---------------------------------------------------------------------------

def _solve_st(mboth, col_a, col_m, is0, h, xdel, ydel, tab,
              inp: SolveInputs, opt: SolveOptions):
    """Solve the IG loop for the whole (S orders x T terms) grid at once.

    The field lives as (up, dn) hemisphere halves of shape (S, T, L, HP);
    the scattering source keeps each order's operator shared across terms
    (``ops.scatter``) and the layer sweep runs on the (S*T) instance axis
    (``ops.sweep``).  Every convergence / stop quantity of the reference's
    per-(IS) scalar machinery (``src/SOS_OS.F:1285-1406``) is an (S, T)
    tensor.  ``h/xdel/ydel``: (T, L); ``tab``: (T,); ``col_a/col_m``:
    (S, W).  Returns ``(i3 (S,T,W), ig_last (S,T), stop_code (S,T))``.
    """
    s_n, t_n = mboth.shape[0], h.shape[0]
    nt = h.shape[1] - 1                          # ground level index
    hp = mboth.shape[-1] // 2
    dtype, device = h.dtype, h.device
    muh = _mu_half(inp.mu_pos)
    coeffs = ops.sweep_coeffs(h)
    xdel = xdel.contiguous()
    ydel = ydel.contiguous()

    def sweep(src_up, src_dn, bc):
        return ops.sweep(src_up, src_dn, coeffs, muh, bc.contiguous())

    def bnd(up, dn):
        return torch.cat([up[:, :, 0], dn[:, :, nt]], dim=-1)

    # ----- order IG = 1 (SOS_FSOURCE_ORDRE1, src/SOS_OS.F:2431) -----
    ch = (torch.exp(h / tab[:, None]) / 4.0)[None, :, :, None]   # (T, L)
    xb, yb = xdel[None, :, :, None], ydel[None, :, :, None]

    def src1(half):
        return (ch * (xb * col_a[:, None, None, half]
                      + yb * col_m[:, None, None, half])).contiguous()

    bc1 = _order1_bc_st(inp, is0, h, tab)
    up, dn = sweep(src1(slice(0, hp)), src1(slice(hp, 2 * hp)), bc1)

    i3 = bnd(up, dn)                                          # (S, T, W)
    d1 = i3
    a1 = torch.zeros_like(i3)
    done = torch.zeros((s_n, t_n), dtype=torch.bool, device=device)
    ig_last = torch.ones((s_n, t_n), dtype=torch.int32, device=device)
    code = torch.zeros((s_n, t_n), dtype=torch.int32, device=device)
    # SEUIL_VALDIF = 1e-50 underflows float32: clamp to the smallest normal
    # so the test keeps its dead-field semantics
    valdif = max(opt.seuil_valdif, float(torch.finfo(dtype).tiny))

    # the reference's DO 503 loop; the (S, T) grid advances until its
    # slowest instance is done, finished instances stay masked
    for ig in range(2, opt.igmax + 1):
        src_up, src_dn = ops.scatter(up, dn, xdel, ydel, mboth)
        bc = _surface_reflect_st(dn[:, :, nt], inp, is0)
        up, dn = sweep(src_up, src_dn, bc)
        del src_up, src_dn
        g1 = bnd(up, dn)                                      # (S, T, W)

        # geometric-series test, skipped at IG == 2 (src/SOS_OS.F:1285-1293)
        if ig > 2:
            conv = (_param_conv(a1, d1, g1, i3) <= opt.seuil_cv_sg) & ~done
        else:
            conv = torch.zeros_like(done)
        active = ~done & ~conv
        c_w = conv[..., None]
        a_w = active[..., None]

        # converged: add the geometric tail, stop (src/SOS_OS.F:1299-1315);
        # not converged: accumulate order IG (src/SOS_OS.F:1343-1363)
        i3_n = torch.where(c_w, i3 + _queue(d1, g1),
                           torch.where(a_w, i3 + g1, i3))

        # stop tests on the order-IG magnitude (src/SOS_OS.F:1368-1406)
        stop_abs = torch.amax(torch.abs(g1), dim=-1) <= valdif
        z_rel = torch.amax(torch.where(i3_n != 0.0,
                                       torch.abs(_safe_div(g1, i3_n)), 0.0),
                           dim=-1)
        stop_rel = z_rel <= opt.seuil_sumdif
        done_n = done | conv | (active & (stop_abs | stop_rel))

        code_n = torch.where(
            conv, 1, torch.where(active & stop_abs, 2,
                                 torch.where(active & stop_rel, 3, 0)))
        code = torch.where(~done & done_n, code_n.to(torch.int32), code)
        ig_last = torch.where(~done, ig, ig_last)

        a1 = torch.where(a_w, d1, a1)
        d1 = torch.where(a_w, g1, d1)
        i3 = i3_n
        done = done_n
        if (ig - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
    return i3, ig_last, code


def _unsupported(inp: SolveInputs, opt: SolveOptions) -> None:
    """Raise for the solver branches this port has not reached yet."""
    if opt.imat_surf or inp.surface.rmat is not None \
            or inp.surface.rmat_sun is not None:
        raise NotImplementedError("surface reflection matrices (BRDF/BPDF/"
                                  "glitter) in the solver: ROADMAP A7")
    if opt.ifresnel:
        raise NotImplementedError("flat-sea Fresnel ground: ROADMAP A7")
    if opt.use_zout or inp.zout_km is not None:
        raise NotImplementedError("output altitude (zout): ROADMAP A10")
    if inp.n0_col is not None:
        raise NotImplementedError("per-term incidence directions "
                                  "(transmissions): ROADMAP A10")


def solve_fourier_batch(inp: SolveInputs, opt: SolveOptions) -> FourierResult:
    """Multi-profile solve: ``h/xdel/ydel`` carry a leading term axis T;
    kernels and surface are shared.  Every Fourier order is solved at once
    on the explicit (S orders x T terms) grid.  Results have shape (T, ...).
    The solve runs on the device and in the dtype of ``inp.h``.
    """
    _unsupported(inp, opt)
    full_precision_matmul()
    h = inp.h
    t_n = h.shape[0]
    n_s = inp.k_aer.shape[0]
    n = inp.mu_pos.shape[0]
    hp = 3 * n
    if inp.is0 is not None:
        is0 = inp.is0.to(h.dtype)
    else:
        is0 = torch.zeros(n_s, dtype=h.dtype, device=h.device)
        is0[0] = 1.0

    # flat operators, built once per solve (Gauss weights + 1/2 folded in)
    mboth = torch.cat([_flat_operator(inp.k_aer, inp.w_pos),
                       _flat_operator(inp.k_mol, inp.w_pos)],
                      dim=-2).contiguous()                  # (S, 2W, W)
    col_a = _flat_solar_col(inp.k_aer)
    col_m = _flat_solar_col(inp.k_mol)
    tab = inp.tab if inp.tab.ndim == 1 else inp.tab.expand(t_n)

    i3, ig_last, stop_code = _solve_st(mboth, col_a, col_m, is0, h,
                                       inp.xdel, inp.ydel, tab, inp, opt)
    i3 = i3.transpose(0, 1)                                  # (T, S, W)

    # diffuse fluxes at IS = 0 (src/SOS_OS.F:1447-1456), per term
    up0 = i3[:, 0, :n]                             # I rows of each half
    dn0 = i3[:, 0, hp:hp + n]
    wmu = inp.mu_pos * inp.w_pos
    emoins = -2.0 / tab * torch.sum(wmu * dn0, dim=-1)
    eplus = -2.0 / tab * torch.sum(wmu * up0, dim=-1)

    # default output levels: TOA for up, ground for down
    # (src/SOS_OS.F:1484-1506) -- exactly the boundary accumulator
    i3bnd = _signed_from_flat(i3, n)                         # (T, S, 3, D)
    return FourierResult(i3z=i3bnd, i3bnd=i3bnd, emoins=emoins, eplus=eplus,
                         tauout=torch.zeros(t_n, dtype=h.dtype,
                                            device=h.device),
                         ig_last=ig_last.transpose(0, 1),
                         stop_code=stop_code.transpose(0, 1))


def fourier_stop_mask(i3bnd, seuil_sf: float = cte.PH_SEUIL_SF):
    """Replicates the sequential Fourier early exit, post hoc.

    The reference accumulates ``I4 += coef*I3`` / ``I5 += coef*sign*I3`` per
    order and leaves the IS loop at the first order whose relative
    contribution drops below ``seuil_sf`` (``SOS_ARRET_FOURIER``,
    ``src/SOS_OS.F:3709-3796``; exit ``:1580-1589``).  ``i3bnd``:
    (..., S, 3, D).  Returns a boolean mask (..., S) selecting exactly the
    orders the reference would have produced.
    """
    n_s = i3bnd.shape[-3]
    s = torch.arange(n_s, device=i3bnd.device)
    coef = torch.where(s == 0, 1.0, 2.0).to(i3bnd.dtype)[:, None, None]
    sign = torch.where(s % 2 == 0, 1.0, -1.0).to(i3bnd.dtype)[:, None, None]
    i4 = torch.cumsum(coef * i3bnd, dim=-3)
    i5 = torch.cumsum(coef * sign * i3bnd, dim=-3)

    def ratios(den):
        r = torch.where(den != 0.0, torch.abs(_safe_div(i3bnd, den)), 0.0)
        return torch.amax(r.flatten(-2), dim=-1)

    z1 = torch.maximum(ratios(i4), ratios(i5))
    passed = z1 <= seuil_sf
    # first passing order ends the loop; that order is still included
    idx = torch.argmax(passed.to(torch.int32), dim=-1)
    last = torch.where(passed.any(dim=-1), idx, n_s - 1)
    return s <= last[..., None]
