"""End-to-end orchestrator: the SOS_PROC pipeline as one function.

Port of the JAX package's ``proc.py`` (reference ``SOS_PROC``,
``src/SOS_PROC.F:415``): host setup in float64 NumPy (angle grids, aerosol
expansion, profiles), the phase kernels and the solve in PyTorch on the
chosen device, then the host aggregation and azimuth recomposition.

The path ported so far is one case with an external phase-matrix aerosol
(IMOD 4) or none, no gaseous absorption, a Lambertian ground and the
default output levels.  Every other branch raises ``NotImplementedError``
naming its ROADMAP item; none is silently skipped.  Unlike the JAX package,
a case keeps its own layer count (no quantization to a kernel chunk) and its
own term count (no padding to a kernel block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import angles as angles_mod
from . import constants as cte
from . import gsf, kernels, profile, recompose, resolve, solver
from .aerosols import AerosolExpansion, decompose_legendre
from .config import UNSET, UNSET_I, SosConfig
from .tracing import NullTrace

#: io keywords whose products this port writes (``api.write_result_files``)
#: or honours (the main log); the others need the product writers
SUPPORTED_IO = ("-SOS_Main.ResRoot", "-SOS_Main.Log", "-SOS.ResFileUp",
                "-SOS.ResFileDown", "-SOS.Flux")


def rayleigh_mot(wavelength: float, psurf: float) -> float:
    """Perbos (1982) CNES molecular optical thickness
    (``src/SOS_PROC.F:3333-3335``)."""
    wa = wavelength
    return (psurf / cte.HT_STD_PSURF) * 1.0e-4 * (
        84.35 / wa ** 4 - 1.225 / wa ** 5 + 1.4 / wa ** 6)


# ---------------------------------------------------------------------------
# Aerosol properties per configuration
# ---------------------------------------------------------------------------

def aerosol_properties(cfg: SosConfig, mie_grid):
    """(AerosolExpansion, TA at the simulation wavelength)."""
    aer = cfg.aerosols
    os_nb, _, _ = angles_mod.expansion_orders(cfg.angles.nbmu_mie,
                                              cfg.angles.nbmu_lum)
    if aer.aot_ref <= 0.0 or aer.model == UNSET_I:
        z = np.zeros(os_nb + 1)
        exp = AerosolExpansion(alpha=z, beta=z, gamma=z, zeta=z,
                               coef_tronca=0.0, piz=1.0, piz_tronc=1.0,
                               sigma_ext=0.0, sigma_sca=0.0)
        return exp, 0.0
    if aer.model != 4:
        raise NotImplementedError(
            f"aerosol model {aer.model} (Mie-based: mono-modal, WMO, S&F, "
            "bimodal, mixture): ROADMAP A6")
    from .external_aerosols import external_phase_matrix
    if abs(aer.waref - cfg.wavelength) > 1.0e-9 and aer.waref != UNSET:
        raise ValueError("external phase functions require "
                         "waref == wavelength (src/SOS_ABS_MAIN.F:677)")
    pm = external_phase_matrix(aer.external_file, mie_grid)
    expn = decompose_legendre(pm, mie_grid.mu, mie_grid.w, os_nb,
                              aer.tronca)
    return expn, float(aer.aot_ref)


# ---------------------------------------------------------------------------
# Truncation adjustment of a discretized profile (src/SOS.F:511-543)
# ---------------------------------------------------------------------------

def truncation_adjust(h, pcaer, pcmol, piz, piz_tronc, coef_tronca):
    """tau-profile rescale for the truncated phase function + conversion of
    the aerosol extinction fraction into a scattering fraction.  The level
    axis is the LAST axis; leading axes (the term batch) broadcast."""
    h = np.asarray(h, dtype=np.float64).copy()
    xdel = np.asarray(pcaer, dtype=np.float64).copy()
    ydel = np.asarray(pcmol, dtype=np.float64).copy()
    a = coef_tronca
    if a != 0.0:
        dh = np.diff(h, axis=-1)
        va = xdel[..., 1:] * dh
        vatr = va * (1.0 - piz * 0.5 * a)
        vr = ydel[..., 1:] * dh
        vg = (1.0 - xdel[..., 1:] - ydel[..., 1:]) * dh
        tot = vatr + vr + vg
        htr = np.concatenate(
            [h[..., :1], h[..., :1] + np.cumsum(tot, axis=-1)], axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            xdel = np.concatenate(
                [xdel[..., :1], np.where(tot > 0, vatr / tot, 0.0)],
                axis=-1)
            ydel = np.concatenate(
                [ydel[..., :1], np.where(tot > 0, vr / tot, 0.0)],
                axis=-1)
        h = htr
    xdel = xdel * piz_tronc
    return h, xdel, ydel


# ---------------------------------------------------------------------------
# Results container + the pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SosResults:
    """Aggregated outputs of one run (the SOS_PROC intent(out) set,
    ``binding/run_sos.py:636-695``)."""
    grid: angles_mod.RadianceGrid
    records_up: np.ndarray       # (S, 3, D) aggregated Fourier Stokes
    records_down: np.ndarray     # same values, an independent array
    ttot_tronc: float            # truncated total optical depth
    ttot_vrai: float             # true total optical depth
    tauout: float                # optical depth of the output level
    emoins: float                # downward diffuse flux
    eplus: float                 # upward diffuse flux
    coef_tronca: float
    n_ckd_terms: int
    thetas_deg: float = 0.0
    # per-stage wall times from the tracer
    timings: Optional[dict] = None
    # view tables (filled by trphi_option)
    phi: Optional[np.ndarray] = None
    theta: Optional[np.ndarray] = None
    up: Optional[dict] = None
    down: Optional[dict] = None

    # -- derived flux outputs (``src/SOS_PROC.F:3828-3837``) ---------------
    @property
    def _mus(self) -> float:
        return float(np.cos(np.radians(self.thetas_deg)))

    @property
    def flux_dir_down(self) -> float:
        """Direct downward transmission for the TRUE optical depth."""
        return float(np.exp(-self.ttot_vrai / self._mus))

    @property
    def flux_diff_down(self) -> float:
        """EMOINS + Tdir_tronc - Tdir_vrai."""
        return float(self.emoins + np.exp(-self.ttot_tronc / self._mus)
                     - np.exp(-self.ttot_vrai / self._mus))

    @property
    def flux_tot_down(self) -> float:
        return float(self.emoins + np.exp(-self.ttot_tronc / self._mus))

    @property
    def flux_diff_up(self) -> float:
        return float(self.eplus)


@dataclasses.dataclass
class PreparedCase:
    """Everything between property generation and the device solve."""
    cfg: SosConfig
    lum: object
    inp: solver.SolveInputs
    opt: solver.SolveOptions
    aik: np.ndarray
    n_terms: int
    iborm: int
    aer_exp: AerosolExpansion
    ttot_vrai_terms: np.ndarray
    ttot_tronc_terms: np.ndarray


def _check_supported(cfg: SosConfig) -> None:
    """Raise for every configuration branch the port has not reached."""
    io = getattr(cfg, "io", {})
    # -SOS.Trans asks for the transmissions, refused below
    extra = sorted(k for k in io if k not in SUPPORTED_IO + ("-SOS.Trans",))
    if extra:
        raise NotImplementedError(
            f"io keywords {extra}: the product and log writers "
            "(products.py) are ROADMAP A14")
    if cfg.absorption.absprofil != 7 and cfg.profile.type == 1:
        raise NotImplementedError("gaseous absorption (CKD terms and their "
                                  "aggregation): ROADMAP A8")
    if cfg.surface.type != 0:
        raise NotImplementedError(f"surface type {cfg.surface.type} "
                                  "(non-Lambertian): ROADMAP A7")
    if cfg.view.zout_km != UNSET:
        raise NotImplementedError("output altitude (zout): ROADMAP A10")
    if cfg.compute_transmissions:
        raise NotImplementedError("diffuse transmissions: ROADMAP A10")


def prepare_case(cfg: SosConfig, trace=None, device=None,
                 dtype=None) -> PreparedCase:
    """Host-side pipeline of one case: properties -> SolveInputs on
    ``device`` in ``dtype`` (package defaults when None)."""
    if trace is None:
        trace = NullTrace()
    device, dtype = resolve(device, dtype)
    cfg.validate()
    _check_supported(cfg)

    # --- angle grids
    with trace.stage("angles"):
        lum = angles_mod.make_radiance_grid(
            cfg.angles.thetas_deg, cfg.angles.nbmu_lum,
            cfg.angles.user_rad_deg,
            inject_solar=cfg.angles.solar_in_grid)
        mie_grid = angles_mod.make_mie_grid(cfg.angles.nbmu_mie,
                                            cfg.angles.user_mie_deg)
        os_nb, _, _ = angles_mod.expansion_orders(cfg.angles.nbmu_mie,
                                                  cfg.angles.nbmu_lum)

    # --- molecular optical thickness
    tr = cfg.profile.mot
    if tr == UNSET:
        tr = rayleigh_mot(cfg.wavelength, cfg.profile.psurf)

    # --- aerosols
    with trace.stage("aerosols"):
        aer_exp, ta = aerosol_properties(cfg, mie_grid)
    trace.event("aerosols", ta=round(ta, 6),
                coef_tronca=round(aer_exp.coef_tronca, 6))

    # --- one term: no gaseous absorption
    aik = np.ones(1)
    n_terms = 1
    trace.event("ckd", n_terms=n_terms)

    # --- profile + truncation adjustment; the case keeps its own NT
    with trace.stage("profiles"):
        if cfg.profile.type == 2:
            prof = profile.slab_profile(tr, cfg.profile.hr, ta,
                                        cfg.profile.zmin, cfg.profile.zmax)
        else:
            prof = profile.exp_profile_no_gas(tr, cfg.profile.hr, ta,
                                              cfg.profile.ha)
        ttot_vrai_terms = np.array([prof.h[-1]])
        hs, xds, yds = truncation_adjust(
            prof.h[None], prof.pcaer[None], prof.pcmol[None],
            aer_exp.piz, aer_exp.piz_tronc, aer_exp.coef_tronca)
    ttot_tronc_terms = hs[:, -1]

    # --- Fourier order cap: pure Rayleigh cuts at IS <= 2 (src/SOS.F:546-550)
    pure_rayleigh = bool(np.all(xds == 0.0))
    iborm = 2 if pure_rayleigh else os_nb

    # --- phase kernels, float64 on the device, then the working dtype
    with trace.stage("kernels"):
        f64 = dict(dtype=torch.float64, device=device)
        psl, rsl, tsl = (torch.as_tensor(a, **f64) for a in gsf.gsf_basis(
            lum.mu, lum.mus, os_nb, iborm + 1))
        k_aer = kernels.aerosol_kernel(
            psl, rsl, tsl, aer_exp.alpha, aer_exp.beta, aer_exp.gamma,
            aer_exp.zeta, cfg.ipolar).to(dtype)
        k_mol = kernels.molecular_kernel(psl, rsl, tsl, cfg.mdf,
                                         cfg.ipolar).to(dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    inp = solver.SolveInputs(
        h=t(hs), xdel=t(xds), ydel=t(yds), k_aer=k_aer, k_mol=k_mol,
        mu_pos=t(lum.mu), w_pos=t(lum.w), tab=t(lum.mus),
        n0=max(lum.imus, 0),
        surface=solver.SurfaceInputs(rho=t(float(cfg.surface.alb))))
    opt = solver.SolveOptions(igmax=cfg.igmax, ipolar=cfg.ipolar)
    return PreparedCase(
        cfg=cfg, lum=lum, inp=inp, opt=opt, aik=aik, n_terms=n_terms,
        iborm=iborm, aer_exp=aer_exp, ttot_vrai_terms=ttot_vrai_terms,
        ttot_tronc_terms=ttot_tronc_terms)


def dispatch_case(prep: PreparedCase, trace=None) -> solver.FourierResult:
    """Device solve of one prepared case on the all-orders route."""
    if trace is None:
        trace = NullTrace()
    if prep.iborm + 1 > 24 and prep.n_terms * (prep.iborm + 1) >= 1024:
        # the JAX package routes this size to the blocked Fourier dispatch
        raise NotImplementedError("blocked Fourier early exit for large "
                                  "(terms x orders) batches: ROADMAP A9")
    with trace.stage("solve"):
        res = solver.solve_fourier_batch(prep.inp, prep.opt)
        if res.i3z.is_cuda:
            torch.cuda.synchronize(res.i3z.device)
    _narrate_convergence(res, trace)
    return res


def _narrate_convergence(res, trace) -> None:
    """Per-IS/IG convergence narration (the reference's unit-99 OS log,
    src/SOS_OS.F:1306-1415)."""
    ig = res.ig_last.cpu().numpy()
    code = res.stop_code.cpu().numpy()
    names = {0: "igmax", 1: "geom-conv", 2: "valdif", 3: "sumdif"}
    trace.event("scattering", ig_mean=round(float(ig.mean()), 2),
                ig_max=int(ig.max()),
                stops={names[c]: int((code == c).sum())
                       for c in np.unique(code)})


def finish_case(prep: PreparedCase, res: solver.FourierResult,
                trace=None) -> SosResults:
    """Host aggregation of one solved case (``src/SOS_AGGREGATE.F:372-441``):
    the Fourier stop mask per term, then the AIK-weighted contraction in
    float64."""
    if trace is None:
        trace = NullTrace()
    aik, n_terms = prep.aik, prep.n_terms
    with trace.stage("aggregate"):
        i3z = res.i3z.cpu().to(torch.float64).numpy()      # (T, S, 3, D)
        mask = solver.fourier_stop_mask(res.i3bnd.cpu(),
                                        prep.opt.seuil_sf).numpy()
        recs = np.einsum("t,ts,tscd->scd", aik, mask.astype(np.float64), i3z)
        emoins = float(aik @ res.emoins.cpu().to(torch.float64).numpy()
                       .reshape(n_terms))
        eplus = float(aik @ res.eplus.cpu().to(torch.float64).numpy()
                      .reshape(n_terms))
        # optical depths aggregate in transmission space
        # (``src/SOS_AGGREGATE.F:466-488``)
        ttot_tronc = -np.log(np.sum(aik * np.exp(-prep.ttot_tronc_terms)))
        ttot_vrai = -np.log(np.sum(aik * np.exp(-prep.ttot_vrai_terms)))

    return SosResults(grid=prep.lum, records_up=recs,
                      records_down=recs.copy(),
                      ttot_tronc=float(ttot_tronc),
                      ttot_vrai=float(ttot_vrai), tauout=0.0,
                      emoins=emoins, eplus=eplus,
                      coef_tronca=prep.aer_exp.coef_tronca,
                      n_ckd_terms=n_terms,
                      thetas_deg=prep.cfg.angles.thetas_deg)


# ---------------------------------------------------------------------------
# View recomposition on aggregated records
# ---------------------------------------------------------------------------

def trphi_option(cfg: SosConfig, res: SosResults) -> SosResults:
    """Fill the (phi x theta) output tables like ``SOS_TRPHI_OPTION``
    (``src/SOS_TRPHI.F:285``): view 1 = principal plane (rows phi+180,
    phi), view 2 = polar diagram (rows phi=0..360 step dphi)."""
    grid = res.grid
    s = cfg.surface
    terms = recompose.DirectTerms(
        igli=s.type == 1, ifresnel=s.type == 2, iroujean=s.type >= 3,
        irondeaux=s.type == 4, ibreon=s.type == 5, inadal=s.type == 6,
        imaignan=s.type == 7)

    if cfg.view.itrphi == 1:
        phis_deg = np.array([cfg.view.phi_deg + 180.0, cfg.view.phi_deg])
    else:
        phis_deg = np.arange(0.0, 360.0 + 1e-9, cfg.view.dphi_deg)

    n = grid.n
    phis = np.radians(phis_deg)
    f = recompose.recompose_np(res.records_up, phis)
    xit, xqt, xut = recompose.add_direct_terms(
        f[:, 0], f[:, 1], f[:, 2], grid.mu, grid.imus, grid.mus,
        res.ttot_tronc, res.tauout, phis, terms, cfg.ipolar)

    out, dn = {}, {}
    ups = slice(n + 1, 2 * n + 1)
    # downward directions of the signed axis are stored mirrored
    for tabs, sl, flip in ((out, ups, False), (dn, slice(0, n), True)):
        xi = xit[:, sl][:, ::-1] if flip else xit[:, sl]
        xq = xqt[:, sl][:, ::-1] if flip else xqt[:, sl]
        xu = xut[:, sl][:, ::-1] if flip else xut[:, sl]
        ang, rate, lpol = recompose.polar_params(xi, xq, xu)
        tabs.update(i=xi, q=xq, u=xu, pol_ang=ang, pol_rate=rate,
                    l_pol=lpol)
    sca = recompose.scattering_angles(
        np.concatenate([-grid.mu, grid.mu]), grid.mus, phis[:, None])
    out["sca"] = sca[:, n:]
    dn["sca"] = sca[:, :n]

    res.phi = phis_deg
    res.theta = grid.theta_deg
    res.up = out
    res.down = dn
    return res


def run(cfg: SosConfig, trace=None, mesh=None, device=None,
        dtype=None) -> SosResults:
    """The full pipeline: properties -> solve -> aggregation, on ``device``
    in ``dtype`` (package defaults when None)."""
    if trace is None:
        trace = NullTrace()
    if mesh is not None:
        raise NotImplementedError("multi-device term sharding: ROADMAP A12")
    prep = prepare_case(cfg, trace, device=device, dtype=dtype)
    res = dispatch_case(prep, trace)
    return finish_case(prep, res, trace)


def sos_run(cfg: SosConfig, trace=None, mesh=None, device=None,
            dtype=None) -> SosResults:
    """run + view recomposition in one call (the SOS_PROC surface).

    When the config carries a ``-SOS_Main.Log`` io entry and no tracer is
    passed, a file tracer is opened for the run and closed with the
    reference's JOB_STATUS trailer (``src/SOS_PROC.F:1508-1530``)."""
    own = False
    if trace is None:
        logfile = getattr(cfg, "io", {}).get("-SOS_Main.Log")
        if logfile:
            from .tracing import Trace
            trace = Trace(logfile=logfile)
            own = True
        else:
            trace = NullTrace()
    try:
        res = run(cfg, trace, mesh=mesh, device=device, dtype=dtype)
        with trace.stage("trphi"):
            res = trphi_option(cfg, res)
    except Exception:
        if own:
            trace.close(ok=False)
        raise
    res.timings = dict(trace.timings)
    if own:
        trace.close(ok=True)
    return res
