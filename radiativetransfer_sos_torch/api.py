"""Migration-parity API: the f2py ``sos.sos_proc`` surface and file writers.

Port of the JAX package's ``api.py`` for the products the port makes
so far (the reference's ``binding/run_sos.py`` surface):

* :func:`sos_proc` — the same keyword names and sentinel values as the f2py
  binding and the same 23-element tuple (``binding/run_sos.py:636-695``),
  tables padded to the reference's static dims (361 x 81,
  ``src/SOS_PROC.F:1177-1204``);
* :func:`config_from_keywords` — the ``-Section.Name value`` decoding of
  ``SOS_ABS_MAIN`` (catalogue ``src/SOS_ABS_MAIN.F:236-911``), shared with
  the CLI;
* ASCII writers for ``SOS_Up.txt`` / ``SOS_Down.txt`` (formats
  ``src/SOS_ABS_MAIN.F:3095-3096``) and the flux file
  (``src/SOS_PROC.F:3842-3874``).

The transmission file, the Fourier binary and the user-angle files wait for
their products (ROADMAP A10, A14); :func:`write_result_files` raises when
one is requested.  Every public entry takes ``device=`` / ``dtype=``
(package defaults when None).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import constants as cte
from .config import UNSET, UNSET_I, SosConfig
from .proc import SosResults, sos_run

NO_OUTPUT = "NO_OUTPUT"
_NPHI_MAX = 361                       # 0:360 azimuth rows
_NMU_MAX = cte.OS_NBMU_MAX + 1        # 0:CTE_OS_NBMU_MAX angle columns


# ---------------------------------------------------------------------------
# Keyword decoding (shared by sos_proc kwargs and the CLI)
# ---------------------------------------------------------------------------

def load_angle_file(path: str) -> np.ndarray:
    """User angle list: one angle in degrees per line
    (``binding/TestFiles/ficAngRad.txt``)."""
    return np.loadtxt(path, dtype=np.float64, ndmin=1)


def load_user_abs_profile(path: str) -> np.ndarray:
    """User absorption profile file: 50 levels x columns
    (z, P, T, gas densities) as read by ``SOS_PREPA_ABSPROFILE``."""
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def _f(v, default=UNSET):
    if v is None:
        return default
    v = float(v)
    return default if v == UNSET else v


def _i(v, default=UNSET_I):
    if v is None:
        return default
    v = int(v)
    return default if v == UNSET_I else v


def _s(v) -> Optional[str]:
    if v is None:
        return None
    v = str(v).strip()
    return None if v in ("", NO_OUTPUT) else v


def config_from_keywords(kw: dict) -> SosConfig:
    """Build a :class:`SosConfig` from ``-Section.Name`` keyword strings.

    Unrecognized keywords raise (mirroring the reference's strict argv
    parser, ``src/SOS_ABS_MAIN.F:1490-2089``); log/result-file keywords are
    accepted and exposed via the returned config's ``io`` attribute dict.
    """
    kw = dict(kw)
    cfg = SosConfig()
    io: dict = {}

    def pop_f(key, default=UNSET):
        return _f(kw.pop(key, None), default)

    def pop_i(key, default=UNSET_I):
        return _i(kw.pop(key, None), default)

    def pop_s(key):
        return _s(kw.pop(key, None))

    # ignored-but-accepted bookkeeping keywords (logs, cache dirs, result
    # file names) -> io dict
    for k in ("-SOS_Main.ResRoot", "-SOS_Main.Log", "-ANG.Rad.ResFile",
              "-ANG.Aer.ResFile", "-ANG.Log", "-AER.Log", "-AER.MieLog",
              "-AER.DirMie", "-AER.ResFile", "-AER.UserFile", "-AP.Log",
              "-SURF.Dir", "-SURF.Log", "-SURF.File", "-SOS.Log",
              "-SOS.ResBin", "-SOS.ResFileUp", "-SOS.ResFileDown",
              "-SOS.ResFileUp.UserAng", "-SOS.ResFileDown.UserAng",
              "-SOS.Trans", "-SOS.Flux"):
        v = pop_s(k)
        if v is not None:
            io[k] = v

    cfg.wavelength = pop_f("-SOS_Main.Wa", pop_f("-SOS.Wa", 0.550))

    cfg.angles.nbmu_lum = pop_i("-ANG.Rad.NbGauss", cte.DEFAULT_NBMU_LUM)
    cfg.angles.nbmu_mie = pop_i("-ANG.Aer.NbGauss", cte.DEFAULT_NBMU_MIE)
    cfg.angles.thetas_deg = pop_f("-ANG.Thetas", 0.0)
    # framework extension (no reference equivalent): 0 decouples the sun
    # geometry from the radiance grid so theta_s sweeps batch into one
    # multiband dispatch (AngleConfig.solar_in_grid)
    cfg.angles.solar_in_grid = bool(pop_i("-ANG.SolarInGrid", 1))
    p = pop_s("-ANG.Rad.UserAngFile")
    if p:
        cfg.angles.user_rad_deg = load_angle_file(p)
    p = pop_s("-ANG.Aer.UserAngFile")
    if p:
        cfg.angles.user_mie_deg = load_angle_file(p)

    a = cfg.aerosols
    a.waref = pop_f("-AER.Waref")
    a.aot_ref = pop_f("-AER.AOTref", 0.0)
    a.tronca = bool(pop_i("-AER.Tronca", 1))
    a.model = pop_i("-AER.Model")
    a.mm.mr_wa = pop_f("-AER.MMD.MRwa")
    a.mm.mi_wa = pop_f("-AER.MMD.MIwa")
    a.mm.mr_waref = pop_f("-AER.MMD.MRwaref")
    a.mm.mi_waref = pop_f("-AER.MMD.MIwaref")
    a.mm.sdtype = pop_i("-AER.MMD.SDtype", 1)
    a.mm.lnd_radius = pop_f("-AER.MMD.LNDradius")
    a.mm.lnd_var = pop_f("-AER.MMD.LNDvar")
    a.mm.junge_slope = pop_f("-AER.MMD.JD.slope")
    a.mm.junge_rmin = pop_f("-AER.MMD.JD.rmin")
    a.mm.junge_rmax = pop_f("-AER.MMD.JD.rmax", cte.DEFAULT_AER_JUNGE_RMAX)
    a.wmo_model = pop_i("-AER.WMO.Model")
    a.wmo_dl = pop_f("-AER.WMO.DL")
    a.wmo_ws = pop_f("-AER.WMO.WS")
    a.wmo_oc = pop_f("-AER.WMO.OC")
    a.wmo_so = pop_f("-AER.WMO.SO")
    a.sf_model = pop_i("-AER.SF.Model")
    a.sf_rh = pop_f("-AER.SF.RH")
    a.bmd.mode_param = pop_i("-AER.BMD.VCdef", 1)
    a.bmd.cv_coarse = pop_f("-AER.BMD.CoarseVC")
    a.bmd.cv_fine = pop_f("-AER.BMD.FineVC")
    a.bmd.rtau_fine_waref = pop_f("-AER.BMD.RAOT")
    for pre, key in (("cm", "CM"), ("fm", "FM")):
        setattr(a.bmd, f"{pre}_mr_wa", pop_f(f"-AER.BMD.{key}.MRwa"))
        setattr(a.bmd, f"{pre}_mi_wa", pop_f(f"-AER.BMD.{key}.MIwa"))
        setattr(a.bmd, f"{pre}_mr_waref", pop_f(f"-AER.BMD.{key}.MRwaref"))
        setattr(a.bmd, f"{pre}_mi_waref", pop_f(f"-AER.BMD.{key}.MIwaref"))
        setattr(a.bmd, f"{pre}_rmodal", pop_f(f"-AER.BMD.{key}.SDradius"))
        setattr(a.bmd, f"{pre}_var", pop_f(f"-AER.BMD.{key}.SDvar"))
    a.external_file = pop_s("-AER.ExtData")
    a.mixture_file = pop_s("-AER.DefMixture")

    pr = cfg.profile
    pr.mot = pop_f("-AP.MOT")
    pr.hr = pop_f("-AP.HR", 8.0)
    pr.type = pop_i("-AP.AerProfile.Type", 1)
    pr.ha = pop_f("-AP.AerHS.HA")
    pr.zmin = pop_f("-AP.AerLayer.Zmin")
    pr.zmax = pop_f("-AP.AerLayer.Zmax")
    pr.psurf = pop_f("-AP.Psurf", cte.HT_STD_PSURF)

    ab = cfg.absorption
    ab.h2o = pop_f("-AP.H2O")
    ab.o3 = pop_f("-AP.O3")
    ab.co2 = pop_f("-AP.CO2")
    ab.ch4 = pop_f("-AP.CH4")
    ab.absprofil = pop_i("-AP.AbsProfile.Type", 7)
    ab.resolution = int(pop_f("-AP.SpectralResol", 10))
    p = pop_s("-AP.AbsProfile.UserFile")
    if p:
        ab.user_profile = load_user_abs_profile(p)
    ab.mode_ckd = pop_i("-SOS.AbsModeCKD", 1)

    s = cfg.surface
    s.type = pop_i("-SURF.Type", 0)
    s.alb = pop_f("-SURF.Alb", 0.0)
    s.ind = pop_f("-SURF.Ind")
    s.wind = pop_f("-SURF.Glitter.Wind")
    s.k0 = pop_f("-SURF.Roujean.K0")
    s.k1 = pop_f("-SURF.Roujean.K1")
    s.k2 = pop_f("-SURF.Roujean.K2")
    s.alpha_nadal = pop_f("-SURF.Nadal.Alpha")
    s.beta_nadal = pop_f("-SURF.Nadal.Beta")
    s.coef_c_maignan = pop_f("-SURF.Maignan.C")

    v = cfg.view
    v.zout_km = pop_f("-SOS.OutputAlt", pop_f("-SOS.OutputLevel"))
    if v.zout_km == -1.0:
        v.zout_km = UNSET
    cfg.igmax = pop_i("-SOS.IGmax", cte.DEFAULT_IGMAX)
    cfg.ipolar = bool(pop_i("-SOS.Ipolar", 1))
    cfg.mdf = pop_f("-SOS.MDF", cte.MDF)
    v.itrphi = pop_i("-SOS.View", 1)
    v.phi_deg = pop_f("-SOS.View.Phi", 0.0)
    v.dphi_deg = pop_i("-SOS.View.Dphi", 30)

    cfg.compute_transmissions = "-SOS.Trans" in io

    unknown = [k for k in kw if kw[k] is not None]
    if unknown:
        raise ValueError(f"unknown keywords: {unknown}")

    # io keywords are checked by proc.run: the ones whose products the port
    # does not write yet raise there
    cfg.io = io
    return cfg


# ---------------------------------------------------------------------------
# ASCII output writers
# ---------------------------------------------------------------------------

def _radiance_header(itrphi: int, updown: int, zalt) -> str:
    """Header block of the up/down radiance files
    (``SOS_OUTPUT_HEADER[_POLAR_DIAG]``, ``binding/run_sos.py:219-279``)."""
    sep = ("#------------------------------------------------------------"
           "-----------------------------------------\n")
    way = "UPWARD" if updown == 1 else "DOWNWARD"
    vs = ("THE AZIMUTH ANGLE AND " if itrphi == 2 else "") \
        + "VIEWING ZENITH ANGLE"
    lines = [f"#{way} RADIANCE FIELD VERSUS {vs}\n"]
    if itrphi == 1:
        lines.append("# (RELATIVE AZIMUTH AND ALTITUDE ARE FIXED)\n")
    else:
        lines.append("# (ALTITUDE IS FIXED)\n")
    lines.append(sep)
    lines.append("#      Relative azimuth convention :\n")
    lines.append("#        180 deg <-> Viewing direction and Sun in the "
                 "same half-plane\n")
    lines.append("#          0 deg <-> Viewing direction and Sun in "
                 "opposite half-planes with respect to the zenith "
                 "direction\n#\n")
    lines.append(f"# Value of the selected altitude for the output (km) : "
                 f"{zalt}\n#\n")
    lines.append("# Columns parameters :\n")
    if itrphi == 2:
        lines.append("#   PHI     :  Relative azimuth Angle (in degrees)\n")
    lines.append("#   VZA     :  Viewing Zenith Angle (in degrees)\n")
    lines.append("#   SCA_ANG :  Scattering angle (in degrees)\n")
    lines.append("#   I       :  Stokes parameter I at output altitude z "
                 "(in sr-1),\n")
    lines.append("#              normalised to the extraterrestrial solar "
                 "irradiance (PI * L(z) / Esun)\n")
    lines.append("#   Q       :  Stokes parameter Q at output altitude z "
                 "(in sr-1)\n")
    lines.append("#   U       :  Stokes parameter U at output altitude z "
                 "(in sr-1)\n")
    lines.append("#   POL_ANG :  Polarization angle (in degrees). "
                 "Note: if undefined the value is -999.00\n")
    lines.append("#   POL_RATE:  Degree of polarization (in %)\n")
    lines.append("#   IPOL    :  Polarized intensity at level z (in sr-1)\n")
    lines.append(sep)
    if itrphi == 2:
        lines.append("#   PHI      VZA     SCA_ANG        I              Q"
                     "              U       POL_ANG  POL_RATE    IPOL\n")
        lines.append("#(degrees) (degrees) (degrees)  (no unit)      "
                     "(no unit)      (no unit)   (degrees) (pcts)  "
                     "(no unit)\n")
    else:
        lines.append("#   VZA     SCA_ANG        I              Q"
                     "              U       POL_ANG  POL_RATE    IPOL\n")
        lines.append("#(degrees) (degrees)  (no unit)      (no unit)      "
                     "(no unit)   (degrees) (pcts)  (no unit)\n")
    return "".join(lines)


def write_radiance_file(path: str, res: SosResults, updown: int,
                        itrphi: int, zalt) -> None:
    """``SOS_Up.txt`` / ``SOS_Down.txt``.

    Principal plane (ITRPHI=1): the phi+180 half-plane with negative view
    angles first, then phi with positive angles (record format
    ``src/SOS_ABS_MAIN.F:3095``, write loops ``:2312-2409``).  Polar diagram
    (ITRPHI=2): phi-major over view angles (``:2427-2496``).
    """
    tabs = res.up if updown == 1 else res.down
    theta = res.theta
    n = theta.shape[0]
    with open(path, "w") as f:
        f.write(_radiance_header(itrphi, updown, zalt))
        if itrphi == 1:
            for row, sgn, order in ((0, -1.0, range(n - 1, -1, -1)),
                                    (1, 1.0, range(n))):
                for j in order:
                    f.write("  %7.2f %7.2f  %13.6e  %13.6e  %13.6e  "
                            "%7.2f %7.2f %13.6e\n"
                            % (sgn * theta[j], tabs["sca"][row, j],
                               tabs["i"][row, j], tabs["q"][row, j],
                               tabs["u"][row, j], tabs["pol_ang"][row, j],
                               tabs["pol_rate"][row, j],
                               tabs["l_pol"][row, j]))
        else:
            for ip, phid in enumerate(res.phi):
                for j in range(n):
                    f.write(" %7.2f %7.2f %7.2f  %13.6e  %13.6e  %13.6e  "
                            "%7.2f %7.2f %13.6e\n"
                            % (phid, theta[j], tabs["sca"][ip, j],
                               tabs["i"][ip, j], tabs["q"][ip, j],
                               tabs["u"][ip, j], tabs["pol_ang"][ip, j],
                               tabs["pol_rate"][ip, j],
                               tabs["l_pol"][ip, j]))


def write_flux_file(path: str, res: SosResults) -> None:
    """Flux file (``src/SOS_PROC.F:3842-3874``, formats ``:4948-4951``)."""
    with open(path, "w") as f:
        f.write("Solar Zenith Angle : %7.3f\n" % res.thetas_deg)
        f.write("  \n")
        f.write(" Downward fluxes at BOA (normalized by TOA solar flux)\n")
        f.write("   - Downward direct flux at BOA : %9.5f\n"
                % res.flux_dir_down)
        f.write("   - Downward diffuse flux at BOA: %9.5f\n"
                % res.flux_diff_down)
        f.write("   ==> Downward total flux at BOA: %9.5f\n"
                % res.flux_tot_down)
        f.write("  \n")
        f.write(" Upward diffuse flux at TOA (normalized by TOA solar "
                "flux): %s\n" % res.flux_diff_up)


# ---------------------------------------------------------------------------
# The f2py-compatible entry point
# ---------------------------------------------------------------------------

#: f2py kwarg name -> -Keyword string (``binding/run_sos.py:319-441``)
_F2PY_TO_KEYWORD = {
    "resroot": "-SOS_Main.ResRoot", "ficmain_log": "-SOS_Main.Log",
    "wa_simu": "-SOS_Main.Wa",
    "nbmu_gauss_lum": "-ANG.Rad.NbGauss",
    "ficangles_user_lum": "-ANG.Rad.UserAngFile",
    "tetas": "-ANG.Thetas", "ficangles_res_lum": "-ANG.Rad.ResFile",
    "nbmu_gauss_mie": "-ANG.Aer.NbGauss",
    "ficangles_user_mie": "-ANG.Aer.UserAngFile",
    "ficangles_res_mie": "-ANG.Aer.ResFile", "ficanglog": "-ANG.Log",
    "waref_aot": "-AER.Waref", "aot_ref": "-AER.AOTref",
    "itronc_aer": "-AER.Tronca", "ficgranu_log": "-AER.Log",
    "ficmie_log": "-AER.MieLog", "dir_mie": "-AER.DirMie",
    "ficgranu": "-AER.ResFile", "imod_aer": "-AER.Model",
    "rn_wa": "-AER.MMD.MRwa", "in_wa": "-AER.MMD.MIwa",
    "rn_waref": "-AER.MMD.MRwaref", "in_waref": "-AER.MMD.MIwaref",
    "igranu": "-AER.MMD.SDtype",
    "lnd_radius_mmd_aer": "-AER.MMD.LNDradius",
    "lnd_lnvar_mmd_aer": "-AER.MMD.LNDvar",
    "jd_slope_mmd_aer": "-AER.MMD.JD.slope",
    "jd_rmin_mmd_aer": "-AER.MMD.JD.rmin",
    "jd_rmax_mmd_aer": "-AER.MMD.JD.rmax",
    "imodele_wmo": "-AER.WMO.Model", "c_wmo_dl": "-AER.WMO.DL",
    "c_wmo_ws": "-AER.WMO.WS", "c_wmo_oc": "-AER.WMO.OC",
    "c_wmo_so": "-AER.WMO.SO", "imodele_sf": "-AER.SF.Model",
    "rh": "-AER.SF.RH", "mode_param_bilnd": "-AER.BMD.VCdef",
    "user_cv_coarse": "-AER.BMD.CoarseVC",
    "user_cv_fine": "-AER.BMD.FineVC", "rtauct_waref": "-AER.BMD.RAOT",
    "bmd_cm_mrwa": "-AER.BMD.CM.MRwa", "bmd_cm_miwa": "-AER.BMD.CM.MIwa",
    "bmd_cm_mrwaref": "-AER.BMD.CM.MRwaref",
    "bmd_cm_miwaref": "-AER.BMD.CM.MIwaref",
    "bmd_cm_rmodal": "-AER.BMD.CM.SDradius",
    "bmd_cm_var": "-AER.BMD.CM.SDvar",
    "bmd_fm_mrwa": "-AER.BMD.FM.MRwa", "bmd_fm_miwa": "-AER.BMD.FM.MIwa",
    "bmd_fm_mrwaref": "-AER.BMD.FM.MRwaref",
    "bmd_fm_miwaref": "-AER.BMD.FM.MIwaref",
    "bmd_fm_rmodal": "-AER.BMD.FM.SDradius",
    "bmd_fm_var": "-AER.BMD.FM.SDvar",
    "ficextdata_aer": "-AER.ExtData", "ficmixture_aer": "-AER.DefMixture",
    "ficuser_aer": "-AER.UserFile", "ficprofil_log": "-AP.Log",
    "tr": "-AP.MOT", "hr": "-AP.HR", "ha": "-AP.AerHS.HA",
    "iprofil": "-AP.AerProfile.Type", "zmin": "-AP.AerLayer.Zmin",
    "zmax": "-AP.AerLayer.Zmax", "psurf": "-AP.Psurf",
    "h2o": "-AP.H2O", "o3": "-AP.O3", "co2": "-AP.CO2", "ch4": "-AP.CH4",
    "absprofil": "-AP.AbsProfile.Type",
    "ficabsprofil": "-AP.AbsProfile.UserFile",
    "nustep": "-AP.SpectralResol", "isurf": "-SURF.Type",
    "dir_surf": "-SURF.Dir", "ficsurf_log": "-SURF.Log",
    "surf_ind": "-SURF.Ind", "wind": "-SURF.Glitter.Wind",
    "k0_roujean": "-SURF.Roujean.K0", "k1_roujean": "-SURF.Roujean.K1",
    "k2_roujean": "-SURF.Roujean.K2", "alpha_nadal": "-SURF.Nadal.Alpha",
    "beta_nadal": "-SURF.Nadal.Beta", "coef_c_maignan": "-SURF.Maignan.C",
    "rho": "-SURF.Alb", "ficsurf": "-SURF.File", "ficsos_log": "-SOS.Log",
    "ficsos_res_bin": "-SOS.ResBin", "fictrans": "-SOS.Trans",
    "ficflux": "-SOS.Flux", "zout": "-SOS.OutputAlt",
    "igmax": "-SOS.IGmax", "ipolar": "-SOS.Ipolar",
    "itrphi": "-SOS.View", "phios": "-SOS.View.Phi",
    "pas_phi": "-SOS.View.Dphi", "imode_ckd_calcul": "-SOS.AbsModeCKD",
}


def _pad2(a: np.ndarray) -> np.ndarray:
    """Pad a (nphi, n) table to the reference's (361, 81) static shape."""
    out = np.zeros((_NPHI_MAX, _NMU_MAX))
    out[: a.shape[0], : a.shape[1]] = a
    return out


def sos_proc(device=None, dtype=None, **kwargs):
    """Drop-in replacement for the f2py ``sos.sos_proc`` call, solved on
    ``device`` in ``dtype``.

    Accepts the keyword set of ``binding/run_sos.py:640-695`` (``ier`` and
    ``trace`` are accepted and ignored — errors raise Python exceptions)
    and returns::

        (nblum, ind_angout, phi, vza,
         sca_ang_up, i_up, q_up, u_up, pol_ang_up, pol_rate_up, l_pol_up,
         sca_ang_down, i_down, q_down, u_down, pol_ang_down,
         pol_rate_down, l_pol_down,
         flux_dir_down, flux_diff_down, flux_tot_down, flux_diff_up,
         coef_tronca)
    """
    kwargs.pop("ier", None)
    kwargs.pop("trace", None)
    kw = {}
    for name, value in kwargs.items():
        if name not in _F2PY_TO_KEYWORD:
            raise TypeError(f"unknown sos_proc argument {name!r}")
        kw[_F2PY_TO_KEYWORD[name]] = value
    cfg = config_from_keywords(kw)
    res = sos_run(cfg, device=device, dtype=dtype)
    write_result_files(cfg, res)

    grid = res.grid
    n = grid.theta_deg.shape[0]
    ind_angout = np.zeros(_NMU_MAX, dtype=np.int64)
    ind_angout[:n] = grid.is_user.astype(np.int64)
    phi = np.zeros(_NPHI_MAX)
    phi[: res.phi.shape[0]] = res.phi
    vza = np.zeros(_NMU_MAX)
    vza[:n] = grid.theta_deg

    u, d = res.up, res.down
    return (n, ind_angout, phi, vza,
            _pad2(u["sca"]), _pad2(u["i"]), _pad2(u["q"]), _pad2(u["u"]),
            _pad2(u["pol_ang"]), _pad2(u["pol_rate"]), _pad2(u["l_pol"]),
            _pad2(d["sca"]), _pad2(d["i"]), _pad2(d["q"]), _pad2(d["u"]),
            _pad2(d["pol_ang"]), _pad2(d["pol_rate"]), _pad2(d["l_pol"]),
            res.flux_dir_down, res.flux_diff_down, res.flux_tot_down,
            res.flux_diff_up, res.coef_tronca)


def write_result_files(cfg: SosConfig, res: SosResults) -> None:
    """Write the requested ASCII products under ResRoot/SOS
    (tree layout ``src/SOS_PROC.F:1475-1500``)."""
    io = getattr(cfg, "io", {})
    root = io.get("-SOS_Main.ResRoot")
    if root is None:
        return
    missing = [k for k in ("-SOS.Trans", "-SOS.ResBin",
                           "-SOS.ResFileUp.UserAng",
                           "-SOS.ResFileDown.UserAng") if k in io]
    if missing:
        raise NotImplementedError(f"result files {missing}: transmissions "
                                  "and product writers are ROADMAP A10/A14")
    outdir = os.path.join(root, "SOS")
    os.makedirs(outdir, exist_ok=True)

    zup = cfg.view.zout_km if cfg.view.zout_km != UNSET else cte.TOA_ALT
    zdn = cfg.view.zout_km if cfg.view.zout_km != UNSET else 0.0
    up_name = io.get("-SOS.ResFileUp", "SOS_Up.txt")
    dn_name = io.get("-SOS.ResFileDown", "SOS_Down.txt")
    write_radiance_file(os.path.join(outdir, up_name), res, 1,
                        cfg.view.itrphi, zup)
    write_radiance_file(os.path.join(outdir, dn_name), res, 2,
                        cfg.view.itrphi, zdn)
    if "-SOS.Flux" in io:
        write_flux_file(os.path.join(outdir, io["-SOS.Flux"]), res)
