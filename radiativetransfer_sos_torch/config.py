"""Typed run configuration mirroring the reference keyword surface.

The reference drives everything through ~90 ``-Section.Name value`` CLI
keywords (catalogue ``src/SOS_ABS_MAIN.F:236-911``) passed positionally
into ``SOS_PROC`` (``src/SOS_PROC.F:415-481``).  Here the same parameter
set is a group of dataclasses; the keyword-string migration shim
(``api.sos_proc``) maps the original names onto these fields so reference
configurations port one-to-one.

Sentinel ``-999``/``-999.0`` keeps the reference's "unset" convention
(``inc/SOS.h:76-78``).

Copy of the JAX package's ``config.py``; ``tests/test_torch_host.py``
pins it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as cte

UNSET = cte.NOT_DEFINED_DBLE
UNSET_I = cte.NOT_DEFINED_INT


@dataclass
class AngleConfig:
    """-ANG.* keywords (``src/SOS_ABS_MAIN.F:318-356``)."""
    nbmu_lum: int = cte.DEFAULT_NBMU_LUM     # -ANG.Rad.NbGauss
    nbmu_mie: int = cte.DEFAULT_NBMU_MIE     # -ANG.Aer.NbGauss
    user_rad_deg: np.ndarray | None = None   # -ANG.Rad.UserAngFile content
    user_mie_deg: np.ndarray | None = None   # -ANG.Aer.UserAngFile content
    thetas_deg: float = 0.0                  # -ANG.Thetas
    # True (reference parity): inject the solar zenith angle into the
    # radiance grid as a weight-0 view direction (src/SOS_ANGLES.F:370-466).
    # False: keep the grid sun-independent so a theta_s sweep shares one
    # static grid and batches into ONE multiband dispatch (the solar
    # direction then enters only through the kernel center slot, tab and
    # the surface solar column — angles.make_radiance_grid docstring)
    solar_in_grid: bool = True


@dataclass
class MonoModalAerosol:
    """IMOD=0: mono-modal size distribution (-AER.MMD.*)."""
    sdtype: int = 1                  # 1 = log-normal, 2 = Junge
    lnd_radius: float = UNSET        # -AER.MMD.LNDradius (microns)
    lnd_var: float = UNSET           # -AER.MMD.LNDvar (ln sigma)
    junge_slope: float = UNSET       # -AER.MMD.JD.slope
    junge_rmin: float = UNSET        # -AER.MMD.JD.rmin: plateau radius R0
    #   (NR = R0^-nu for r <= R0); mandatory for the Junge model like the
    #   reference (src/SOS_PROC.F:1694-1697 -> error 23132)
    junge_rmax: float = cte.DEFAULT_AER_JUNGE_RMAX
    mr_wa: float = UNSET             # -AER.MMD.MRwa  (real index at wa)
    mi_wa: float = UNSET             # -AER.MMD.MIwa
    mr_waref: float = UNSET          # index at the AOT reference wavelength
    mi_waref: float = UNSET


@dataclass
class BiModalAerosol:
    """IMOD=3: bimodal log-normal (-AER.BMD.*)."""
    mode_param: int = 1              # 1 = user cv fractions, 2 = tauRatio
    cv_fine: float = UNSET
    cv_coarse: float = UNSET
    rtau_fine_waref: float = UNSET   # ratio AOTfine/AOTtotal at waref
    fm_rmodal: float = UNSET
    fm_var: float = UNSET
    fm_mr_wa: float = UNSET
    fm_mi_wa: float = UNSET
    fm_mr_waref: float = UNSET
    fm_mi_waref: float = UNSET
    cm_rmodal: float = UNSET
    cm_var: float = UNSET
    cm_mr_wa: float = UNSET
    cm_mi_wa: float = UNSET
    cm_mr_waref: float = UNSET
    cm_mi_waref: float = UNSET


@dataclass
class AerosolConfig:
    """-AER.* keywords (``src/SOS_ABS_MAIN.F:420-640``)."""
    aot_ref: float = 0.0             # -AER.AOTref at waref
    waref: float = UNSET             # -AER.Waref (microns)
    model: int = UNSET_I             # -AER.Model (IMOD 0..5)
    tronca: bool = True              # -AER.Tronca
    mm: MonoModalAerosol = field(default_factory=MonoModalAerosol)
    bmd: BiModalAerosol = field(default_factory=BiModalAerosol)
    wmo_model: int = UNSET_I         # -AER.WMO.Model (1 C, 2 M, 3 U, 4 user)
    wmo_dl: float = UNSET            # user WMO volume fractions
    wmo_ws: float = UNSET
    wmo_oc: float = UNSET
    wmo_so: float = UNSET
    sf_model: int = UNSET_I          # -AER.SF.Model (1..4)
    sf_rh: float = UNSET             # -AER.SF.RH (%)
    external_file: str | None = None  # -AER.ExtData
    mixture_file: str | None = None   # IMOD=5 user mixture
    alpha_cap: float | None = None    # testing override: bound Mie sweeps


@dataclass
class SurfaceConfig:
    """-SURF.* keywords (``src/SOS_ABS_MAIN.F:660-760``)."""
    type: int = 0                    # -SURF.Type (ISURF 0..7)
    alb: float = 0.0                 # -SURF.Alb (Lambertian rho)
    ind: float = UNSET               # -SURF.Ind (refractive index)
    wind: float = UNSET              # -SURF.Glitter.Wind (m/s)
    k0: float = UNSET                # -SURF.Roujean.K0
    k1: float = UNSET
    k2: float = UNSET
    alpha_nadal: float = UNSET
    beta_nadal: float = UNSET
    coef_c_maignan: float = UNSET    # C*exp(-nu) site coefficient


@dataclass
class ProfileConfig:
    """-AP.* keywords (``src/SOS_ABS_MAIN.F:360-418``)."""
    mot: float = UNSET               # -AP.MOT (Rayleigh OT; UNSET -> Perbos)
    hr: float = 8.0                  # -AP.HR molecular scale height (km)
    type: int = 1                    # -AP.Type (1 exp aerosols, 2 slab)
    ha: float = UNSET                # -AP.AerHS.HA (km)
    zmin: float = UNSET              # -AP.AerLayer.Zmin
    zmax: float = UNSET              # -AP.AerLayer.Zmax
    psurf: float = cte.HT_STD_PSURF  # -AP.Psurf (mbar)


@dataclass
class AbsConfig:
    """-AbsAtmo.* keywords (``src/SOS_ABS_MAIN.F:770-840``)."""
    absprofil: int = 7               # 0 user file, 1..6 built-in, 7 = none
    user_profile: np.ndarray | None = None   # (50, 13) when absprofil = 0
    mode_ckd: int = 1                # -AbsAtmo.AbsModeCKD (1 fine, 2 fast)
    resolution: int = 10             # -AbsAtmo.Resolution (1/5/10 cm-1)
    h2o: float = UNSET               # -AbsAtmo.H2O (g/cm2)
    o3: float = UNSET                # -AbsAtmo.O3 (Dobson)
    co2: float = UNSET               # -AbsAtmo.CO2 (ppmv at surface)
    ch4: float = UNSET               # -AbsAtmo.CH4 (ppmv at surface)
    # framework extension (no reference keyword): True downgrades a missing
    # CKD table to "gas transparent" instead of the reference's hard abort
    # (src/SOS_SUB_TRS.F:706-707) — see absorption.load_ckd
    allow_missing_gas: bool = False


@dataclass
class ViewConfig:
    """-SOS.View / -SOS.Output keywords (``src/SOS_ABS_MAIN.F:844-911``)."""
    itrphi: int = 1                  # 1 principal plane, 2 polar diagram
    phi_deg: float = 0.0             # -SOS.View.Phi (ITRPHI=1)
    dphi_deg: int = 30               # -SOS.View.Dphi (ITRPHI=2)
    zout_km: float = UNSET           # -SOS.OutputLevel altitude (UNSET = TOA/0)


@dataclass
class SosConfig:
    """Complete run configuration (the SOS_PROC argument list)."""
    wavelength: float = 0.550        # -SOS.Wa (microns)
    angles: AngleConfig = field(default_factory=AngleConfig)
    aerosols: AerosolConfig = field(default_factory=AerosolConfig)
    surface: SurfaceConfig = field(default_factory=SurfaceConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    absorption: AbsConfig = field(default_factory=AbsConfig)
    view: ViewConfig = field(default_factory=ViewConfig)
    igmax: int = cte.DEFAULT_IGMAX   # -SOS.IGmax
    ipolar: bool = True              # -SOS.Ipolar
    mdf: float = cte.MDF             # -SOS.MDF molecular depolarization
    compute_transmissions: bool = False   # -SOS.Trans

    def validate(self):
        """Parameter cross-checks ported from ``src/SOS_PROC.F:1534-2300``.

        Each check cites the reference's numbered error exit (the ``GOTO
        2xxx`` label in ``SOS_PROC``).  Non-fatal validity limits (e.g. the
        Roujean 60 degree domain, ``inc/SOS.h:347-355``) raise
        ``UserWarning`` instead, matching the reference's silent clamping
        (``src/SOS_ROUJEAN.F:953-960``).
        """
        import warnings

        def err(label, msg):
            raise ValueError(f"{msg} (reference error exit {label}, "
                             "src/SOS_PROC.F)")

        # --- wavelength (2100/2101) and solar angle (2200/2201)
        if self.wavelength == UNSET:
            err(2100, "simulation wavelength -SOS_Main.Wa required")
        if not (cte.WAMIN <= self.wavelength <= cte.WAMAX):
            err(2101, f"wavelength {self.wavelength} outside "
                f"[{cte.WAMIN}, {cte.WAMAX}] microns")
        if self.angles.thetas_deg == UNSET:
            err(2200, "solar zenith angle -ANG.Thetas required")
        if not (0.0 <= self.angles.thetas_deg < 90.0):
            err(2201, "solar zenith angle must be in [0, 90)")

        # --- angle grid bounds (array dims inc/SOS.h:457,471,555)
        if not (1 <= self.angles.nbmu_lum <= cte.OS_NBMU_MAX):
            err("ANGLES", f"radiance Gauss angle count "
                f"{self.angles.nbmu_lum} outside [1, {cte.OS_NBMU_MAX}] "
                "(CTE_OS_NBMU_MAX, inc/SOS.h:471)")
        if not (1 <= self.angles.nbmu_mie <= cte.MIE_NBMU_MAX):
            err("ANGLES", f"Mie Gauss angle count {self.angles.nbmu_mie} "
                f"outside [1, {cte.MIE_NBMU_MAX}] (CTE_MIE_NBMU_MAX, "
                "inc/SOS.h:457)")
        for name, ua in (("radiance", self.angles.user_rad_deg),
                         ("Mie", self.angles.user_mie_deg)):
            if ua is not None:
                if len(ua) > cte.NBMU_USER_MAX:
                    err("ANGLES", f"more than {cte.NBMU_USER_MAX} user "
                        f"{name} angles")
                a = np.asarray(ua, dtype=np.float64)
                if np.any(a < 0.0) or np.any(a >= 90.0):
                    err("ANGLES", f"user {name} angles must be in [0, 90)")

        # --- aerosols (2305..2340)
        aer = self.aerosols
        if aer.aot_ref > 0.0:
            if aer.model == UNSET_I:
                err(2304, "aerosol model -AER.Model required when AOT > 0")
            if not (0 <= aer.model <= 5):
                err(2305, f"aerosol model {aer.model} outside [0, 5]")
            if aer.model == 0:
                mm = aer.mm
                if mm.mr_wa == UNSET or mm.mi_wa == UNSET:
                    err(2309, "mono-modal refractive index "
                        "-AER.MMD.MRwa/-AER.MMD.MIwa required")
                if mm.mi_wa > 0.0:
                    err(2310, "imaginary refractive index must be <= 0")
                if mm.sdtype not in (1, 2):
                    err(2312, "mono-modal SDtype must be 1 (LND) or 2 "
                        "(Junge)")
                if mm.sdtype == 1 and (mm.lnd_radius == UNSET
                                       or mm.lnd_var == UNSET):
                    err(2313, "LND radius/variance required")
                if mm.sdtype == 2 and (mm.junge_slope == UNSET
                                       or mm.junge_rmin == UNSET):
                    err(2314, "Junge slope and rmin required "
                        "(-AER.MMD.JD.slope / -AER.MMD.JD.rmin)")
                if (aer.waref != UNSET
                        and abs(aer.waref - self.wavelength) > 1e-9
                        and (mm.mr_waref == UNSET or mm.mi_waref == UNSET)):
                    err(2317, "refractive index at the AOT reference "
                        "wavelength required when waref != wa")
            elif aer.model == 1:
                if aer.wmo_model == UNSET_I:
                    err(2315, "WMO model -AER.WMO.Model required")
                if not (1 <= aer.wmo_model <= 4):
                    err(2316, "WMO model must be in [1, 4]")
                if aer.wmo_model == 4 and UNSET in (aer.wmo_dl, aer.wmo_ws,
                                                    aer.wmo_oc, aer.wmo_so):
                    err(2317, "user WMO volume fractions DL/WS/OC/SO "
                        "required")
            elif aer.model == 2:
                if aer.sf_model == UNSET_I:
                    err(2318, "Shettle&Fenn model -AER.SF.Model required")
                if aer.sf_rh == UNSET:
                    err(2319, "relative humidity -AER.SF.RH required")
                if not (1 <= aer.sf_model <= 4):
                    err(2320, "S&F model must be in [1, 4]")
                if not (0.0 <= aer.sf_rh <= 99.0):
                    err(2321, "relative humidity must be in [0, 99] %")
            elif aer.model == 3:
                b = aer.bmd
                if b.mode_param not in (1, 2):
                    err(2324, "bimodal VCdef must be 1 or 2")
                if b.mode_param == 1 and (b.cv_coarse == UNSET
                                          or b.cv_fine == UNSET):
                    err(2325, "bimodal volume concentrations required")
                if b.mode_param == 2 and b.rtau_fine_waref == UNSET:
                    err(2326, "bimodal AOT ratio -AER.BMD.RAOT required")
                if UNSET in (b.cm_mr_wa, b.cm_mi_wa, b.cm_rmodal, b.cm_var):
                    err(2327, "bimodal coarse-mode parameters required")
                if UNSET in (b.fm_mr_wa, b.fm_mi_wa, b.fm_rmodal, b.fm_var):
                    err(2328, "bimodal fine-mode parameters required")
                if (b.mode_param == 2 and aer.waref != UNSET
                        and abs(aer.waref - self.wavelength) > 1e-9
                        and UNSET in (b.cm_mr_waref, b.cm_mi_waref,
                                      b.fm_mr_waref, b.fm_mi_waref)):
                    err(2329, "bimodal waref refractive indices required "
                        "for the AOT-ratio parameterization")
            elif aer.model == 4:
                if aer.external_file is None:
                    err(2330, "external phase function file -AER.ExtData "
                        "required")
                if (aer.waref != UNSET
                        and abs(aer.waref - self.wavelength) > 1e-9):
                    err(2331, "external phase functions require "
                        "waref == wavelength")
            elif aer.model == 5:
                if aer.mixture_file is None:
                    err(2340, "user mixture file -AER.DefMixture required")
            if aer.waref == UNSET and aer.model not in (4,):
                warnings.warn("AOT reference wavelength -AER.Waref unset; "
                              "assuming waref == simulation wavelength")

        # --- surface (2401..2411)
        s = self.surface
        if s.alb == UNSET:
            err(2401, "surface albedo -SURF.Alb required")
        if s.alb < 0.0:
            err(2402, "surface albedo must be >= 0")
        if s.type not in range(8):
            err(2404, f"unknown surface type {s.type}")
        if s.type == 2 and not self.angles.solar_in_grid:
            err(2412, "the flat-sea specular sun term (src/SOS_TRPHI.F:"
                "1008-1039) needs the solar view slot: ISURF=2 requires "
                "angles.solar_in_grid=True")
        if s.type in (1, 2, 4, 5, 6, 7) and s.ind == UNSET:
            err(2405, "surface refractive index -SURF.Ind required for "
                f"ISURF {s.type}")
        if s.type == 1:
            if s.wind == UNSET:
                err(2406, "glitter surface requires -SURF.Glitter.Wind")
            if s.wind < 0.0:
                err(24061, "wind speed must be >= 0")
        if s.type >= 3 and UNSET in (s.k0, s.k1, s.k2):
            err(2407, "Roujean K0/K1/K2 required for ISURF >= 3")
        if s.type == 6:
            # hard refusal, src/SOS_PROC.F:2211-2225 ("The Nadal's BPDF
            # model is not supported") — the standalone nadal_fourier
            # remains available for differential testing
            raise ValueError("The Nadal's BPDF model is not supported "
                             "==> select another surface model "
                             "(src/SOS_PROC.F:2223-2225)")
        if s.type == 7 and s.coef_c_maignan == UNSET:
            err(2411, "Maignan C coefficient -SURF.Maignan.C required")
        if s.type >= 3 and self.angles.thetas_deg > cte.TETAS_LIM_ROUJEAN:
            warnings.warn(
                f"solar zenith {self.angles.thetas_deg} deg exceeds the "
                f"Roujean BRDF validity limit {cte.TETAS_LIM_ROUJEAN} deg; "
                "the kernel clamps to the limit "
                "(src/SOS_ROUJEAN.F:953-960, inc/SOS.h:347-355)")

        # --- profile (2502..2513)
        p = self.profile
        if p.mot != UNSET and p.mot < 0.0:
            err(2502, "molecular optical thickness must be >= 0")
        if p.hr == UNSET:
            err(2503, "molecular scale height -AP.HR required")
        if p.hr <= 0.0:
            err(2504, "molecular scale height must be > 0")
        if p.type not in (1, 2):
            err(2506, "aerosol profile type must be 1 (exp) or 2 (slab)")
        if p.type == 1 and self.aerosols.aot_ref > 0.0:
            if p.ha == UNSET:
                err(2507, "exponential aerosol profile requires "
                    "-AP.AerHS.HA")
            if p.ha <= 0.0:
                err(2508, "aerosol scale height must be > 0")
        if p.type == 2:
            if p.zmin == UNSET or p.zmax == UNSET:
                err(2509, "slab profile requires zmin/zmax")
            if p.zmax <= p.zmin or p.zmin < 0.0:
                err(2509, "slab requires 0 <= zmin < zmax")

        # --- absorption (2510..2515)
        ab = self.absorption
        if not (0 <= ab.absprofil <= 7):
            err(2511, "absorption profile type must be in [0, 7]")
        if ab.absprofil == 0 and ab.user_profile is None:
            err(2512, "user absorption profile file required for "
                "-AP.AbsProfile.Type 0")
        if p.type == 2 and ab.absprofil != 7:
            err(2513, "the slab aerosol profile (-AP.AerProfile.Type 2) is "
                "incompatible with gaseous absorption")
        if ab.absprofil != 7:
            if ab.resolution not in (1, 5, 10):
                err(25141, "CKD resolution must be 1, 5 or 10 cm-1")
            if ab.mode_ckd not in (1, 2):
                err(2515, "CKD computation mode must be 1 or 2")

        # --- solver/view (2604..2611)
        if self.igmax < 1:
            err(2604, "IGmax must be >= 1")
        if self.view.itrphi not in (1, 2):
            err(2606, "view option must be 1 (plane) or 2 (polar)")
        if self.view.itrphi == 1 and self.view.phi_deg == UNSET:
            err(2607, "principal-plane azimuth -SOS.View.Phi required")
        if self.view.itrphi == 2:
            if self.view.dphi_deg == UNSET_I:
                err(2608, "polar-diagram step -SOS.View.Dphi required")
            if self.view.dphi_deg <= 0:
                err(2609, "polar-diagram azimuth step must be > 0")
        if self.view.zout_km != UNSET and self.view.zout_km < 0.0:
            err(2611, "output altitude must be >= 0 km (or unset = "
                "TOA/ground)")
        return self
