"""Data-free end-to-end cases of the port, as keyword dictionaries.

``slice_keywords`` is the reference's ``binding/run_sos.py`` smoke case
(``demos/configs.py:demo_binding440``: 440 nm, theta_s = 40 deg, 24
radiance and 40 Mie Gauss angles, principal plane at phi = 35 deg, IGmax 30,
truncation on, MOT 0.230, HR 8 km, HA 2 km) with the three parts that need
the reference's data tables swapped for data-free ones:

* aerosol: an external phase-matrix file (IMOD 4) written by
  :func:`write_hg_phase_file` (a Henyey-Greenstein F11, g = 0.7, with
  Rayleigh-shaped polarization), AOT 0.3 at 440 nm, in place of the WMO
  continental model;
* gas: none (absorption profile type 7), in place of the MLS profile with
  CKD mode 2;
* surface: Lambertian, albedo 0.02, in place of the glitter ground.

``rayleigh_keywords`` is the same geometry with no aerosol (3 Fourier
orders).
"""

from __future__ import annotations

import numpy as np


def write_hg_phase_file(path, g: float = 0.7, n_angles: int = 181,
                        k_ext: float = 0.1, k_sca: float = 0.095) -> None:
    """External phase-matrix file (``-AER.ExtData`` format,
    ``src/SOS_AEROSOLS.F:2143-2260``): Henyey-Greenstein F11 with asymmetry
    ``g``, Rayleigh-shaped -F12/F11 and F33/F11, F22/F11 = 1, on
    ``n_angles`` scattering angles from 0 to 180 degrees."""
    ang = np.linspace(0.0, 180.0, n_angles)
    mu = np.cos(np.radians(ang))
    f11 = (1.0 - g * g) / (1.0 + g * g - 2.0 * g * mu) ** 1.5
    with open(path, "w") as f:
        f.write(f"Extinction coefficient (km-1) : {k_ext}\n")
        f.write(f"Scattering coefficient (km-1) : {k_sca}\n")
        f.write(f"Nb angles : {n_angles}\n")
        f.write("ANGLE F11 -F12/F11 F22/F11 F33/F11\n")
        for j in range(n_angles):
            m2 = mu[j] * mu[j]
            f.write(f"{ang[j]:8.3f} {f11[j]:.10e} "
                    f"{(1.0 - m2) / (1.0 + m2):.10e} 1.0 "
                    f"{2.0 * mu[j] / (1.0 + m2):.10e}\n")


def _common(res_root, nbmu_lum: int, nbmu_mie: int) -> dict:
    kw = {
        "-SOS_Main.Wa": "0.440",
        "-ANG.Thetas": "40.00",
        "-ANG.Rad.NbGauss": str(nbmu_lum),
        "-ANG.Aer.NbGauss": str(nbmu_mie),
        "-AP.MOT": "0.230",
        "-AP.AerProfile.Type": "1",
        "-AP.HR": "8",
        "-AP.AerHS.HA": "2",
        "-AP.AbsProfile.Type": "7",
        "-SURF.Type": "0",
        "-SURF.Alb": "0.02",
        "-SOS.View": "1",
        "-SOS.View.Phi": "35",
        "-SOS.IGmax": "30",
    }
    if res_root is not None:
        kw.update({"-SOS_Main.ResRoot": str(res_root),
                   "-SOS.Flux": "FicFlux.txt"})
    return kw


def slice_keywords(res_root, ext_file, nbmu_lum: int = 24,
                   nbmu_mie: int = 40) -> dict:
    """The slice case; ``ext_file`` from :func:`write_hg_phase_file`."""
    kw = _common(res_root, nbmu_lum, nbmu_mie)
    kw.update({"-AER.Model": "4", "-AER.ExtData": str(ext_file),
               "-AER.Waref": "0.440", "-AER.AOTref": "0.300",
               "-AER.Tronca": "1"})
    return kw


def rayleigh_keywords(res_root, nbmu_lum: int = 24,
                      nbmu_mie: int = 40) -> dict:
    """The slice geometry over a Rayleigh-only atmosphere (AOT 0)."""
    return _common(res_root, nbmu_lum, nbmu_mie)
