"""Atmospheric optical-depth profile discretizer (no gaseous absorption).

Copy of the scattering-only part of the JAX package's ``profile.py``
(reference ``SOS_PROFILE``, ``src/SOS_PROFIL.F:224``, and ``SOS_DISC``,
``src/SOS_PROFIL.F:1210``); ``tests/test_torch_host.py`` pins it to the
original.  Host-side float64 NumPy:

* ``IPROFIL=1`` without gas — exponential molecular (scale height HR) +
  exponential aerosol (HA); adaptive layering: first layer ``tau = 2e-4``,
  following layers ``~0.005`` (``inc/SOS.h:202-235``), min 100 layers
  (``src/SOS_PROFIL.F:341-489``).
* ``IPROFIL=2`` — homogeneous aerosol slab between ZMIN and ZMAX with
  molecular background and transition sublayers (``src/SOS_PROFIL.F:807-950``).

The profile merged with a gaseous-absorption tau profile
(``exp_profile_with_gas``) comes with the CKD port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as cte


@dataclasses.dataclass(frozen=True)
class Profile:
    """Discretized profile; level 0 = TOA, level nt = bottom."""
    zprof: np.ndarray   # (nt+1,) level altitudes (km)
    h: np.ndarray       # (nt+1,) cumulative optical depth (mol+aer+abs)
    pcaer: np.ndarray   # (nt+1,) aerosol fraction of the layer extinction
    pcmol: np.ndarray   # (nt+1,) molecular fraction

    @property
    def nt(self) -> int:
        return int(self.h.shape[0] - 1)

    def padded(self, nt_max: int) -> "Profile":
        """Static-shape padding: replicate the bottom level (zero-thickness
        layers are exact no-ops for the sweep integrator)."""
        nt = self.nt
        if nt > nt_max:
            raise ValueError(f"profile has {nt} layers > nt_max={nt_max}")
        pad = nt_max - nt
        rep = lambda a: np.concatenate([a, np.full(pad, a[-1])])
        return Profile(zprof=rep(self.zprof), h=rep(self.h),
                       pcaer=rep(self.pcaer), pcmol=rep(self.pcmol))


def _disc(dt, ta, ha, tr, hr, tabs, altabs, tim1, zmax_init, tg_zlim, zlim):
    """Bisection tau->z inversion (``SOS_DISC``, ``src/SOS_PROFIL.F:1210``)."""
    ti = tim1 + dt
    zmax = zmax_init
    zmin = zlim
    for _ in range(10000):
        zmoy = (zmax + zmin) / 2.0
        if tg_zlim > 0.0:
            if zmoy > altabs[0]:
                tg = tabs[0]
            else:
                # bounded, unlike the reference's DO WHILE (SOS_DISC) which
                # reads past ALTABS when zmoy falls below the lowest table
                # altitude; clamping extrapolates the bottom layer linearly
                j = 1
                while j < len(altabs) and zmoy < altabs[j]:
                    j += 1
                if j >= len(altabs):
                    j = len(altabs) - 1
                zz = (zmoy - altabs[j - 1]) / (altabs[j] - altabs[j - 1])
                tg = (1.0 - zz) * tabs[j - 1] + zz * tabs[j]
        else:
            tg = 0.0
        tzmoy = ta * np.exp(-zmoy / ha) + tr * np.exp(-zmoy / hr) + tg
        if abs(ti - tzmoy) < 1.0e-6 or zmoy == 0.0:
            return zmoy
        if ti - tzmoy < 0.0:
            zmin = zmoy
        else:
            zmax = zmoy
    raise RuntimeError(
        f"tau->z bisection did not converge (ta={ta}, ha={ha}, tr={tr}, "
        f"hr={hr}) — check scale heights are positive")


def _layer_counts(ttot):
    """(nt, t_first, t_layer) for a scattering-only column
    (``src/SOS_PROFIL.F:344-392``)."""
    if ttot / cte.OS_NT_MIN <= cte.TOA_FIRST_LAYER_OPT_THICKNESS:
        nt = cte.OS_NT_MIN
        t_layer = ttot / nt
        t_first = t_layer
    elif ttot / cte.OS_NT_MIN < cte.TCOUCHE:
        nt = cte.OS_NT_MIN + 1
        t_first = cte.TOA_FIRST_LAYER_OPT_THICKNESS
        t_layer = (ttot - t_first) / cte.OS_NT_MIN
    else:
        t_first = cte.TOA_FIRST_LAYER_OPT_THICKNESS
        nt = int((ttot - t_first) / cte.TCOUCHE)
        t_layer = (ttot - t_first) / nt
        nt += 1
    return nt, t_first, t_layer


def exp_profile_no_gas(tr, hr, ta, ha):
    """Scattering-only exponential profile (``src/SOS_PROFIL.F:398-489``)."""
    ttot = tr + ta
    nt, t_first, t_layer = _layer_counts(ttot)
    zprof = np.zeros(nt + 1)
    hmol = np.zeros(nt + 1)
    haer = np.zeros(nt + 1)
    h = np.zeros(nt + 1)
    pcm = np.zeros(nt + 1)
    pca = np.zeros(nt + 1)
    zprof[0] = cte.TOA_ALT

    if ta == 0.0:
        hmol[1] = t_first
        for i in range(2, nt + 1):
            hmol[i] = (i - 1) * t_layer + t_first
        pcm[:] = 1.0
        h[:] = hmol
        zprof[1:] = hr * np.log(tr / hmol[1:])
    else:
        # level 1: step down in altitude until the first-layer tau is reached
        dtau = 0.0
        z = cte.TOA_ALT
        while dtau < t_first:
            z -= cte.DELTA_Z
            dtau = tr * np.exp(-z / hr) + ta * np.exp(-z / ha)
        zprof[1] = z
        vr = tr * np.exp(-z / hr)
        va = ta * np.exp(-z / ha)
        hmol[1], haer[1], h[1] = vr, va, dtau
        pcm[1] = vr / dtau
        pca[1] = va / dtau
        pcm[0], pca[0] = pcm[1], pca[1]
        dummy_tabs = np.zeros(cte.ABS_NBLEV)
        dummy_alt = np.linspace(cte.TOA_ALT, 0.0, cte.ABS_NBLEV)
        for i in range(2, nt):
            z = _disc(t_layer, ta, ha, tr, hr, dummy_tabs, dummy_alt,
                      h[i - 1], zprof[1], 0.0, 0.0)
            zprof[i] = z
            vr = tr * np.exp(-z / hr)
            va = ta * np.exp(-z / ha)
            hmol[i], haer[i] = vr, va
            h[i] = vr + va
            dvr = vr - hmol[i - 1]
            dva = va - haer[i - 1]
            pcm[i] = dvr / (dvr + dva)
            pca[i] = dva / (dvr + dva)
        zprof[nt] = 0.0
        hmol[nt], haer[nt] = tr, ta
        h[nt] = tr + ta
        dvr = tr - hmol[nt - 1]
        dva = ta - haer[nt - 1]
        pcm[nt] = dvr / (dvr + dva)
        pca[nt] = dva / (dvr + dva)
    return Profile(zprof=zprof, h=h, pcaer=pca, pcmol=pcm)


def slab_profile(tr, hr, ta, zmin, zmax):
    """Homogeneous aerosol slab between two altitudes (IPROFIL=2).

    Reference ``src/SOS_PROFIL.F:807-950``; no gaseous absorption.
    """
    if zmin < 0.0 or zmax <= zmin:
        raise ValueError("need 0 <= zmin < zmax")
    ttot = tr + ta
    nt = int(ttot / cte.TCOUCHE)
    nt = min(nt, cte.OS_NT)

    vr_c1 = tr * np.exp(-(zmax + cte.DZTRANSI) / hr)
    vr_c2 = tr * (np.exp(-zmin / hr) - np.exp(-(zmax + cte.DZTRANSI) / hr))
    if zmin == 0.0:
        vr_c3 = 0.0
        nb_tr = 1
    else:
        vr_c3 = tr * (1.0 - np.exp(-(zmin - cte.DZTRANSI) / hr))
        nb_tr = 2

    nbsc_c1 = int((nt - nb_tr) * vr_c1 / (tr + ta))
    nbsc_c1 = max(cte.PROFIL_MIN_NBC, nbsc_c1)
    if zmin == 0.0:
        nbsc_c3 = 0
    else:
        nbsc_c3 = int((nt - nb_tr) * vr_c3 / (tr + ta))
        nbsc_c3 = max(cte.PROFIL_MIN_NBC, nbsc_c3)
    nbsc_c2 = (nt - nb_tr) - nbsc_c1 - nbsc_c3
    if ta / nbsc_c2 < 1.0e-5:
        raise ValueError("AOT too small for the slab profile definition")

    hmol = np.zeros(nt + 1)
    haer = np.zeros(nt + 1)
    hmol[0] = tr * np.exp(-cte.TOA_ALT / hr)

    vr_sc = vr_c1 / nbsc_c1
    for i in range(1, nbsc_c1 + 1):
        hmol[i] = hmol[i - 1] + vr_sc
        haer[i] = 0.0

    i = nbsc_c1 + 1
    hmol[i] = tr * np.exp(-zmax / hr)
    vr_sc = hmol[i] - hmol[i - 1]
    haer[i] = haer[i - 1] + ta * vr_sc / vr_c2

    delta_z = (zmax - zmin) / nbsc_c2
    z = zmax
    for i in range(nbsc_c1 + 2, nbsc_c1 + nbsc_c2 + 2):
        z -= delta_z
        hmol[i] = tr * np.exp(-z / hr)
        vr_sc = hmol[i] - hmol[i - 1]
        haer[i] = haer[i - 1] + ta * vr_sc / vr_c2

    if zmin != 0.0:
        i = nbsc_c1 + nbsc_c2 + 2
        hmol[i] = tr * np.exp(-(zmin - cte.DZTRANSI) / hr)
        haer[i] = haer[i - 1]
        vr_sc = vr_c3 / nbsc_c3
        for i in range(nbsc_c1 + nbsc_c2 + 3, nt + 1):
            hmol[i] = vr_sc + hmol[i - 1]
            haer[i] = haer[i - 1]

    zprof = np.zeros(nt + 1)
    h = np.zeros(nt + 1)
    pca = np.zeros(nt + 1)
    pcm = np.zeros(nt + 1)
    zprof[0] = cte.TOA_ALT
    h[0] = hmol[0]
    pcm[0] = 1.0
    for i in range(1, nt + 1):
        h[i] = hmol[i] + haer[i]
        zprof[i] = hr * np.log(tr / hmol[i])
        if haer[i] == haer[i - 1]:
            pca[i] = 0.0
            pcm[i] = 1.0
        else:
            pcm[i] = 1.0 / (1.0 + ta / vr_c2)
            pca[i] = 1.0 - pcm[i]
    return Profile(zprof=zprof, h=h, pcaer=pca, pcmol=pcm)
