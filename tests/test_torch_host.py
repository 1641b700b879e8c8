"""The port's copies of the numpy-only host modules vs their originals.

JAX is not installed where the port runs on the card, and importing any
module of the JAX package imports JAX (its ``__init__``), so the port
carries copies of the host modules it needs.  Each copy must give results
equal to its original on the same inputs: the code is the same NumPy, so
equality is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import radiativetransfer_sos_torch as T
import radiativetransfer_sos_tpu as J
from radiativetransfer_sos_torch import (aerosols as t_aer, angles as t_ang,
                                         config as t_cfg, constants as t_cte,
                                         external_aerosols as t_ext,
                                         gsf as t_gsf, legendre as t_leg,
                                         profile as t_prof, proc as t_proc,
                                         recompose as t_rec)
from radiativetransfer_sos_tpu import (aerosols as j_aer, angles as j_ang,
                                       config as j_cfg, constants as j_cte,
                                       external_aerosols as j_ext,
                                       gsf as j_gsf, legendre as j_leg,
                                       profile as j_prof, proc as j_proc,
                                       recompose as j_rec)
from torch_parity import write_external_file


def _assert_same(a, b, path="result"):
    """Exact equality through dataclasses, tuples, dicts and arrays."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _grids(mod):
    lum = mod.make_radiance_grid(40.0, 10)
    mie = mod.make_mie_grid(12)
    return lum, mie


def case_constants(m, tmp_path):
    cte = t_cte if m is T else j_cte
    return {k: getattr(cte, k) for k in dir(cte) if k.isupper()}


def case_config_validate(m, tmp_path):
    cfg_mod = t_cfg if m is T else j_cfg
    cfg = cfg_mod.SosConfig(wavelength=0.44)
    cfg.angles.thetas_deg = 40.0
    cfg.aerosols.aot_ref = 0.3
    cfg.aerosols.model = 4
    cfg.aerosols.external_file = "x.txt"
    cfg.profile.ha = 2.0
    cfg.validate()
    msgs = []
    for bad in (dict(wavelength=9.0), dict(igmax=0)):
        c = cfg_mod.SosConfig(**bad)
        with pytest.raises(ValueError) as exc:
            c.validate()
        msgs.append(str(exc.value))
    return dataclasses.asdict(cfg), msgs


def case_radiance_grid(m, tmp_path):
    ang = t_ang if m is T else j_ang
    return (ang.make_radiance_grid(40.0, 10),
            ang.make_radiance_grid(33.0, 7, np.array([0.0, 12.5, 60.0])),
            ang.make_radiance_grid(40.0, 10, inject_solar=False),
            ang.make_mie_grid(12), ang.make_mie_grid(5, np.array([3.0])),
            ang.expansion_orders(12, 10), ang.expansion_orders(None, None))


def case_legendre(m, tmp_path):
    leg = t_leg if m is T else j_leg
    x = np.linspace(-1.0, 1.0, 17)
    b22 = np.linspace(1.0, 0.1, 13)
    d33 = np.cos(np.arange(13.0))
    return (leg.legendre_table(x, 12), leg.gsf2_table(x, 12),
            leg.alpha_zeta_from(b22, d33))


def case_gsf_basis(m, tmp_path):
    g = t_gsf if m is T else j_gsf
    lum = (t_ang if m is T else j_ang).make_radiance_grid(40.0, 10)
    return g.gsf_basis(lum.mu, lum.mus, 24, 25)


def case_external_phase_matrix(m, tmp_path):
    ext = t_ext if m is T else j_ext
    _, mie = _grids(t_ang if m is T else j_ang)
    path = write_external_file(tmp_path / "hg.txt")
    x = np.linspace(-1.0, 1.0, 21)
    return (ext.parse_external_file(path), ext.external_phase_matrix(path, mie),
            ext.spline_resample(x, np.exp(x), np.linspace(-0.97, 0.97, 40)))


def case_decompose_legendre(m, tmp_path):
    aer = t_aer if m is T else j_aer
    ext = t_ext if m is T else j_ext
    _, mie = _grids(t_ang if m is T else j_ang)
    out = []
    for g in (0.7, 0.9):           # 0.9 keeps the truncation (coef >= 0.1)
        pm = ext.external_phase_matrix(
            write_external_file(tmp_path / f"hg{g}.txt", g=g), mie)
        for itronc in (True, False):
            out.append(aer.decompose_legendre(pm, mie.mu, mie.w, 24, itronc))
    return out


def case_profiles(m, tmp_path):
    prof = t_prof if m is T else j_prof
    return (prof.exp_profile_no_gas(0.23, 8.0, 0.3, 2.0),
            prof.exp_profile_no_gas(0.23, 8.0, 0.0, -999.0),
            prof.exp_profile_no_gas(0.1, 8.0, 0.05, 1.0).padded(140),
            prof.slab_profile(0.23, 8.0, 0.3, 1.0, 3.0))


def case_truncation_adjust(m, tmp_path):
    p = t_proc if m is T else j_proc
    prof = t_prof.exp_profile_no_gas(0.23, 8.0, 0.3, 2.0)
    return (p.truncation_adjust(prof.h[None], prof.pcaer[None],
                                prof.pcmol[None], 0.95, 0.9, 0.3),
            p.truncation_adjust(prof.h, prof.pcaer, prof.pcmol, 0.95, 0.95,
                                0.0),
            p.rayleigh_mot(0.44, 1013.0), p.rayleigh_mot(0.865, 980.0))


def case_recompose(m, tmp_path):
    rec = t_rec if m is T else j_rec
    rng = np.random.default_rng(5)
    n = 6
    records = rng.standard_normal((9, 3, 2 * n + 1)) * 1e-2
    records[:, 0] = np.abs(records[:, 0]) + 0.05
    records[3, 1, 2] = 1e-17                  # zeroed by the add-back pass
    mu = np.sort(rng.uniform(0.1, 1.0, n))[::-1]
    phis = np.radians([215.0, 35.0, 90.0])
    f = rec.recompose_np(records, phis)
    terms = rec.DirectTerms()
    xi, xq, xu = rec.add_direct_terms(f[:, 0], f[:, 1], f[:, 2], mu, 2,
                                      -0.766, 0.5, 0.0, phis, terms)
    one = rec.add_direct_terms(f[0, 0], f[0, 1], f[0, 2], mu, 2, -0.766,
                               0.5, 0.0, phis[0], terms)
    return (f, rec.recompose_np(records, 0.3), (xi, xq, xu), one,
            rec.polar_params(xi, xq, xu),
            rec.scattering_angles(np.concatenate([-mu, mu]), -0.766,
                                  phis[:, None]))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_copy_matches_original(name, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = CASES[name](T, tmp_path / "t")
    want = CASES[name](J, tmp_path / "j")
    _assert_same(got, want, name)
