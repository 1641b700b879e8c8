"""The port's main path end to end against the JAX package, on the CPU.

``proc.sos_run`` of both packages on the same keyword sets (float64, CPU),
at a small size (10 radiance and 12 Mie Gauss angles: N = 11, NT = 106,
OS_NB = 24):

* the slice case (``cases.slice_keywords``: external Henyey-Greenstein
  aerosol g = 0.7, whose truncation auto-cancels), the same with g = 0.9
  (truncation kept, so the profile rescale runs), and the Rayleigh case
  (AOT 0, 3 Fourier orders);
* tables (I, Q, U, polarization rate) and fluxes at rtol 1e-9, the Fourier
  records at rtol 1e-9 plus 1e-14 of the largest record;
* ``SOS_Up.txt`` / ``SOS_Down.txt`` / ``FicFlux.txt`` equal to their
  printed precision (one unit of the last printed digit).

Plus the entry points a user calls (``sos_proc``, the CLI as a
subprocess), the isolation of the port from JAX, and ``chip_smoke.py``'s
refusal to run without a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from radiativetransfer_sos_torch import api as t_api
from radiativetransfer_sos_torch import cases
from radiativetransfer_sos_torch import proc as t_proc
from radiativetransfer_sos_tpu import api as j_api
from radiativetransfer_sos_tpu import proc as j_proc
from torch_parity import write_external_file

RTOL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(nbmu_lum=10, nbmu_mie=12)


def _keywords(name, res_root, tmp_path):
    if name == "rayleigh":
        return cases.rayleigh_keywords(res_root, **SMALL)
    g = 0.9 if name == "slice-truncated" else 0.7
    ext = write_external_file(tmp_path / f"hg{g}.txt", g=g)
    return cases.slice_keywords(res_root, ext, **SMALL)


@pytest.fixture(scope="module", params=["slice", "slice-truncated",
                                        "rayleigh"])
def both(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    out = {}
    for tag, api, proc in (("torch", t_api, t_proc), ("jax", j_api, j_proc)):
        cfg = api.config_from_keywords(
            _keywords(request.param, tmp / tag, tmp))
        kw = dict(device="cpu") if tag == "torch" else {}
        res = proc.sos_run(cfg, **kw)
        api.write_result_files(cfg, res)
        out[tag] = (res, tmp / tag / "SOS")
    return request.param, out


def test_tables_match_jax(both):
    name, out = both
    (got, _), (want, _) = out["torch"], out["jax"]
    assert got.records_up.shape == want.records_up.shape
    n_s = 3 if name == "rayleigh" else 25
    assert got.records_up.shape[0] == n_s
    np.testing.assert_allclose(
        got.records_up, want.records_up, rtol=RTOL,
        atol=1e-14 * np.max(np.abs(want.records_up)))
    for side in ("up", "down"):
        for key in ("i", "q", "u", "pol_rate", "l_pol", "sca"):
            np.testing.assert_allclose(getattr(got, side)[key],
                                       getattr(want, side)[key], rtol=RTOL,
                                       err_msg=f"{side}.{key}")
    for attr in ("emoins", "eplus", "ttot_tronc", "ttot_vrai", "coef_tronca",
                 "flux_dir_down", "flux_diff_down", "flux_tot_down"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr),
                                   rtol=RTOL, err_msg=attr)
    np.testing.assert_array_equal(got.phi, want.phi)
    np.testing.assert_array_equal(got.theta, want.theta)
    if name == "slice-truncated":
        assert got.coef_tronca > 0.1


_NUM = re.compile(r"-?\d+\.\d+(?:[eE][-+]\d+)?")


def _printed_unit(token: str) -> float:
    """One unit of the last printed digit of a %f / %e token; a value
    printed in full (``%s`` of a float) is held to ``RTOL`` instead."""
    mant, _, exp = token.lower().partition("e")
    digits = len(mant.split(".")[1])
    return max(10.0 ** (int(exp or 0) - digits), RTOL * abs(float(token)))


@pytest.mark.parametrize("fname", ["SOS_Up.txt", "SOS_Down.txt",
                                   "FicFlux.txt"])
def test_result_files_match_jax(both, fname):
    _, out = both
    got = (out["torch"][1] / fname).read_text().splitlines()
    want = (out["jax"][1] / fname).read_text().splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        ta, tb = _NUM.findall(a), _NUM.findall(b)
        assert _NUM.sub("#", a) == _NUM.sub("#", b)    # same layout
        for x, y in zip(ta, tb):
            assert abs(float(x) - float(y)) <= 1.0001 * _printed_unit(y), \
                (a, b)


def test_sos_proc_tuple_matches_jax(tmp_path):
    kw = dict(wa_simu=0.55, tetas=32.0, nbmu_gauss_lum=6, isurf=0, rho=0.1,
              absprofil=7, itrphi=2, pas_phi=90, igmax=20)
    got = t_api.sos_proc(device="cpu", resroot=str(tmp_path / "t"), **kw)
    want = j_api.sos_proc(resroot=str(tmp_path / "j"), **kw)
    assert len(got) == len(want) == 23
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-15)
    assert (tmp_path / "t" / "SOS" / "SOS_Up.txt").exists()


@pytest.mark.parametrize("keyword,value,match", [
    ("-AER.Model", "1", "ROADMAP A6"),
    ("-AP.AbsProfile.Type", "2", "ROADMAP A8"),
    ("-SURF.Type", "3", "ROADMAP A7"),
    ("-SOS.OutputAlt", "3.0", "ROADMAP A10"),
    ("-SOS.Trans", "T.txt", "ROADMAP A10"),
    ("-AER.Log", "aer.log", "ROADMAP A14"),
])
def test_unported_options_raise(tmp_path, keyword, value, match):
    kw = cases.rayleigh_keywords(None, 4, 4)
    kw[keyword] = value
    if keyword == "-AER.Model":
        kw.update({"-AER.AOTref": "0.1", "-AER.WMO.Model": "1",
                   "-AER.Waref": "0.44", "-AP.AerHS.HA": "2"})
    if keyword == "-SURF.Type":
        kw.update({"-SURF.Roujean.K0": "0.1", "-SURF.Roujean.K1": "0.1",
                   "-SURF.Roujean.K2": "0.1"})
    cfg = t_api.config_from_keywords(kw)
    with pytest.raises(NotImplementedError, match=match):
        t_proc.sos_run(cfg, device="cpu")


def _run(args, tmp_path, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=600,
                          **kw)


def test_cli_subprocess(tmp_path):
    """``python -m radiativetransfer_sos_torch.cli`` with the reference's
    keywords: JOB_STATUS=OK and the products on disk; status 1 on error."""
    argv = ["-SOS_Main.Wa", "0.550", "-SOS_Main.ResRoot", str(tmp_path),
            "-ANG.Rad.NbGauss", "8", "-ANG.Thetas", "35.",
            "-SOS.View", "1", "-SOS.View.Phi", "0.", "-AP.HR", "8.0",
            "-AP.AbsProfile.Type", "7", "-SURF.Type", "0", "-SURF.Alb", "0.1",
            "-SOS.IGmax", "20", "-SOS.Flux", "FicFlux.txt"]
    p = _run(["-m", "radiativetransfer_sos_torch.cli", *argv], tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "JOB_STATUS=OK" in p.stdout
    rows = [ln for ln in (tmp_path / "SOS" / "SOS_Up.txt").read_text()
            .splitlines() if ln and not ln.startswith("#")]
    assert len(rows) == 18          # (8 Gauss + solar slot) x half-planes
    assert (tmp_path / "SOS" / "FicFlux.txt").exists()
    bad = _run(["-m", "radiativetransfer_sos_torch", "-SOS_Main.Wa", "99.0"],
               tmp_path)
    assert bad.returncode == 1 and "ERROR" in bad.stderr


_ISOLATED = r"""
import sys
sys.modules["jax"] = None                         # any import of jax fails
sys.modules["radiativetransfer_sos_tpu"] = None
import radiativetransfer_sos_torch
from radiativetransfer_sos_torch import (_build, aerosols, angles, api, cases,
    cli, config, constants, external_aerosols, gsf, kernels, legendre, ops,
    precision, proc, profile, recompose, solver, tracing)
cfg = api.config_from_keywords(cases.rayleigh_keywords(None, 6, 6))
res = proc.sos_run(cfg, device="cpu")
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
print("I0", res.up["i"][0, 0])
"""


def test_port_runs_with_jax_blocked(tmp_path):
    p = _run(["-c", _ISOLATED], tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    assert float(p.stdout.split("I0")[1]) > 0.0


def test_port_sources_never_name_jax():
    pkg = os.path.join(ROOT, "radiativetransfer_sos_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        paths += [os.path.join(d, f) for f in files
                  if f.endswith((".py", ".cu"))]
    for path in paths:
        text = open(path).read()
        assert "import jax" not in text, path
        assert "from jax" not in text, path
        assert "radiativetransfer_sos_tpu" not in text, path


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CPU fallback: without a card the smoke script exits non-zero and
    prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    p = _run([os.path.join(ROOT, "chip_smoke.py")], tmp_path)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
