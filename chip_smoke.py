#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port ``radiativetransfer_sos_torch``.

Run from the repository root with no arguments, on a machine with one CUDA
card (Hopper, sm_90a) and the CUDA toolkit::

    python3 chip_smoke.py

Phases, one line each (or a few):

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build of the hand-written kernels from ``radiativetransfer_sos_torch/
   csrc`` with nvcc, and its time;
3. each kernel against its plain PyTorch version on the card, float32 and
   float64, at two ragged shapes, the slice's shape and the demo shape,
   with the bounds below; times of kernel and plain version (CUDA events);
4. the slice case (``radiativetransfer_sos_torch.cases.slice_keywords``:
   the binding smoke case with an external Henyey-Greenstein aerosol, no
   gas, a Lambertian ground) through ``proc.sos_run(device="cuda")`` and
   ``api.write_result_files``; both kernels must have launched during it;
   its tables must be finite with I > 0 and 0 <= pol_rate <= 100; CUDA
   float64 must equal the port on CPU float64 (which the CPU tests pin to
   the JAX package); the float32 error against float64 is printed;
5. the demo-shape solve (``precision.demo_problem``, 16 terms, float32):
   warm time per solve, terms/s, and a device-time profile.

Then one JSON line with each kernel's launches on the slice run, its error
and times, the card line, and last ``{"ok": true, "device": {...}}``.
Any failed phase raises, so the exit code is non-zero and no result line is
printed; so does a machine without a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: kernel vs plain version: max |kernel - plain| <= REL * max |plain|
#: (float64: summation order and one-ulp exp differences only; float32:
#: the same over up to ~600 recurrence steps and K = 4*3N products)
KERNEL_REL = {"float64": 1e-12, "float32": 1e-4}
#: slice on CUDA float64 vs the port on CPU float64:
#: |cuda - cpu| <= RTOL |cpu| + ATOL_REL * max |cpu|
SLICE_RTOL, SLICE_ATOL_REL = 1e-10, 1e-14
#: loose sanity bound on the float32 slice against float64
#: (precision.rel_err); the port's real float32 gate is set from this number
F32_SANITY = 5e-3

_ROOT = os.path.dirname(os.path.abspath(__file__))
_PKG = "radiativetransfer_sos_torch"
#: the Pallas module of the JAX reference package, named by its file only:
#: the port's sources never name that package
_PALLAS = "pallas_ops.py"


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _sweep_case(torch, rng, s_n, t_n, l_n, hp, dtype, zero_layers=()):
    """Random sweep operands; ``zero_layers`` get dtau = 0 (identity)."""
    from radiativetransfer_sos_torch import ops

    dh = rng.uniform(1e-4, 5e-2, size=(t_n, l_n - 1))
    for j in zero_layers:
        dh[:, j] = 0.0
    h = np.concatenate([np.zeros((t_n, 1)), np.cumsum(dh, axis=1)], axis=1)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()

    return (t(rng.standard_normal((s_n, t_n, l_n, hp))),
            t(rng.standard_normal((s_n, t_n, l_n, hp))),
            ops.sweep_coeffs(t(h)), t(rng.uniform(0.05, 1.0, hp)),
            t(rng.standard_normal((s_n, t_n, hp))))


def _scatter_case(torch, rng, s_n, t_n, l_n, hp, dtype):
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()

    x = rng.uniform(0.0, 1.0, (t_n, l_n))
    return (t(rng.standard_normal((s_n, t_n, l_n, hp))),
            t(rng.standard_normal((s_n, t_n, l_n, hp))), t(x), t(1.0 - x),
            t(0.01 * rng.standard_normal((s_n, 4 * hp, 2 * hp))))


def _compare(torch, name, kernel, plain, args, dtype_name):
    """Kernel vs plain on the same operands; raises past the bound."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    bound = KERNEL_REL[dtype_name] * scale
    if not err <= bound:
        raise AssertionError(f"{name} {dtype_name}: max |kernel - plain| "
                             f"{err:.3e} > {bound:.3e}")
    if dtype_name == "float32":
        # both float32 versions against the plain version in float64 on the
        # same (float32-rounded) operands: the kernel must be as accurate
        want64 = plain(*(a.double() for a in args))
        e_k = max(float((g.double() - w).abs().max())
                  for g, w in zip(got, want64))
        e_p = max(float((g.double() - w).abs().max())
                  for g, w in zip(want, want64))
        return err, f" (vs float64: kernel {e_k:.3e}, plain {e_p:.3e})"
    return err, ""


def phase_kernels(torch, ops, slice_shape):
    """Phase 3: every kernel against its plain version; returns the
    slice-shape float32 numbers for the JSON line."""
    rng = np.random.default_rng(2024)
    n_s, n_l, n_hp = slice_shape
    shapes = {"ragged-a": (3, 1, 37, 21, (0, 5, 6, 35)),
              "ragged-b": (2, 3, 53, 15, (17, 50, 51)),
              "slice": (n_s, 1, n_l, n_hp, ()),
              "demo": (81, 16, 601, 123, ())}
    summary = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for label, (s_n, t_n, l_n, hp, zl) in shapes.items():
            sc = _scatter_case(torch, rng, s_n, t_n, l_n, hp, dtype)
            sw = _sweep_case(torch, rng, s_n, t_n, l_n, hp, dtype, zl)
            e_sc, x_sc = _compare(torch, "scatter", ops.scatter,
                                  ops.scatter_plain, sc, dname)
            e_sw, x_sw = _compare(torch, "sweep", ops.sweep,
                                  ops.sweep_plain, sw, dname)
            line = (f"[3] {dname} {label} (S,T,L,HP)=({s_n},{t_n},{l_n},"
                    f"{hp}): max |kernel - plain| scatter {e_sc:.3e}{x_sc},"
                    f" sweep {e_sw:.3e}{x_sw}")
            if label in ("slice", "demo"):
                reps = 20 if label == "slice" else 5
                t = {}
                for key, fn, args in (
                        ("scatter_plain", ops.scatter_plain, sc),
                        ("scatter", ops.scatter, sc),
                        ("sweep_plain", ops.sweep_plain, sw),
                        ("sweep", ops.sweep, sw)):
                    t[key] = _time_ms(torch, lambda: fn(*args), reps)
                # plain, kernel, kernel, plain: average each pair
                for key, fn, args in (
                        ("sweep", ops.sweep, sw),
                        ("sweep_plain", ops.sweep_plain, sw),
                        ("scatter", ops.scatter, sc),
                        ("scatter_plain", ops.scatter_plain, sc)):
                    t[key] = 0.5 * (t[key] + _time_ms(
                        torch, lambda: fn(*args), reps))
                line += (f"; ms scatter {t['scatter']:.4f} (plain "
                         f"{t['scatter_plain']:.4f}), sweep {t['sweep']:.4f}"
                         f" (plain {t['sweep_plain']:.4f})")
                summary[(dname, label)] = dict(scatter=(e_sc, t["scatter"],
                                                        t["scatter_plain"]),
                                               sweep=(e_sw, t["sweep"],
                                                      t["sweep_plain"]))
            print(line, flush=True)
            del sc, sw
            torch.cuda.empty_cache()
    return summary


def _close(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    return bool(np.all(np.abs(a - b) <= SLICE_RTOL * np.abs(b)
                       + SLICE_ATOL_REL * scale))


def phase_slice(torch, api, cases, ops, precision, proc, workdir):
    """Phase 4: the slice case end to end; returns the launch counts."""
    ext = os.path.join(workdir, "hg_g07.txt")
    cases.write_hg_phase_file(ext)
    kw = cases.slice_keywords(os.path.join(workdir, "out"), ext)
    cfg = api.config_from_keywords(kw)

    ops.reset_launches()
    t0 = time.perf_counter()
    res = proc.sos_run(cfg, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    api.write_result_files(cfg, res)
    print(f"[4] slice sos_run cuda float32: {wall:.3f} s wall (first call), "
          f"stages {json.dumps({k: round(v, 4) for k, v in res.timings.items()})}"
          f", launches {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "slice run")
    t0 = time.perf_counter()
    warm = proc.sos_run(cfg, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"[4] slice sos_run cuda float32 warm: "
          f"{time.perf_counter() - t0:.4f} s wall, stages "
          f"{json.dumps({k: round(v, 4) for k, v in warm.timings.items()})}",
          flush=True)
    _profile(torch, "[4] one warm slice sos_run",
             lambda: proc.sos_run(cfg, device="cuda", dtype=torch.float32))

    n = res.grid.n
    for side, tabs in (("up", res.up), ("down", res.down)):
        for key in ("i", "q", "u", "pol_rate", "pol_ang", "l_pol", "sca"):
            v = tabs[key]
            if v.shape != (2, n) or not np.all(np.isfinite(v)):
                raise AssertionError(f"{side} {key}: shape {v.shape} or "
                                     "non-finite values")
        if not np.all(tabs["i"] > 0.0):
            raise AssertionError(f"{side} I not positive")
        if not np.all((tabs["pol_rate"] >= 0.0) & (tabs["pol_rate"] <= 100.0)):
            raise AssertionError(f"{side} pol_rate outside [0, 100]")
    outdir = os.path.join(workdir, "out", "SOS")
    for fname in ("SOS_Up.txt", "SOS_Down.txt", "FicFlux.txt"):
        path = os.path.join(outdir, fname)
        if not os.path.getsize(path):
            raise AssertionError(f"{fname} is empty")
    rows = [ln for ln in open(os.path.join(outdir, "SOS_Up.txt"))
            if not ln.startswith("#")]
    if len(rows) != 2 * n:
        raise AssertionError(f"SOS_Up.txt has {len(rows)} rows, want {2 * n}")

    t0 = time.perf_counter()
    res64 = proc.sos_run(cfg, device="cuda", dtype=torch.float64)
    wall64 = time.perf_counter() - t0
    ref = proc.sos_run(cfg, device="cpu", dtype=torch.float64)
    pairs = [("records", res64.records_up, ref.records_up),
             ("emoins", res64.emoins, ref.emoins),
             ("eplus", res64.eplus, ref.eplus)]
    for side in ("up", "down"):
        for key in ("i", "q", "u", "pol_rate"):
            pairs.append((f"{side}.{key}", getattr(res64, side)[key],
                          getattr(ref, side)[key]))
    worst = max(float(np.max(np.abs(np.asarray(a) - b)
                             / np.maximum(np.abs(b), 1e-300)))
                for _, a, b in pairs)
    bad = [name for name, a, b in pairs if not _close(a, b)]
    print(f"[4] slice cuda float64 vs cpu float64: {wall64:.3f} s wall, "
          f"worst relative difference {worst:.3e}, N = {n}, "
          f"records {ref.records_up.shape}", flush=True)
    if bad:
        raise AssertionError(f"cuda float64 differs from cpu float64 in {bad}")

    err_rec = precision.rel_err(res.records_up, res64.records_up)
    err_tab = max(precision.rel_err(getattr(res, s)[k], getattr(res64, s)[k])
                  for s in ("up", "down") for k in ("i", "q", "u"))
    print(f"[4] slice float32 vs float64 rel_err: records {err_rec:.3e}, "
          f"I/Q/U tables {err_tab:.3e} (sanity bound {F32_SANITY})",
          flush=True)
    if not max(err_rec, err_tab) <= F32_SANITY:
        raise AssertionError("float32 slice past the sanity bound")
    return launches


def phase_demo(torch, precision, solver, summary):
    """Phase 5: demo-shape solve throughput and device-time profile."""
    prob = precision.demo_problem(torch.float32, "cuda", n_terms=16)
    res = solver.solve_fourier_batch(prob.inp, prob.opt)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = solver.solve_fourier_batch(prob.inp, prob.opt)
        torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / reps
    ig = res.ig_last.cpu().numpy()
    if not np.all(np.isfinite(res.i3bnd.cpu().numpy())):
        raise AssertionError("demo solve produced non-finite records")
    print(f"[5] demo solve (S=81, T=16, L=601, N=41) float32: {per:.4f} s "
          f"per solve warm, {prob.n_terms / per:.2f} terms/s, orders "
          f"IG max {int(ig.max())} mean {float(ig.mean()):.2f}", flush=True)
    d = summary[("float32", "demo")]
    print(f"[5] demo-shape kernels float32 ms: scatter {d['scatter'][1]:.4f} "
          f"(plain {d['scatter'][2]:.4f}), sweep {d['sweep'][1]:.4f} "
          f"(plain {d['sweep'][2]:.4f})", flush=True)
    _profile(torch, "[5] one demo solve",
             lambda: solver.solve_fourier_batch(prob.inp, prob.opt))


def _profile(torch, label, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time.  A failure of ``fn``
    raises; only the report may be unavailable."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    try:
        rows = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
                for e in prof.key_averages()]
        rows = sorted((r for r in rows if r[1] > 0.0), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e3
        top = [(k[:40], round(t / 1e3, 3), c) for k, t, c in rows[:6]]
        print(f"{label}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
              f"({100.0 * busy / (wall * 1e3):.1f} %); top (name, self ms, "
              f"calls): {top}", flush=True)
    except Exception as exc:  # the profile's analysis is a report only
        print(f"{label}: profile not available: {type(exc).__name__}: {exc}",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, _ROOT)
    from radiativetransfer_sos_torch import (_build, api, cases,
                                             full_precision_matmul, ops,
                                             precision, proc, solver)

    full_precision_matmul()
    card = _card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, nvcc: {nvcc[-1]}", flush=True)

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(
        ".log").exists() else ""
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln
             or "spill" in ln]
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f} s: {so.name}"
          f"; ptxas: {usage}", flush=True)

    with tempfile.TemporaryDirectory() as workdir:
        # the slice shape: S = OS_NB+1 = 81 orders, L = NT+1 = 107 levels,
        # HP = 3N with N = 24 Gauss angles + the solar slot
        summary = phase_kernels(torch, ops, (81, 107, 75))
        launches = phase_slice(torch, api, cases, ops, precision, proc,
                               workdir)
    phase_demo(torch, precision, solver, summary)

    s = summary[("float32", "slice")]
    kernels = [
        {"name": "scatter", "route": "cuda",
         "source": f"{_PKG}/csrc/scatter.cu", "replaces": f"{_PALLAS}:88 (JAX package)",
         "launches": launches["scatter"], "max_abs_err": s["scatter"][0],
         "ms": s["scatter"][1], "plain_ms": s["scatter"][2]},
        {"name": "sweep", "route": "cuda",
         "source": f"{_PKG}/csrc/sweep.cu", "replaces": f"{_PALLAS}:247 (JAX package)",
         "launches": launches["sweep"], "max_abs_err": s["sweep"][0],
         "ms": s["sweep"][1], "plain_ms": s["sweep"][2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
