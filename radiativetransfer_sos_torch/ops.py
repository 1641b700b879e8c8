"""The two hot kernels of the solve, their plain versions and launch counts.

Counterpart of the JAX package's ``pallas_ops.py``.  One scattering
order of the solver is two dense passes over the field (reference
``SOS_FSOURCE_ORDREIG`` + ``SOS_INTEGR_EPOPT``, ``src/SOS_OS.F:2663`` /
``:2222``):

* :func:`scatter` — the order-IG source: per-level aerosol/molecular mix of
  the field times the order's flat operator (``csrc/scatter.cu``);
* :func:`sweep` — both hemisphere layer integrations as affine recurrences
  with a source linear in optical depth (``csrc/sweep.cu``).

Layout (no TPU padding): a field or source hemisphere is (S, T, L, HP) with
S Fourier orders, T terms, L = NT+1 levels and HP = 3N lanes (Stokes-major,
``c = stokes*N + p``).  The per-level mixing fractions are (T, L), shared
by every order; the sweep's per-level inputs (:func:`sweep_coeffs`) are
(T, L, 4).

Each wrapper takes its plain PyTorch version for CPU tensors only.  For a
CUDA tensor it launches its kernel on the current stream or raises; it adds
one to :data:`LAUNCHES` at each launch and nowhere else.
"""

from __future__ import annotations

import torch

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"scatter": 0, "sweep": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, tensors: dict, shapes: dict) -> str:
    """Validate device, dtype, shape and contiguity; return the dtype tag."""
    first = next(iter(tensors.values()))
    if first.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {first.dtype} not supported "
                        "(float32 or float64)")
    for key, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"expected {first.dtype} on {first.device}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return _DTYPES[first.dtype]


def _launch(entry: str, device: torch.device, *args) -> None:
    from ._build import library

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# Scatter: mix + per-order operator product (SOS_FSOURCE_ORDREIG)
# ---------------------------------------------------------------------------

def scatter_plain(up, dn, xdel, ydel, mboth):
    """Plain PyTorch scattering source: mix, then one batched matmul.

    ``up/dn``: (S, T, L, HP) field hemispheres; ``xdel/ydel``: (T, L);
    ``mboth``: (S, 4 HP, 2 HP) per-order flat operators, rows ordered
    [aerosol; molecular] over the [up | dn] field lanes
    (``solver._flat_operator``).  Returns the source halves
    ``(src_up, src_dn)``, each (S, T, L, HP).
    """
    s_n, t_n, l_n, hp = up.shape
    x = xdel[None, :, :, None]
    y = ydel[None, :, :, None]
    f2 = torch.cat([x * up, x * dn, y * up, y * dn], dim=-1)
    src = torch.matmul(f2.reshape(s_n, t_n * l_n, 4 * hp), mboth)
    src = src.reshape(s_n, t_n, l_n, 2 * hp)
    return src[..., :hp].contiguous(), src[..., hp:].contiguous()


def scatter(up, dn, xdel, ydel, mboth):
    """Scattering source of one order for the whole (S, T) grid.

    Same operands and result as :func:`scatter_plain`.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/scatter.cu``.
    """
    if up.device.type == "cpu":
        return scatter_plain(up, dn, xdel, ydel, mboth)
    if up.device.type != "cuda":
        raise ValueError(f"scatter: unsupported device {up.device}")
    s_n, t_n, l_n, hp = up.shape
    tag = _check("scatter",
                 dict(up=up, dn=dn, xdel=xdel, ydel=ydel, mboth=mboth),
                 dict(up=(s_n, t_n, l_n, hp), dn=(s_n, t_n, l_n, hp),
                      xdel=(t_n, l_n), ydel=(t_n, l_n),
                      mboth=(s_n, 4 * hp, 2 * hp)))
    out_up = torch.empty_like(up)
    out_dn = torch.empty_like(dn)
    _launch(f"sos_scatter_{tag}", up.device, up.data_ptr(), dn.data_ptr(),
            xdel.data_ptr(), ydel.data_ptr(), mboth.data_ptr(),
            out_up.data_ptr(), out_dn.data_ptr(), s_n, t_n * l_n, hp)
    LAUNCHES["scatter"] += 1
    return out_up, out_dn


# ---------------------------------------------------------------------------
# Sweep: both hemisphere integrations (SOS_INTEGR_EPOPT)
# ---------------------------------------------------------------------------

def sweep_coeffs(h):
    """Per-level affine-step inputs of the sweep, (T, L, 4).

    ``h``: (T, L) cumulative optical depth, 0 at TOA.  Lanes
    ``[dtau_dn, 1/dtau_dn, dtau_up, 1/dtau_up]`` with
    ``dtau_dn[l] = h[l]-h[l-1]`` (0 at l = 0) and ``dtau_up[l] =
    h[l+1]-h[l]`` (0 at the ground); a zero thickness stores 1/dtau = 0
    (port of ``pallas_ops.sweep_coeffs``).
    """
    zero = torch.zeros_like(h[:, :1])
    d = h[:, 1:] - h[:, :-1]
    d_dn = torch.cat([zero, d], dim=1)
    d_up = torch.cat([d, zero], dim=1)

    def recip(v):
        pos = v > 0.0
        return torch.where(pos, 1.0 / torch.where(pos, v, 1.0), 0.0)

    return torch.stack([d_dn, recip(d_dn), d_up, recip(d_up)],
                       dim=-1).contiguous()


def sweep_plain(src_up, src_dn, coeffs, muh, bc):
    """Plain PyTorch sweep: the per-layer affine terms vectorised, then a
    level loop over the carry, vectorised over instances and lanes.

    ``src_up/src_dn``: (S, T, L, HP); ``coeffs``: (T, L, 4) from
    :func:`sweep_coeffs`; ``muh``: (HP,) direction cosines; ``bc``:
    (S, T, HP) upward ground boundary.  Returns ``(up, dn)``, each
    (S, T, L, HP): ``dn[:, :, 0] = 0`` and ``up[:, :, L-1] = bc``.
    """
    l_n = src_up.shape[2]
    cf = coeffs[None, :, :, None, :]                      # (1, T, L, 1, 4)
    dt_dn, rd_dn, dt_up, rd_up = (cf[..., i] for i in range(4))
    a_dn = torch.exp(-dt_dn / muh)
    a_up = torch.exp(-dt_up / muh)
    # down layer ending at level l (l >= 1)
    hi, lo = src_dn[:, :, 1:], src_dn[:, :, :-1]
    al = (hi - lo) * rd_dn[:, :, 1:]
    a = a_dn[:, :, 1:]
    b_dn = (1.0 - a) * (-al * muh + hi) + al * a * dt_dn[:, :, 1:]
    # up layer starting at level l (l <= L-2)
    hi, lo = src_up[:, :, 1:], src_up[:, :, :-1]
    al = (hi - lo) * rd_up[:, :, :-1]
    a = a_up[:, :, :-1]
    b_up = (1.0 - a) * (al * muh + lo) - al * a * dt_up[:, :, :-1]

    dn = torch.empty_like(src_dn)
    up = torch.empty_like(src_up)
    f = torch.zeros_like(bc)
    dn[:, :, 0] = f
    a_dn = a_dn.expand(src_dn.shape)
    for l in range(1, l_n):
        f = a_dn[:, :, l] * f + b_dn[:, :, l - 1]
        dn[:, :, l] = f
    f = bc
    up[:, :, l_n - 1] = f
    a_up = a_up.expand(src_up.shape)
    for l in range(l_n - 2, -1, -1):
        f = a_up[:, :, l] * f + b_up[:, :, l]
        up[:, :, l] = f
    return up, dn


def sweep(src_up, src_dn, coeffs, muh, bc):
    """Both hemisphere integrations for the whole (S, T) grid.

    Same operands and result as :func:`sweep_plain`.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/sweep.cu``.
    """
    if src_up.device.type == "cpu":
        return sweep_plain(src_up, src_dn, coeffs, muh, bc)
    if src_up.device.type != "cuda":
        raise ValueError(f"sweep: unsupported device {src_up.device}")
    s_n, t_n, l_n, hp = src_up.shape
    tag = _check("sweep",
                 dict(src_up=src_up, src_dn=src_dn, coeffs=coeffs, muh=muh,
                      bc=bc),
                 dict(src_up=(s_n, t_n, l_n, hp),
                      src_dn=(s_n, t_n, l_n, hp), coeffs=(t_n, l_n, 4),
                      muh=(hp,), bc=(s_n, t_n, hp)))
    up = torch.empty_like(src_up)
    dn = torch.empty_like(src_dn)
    _launch(f"sos_sweep_{tag}", src_up.device, src_up.data_ptr(),
            src_dn.data_ptr(), coeffs.data_ptr(), muh.data_ptr(),
            bc.data_ptr(), up.data_ptr(), dn.data_ptr(), s_n * t_n, t_n,
            l_n, hp)
    LAUNCHES["sweep"] += 1
    return up, dn
