"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

The same inputs, made from a seed with NumPy, go through the JAX reference
(``radiativetransfer_sos_tpu``, JAX on the CPU in float64 as
``tests/conftest.py`` configures it) and through its counterpart in the port
(``radiativetransfer_sos_torch``, float64 on the CPU, where each kernel
wrapper takes its plain PyTorch version).  Data crosses between the two
frameworks as NumPy arrays only.

The suite runs under pytest-xdist with several workers on few cores, so
torch is held to one thread here.  Whether a CUDA card is present is
decided inside the ``cuda_device`` fixture, never at import time.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from radiativetransfer_sos_torch import cases

torch.set_num_threads(1)

#: the port's CPU float64 path against the JAX package's CPU float64 path:
#: identical formulas, summation orders differ (einsum / matmul / scan vs
#: sequential recurrence), so agreement is to a few hundred ulps
RTOL_F64 = 1e-12


@pytest.fixture(scope="session")
def cuda_device():
    """The first CUDA device, or skip (tests marked ``cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there "
                    "(python3 chip_smoke.py checks them on the card)")
    return torch.device("cuda", 0)


def write_external_file(path, g: float = 0.7) -> str:
    """The slice's IMOD-4 phase-matrix file (Henyey-Greenstein F11,
    Rayleigh-shaped polarization) in the ``-AER.ExtData`` format of
    ``tests/test_aerosol_models.py``; returns the path as a string."""
    cases.write_hg_phase_file(str(path), g=g)
    return str(path)


def sweep_case(seed, s_n, t_n, l_n, hp, zero_layers=(), dtype=np.float64):
    """Seeded sweep operands in the port's layout: ``h`` (T, L),
    ``muh`` (HP,), ``src_up/src_dn`` (S, T, L, HP), ``bc`` (S, T, HP);
    ``zero_layers`` get zero thickness (identity steps)."""
    rng = np.random.default_rng(seed)
    dh = rng.uniform(1e-4, 5e-2, size=(t_n, l_n - 1))
    for j in zero_layers:
        dh[:, j] = 0.0
    h = np.concatenate([np.zeros((t_n, 1)), np.cumsum(dh, axis=1)], axis=1)
    muh = np.concatenate([rng.uniform(0.05, 1.0, size=hp - 2), np.ones(2)])
    src_up = rng.standard_normal((s_n, t_n, l_n, hp))
    src_dn = rng.standard_normal((s_n, t_n, l_n, hp))
    bc = rng.standard_normal((s_n, t_n, hp))
    return tuple(a.astype(dtype) for a in (h, muh, src_up, src_dn, bc))


def scatter_case(seed, s_n, t_n, l_n, hp, dtype=np.float64):
    """Seeded scatter operands in the port's layout: ``up/dn``
    (S, T, L, HP), ``xdel/ydel`` (T, L), ``mboth`` (S, 4 HP, 2 HP)."""
    rng = np.random.default_rng(seed)
    up = rng.standard_normal((s_n, t_n, l_n, hp))
    dn = rng.standard_normal((s_n, t_n, l_n, hp))
    xdel = rng.uniform(0.0, 1.0, (t_n, l_n))
    mboth = rng.standard_normal((s_n, 4 * hp, 2 * hp))
    return tuple(a.astype(dtype) for a in (up, dn, xdel, 1.0 - xdel, mboth))


def tt(a, dtype=torch.float64, device="cpu"):
    """NumPy -> torch tensor on ``device`` (float64 on the CPU by default)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy()
