"""The port's hand-written CUDA kernels on the card (marker ``cuda``).

This file imports no JAX, so it also runs where JAX is not installed, with
the repository's JAX-configuring ``conftest.py`` left out::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips (``cuda_device`` fixture).  The same
checks, at the main path's real shapes, are phases of ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from radiativetransfer_sos_torch import api, cases, ops, proc
from torch_parity import cuda_device  # noqa: F401 (fixture)
from torch_parity import scatter_case, sweep_case, tt, write_external_file

#: kernel vs plain: max |kernel - plain| <= REL * max |plain| (summation
#: order and one-ulp exp differences, over up to ~50 recurrence steps)
REL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain(cuda_device, dtype):  # noqa: F811
    """Ragged shapes with zero-thickness layers; the launch counters count
    kernel launches only."""
    ops.reset_launches()
    for shape in ((3, 1, 37, 21), (2, 3, 53, 15)):
        sc = [tt(a, dtype, cuda_device) for a in scatter_case(1, *shape)]
        h, muh, su, sd, bc = sweep_case(2, *shape, zero_layers=(0, 5, 30))
        sw = [tt(a, dtype, cuda_device) for a in (su, sd)]
        sw += [ops.sweep_coeffs(tt(h, dtype, cuda_device)),
               tt(muh, dtype, cuda_device), tt(bc, dtype, cuda_device)]
        for kernel, plain, args in ((ops.scatter, ops.scatter_plain, sc),
                                    (ops.sweep, ops.sweep_plain, sw)):
            for g, w in zip(kernel(*args), plain(*args)):
                scale = float(w.abs().max())
                assert float((g - w).abs().max()) <= REL[dtype] * scale
    assert ops.LAUNCHES == {"scatter": 2, "sweep": 2}


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda_device, tmp_path):  # noqa: F811
    """The small slice case in float64 on the card equals the port on the
    CPU (rtol 1e-10), and went through both kernels."""
    ext = write_external_file(tmp_path / "hg.txt")
    cfg = api.config_from_keywords(cases.slice_keywords(None, ext, 10, 12))
    ops.reset_launches()
    got = proc.sos_run(cfg, device=cuda_device, dtype=torch.float64)
    assert ops.LAUNCHES["scatter"] > 0 and ops.LAUNCHES["sweep"] > 0
    want = proc.sos_run(cfg, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(got.records_up, want.records_up, rtol=1e-10,
                               atol=1e-14 * np.max(np.abs(want.records_up)))
    for key in ("i", "q", "u"):
        np.testing.assert_allclose(got.up[key], want.up[key], rtol=1e-10)
