"""PyTorch/CUDA port of the successive-orders-of-scattering RT framework.

A second package beside the JAX reference package (``..._tpu``):
module names mirror the reference so each counterpart is easy to find.  It
imports ``torch`` and NumPy, never ``jax`` and never the JAX package, so it
runs where JAX is not installed.  The numpy-only host modules are copies of
the reference's, pinned to their originals by ``tests/test_torch_host.py``.

Device and dtype policy:

* :func:`default_device` is ``cuda`` when a card is present, else ``cpu``
  (JAX's default-backend rule);
* the working dtype is float64 on the CPU and float32 on CUDA, with float64
  available on CUDA by passing ``dtype=torch.float64``;
* TF32 is off: :func:`full_precision_matmul` is called by every public entry
  that multiplies float32 matrices on the card.

The two hot kernels (scattering source and layer sweep) are hand-written
CUDA C++ under ``csrc/`` (``ops.py``); on CPU tensors their plain PyTorch
versions run instead.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """``cuda`` when a card is present, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def on_cuda(device) -> bool:
    """True when computations on ``device`` land on a CUDA card
    (counterpart of ``solver.on_tpu``)."""
    return torch.device(device).type == "cuda"


def working_dtype(device) -> torch.dtype:
    """Default solve dtype: float64 on the CPU, float32 on CUDA."""
    return torch.float32 if on_cuda(device) else torch.float64


def resolve(device=None, dtype=None) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) with the package defaults filled in."""
    device = default_device() if device is None else torch.device(device)
    dtype = working_dtype(device) if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}; use float32 or float64")
    return device, dtype


def full_precision_matmul() -> None:
    """Keep float32 products in full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
