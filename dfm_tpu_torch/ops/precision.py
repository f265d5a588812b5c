"""Dtype policy helpers: where float64 enters a float32 pipeline.

The PyTorch twin of ``dfm_tpu.ops.precision`` with x64 on.  f64 is native on
both the CPU and the H100, so the accumulation dtype is always float64:

- ``accum_dtype(compute_dtype=None, native_only=False)``: the JAX
  signature.  The dtype of the three (T,)-sized assembly points (the
  unmasked ``ldR`` sum, the ``quad_R`` row-sum and the loglik assembly),
  each a measured fix of the 1e-5 loglik contract, and with
  ``native_only=True`` the upgrade of SEQUENTIAL work (the
  mixed-frequency augmented-state scans, ``models.mixed_freq``) only
  where f64 is native.  The JAX package answers float64 for both when
  x64 is on and the backend is the CPU; the port's f64 is native on the
  CPU and on the H100 alike, so both answers are float64 whatever the
  compute dtype.
- ``default_compute_dtype(device)``: float32 on CUDA, float64 on the CPU
  (the golden/test regime).
- ``highest_precision()``: a context that keeps float32 matrix products in
  true float32 (no TF32) and restores the caller's settings on exit — the
  twin of ``matmul_precision="highest"``.  Reduced-precision inputs cost
  ~1e-4 relative loglik against the 1e-5 contract.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["accum_dtype", "default_compute_dtype", "highest_precision"]


def accum_dtype(compute_dtype=None, native_only: bool = False) -> torch.dtype:
    """float64: the accumulation dtype of ``compute_dtype`` (any dtype),
    native f64 or not (see the module docstring)."""
    return torch.float64


def default_compute_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


@contextlib.contextmanager
def highest_precision():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
