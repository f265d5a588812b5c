"""Panel data preparation on the host (a copy of ``dfm_tpu.utils.data``).

Column standardization to mean 0 / variance 1 with mask/NaN awareness,
panel validation and the {0,1} observation mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Standardizer", "standardize", "standardize_onepass",
           "validate_panel", "build_mask"]


@dataclasses.dataclass
class Standardizer:
    """Per-series affine transform y -> (y - mean) / scale and its inverse."""

    mean: np.ndarray   # (N,)
    scale: np.ndarray  # (N,)

    def transform(self, Y: np.ndarray) -> np.ndarray:
        return (Y - self.mean) / self.scale

    def inverse(self, Z: np.ndarray) -> np.ndarray:
        return Z * self.scale + self.mean


def standardize(Y: np.ndarray, mask: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Standardizer]:
    """Standardize each series over its *observed* entries.

    NaNs in ``Y`` are treated as missing regardless of ``mask``.  Returns the
    standardized panel (missing entries left as NaN) and the transform.
    """
    Y = np.asarray(Y, dtype=np.float64)
    obs = np.isfinite(Y)
    if mask is not None:
        obs &= np.asarray(mask) > 0
    W = obs.astype(np.float64)
    counts = np.maximum(W.sum(0), 1.0)
    Yz = np.where(obs, Y, 0.0)
    mean = Yz.sum(0) / counts
    var = (W * (Yz - mean) ** 2).sum(0) / np.maximum(counts - 1.0, 1.0)
    scale = np.sqrt(np.maximum(var, 1e-12))
    Z = np.where(obs, (Y - mean) / scale, np.nan)
    return Z, Standardizer(mean, scale)


def standardize_onepass(Y: np.ndarray, out_dtype=np.float64
                        ) -> Tuple[np.ndarray, Standardizer]:
    """One-pass standardize for FULLY-OBSERVED panels, emitting ``out_dtype``.

    Mean and variance come from one pass (sum and sum of squares in f64);
    the output is written directly in the compute dtype.  Same ddof-1 /
    1e-12 variance-floor semantics as ``standardize``.
    """
    Y = np.asarray(Y)
    T = Y.shape[0]
    s1 = Y.sum(axis=0, dtype=np.float64)
    s2 = np.einsum("ti,ti->i", Y, Y, dtype=np.float64)
    mean = s1 / T
    var = (s2 - T * mean * mean) / max(T - 1.0, 1.0)
    scale = np.sqrt(np.maximum(var, 1e-12))
    inv = (1.0 / scale).astype(out_dtype)
    Z = (Y.astype(out_dtype, copy=False) - mean.astype(out_dtype)) * inv
    return Z, Standardizer(mean, scale)


def validate_panel(Y: np.ndarray, mask: Optional[np.ndarray] = None,
                   check_variance: bool = True) -> None:
    """Reject panels that poison standardization/EM downstream.

    Raises ``ValueError`` naming the offending columns when a series has no
    observed entries or, with ``check_variance``, when an observed series
    is constant.
    """
    Y = np.asarray(Y, dtype=np.float64)
    obs = np.isfinite(Y)
    if mask is not None:
        obs &= np.asarray(mask) > 0
    counts = obs.sum(0)
    dead = np.flatnonzero(counts == 0)
    if dead.size:
        raise ValueError(
            f"column(s) {dead.tolist()} have no observed entries "
            "(all-NaN / fully masked); drop them before fitting")
    if not check_variance:
        return
    W = obs.astype(np.float64)
    Yz = np.where(obs, Y, 0.0)
    mean = Yz.sum(0) / np.maximum(counts, 1.0)
    var = (W * (Yz - mean) ** 2).sum(0) / np.maximum(counts - 1.0, 1.0)
    flat = np.flatnonzero((counts > 1) & (var < 1e-12))
    if flat.size:
        raise ValueError(
            f"column(s) {flat.tolist()} have zero variance over their "
            "observed entries; standardization would divide by ~0 — drop "
            "or de-constant them before fitting")


def build_mask(Y: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """{0,1} observation mask from explicit mask and/or NaN pattern."""
    obs = np.isfinite(np.asarray(Y, dtype=np.float64))
    if mask is not None:
        obs &= np.asarray(mask) > 0
    return obs.astype(np.float64)
