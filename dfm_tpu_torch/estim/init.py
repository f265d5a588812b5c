"""Device-side panel standardization and PCA warm start.

Twins of ``dfm_tpu.estim.init``.  ``fit`` uses them for large panels
(N*T >= 4e6) so the N-sized prep work runs on the device.  The top
singular vectors come from an eigendecomposition of the (T, T) Gram
matrix (``torch.linalg.eigh``, a library call, as the JAX package leaves
it to XLA); the k-sized VAR(1) tail runs on the host.
``pca_init_batched`` is the same init over a stack of panels (the
``fit_many(device_init=True)`` warm starts): one batched eigh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backends import cpu_ref
from .fused import read_packed

__all__ = ["standardize_device", "pca_init_device", "pca_init_batched"]


def standardize_device(Y: torch.Tensor):
    """Column standardization of a FULLY-OBSERVED panel on the device.

    Same ddof-1 / 1e-12 variance-floor semantics as
    ``utils.data.standardize``, two-pass (mean, then centered sum of
    squares).  Returns ``(Yz, stack([mean, scale]))`` so the host fetches
    the stats in one read.
    """
    T = Y.shape[0]
    mean = Y.mean(dim=0)
    xc = Y - mean[None, :]
    var = (xc * xc).sum(dim=0) / max(float(T - 1), 1.0)
    scale = torch.sqrt(torch.clamp(var, min=1e-12))
    return (xc / scale[None, :]).contiguous(), torch.stack([mean, scale])


def _pca_parts(Y: torch.Tensor, k: int):
    """PCA loadings, factors and residual variances of a (..., T, N)
    panel; leading axes batch independent panels."""
    T, N = Y.shape[-2:]
    Yt = Y.transpose(-1, -2)
    # Y = U S V'  =>  Y Y' = U S^2 U'  and  V = Y' U / S.
    G = Y @ Yt
    w, U = torch.linalg.eigh(G)                   # ascending eigenvalues
    w_k = w[..., -k:].flip(-1)                    # top-k, descending
    U_k = U[..., -k:].flip(-1)
    s_k = torch.sqrt(torch.clamp(w_k, min=1e-12))
    V = (Yt @ U_k) / s_k[..., None, :]            # (..., N, k)
    Lam = float(np.sqrt(N)) * V
    F = Y @ Lam / N                               # (..., T, k)
    resid = Y - F @ Lam.transpose(-1, -2)
    R = torch.clamp(resid.var(dim=-2, unbiased=False), min=1e-6)
    return Lam, F, R


def _panel(Y, dtype, device) -> torch.Tensor:
    """``Y`` (a tensor or a host array) as a tensor in ``dtype`` (default:
    a tensor's own dtype, float32 for a host array, the JAX default) on
    ``device`` (default: a tensor's own device, the card for a host
    array)."""
    if isinstance(Y, torch.Tensor):
        return Y.to(device=device or Y.device, dtype=dtype or Y.dtype)
    return torch.as_tensor(np.asarray(Y), dtype=dtype or torch.float32,
                           device=device or "cuda")


def pca_init_device(Y, k: int, static: bool = False, dtype=None,
                    device=None) -> cpu_ref.SSMParams:
    """Device PCA init on a standardized, zero-filled panel (a tensor, or
    a host array the JAX way), computed in ``dtype`` (see ``_panel``);
    returns NumPy f64 params (the same type as the host initializer).
    Eigenvector signs may differ from another eigensolver's, column by
    column."""
    Lam, F, R = _pca_parts(_panel(Y, dtype, device), k)
    A, Q, mu0, P0 = cpu_ref.var_tail(F.to("cpu", torch.float64).numpy(), k,
                                     static)
    return cpu_ref.SSMParams(Lam.to("cpu", torch.float64).numpy(), A, Q,
                             R.to("cpu", torch.float64).numpy(), mu0, P0)


def pca_init_batched(Y, k: int, static: bool = False, dtype=None,
                     device=None) -> list:
    """Device PCA warm starts for a stack (B, T, N) of standardized, fully
    observed panels (a tensor or a host array, in ``dtype`` on ``device``
    as ``pca_init_device``): one batched Gram eigh, then the k-sized VAR
    tails on the host, one per panel.  Returns B NumPy f64 param sets."""
    Lam, F, R = _pca_parts(_panel(Y, dtype, device), k)
    h = read_packed({"Lam": Lam, "F": F, "R": R})   # one read
    out = []
    for b in range(Lam.shape[0]):
        A, Q, mu0, P0 = cpu_ref.var_tail(h["F"][b], k, static)
        out.append(cpu_ref.SSMParams(h["Lam"][b], A, Q, h["R"][b], mu0, P0))
    return out
