"""PSD-safe linear-algebra primitives (twins of ``dfm_tpu.ops.linalg``).

Cholesky-only solves, no explicit inverses.  Two behaviours carry over
from the reference: ``psd_cholesky`` symmetrizes and then adds a jitter
matched to the dtype (1e-6 in f32, 1e-10 in f64), and nothing clamps, so
an indefinite input gives NaN instead of silently wrong numbers.
"""

from __future__ import annotations

import torch

__all__ = ["sym", "default_jitter", "psd_cholesky", "chol_solve",
           "chol_logdet", "solve_psd"]


def sym(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize the trailing two axes."""
    return 0.5 * (M + M.transpose(-1, -2))


def default_jitter(dtype) -> float:
    """Diagonal jitter matched to precision: ~1e-10 in f64, ~1e-6 in f32."""
    return 1e-10 if dtype == torch.float64 else 1e-6


def psd_cholesky(M: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Cholesky of a nominally-PSD matrix with symmetrization + jitter.

    ``torch.linalg.cholesky_ex`` reports a failed factorization through
    ``info`` instead of raising; the failed factor is replaced by NaN so an
    indefinite input fails visibly, as ``jnp.linalg.cholesky`` does.
    """
    k = M.shape[-1]
    if jitter is None:
        jitter = default_jitter(M.dtype)
    eye = torch.eye(k, dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(sym(M) + jitter * eye)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = B given lower-triangular L.  B may be matrix or vector."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    X = torch.cholesky_solve(B, L, upper=False)
    return X[..., 0] if vec else X


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log det(L L') from the Cholesky factor."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def solve_psd(M: torch.Tensor, B: torch.Tensor,
              jitter: float | None = None) -> torch.Tensor:
    """Solve M X = B for symmetric PSD M via Cholesky."""
    return chol_solve(psd_cholesky(M, jitter), B)
