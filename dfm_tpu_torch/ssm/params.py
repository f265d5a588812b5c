"""State-space parameter and result containers on tensors.

The PyTorch mirror of ``dfm_tpu.ssm.params``: NamedTuples of tensors on
one device in one dtype.  ``SSMParams.from_numpy`` is how weights cross
from any NumPy parameter set (the JAX package's ``cpu_ref.SSMParams``, its
``ssm.params.SSMParams(...).to_numpy()``, or this package's own NumPy
container) — it reads only the six attributes, so it imports neither.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SSMParams(NamedTuple):
    """y_t = Lam f_t + eps, eps ~ N(0, diag(R)); f_t = A f_{t-1} + eta ~ N(0,Q).

    Lam: (N, k); A: (k, k); Q: (k, k); R: (N,) diagonal; mu0: (k,); P0: (k, k).
    """

    Lam: torch.Tensor
    A: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    mu0: torch.Tensor
    P0: torch.Tensor

    def to(self, device=None, dtype=None) -> "SSMParams":
        return SSMParams(*(x.to(device=device, dtype=dtype) for x in self))

    @classmethod
    def from_numpy(cls, p, dtype=torch.float64, device="cpu") -> "SSMParams":
        """From any object with ``Lam, A, Q, R, mu0, P0`` as arrays."""
        arrs = (p.Lam, p.A, p.Q, p.R, p.mu0, p.P0)
        return cls(*(torch.tensor(np.asarray(a), dtype=dtype,
                                  device=device).contiguous()
                     for a in arrs))

    def to_numpy(self):
        from ..backends.cpu_ref import SSMParams as NpParams
        return NpParams(*(x.detach().to("cpu", torch.float64).numpy()
                          for x in self))


class FilterResult(NamedTuple):
    x_pred: torch.Tensor   # (T, k)
    P_pred: torch.Tensor   # (T, k, k)
    x_filt: torch.Tensor   # (T, k)
    P_filt: torch.Tensor   # (T, k, k)
    loglik: torch.Tensor   # scalar


class SmootherResult(NamedTuple):
    x_sm: torch.Tensor     # (T, k)
    P_sm: torch.Tensor     # (T, k, k)
    P_lag: torch.Tensor    # (T, k, k); row 0 is zeros
