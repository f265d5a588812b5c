"""Capacity padding of panels (the NumPy helper of the batched engine).

The port's copy of ``dfm_tpu.estim.batched.pad_panel_to_t``: serving
sessions hold their panel in a capacity-padded buffer whose pad rows are
exactly zero with a zero mask, which the masked filters and M-step treat
as inert.  The rest of the JAX module (the batched multi-fit engine) is
ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pad_panel_to_t"]


def pad_panel_to_t(Y: np.ndarray, t_max: int) -> np.ndarray:
    """Pad a (T, N) panel to (t_max, N) with exact-zero trailing time
    steps."""
    T, N = Y.shape
    if T > t_max:
        raise ValueError(f"panel has T={T} > t_max={t_max}")
    if T == t_max:
        return Y
    return np.concatenate([Y, np.zeros((t_max - T, N), Y.dtype)], axis=0)
