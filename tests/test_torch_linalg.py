"""dfm_tpu_torch.ops against the dfm_tpu.ops twins at float64 on the CPU.

Inputs are random batched PSD matrices from numpy seeds.  Every check is a
single pass of the same algorithm (Cholesky, two triangular solves), so
the tolerance is 1e-12 relative: LAPACK's order of operations may differ
between the two frameworks' CPU kernels, nothing more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.ops import linalg as jl
from dfm_tpu_torch.ops import linalg as tl
from dfm_tpu_torch.ops import precision as tp
from torch_parity import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _psd(rng, batch, k):
    X = rng.standard_normal(batch + (k, 2 * k))
    return X @ np.swapaxes(X, -1, -2) / (2 * k)


@pytest.mark.parametrize("batch,k", [((), 1), ((), 3), ((5,), 4),
                                     ((2, 3), 6)])
def test_psd_cholesky_and_logdet(batch, k):
    rng = np.random.default_rng(10 + k)
    M = _psd(rng, batch, k)
    M = M + 1e-3 * rng.standard_normal(M.shape)     # not exactly symmetric
    L_j = np.asarray(jl.psd_cholesky(jnp.asarray(M)))
    L_t = tl.psd_cholesky(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(L_t, L_j, rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(tl.chol_logdet(torch.as_tensor(L_t)).numpy(),
                               np.asarray(jl.chol_logdet(jnp.asarray(L_j))),
                               rtol=RTOL)


@pytest.mark.parametrize("vector", [False, True])
def test_chol_solve_and_solve_psd(vector):
    rng = np.random.default_rng(11)
    M = _psd(rng, (7,), 5)
    B = rng.standard_normal((7, 5) if vector else (7, 5, 3))
    L = jl.psd_cholesky(jnp.asarray(M))
    X_j = np.asarray(jl.chol_solve(L, jnp.asarray(B)))
    X_t = tl.chol_solve(torch.as_tensor(np.array(L)),
                        torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(X_t, X_j, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(
        tl.solve_psd(torch.as_tensor(M), torch.as_tensor(B)).numpy(),
        np.asarray(jl.solve_psd(jnp.asarray(M), jnp.asarray(B))),
        rtol=RTOL, atol=1e-12)


def test_sym_and_jitter():
    rng = np.random.default_rng(12)
    M = rng.standard_normal((4, 3, 3))
    np.testing.assert_array_equal(tl.sym(torch.as_tensor(M)).numpy(),
                                  np.asarray(jl.sym(jnp.asarray(M))))
    assert tl.default_jitter(torch.float64) == jl.default_jitter(jnp.float64)
    assert tl.default_jitter(torch.float32) == jl.default_jitter(jnp.float32)


def test_indefinite_input_gives_nan_like_the_reference():
    M = np.array([[1.0, 2.0], [2.0, 1.0]])          # eigenvalues 3, -1
    assert np.isnan(np.asarray(jl.psd_cholesky(jnp.asarray(M)))).any()
    assert torch.isnan(tl.psd_cholesky(torch.as_tensor(M))).all()


def test_precision_policy():
    assert tp.accum_dtype() == torch.float64
    assert tp.default_compute_dtype("cpu") == torch.float64
    assert tp.default_compute_dtype("cuda") == torch.float32
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with tp.highest_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])
