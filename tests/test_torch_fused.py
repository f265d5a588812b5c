"""The port's fused fit (dfm_tpu_torch.estim.fused, fit(fused=...)) against
the JAX package's at float64 on the CPU.

The port runs the JAX ``lax.while_loop`` as gated chunks whose carry is
committed only while the loop runs, so stop iteration, status and the
last-good checkpoint are the JAX loop's exactly; the numbers carry only
per-iteration rounding differences (~1e-15 a pass), held at 1e-9 over
whole fits, 1e-12 for the t-masked M-step alone and 1e-10 for the
diffusion-index regressions (one batched solve).  The JAX fused fits run
unguarded (``robust=False``): the port has no guard yet, and without
faults the two JAX paths agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.estim import em as jem
from dfm_tpu.estim import fused as jfused
from dfm_tpu.ssm.info_filter import info_filter as jinfo_filter
from dfm_tpu.ssm.kalman import rts_smoother as jrts
from dfm_tpu.ssm.params import SSMParams as JParams
from dfm_tpu.ssm.params import SmootherResult as JSm
from dfm_tpu.utils import dgp
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.estim import fused as tfused
from dfm_tpu_torch.ssm.params import SmootherResult as TSm
from dfm_tpu_torch.ssm.params import SSMParams as TParams
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-9
FIELDS = ("Lam", "A", "Q", "R", "mu0", "P0")
CPU64 = dict(device="cpu", dtype=torch.float64)


def _panel(N, T, k, seed, frac_missing=0.0):
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N, k, rng)
    Y, _ = dgp.simulate(p, T, rng)
    Y = 2.0 * Y + 0.5                           # standardization matters
    if frac_missing:
        Y[rng.random(Y.shape) < frac_missing] = np.nan
        Y[T - 3:, : N // 3] = np.nan            # a ragged edge
    return Y


@pytest.fixture(scope="module")
def padded():
    """A capacity-padded masked panel (30 live rows of 45) and the JAX
    info-form smoother moments on it, as NumPy."""
    rng = np.random.default_rng(11)
    p = dgp.dfm_params(24, 3, rng)
    Y, _ = dgp.simulate(p, 30, rng)
    W = (rng.random(Y.shape) > 0.1).astype(float)
    Yb = np.zeros((45, 24))
    Wb = np.zeros((45, 24))
    Yb[:30], Wb[:30] = np.where(W > 0, Y, 0.0), W
    pj = JParams.from_numpy(p, jnp.float64)
    kf = jinfo_filter(jnp.asarray(Yb), pj, mask=jnp.asarray(Wb))
    sm = jrts(kf, pj)
    return p, tuple(np.asarray(x) for x in sm)


@pytest.mark.parametrize("n_steps", [30, 45, 2])
@pytest.mark.parametrize("estimate_A", [True, False])
def test_mstep_dynamics_tmasked_matches_jax(padded, n_steps, estimate_A):
    p, sm = padded
    jsm = JSm(*(jnp.asarray(x) for x in sm))
    tsm = TSm(*(torch.tensor(x) for x in sm))
    jcfg = jem.EMConfig(estimate_A=estimate_A, estimate_init=True,
                        filter="info")
    tcfg = tem.EMConfig(estimate_A=estimate_A, estimate_init=True,
                        filter="info")
    want = jem.mstep_dynamics_tmasked(
        jsm, *jem.moments(jsm), JParams.from_numpy(p, jnp.float64), jcfg,
        jnp.int32(n_steps))
    got = tem.mstep_dynamics_tmasked(
        tsm, *tem.moments(tsm), TParams.from_numpy(p), tcfg, n_steps)
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), 1e-12)


@pytest.mark.parametrize("horizon", [1, 3])
def test_di_forecasts_match_jax(horizon):
    rng = np.random.default_rng(horizon)
    F = rng.standard_normal((40, 3))
    Y = F @ rng.standard_normal((3, 9)) + 0.3 * rng.standard_normal((40, 9))
    close(tfused._di_forecast_core(torch.as_tensor(F), torch.as_tensor(Y),
                                   horizon).numpy(),
          np.asarray(jfused._di_forecast_core(jnp.asarray(F), jnp.asarray(Y),
                                              horizon)), 1e-10)
    Yb = Y.copy()
    Yb[31:] = 0.0                               # a capacity pad past t = 31
    for t_new in (31, 40, 2):
        close(tfused._di_forecast_core_masked(
                  torch.as_tensor(F), torch.as_tensor(Yb), t_new,
                  horizon).numpy(),
              np.asarray(jfused._di_forecast_core_masked(
                  jnp.asarray(F), jnp.asarray(Yb), jnp.int32(t_new),
                  horizon)), 1e-10)


def _fits(Y, flt, fused, max_iters, tol, chunk=8, init=None):
    kw = dict(fused=fused, max_iters=max_iters, tol=tol, init=init)
    rj = jfit(JModel(2), Y, backend=TPUBackend(dtype=np.float64, filter=flt,
                                               fused_chunk=chunk),
              robust=False, **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(2), Y,
                 backend=dtt.TorchBackend(filter=flt, fused_chunk=chunk,
                                          **CPU64), **kw)
    return rt, rj


def _assert_fit_matches(rt, rj, outputs=True):
    assert (rt.n_iters, rt.converged) == (rj.n_iters, rj.converged)
    assert rt.filter == rj.filter
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=RTOL)
    for f in FIELDS:
        close(getattr(rt.params, f), getattr(rj.params, f), RTOL)
    close(rt.factors, rj.factors, RTOL)
    close(rt.factor_cov, rj.factor_cov, RTOL)
    if not outputs:
        return
    close(rt.nowcast, rj.nowcast, RTOL)
    for key in ("y", "f", "di"):
        close(rt.forecasts[key], rj.forecasts[key], RTOL)


# (engine asked, N, T, missing share, engine it resolves to)
ENGINES = [("auto", 12, 60, 0.1, "dense"),
           ("auto", 40, 60, 0.1, "info"),
           ("ss", 40, 90, 0.0, "ss"),
           ("pit_qr", 36, 60, 0.1, "pit_qr")]


@pytest.mark.parametrize("flt,N,T,miss,engine", ENGINES,
                         ids=[e[-1] for e in ENGINES])
def test_fused_fit_matches_jax(flt, N, T, miss, engine):
    Y = _panel(N, T, 2, seed=N + T, frac_missing=miss)
    init = dtt.fit(dtt.DynamicFactorModel(2), Y, max_iters=0,
                   backend=dtt.TorchBackend(**CPU64)).params
    rt, rj = _fits(Y, flt, fused=3, max_iters=11, tol=0.0, chunk=4,
                   init=init)
    assert rt.filter == engine
    assert rt.forecasts["y"].shape == (3, N)
    _assert_fit_matches(rt, rj)
    # Two status reads (after chunks 1 and 2 of 3) and the final read.
    assert rt.host_reads == 3


def test_fused_fit_stops_where_jax_stops():
    Y = _panel(40, 60, 2, seed=3, frac_missing=0.1)
    rt, rj = _fits(Y, "auto", fused=True, max_iters=60, tol=1e-5, chunk=4)
    assert rt.converged and 4 < rt.n_iters < 60
    _assert_fit_matches(rt, rj)
    assert rt.host_reads <= -(-rt.n_iters // 4) + 1


def test_fused_divergence_seam_keeps_last_good():
    """The fault seam craters chunk 2's logliks: the fit stops at chunk
    2's first iteration (8 + 1 logliks) and returns the last-good params,
    chunk 1's entry point, not converged, with no nowcast."""
    Y = _panel(40, 60, 2, seed=5, frac_missing=0.1)
    kw = dict(max_iters=30, tol=0.0)
    rj = jfit(JModel(2), Y, backend=TPUBackend(dtype=np.float64,
                                               fused_chunk=4),
              fused=jfused.FusedOptions(fault_chunk=2), robust=False, **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(2), Y,
                 backend=dtt.TorchBackend(fused_chunk=4, **CPU64),
                 fused=tfused.FusedOptions(fault_chunk=2), **kw)
    assert rt.n_iters == rj.n_iters == 9 and not rt.converged
    assert rt.nowcast is None and rt.forecasts is None
    assert rj.nowcast is None
    _assert_fit_matches(rt, rj, outputs=False)


def test_di_solve_finite_at_an_exact_zero_pivot():
    """ROADMAP Queue 3 (the rank-8 session at k = 128, f32): when the
    diffusion-index normal equations are singular to f32 rounding (the
    1e-8 ridge is below the resolution of sums of a few thousand, and two
    regressors coincide), torch's LU meets an exact zero pivot and
    ``solve_ex`` returns inf / NaN where the JAX package's LU, rounding
    differently, had landed on a tiny pivot.  ``_di_solve`` takes eps x
    the largest pivot there and stays finite; a nonsingular system is
    solved as ``solve_ex`` solves it, bit for bit."""
    f32 = torch.float32
    Gff = torch.tensor([[4096.0, 2048, 2048], [2048, 2048, 2048],
                        [2048, 2048, 2048]], dtype=f32)
    Gfy, Gyy = torch.zeros(3, 2, dtype=f32), torch.tensor([1024.0, 2048.0])
    bf = torch.tensor([[1.0, 2], [3, 4], [5, 6]])
    by = torch.tensor([7.0, 8.0])
    XtX = torch.zeros(2, 4, 4, dtype=f32)
    XtX[:, :3, :3] = Gff
    XtX[:, 3, 3] = Gyy
    XtX = XtX + 1e-8 * torch.eye(4)
    rhs = torch.cat([bf.T, by[:, None]], dim=-1)[..., None]
    old, info = torch.linalg.solve_ex(XtX, rhs)
    assert (info > 0).all() and not torch.isfinite(old).all()
    assert torch.isfinite(tfused._di_solve(Gff, Gfy, Gyy, bf, by, 2, 4,
                                           1e-8)).all()
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.standard_normal((40, 6)), dtype=f32)
    Yl = torch.tensor(rng.standard_normal((40, 2)), dtype=f32)
    Z = torch.tensor(rng.standard_normal((40, 2)), dtype=f32)
    got = tfused._di_solve(X.T @ X, X.T @ Yl, (Yl * Yl).sum(0), X.T @ Z,
                           (Yl * Z).sum(0), 2, 7, 1e-8)
    M = torch.zeros(2, 7, 7, dtype=f32)
    M[:, :6, :6] = X.T @ X
    M[:, :6, 6] = (X.T @ Yl).T
    M[:, 6, :6] = (X.T @ Yl).T
    M[:, 6, 6] = (Yl * Yl).sum(0)
    M = M + 1e-8 * torch.eye(7)
    want = torch.linalg.solve_ex(
        M, torch.cat([(X.T @ Z).T, (Yl * Z).sum(0)[:, None]], -1)[..., None])
    assert torch.equal(got, want[0][..., 0])
