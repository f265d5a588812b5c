"""The port's rank-r engine (dfm_tpu_torch.ssm.lowrank_filter and its
routes through fit, the fused fit, sessions and fleet buckets) against
the JAX package at float64 on the CPU, where every K9 kernel runs its
plain twin.

Single passes agree with the JAX functions and with ``cpu_ref``'s NumPy
oracle to 1e-10 relative, except where the reference itself is not
defined to that precision: at a step that observes fewer than r series,
Gam_t = V'C_t V + eps I and S_t are singular but for eps (condition
~1e13 here), so log|S_t| - log|Gam_t| and the quadratic correction carry
a rounding of ~1e-5 in any implementation (the JAX function and the
NumPy oracle differ there by ~3e-6 on the loglik).  Those two terms are
held to LD_ATOL = 1e-3 absolute at such steps (cond x eps_64 ~ 1e-3) and
to 1e-10 everywhere else; every moment is held to 1e-10 at every step.
Fits, sessions and fleets run on panels with scattered missing values
(every step observes more than r series) and agree to 1e-9, the EM-path
tolerance of the other test_torch_* files.  The policy basis is compared
through its projector V V' (the engine is invariant to V -> V B) on a
panel whose r-th and (r+1)-th eigenvalues are well apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu
import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.backends import cpu_ref as jref
from dfm_tpu.estim.em import EMConfig as JEMConfig
from dfm_tpu.ssm import lowrank_filter as jl
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch.estim.em import EMConfig
from dfm_tpu_torch.ssm import info_filter as ti
from dfm_tpu_torch.ssm import lowrank_filter as tl
from dfm_tpu_torch.ssm.kalman import rts_smoother
from dfm_tpu_torch.ssm.params import SSMParams as TP
from dfm_tpu_torch.utils.data import Standardizer
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, EM_RTOL, LD_ATOL = 1e-10, 1e-9, 1e-3
N, T, K = 21, 48, 5
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)
FULL_MISS, FEW = 7, 11        # a fully missing step; one observing 2 series


def _panel(seed=5, masked=False):
    """(params, Y zero-filled at missing, mask or None).  Masked: 30%
    scattered missing, step FULL_MISS unobserved, step FEW observing 2
    series (fewer than r = 3)."""
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N, K, rng)
    Y, _ = dgp.simulate(p, T, rng)
    if not masked:
        return p, Y, None
    W = (rng.random((T, N)) > 0.3).astype(float)
    W[FULL_MISS] = 0.0
    W[FEW] = 0.0
    W[FEW, :2] = 1.0
    return p, np.where(W > 0, Y, 0.0), W


def _pair(p, Y, W, r):
    """The JAX lowrank filter + smoother and the port's, same inputs."""
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    mj = None if W is None else jnp.asarray(W)
    mt = None if W is None else torch.as_tensor(W)
    kj = jl.lowrank_filter(jnp.asarray(Y), pj, mask=mj, rank=r)
    sj = jl.lowrank_smoother(kj, pj, rank=r)
    kt, st = tl.lowrank_filter_smoother(torch.as_tensor(Y), pt, mask=mt,
                                        rank=r)
    return (kj, sj), (kt, st)


def _n_obs(W):
    return np.full(T, N) if W is None else W.sum(1)


# ------------------------------------------------ rank and basis ------

@pytest.mark.parametrize("k,rank", [(4, 0), (12, 0), (12, 3), (12, 99),
                                    (12, -1), (3, 2), (20, 0), (1, 5)])
def test_resolve_rank_matches_jax_and_oracle(k, rank):
    assert tl.resolve_rank(k, rank) == jl.resolve_rank(k, rank) \
        == jref.resolve_rank(k, rank)
    assert tl.DEFAULT_MAX_RANK == jl.DEFAULT_MAX_RANK


def _separated(seed=3, k=K):
    """Loadings whose information matrix has eigenvalues ~4^-j apart."""
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N, k, rng)
    Lam = np.asarray(p.Lam) * (2.0 ** -np.arange(k))[None, :]
    return Lam, np.asarray(p.R)


@pytest.mark.parametrize("r", [1, 3, K])
def test_policy_basis_projector_matches_jax(r):
    Lam, R = _separated()
    Vj = np.asarray(jl.policy_basis(jnp.asarray(Lam), jnp.asarray(R), r))
    Vt = tl.policy_basis(torch.as_tensor(Lam), torch.as_tensor(R), r).numpy()
    assert Vt.shape == (K, r)
    np.testing.assert_allclose(Vt.T @ Vt, np.eye(r), atol=1e-12)
    close(Vt @ Vt.T, Vj @ Vj.T, PASS_RTOL)
    # The bucket form: lanes of the stacked (B, N, k) loadings.
    Lam2, R2 = _separated(seed=4)
    Vb = tl.policy_basis(torch.as_tensor(np.stack([Lam, Lam2])),
                         torch.as_tensor(np.stack([R, R2])), r).numpy()
    close(Vb[0] @ Vb[0].T, Vt @ Vt.T, PASS_RTOL)
    V2 = tl.policy_basis(torch.as_tensor(Lam2), torch.as_tensor(R2),
                         r).numpy()
    close(Vb[1] @ Vb[1].T, V2 @ V2.T, PASS_RTOL)


def test_chol_small_matches_jax_and_nans_an_indefinite_factor():
    """ops.linalg.chol_small / chol_solve_small: the JAX factors and
    solves on a batch of SPD systems, and NaN (no clamp, no raise) for the
    indefinite one, as the JAX function gives."""
    from dfm_tpu.ops import linalg as jla
    from dfm_tpu_torch.ops import linalg as tla
    rng = np.random.default_rng(2)
    X = rng.standard_normal((3, 4, 4))
    M = X @ X.transpose(0, 2, 1) + 0.1 * np.eye(4)
    M[2] = np.diag([1.0, -1.0, 2.0, 3.0])
    B = rng.standard_normal((3, 4, 2))
    Lt = tla.chol_small(torch.as_tensor(M))
    Lj = np.asarray(jla.chol_small(jnp.asarray(M)))
    close(Lt[:2], Lj[:2], PASS_RTOL)
    np.testing.assert_array_equal(Lt[2].numpy(), Lj[2])    # NaN below
    close(tla.chol_solve_small(Lt[:2], torch.as_tensor(B[:2])),
          np.asarray(jla.chol_solve_small(jnp.asarray(Lj[:2]),
                                          jnp.asarray(B[:2]))), PASS_RTOL)


# --------------------------------------------------- single passes ----

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("r", [1, 3, K])
def test_single_pass_matches_jax(masked, r):
    """Filter (moments, logdetG, corr, loglik) and smoother (moments,
    P_lag) against the JAX functions; a fully masked step is exactly
    inert (logdetG = corr = 0, x_f = x_pred)."""
    p, Y, W = _panel(masked=masked)
    (kj, sj), (kt, st) = _pair(p, Y, W, r)
    for a, b in zip(list(kt[:4]) + list(st), list(kj[:4]) + list(sj)):
        close(a, b, PASS_RTOL)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    mj = None if W is None else jnp.asarray(W)
    mt = None if W is None else torch.as_tensor(W)
    from dfm_tpu.ssm.info_filter import obs_stats as jstats
    oj = jl.lowrank_from_stats(jstats(jnp.asarray(Y), pj.Lam, pj.R, mask=mj),
                               pj, r)
    ot = tl.lowrank_from_stats(ti.obs_stats(torch.as_tensor(Y), pt.Lam, pt.R,
                                            mask=mt), pt, r)
    deficient = (_n_obs(W) > 0) & (_n_obs(W) < r)
    for a, b in zip(ot[4:], oj[4:]):
        a, b = a.numpy(), np.asarray(b)
        close(a[~deficient], b[~deficient], PASS_RTOL)
        np.testing.assert_allclose(a[deficient], b[deficient], rtol=0,
                                   atol=LD_ATOL)
    ll_t, ll_j = float(kt.loglik), float(kj.loglik)
    assert abs(ll_t - ll_j) <= (PASS_RTOL * abs(ll_j)
                                + LD_ATOL * deficient.sum())
    if masked:
        assert float(ot[4][FULL_MISS]) == 0.0 == float(ot[5][FULL_MISS])
        assert torch.equal(ot[2][FULL_MISS], ot[0][FULL_MISS])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_single_pass_matches_the_numpy_oracle(masked):
    p, Y, W = _panel(seed=8, masked=masked)
    if W is not None:
        W[FEW, :4] = 1.0            # >= r observed: the loglik is defined
    kt, st = tl.lowrank_filter_smoother(
        torch.as_tensor(Y), TP.from_numpy(p),
        mask=None if W is None else torch.as_tensor(W), rank=3)
    kn = jref.kalman_filter_lowrank(Y, p, mask=W, rank=3)
    sn = jref.rts_smoother_lowrank(kn, p, rank=3)
    for name in ("x_pred", "P_pred", "x_filt", "P_filt"):
        close(getattr(kt, name), getattr(kn, name), PASS_RTOL)
    for name in ("x_sm", "P_sm", "P_lag"):
        close(getattr(st, name), getattr(sn, name), PASS_RTOL)
    np.testing.assert_allclose(float(kt.loglik), kn.loglik, rtol=PASS_RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_rank_k_is_the_exact_info_pair(masked):
    p, Y, W = _panel(seed=6, masked=masked)
    if W is not None:
        W[FEW, :K] = 1.0            # >= r observed: the loglik is defined
    Yt, pt = torch.as_tensor(Y), TP.from_numpy(p)
    mt = None if W is None else torch.as_tensor(W)
    kt, st = tl.lowrank_filter_smoother(Yt, pt, mask=mt, rank=K)
    ki = ti.info_filter(Yt, pt, mask=mt)
    si = rts_smoother(ki, pt)
    for a, b in zip(list(kt[:4]) + list(st), list(ki[:4]) + list(si)):
        close(a, b, EM_RTOL)
    np.testing.assert_allclose(float(kt.loglik), float(ki.loglik),
                               rtol=EM_RTOL)


def test_downdate_is_conservative():
    """P_lowrank - P_exact >= 0 in the PSD order (to rounding), filtered
    and smoothed, at r = 2 < k."""
    p, Y, W = _panel(seed=7, masked=True)
    Yt, pt, mt = torch.as_tensor(Y), TP.from_numpy(p), torch.as_tensor(W)
    kt, st = tl.lowrank_filter_smoother(Yt, pt, mask=mt, rank=2)
    ki = ti.info_filter(Yt, pt, mask=mt)
    si = rts_smoother(ki, pt)
    for lr, ex in ((kt.P_filt, ki.P_filt), (st.P_sm, si.P_sm)):
        gap = torch.linalg.eigvalsh(0.5 * ((lr - ex) + (lr - ex).mT))
        assert float(gap.min()) > -1e-9
    cov_lr = tl.state_coverage(st.x_sm, st.P_sm, si.x_sm.numpy(), z=1.0)
    assert cov_lr == pytest.approx(jl.state_coverage(
        np.asarray(st.x_sm), np.asarray(st.P_sm), si.x_sm.numpy(), z=1.0))


def test_e_step_matches_jax():
    """EMConfig(filter="lowrank", rank=3).e_step: one policy basis for
    both passes, the JAX E-step's numbers."""
    p, Y, W = _panel(seed=9, masked=True)
    W[FEW, :4] = 1.0
    kt, stt, dt_ = EMConfig(filter="lowrank", rank=3).e_step(
        torch.as_tensor(Y), torch.as_tensor(W), TP.from_numpy(p))
    kj, sjj, dj = JEMConfig(filter="lowrank", rank=3).e_step(
        jnp.asarray(Y), jnp.asarray(W), JP.from_numpy(p, jnp.float64))
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik),
                               rtol=PASS_RTOL)
    for a, b in zip(stt, sjj):
        close(a, b, PASS_RTOL)
    assert float(dt_) == float(dj) == 0.0


def test_float32_pass_against_float64():
    """The f32 pass against the f64 one, with the earlier files' widening
    rule: within 1e-4 of each output's scale plus four times the JAX f32
    function's own distance from its f64 answer; the loglik within 1e-5
    relative (the contract's bound)."""
    p, Y, W = _panel(seed=10, masked=True)
    W[FEW, :4] = 1.0
    (kj, sj), (kt, st) = _pair(p, Y, W, 3)
    Y32, W32 = Y.astype(np.float32), W.astype(np.float32)
    kt32, st32 = tl.lowrank_filter_smoother(
        torch.as_tensor(Y32), TP.from_numpy(p, torch.float32),
        mask=torch.as_tensor(W32), rank=3)
    pj32 = JP.from_numpy(p, jnp.float32)
    kj32 = jl.lowrank_filter(jnp.asarray(Y32), pj32, mask=jnp.asarray(W32),
                             rank=3)
    sj32 = jl.lowrank_smoother(kj32, pj32, rank=3)
    for got, want, jax32 in zip(list(kt32[:4]) + list(st32),
                                list(kt[:4]) + list(st),
                                list(kj32[:4]) + list(sj32)):
        got, want = got.double().numpy(), want.numpy()
        noise = float(np.abs(np.asarray(jax32, np.float64) - want).max())
        assert (np.abs(got - want).max()
                <= 1e-4 * np.abs(want).max() + 4.0 * noise)
    assert kt32.loglik.dtype == torch.float64
    ll = float(kt.loglik)
    assert abs(float(kt32.loglik) - ll) < 1e-5 * abs(ll)


def test_wrappers_hold_their_kernel_range():
    """On the CPU the twins take any k (here k = 120, past K9's own kernels'
    100); the range check raises NotImplementedError naming the ROADMAP row
    past the generic kernels' k = 128, whatever r."""
    from dfm_tpu_torch import kernels
    C = torch.eye(120, dtype=torch.float64)[None]
    assert tl.lowrank_basis(C, 4).shape == (1, 120, 4)
    for k, r in ((129, 8), (129, 129)):
        with pytest.raises(NotImplementedError, match="Generic k"):
            kernels.check_lowrank("lowrank_scan", k, r)
    with pytest.raises(NotImplementedError, match="Generic k"):
        kernels.check_k("info_scan", 17)
    with pytest.raises(ValueError):
        kernels.check_lowrank("lowrank_scan", 3, 4)


# ------------------------------------------- fit, session, fleet -------

def _fit_panel(seed=12, N_=30, T_=70, k=4):
    rng = np.random.default_rng(seed)
    Y, _ = dgp.simulate(dgp.dfm_params(N_, k, rng), T_, rng)
    Y = 2.0 * Y + 0.5
    Y[rng.random(Y.shape) < 0.1] = np.nan
    Y[T_ - 3:, : N_ // 4] = np.nan              # a ragged edge
    return Y


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
def test_fit_matches_jax(fused):
    """fit(filter="lowrank", rank=3): the chunked fit (reporting smooth on
    the exact info pair, as in the JAX package) and the fused fit (the
    final smooth through the lowrank pair, nowcast and forecasts).  Four
    iterations: EM at r < k is not monotone, and on this panel both
    packages stop a tol = 0 fit as diverged at the fifth."""
    Y = _fit_panel()
    kw = dict(max_iters=4, tol=0.0, fused=fused)
    rj = jfit(JModel(4), Y, backend=TPUBackend(
        dtype=np.float64, filter="lowrank", rank=3, robust=False), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(4), Y, backend=dtt.TorchBackend(
        device="cpu", dtype=torch.float64, filter="lowrank", rank=3), **kw)
    assert rt.filter == rj.filter == "lowrank"
    assert rt.n_iters == rj.n_iters == 4 and rt.converged == rj.converged
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=EM_RTOL)
    s = np.sign(np.sum(rt.params.Lam * rj.params.Lam, axis=0))
    close(rt.params.Lam * s, rj.params.Lam, EM_RTOL)
    for name in ("R", "mu0"):
        close(getattr(rt.params, name) * (s if name == "mu0" else 1.0),
              getattr(rj.params, name), EM_RTOL)
    D = np.diag(s)
    for name in ("A", "Q", "P0"):
        close(D @ getattr(rt.params, name) @ D, getattr(rj.params, name),
              EM_RTOL)
    close(rt.factors * s, rj.factors, EM_RTOL)
    close(D @ rt.factor_cov @ D, rj.factor_cov, EM_RTOL)
    if fused:
        close(rt.nowcast, rj.nowcast, EM_RTOL)
        for key in ("y", "di"):
            close(rt.forecasts[key], rj.forecasts[key], EM_RTOL)


def _as_port(rj, k):
    s = rj.standardizer
    return dtt.FitResult(
        params=rj.params, logliks=rj.logliks, factors=rj.factors,
        factor_cov=rj.factor_cov, converged=rj.converged, n_iters=rj.n_iters,
        standardizer=(Standardizer(s.mean, s.scale) if s is not None
                      else None),
        model=dtt.DynamicFactorModel(k), backend="torch", history=[],
        filter=rj.filter)


def _assert_update_matches(tu, ju):
    assert (tu.t, tu.n_iters, tu.converged, tu.diverged) == (
        ju.t, ju.n_iters, ju.converged, ju.diverged)
    for name in ("nowcast", "nowcast_sd", "factors", "factor_cov",
                 "forecast_sd", "logliks"):
        close(getattr(tu, name), getattr(ju, name), EM_RTOL)
    for key in ("y", "f", "di"):
        close(tu.forecasts[key], ju.forecasts[key], EM_RTOL)


def test_ring_session_matches_jax():
    """A lowrank ring session at rank 2: 3 updates, the first evicting
    (capacity 42 < 40 + 3), against the JAX session; the session's rank,
    key and snapshot carry the rank."""
    Y = _fit_panel(seed=13, N_=24, T_=52, k=3)
    jb = TPUBackend(dtype=np.float64, filter="lowrank", rank=2,
                    fused_chunk=4)
    rj = jfit(JModel(3), Y[:40], backend=jb, fused=True, max_iters=6,
              tol=0.0, robust=False)
    rt = _as_port(rj, 3)
    kw = dict(capacity=42, max_update_rows=4, max_iters=4, tol=0.0,
              ring=True)
    js = dfm_tpu.open_session(rj, Y[:40], backend=jb, robust=False, **kw)
    tb = dtt.TorchBackend(device="cpu", dtype=torch.float64, rank=2,
                          fused_chunk=4)
    ts = dtt.open_session(rt, Y[:40], backend=tb, **kw)
    assert ts.filter == js.filter == "lowrank" and ts.rank == js.rank == 2
    assert ts.key == js._key
    for lo, hi in ((40, 43), (43, 44), (44, 48)):
        _assert_update_matches(ts.update(Y[lo:hi]), js.update(Y[lo:hi]))
    assert ts.n_evicted == js.n_evicted > 0


def test_fleet_bucket_with_a_k_padded_lane_matches_jax(tmp_path,
                                                        monkeypatch):
    """A lowrank bucket of k = 2 and k = 3 tenants (k_max = 3, rank auto
    -> 3): two ticks against the JAX fleet; each lane is the JAX vmap of
    the lone pair, here one batched pass."""
    monkeypatch.setenv("DFM_RUNS", str(tmp_path / "runs"))
    ten = []
    for N_, k, seed in ((10, 2, 31), (12, 3, 32)):
        Y = _fit_panel(seed=seed, N_=N_, T_=46, k=k)
        rj = jfit(JModel(k), Y[:40], backend=TPUBackend(dtype=np.float64),
                  max_iters=6, robust=False)
        ten.append((rj, _as_port(rj, k), Y[:40], Y[40:]))
    kw = dict(capacity=50, max_update_rows=3, max_iters=3, tol=0.0,
              max_classes=1, filter="lowrank")
    jf = dfm_tpu.open_fleet([t[0] for t in ten], [t[2] for t in ten],
                            backend=TPUBackend(dtype=np.float64),
                            robust=False, **kw)
    tf = dtt.open_fleet([t[1] for t in ten], [t[2] for t in ten],
                        backend=CPU, **kw)
    assert tf.classes == jf.classes
    assert tf._buckets[0].dims[2] == 3
    for tick in ((2, 3), (1, 0)):
        for i, n in enumerate(tick):
            if n:
                tf.submit(f"t{i}", ten[i][3][:n])
                jf.submit(f"t{i}", ten[i][3][:n])
        to, jo = tf.drain(), jf.drain()
        assert sorted(to) == sorted(jo)
        for name in jo:
            _assert_update_matches(to[name][0], jo[name][0])
