"""dfm_tpu_torch's covariance-form parallel-in-time engine (pit) against
dfm_tpu at float64 on the CPU, where K14's launchers run their plain twins.

- Single passes (the element builds, the two combines in 2-D and batched,
  the blocked scans, the filter and the smoother) agree with the JAX
  functions to 1e-10 relative (``close``: to the array's largest entry),
  the filter and smoother also with the port's own info pair to 1e-9 (the
  bounds of tests/test_parallel_filter.py).
- EM paths (``em_fit_scan``, ``fit``, the fused fit, sessions, the
  mixed-frequency ``time_scan="pit"`` fits) agree to 1e-9.
- The f32 MF pit trajectory stays within 2e-4 of the sequential one
  (tests/test_mixed_freq.py's bound), and the log-depth scan
  (``scan_impl="associative"``) gives the JAX pair's answers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu import open_session as jopen
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.estim import em as jem
from dfm_tpu.models import mixed_freq as jm
from dfm_tpu.ops import scan as jsc
from dfm_tpu.ssm import info_filter as jinf
from dfm_tpu.ssm import parallel_filter as jpf
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.models import mixed_freq as tm
from dfm_tpu_torch.ssm import info_filter as tinf
from dfm_tpu_torch.ssm import parallel_filter as tpf
from dfm_tpu_torch.ssm.kalman import rts_smoother
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
K = 3


@functools.lru_cache(maxsize=None)
def _setup(T=60, N=30):
    """(params, Y, mask): a fully missing step 0, a step that observes
    fewer than k series, 20% scattered missing."""
    rng = np.random.default_rng(61)
    p = dgp.dfm_params(N, K, rng)
    Y, _ = dgp.simulate(p, T, rng)
    W = dgp.random_mask(T, N, np.random.default_rng(62), 0.2)
    W[0] = 0.0
    W[9] = 0.0
    W[9, :K - 1] = 1.0
    return p, Y, W


def _stats(masked, T=60):
    p, Y, W = _setup(T)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    m = W if masked else None
    sj = jinf.obs_stats(jnp.asarray(Y), pj.Lam, pj.R,
                        mask=None if m is None else jnp.asarray(m))
    st = tinf.ObsStats(*(torch.tensor(np.asarray(x)) for x in sj))
    return pj, pt, sj, st


def _filters(masked):
    p, Y, W = _setup()
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    kj = jpf.pit_filter(jnp.asarray(Y), pj,
                        mask=jnp.asarray(W) if masked else None)
    kt = tpf.pit_filter(torch.as_tensor(Y), pt,
                        mask=torch.as_tensor(W) if masked else None)
    return p, pj, pt, kj, kt


def _same(got, want, rtol=PASS_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.numpy() if isinstance(g, torch.Tensor) else g,
              np.asarray(w), rtol)


# ------------------------------------------------------- single passes --

@pytest.mark.parametrize("masked", [False, True])
def test_filter_elements_match_jax(masked):
    """Masked: step 0 is fully missing (C_0 = 0) and step 9 sees fewer
    than k series (a rank-deficient C_t)."""
    pj, pt, sj, st = _stats(masked)
    want = jpf._filter_elements(sj, pj.A, pj.Q, pj.mu0, pj.P0)
    got = tpf._filter_elements(st, pt.A, pt.Q, pt.mu0, pt.P0)
    _same(got, want)
    # The launcher on CPU tensors is the twin itself.
    for g, w in zip(tpf.pit_filter_elements(st, pt.A, pt.Q, pt.mu0, pt.P0),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_smoother_elements_match_jax(masked):
    p, pj, pt, kj, kt = _filters(masked)
    (wE, wg, wL), wJ = jpf._smoother_elements(kj, pj.A)
    (gE, gg, gL), gJ = tpf._smoother_elements(kt, pt.A)
    _same((gE, gg, gL, gJ), (wE, wg, wL, wJ))
    (cE, cg, cL), cJ = tpf.pit_smoother_elements(kt, pt.A)
    assert torch.equal(cL, gL) and torch.equal(cJ, gJ)


def _elements(rng, shape):
    """Random filter elements with PSD C and J, leading ``shape``."""
    def psd():
        X = rng.standard_normal(shape + (K, K + 1)) * 0.5
        return X @ np.swapaxes(X, -1, -2)
    A = rng.standard_normal(shape + (K, K)) * 0.4
    return (A, rng.standard_normal(shape + (K,)), psd(),
            rng.standard_normal(shape + (K,)), psd())


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)],
                         ids=["2-D", "batched", "batched-2"])
def test_combine_filter_matches_jax(batch):
    rng = np.random.default_rng(len(batch) + 70)
    ei, ej = _elements(rng, batch), _elements(rng, batch)
    want = jpf._combine_filter(tuple(map(jnp.asarray, ei)),
                               tuple(map(jnp.asarray, ej)))
    got = tpf._combine_filter(tuple(map(torch.tensor, ei)),
                              tuple(map(torch.tensor, ej)))
    _same(got, want)


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)],
                         ids=["2-D", "batched", "batched-2"])
def test_combine_smoother_matches_jax(batch):
    rng = np.random.default_rng(len(batch) + 80)
    el, ee = (_elements(rng, batch)[:3] for _ in range(2))    # (E, g, L)
    want = jpf._combine_smoother(tuple(map(jnp.asarray, el)),
                                 tuple(map(jnp.asarray, ee)))
    got = tpf._combine_smoother(tuple(map(torch.tensor, el)),
                                tuple(map(torch.tensor, ee)))
    _same(got, want)


_jax_prefix = jax.jit(lambda e: jsc.blocked_scan(jpf._combine_filter, e))
_jax_suffix = jax.jit(
    lambda e: jsc.blocked_scan(jpf._combine_smoother, e, reverse=True))


@pytest.mark.parametrize("T", [1, 2, 3, 7, 29, 97])
def test_pit_scan_plain_matches_blocked_scan(T):
    """The prefix of real filter elements and the suffix of real smoother
    elements (the port's plain builds on the first T steps), against
    dfm_tpu.ops.scan.blocked_scan with the JAX combines: T = 1..3 exercise
    the empty phases, 7, 29 and 97 a remainder."""
    p, Y, W = _setup()
    pt = TP.from_numpy(p)
    Yt, Wt = torch.as_tensor(Y[:T]), torch.as_tensor(W[:T])
    st = tinf.obs_stats(Yt, pt.Lam, pt.R, mask=Wt)
    el = tpf._filter_elements(st, pt.A, pt.Q, pt.mu0, pt.P0)
    _same(tpf.pit_scan_plain(el),
          _jax_prefix(tuple(jnp.asarray(x.numpy()) for x in el)))
    sel, _ = tpf._smoother_elements(tpf.pit_filter(Yt, pt, mask=Wt), pt.A)
    _same(tpf.pit_scan_plain(sel, smoother=True),
          _jax_suffix(tuple(jnp.asarray(x.numpy()) for x in sel)))


@pytest.mark.parametrize("masked", [False, True])
def test_pit_filter_smoother_match_jax_and_info(masked):
    p, pj, pt, kj, kt = _filters(masked)
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik),
                               rtol=PASS_RTOL)
    _same(kt[:4], kj[:4])
    smj = jpf.pit_smoother(kj, pj)
    smt = tpf.pit_smoother(kt, pt)
    _same(smt, smj)
    # Against the port's own info pair (the JAX test's bounds).
    _, Y, W = _setup()
    ki = tinf.info_filter(torch.as_tensor(Y), pt,
                          mask=torch.as_tensor(W) if masked else None)
    si = rts_smoother(ki, pt)
    assert abs(float(kt.loglik) - float(ki.loglik)) < 1e-9 * abs(
        float(ki.loglik))
    for g, w in ((kt.x_filt, ki.x_filt), (kt.P_filt, ki.P_filt),
                 (smt.x_sm, si.x_sm), (smt.P_lag, si.P_lag)):
        close(g, w, 1e-9)


def test_unported_scan_and_width_raise():
    """The log-depth scan (``scan_impl="associative"``) gives the JAX
    pair's answers (tests/test_torch_pit_assoc.py holds it across shapes);
    the K14 kernels stop at 128 on the card."""
    p, Y, W = _setup()
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    kj = jpf.pit_filter(jnp.asarray(Y), pj, mask=jnp.asarray(W),
                        scan_impl="associative")
    kt = tpf.pit_filter(torch.as_tensor(Y), pt, mask=torch.as_tensor(W),
                        scan_impl="associative")
    _same(kt[:4], kj[:4])
    assert abs(float(kt.loglik) - float(kj.loglik)) < FIT_RTOL * abs(
        float(kj.loglik))
    _same(tpf.pit_smoother(kt, pt, scan_impl="associative"),
          jpf.pit_smoother(kj, pj, scan_impl="associative"))
    # The K14 kernels' range on the card (the CPU twins take any k): one
    # kernel each to 32, the generic one to 128.
    for name in ("pit_elements", "pit_scan"):
        assert kernels.route(name, kernels.WIDE_KMAX) == name
        assert kernels.route(name, kernels.WIDE_KMAX + 1) == \
            kernels.GEN[name]
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
            kernels.route(name, kernels.GEN_KMAX + 1)


# ------------------------------------------------------------ EM paths --

def test_em_through_pit_matches_jax():
    p, Y, W = _setup()
    Yz = np.where(W > 0, (Y - Y.mean(0)) / Y.std(0), 0.0)
    p0 = jcpu.pca_init(Yz, K, mask=W)
    cfg_t = tem.EMConfig(filter="pit")
    assert cfg_t.filter_fn() is tpf.pit_filter
    assert cfg_t.smoother_fn() is tpf.pit_smoother
    pj, lls_j, _ = jem.em_fit_scan(
        jnp.asarray(Yz), JP.from_numpy(p0, jnp.float64), 5,
        mask=jnp.asarray(W), cfg=jem.EMConfig(filter="pit"))
    ps, lls_t, _ = tem.em_fit_scan(
        torch.as_tensor(Yz), TP.from_numpy(p0), 5, mask=torch.as_tensor(W),
        cfg=cfg_t)
    np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j),
                               rtol=FIT_RTOL)
    for g, w in zip(ps[-1], pj):
        close(g, w, FIT_RTOL)


def _panel():
    p, Y, W = _setup()
    return np.where(W > 0, 2.0 * Y + 1.0, np.nan)


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
def test_fit_matches_jax(fused):
    Y = _panel()
    kw = dict(max_iters=6, tol=0.0, fused=fused)
    rj = jfit(JModel(K), Y, backend=TPUBackend(dtype=np.float64,
                                               filter="pit"), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(K), Y,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          filter="pit", fused_chunk=4), **kw)
    assert rt.filter == rj.filter == "pit"
    assert rt.n_iters == rj.n_iters == 6
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for f in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, f), getattr(rj.params, f), FIT_RTOL)
    close(rt.factors, rj.factors, FIT_RTOL)
    close(rt.factor_cov, rj.factor_cov, FIT_RTOL)
    if fused:
        close(rt.nowcast, rj.nowcast, FIT_RTOL)
        close(rt.forecasts["y"], rj.forecasts["y"], FIT_RTOL)


@pytest.mark.parametrize("ring", [False, True], ids=["plain", "ring"])
def test_session_matches_jax(ring):
    """A pit session opened on the JAX pit fit's params (the port
    FitResult built from its fields), 3 updates, the first one evicting
    when ``ring``."""
    Y = _panel()
    jb = TPUBackend(dtype=np.float64, filter="pit", fused_chunk=4)
    rj = jfit(JModel(K, standardize=False), Y[:40], backend=jb, fused=True,
              max_iters=6, tol=0.0, robust=False)
    rt = dtt.FitResult(
        params=rj.params, logliks=rj.logliks, factors=rj.factors,
        factor_cov=rj.factor_cov, converged=rj.converged,
        n_iters=rj.n_iters, standardizer=None,
        model=dtt.DynamicFactorModel(K, standardize=False), backend="torch",
        history=[], filter=rj.filter)
    kw = dict(capacity=41 if ring else 56, max_update_rows=4, max_iters=4,
              tol=0.0, ring=ring)
    js = jopen(rj, Y[:40], backend=jb, robust=False, **kw)
    ts = dtt.open_session(rt, Y[:40], backend=dtt.TorchBackend(
        device="cpu", dtype=torch.float64, filter="pit", fused_chunk=4),
        **kw)
    assert ts.filter == js.filter == "pit"
    for sl in ((40, 43), (43, 44), (44, 48)):
        tu, ju = ts.update(Y[sl[0]:sl[1]]), js.update(Y[sl[0]:sl[1]])
        assert (tu.t, tu.n_iters) == (ju.t, ju.n_iters)
        for name in ("nowcast", "nowcast_sd", "factors", "factor_cov",
                     "forecast_sd", "logliks"):
            close(getattr(tu, name), getattr(ju, name), FIT_RTOL)
    assert (ts.t, ts.n_evicted) == (js.t, js.n_evicted)
    assert ts.n_evicted == (7 if ring else 0)


# ------------------------------------------------- mixed frequency (S3) --

MF_PANELS = {"m10": (30, 8, 2), "m25": (24, 8, 5)}


@functools.lru_cache(maxsize=None)
def _mf_panel(pn):
    nm, nq, k = MF_PANELS[pn]
    rng = np.random.default_rng(5)
    Y, mask, _, _ = dgp.simulate_mixed_freq(nm, nq, 60, k, rng)
    W = mask * dgp.random_mask(60, nm + nq, rng, 0.1)
    W[56:, :nm // 3] = 0.0
    W[17] = 0.0                          # a fully missing step
    W[:, 2] = 0.0                        # a never-observed monthly series
    return np.where(W > 0, Y, np.nan), W


@pytest.mark.parametrize("pn", MF_PANELS)
def test_mf_fit_pit_matches_jax(pn):
    Y, W = _mf_panel(pn)
    nm, nq, k = MF_PANELS[pn]
    kw = dict(n_monthly=nm, n_quarterly=nq, n_factors=k, time_scan="pit")
    rj = jm.mf_fit(Y, jm.MixedFreqSpec(**kw), mask=W, max_iters=4, tol=0.0,
                   fused_chunk=2)
    rt = dtt.fit(dtt.MixedFreqSpec(**kw), Y, mask=W, max_iters=4, tol=0.0,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          fused_chunk=2))
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for name in tm.MFParams._fields:
        close(np.asarray(getattr(rt.params, name)),
              np.asarray(getattr(rj.params, name)), FIT_RTOL)
    for name in ("nowcast", "factors", "factor_cov"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)


def test_mf_pit_matches_seq_f32():
    """The f32 pit E-step's trajectory stays within the in-loop noise band
    of the sequential one (tests/test_mixed_freq.py's check, on the port)."""
    rng = np.random.default_rng(34)
    Y, mask, _, _ = dgp.simulate_mixed_freq(24, 6, 70, 2, rng)
    spec = tm.MixedFreqSpec(n_monthly=24, n_quarterly=6, n_factors=2)
    r0 = tm.mf_fit(Y, spec, mask=mask, max_iters=2, tol=0.0, device="cpu")
    W = np.where(np.isfinite(Y), mask, 0.0)
    Yz = np.where(W > 0, r0.standardizer.transform(np.nan_to_num(Y)), 0.0)
    args = (torch.tensor(Yz, dtype=torch.float32),
            torch.tensor(W, dtype=torch.float32),
            tm.MFParams(*r0.params).to("cpu", torch.float32))
    _, lls_seq = tm.mf_em_scan(*args, spec, 4)
    _, lls_pit = tm.mf_em_scan(
        *args, tm.MixedFreqSpec(n_monthly=24, n_quarterly=6, n_factors=2,
                                time_scan="pit"), 4)
    np.testing.assert_allclose(lls_pit.numpy(), lls_seq.numpy(), rtol=2e-4)
