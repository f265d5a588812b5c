"""The steady-state (ss) and covariance-form parallel-in-time (pit) engines
past k = 32, where the card takes the generic kernels K5a-gen
(``ss_cov_path_gen``), K5b-gen (``affine_scan_gen``), K14-el-gen
(``pit_elements_gen``) and K14-scan-gen (``pit_scan_gen``), against dfm_tpu
at float64 on the CPU.

The CPU runs each kernel's plain twin, which takes any k, so these tests
hold the engines' algebra at k = 34 and 40 against the JAX package: single
passes at 1e-10 relative (``close``: to the array's largest entry), the EM
paths (the unmasked ``auto`` -> ``ss`` fit, the masked ``pit`` fit, the
mixed-frequency ``time_scan="pit"`` fit at m = 35) at 1e-9 (each iteration
carries ~1e-13 rounding into the next params).  The masked pit panel has
scattered missing values, a fully missing step and a never-observed series
(observed once for the fit: ``fit`` refuses an all-missing column).
``kernels.route`` gives the four entry points their generic kernels from
33 to 128 and raises naming the ROADMAP row at 129, before any launch (a
"meta" tensor takes the kernel route without a card).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.models import mixed_freq as jm
from dfm_tpu.ops import scan as jsc
from dfm_tpu.ssm import info_filter as jinf
from dfm_tpu.ssm import parallel_filter as jpf
from dfm_tpu.ssm import steady as jss
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.models import mixed_freq as tm
from dfm_tpu_torch.ops import scan as tsc
from dfm_tpu_torch.ssm import info_filter as tinf
from dfm_tpu_torch.ssm import parallel_filter as tpf
from dfm_tpu_torch.ssm import steady as tss
from dfm_tpu_torch.ssm.params import FilterResult as TFR
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
KS = (34, 40)
TAU = 8
T, N = 60, 80
FULL_MISS, NEVER = 9, 5
CPU64 = dict(device="cpu", dtype=torch.float64)
NAMES = ("ss_cov_path", "affine_scan", "pit_elements", "pit_scan")


@functools.lru_cache(maxsize=None)
def _panel(k):
    """(true params, fully observed Y, mask): 10% scattered missing, a
    fully missing step and a never-observed series."""
    rng = np.random.default_rng(1500 + k)
    p = dgp.dfm_params(N, k, rng)
    Y, _ = dgp.simulate(p, T, rng)
    W = (rng.random(Y.shape) >= 0.1).astype(np.float64)
    W[FULL_MISS] = 0.0
    W[:, NEVER] = 0.0
    return p, 1.5 * Y + 0.5, W


def _same(got, want, rtol=PASS_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.numpy() if isinstance(g, torch.Tensor) else g,
              np.asarray(w), rtol)


# --------------------------------------------------------------- ss ----

@pytest.mark.parametrize("k", KS)
def test_ss_passes_match_jax(k):
    """ss_cov_path_plain (the twin of K5a-gen) against the JAX covariance
    path and smoother, and ss_filter_smoother against dfm_tpu's, on the
    fully observed panel at tau = 8."""
    p, Y, _ = _panel(k)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    sj = jinf.obs_stats(jnp.asarray(Y), pj.Lam, pj.R)
    st = tinf.obs_stats(torch.as_tensor(Y), pt.Lam, pt.R)
    Pp, Pf, M, ldG, delta, J, front, end_rev = tss.ss_cov_path_plain(
        st.C, pt.A, pt.Q, pt.P0, TAU)
    want = jss._cov_path(sj.C, pj.A, pj.Q, pj.P0, TAU, jnp.float64)
    _same((Pp, Pf, M, ldG), want[:4])
    # delta is converged to rounding here (~1e-18): compared as
    # tests/test_torch_steady.py does, absolutely.
    assert float(delta) == pytest.approx(float(want[4]), abs=1e-15)
    assert tuple(J.shape) == tuple(front.shape) == (TAU, k, k)
    kj, smj, dj = jss.ss_filter_smoother(jnp.asarray(Y), pj, tau=TAU)
    kt, smt, dtt_ = tss.ss_filter_smoother(torch.as_tensor(Y), pt, tau=TAU)
    assert 2 * TAU + 4 < T                 # not the exact fallback
    close(float(kt.loglik), float(kj.loglik), PASS_RTOL)
    _same(kt[:4], kj[:4])
    _same(smt, smj)
    assert float(dtt_) == pytest.approx(float(dj), abs=1e-15)
    # The smoother's covariance path is the kernel's output rows.
    close(smt.P_sm[:TAU], front, 0.0)
    close(smt.P_sm[T - 1 - TAU:T - 1], end_rev.flip(0), 0.0)


def _jax_affine(d, Mh, M, xb, reverse):
    """The JAX engine's mean recursions (dfm_tpu/ssm/steady.py:183-191,
    243-245): the exact head by ``lax.scan``, the constant tail by
    ``affine_const_prefix``; forward from x_0 = xb, or reverse from
    x_{T-1} = xb."""
    T_, h = d.shape[0], Mh.shape[0]

    def vstep(x, inp):
        M_t, d_t = inp
        x_new = M_t @ x + d_t
        return x_new, x_new

    if not reverse:
        last, head = lax.scan(vstep, xb, (Mh[1:h], d[1:h]))
        tail = jsc.affine_const_prefix(M, d[h:], last)
        return jnp.concatenate([xb[None], head, tail], axis=0)
    c_rev = jnp.flip(d[:T_ - 1], axis=0)
    y_const = jsc.affine_const_prefix(M, c_rev[:T_ - h], xb)
    _, y_exact = lax.scan(vstep, y_const[-1],
                          (jnp.flip(Mh[:h - 1], axis=0), c_rev[T_ - h:]))
    ys = jnp.concatenate([y_const, y_exact], axis=0)
    return jnp.concatenate([jnp.flip(ys, axis=0), xb[None]], axis=0)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_affine_scan_plain_matches_jax_head_and_tail(k, reverse):
    """affine_scan_plain (the twin of K5b-gen) against the JAX head and
    tail scans, on maps of spectral radius < 1 (the closed-loop filter and
    smoother gains are)."""
    rng = np.random.default_rng(2 * k + reverse)
    Mh = rng.standard_normal((TAU, k, k))
    Mh *= 0.9 / np.abs(np.linalg.eigvals(Mh)).max(axis=-1)[:, None, None]
    d = rng.standard_normal((T, k))
    xb = rng.standard_normal(k)
    want = _jax_affine(jnp.asarray(d), jnp.asarray(Mh), jnp.asarray(Mh[-1]),
                       jnp.asarray(xb), reverse)
    got = tsc.affine_scan_plain(torch.as_tensor(d), torch.as_tensor(Mh),
                                torch.as_tensor(Mh[-1]), torch.as_tensor(xb),
                                reverse=reverse)
    close(got, want, PASS_RTOL)
    # The launcher on CPU tensors is the twin itself.
    assert torch.equal(tsc.affine_scan(
        torch.as_tensor(d), torch.as_tensor(Mh), torch.as_tensor(Mh[-1]),
        torch.as_tensor(xb), reverse=reverse), got)


def test_auto_ss_fit_matches_jax():
    """``fit`` with the default backend's rule on a fully observed 90 x
    520 panel at k = 34 resolves to ``ss`` (tau = auto_tau(init)) in both
    packages; 3 iterations agree to 1e-9."""
    k = 34
    rng = np.random.default_rng(3400)
    p = dgp.dfm_params(520, k, rng)
    Y, _ = dgp.simulate(p, 90, rng)
    kw = dict(max_iters=3, tol=0.0)
    rj = jfit(JModel(k), Y, backend=TPUBackend(dtype=np.float64), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(k), Y,
                 backend=dtt.TorchBackend(**CPU64), **kw)
    assert rt.filter == rj.filter == "ss"
    assert 2 * rt.tau + 4 < Y.shape[0]     # not the exact fallback
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for f in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, f), getattr(rj.params, f), FIT_RTOL)
    close(rt.factors, rj.factors, FIT_RTOL)
    close(rt.factor_cov, rj.factor_cov, FIT_RTOL)


# -------------------------------------------------------------- pit ----

def _stats(k, masked):
    p, Y, W = _panel(k)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    m = W if masked else None
    sj = jinf.obs_stats(jnp.asarray(Y), pj.Lam, pj.R,
                        mask=None if m is None else jnp.asarray(m))
    st = tinf.ObsStats(*(torch.tensor(np.asarray(x)) for x in sj))
    return pj, pt, sj, st


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("masked", [False, True], ids=["static", "masked"])
def test_pit_passes_match_jax(k, masked):
    """pit_filter_elements, pit_from_stats (the prefix and the assembly),
    pit_smoother and pit_filter_smoother: the twins of K14-el-gen (all
    four modes) and K14-scan-gen (prefix and suffix); T = 60 leaves a
    non-empty tail after the blocks (S = 7, B = 8)."""
    pj, pt, sj, st = _stats(k, masked)
    if masked:
        assert float(st.n[FULL_MISS]) == 0.0
    _same(tpf.pit_filter_elements(st, pt.A, pt.Q, pt.mu0, pt.P0),
          jpf._filter_elements(sj, pj.A, pj.Q, pj.mu0, pj.P0))
    _same(tpf.pit_from_stats(st, pt), jpf.pit_from_stats(sj, pj))
    p, Y, W = _panel(k)
    m = W if masked else None
    kj, smj = jpf.pit_filter_smoother(
        jnp.asarray(Y), pj, mask=None if m is None else jnp.asarray(m))
    kt, smt = tpf.pit_filter_smoother(
        torch.as_tensor(Y), pt, mask=None if m is None else torch.as_tensor(m))
    close(float(kt.loglik), float(kj.loglik), PASS_RTOL)
    _same(kt[:4], kj[:4])
    _same(smt, smj)
    kf = TFR(*(torch.tensor(np.asarray(x)) for x in kj))
    _same(tpf.pit_smoother(kf, pt), jpf.pit_smoother(kj, pj))


def test_pit_fit_matches_jax():
    """``fit(filter="pit")`` on the masked 60 x 80 panel at k = 34 (the
    never-observed series observed once), 4 iterations: 1e-9."""
    k = 34
    _, Y, W = _panel(k)
    W = W.copy()
    W[0, NEVER] = 1.0
    Ynan = np.where(W > 0, Y, np.nan)
    kw = dict(max_iters=4, tol=0.0)
    rj = jfit(JModel(k), Ynan, backend=TPUBackend(dtype=np.float64,
                                                  filter="pit"), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(k), Ynan,
                 backend=dtt.TorchBackend(filter="pit", **CPU64), **kw)
    assert rt.filter == rj.filter == "pit"
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for f in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, f), getattr(rj.params, f), FIT_RTOL)
    close(rt.factors, rj.factors, FIT_RTOL)
    close(rt.factor_cov, rj.factor_cov, FIT_RTOL)


def test_mf_pit_past_32_matches_jax():
    """``MixedFreqSpec(24, 8, 7, time_scan="pit")`` (augmented width m =
    35) on 60 steps with a fully missing step and a never-observed
    monthly series, 4 iterations: 1e-9."""
    rng = np.random.default_rng(7)
    Y, mask, _, _ = dgp.simulate_mixed_freq(24, 8, 60, 7, rng)
    W = mask * dgp.random_mask(60, 32, rng, 0.1)
    W[17] = 0.0
    W[:, 2] = 0.0
    Y = np.where(W > 0, Y, np.nan)
    kw = dict(n_monthly=24, n_quarterly=8, n_factors=7, time_scan="pit")
    rj = jm.mf_fit(Y, jm.MixedFreqSpec(**kw), mask=W, max_iters=4, tol=0.0,
                   fused_chunk=2)
    rt = dtt.fit(dtt.MixedFreqSpec(**kw), Y, mask=W, max_iters=4, tol=0.0,
                 backend=dtt.TorchBackend(fused_chunk=2, **CPU64))
    assert tm.MixedFreqSpec(**kw).state_dim == 35
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for name in tm.MFParams._fields:
        close(np.asarray(getattr(rt.params, name)),
              np.asarray(getattr(rj.params, name)), FIT_RTOL)
    for name in ("nowcast", "factors", "factor_cov"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)


# ----------------------------------------------------------- routing ---

@pytest.mark.parametrize("k", [33, 100, 128])
def test_routes_to_the_generic_kernels(k):
    for name in NAMES:
        got = kernels.route(name, k)
        assert got == kernels.GEN[name] == f"{name}_gen"
        assert kernels.KERNELS[got][0] == kernels.KERNELS[name][0]


def _meta(*shape):
    """A tensor with no storage: a wrapper takes its kernel route for any
    device but the CPU, so a "meta" tensor reaches the range check without
    a card."""
    return torch.zeros(shape, device="meta")


def test_k129_raises_naming_the_roadmap_row_before_any_launch():
    k = 129
    for name in NAMES:
        with pytest.raises(NotImplementedError, match="Generic k") as err:
            kernels.route(name, k)
        assert kernels.GENERIC_K in str(err.value)
    kernels.reset_launches()
    mats, vecs, eye = _meta(5, k, k), _meta(5, k), _meta(k, k)
    st = tinf.ObsStats(vecs, mats, _meta(5), _meta(5))
    kf = TFR(vecs, mats, vecs, mats, None)
    calls = [
        lambda: tss.ss_cov_path(eye, eye, eye, eye, TAU),
        lambda: tsc.affine_scan(vecs, mats, eye, _meta(k)),
        lambda: tpf.pit_filter_elements(st, eye, eye, _meta(k), eye),
        lambda: tpf.pit_scan((mats, vecs, mats, vecs, mats)),
        lambda: tpf.pit_scan((mats, vecs, mats), smoother=True),
        lambda: tpf.pit_filter_assemble(vecs, mats, mats, eye, eye, _meta(k),
                                        eye),
        lambda: tpf.pit_smoother_elements(kf, eye),
        lambda: tpf.pit_smoother_assemble(mats, mats[:4]),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Generic k") as err:
            call()
        assert kernels.GENERIC_K in str(err.value)
    assert not any(kernels.LAUNCHES.values())
