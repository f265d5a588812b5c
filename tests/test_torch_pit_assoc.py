"""The log-depth associative scan (``scan_impl="associative"``) of the
port's parallel-in-time engines against dfm_tpu at float64 on the CPU,
where the K14-assoc and K8-assoc launchers run their plain twins.

- ``ops.scan.associative_scan`` repeats ``jax.lax.associative_scan``'s
  tree: k x k products and the affine smoothing combine, forward and
  reverse, at odd and even lengths, to 1e-12.
- The six public functions of ``pit`` and ``pit_qr`` with
  ``scan_impl="associative"`` against their JAX twins, masked and not:
  moments to 1e-10, loglik to 1e-9 relative (k = 12 takes the square-root
  engine's generic branch past ``QR_UNROLL_K_MAX``).
- In the port, the associative and blocked scans agree to 1e-9 in f64.
- The new kernels' routes: the warp kernel to 32 and the generic one to
  128 (K14-assoc), the one-thread kernel to 10 and the generic one to 128
  (K8-assoc), and a raise naming ``GENERIC_K`` at 129 before any launch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.ssm import info_filter as jif
from dfm_tpu.ssm import parallel_filter as jpf
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.ops import linalg as tla
from dfm_tpu_torch.ops import scan as tsc
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import parallel_filter as tpf
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

SCAN_RTOL, MOMENT_RTOL, LL_RTOL, IMPL_RTOL = 1e-12, 1e-10, 1e-9, 1e-9
N = 20
LENGTHS = (1, 2, 3, 4, 5, 8, 9, 17, 33)


def _affine(ei, ej):
    """The smoothing combine's algebra (later, earlier) in any array
    namespace with ``@``."""
    El, gl, Ll = ei
    Ee, ge, Le = ej
    return (Ee @ El, (Ee @ gl[..., None])[..., 0] + ge,
            Ee @ Ll @ Ee.swapaxes(-1, -2) + Le)


def _elems(kind, T, k=3):
    rng = np.random.default_rng(T)
    E = 0.5 * rng.standard_normal((T, k, k))
    if kind == "matmul":
        return E
    X = rng.standard_normal((T, k, k))
    return (E, rng.standard_normal((T, k)), X @ X.swapaxes(-1, -2))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("kind", ["matmul", "affine"])
def test_associative_scan_matches_lax(kind, T, reverse):
    el = _elems(kind, T)
    if kind == "matmul":
        got = tsc.associative_scan(lambda a, b: a @ b, torch.tensor(el),
                                   reverse=reverse)
        want = jax.lax.associative_scan(jnp.matmul, jnp.asarray(el),
                                        reverse=reverse)
        close(got, want, SCAN_RTOL)
        return
    got = tsc.associative_scan(_affine, tuple(torch.tensor(x) for x in el),
                               reverse=reverse)
    want = jax.lax.associative_scan(_affine,
                                    tuple(jnp.asarray(x) for x in el),
                                    reverse=reverse)
    for g, w in zip(got, want):
        close(g, w, SCAN_RTOL)


@functools.lru_cache(maxsize=None)
def _setup(T, k):
    """(params, Y, mask) with a fully missing step 0 and, past T = 5, a
    step that observes fewer than k series."""
    rng = np.random.default_rng(100 * T + k)
    p = dgp.dfm_params(N, k, rng)
    Y, _ = dgp.simulate(p, T, rng)
    W = dgp.random_mask(T, N, np.random.default_rng(T + k), 0.2)
    W[0] = 0.0
    if T > 5:
        W[5] = 0.0
        W[5, :k - 1] = 1.0
    return p, Y, W


ENGINES = {"pit": (tpf.pit_from_stats, tpf.pit_filter, tpf.pit_smoother,
                   jpf.pit_from_stats, jpf.pit_filter, jpf.pit_smoother),
           "pit_qr": (tpf.pit_qr_from_stats, tpf.pit_qr_filter,
                      tpf.pit_qr_smoother, jpf.pit_qr_from_stats,
                      jpf.pit_qr_filter, jpf.pit_qr_smoother)}
CASES = [(e, T, k, m) for e in ENGINES for T in (2, 7, 40)
         for k in ((1, 3) if e == "pit" else (1, 3, 12))
         for m in (True, False)]


@functools.lru_cache(maxsize=None)
def _jax(engine, T, k):
    """The JAX twins' ``*_from_stats``, ``*_filter`` and ``*_smoother`` on
    ``_setup(T, k)``, masked and not, in one jitted program a shape (the
    compile is the cost): {masked: (from_stats, filter, smoother)} as
    NumPy."""
    j_stats, j_filter, j_smoother = ENGINES[engine][3:]
    p, Y, W = _setup(T, k)

    def run(Y, pj, W):
        out = {}
        for masked, m in ((True, W), (False, None)):
            sj = jif.obs_stats(Y, pj.Lam, pj.R, mask=m)
            kf = j_filter(Y, pj, mask=m, scan_impl="associative")
            out[masked] = (j_stats(sj, pj, "associative"), kf,
                           j_smoother(kf, pj, scan_impl="associative"))
        return out

    out = jax.jit(run)(jnp.asarray(Y), JP.from_numpy(p, jnp.float64),
                       jnp.asarray(W))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("engine,T,k,masked", CASES)
def test_public_functions_match_jax(engine, T, k, masked):
    """``*_from_stats``, ``*_filter`` and ``*_smoother`` with
    ``scan_impl="associative"`` give the JAX twins' answers."""
    t_stats, t_filter, t_smoother = ENGINES[engine][:3]
    p, Y, W = _setup(T, k)
    pt = TP.from_numpy(p)
    mt = torch.as_tensor(W) if masked else None
    st = tif.obs_stats(torch.as_tensor(Y), pt.Lam, pt.R, mask=mt)
    sj, kj, smj = _jax(engine, T, k)[masked]
    for got, want in zip(t_stats(st, pt, "associative"), sj):
        close(got, want, MOMENT_RTOL)
    kt = t_filter(torch.as_tensor(Y), pt, mask=mt, scan_impl="associative")
    for got, want in zip(kt[:4], kj[:4]):
        close(got, want, MOMENT_RTOL)
    assert abs(float(kt.loglik) - float(kj.loglik)) <= LL_RTOL * abs(
        float(kj.loglik))
    smt = t_smoother(kt, pt, scan_impl="associative")
    for got, want in zip(smt, smj):
        close(got, want, MOMENT_RTOL)


@pytest.mark.parametrize("engine,k", [("pit", 3), ("pit", 12),
                                      ("pit_qr", 3)])
def test_associative_matches_blocked(engine, k):
    """The two scans of one engine agree in f64 (they associate the same
    combines differently).  (Past k = 10 the square-root engine's tria is
    the Gram matrix's jittered Cholesky, whose error depends on the order:
    ROADMAP Queue 3 "Watch"; the card's sweep compares the two kernels
    there.)"""
    _, t_filter, t_smoother = ENGINES[engine][:3]
    p, Y, W = _setup(40, k)
    pt = TP.from_numpy(p)
    out = {}
    for impl in ("blocked", "associative"):
        kf = t_filter(torch.as_tensor(Y), pt, mask=torch.as_tensor(W),
                      scan_impl=impl)
        out[impl] = (kf, t_smoother(kf, pt, scan_impl=impl))
    (kb, sb), (ka, sa) = out["blocked"], out["associative"]
    for got, want in zip((*ka[:4], *sa), (*kb[:4], *sb)):
        close(got, want, IMPL_RTOL)
    assert abs(float(ka.loglik) - float(kb.loglik)) <= IMPL_RTOL * abs(
        float(kb.loglik))


def test_scan_impl_is_checked():
    p, Y, _ = _setup(7, 3)
    with pytest.raises(ValueError, match="scan_impl"):
        tpf.pit_filter(torch.as_tensor(Y), TP.from_numpy(p),
                       scan_impl="sequential")


def test_routes_at_the_tier_ends():
    """K14-assoc: its warp kernel to 32, the generic one to 128; K8-assoc:
    its one-thread kernel to 10, the generic one to 128."""
    assert kernels.route("pit_assoc", kernels.KMAX) == "pit_assoc"
    assert kernels.route("pit_assoc", kernels.WIDE_KMAX) == "pit_assoc"
    assert kernels.route("pit_assoc", kernels.WIDE_KMAX + 1) == \
        "pit_assoc_gen"
    assert kernels.route("pit_assoc", kernels.GEN_KMAX) == "pit_assoc_gen"
    assert tla.check_qr_k("qr_assoc", tla.QR_UNROLL_K_MAX) == "qr_assoc"
    assert tla.check_qr_k("qr_assoc", tla.QR_UNROLL_K_MAX + 1) == \
        "qr_assoc_gen"
    assert tla.check_qr_k("qr_assoc", kernels.GEN_KMAX) == "qr_assoc_gen"
    for name in ("pit_assoc", "pit_assoc_gen", "qr_assoc", "qr_assoc_gen"):
        assert kernels.KERNELS[name][0] == "pit_assoc.cu"


def _meta_elems(T, k, smoother):
    shapes = ((T, k, k), (T, k), (T, k, k), (T, k), (T, k, k))
    return tuple(torch.empty(s, device="meta", dtype=torch.float32)
                 for s in shapes[:3 if smoother else 5])


@pytest.mark.parametrize("smoother", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("scan", [tpf.pit_scan, tpf.qr_scan],
                         ids=["K14-assoc", "K8-assoc"])
def test_past_128_raises_before_any_launch(scan, smoother):
    """A "meta" tensor takes the kernel route without a card: at k = 129
    the associative scans raise naming the ROADMAP row, and nothing is
    launched."""
    before = dict(kernels.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2") as e:
        scan(_meta_elems(5, kernels.GEN_KMAX + 1, smoother), smoother,
             scan_impl="associative")
    assert kernels.GENERIC_K in str(e.value)
    assert kernels.LAUNCHES == before
