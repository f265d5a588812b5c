"""Parallel-in-time filters and smoothers (twins of
``dfm_tpu.ssm.parallel_filter``): the covariance-form engine ``pit`` and
the square-root engine ``pit_qr``.

Filtering is associative (Sarkka & Garcia-Fernandez): each step is an
element of a semigroup whose inclusive prefix product carries the
filtered moments, and the RTS smoother is the reverse prefix of affine
elements.  Two scans take the combines, as in the JAX package
(``scan_impl``): "blocked" (``ops.scan.blocked_scan``, ~2 sqrt(T)
combines in sequence, batched over blocks) and "associative"
(``ops.scan.associative_scan``, the log-depth tree of
``lax.associative_scan``: ~2T combines in 2 floor(log2 T) levels).  On
CUDA tensors the associative scans are the kernels K14-assoc
(``pit_assoc``, ``pit_assoc_gen``) and K8-assoc (``qr_assoc``,
``qr_assoc_gen``) of ``csrc/pit_assoc.cu``, a launch a level, on the
blocked kernels' combine bodies at each tier.

``pit``: elements (A, b, C, eta, J) built from the information-form
statistics by push-through solves with I + Q C_t and I + C_t Q (the t = 0
element from (mu0, P0)); the combine carries general solves with
D = (1 + jitter) I + C_i J_j and E = (1 + jitter) I + J_j C_i; after the
prefix (b_t, C_t) are the filtered moments, and the predicted moments and
log|I + Lp' C_t Lp| follow one step off them.  The smoother's elements
are (E, g, L), E_t the RTS gain.  Kernels on CUDA tensors (K14):
``pit_elements`` (``csrc/pit_elements.cu``: the filter elements, the
filter assembly, the smoother elements and P_lag, one warp a step) and
``pit_scan`` (``csrc/pit_scan.cu``: the blocked prefix and suffix, one
warp a combine, a launch a phase) at k <= 32, and their generic kernels
``pit_elements_gen`` and ``pit_scan_gen`` (the same sources: a CTA a step
or a combine on the block-wide routines, persistent grids) at 32 < k <=
128 (``kernels.route``; past 128 a CUDA call raises).

``pit_qr``: the elements carry square-root factors, C = U U', and every
combine is a thin QR (``tria``) of stacked factors plus triangular solves
against Cholesky factors of I + (PSD), so no jitter is needed.  The
smoother is the reverse prefix of affine elements (E, g, D) with L = D D'.
Kernels on CUDA tensors: ``qr_elements`` (``csrc/qr_elements.cu``: the
element builds and the post-scan assemblies, one thread per step, on the
K6/K7 device functions of ``csrc/small_linalg.cuh``) and ``qr_scan``
(``csrc/qr_scan.cu``: K8, the blocked prefix and suffix with the QR
combines) at k <= 10 (``QR_UNROLL_K_MAX``), and their generic kernels
``qr_elements_gen`` and ``qr_scan_gen`` (in ``csrc/pit_elements.cu`` and
``csrc/pit_scan.cu``, beside the pit engine's generic kernels: the JAX
package's generic branches past 10, a CTA a step or a combine on the
block-wide routines, persistent grids) at 10 < k <= 128
(``ops.linalg.check_qr_k``; past 128 a CUDA call raises).  Past 10 the
reference forms tria from the Gram matrix with a jitter (1e-6 in f32),
so in f32 its loglik is far from the f64 one at large N, as the JAX
package's is; f64 is the engine's dtype there.

The plain twin beside each launcher runs for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..ops.linalg import (chol_logdet, chol_solve, check_qr_k,
                          default_jitter, gen_work, matmul_vpu, matvec_vpu,
                          psd_cholesky, psd_factor, qr_chol, qr_chol_solve,
                          sym, tri_solve, tria)
from ..ops.scan import associative_scan, blocked_scan, default_block_size
from .info_filter import (ObsStats, loglik_from_terms, loglik_terms_local,
                          obs_stats, quad_local, u_from_stats)
from .params import FilterResult, SmootherResult, SSMParams

__all__ = ["pit_filter_elements", "pit_filter_elements_plain",
           "pit_scan", "pit_scan_plain", "pit_filter_assemble",
           "pit_filter_assemble_plain", "pit_from_stats", "pit_filter",
           "pit_smoother_elements", "pit_smoother_elements_plain",
           "pit_smoother_assemble", "pit_smoother_assemble_plain",
           "pit_smoother", "pit_filter_smoother",
           "qr_generic_elements", "qr_init_posterior", "qr_filter_elements",
           "qr_filter_elements_plain", "qr_combine_filter",
           "qr_combine_smoother", "qr_scan", "qr_scan_plain",
           "pit_qr_from_stats", "qr_filter_assemble",
           "qr_filter_assemble_plain", "pit_qr_filter", "qr_smoother_elements",
           "qr_smoother_elements_plain", "qr_smoother_assemble",
           "qr_smoother_assemble_plain", "pit_qr_smoother",
           "pit_qr_filter_smoother"]


def _gram(U):
    """U U' in the broadcast-product form."""
    return matmul_vpu(U, U.transpose(-1, -2))


def _bcast(M, T):
    return M.expand((T,) + M.shape)


def _mv(M, v):
    """Batched matrix-vector product (..., i, j) x (..., j)."""
    return torch.einsum("...kl,...l->...k", M, v)


# The plain scans by ``scan_impl``.
_SCANS = {"blocked": blocked_scan, "associative": associative_scan}


def _check_scan_impl(scan_impl: str) -> None:
    """Raise on an unknown ``scan_impl``: checked by ``pit_scan`` and
    ``qr_scan`` alone, which every public function goes through."""
    if scan_impl not in _SCANS:
        raise ValueError(f"unknown scan_impl {scan_impl!r}")


def _plain_scan(combine, elems, reverse: bool, scan_impl: str) -> tuple:
    """``combine``'s inclusive prefix (suffix if ``reverse``) by the scan
    ``scan_impl`` names."""
    return _SCANS[scan_impl](combine, elems, reverse=reverse)


def _assoc_levels(T: int) -> list:
    """Elements of each level above 0 of the associative scan's tree (n_0
    = T, n_{l+1} = n_l // 2 while n_l >= 2): the workspace the K14-assoc
    and K8-assoc kernels take, levels back to back (csrc/pit_assoc.cu
    ``run_tree``)."""
    sizes = []
    n = T
    while n >= 2:
        n //= 2
        sizes.append(n)
    return sizes


def _assoc_launch(kernel: str, elems: tuple, smoother: bool) -> tuple:
    """The associative scan kernel ``kernel`` (K14-assoc or K8-assoc at
    its tier) over contiguous copies of ``elems``, scanned in place; the
    level workspace (and a generic kernel's per-CTA workspace) allocated
    for the call.  A sequence of one element is its own scan: nothing is
    launched."""
    T, k = elems[1].shape
    dt, dev = elems[0].dtype, elems[0].device
    out = tuple(x.clone(memory_format=torch.contiguous_format)
                for x in elems)
    shapes = ((T, k, k), (T, k), (T, k, k), (T, k), (T, k, k))
    _check(dt, dev, *((f"elems[{i}]", x, s)
                      for i, (x, s) in enumerate(zip(out, shapes))))
    if T < 2:
        return out
    per = (2 * k * k + k) if smoother else (3 * k * k + 2 * k)
    levels = torch.empty(sum(_assoc_levels(T)) * per, dtype=dt, device=dev)
    ptrs = list(out) + [None] * (5 - len(out))
    if not kernel.endswith("_gen"):
        kernels.launch(kernel, dt, int(smoother), *ptrs, levels, T, k)
    else:
        work, ctas = gen_work(kernel, dt, dev, T // 2, k)
        kernels.launch(kernel, dt, int(smoother), *ptrs, levels, work, T, k,
                       ctas)
    return out


def _filter_elements(stats: ObsStats, A, Q, mu0, P0):
    """Covariance-form elements (A, b, C, eta, J) from the info-form
    statistics, by the push-through solves
        A_t = (I + Q C_t)^{-1} F        b_t = Q (I + C_t Q)^{-1} bobs_t
        C_t = (I + Q C_t)^{-1} Q        eta_t = F' (I + C_t Q)^{-1} bobs_t
        J_t = F' (I + C_t Q)^{-1} C_t F
    and at t = 0 the first posterior from (mu0, P0) with A_0 = 0, eta_0 =
    0, J_0 = 0.  The plain twin of ``pit_filter_elements``."""
    T, k = stats.b.shape
    dt, dev = stats.b.dtype, stats.b.device
    I_k = torch.eye(k, dtype=dt, device=dev)
    C_t = stats.C if stats.C.ndim == 3 else _bcast(stats.C, T)
    bobs = stats.b
    M = I_k + torch.einsum("kl,tlm->tkm", Q, C_t)           # I + Q C_t
    A_el = torch.linalg.solve(M, _bcast(A, T))
    C_el = sym(torch.linalg.solve(M, _bcast(Q, T)))
    N_ = I_k + torch.einsum("tkl,lm->tkm", C_t, Q)          # I + C_t Q
    Ninv_b = torch.linalg.solve(N_, bobs[..., None])[..., 0]
    b_el = torch.einsum("kl,tl->tk", Q, Ninv_b)
    eta_el = torch.einsum("lk,tl->tk", A, Ninv_b)
    NinvC = torch.linalg.solve(N_, C_t)
    J_el = sym(torch.einsum("lk,tlm,mn->tkn", A, NinvC, A))
    C0 = C_t[0]
    b0 = mu0 + P0 @ torch.linalg.solve(I_k + C0 @ P0, bobs[0] - C0 @ mu0)
    A_el[0] = 0.0
    b_el[0] = b0
    C_el[0] = sym(torch.linalg.solve(I_k + P0 @ C0, P0))
    eta_el[0] = 0.0
    J_el[0] = 0.0
    return (A_el, b_el, C_el, eta_el, J_el)


pit_filter_elements_plain = _filter_elements


def _pit_launch(kernel: str, mode: int, dt, ins, outs, n: int, k: int,
                c_stride: int = 0):
    """Mode ``mode`` of ``kernel`` (``kernels.route("pit_elements",
    k)``)."""
    ins = list(ins) + [None] * (7 - len(ins))
    outs = list(outs) + [None] * (5 - len(outs))
    if kernel == "pit_elements":
        kernels.launch(kernel, dt, mode, *ins, *outs, n, k, c_stride)
        return
    work, ctas = gen_work(kernel, dt, outs[0].device, n, k)
    kernels.launch(kernel, dt, mode, *ins, *outs, work, n, k, c_stride, ctas)


def pit_filter_elements(stats: ObsStats, A, Q, mu0, P0):
    """The filter elements (A, b, C, eta, J), (T, k, k) / (T, k) each.
    Kernel pit_elements (mode 0) for CUDA tensors."""
    b = stats.b
    if b.device.type == "cpu":
        return _filter_elements(stats, A, Q, mu0, P0)
    T, k = b.shape
    dt, dev = b.dtype, b.device
    kernel = kernels.route("pit_elements", k)
    static_C = stats.C.ndim == 2
    _check(dt, dev, ("b", b, (T, k)),
           ("C", stats.C, (k, k) if static_C else (T, k, k)),
           ("A", A, (k, k)), ("Q", Q, (k, k)), ("mu0", mu0, (k,)),
           ("P0", P0, (k, k)))
    outs = tuple(torch.empty(s, dtype=dt, device=dev)
                 for s in ((T, k, k), (T, k), (T, k, k), (T, k), (T, k, k)))
    _pit_launch(kernel, 0, dt, (b, stats.C, A, Q, mu0, P0), outs, T, k,
                0 if static_C else k * k)
    return outs


def _combine_filter(ei, ej):
    """Associative filtering product (ei earlier, ej later), batched over
    leading axes:
        D = (1 + jitter) I + C_i J_j,   E = (1 + jitter) I + J_j C_i
        A = A_j D^{-1} A_i,   b = A_j D^{-1} (b_i + C_i eta_j) + b_j
        C = sym(A_j D^{-1} C_i A_j' + C_j)
        eta = A_i' E^{-1} (eta_j - J_j b_i) + eta_i
        J = sym(A_i' E^{-1} J_j A_i + J_i)
    with C_i and J_j symmetrized on entry (the JAX package's f32 rules)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    k = Ai.shape[-1]
    Ci, Jj = sym(Ci), sym(Jj)
    jit_eye = (1.0 + default_jitter(Ai.dtype)) * torch.eye(
        k, dtype=Ai.dtype, device=Ai.device)
    D = jit_eye + Ci @ Jj
    AjD = torch.linalg.solve(D.transpose(-1, -2),
                             Aj.transpose(-1, -2)).transpose(-1, -2)
    A = AjD @ Ai
    b = _mv(AjD, bi + _mv(Ci, etaj)) + bj
    C = sym(AjD @ Ci @ Aj.transpose(-1, -2) + Cj)
    E = jit_eye + Jj @ Ci
    AiT = Ai.transpose(-1, -2)
    EinvRHS = torch.linalg.solve(E, (etaj - _mv(Jj, bi))[..., None])
    eta = _mv(AiT, EinvRHS[..., 0]) + etai
    J = sym(AiT @ torch.linalg.solve(E, Jj @ Ai) + Ji)
    return (A, b, C, eta, J)


def _combine_smoother(elater, eearlier):
    """Compose x_t = E x_{t+1} + g + noise(L) elements: the earlier
    element is the outer map, E = E_e E_l, g = E_e g_l + g_e, L =
    sym(E_e L_l E_e' + L_e).  Argument order (later, earlier), as
    ``blocked_scan(..., reverse=True)`` calls it."""
    El, gl, Ll = elater
    Ee, ge, Le = eearlier
    E = Ee @ El
    g = _mv(Ee, gl) + ge
    L = sym(Ee @ Ll @ Ee.transpose(-1, -2) + Le)
    return (E, g, L)


def pit_scan_plain(elems: tuple, smoother: bool = False,
                   scan_impl: str = "blocked") -> tuple:
    """Plain twin of ``pit_scan``: ``blocked_scan`` (or, for
    ``scan_impl="associative"``, ``associative_scan``) with the
    covariance-form combines."""
    if smoother:
        return _plain_scan(_combine_smoother, elems, True, scan_impl)
    return _plain_scan(_combine_filter, elems, False, scan_impl)


def pit_scan(elems: tuple, smoother: bool = False,
             scan_impl: str = "blocked") -> tuple:
    """Inclusive prefix of the filter elements (A, b, C, eta, J), or
    inclusive suffix of the smoother elements (E, g, L).  For CUDA
    tensors: "blocked", kernel pit_scan (one call: four launches, one a
    phase of ``blocked_scan``); "associative", kernel K14-assoc
    (``pit_assoc``, past k = 32 ``pit_assoc_gen``: one call, a launch a
    level of ``associative_scan``'s tree).  The inputs are left as they
    are."""
    _check_scan_impl(scan_impl)
    if elems[0].device.type == "cpu":
        return pit_scan_plain(elems, smoother, scan_impl)
    T, k = elems[1].shape
    if scan_impl == "associative":
        return _assoc_launch(kernels.route("pit_assoc", k), elems, smoother)
    dt, dev = elems[0].dtype, elems[0].device
    kernel = kernels.route("pit_scan", k)
    # Contiguous copies, scanned in place.
    out = tuple(x.clone(memory_format=torch.contiguous_format)
                for x in elems)
    shapes = ((T, k, k), (T, k), (T, k, k), (T, k), (T, k, k))
    _check(dt, dev, *((f"elems[{i}]", x, s)
                      for i, (x, s) in enumerate(zip(out, shapes))))
    S = default_block_size(T)
    per = (2 * k * k + k) if smoother else (3 * k * k + 2 * k)
    scratch = torch.empty((T // S) * per, dtype=dt, device=dev)
    ptrs = list(out) + [None] * (5 - len(out))
    if kernel == "pit_scan":
        kernels.launch(kernel, dt, int(smoother), *ptrs, scratch, T, S, k)
    else:
        work, ctas = gen_work(kernel, dt, dev, T, k)
        kernels.launch(kernel, dt, int(smoother), *ptrs, scratch, work, T, S,
                       k, ctas)
    return out


def pit_filter_assemble_plain(x_f, P_f, C, A, Q, mu0, P0):
    """Plain twin of ``pit_filter_assemble``."""
    T, k = x_f.shape
    x_pred = torch.cat([mu0[None], x_f[:-1] @ A.T], dim=0)
    P_pred = torch.cat(
        [P0[None], sym(torch.einsum("ij,tjl,kl->tik", A, P_f[:-1], A)
                       + Q[None])], dim=0)
    C_t = C if C.ndim == 3 else _bcast(C, T)
    Lp = psd_cholesky(P_pred)
    G = torch.eye(k, dtype=x_f.dtype, device=x_f.device)[None] + \
        torch.einsum("tlk,tlm,tmn->tkn", Lp, C_t, Lp)
    return x_pred, P_pred, chol_logdet(psd_cholesky(G, jitter=0.0))


def pit_filter_assemble(x_f, P_f, C, A, Q, mu0, P0):
    """The moments after the filter scan: (x_pred, P_pred, logdetG), with
    P_pred,t = sym(A P_f,t-1 A' + Q) (P_pred,0 = P0), Lp_t the jittered
    Cholesky factor of P_pred,t and logdetG_t = log|I + Lp_t' C_t Lp_t|
    from an unjittered Cholesky.  Kernel pit_elements (mode 1) for CUDA
    tensors."""
    if x_f.device.type == "cpu":
        return pit_filter_assemble_plain(x_f, P_f, C, A, Q, mu0, P0)
    T, k = x_f.shape
    dt, dev = x_f.dtype, x_f.device
    kernel = kernels.route("pit_elements", k)
    static_C = C.ndim == 2
    _check(dt, dev, ("x_f", x_f, (T, k)), ("P_f", P_f, (T, k, k)),
           ("C", C, (k, k) if static_C else (T, k, k)), ("A", A, (k, k)),
           ("Q", Q, (k, k)), ("mu0", mu0, (k,)), ("P0", P0, (k, k)))
    outs = tuple(torch.empty(s, dtype=dt, device=dev)
                 for s in ((T, k), (T, k, k), (T,)))
    _pit_launch(kernel, 1, dt, (x_f, P_f, C, A, Q, mu0, P0), outs, T,
                k, 0 if static_C else k * k)
    return outs


def pit_from_stats(stats: ObsStats, p: SSMParams, scan_impl: str = "blocked"):
    """Element build + prefix product + moment and logdet assembly from the
    statistics: (x_pred, P_pred, x_filt, P_filt, logdetG).  The innovation
    quadratic is the caller's (it needs the panel).  Shared by
    ``pit_filter`` and the mixed-frequency E-step (``time_scan="pit"``)."""
    elems = pit_filter_elements(stats, p.A, p.Q, p.mu0, p.P0)
    pref = pit_scan(elems, scan_impl=scan_impl)
    x_f, P_f = pref[1], pref[2]
    x_pred, P_pred, logdetG = pit_filter_assemble(
        x_f, P_f, stats.C, p.A, p.Q, p.mu0, p.P0)
    return x_pred, P_pred, x_f, P_f, logdetG


def pit_filter(Y: torch.Tensor, p: SSMParams,
               mask: Optional[torch.Tensor] = None,
               scan_impl: str = "blocked") -> FilterResult:
    """Covariance-form parallel-in-time filter: the contract of
    ``info_filter`` (exact loglik, predicted and filtered moments).
    ``scan_impl``: "blocked" (~2 sqrt(T) combines in sequence) or
    "associative" (the log-depth tree, ~2T combines)."""
    p = p.to(dtype=Y.dtype)
    stats = obs_stats(Y, p.Lam, p.R, mask=mask)
    x_pred, P_pred, x_f, P_f, logdetG = pit_from_stats(stats, p, scan_impl)
    quad_R, U = loglik_terms_local(Y, p.Lam, p.R, x_pred, mask)
    ll = loglik_from_terms(stats, logdetG, P_f, quad_R, U)
    return FilterResult(x_pred, P_pred, x_f, P_f, ll)


def _smoother_elements(kf: FilterResult, A):
    """Affine smoothing elements (E, g, L) and the gains J (T-1, k, k):
    J_t = P_f,t A' P_pred,t+1^{-1} (jittered Cholesky), E_t = J_t, g_t =
    x_f,t - J_t x_pred,t+1, L_t = sym(P_f,t - J_t P_pred,t+1 J_t'); the
    last element anchors at T-1 (E = 0, g = x_f, L = P_f).  The plain
    twin of ``pit_smoother_elements``."""
    T, k = kf.x_filt.shape
    Pp_next = kf.P_pred[1:]
    L = psd_cholesky(Pp_next)
    APf = torch.einsum("ij,tjk->tik", A, kf.P_filt[:-1])
    J = chol_solve(L, APf).transpose(-1, -2)
    E = torch.cat([J, torch.zeros((1, k, k), dtype=J.dtype,
                                  device=J.device)], dim=0)
    g_head = kf.x_filt[:-1] - torch.einsum("tkl,tl->tk", J, kf.x_pred[1:])
    g = torch.cat([g_head, kf.x_filt[-1:]], dim=0)
    L_head = sym(kf.P_filt[:-1]
                 - torch.einsum("tkl,tlm,tnm->tkn", J, Pp_next, J))
    L_el = torch.cat([L_head, kf.P_filt[-1:]], dim=0)
    return (E, g, L_el), J


pit_smoother_elements_plain = _smoother_elements


def pit_smoother_elements(kf: FilterResult, A):
    """The smoothing elements (E, g, L) and the gains J = E[:-1].  Kernel
    pit_elements (mode 2) for CUDA tensors."""
    x_filt = kf.x_filt
    if x_filt.device.type == "cpu":
        return _smoother_elements(kf, A)
    T, k = x_filt.shape
    dt, dev = x_filt.dtype, x_filt.device
    kernel = kernels.route("pit_elements", k)
    _check(dt, dev, ("x_pred", kf.x_pred, (T, k)),
           ("P_pred", kf.P_pred, (T, k, k)), ("x_filt", x_filt, (T, k)),
           ("P_filt", kf.P_filt, (T, k, k)), ("A", A, (k, k)))
    E, g, L = (torch.empty(s, dtype=dt, device=dev)
               for s in ((T, k, k), (T, k), (T, k, k)))
    _pit_launch(kernel, 2, dt,
                (kf.x_pred, kf.P_pred, x_filt, kf.P_filt, A), (E, g, L), T, k)
    return (E, g, L), E[:T - 1]


def pit_smoother_assemble_plain(P_sm, J):
    """Plain twin of ``pit_smoother_assemble``."""
    return torch.cat([torch.zeros_like(P_sm[:1]),
                      torch.einsum("tij,tkj->tik", P_sm[1:], J)], dim=0)


def pit_smoother_assemble(P_sm, J):
    """P_lag with P_lag,t = P_sm,t J_{t-1}' and P_lag,0 = 0.  Kernel
    pit_elements (mode 3) for CUDA tensors."""
    if P_sm.device.type == "cpu":
        return pit_smoother_assemble_plain(P_sm, J)
    T, k = P_sm.shape[0], P_sm.shape[1]
    dt, dev = P_sm.dtype, P_sm.device
    kernel = kernels.route("pit_elements", k)
    _check(dt, dev, ("P_sm", P_sm, (T, k, k)), ("J", J, (T - 1, k, k)))
    P_lag = torch.empty((T, k, k), dtype=dt, device=dev)
    _pit_launch(kernel, 3, dt, (P_sm, J), (P_lag,), T, k)
    return P_lag


def pit_smoother(kf: FilterResult, p: SSMParams,
                 scan_impl: str = "blocked") -> SmootherResult:
    """Covariance-form parallel-in-time RTS smoother: the contract of
    ``rts_smoother``.  ``scan_impl``: as ``pit_filter``."""
    p = p.to(dtype=kf.x_filt.dtype)
    elems, J = pit_smoother_elements(kf, p.A)
    suf = pit_scan(elems, smoother=True, scan_impl=scan_impl)
    return SmootherResult(suf[1], suf[2], pit_smoother_assemble(suf[2], J))


def pit_filter_smoother(Y, p, mask=None):
    kf = pit_filter(Y, p, mask=mask)
    return kf, pit_smoother(kf, p)


def qr_generic_elements(stats: ObsStats, A, Q):
    """Square-root elements (A, b, U, eta, Z) of every step, without the
    t = 0 prior correction.  With Lq Lq' = Q, W_t W_t' = C_t (guarded
    factors: C_t is rank-deficient when a step observes fewer than k
    series) and H_t = chol(I + W_t' Q W_t):
        U_t = Lq E_t^{-T}, E_t = chol(I + Lq' C_t Lq);  Z_t = F' W_t H_t^{-T}
        A_t = F - Q W_t (H_t H_t')^{-1} W_t' F
        b_t = Q n_t,  eta_t = F' n_t,  n_t = (I + C_t Q)^{-1} bobs_t
    """
    T, k = stats.b.shape
    C_t = stats.C if stats.C.ndim == 3 else _bcast(stats.C, T)
    bobs = stats.b
    I_k = torch.eye(k, dtype=bobs.dtype, device=bobs.device)
    Lq = psd_factor(Q)
    F_b = _bcast(A, T)
    LqT_C = matmul_vpu(_bcast(Lq.T, T), C_t)
    E = qr_chol(I_k + matmul_vpu(LqT_C, _bcast(Lq, T)))
    U_el = tri_solve(E, _bcast(Lq.T, T)).transpose(-1, -2)
    W = psd_factor(C_t)
    WT = W.transpose(-1, -2)
    QW = matmul_vpu(_bcast(Q, T), W)
    H = qr_chol(I_k + matmul_vpu(WT, QW))
    Qb = matvec_vpu(_bcast(Q, T), bobs)
    n_t = bobs - matvec_vpu(W, qr_chol_solve(H, matvec_vpu(WT, Qb)))
    b_el = matvec_vpu(_bcast(Q, T), n_t)
    eta_el = matvec_vpu(_bcast(A.T, T), n_t)
    FTW = matmul_vpu(_bcast(A.T, T), W)
    Z_el = tri_solve(H, FTW.transpose(-1, -2)).transpose(-1, -2)
    A_el = F_b - matmul_vpu(QW, qr_chol_solve(H, matmul_vpu(WT, F_b)))
    return (A_el, b_el, U_el, eta_el, Z_el)


def qr_init_posterior(C0, bobs0, mu0, P0):
    """(b0, U0): the first filtered posterior from the prior (mu0, P0)."""
    k = mu0.shape[0]
    I_k = torch.eye(k, dtype=mu0.dtype, device=mu0.device)
    Lp0 = psd_factor(P0)
    E0 = qr_chol(I_k + Lp0.T @ C0 @ Lp0)
    U0 = tri_solve(E0, Lp0.T).transpose(-1, -2)
    W0 = psd_factor(C0)
    Hp = qr_chol(I_k + W0.T @ P0 @ W0)
    v0 = bobs0 - C0 @ mu0
    n0 = v0 - W0 @ qr_chol_solve(Hp, W0.T @ (P0 @ v0))
    return mu0 + P0 @ n0, U0


def qr_filter_elements_plain(stats: ObsStats, A, Q, mu0, P0):
    """Plain twin of ``qr_filter_elements``."""
    A_el, b_el, U_el, eta_el, Z_el = (x.clone() for x in
                                      qr_generic_elements(stats, A, Q))
    C0 = stats.C if stats.C.ndim == 2 else stats.C[0]
    b0, U0 = qr_init_posterior(C0, stats.b[0], mu0, P0)
    A_el[0] = 0.0
    b_el[0] = b0
    U_el[0] = U0
    eta_el[0] = 0.0
    Z_el[0] = 0.0
    return (A_el, b_el, U_el, eta_el, Z_el)


def _qr_launch(mode: int, dt, ins, outs, n: int, k: int, c_stride: int = 0):
    """Mode ``mode`` of the kernel ``check_qr_k("qr_elements", k)`` routes
    to (raises past its range before any launch)."""
    kernel = check_qr_k("qr_elements", k)
    ins = list(ins) + [None] * (7 - len(ins))
    outs = list(outs) + [None] * (5 - len(outs))
    if kernel == "qr_elements":
        kernels.launch(kernel, dt, mode, 0, *ins, *outs, n, k, c_stride)
        return
    work, ctas = gen_work(kernel, dt, outs[0].device, n, k)
    kernels.launch(kernel, dt, mode, 0, *ins, *outs, work, n, k, c_stride,
                   ctas)


def _check(dt, dev, *named):
    for name, x, shape in named:
        kernels.check_tensor(name, x, shape, dt, dev)


def qr_filter_elements(stats: ObsStats, A, Q, mu0, P0):
    """The filter elements with the t = 0 prior correction (A_0 = 0, b_0
    and U_0 the first posterior, eta_0 = 0, Z_0 = 0).  Kernel qr_elements
    (mode 0) for CUDA tensors."""
    b = stats.b
    if b.device.type == "cpu":
        return qr_filter_elements_plain(stats, A, Q, mu0, P0)
    T, k = b.shape
    dt, dev = b.dtype, b.device
    check_qr_k("qr_elements", k)          # before any allocation
    static_C = stats.C.ndim == 2
    _check(dt, dev, ("b", b, (T, k)),
           ("C", stats.C, (k, k) if static_C else (T, k, k)),
           ("A", A, (k, k)), ("Q", Q, (k, k)), ("mu0", mu0, (k,)),
           ("P0", P0, (k, k)))
    outs = tuple(torch.empty(s, dtype=dt, device=dev)
                 for s in ((T, k, k), (T, k), (T, k, k), (T, k), (T, k, k)))
    _qr_launch(0, dt, (b, stats.C, A, Q, mu0, P0), outs, T, k,
               0 if static_C else k * k)
    return outs


def qr_combine_filter(ei, ej):
    """Square-root filtering product (ei earlier, ej later), batched over
    leading axes."""
    Ai, bi, Ui, etai, Zi = ei
    Aj, bj, Uj, etaj, Zj = ej
    k = Ai.shape[-1]
    I_b = torch.eye(k, dtype=Ai.dtype, device=Ai.device).expand(Ai.shape)
    UiT = Ui.transpose(-1, -2)
    ZjT = Zj.transpose(-1, -2)
    Yf = matmul_vpu(UiT, Zj)                          # U_i' Z_j
    YfT = Yf.transpose(-1, -2)
    Theta = tria(torch.cat([Yf, I_b], dim=-1))
    Lam = tria(torch.cat([YfT, I_b], dim=-1))

    def Dinv(M):                                      # (I + C_i J_j)^{-1} M
        return M - matmul_vpu(Ui, qr_chol_solve(
            Theta, matmul_vpu(Yf, matmul_vpu(ZjT, M))))

    def Dinv_v(v):
        return v - matvec_vpu(Ui, qr_chol_solve(
            Theta, matvec_vpu(Yf, matvec_vpu(ZjT, v))))

    def Einv_v(v):                                    # (I + J_j C_i)^{-1} v
        return v - matvec_vpu(Zj, qr_chol_solve(
            Lam, matvec_vpu(YfT, matvec_vpu(UiT, v))))

    A = matmul_vpu(Aj, Dinv(Ai))
    b = matvec_vpu(Aj, Dinv_v(bi + matvec_vpu(Ui, matvec_vpu(UiT, etaj)))) \
        + bj
    U_half = tri_solve(Theta, matmul_vpu(Aj, Ui).transpose(-1, -2)) \
        .transpose(-1, -2)
    U = tria(torch.cat([U_half, Uj], dim=-1))
    AiT = Ai.transpose(-1, -2)
    eta = matvec_vpu(AiT, Einv_v(etaj - matvec_vpu(Zj, matvec_vpu(ZjT, bi)))) \
        + etai
    Z_half = tri_solve(Lam, matmul_vpu(AiT, Zj).transpose(-1, -2)) \
        .transpose(-1, -2)
    Z = tria(torch.cat([Z_half, Zi], dim=-1))
    return (A, b, U, eta, Z)


def qr_combine_smoother(elater, eearlier):
    """Square-root smoothing product: E = E_e E_l, g = E_e g_l + g_e,
    D = tria([E_e D_l | D_e])."""
    El, gl, Dl = elater
    Ee, ge, De = eearlier
    E = matmul_vpu(Ee, El)
    g = matvec_vpu(Ee, gl) + ge
    D = tria(torch.cat([matmul_vpu(Ee, Dl), De], dim=-1))
    return (E, g, D)


def qr_scan_plain(elems: tuple, smoother: bool = False,
                  scan_impl: str = "blocked") -> tuple:
    """Plain twin of ``qr_scan``: ``blocked_scan`` (or, for
    ``scan_impl="associative"``, ``associative_scan``) with the QR
    combines."""
    if smoother:
        return _plain_scan(qr_combine_smoother, elems, True, scan_impl)
    return _plain_scan(qr_combine_filter, elems, False, scan_impl)


def qr_scan(elems: tuple, smoother: bool = False,
            scan_impl: str = "blocked") -> tuple:
    """Inclusive prefix of the filter elements (A, b, U, eta, Z), or
    inclusive suffix of the smoother elements (E, g, D).  For CUDA
    tensors: "blocked", kernel K8 (``qr_scan``, past k = 10
    ``qr_scan_gen``: one call, four launches counted as one);
    "associative", kernel K8-assoc (``qr_assoc``, past k = 10
    ``qr_assoc_gen``: one call, a launch a level).  The inputs are left as
    they are."""
    _check_scan_impl(scan_impl)
    if elems[0].device.type == "cpu":
        return qr_scan_plain(elems, smoother, scan_impl)
    T, k = elems[1].shape
    if scan_impl == "associative":
        return _assoc_launch(check_qr_k("qr_assoc", k), elems, smoother)
    dt, dev = elems[0].dtype, elems[0].device
    kernel = check_qr_k("qr_scan", k)
    # Contiguous copies, scanned in place.
    out = tuple(x.clone(memory_format=torch.contiguous_format)
                for x in elems)
    shapes = ((T, k, k), (T, k), (T, k, k), (T, k), (T, k, k))
    _check(dt, dev, *((f"elems[{i}]", x, s)
                      for i, (x, s) in enumerate(zip(out, shapes))))
    S = default_block_size(T)
    scratch = torch.empty((T // S) * (3 * k * k + 2 * k), dtype=dt,
                          device=dev)
    ptrs = list(out) + [None] * (5 - len(out))
    if kernel == "qr_scan":
        kernels.launch(kernel, dt, int(smoother), *ptrs, scratch, T, S, k)
    else:
        work, ctas = gen_work(kernel, dt, dev, T, k)
        kernels.launch(kernel, dt, int(smoother), *ptrs, scratch, work, T, S,
                       k, ctas)
    return out


def qr_filter_assemble_plain(x_f, U_f, C, A, Q, mu0, P0):
    """Plain twin of ``qr_filter_assemble``."""
    T, k = x_f.shape
    P_f = _gram(U_f)
    Lq = psd_factor(Q)
    AU = matmul_vpu(_bcast(A, T - 1), U_f[:-1])
    Lp_tail = tria(torch.cat([AU, _bcast(Lq, T - 1)], dim=-1))
    Lp = torch.cat([psd_factor(P0)[None], Lp_tail], dim=0)
    P_pred = _gram(Lp)
    x_pred = torch.cat([mu0[None], x_f[:-1] @ A.T], dim=0)
    C_t = C if C.ndim == 3 else _bcast(C, T)
    I_k = torch.eye(k, dtype=x_f.dtype, device=x_f.device)
    G = I_k + matmul_vpu(matmul_vpu(Lp.transpose(-1, -2), C_t), Lp)
    return x_pred, P_pred, P_f, chol_logdet(qr_chol(G))


def qr_filter_assemble(x_f, U_f, C, A, Q, mu0, P0):
    """The moments after the filter scan: (x_pred, P_pred, P_f, logdetG),
    with the predicted factors Lp_t = tria([A U_f,t-1 | Lq]) (Lp_0 the
    prior's) and logdetG_t = log|I + Lp_t' C_t Lp_t|.  Kernel qr_elements
    (mode 2) for CUDA tensors."""
    if x_f.device.type == "cpu":
        return qr_filter_assemble_plain(x_f, U_f, C, A, Q, mu0, P0)
    T, k = x_f.shape
    dt, dev = x_f.dtype, x_f.device
    check_qr_k("qr_elements", k)
    static_C = C.ndim == 2
    _check(dt, dev, ("x_f", x_f, (T, k)), ("U_f", U_f, (T, k, k)),
           ("C", C, (k, k) if static_C else (T, k, k)), ("A", A, (k, k)),
           ("Q", Q, (k, k)), ("mu0", mu0, (k,)), ("P0", P0, (k, k)))
    outs = tuple(torch.empty(s, dtype=dt, device=dev)
                 for s in ((T, k), (T, k, k), (T, k, k), (T,)))
    _qr_launch(2, dt, (x_f, U_f, C, A, Q, mu0, P0), outs, T, k,
               0 if static_C else k * k)
    return outs


def pit_qr_from_stats(stats: ObsStats, p: SSMParams,
                      scan_impl: str = "blocked"):
    """Element build + prefix scan + moment assembly: (x_pred, P_pred,
    x_f, P_f, logdetG).  ``scan_impl``: "blocked" or "associative", as
    ``pit_filter``."""
    elems = qr_filter_elements(stats, p.A, p.Q, p.mu0, p.P0)
    pref = qr_scan(elems, scan_impl=scan_impl)
    x_f, U_f = pref[1], pref[2]
    x_pred, P_pred, P_f, logdetG = qr_filter_assemble(
        x_f, U_f, stats.C, p.A, p.Q, p.mu0, p.P0)
    return x_pred, P_pred, x_f, P_f, logdetG


def pit_qr_filter(Y: torch.Tensor, p: SSMParams,
                  mask: Optional[torch.Tensor] = None,
                  scan_impl: str = "blocked") -> FilterResult:
    """Square-root parallel-in-time filter: the contract of
    ``info_filter`` (exact loglik, predicted and filtered moments).
    ``scan_impl``: as ``pit_qr_from_stats``."""
    p = p.to(dtype=Y.dtype)
    stats = obs_stats(Y, p.Lam, p.R, mask=mask)
    x_pred, P_pred, x_f, P_f, logdetG = pit_qr_from_stats(stats, p,
                                                          scan_impl)
    quad_R = quad_local(Y, p.Lam, p.R, x_pred, mask)
    ll = loglik_from_terms(stats, logdetG, P_f, quad_R,
                           u_from_stats(stats, x_pred))
    return FilterResult(x_pred, P_pred, x_f, P_f, ll)


def qr_smoother_elements_plain(kf: FilterResult, A, Q):
    """Plain twin of ``qr_smoother_elements``."""
    T, k = kf.x_filt.shape
    U_f = psd_factor(kf.P_filt)
    Lq = psd_factor(Q)
    Lp_next = psd_factor(kf.P_pred[1:])
    APf = matmul_vpu(_bcast(A, T - 1), kf.P_filt[:-1])
    J = qr_chol_solve(Lp_next, APf).transpose(-1, -2)         # (T-1, k, k)
    E = torch.cat([J, torch.zeros_like(J[:1])], dim=0)
    g_head = kf.x_filt[:-1] - torch.einsum("tkl,tl->tk", J, kf.x_pred[1:])
    g = torch.cat([g_head, kf.x_filt[-1:]], dim=0)
    I_k = torch.eye(k, dtype=A.dtype, device=A.device)
    ImJA = I_k - matmul_vpu(J, _bcast(A, T - 1))
    D_head = tria(torch.cat([matmul_vpu(ImJA, U_f[:-1]),
                             matmul_vpu(J, _bcast(Lq, T - 1))], dim=-1))
    D = torch.cat([D_head, U_f[-1:]], dim=0)
    return (E, g, D), J


def qr_smoother_elements(kf: FilterResult, A, Q):
    """Square-root smoothing elements (E, g, D) and the gains J (T-1, k, k),
    with the Joseph-form residual factor D_t = tria([(I - J A) U_f | J Lq]).
    Kernel qr_elements (mode 1) for CUDA tensors."""
    x_filt = kf.x_filt
    if x_filt.device.type == "cpu":
        return qr_smoother_elements_plain(kf, A, Q)
    T, k = x_filt.shape
    dt, dev = x_filt.dtype, x_filt.device
    check_qr_k("qr_elements", k)
    _check(dt, dev, ("x_pred", kf.x_pred, (T, k)),
           ("P_pred", kf.P_pred, (T, k, k)), ("x_filt", x_filt, (T, k)),
           ("P_filt", kf.P_filt, (T, k, k)), ("A", A, (k, k)),
           ("Q", Q, (k, k)))
    E, g, D = (torch.empty(s, dtype=dt, device=dev)
               for s in ((T, k, k), (T, k), (T, k, k)))
    J = torch.empty((max(T - 1, 0), k, k), dtype=dt, device=dev)
    _qr_launch(1, dt, (kf.x_pred, kf.P_pred, x_filt, kf.P_filt, A, Q),
               (E, g, D, J), T, k)
    return (E, g, D), J


def qr_smoother_assemble_plain(D_sm, J):
    """Plain twin of ``qr_smoother_assemble``."""
    P_sm = _gram(D_sm)
    P_lag = torch.cat([torch.zeros_like(P_sm[:1]),
                       torch.einsum("tij,tkj->tik", P_sm[1:], J)], dim=0)
    return P_sm, P_lag


def qr_smoother_assemble(D_sm, J):
    """(P_sm = D D', P_lag with P_lag,t = P_sm,t J_{t-1}' and P_lag,0 = 0).
    Kernel qr_elements (mode 3) for CUDA tensors."""
    if D_sm.device.type == "cpu":
        return qr_smoother_assemble_plain(D_sm, J)
    T, k = D_sm.shape[0], D_sm.shape[1]
    dt, dev = D_sm.dtype, D_sm.device
    check_qr_k("qr_elements", k)
    _check(dt, dev, ("D_sm", D_sm, (T, k, k)), ("J", J, (T - 1, k, k)))
    P_sm, P_lag = (torch.empty((T, k, k), dtype=dt, device=dev)
                   for _ in range(2))
    _qr_launch(3, dt, (D_sm, J), (P_sm, P_lag), T, k)
    return P_sm, P_lag


def pit_qr_smoother(kf: FilterResult, p: SSMParams,
                    scan_impl: str = "blocked") -> SmootherResult:
    """Square-root parallel-in-time RTS smoother: the contract of
    ``rts_smoother``.  ``scan_impl``: as ``pit_qr_from_stats``."""
    p = p.to(dtype=kf.x_filt.dtype)
    elems, J = qr_smoother_elements(kf, p.A, p.Q)
    suf = qr_scan(elems, smoother=True, scan_impl=scan_impl)
    P_sm, P_lag = qr_smoother_assemble(suf[2], J)
    return SmootherResult(suf[1], P_sm, P_lag)


def pit_qr_filter_smoother(Y, p, mask=None):
    kf = pit_qr_filter(Y, p, mask=mask)
    return kf, pit_qr_smoother(kf, p)
