"""Prefix scans of the steady-state and square-root engines (twins of
``dfm_tpu.ops.scan``).

``affine_scan`` is kernel K5b (``csrc/affine_scan.cu``; K5b-wide for
16 < k <= 32, K5b-gen for 32 < k <= 128): the whole mean recursion x_t = M_t x_{t-1} + d_t of the
steady-state engine, an exact coefficient head and a constant tail,
forward or in reverse.  Its plain
twin runs the head in sequence and the tail with ``affine_const_prefix``
(the JAX package's shift-doubling), as ``dfm_tpu.ssm.steady`` does.

``blocked_scan`` is the plain twin of the scan kernels K8
(``csrc/qr_scan.cu``) and K14-scan (``csrc/pit_scan.cu``): the
work-efficient blocked prefix over an associative ``combine``, with the
JAX package's default of S = floor(sqrt(T)) elements a block
(``default_block_size``, which the kernels take), so that kernel and twin
associate identically.

``associative_scan`` is the plain twin of the log-depth scan kernels
K14-assoc and K8-assoc (``csrc/pit_assoc.cu``): the tree of
``lax.associative_scan`` (jax 0.9.0, ``jax/_src/lax/control_flow/
loops.py:2605``, ``_scan`` at 2705, ``_interleave`` at 2746) on tuples of
tensors, so that kernel and twin associate identically.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .. import kernels

__all__ = ["affine_const_prefix", "affine_scan", "affine_scan_plain",
           "associative_scan", "blocked_scan", "default_block_size"]


def affine_const_prefix(M: torch.Tensor, d: torch.Tensor,
                        x0: torch.Tensor) -> torch.Tensor:
    """All states of x_t = M x_{t-1} + d_t (t = 1..n) for constant M, by
    shift-doubling: log2(n) rounds, each one (n, k) x (k, k) product and a
    shifted add.  Returns the (n, k) stack of x_1..x_n."""
    seq = torch.cat([x0[None], d], dim=0)             # entry 0 = M^0 x0
    P = M
    shift = 1
    while shift < seq.shape[0]:
        pad = torch.zeros((shift,) + seq.shape[1:], dtype=seq.dtype,
                          device=seq.device)
        seq = seq + torch.cat([pad, seq[:-shift]], dim=0) @ P.T
        P = P @ P
        shift *= 2
    return seq[1:]


def affine_scan_plain(d, Mh, M, xb, reverse: bool = False):
    """Plain twin of ``affine_scan``: the head steps (M_t = Mh[t], t < h)
    in sequence, the constant-M steps by ``affine_const_prefix``."""
    T_, h = d.shape[0], Mh.shape[0]
    x = torch.empty_like(d)
    if not reverse:
        x[0] = xb
        xt = xb
        for t in range(1, min(h, T_)):
            xt = Mh[t] @ xt + d[t]
            x[t] = xt
        if h < T_:
            x[max(h, 1):] = affine_const_prefix(M, d[max(h, 1):], xt)
        return x
    x[T_ - 1] = xb
    xt = xb
    lo = min(h, T_ - 1)                     # steps t = T-2 .. lo use M
    if lo <= T_ - 2:
        tail = affine_const_prefix(M, d[lo:T_ - 1].flip(0), xb)
        x[lo:T_ - 1] = tail.flip(0)
        xt = tail[-1]
    for t in range(lo - 1, -1, -1):
        xt = Mh[t] @ xt + d[t]
        x[t] = xt
    return x


def affine_scan(d: torch.Tensor, Mh: torch.Tensor, M: torch.Tensor,
                xb: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The recursion over t in [0, T) with M_t = Mh[t] for t < h and M
    after: forward x_0 = xb, x_t = M_t x_{t-1} + d_t; reverse x_{T-1} =
    xb, x_t = M_t x_{t+1} + d_t.  d (T, k) (its boundary row is not
    read), Mh (h, k, k), M (k, k), xb (k,).  Kernel K5b for CUDA tensors
    (K5b-wide for 16 < k <= 32, K5b-gen for 32 < k <= 128).
    """
    if d.device.type == "cpu":
        return affine_scan_plain(d, Mh, M, xb, reverse)
    T_, k = d.shape
    h = Mh.shape[0]
    dt, dev = d.dtype, d.device
    kernel = kernels.route("affine_scan", k)
    for name, x, shape in (("d", d, (T_, k)), ("Mh", Mh, (h, k, k)),
                           ("M", M, (k, k)), ("xb", xb, (k,))):
        kernels.check_tensor(name, x, shape, dt, dev)
    x = torch.empty((T_, k), dtype=dt, device=dev)
    kernels.launch(kernel, dt, d, Mh, M, xb, x, T_, h, k,
                   int(reverse))
    return x


def default_block_size(T: int) -> int:
    """Elements a block of ``blocked_scan`` when no ``block_size`` is
    given (the JAX package's default, floor(sqrt(T))), which the K8 and
    K14 scan kernels take."""
    return min(max(1, int(math.sqrt(T))), T)


def _take(elems, idx):
    return tuple(x[idx] for x in elems)


def blocked_scan(combine: Callable, elems, block_size: int | None = None,
                 reverse: bool = False):
    """Inclusive prefix (suffix if ``reverse``) products of ``elems`` (a
    tensor or a tuple of tensors, sequence on axis 0) under
    ``combine(earlier, later)``, batched over blocks of ``block_size``
    elements (default floor(sqrt(T)), at most T): S + B sequential
    combines instead of T.  For ``reverse`` the sequence is flipped and
    combine(later, earlier) is called, as ``lax.associative_scan(...,
    reverse=True)`` does.  The JAX package's signature and argument
    order."""
    if isinstance(elems, torch.Tensor):
        return blocked_scan(lambda a, b: (combine(a[0], b[0]),), (elems,),
                            block_size, reverse)[0]
    if reverse:
        out = blocked_scan(combine, tuple(x.flip(0) for x in elems),
                           block_size)
        return tuple(x.flip(0) for x in out)
    T = elems[0].shape[0]
    S = min(block_size, T) if block_size is not None else \
        default_block_size(T)
    B = T // S
    T0 = B * S
    main = tuple(x[:T0].reshape((B, S) + x.shape[1:]).transpose(0, 1)
                 for x in elems)                          # (S, B, ...)
    within = [_take(main, 0)]
    for s in range(1, S):
        within.append(combine(within[-1], _take(main, s)))
    within = tuple(torch.stack(v) for v in zip(*within))  # (S, B, ...)
    if B > 1:
        products = _take(within, S - 1)                   # (B, ...)
        offsets = [_take(products, 0)]
        for b in range(1, B - 1):
            offsets.append(combine(offsets[-1], _take(products, b)))
        off = tuple(torch.stack(v) for v in zip(*offsets))        # (B-1, ...)
        off_b = tuple(x[:, None].expand((B - 1, S) + x.shape[1:])
                      for x in off)
        tail = tuple(x.transpose(0, 1)[1:] for x in within)       # (B-1, S, ...)
        combined = combine(off_b, tail)
        full = tuple(torch.cat([w.transpose(0, 1)[:1], c], dim=0)
                     .reshape((T0,) + w.shape[2:])
                     for w, c in zip(within, combined))
    else:
        full = tuple(w.transpose(0, 1).reshape((T0,) + w.shape[2:])
                     for w in within)
    if T0 < T:
        carry = _take(full, T0 - 1)
        rest = []
        for i in range(T0, T):
            carry = combine(carry, _take(elems, i))
            rest.append(carry)
        full = tuple(torch.cat([f, torch.stack(v)], dim=0)
                     for f, v in zip(full, zip(*rest)))
    return full


def associative_scan(combine: Callable, elems, reverse: bool = False):
    """Inclusive prefix (suffix if ``reverse``) products of ``elems`` (a
    tensor or a tuple of tensors, sequence on axis 0) under
    ``combine(earlier, later)``, by the log-depth tree of
    ``lax.associative_scan``: combine the pairs (e[2i], e[2i+1]), scan the
    reduced half, then out[2i] = combine(odd[i-1], e[2i]) for i >= 1,
    out[0] = e[0] and out[2i+1] = odd[i].  For ``reverse`` the sequence is
    flipped, scanned and flipped back, so ``combine`` receives (later,
    earlier), as ``lax.associative_scan(..., reverse=True)`` calls it."""
    if isinstance(elems, torch.Tensor):
        return associative_scan(lambda a, b: (combine(a[0], b[0]),),
                                (elems,), reverse)[0]
    elems = tuple(elems)
    if reverse:
        out = _assoc(combine, tuple(x.flip(0) for x in elems))
        return tuple(x.flip(0) for x in out)
    return _assoc(combine, elems)


def _assoc(combine: Callable, elems: tuple) -> tuple:
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = tuple(combine(tuple(x[0:n - 1:2] for x in elems),
                            tuple(x[1::2] for x in elems)))
    odd = _assoc(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(x[:-1] for x in odd),
                       tuple(x[2::2] for x in elems))
    else:
        even = combine(odd, tuple(x[2::2] for x in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full[0] = e[0]
        full[2::2] = ev
        full[1::2] = od
        out.append(full)
    return tuple(out)
