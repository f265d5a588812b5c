"""Capacity-buffer maintenance of the serving layer: kernel K13.

The PyTorch twin of ``dfm_tpu.serve.batched.ring_evict`` together with the
append that follows it in ``dfm_tpu.serve.session._session_core``, in its
single-session form: ``ring_evict_append`` retires the oldest ``n_evict``
rows of a capacity-padded (T_cap, N) panel and its mask, shifts the live
window back to the buffer origin, re-zeroes the tail, and writes the
update's ``r_max`` padded rows at the new live end, dropping rows past
capacity.  On a CUDA tensor it launches ``csrc/ring_append.cu``; on a CPU
tensor it runs ``ring_evict_append_plain``, which is the JAX routines'
algebra (roll, select, scatter with drop) and equals the kernel bit for
bit.

``n_evict`` and ``t_cur`` are host integers: a session tracks both on the
host before each update, so this eager slice passes them as kernel
arguments.  A CUDA-graph capture of the query would move them into device
scalars that the kernel reads.  The batched forms (``batched_ring_evict``,
``estim/batched.py:batched_ragged_append``) are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["ring_evict_append", "ring_evict_append_plain"]


def _check_counts(T_cap: int, r_max: int, n_evict: int, t_cur: int) -> None:
    if not 0 <= n_evict <= t_cur <= T_cap:
        raise ValueError(f"ring_evict_append needs 0 <= n_evict <= t_cur <= "
                         f"T_cap; got n_evict={n_evict}, t_cur={t_cur}, "
                         f"T_cap={T_cap}")
    if r_max < 0:
        raise ValueError(f"ring_evict_append: r_max={r_max} < 0")


def ring_evict_append_plain(Ybuf, Wbuf, rows, rmask, n_evict: int,
                            t_cur: int) -> None:
    """Plain-torch K13, in place: ``where(t < t_keep, roll(buf, -n_evict),
    0)`` on both buffers (t_keep = t_cur - n_evict), then ``rows``/``rmask``
    (r_max, N) written at rows t_keep + j, the rows past T_cap dropped."""
    T_cap, r_max = Ybuf.shape[0], rows.shape[0]
    _check_counts(T_cap, r_max, n_evict, t_cur)
    t_keep = t_cur - n_evict
    keep = (torch.arange(T_cap, device=Ybuf.device) < t_keep)[:, None]
    n_in = max(0, min(r_max, T_cap - t_keep))
    idx = torch.arange(t_keep, t_keep + n_in, device=Ybuf.device)
    for buf, src in ((Ybuf, rows), (Wbuf, rmask)):
        out = torch.where(keep, torch.roll(buf, -n_evict, dims=0),
                          torch.zeros((), dtype=buf.dtype, device=buf.device))
        out.index_copy_(0, idx, src[:n_in])
        buf.copy_(out)


def ring_evict_append(Ybuf, Wbuf, rows, rmask, n_evict: int,
                      t_cur: int) -> None:
    """K13: evict ``n_evict`` rows and append ``rows``/``rmask`` in place
    on ``Ybuf``/``Wbuf`` (see the module docstring).  The kernel assumes
    the session's invariant, every row at and past ``t_cur`` exactly zero
    on entry; under it, kernel and plain twin agree bit for bit.  One
    launch per call on CUDA tensors; no fallback."""
    if Ybuf.device.type == "cpu":
        return ring_evict_append_plain(Ybuf, Wbuf, rows, rmask, n_evict,
                                       t_cur)
    T_cap, N = Ybuf.shape
    r_max = rows.shape[0]
    dt, dev = Ybuf.dtype, Ybuf.device
    _check_counts(T_cap, r_max, n_evict, t_cur)
    for name, x, shape in (("Ybuf", Ybuf, (T_cap, N)),
                           ("Wbuf", Wbuf, (T_cap, N)),
                           ("rows", rows, (r_max, N)),
                           ("rmask", rmask, (r_max, N))):
        kernels.check_tensor(name, x, shape, dt, dev)
    kernels.launch("ring_append", dt, Ybuf, Wbuf, rows, rmask, T_cap, N,
                   r_max, int(n_evict), int(t_cur))
