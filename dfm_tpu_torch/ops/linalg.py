"""PSD-safe linear-algebra primitives (twins of ``dfm_tpu.ops.linalg``).

Cholesky-only solves, no explicit inverses.  Two behaviours carry over
from the reference: ``psd_cholesky`` symmetrizes and then adds a jitter
matched to the dtype (1e-6 in f32, 1e-10 in f64), and nothing clamps, so
an indefinite input gives NaN instead of silently wrong numbers.

The ``*_unrolled`` functions are the plain twins of kernels K6 and K7:
the JAX package's elementwise small-matrix routines, batched over the
leading axes, whose CUDA form is the per-thread device code in
``csrc/small_linalg.cuh`` (run inside ``csrc/qr_elements.cu`` and
``csrc/qr_scan.cu``).  Above QR_UNROLL_K_MAX the square-root engine takes
the JAX package's generic branches instead: ``tria`` the Gram matrix's
jittered Cholesky, ``tri_solve`` ``solve_triangular``, ``psd_factor`` a
jittered Cholesky, and in the element builds ``qr_chol`` (an unjittered
``psd_cholesky``) and ``qr_chol_solve`` (``chol_solve``); their CUDA form
is the block-wide code of ``csrc/cta_linalg.cuh`` inside the generic
kernels ``qr_elements_gen`` and ``qr_scan_gen`` (``csrc/pit_elements.cu``,
``csrc/pit_scan.cu``, beside the pit engine's generic kernels).  ``small_linalg`` applies
one function to a batch: on a CUDA tensor it launches the unit mode of
the kernel ``check_qr_k`` routes to, on a CPU tensor it runs the twin.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["sym", "default_jitter", "psd_cholesky", "chol_solve",
           "chol_logdet", "solve_psd", "chol_small", "chol_solve_small",
           "UNROLL_K_MAX", "QR_UNROLL_K_MAX",
           "chol_unrolled", "matmul_vpu", "matvec_vpu",
           "chol_solve_unrolled", "tria_unrolled", "tria",
           "tri_solve_unrolled", "tri_solve", "psd_factor_unrolled",
           "psd_factor", "qr_chol", "qr_chol_solve", "SMALL_LINALG_OPS",
           "small_linalg", "check_qr_k"]

# The JAX package's unroll bounds (dfm_tpu/ops/linalg.py).  Above
# QR_UNROLL_K_MAX its square-root engine switches tria / tri_solve /
# psd_factor and the element builds' chol / chol_solve to the generic
# forms (the kernels qr_elements_gen and qr_scan_gen).
UNROLL_K_MAX = 8
QR_UNROLL_K_MAX = 10


def sym(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize the trailing two axes."""
    return 0.5 * (M + M.transpose(-1, -2))


def default_jitter(dtype) -> float:
    """Diagonal jitter matched to precision: ~1e-10 in f64, ~1e-6 in f32."""
    return 1e-10 if dtype == torch.float64 else 1e-6


def psd_cholesky(M: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Cholesky of a nominally-PSD matrix with symmetrization + jitter.

    ``torch.linalg.cholesky_ex`` reports a failed factorization through
    ``info`` instead of raising; the failed factor is replaced by NaN so an
    indefinite input fails visibly, as ``jnp.linalg.cholesky`` does.
    """
    k = M.shape[-1]
    if jitter is None:
        jitter = default_jitter(M.dtype)
    eye = torch.eye(k, dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(sym(M) + jitter * eye)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = B given lower-triangular L.  B may be matrix or vector."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    X = torch.cholesky_solve(B, L, upper=False)
    return X[..., 0] if vec else X


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log det(L L') from the Cholesky factor."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def solve_psd(M: torch.Tensor, B: torch.Tensor,
              jitter: float | None = None) -> torch.Tensor:
    """Solve M X = B for symmetric PSD M via Cholesky."""
    return chol_solve(psd_cholesky(M, jitter), B)


def chol_small(M: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Cholesky of M + jitter I for the small r x r systems of the rank-r
    engine (its S, Gam and Sig carry their own regularization, so the
    default adds none).  No clamp and no raise: a failed factor's lower
    triangle becomes NaN, as ``jnp.linalg.cholesky`` gives
    (``torch.linalg.cholesky`` would raise and read the host)."""
    if jitter:
        M = M + jitter * torch.eye(M.shape[-1], dtype=M.dtype,
                                   device=M.device)
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def chol_solve_small(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = B with the factor of ``chol_small``."""
    return chol_solve(L, B)


def chol_unrolled(P: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Batched Cholesky of the lower triangle of P, the textbook scalar
    algorithm over the batch.  No clamp: a negative pivot gives NaN."""
    k = P.shape[-1]
    L: list = [[None] * k for _ in range(k)]
    for i in range(k):
        s = P[..., i, i] + jitter
        for j in range(i):
            s = s - L[i][j] * L[i][j]
        L[i][i] = torch.sqrt(s)
        for r in range(i + 1, k):
            s2 = P[..., r, i]
            for j in range(i):
                s2 = s2 - L[r][j] * L[i][j]
            L[r][i] = s2 / L[i][i]
    return _lower(L, P[..., 0, 0])


def _lower(L, like):
    zero = torch.zeros_like(like)
    k = len(L)
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(k)],
                        dim=-1) for i in range(k)]
    return torch.stack(rows, dim=-2)


def matmul_vpu(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j, l) as a broadcast multiply and sum."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def matvec_vpu(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) as a broadcast multiply and sum."""
    return (A * v[..., None, :]).sum(-1)


def chol_solve_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = B by forward and back substitution; B (..., k) or
    (..., k, r)."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    k, r = L.shape[-1], B.shape[-1]
    cols = []
    for c in range(r):
        y: list = [None] * k
        for i in range(k):
            s = B[..., i, c]
            for j in range(i):
                s = s - L[..., i, j] * y[j]
            y[i] = s / L[..., i, i]
        x: list = [None] * k
        for i in reversed(range(k)):
            s = y[i]
            for j in range(i + 1, k):
                s = s - L[..., j, i] * x[j]
            x[i] = s / L[..., i, i]
        cols.append(torch.stack(x, dim=-1))
    X = torch.stack(cols, dim=-1)
    return X[..., 0] if vec else X


def tria_unrolled(X: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L L' = X X' for X (..., k, m), by modified
    Gram-Schmidt on the rows of X.  An exactly-zero residual row gives a
    zero row of L; the diagonal is >= 0."""
    k = X.shape[-2]
    q: list = [None] * k
    L: list = [[None] * k for _ in range(k)]
    for i in range(k):
        v = X[..., i, :]
        for j in range(i):
            c = (v * q[j]).sum(-1)
            L[i][j] = c
            v = v - c[..., None] * q[j]
        nrm = torch.sqrt((v * v).sum(-1))
        L[i][i] = nrm
        nz = nrm[..., None] > 0
        q[i] = torch.where(nz, v / torch.where(nz, nrm[..., None], 1.0),
                           0.0)
    return _lower(L, X[..., 0, 0])


def tria(X: torch.Tensor) -> torch.Tensor:
    """``tria_unrolled`` for k <= QR_UNROLL_K_MAX; above it the Gram
    matrix's jittered Cholesky, as the JAX package falls back."""
    if X.shape[-2] <= QR_UNROLL_K_MAX:
        return tria_unrolled(X)
    return psd_cholesky(X @ X.transpose(-1, -2))


def tri_solve_unrolled(L: torch.Tensor, B: torch.Tensor,
                       trans: bool = False) -> torch.Tensor:
    """Solve L X = B (L' X = B with ``trans``) by substitution; a zero
    pivot gives a zero entry (the pseudo-inverse of the semidefinite
    factors)."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    k, r = L.shape[-1], B.shape[-1]
    diag = [L[..., i, i] for i in range(k)]
    safe = [torch.where(d > 0, d, 1.0) for d in diag]
    cols = []
    for c in range(r):
        x: list = [None] * k
        for i in (reversed(range(k)) if trans else range(k)):
            s = B[..., i, c]
            if trans:
                for j in range(i + 1, k):
                    s = s - L[..., j, i] * x[j]
            else:
                for j in range(i):
                    s = s - L[..., i, j] * x[j]
            x[i] = torch.where(diag[i] > 0, s / safe[i], 0.0)
        cols.append(torch.stack(x, dim=-1))
    X = torch.stack(cols, dim=-1)
    return X[..., 0] if vec else X


def tri_solve(L: torch.Tensor, B: torch.Tensor,
              trans: bool = False) -> torch.Tensor:
    """``tri_solve_unrolled`` for small k, ``solve_triangular`` above."""
    if L.shape[-1] <= QR_UNROLL_K_MAX:
        return tri_solve_unrolled(L, B, trans=trans)
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    M = L.transpose(-1, -2) if trans else L
    X = torch.linalg.solve_triangular(M, B, upper=trans)
    return X[..., 0] if vec else X


def psd_factor_unrolled(P: torch.Tensor) -> torch.Tensor:
    """Guarded Cholesky-type factor of a possibly singular PSD matrix: a
    pivot at or below eps(dtype) * k * |P_ii| becomes an exact zero row
    and column instead of NaN."""
    k = P.shape[-1]
    eps = float(torch.finfo(P.dtype).eps)
    L: list = [[None] * k for _ in range(k)]
    for i in range(k):
        s = P[..., i, i]
        for j in range(i):
            s = s - L[i][j] * L[i][j]
        live = s > eps * k * torch.abs(P[..., i, i])
        d = torch.sqrt(torch.where(live, s, 1.0))
        L[i][i] = torch.where(live, d, 0.0)
        for r in range(i + 1, k):
            s2 = P[..., r, i]
            for j in range(i):
                s2 = s2 - L[r][j] * L[i][j]
            L[r][i] = torch.where(live, s2 / d, 0.0)
    return _lower(L, P[..., 0, 0])


def psd_factor(P: torch.Tensor) -> torch.Tensor:
    """``psd_factor_unrolled`` for small k; jittered Cholesky above it."""
    if P.shape[-1] <= QR_UNROLL_K_MAX:
        return psd_factor_unrolled(P)
    return psd_cholesky(P)


def qr_chol(M: torch.Tensor) -> torch.Tensor:
    """The square-root engine's Cholesky of I + (PSD) in its element
    builds, the t = 0 posterior and the logdet: ``chol_unrolled`` for
    k <= QR_UNROLL_K_MAX, an unjittered ``psd_cholesky`` above it."""
    if M.shape[-1] <= QR_UNROLL_K_MAX:
        return chol_unrolled(M)
    return psd_cholesky(M, jitter=0.0)


def qr_chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The square-root engine's solve against a ``qr_chol`` factor:
    ``chol_solve_unrolled`` for small k, ``chol_solve`` above it."""
    if L.shape[-1] <= QR_UNROLL_K_MAX:
        return chol_solve_unrolled(L, B)
    return chol_solve(L, B)


# The unit mode of kernels qr_elements (k <= QR_UNROLL_K_MAX) and
# qr_elements_gen (above it): op -> (code, plain twin at the batch's k).
SMALL_LINALG_OPS = {
    "chol": (0, lambda X, B: qr_chol(X)),
    "chol_solve": (1, qr_chol_solve),
    "tria": (2, lambda X, B: tria(X)),
    "tri_solve": (3, tri_solve),
    "tri_solve_trans": (4, lambda X, B: tri_solve(X, B, True)),
    "psd_factor": (5, lambda X, B: psd_factor(X)),
}


def small_linalg(op: str, X: torch.Tensor,
                 B: torch.Tensor | None = None) -> torch.Tensor:
    """One K6/K7 function over a batch (n, k, k) -> (n, k, k): X is the
    matrix (for ``tria`` the (n, k, 2k) block), B the right-hand side of
    the solves.  CUDA tensors: the unit mode of the kernel ``check_qr_k``
    routes to (past QR_UNROLL_K_MAX the generic branch); CPU tensors: the
    plain twin."""
    code, plain = SMALL_LINALG_OPS[op]
    if X.device.type == "cpu":
        return plain(X, B)
    n, k = X.shape[0], X.shape[1]
    kernel = check_qr_k("qr_elements", k)
    dt, dev = X.dtype, X.device
    kernels.check_tensor("X", X, (n, k, 2 * k if op == "tria" else k), dt,
                         dev)
    if code in (1, 3, 4):
        kernels.check_tensor("B", B, (n, k, k), dt, dev)
    out = torch.empty((n, k, k), dtype=dt, device=dev)
    args = (X, B, None, None, None, None, None, out, None, None, None, None)
    if kernel == "qr_elements":
        kernels.launch(kernel, dt, 4, code, *args, n, k, 0)
    else:
        work, ctas = gen_work(kernel, dt, dev, n, k)
        kernels.launch(kernel, dt, 4, code, *args, work, n, k, 0, ctas)
    return out


def gen_work(kernel: str, dt, dev, n: int, k: int) -> tuple:
    """(workspace, CTA count) of a generic kernel's persistent grid over n
    items (``kernels.GEN_MATS`` k x k matrices a CTA)."""
    ctas = kernels.gen_ctas(dev, n)
    work = torch.empty(ctas * kernels.GEN_MATS[kernel] * k * k, dtype=dt,
                       device=dev)
    return work, ctas


def check_qr_k(name: str, k: int) -> str:
    """The kernel the square-root engine's entry ``name`` ("qr_elements",
    "qr_scan" or "qr_assoc") launches at k: its own (one thread a step or a combine)
    for k <= QR_UNROLL_K_MAX, ``<name>_gen`` (the JAX package's generic
    branch, a CTA a step or a combine) for QR_UNROLL_K_MAX < k <=
    kernels.GEN_KMAX; past that it raises naming the ROADMAP row, before
    any launch."""
    if k <= QR_UNROLL_K_MAX:
        kernels.check_k(name, k)
        return name
    kernels.check_k(name, k, kernels.GEN_KMAX)
    return f"{name}_gen"
