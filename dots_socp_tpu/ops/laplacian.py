"""Space-time Laplacian inverse on the accelerator.

The phi-step solves (L_time (x) diag(av) + I (x) L_space) phi = rhs on the
(T+1, V) grid. Like the reference (`utils/laplacian_inverse_socp.py:11-62`)
we diagonalize the 1-D Neumann time Laplacian, decoupling the system into
T+1 independent spatial solves -- but instead of T+1 cached SuperLU
factorizations (inherently sequential back-substitutions), we factor the
*spatial* pencil spectrally as well:

    C = av^{-1/2} (-L_space) av^{-1/2} = Q diag(w) Q^T,  w >= 0,

so every shifted solve (L_space + (lam_a - eps) diag(av)) x = b becomes

    x = av^{-1/2} Q diag(1/(lam_a - eps - w)) Q^T av^{-1/2} b,

i.e. two (T+1, V) x (V, V) GEMMs per iteration: exact, batched over all
time shifts at once, and matmul-bound. Zero denominators (the joint constant
null space when eps = 0) are pseudo-inverted to 0, which pins phi's free
constant instead of letting it drift.

The dense factor costs O(V^2) memory; `max_dense_vertices` in the solver
selects the matrix-free preconditioned-CG path (`cg_solve`) for larger
meshes, using L x = div(area * grad(x)) as the SpMV.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dots_socp_tpu.ops.mesh_ops import SurfaceOps, laplacian_apply


def build_time_laplacian(n_time: int, stepsize_time: float) -> np.ndarray:
    """Dense (T+1, T+1) Neumann 1-D Laplacian, scaled by 1/dt^2.

    Interior rows are the [1, -2, 1] stencil; boundary rows [-1, 1]
    (reference `laplacian_inverse_socp.py:15-26`). Negative semidefinite.
    """
    n = n_time + 1
    lap = np.zeros((n, n))
    idx = np.arange(1, n - 1)
    lap[idx, idx] = -2.0
    lap[idx, idx - 1] = 1.0
    lap[idx, idx + 1] = 1.0
    lap[0, 0] = lap[-1, -1] = -1.0
    lap[0, 1] = lap[-1, -2] = 1.0
    return lap / stepsize_time**2


class SpectralFactor(NamedTuple):
    """Precomputed spectral factorization of the space-time Laplacian.

    u_time : (T+1, T+1) eigenvectors of the time Laplacian
    s      : (V,) av^{-1/2}
    q      : (V, V) eigenvectors of C (ascending eigenvalues w)
    invfac : (T+1, V) masked 1 / (lam_a - eps - w_i)
    """

    u_time: jnp.ndarray
    s: jnp.ndarray
    q: jnp.ndarray
    invfac: jnp.ndarray


def build_spectral_factor(
    n_time: int,
    stepsize_time: float,
    av: np.ndarray,
    lap_space,
    eps: float = 0.0,
    dtype=jnp.float32,
    use_host_eigh: bool | None = None,
) -> SpectralFactor:
    """Factor the pencil once at setup.

    Parameters
    ----------
    av : (V,) vertex areas (area_vertices / 3)
    lap_space : scipy sparse or dense (V, V) cotan Laplacian (negative SD)
    use_host_eigh : LAPACK eigh on the host (default True), with an on-disk
        cache, and the factor shipped to the device once. False runs
        `jnp.linalg.eigh` on the device instead; its speed on the GPU for
        this one-time V x V factor is not measured yet.
    """
    lap_time = build_time_laplacian(n_time, stepsize_time)
    lam_t, u_time = np.linalg.eigh(lap_time)  # lam_t <= 0 ascending

    av = np.asarray(av, dtype=np.float64)
    s = 1.0 / np.sqrt(av)
    dense = lap_space.toarray() if hasattr(lap_space, "toarray") else np.asarray(lap_space)
    c = -(s[:, None] * dense * s[None, :])
    c = 0.5 * (c + c.T)  # enforce symmetry

    if use_host_eigh is None:
        use_host_eigh = True

    if use_host_eigh:
        w, q = _spectral_eigh_cached(lap_space, av, c, dtype)
        w = jnp.asarray(w, dtype=dtype)
        q = jnp.asarray(q, dtype=dtype)
    else:
        c_dev = jax.device_put(jnp.asarray(c, dtype=dtype), jax.devices()[0])
        w, q = jnp.linalg.eigh(c_dev)

    lam_t = jnp.asarray(lam_t, dtype=dtype)
    denom = (lam_t[:, None] - eps) - w[None, :]  # (T+1, V), <= 0
    scale = jnp.max(w) - jnp.min(lam_t) + 1.0
    tiny = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype) * scale
    invfac = jnp.where(jnp.abs(denom) > tiny, 1.0 / denom, 0.0)

    return SpectralFactor(
        u_time=jnp.asarray(u_time, dtype=dtype),
        s=jnp.asarray(s, dtype=dtype),
        q=q,
        invfac=invfac,
    )


def _spectral_eigh_cached(lap_space, av, c, dtype, min_cache_v: int = 4096):
    """Host eigh of C = av^{-1/2}(-L)av^{-1/2} with an on-disk cache.

    The one-time LAPACK eigh is O(V^3) (~2 min at V=12k on this host) and
    depends only on (L_space, av); sweeps re-solving the same mesh at
    several congestion levels pay it once. Small factors (V < min_cache_v)
    are not worth the disk round trip. Cache IO failures fall back to
    computing. Shares the cache directory with the Ritz pairs.
    """
    import hashlib
    import os

    v = av.shape[0]
    if v < min_cache_v or not hasattr(lap_space, "tocsr"):
        return np.linalg.eigh(c)

    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    dtype_tag = "f64" if dtype == jnp.float64 else "f32"
    h = hashlib.sha256()
    h.update(dtype_tag.encode())
    for part in (
        np.int64([v]),
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int64),
        np.asarray(csr.data, dtype=np.float64),
        np.asarray(av, dtype=np.float64),
    ):
        h.update(part.tobytes())
    cache_dir = _ritz_cache_dir()
    path = os.path.join(cache_dir, f"eigh_{h.hexdigest()[:32]}.npz")
    try:
        with np.load(path) as f:
            return f["w"], f["q"]
    except (OSError, KeyError, ValueError):
        pass
    w, q = np.linalg.eigh(c)
    # Store at the consumer dtype: halves the disk footprint for f32 runs
    # (the factor is cast to `dtype` immediately after anyway).
    store = np.float64 if dtype == jnp.float64 else np.float32
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, w=w.astype(store), q=q.astype(store))
        os.replace(tmp, path)
    except OSError:
        pass
    return w, q


def spectral_solve(factor: SpectralFactor, rhs, precision=jax.lax.Precision.HIGHEST):
    """Apply the space-time Laplacian pseudo-inverse to rhs (T+1, V).

    Two small time-transform GEMMs + two (T+1,V)x(V,V) GEMMs. Mirrors
    reference `laplacian_inverse_socp.py:52-61`.

    precision : explicit HIGHEST by default, whatever the global default.
        A lower precision runs float32 GEMMs in TF32 on the GPU, which keeps
        ~3 decimal digits; `chip_smoke.py` measures the error that leaves
        on phi against a float64 direct solve.
    """
    mm = partial(jnp.matmul, precision=precision)
    y = mm(factor.u_time.T, rhs)  # time transform
    y = y * factor.s[None, :]
    coef = mm(y, factor.q)
    coef = coef * factor.invfac
    z = mm(coef, factor.q.T)
    z = z * factor.s[None, :]
    return mm(factor.u_time, z)


class CGOperator(NamedTuple):
    """Matrix-free shifted-Laplacian systems for the CG path.

    shifts   : (T+1,) lam_a - eps (time eigenvalues, shifted)
    jacobi   : (T+1, V) inverse diagonal of -(L_space + shift * diag(av))
    null_row : (T+1,) 1.0 where the shifted system is singular (shift ~ 0)
    u_time   : (T+1, T+1) time eigenvectors
    av_unit  : (V,) av / sum(av), for deflating the constant null vector
    s        : (V,) av^{-1/2} (generalized-eigenvector scaling)
    defl_q   : (V, k) Ritz vectors of C = av^{-1/2} (-L) av^{-1/2}
               (k = 0 disables the low-rank preconditioner term)
    defl_winv: (T+1, k) masked 1 / (ritz_w_i - shift_a)
    rtol     : () relative tolerance -- a TRACED scalar, so the host can
               tighten it as the outer iALM error decreases (classic
               inexact-ALM inner-tolerance scheduling) without recompiling
    ell_idx  : (V, D) int32 padded-ELL column indices of L_space (row-major
               neighbor lists, self-index on padding slots)
    ell_w    : (V, D) matching nonzero values (0 on padding slots)

    The SpMV inside CG uses the ELL form instead of composing
    div(area * grad(x)): one gather of D ~ 8 neighbor values per vertex
    replaces two incidence passes through (T+1, F, 3) corner-slot
    intermediates, cutting HBM traffic ~3x on this bandwidth-bound op.
    """

    shifts: jnp.ndarray
    jacobi: jnp.ndarray
    null_row: jnp.ndarray
    u_time: jnp.ndarray
    av_unit: jnp.ndarray
    s: jnp.ndarray
    defl_q: jnp.ndarray
    defl_winv: jnp.ndarray
    rtol: jnp.ndarray
    ell_idx: jnp.ndarray
    ell_w: jnp.ndarray
    # Optional float64 leaves for mixed-precision iterative refinement
    # (`refine=True` at build): the f64 TRUE-residual matvec around the f32
    # inner CG. None disables refinement.
    ell_w_hi: jnp.ndarray = None
    av_hi: jnp.ndarray = None
    shifts_hi: jnp.ndarray = None
    u_time_hi: jnp.ndarray = None
    # (V,) 1.0 on real vertices, 0.0 on padding slots (structurally empty
    # Laplacian rows). On the singular (shift ~ 0) row the padded system's
    # null space is span{1_real} + one axis per padding slot; consistency
    # projection must therefore zero the padding entries and subtract the
    # REAL-vertex mean -- subtracting the global mean instead leaves an
    # irreducible residual on slots whose Jacobi diagonal is ~1/0
    # (overflows to inf in f32 and stalls the whole row; measured on the
    # 25-dummy blocked layout at V=1681).
    real_mask: jnp.ndarray = None


def _ritz_cache_dir() -> str:
    """Directory for persisted Ritz pairs (env DOTS_SOCP_CACHE_DIR, default
    <repo>/output/ritz_cache next to the package)."""
    import os
    from pathlib import Path

    env = os.environ.get("DOTS_SOCP_CACHE_DIR")
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / "output" / "ritz_cache")


def _ritz_pairs_cached(lap_space, av: np.ndarray, k: int, seed: int = 7):
    """`_ritz_pairs` with an on-disk cache keyed by the exact problem.

    The LOBPCG deflation setup is the dominant one-time cost at large V
    (measured 778 s at V=97k); the pairs depend only on (L_space, av, k,
    seed), so persist them keyed by a content hash and pay the cost once
    per mesh. Any cache IO failure silently falls back to recomputing.
    """
    import hashlib
    import os

    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    h = hashlib.sha256()
    for part in (
        np.int64([k, seed, csr.shape[0]]),
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int64),
        np.asarray(csr.data, dtype=np.float64),
        np.asarray(av, dtype=np.float64),
    ):
        h.update(part.tobytes())
    cache_dir = _ritz_cache_dir()
    path = os.path.join(cache_dir, f"ritz_{h.hexdigest()[:32]}.npz")

    try:
        with np.load(path) as f:
            return f["q"], f["w"]
    except (OSError, KeyError, ValueError):
        pass

    q, w = _ritz_pairs(csr, av, k, seed)

    if q.shape[1] == 0:
        return q, w  # never cache a failed computation

    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:  # file object: savez can't append ".npz"
            np.savez(f, q=q, w=w)
        os.replace(tmp, path)  # atomic against concurrent builders
    except OSError:
        pass
    return q, w


def _ritz_pairs(lap_space, av: np.ndarray, k: int, seed: int = 7):
    """The k smallest eigenpairs of C = av^{-1/2}(-L)av^{-1/2} (host side,
    one-time), for the CG deflation preconditioner.

    Shift-invert Lanczos: factorize C + delta*I once with SuperLU (2-D mesh
    fill-in keeps this cheap even at V ~ 100k) and run ARPACK on the
    inverse. This replaces the round-2 LOBPCG pipeline, which silently
    returned EMPTY at V >= 46k -- the large-mesh deflation never actually
    engaged, leaving Jacobi-only CG at ~400+ inner iterations. LOBPCG
    remains the fallback when the factorization fails. Any failure
    degrades to Jacobi-only preconditioning (empty deflation)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import LinearOperator, eigsh, lobpcg, splu

    v = av.shape[0]
    k = int(min(k, max(v // 4, 1)))
    if k <= 0:
        return np.zeros((v, 0)), np.zeros(0)
    s = 1.0 / np.sqrt(av)
    c = -sp.csr_matrix(lap_space)
    c = (sp.diags(s) @ c @ sp.diags(s)).tocsc()
    diag_max = float(np.max(c.diagonal(), initial=1.0))

    with np.errstate(all="ignore"):
        try:
            delta = 1e-8 * diag_max  # C is PSD; makes C + delta*I PD
            lu = splu(c + delta * sp.identity(v, format="csc"))
            op_inv = LinearOperator((v, v), matvec=lu.solve)
            w, q = eigsh(
                c,
                k=k,
                sigma=-delta,
                which="LM",  # nearest sigma => smallest eigenvalues of C
                OPinv=op_inv,
                v0=np.sqrt(av),  # known null vector of C
                tol=1e-8,
            )
            if np.isfinite(q).all() and np.isfinite(w).all():
                return q, np.maximum(w, 0.0)
        except Exception:
            pass
        # Fallback: Jacobi-preconditioned LOBPCG + Rayleigh-Ritz cleanup.
        try:
            precond = LinearOperator(
                (v, v), matvec=lambda x: x / np.maximum(c.diagonal(), 1e-30)
            )
            rng = np.random.default_rng(seed)
            x0 = rng.standard_normal((v, k))
            x0[:, 0] = np.sqrt(av)
            w, q = lobpcg(
                c, x0, M=precond, largest=False, tol=1e-4, maxiter=128
            )
            if not np.isfinite(q).all():
                return np.zeros((v, 0)), np.zeros(0)
            q, _ = np.linalg.qr(q)
            small = q.T @ (c @ q)
            w, u = np.linalg.eigh(0.5 * (small + small.T))
        except Exception:
            return np.zeros((v, 0)), np.zeros(0)
    q, w = q @ u, np.maximum(w, 0.0)
    if not (np.isfinite(q).all() and np.isfinite(w).all()):
        return np.zeros((v, 0)), np.zeros(0)
    return q, w


def build_cg_operator(
    n_time: int,
    stepsize_time: float,
    av: np.ndarray,
    lap_space,
    eps: float = 0.0,
    dtype=jnp.float32,
    deflation_k: int = 64,
    rtol: float = 1e-6,
    refine: bool = False,
) -> CGOperator:
    """Set up the matrix-free CG solver for meshes too large to densify.

    lap_space : scipy sparse (V, V) cotan Laplacian (negative SD), used for
        its diagonal and for the one-time Ritz-pair computation.
    deflation_k : number of low-end Ritz pairs in the spectral
        preconditioner (0 disables). The smallest generalized eigenvalues of
        (-L, diag(av)) are shared by ALL T+1 shifted systems, so one
        low-rank term accelerates the whole batch -- it is exactly the
        ill-conditioned tail that plain Jacobi cannot see.
    refine : attach float64 operator leaves enabling mixed-precision
        iterative refinement in `cg_solve`. Finite-precision CG cannot push
        the TRUE residual ||b - A x|| below ~eps * ||A|| ||x|| no matter how
        tight the recursive-residual tolerance is; at V=46k that f32 floor
        is eps32/h^2 ~ 2e-3 relative -- above the 1e-4 outer tolerance
        (measured: the tight-CG control stalled at 1.7e-3 exactly like the
        adaptive run). Refinement restores f64-level true residuals while
        every inner CG iteration keeps running in f32.
    """
    lap_time = build_time_laplacian(n_time, stepsize_time)
    lam_t, u_time = np.linalg.eigh(lap_time)
    av = np.asarray(av, dtype=np.float64)
    lap_diag = np.asarray(
        lap_space.diagonal() if hasattr(lap_space, "diagonal") else lap_space
    )
    shifts = lam_t - eps  # (T+1,)
    diag = -(lap_diag[None, :] + shifts[:, None] * av[None, :])
    scale = np.abs(shifts).max() * av.max() + np.abs(lap_diag).max()
    null_row = (np.abs(shifts) * av.max() < 1e-10 * scale).astype(np.float64)
    jacobi = 1.0 / np.maximum(diag, 1e-30 * scale)
    # Padding slots (structurally empty rows): their residual is pinned at
    # exactly 0 on the singular row (see `real_mask`), so zero the ~1/0
    # Jacobi entries there instead of letting them overflow to inf in f32.
    real = (lap_diag != 0).astype(np.float64)
    jacobi = np.where(
        (null_row[:, None] > 0.5) & (real[None, :] < 0.5), 0.0, jacobi
    )

    if deflation_k > 0 and hasattr(lap_space, "diagonal"):
        q, w = _ritz_pairs_cached(lap_space, av, deflation_k)
    else:
        q, w = np.zeros((av.shape[0], 0)), np.zeros(0)
    denom = w[None, :] - shifts[:, None]  # (T+1, k), >= 0
    tiny = 1e-10 * max(scale / max(av.max(), 1e-30), 1.0)
    with np.errstate(divide="ignore"):
        winv = np.where(np.abs(denom) > tiny, 1.0 / denom, 0.0)
    if q.shape[1] > 0:
        # On the singular (shift ~ 0) rows, the Ritz pair aligned with the
        # known null vector sqrt(av) must contribute nothing: LOBPCG's
        # tol=1e-4 can leave its Ritz value w0 above `tiny`, making 1/w0
        # huge and injecting f32-amplified noise along the null direction.
        # Zero it by alignment, not by the absolute threshold.
        v0 = np.sqrt(av)
        v0 /= np.linalg.norm(v0)
        null_aligned = np.abs(q.T @ v0) > 0.5  # (k,)
        winv = np.where(
            null_row.astype(bool)[:, None] & null_aligned[None, :], 0.0, winv
        )

    ell_idx, ell_w = _ell_arrays(lap_space)

    hi = {}
    if refine:
        # f64 leaves only exist when x64 is on (else they silently downcast
        # and the refinement loop would chase its own rounding).
        jax.config.update("jax_enable_x64", True)
        hi = dict(
            ell_w_hi=jnp.asarray(ell_w, dtype=jnp.float64),
            av_hi=jnp.asarray(av, dtype=jnp.float64),
            shifts_hi=jnp.asarray(shifts, dtype=jnp.float64),
            u_time_hi=jnp.asarray(u_time, dtype=jnp.float64),
        )

    return CGOperator(
        shifts=jnp.asarray(shifts, dtype=dtype),
        jacobi=jnp.asarray(jacobi, dtype=dtype),
        null_row=jnp.asarray(null_row, dtype=dtype),
        u_time=jnp.asarray(u_time, dtype=dtype),
        av_unit=jnp.asarray(av / av.sum(), dtype=dtype),
        s=jnp.asarray(1.0 / np.sqrt(av), dtype=dtype),
        defl_q=jnp.asarray(q, dtype=dtype),
        defl_winv=jnp.asarray(winv, dtype=dtype),
        rtol=jnp.asarray(rtol, dtype=dtype),
        ell_idx=jnp.asarray(ell_idx),
        ell_w=jnp.asarray(ell_w, dtype=dtype),
        real_mask=jnp.asarray(real, dtype=dtype),
        **hi,
    )


def _ell_arrays(lap_space):
    """Padded-ELL (indices, values) of the sparse (V, V) cotan Laplacian.

    Rows are padded to the max vertex degree + 1 with (own-index, 0.0)
    entries, so the SpMV is a fixed-width gather + mul-sum with no scatter
    (the reference's `utils/laplacian_inverse_socp.py` delegates to
    SuperLU; here CG owns the hot loop and the SpMV *is* the roofline).
    """
    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    v = csr.shape[0]
    nnz_per_row = np.diff(csr.indptr)
    width = max(int(nnz_per_row.max(initial=0)), 1)
    idx = np.repeat(np.arange(v, dtype=np.int32)[:, None], width, axis=1)
    w = np.zeros((v, width), dtype=np.float64)
    rows = np.repeat(np.arange(v), nnz_per_row)
    slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    idx[rows, slots] = csr.indices.astype(np.int32)
    w[rows, slots] = csr.data
    return idx, w


def ell_matvec(op: CGOperator, x, weights=None):
    """L_space @ x for (..., V) x, via the padded-ELL gather form.

    The gather runs in vertex-major layout: moving V to the front makes
    each gathered element a contiguous (lead...,) row -- T+1 = 32 f32
    values are one 128-byte row -- instead of a single strided element.

    weights : override for `op.ell_w` (the refinement path passes the f64
        copy so the true-residual matvec carries f64 matrix entries).
    """
    w = op.ell_w if weights is None else weights
    xt = jnp.moveaxis(x, -1, 0)  # (V, ...)
    g = xt[op.ell_idx]  # (V, D, ...)
    w = w.reshape(w.shape + (1,) * (x.ndim - 1))
    return jnp.moveaxis((g * w).sum(1), 0, -1)


class BandedOperator(NamedTuple):
    """RCM block-banded form of the cotan Laplacian: zero-gather SpMV.

    After a reverse-Cuthill-McKee reordering the matrix bandwidth drops to
    O(sqrt V); padding it to (2*w_blocks+1) block diagonals of 128x128
    dense tiles turns the SpMV into a handful of shifted batched matmuls,
    shared across all T+1 time shifts:

        y_i = sum_d  A[d, i] @ x_{i+d-w},   A[d] : (nb, 128, 128)

    blocks : (2w+1, nb, 128, 128) dense band tiles (zero-padded)
    perm   : (Vp,) RCM order (new position -> old index)
    iperm  : (Vp,) inverse permutation
    """

    blocks: jnp.ndarray
    perm: jnp.ndarray
    iperm: jnp.ndarray


def build_banded_operator(
    lap_space, dtype=jnp.float32, block: int = 128, max_bytes: int = 2 << 30
):
    """Host-side: RCM-reorder the sparse Laplacian and extract the dense
    block band. Returns None when the band storage would exceed max_bytes
    (pathological orderings / very high genus meshes)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = sp.csr_matrix(lap_space)
    v = csr.shape[0]
    perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
    p = csr[perm][:, perm].tocoo()

    vp = -(-v // block) * block
    nb = vp // block
    bw = int(np.abs(p.row - p.col).max(initial=0))
    w_blocks = (bw + block - 1) // block  # block-diagonal reach each side
    n_diag = 2 * w_blocks + 1
    itemsize = np.dtype(np.float32 if dtype == jnp.float32 else np.float64).itemsize
    if n_diag * nb * block * block * itemsize > max_bytes:
        return None

    blocks = np.zeros((n_diag, nb, block, block), dtype=np.float64)
    bi, bj = p.row // block, p.col // block
    d = bj - bi + w_blocks  # 0 .. n_diag-1 by construction
    blocks[d, bi, p.row % block, p.col % block] = p.data

    perm_full = np.concatenate([perm, np.arange(v, vp)]).astype(np.int32)
    iperm_full = np.empty(vp, dtype=np.int32)
    iperm_full[perm_full] = np.arange(vp, dtype=np.int32)
    return BandedOperator(
        blocks=jnp.asarray(blocks, dtype=dtype),
        perm=jnp.asarray(perm_full),
        iperm=jnp.asarray(iperm_full),
    )


def banded_matvec(op: BandedOperator, x):
    """L_space @ x for (..., V) x via shifted block-diagonal batched
    matmuls -- dense matmul work, no gathers (the two permutations are
    row-contiguous takes)."""
    vp = op.perm.shape[0]
    v = x.shape[-1]
    lead = x.shape[:-1]
    nb = op.blocks.shape[1]
    block = op.blocks.shape[2]
    w = (op.blocks.shape[0] - 1) // 2

    xt = jnp.moveaxis(x, -1, 0)  # (V, ...)
    if vp > v:
        xt = jnp.concatenate(
            [xt, jnp.zeros((vp - v,) + lead, dtype=x.dtype)], axis=0
        )
    xp = xt[op.perm].reshape((nb, block) + lead)  # (nb, 128, ...)
    flat = xp.reshape(nb, block, -1)  # (nb, 128, L)

    hi = jax.lax.Precision.HIGHEST
    y = jnp.zeros_like(flat)
    for d in range(op.blocks.shape[0]):
        shift = d - w  # block offset of the source column panel
        src = jnp.roll(flat, -shift, axis=0)
        contrib = jnp.einsum(
            "nij,njl->nil", op.blocks[d], src, precision=hi
        )
        # Zero the wrapped-around panels from the roll.
        if shift > 0:
            idx = jnp.arange(nb) < nb - shift
            contrib = jnp.where(idx[:, None, None], contrib, 0.0)
        elif shift < 0:
            idx = jnp.arange(nb) >= -shift
            contrib = jnp.where(idx[:, None, None], contrib, 0.0)
        y = y + contrib
    y = y.reshape((vp,) + lead)[op.iperm][:v]
    return jnp.moveaxis(y, 0, -1)


def cg_solve(
    ops: SurfaceOps,
    op: CGOperator,
    rhs,
    x0=None,
    max_iters: int = 200,
    rtol=None,
    halo=None,
    mesh_axes=None,
    space_sharded=False,
    return_iters=False,
    ops_hi=None,
):
    """Batched spectrally-preconditioned CG over the T+1 shifted SPD systems.
    With return_iters=True, also returns the inner iteration count (for
    diagnostics / the large-solve CG histogram).

    Solves -(L_space + shift_a * diag(av)) x_a = -b_a for all time modes at
    once (the whole batch shares each SpMV). The preconditioner is Jacobi
    plus the low-rank spectral term built from the Ritz pairs of
    (-L, diag(av)): with u_i = av^{-1/2} q_i, A_a u_i ~ (w_i - shift_a)
    diag(av) u_i, so M^-1 = J^-1 + S Q diag(1/(w - shift_a)) Q^T S (SPD,
    congruent form) collapses the slow low-frequency tail for every shift
    at once, at the cost of two thin (T+1,V)x(V,k) GEMMs per iteration.

    Stopping is PER SHIFT: each of the T+1 systems terminates against its
    own ||b_a|| (an aggregate criterion would let a dominant-norm shift
    either mask under-converged small-norm shifts or keep every converged
    shift iterating). Converged rows are frozen (alpha = beta = 0) so their
    x stops drifting while the remaining rows share the batched SpMV.

    Singular rows (Neumann null space at shift = 0) are deflated by
    projecting out the constant. Warm-startable via x0 (the previous outer
    iteration's phi). `rtol=None` reads the traced `op.rtol`, which the
    host adapts to the outer iALM error between dispatches.

    space_sharded : the problem's vertex axis is partitioned over a device
    mesh but no halo tables exist. The ELL gather indexes globally, which
    GSPMD can only resolve by all-gathering x every matvec -- route through
    the incidence-form `laplacian_apply` instead (partitionable reductions).

    Mixed-precision refinement: when the operator carries f64 leaves
    (`build_cg_operator(refine=True)`) and the work dtype is narrower than
    f64, the solve runs classic iterative refinement -- the TRUE residual
    r = b - A x is evaluated in f64 (x and the accumulated solution held in
    f64), and each correction is solved by the f32 inner CG below.
    Finite-precision CG floors the true residual at
    ~eps_work * ||A|| ||x|| regardless of the recursive-residual tolerance;
    each refinement pass shrinks the correction norm, so the floor drops
    geometrically (~eps32 * cond(A) per pass) until the f64 target is met.
    The returned x is f64. Cost: one f64 ELL matvec per pass (1-2 passes
    after the warm start) on top of the unchanged f32 inner iterations.
    """
    if rtol is None:
        rtol = op.rtol
    rtol = jnp.asarray(rtol, dtype=rhs.dtype)
    has_deflation = op.defl_q.shape[-1] > 0

    # Refinement on a space-sharded problem needs the f64 SurfaceOps
    # (`ProblemData.ops_hi`) for the partitionable incidence-form true
    # residual; unsharded refinement keeps the cheaper f64 ELL matvec.
    sharded_space = halo is not None or space_sharded
    use_refine = op.ell_w_hi is not None and (
        not sharded_space or ops_hi is not None
    )
    # The refinement's inner correction solves always run in f32 --
    # including for f64 rhs, where refinement restores full f64
    # true-residual accuracy around them. Without refinement the solve runs
    # in the rhs dtype.
    work = jnp.float32 if use_refine else rhs.dtype

    jacobi = op.jacobi.astype(work)
    defl_q = op.defl_q.astype(work)
    s_vec = op.s.astype(work)
    av_vec = ops.av.astype(work)
    shifts_w = op.shifts.astype(work)
    defl_winv_w = op.defl_winv.astype(work)
    ell_w_work = op.ell_w.astype(work)

    # Real-vertex mask (padding slots excluded from the null-space
    # projection; see `CGOperator.real_mask`).
    real = (
        op.real_mask
        if op.real_mask is not None
        else jnp.ones_like(op.s)
    )
    n_real = real.sum()

    def deflate(v):
        # Singular rows (-L at shift=0): the padded system's null space is
        # the constant over REAL vertices plus one axis per padding slot;
        # consistency projects both out of b (and keeps x orthogonal).
        rm = real.astype(v.dtype)
        nr = op.null_row.astype(v.dtype)[:, None]
        mean = (v * rm[None, :]).sum(axis=1, keepdims=True) / n_real.astype(
            v.dtype
        )
        v = v - nr * mean
        return jnp.where(nr > 0, v * rm[None, :], v)

    def matvec(x):
        if halo is None and not space_sharded:
            # Padded-ELL SpMV: one fixed-width neighbor gather per vertex.
            # ~3x less HBM traffic than composing div(area * grad(x))
            # through the (T+1, F, 3) corner-slot intermediates. Weights in
            # the work dtype (an f64 operator under refinement runs its
            # inner corrections in f32).
            lap = ell_matvec(op, x, weights=ell_w_work)
        else:
            # Space-sharded blocked layout: the halo-exchange incidence ops
            # keep the gather shard-local (ELL neighbor lists would reach
            # across shard boundaries); without halo tables, the incidence
            # form still partitions without per-matvec all-gathers.
            lap = laplacian_apply(ops, x, halo, mesh_axes, (None,))
        return -(lap + shifts_w[:, None] * av_vec[None, :] * x)

    def precond(r):
        z = jacobi * r
        if has_deflation:
            coef = (s_vec[None, :] * r) @ defl_q  # (T+1, k)
            z = z + s_vec[None, :] * ((coef * defl_winv_w) @ defl_q.T)
        return z

    # Per-shift threshold, capped at the mean row norm: every row with
    # above-average ||b_a|| must meet its own relative tolerance (the
    # batch-summed criterion let a dominant-norm shift end them early),
    # while below-average rows only need the absolute accuracy the
    # aggregate solution requires (rtol * sqrt(mean ||b||^2)) -- demanding
    # their own relative tolerance over-solves the ill-conditioned
    # small-norm shifts by orders of magnitude at loose inexact-ALM
    # tolerances (measured 200-iteration CG stalls at V=46k). Guarantees
    # sum(res^2) <= 2 rtol^2 sum(||b||^2): strictly stronger per row than
    # the aggregate criterion, within a bounded factor of it in cost. The
    # mean also floors (near-)zero-RHS rows against rounding noise.
    def row_thresh(b, tol):
        b_norm_row = (b * b).sum(axis=1, keepdims=True)  # (T+1, 1)
        return tol * tol * jnp.maximum(b_norm_row, b_norm_row.mean())

    def pcg_core(b, x, thresh):
        """Inner PCG in the work dtype; b/x in eigenbasis.
        Frozen (converged) rows keep p and rz unchanged so they resume
        consistently if re-activated; beta = 0 there avoids rz_new/rz ~ 1
        blowing p up. The singular (shift ~ 0) row is re-deflated every
        iteration: f32 matvec rounding at tiny refinement-correction scales
        injects null-space components that CG cannot reduce and that
        eventually drive p^T A p negative -- measured breakdown to NaN at
        inner iteration ~43 without this."""
        r = deflate(b - matvec(x))
        z = precond(r)
        p = z
        rz = (r * z).sum(axis=1, keepdims=True)

        def body(state):
            x, r, p, rz, it = state
            active = (r * r).sum(axis=1, keepdims=True) > thresh
            ap = matvec(p)
            den = (p * ap).sum(axis=1, keepdims=True)
            # den <= 0 on an active row is rounding-level breakdown on the
            # singular shift: freeze the row this iteration instead of
            # amplifying noise through a huge/negative step. The same mask
            # must govern the beta/p/rz updates -- with alpha = 0, r is
            # unchanged, so rz_new == rz would give beta == 1 and p = z + p
            # would grow every iteration while the row makes no progress.
            step = active & (den > 0)
            alpha = jnp.where(step, rz / jnp.maximum(den, 1e-30), 0.0)
            x = x + alpha * p
            r = deflate(r - alpha * ap)
            z = precond(r)
            rz_new = (r * z).sum(axis=1, keepdims=True)
            beta = jnp.where(step, rz_new / jnp.maximum(rz, 1e-30), 0.0)
            p = jnp.where(step, z + beta * p, p)
            rz = jnp.where(step, rz_new, rz)
            return x, r, p, rz, it + 1

        def cond(state):
            _, r, _, _, it = state
            res_row = (r * r).sum(axis=1, keepdims=True)
            return jnp.logical_and(it < max_iters, jnp.any(res_row > thresh))

        x, _, _, _, iters = jax.lax.while_loop(cond, body, (x, r, p, rz, 0))
        return x, iters

    if not use_refine:
        b = deflate(-(op.u_time.T @ rhs))
        x = jnp.zeros_like(b) if x0 is None else op.u_time.T @ x0
        x, iters = pcg_core(b, x, row_thresh(b, rtol))
        x = op.u_time @ deflate(x)
        return (x, iters) if return_iters else x

    # ---- mixed-precision iterative refinement ------------------------------
    f64 = jnp.float64
    ut = op.u_time_hi
    b64 = deflate(-(ut.T @ rhs.astype(f64)))
    x64 = jnp.zeros_like(b64) if x0 is None else deflate(ut.T @ x0.astype(f64))
    thresh64 = row_thresh(b64, rtol.astype(f64))
    thresh_w = thresh64.astype(work)

    def matvec_hi(x):
        if sharded_space:
            # f64 halo/incidence matvec: shard-local gathers + one
            # boundary-sized all-gather per application (the ELL gather's
            # global indices would all-gather x under GSPMD). The f64
            # incidence composition div(area_f * grad(x)) equals the
            # assembled f64 cotan matrix to rounding.
            lap = laplacian_apply(ops_hi, x, halo, mesh_axes, (None,))
        else:
            lap = ell_matvec(op, x, weights=op.ell_w_hi)
        return -(lap + op.shifts_hi[:, None] * op.av_hi[None, :] * x)

    max_refine = 6
    # Per-pass relative target (squared): each correction solve only has
    # to shrink the true residual ~2 decades; the outer loop re-checks in
    # f64 and runs another pass if needed. Solving every correction to the
    # FINAL absolute target instead makes the f32 inner CG grind against
    # its own recursive-residual floor -- measured ~214 inner iterations
    # per outer at rtol 5e-6, V=46k, where two 30-iteration passes suffice.
    eta2 = jnp.asarray(1e-4)

    def body(carry):
        x64, total, passes, _ = carry
        r64 = deflate(b64 - matvec_hi(x64))
        unmet = jnp.any((r64 * r64).sum(axis=1, keepdims=True) > thresh64)

        def correct(x64, total):
            r_w = r64.astype(work)
            thresh_pass = jnp.maximum(
                thresh_w,
                eta2.astype(work)
                * (r_w * r_w).sum(axis=1, keepdims=True),
            )
            d, it = pcg_core(r_w, jnp.zeros_like(r_w), thresh_pass)
            return x64 + d.astype(f64), total + it

        x64, total = jax.lax.cond(
            unmet, correct, lambda x, t: (x, t), x64, total
        )
        return x64, total, passes + 1, ~unmet

    def cond(carry):
        _, _, passes, done = carry
        return (~done) & (passes < max_refine)

    x64, iters, _, _ = jax.lax.while_loop(
        cond, body, (x64, jnp.asarray(0, jnp.int32), jnp.int32(0), False)
    )
    x = ut @ deflate(x64)
    return (x, iters) if return_iters else x
