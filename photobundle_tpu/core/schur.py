"""Gauss-Newton normal equations + Schur complement — the reference's L1.

JAX replacement for Ceres' `SPARSE_SCHUR` linear solver with
points-first elimination (reference: pb:src/photobundle.cc solver options;
SURVEY.md sections 1/3.3). Ceres builds sparse block matrices and runs a
sparse Schur eliminator on CPU threads. Here the normal equations are built
directly from the factored residual statistics (core/residuals.py) as fused
elementwise contractions, so the entire elimination is batched dense
algebra:

    Hpp  (3, 3, N)    per-point blocks         -> batched closed-form inverse
    Hpc  (W, 3, 6, N) point-pose coupling      -> unrolled fused multiplies
    Hcc  (W, 6, 6)    pose diagonal blocks     -> one contraction over 3N
    S    (W, W, 6, 6) reduced camera system    -> one contraction over 3N
    solve 6W x 6W     dense Cholesky (W is the sliding window: tiny)

LAYOUT: every big per-point tensor keeps the POINT axis MINOR (last), so
each is a stack of dense (N,) planes and the per-point algebra runs as
fused elementwise work over contiguous memory.

Invalid observations contribute exact zeros (residuals are pre-masked), so
no index lists or scatters are needed — this is what makes the same code
shard over a device mesh with one `psum` (parallel/sharded.py).

Damping follows Ceres' LEVENBERG_MARQUARDT: H + lam * diag(H) with the
diagonal clamped, applied consistently to the eliminated point blocks and
the reduced system (SURVEY.md 'hard parts').
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .residuals import CompressedResiduals, Residuals

_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32


class NormalEq(NamedTuple):
    """Point-minor layout (see module docstring)."""

    hpp: jax.Array    # (3, 3, N)
    hpc: jax.Array    # (W, 3, 6, N)
    hcc: jax.Array    # (W, 6, 6)
    bp: jax.Array     # (3, N)   right-hand side -J^T r (point part)
    bc: jax.Array     # (W, 6)   right-hand side -J^T r (pose part)


class NormalEqDense(NamedTuple):
    """Point-major layout — the small-problem/test oracle layout."""

    hpp: jax.Array    # (N, 3, 3)
    hpc: jax.Array    # (N, W, 3, 6)
    hcc: jax.Array    # (W, 6, 6)
    bp: jax.Array     # (N, 3)
    bc: jax.Array     # (W, 6)


def to_point_major(eq: NormalEq) -> NormalEqDense:
    return NormalEqDense(
        hpp=jnp.transpose(eq.hpp, (2, 0, 1)),
        hpc=jnp.transpose(eq.hpc, (3, 0, 1, 2)),
        hcc=eq.hcc, bp=jnp.transpose(eq.bp, (1, 0)), bc=eq.bc)


def to_point_minor(eq: NormalEqDense) -> NormalEq:
    return NormalEq(
        hpp=jnp.transpose(eq.hpp, (1, 2, 0)),
        hpc=jnp.transpose(eq.hpc, (1, 2, 3, 0)),
        hcc=eq.hcc, bp=jnp.transpose(eq.bp, (1, 0)), bc=eq.bc)


def build_normal_equations(res: Residuals) -> NormalEqDense:
    """Oracle path from the dense (N, W, D, ·) residual tensor — tests and
    tiny problems only. Each einsum is a batched matmul; masked entries are
    exact zeros."""
    jp, jc, r = res.j_point, res.j_pose, res.r
    hpp = jnp.einsum("nwdi,nwdj->nij", jp, jp)
    hpc = jnp.einsum("nwdi,nwdj->nwij", jp, jc)
    hcc = jnp.einsum("nwdi,nwdj->wij", jc, jc)
    bp = -jnp.einsum("nwdi,nwd->ni", jp, r)
    bc = -jnp.einsum("nwdi,nwd->wi", jc, r)
    return NormalEqDense(hpp=hpp, hpc=hpc, hcc=hcc, bp=bp, bc=bc)


def build_normal_equations_compressed(res: CompressedResiduals) -> NormalEq:
    """Normal equations from the rank-2-factored statistics
    (residuals.evaluate_compressed, point-minor layout): per observation

        H_obs = A^T gtg A + jp jp^T          (9, 9)
        b_obs = -(A^T gtr + rp * jp)         (9,)

    partitioned into Hpp / Hpc / Hcc / bp / bc and summed over frames /
    points. Only the needed blocks are formed (never the full 9x9): the
    per-point blocks as fused elementwise multiplies over dense (W, N)
    planes, the pose blocks as one dot_general contracting (2+1)N.
    Identical result to build_normal_equations(evaluate(...)). Without an
    inverse-depth prior the jp/rp rows are exact zeros and contribute
    nothing."""
    a, gtg, gtr = res.a, res.gtg, res.gtr          # (W,2,9,N) (W,2,2,N) (W,2,N)
    jp, rp = res.jp, res.rp                        # (W, 9, N) (W, N)
    # ga[w,b,j,n] = sum_a gtg[w,b,a,n] * a[w,a,j,n]
    ga = (gtg[:, :, 0][:, :, None] * a[:, 0][:, None]
          + gtg[:, :, 1][:, :, None] * a[:, 1][:, None])     # (W, 2, 9, N)

    # All blocks as broadcast-multiply-reduce over point-minor planes. NOT
    # einsum/dot_general: a contraction whose OUTPUT keeps the N axis free
    # lowers as a batched-over-N dot, with the operands transposed into
    # point-major batch layouts.
    # Pose diagonal blocks (N contracted — a true matrix product).
    rows_c = jnp.concatenate([a[:, :, :6], jp[:, None, :6]], axis=1)
    cols_c = jnp.concatenate([ga[:, :, :6], jp[:, None, :6]], axis=1)
    hcc = jnp.einsum("wbin,wbjn->wij", rows_c, cols_c)       # (W, 6, 6)

    ap, gap, jpp = a[:, :, 6:], ga[:, :, 6:], jp[:, 6:]      # (W,2,3,N), (W,3,N)
    hpp = (jnp.sum(ap[:, :, :, None] * gap[:, :, None], axis=(0, 1))
           + jnp.sum(jpp[:, :, None] * jpp[:, None], axis=0))  # (3, 3, N)
    hpc = (jnp.sum(ap[:, :, :, None] * ga[:, :, None, :6], axis=1)
           + jpp[:, :, None] * jp[:, None, :6])              # (W, 3, 6, N)

    b_obs = -(jnp.sum(a * gtr[:, :, None], axis=1) + jp * rp[:, None])
    bp = jnp.sum(b_obs[:, 6:], axis=0)                       # (3, N)
    bc = jnp.sum(b_obs[:, :6], axis=-1)                      # (W, 6)
    return NormalEq(hpp=hpp, hpc=hpc, hcc=hcc, bp=bp, bc=bc)


def _damped(h: jax.Array, lam: jax.Array) -> jax.Array:
    """H + lam * clamp(diag(H)) * I for (..., k, k) blocks."""
    d = jnp.clip(jnp.diagonal(h, axis1=-2, axis2=-1), _DIAG_MIN, _DIAG_MAX)
    k = h.shape[-1]
    return h + lam * d[..., None] * jnp.eye(k, dtype=h.dtype)


def _damped_nlast(h: jax.Array, lam: jax.Array) -> jax.Array:
    """Same for the (3, 3, N) point-minor layout."""
    eye = jnp.eye(h.shape[0], dtype=h.dtype)[:, :, None]
    d = jnp.stack([h[i, i] for i in range(h.shape[0])])      # (3, N)
    d = jnp.clip(d, _DIAG_MIN, _DIAG_MAX)
    return h + lam * d[:, None, :] * eye


def inv3x3(m: jax.Array, valid: jax.Array | None = None, eps: float = 1e-12) -> jax.Array:
    """Batched closed-form (adjugate) 3x3 inverse, (..., 3, 3) layout.
    Singular or invalid blocks return zeros, which makes the corresponding
    point update zero — the masked-point mechanism of the static-shape
    design."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    ok = jnp.abs(det) > eps
    if valid is not None:
        ok = ok & valid
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    adj = jnp.stack(
        [
            jnp.stack([ca, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([cb, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([cc, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def inv3x3_nlast(m: jax.Array, valid: jax.Array | None = None,
                 eps: float = 1e-12) -> jax.Array:
    """inv3x3 for the (3, 3, N) point-minor layout — every component is a
    dense (N,) vector, so the closed form is 40-odd fused elementwise
    ops."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    ok = jnp.abs(det) > eps
    if valid is not None:
        ok = ok & valid
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    adj = jnp.stack(
        [
            jnp.stack([ca, c * h - b * i, b * f - c * e]),
            jnp.stack([cb, a * i - c * g, c * d - a * f]),
            jnp.stack([cc, b * g - a * h, a * e - b * d]),
        ]
    )
    return adj * inv_det


class SchurSystem(NamedTuple):
    s: jax.Array          # (6W, 6W) reduced camera matrix (gauge-fixed)
    rhs: jax.Array        # (6W,)
    hpp_inv: jax.Array    # (3, 3, N) damped inverses (for back-substitution)
    hpc_d: jax.Array      # (W, 3, 6, N) (damped coupling, = hpc)
    bp: jax.Array         # (3, N)


def reduce_camera_system(eq: NormalEq, lam: jax.Array, point_valid: jax.Array,
                         frozen: jax.Array, reduce_fn=None,
                         pose_coupling: jax.Array | None = None) -> SchurSystem:
    """Eliminate point blocks; assemble the reduced (6W, 6W) camera system.

    frozen: (W,) bool — gauge-fixed poses (identity rows/cols, zero rhs).
    point_valid: (N,) bool — points that may move.
    reduce_fn: cross-shard sum (e.g. lax.psum) applied to the point-summed
        Schur terms only — `eq.hcc`/`eq.bc` must ALREADY be globally reduced
        by the caller, so the distributed Schur reduction is exactly one
        psum of a (W, W, 6, 6) + (W, 6) contribution per shard
        (SURVEY.md section 5.7: the 'ring-attention of BA').
    """
    if reduce_fn is None:
        reduce_fn = lambda x: x
    w = eq.hcc.shape[0]
    hpp_inv = inv3x3_nlast(_damped_nlast(eq.hpp, lam), point_valid)  # (3,3,N)
    # T[w, i, k, n] = sum_j W_p[i, j, n] Hpc[w, j, k, n] — fused broadcast
    # multiplies (a free-minor-N einsum would transpose to point-major).
    t = jnp.sum(hpp_inv[None, :, :, None] * eq.hpc[:, None], axis=2)
    # (W, 3, 6, N)
    # S[f, g] -= sum_{j,n} Hpc[f, j, i, n] T[g, j, k, n]: ONE contraction
    # of size 3N.
    s_off = reduce_fn(jnp.einsum("fjin,gjkn->fgik", eq.hpc, t))
    hcc_d = _damped(eq.hcc, lam)
    s = -s_off
    s = s.at[jnp.arange(w), jnp.arange(w)].add(hcc_d)
    if pose_coupling is not None:
        # Off-diagonal pose-pose blocks (e.g. the relative-motion prior);
        # replicated — must NOT go through reduce_fn.
        s = s + pose_coupling
    rhs = eq.bc - reduce_fn(jnp.einsum("fjin,jn->fi", t, eq.bp))  # (W, 6)

    # Gauge fixing: frozen pose blocks become identity rows/cols with zero
    # rhs, so their update is exactly zero. Must be identical on every shard
    # (SURVEY.md 'hard parts': gauge handling across shards) — `frozen` is
    # replicated, so it is.
    free = (~frozen).astype(s.dtype)
    mask2 = free[:, None] * free[None, :]                          # (W, W)
    s = s * mask2[:, :, None, None]
    s = s.at[jnp.arange(w), jnp.arange(w)].add(
        jnp.eye(6, dtype=s.dtype)[None] * frozen.astype(s.dtype)[:, None, None]
    )
    rhs = rhs * free[:, None]

    s_flat = s.transpose(0, 2, 1, 3).reshape(6 * w, 6 * w)
    return SchurSystem(s=s_flat, rhs=rhs.reshape(-1), hpp_inv=hpp_inv,
                       hpc_d=eq.hpc, bp=eq.bp)


def solve_reduced(sys: SchurSystem):
    """Cholesky solve of the reduced system; returns (dc (W,6), dp (N,3)).

    The reduced matrix is SPD after damping + gauge fixing; a tiny jitter
    guards float32 round-off. Back-substitution recovers point updates:
    dp = W_p (bp - Hpc dc) — all fused point-minor multiplies.
    """
    w6 = sys.s.shape[0]
    s = sys.s + 1e-8 * jnp.eye(w6, dtype=sys.s.dtype)
    chol = jax.scipy.linalg.cho_factor(s, lower=True)
    dc_flat = jax.scipy.linalg.cho_solve(chol, sys.rhs)
    dc = dc_flat.reshape(-1, 6)
    rhs_p = sys.bp - jnp.sum(sys.hpc_d * dc[:, None, :, None],
                             axis=(0, 2))                        # (3, N)
    dp = jnp.sum(sys.hpp_inv * rhs_p[None], axis=1)              # (3, N)
    return dc, dp.T


def solve_dense_full(eq, lam: jax.Array, point_valid: jax.Array,
                     frozen: jax.Array):
    """Reference oracle: assemble and solve the FULL (6W + 3N) system
    densely. O((6W + 3N)^3) — tests only (SURVEY.md section 4: Schur vs
    dense lstsq on tiny problems). Accepts either layout."""
    if isinstance(eq, NormalEq):
        eq = to_point_major(eq)
    n = eq.hpp.shape[0]
    w = eq.hcc.shape[0]
    dim = 6 * w + 3 * n
    h = jnp.zeros((dim, dim), eq.hpp.dtype)
    hcc_d = _damped(eq.hcc, lam)
    hpp_d = _damped(eq.hpp, lam)
    for f in range(w):
        h = h.at[6 * f:6 * f + 6, 6 * f:6 * f + 6].set(hcc_d[f])
    for p in range(n):
        o = 6 * w + 3 * p
        h = h.at[o:o + 3, o:o + 3].set(hpp_d[p])
        for f in range(w):
            h = h.at[o:o + 3, 6 * f:6 * f + 6].set(eq.hpc[p, f])
            h = h.at[6 * f:6 * f + 6, o:o + 3].set(eq.hpc[p, f].T)
    b = jnp.concatenate([eq.bc.reshape(-1), eq.bp.reshape(-1)])

    # Freeze gauge poses and invalid points by identity rows/cols.
    fixed = jnp.concatenate([
        jnp.repeat(frozen, 6),
        jnp.repeat(~point_valid, 3),
    ])
    free = (~fixed).astype(h.dtype)
    h = h * free[:, None] * free[None, :] + jnp.diag(fixed.astype(h.dtype))
    b = b * free
    sol = jnp.linalg.solve(h + 1e-8 * jnp.eye(dim, dtype=h.dtype), b)
    dc = sol[: 6 * w].reshape(w, 6)
    dp = sol[6 * w:].reshape(n, 3)
    return dc, dp


def predicted_reduction(eq: NormalEq, lam: jax.Array, dc: jax.Array, dp: jax.Array,
                        reduce_fn=None) -> jax.Array:
    """LM model decrease 0.5 * dx^T (lam * D dx + b) for the gain ratio
    (Madsen/Nielsen form), over both pose and point blocks. The point term
    sums over shard-local points and is cross-shard reduced; the pose term
    uses the already-replicated reduced blocks. dp: (N, 3)."""
    if reduce_fn is None:
        reduce_fn = lambda x: x
    d_c = jnp.clip(jnp.diagonal(eq.hcc, axis1=-2, axis2=-1), _DIAG_MIN, _DIAG_MAX)
    d_p = jnp.clip(jnp.stack([eq.hpp[0, 0], eq.hpp[1, 1], eq.hpp[2, 2]]),
                   _DIAG_MIN, _DIAG_MAX)                     # (3, N)
    dpt = dp.T                                               # (3, N)
    term_c = jnp.sum(dc * (lam * d_c * dc + eq.bc))
    term_p = reduce_fn(jnp.sum(dpt * (lam * d_p * dpt + eq.bp)))
    return 0.5 * (term_c + term_p)
