"""Batched per-row ridge solvers — the device replacement for the reference's
per-row OpenMP kernels.

Every ALS half-iteration in cmfrec boils down to, for each row i:

    (G0 + sum_l cw[i,l] * M[idx[i,l]] M[idx[i,l]]^T + diag(lam_i)) a_i
        = r0_i + sum_l cv[i,l] * M[idx[i,l]]

where M is the (extended) opposing factor matrix and (cw, cv) encode the
model variant:

  explicit      cw = w,            cv = w * (x - opp_bias - ...)   (ref:
                /root/reference/src/common.c:546 factors_closed_form)
  implicit/WRMF cw = alpha*x,      cv = (1 + alpha*x), G0 += M^T M (ref:
                /root/reference/src/common.c:2063 factors_implicit_chol)
  NA-as-zero    cw = w - 1,        cv = w * x,         G0 += M^T M

All rows in a padded bucket are solved together as one batched device
program: gather -> batched Gram einsum -> batched Cholesky, or a
fixed-step batched conjugate gradient (matching ``max_cg_steps``,
/root/reference/src/common.c:1098), or batched coordinate descent for
non-negativity / L1 (/root/reference/src/common.c:2131,2228).

Note on implicit CG: the reference's warm-start residual deviates from the
system its own Cholesky path solves (the ``-(coef-1)*Xa - coef`` term at
/root/reference/src/common.c:1936-1941 is off by ``(1+coef)*B_j`` versus the
Frederickson formulation it cites), so its CG converges to a slightly
different fixed point.  We implement the exact residual; our CG therefore
converges to the same solution as the Cholesky path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import SOLVER_PRECISION


class SparsePart(NamedTuple):
    """One gathered sparse contribution to a batch of row systems.

    mat: [S, K] extended opposing factor matrix (gather source)
    idx: [R, L] int32 indices into mat (0-padded)
    cw:  [R, L] Gram coefficients (0 on padding)
    cv:  [R, L] rhs coefficients  (0 on padding)
    """

    mat: jax.Array
    idx: jax.Array
    cw: jax.Array
    cv: jax.Array


def length_mask(length: jax.Array, width: int) -> jax.Array:
    """[R] lengths -> [R, width] validity mask."""
    return (
        jax.lax.broadcasted_iota(jnp.int32, (length.shape[0], width), 1)
        < length[:, None]
    )


def gather_rows(mat: jax.Array, idx: jax.Array, mxu_bf16: bool = False) -> jax.Array:
    """[S, K], [R, L] -> [R, L, K].  With mxu_bf16 the opposing matrix is
    cast to bf16 BEFORE the gather, halving both the gathered bytes and the
    einsum traffic (products stay exact in the f32 accumulator; only the
    factor values round, ~0.4% — the same trade the dense engine makes)."""
    if mxu_bf16:
        mat = mat.astype(jnp.bfloat16)
    return jnp.take(mat, idx, axis=0, unique_indices=False, indices_are_sorted=False)


def _ein(*args, bf16: bool):
    if bf16:
        return jnp.einsum(*args, preferred_element_type=jnp.float32)
    return jnp.einsum(*args, precision=SOLVER_PRECISION)


def part_gram(part: SparsePart, mxu_bf16: bool = False) -> jax.Array:
    """[R, K, K] Gram contribution: sum_l cw * m m^T."""
    ms = gather_rows(part.mat, part.idx, mxu_bf16)
    lhs = ms * part.cw[..., None].astype(ms.dtype) if mxu_bf16 else ms * part.cw[..., None]
    return _ein("rlk,rlm->rkm", lhs.astype(ms.dtype), ms, bf16=mxu_bf16)


def part_rhs(part: SparsePart, mxu_bf16: bool = False) -> jax.Array:
    """[R, K] rhs contribution: sum_l cv * m."""
    ms = gather_rows(part.mat, part.idx, mxu_bf16)
    cv = part.cv.astype(ms.dtype) if mxu_bf16 else part.cv
    return _ein("rlk,rl->rk", ms, cv, bf16=mxu_bf16)


def _part_matvec(ms: jax.Array, cw: jax.Array, p: jax.Array) -> jax.Array:
    """[R, L, K] gathered rows, [R, L] coefs, [R, K] vec -> [R, K]."""
    bf16 = ms.dtype == jnp.bfloat16
    t = _ein("rlk,rk->rl", ms, p.astype(ms.dtype), bf16=bf16) * cw
    return _ein("rl,rlk->rk", t.astype(ms.dtype), ms, bf16=bf16)


def assemble_system(
    parts: list[SparsePart],
    lam_vec: jax.Array,  # [K]
    lam_mult: Optional[jax.Array] = None,  # [R] per-row lam scaling or None
    G0: Optional[jax.Array] = None,  # [K, K] shared Gram base
    r0: Optional[jax.Array] = None,  # [R, K] per-row rhs base
    mxu_bf16: bool = False,
    ring_mesh=None,  # jax.sharding.Mesh: keep each part's opposing matrix
    # row-sharded and assemble via the ppermute ring (parallel/ring.py) —
    # the big-axis path when the opposing matrix does not fit one chip.
):
    """Build the dense batched (G, rhs) for Cholesky / CD solving."""
    R = parts[0].idx.shape[0] if parts else r0.shape[0]
    K = parts[0].mat.shape[1] if parts else r0.shape[1]
    dt = parts[0].mat.dtype if parts else r0.dtype
    if dt == jnp.bfloat16:
        dt = jnp.float32
    G = jnp.zeros((R, K, K), dt)
    rhs = jnp.zeros((R, K), dt)
    for p in parts:
        # Ring assembly exists to avoid materializing a BIG opposing
        # matrix on every chip; small opposing matrices (side-info C/D,
        # a few hundred rows) are cheaper to gather directly — the ring
        # would pay ~mesh-size masked passes to avoid replicating a few
        # hundred KB (GSPMD inserts the all-gather when the matrix is
        # sharded, which is fine at that size).
        ring_this = (ring_mesh is not None
                     and p.mat.shape[0] >= 8 * int(ring_mesh.size))
        if ring_this:
            from ..parallel.ring import pad_rows_to, ring_part_system

            Gp, rp = ring_part_system(
                pad_rows_to(p.mat, int(ring_mesh.size)), p.idx, p.cw, p.cv,
                mesh=ring_mesh, mxu_bf16=mxu_bf16,
            )
            G = G + Gp.astype(dt)
            rhs = rhs + rp.astype(dt)
            continue
        G = G + part_gram(p, mxu_bf16)
        rhs = rhs + part_rhs(p, mxu_bf16)
    if G0 is not None:
        G = G + G0[None, :, :]
    if r0 is not None:
        rhs = rhs + r0
    lam_row = lam_vec[None, :] if lam_mult is None else lam_vec[None, :] * lam_mult[:, None]
    G = G + jnp.einsum("rk,km->rkm", lam_row, jnp.eye(K, dtype=dt))
    return G, rhs


def solve_chol(G: jax.Array, rhs: jax.Array) -> jax.Array:
    """Batched SPD solve via Cholesky (the reference's tposv_,
    /root/reference/src/common.c:1045)."""
    L = jax.lax.linalg.cholesky(G)
    y = jax.lax.linalg.triangular_solve(
        L, rhs[..., None], left_side=True, lower=True, transpose_a=False
    )
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x[..., 0]


def solve_shared_chol(G: jax.Array, rhs: jax.Array) -> jax.Array:
    """All rows share ONE [K, K] SPD system matrix (NA-as-zero style
    half-steps, /root/reference/src/common.c:3118 optimizeA case 3 and the
    implicit-feature Bi/Ai solves, collective.c:8479/8520): one Cholesky
    factorization, two triangular solves over the [R, K] rhs."""
    L = jax.lax.linalg.cholesky(G)
    y = jax.lax.linalg.triangular_solve(L, rhs.T, left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x.T


def solve_cg(
    parts: list[SparsePart],
    lam_vec: jax.Array,
    a0: jax.Array,  # [R, K] warm start (previous factors)
    n_steps: int,
    lam_mult: Optional[jax.Array] = None,
    G0: Optional[jax.Array] = None,
    r0: Optional[jax.Array] = None,
    rel_tol: float = 1e-12,
    jacobi: bool = False,
    mxu_bf16: bool = False,
) -> jax.Array:
    """Batched truncated CG, warm-started, matching the reference's
    ``max_cg_steps``-step truncation (/root/reference/src/common.c:1098).
    With ``jacobi=True`` runs diagonally-preconditioned PCG instead
    (``precondition_cg``, /root/reference/src/common.c:1190
    factors_explicit_pcg).

    DELIBERATE DIVERGENCE (collective PCG only): our preconditioner is
    the true Jacobi diagonal of the system being solved (w_user-scaled
    CtC, w_implicit-scaled BiTBi included via G0/parts).  The reference's
    collective_block_cg builds its PC from the RAW Grams instead — no
    w_user on CtC (collective.c:2266), BiTBi built with 1.0 under CG
    (:1493) — so collective PCG trajectories differ from the binary
    (plain-model PCG pins exactly; see test_explicit_pcg_vs_binary).
    Both preconditioners are SPD and reach optima of equal objective
    quality (test_collective_pcg_objective_quality_vs_binary).

    Early per-row termination (residual below tolerance) is realized by
    masking the step size to zero, which freezes converged rows without
    breaking the static loop structure.
    """
    dt = a0.dtype
    R, K = a0.shape
    lam_row = (
        lam_vec[None, :] if lam_mult is None else lam_vec[None, :] * lam_mult[:, None]
    )
    gathered = [(gather_rows(p.mat, p.idx, mxu_bf16), p.cw) for p in parts]

    def matvec(v):
        out = v * lam_row
        if G0 is not None:
            out = out + jnp.einsum("km,rm->rk", G0, v, precision=SOLVER_PRECISION)
        for ms, cw in gathered:
            out = out + _part_matvec(ms, cw, v)
        return out

    rhs = jnp.zeros((R, K), dt)
    for p, (ms, _) in zip(parts, gathered):
        cv = p.cv.astype(ms.dtype) if mxu_bf16 else p.cv
        rhs = rhs + _ein("rlk,rl->rk", ms, cv, bf16=mxu_bf16)
    if r0 is not None:
        rhs = rhs + r0

    if jacobi:
        diag = jnp.broadcast_to(lam_row, (R, K))
        if G0 is not None:
            diag = diag + jnp.einsum("kk->k", G0)[None, :]
        for ms, cw in gathered:
            diag = diag + jnp.einsum(
                "rlk,rl->rk", ms * ms, cw, precision=SOLVER_PRECISION
            )
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0), 1.0)
    else:
        inv_diag = None

    def precond(r):
        return r if inv_diag is None else r * inv_diag

    r = rhs - matvec(a0)
    z = precond(r)
    rz0 = jnp.sum(r * z, axis=-1)
    # Two-tolerance stopping, matching the reference exactly
    # (/root/reference/src/common.c:1147,1181): skip rows already below
    # 1e-12, and stop a row once its post-step residual falls below 1e-8.
    # The reference's PCG variant (factors_explicit_pcg, common.c:1198)
    # has NO stopping tests — it always runs max_cg_steps — so under
    # jacobi we only guard against zero denominators.
    live0 = (jnp.ones((R,), bool) if jacobi
             else rz0 > jnp.asarray(rel_tol, dt))

    def body(carry, _):
        a, r, p, rz, live = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap, axis=-1)
        alpha = jnp.where(live, rz / jnp.where(denom == 0, 1, denom), 0.0)
        a = a + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z, axis=-1)
        if not jacobi:
            live = live & (rz_new > 1e-8)
        beta = jnp.where(live, rz_new / jnp.where(rz == 0, 1, rz), 0.0)
        p = jnp.where(live[:, None], z + beta[:, None] * p, p)
        return (a, r, p, jnp.where(live, rz_new, rz), live), None

    (a, _, _, _, _), _ = jax.lax.scan(
        body, (a0, r, z, rz0, live0), None, length=n_steps
    )
    return a


def solve_cd(
    G: jax.Array,  # [R, K, K] WITHOUT l1 but WITH lam on diag
    rhs: jax.Array,  # [R, K]
    l1_vec: jax.Array,  # [K] or [R, K] l1 penalty per coordinate (may be 0;
    # 2-D for per-row scaling under scale_lam, common.c:717-722)
    nonneg: bool,
    max_steps: int,
    a0: Optional[jax.Array] = None,
    tol: float = 1e-9,
) -> jax.Array:
    """Batched cyclic coordinate descent: non-negative least squares and/or
    elastic net, matching solve_nonneg / solve_elasticnet
    (/root/reference/src/common.c:2131,2228).

    Minimizes 0.5 a^T G a - rhs^T a + l1^T |a| (optionally s.t. a >= 0).
    """
    R, K = rhs.shape
    dt = rhs.dtype
    a = jnp.zeros((R, K), dt) if a0 is None else a0
    diag = jnp.einsum("rkk->rk", G)
    safe_diag = jnp.where(diag <= 0, 1.0, diag)

    def sweep(carry, _):
        a, max_delta_prev, done = carry

        def coord(kk, acc):
            a, max_delta = acc
            g_k = jax.lax.dynamic_index_in_dim(G, kk, axis=1, keepdims=False)  # [R,K]
            a_k = jax.lax.dynamic_index_in_dim(a, kk, axis=1, keepdims=False)  # [R]
            d_k = jax.lax.dynamic_index_in_dim(safe_diag, kk, axis=1, keepdims=False)
            r_k = jax.lax.dynamic_index_in_dim(rhs, kk, axis=1, keepdims=False)
            if l1_vec.ndim == 2:
                l1_k = jax.lax.dynamic_index_in_dim(
                    l1_vec, kk, axis=1, keepdims=False
                )
            else:
                l1_k = l1_vec[kk]
            # gradient excluding own coordinate
            num = r_k - jnp.sum(g_k * a, axis=-1) + a_k * jax.lax.dynamic_index_in_dim(
                g_k, kk, axis=1, keepdims=False
            )
            if nonneg:
                new = jnp.maximum(num - l1_k, 0.0) / d_k
            else:
                new = (
                    jnp.sign(num) * jnp.maximum(jnp.abs(num) - l1_k, 0.0) / d_k
                )
            new = jnp.where(done, a_k, new)
            a = jax.lax.dynamic_update_index_in_dim(a, new, kk, axis=1)
            max_delta = jnp.maximum(max_delta, jnp.abs(new - a_k))
            return a, max_delta

        a, max_delta = jax.lax.fori_loop(0, K, coord, (a, jnp.zeros(R, dt)))
        done = done | (max_delta <= tol)
        return (a, max_delta, done), None

    (a, _, _), _ = jax.lax.scan(
        sweep, (a, jnp.zeros(R, dt), jnp.zeros(R, bool)), None, length=max_steps
    )
    return a
