"""Batched ALS half-iteration drivers.

One "half-iteration" solves every row of one factor matrix given the others
(the reference's optimizeA / optimizeA_implicit / optimizeA_collective,
/root/reference/src/common.c:2742,3305, /root/reference/src/collective.c:4720).
Each degree bucket of rows becomes one statically-shaped batched
program: coefficient prep -> gather -> Gram/CG -> batched Cholesky or
truncated CG or coordinate descent.

A row system is assembled from up to two sparse *parts* (the X interactions
and, for the collective model, a sparse side-info matrix) plus a shared Gram
base G0 (BtB-style caches, dense side-info CtC, implicit-feature BiTBi) and a
per-row rhs base r0 (dense side-info U @ Ce).  See ops/rowsolve.py for the
system definition.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SOLVER_PRECISION
from ..data.shards import BucketedRows
from ..ops import rowsolve
from ..ops.rowsolve import SparsePart, length_mask


class PartData(NamedTuple):
    """Dynamic arrays of one sparse part for one bucket (pytree)."""

    idx: jax.Array  # [R, L]
    val: jax.Array  # [R, L]
    length: jax.Array  # [R]
    wgt: Optional[jax.Array]  # [R, L] or None
    opp: jax.Array  # [S, K] extended opposing matrix
    opp_bias: Optional[jax.Array]  # [S] or None
    w: jax.Array  # scalar part weight (w_main / w_user / ...)
    alpha: Optional[jax.Array]  # scalar, implicit confidence slope
    mu: Optional[jax.Array]  # scalar global mean (NA-as-zero centering)


def _coefficients(p: PartData, mode: str):
    """Map raw (val, wgt) to the unified (cw, cv) Gram/rhs coefficients.

    explicit:  cw = w*wgt, cv = w*wgt*(val - opp_bias)
               (/root/reference/src/common.c:546 factors_closed_form)
    implicit:  cw = w*alpha*val, cv = w*(1 + alpha*val)
               (/root/reference/src/common.c:2063 factors_implicit_chol)
    na0:       NA-as-zero explicit: cw = w*(wgt-1), cv = w*wgt*val;
               caller includes w * opp^T opp in G0
               (/root/reference/src/common.c:3118 optimizeA case 3)
    """
    msk = length_mask(p.length, p.idx.shape[1]).astype(p.val.dtype)
    if mode == "explicit":
        vadj = p.val if p.opp_bias is None else p.val - jnp.take(p.opp_bias, p.idx)
        cw = p.w * msk if p.wgt is None else p.w * p.wgt * msk
        cv = cw * vadj
    elif mode == "implicit":
        av = p.alpha * p.val
        cw = p.w * av * msk
        cv = p.w * (1.0 + av) * msk
    elif mode == "na0":
        # NA-as-zero explicit: missing entries participate with raw value 0
        # (i.e. centered target -mu - opp_bias).  The caller puts
        # w * opp^T opp into G0 and w * opp^T (-mu - opp_bias) into r0; here
        # we produce only the observed-entry corrections relative to that
        # base (the reference's bias_BtX trick,
        # /root/reference/src/collective.c:303-312).
        if p.wgt is None:
            cw = jnp.zeros_like(p.val)
        else:
            cw = p.w * (p.wgt - 1.0) * msk
        ob = jnp.zeros_like(p.val) if p.opp_bias is None else jnp.take(p.opp_bias, p.idx)
        mu = 0.0 if p.mu is None else p.mu
        vadj = p.val - ob
        wgt = 1.0 if p.wgt is None else p.wgt
        cv = p.w * (wgt * vadj + mu + ob) * msk
    else:
        raise ValueError(mode)
    return SparsePart(p.opp, p.idx, cw, cv)


def _lam_multiplier(p: PartData, mode: str, n_total: int):
    """Per-row lambda multiplier for scale_lam
    (/root/reference/src/common.c:689-724): observation count, weight sum,
    or the full column count under NA-as-zero."""
    if mode == "na0":
        if p.wgt is None:
            return jnp.full(p.idx.shape[0], float(n_total), p.val.dtype)
        # weighted NA-as-zero: wsum over observed + 1 per missing entry
        # (/root/reference/src/common.c:708-710)
        msk = length_mask(p.length, p.idx.shape[1]).astype(p.val.dtype)
        wsum = jnp.sum(p.wgt * msk, axis=1)
        return wsum + (float(n_total) - p.length.astype(p.val.dtype))
    msk = length_mask(p.length, p.idx.shape[1]).astype(p.val.dtype)
    if p.wgt is None:
        return p.length.astype(p.val.dtype)
    return jnp.sum(p.wgt * msk, axis=1)


@partial(
    jax.jit,
    static_argnames=(
        "modes",
        "method",
        "n_steps",
        "nonneg",
        "max_cd_steps",
        "scale_lam",
        "n_totals",
        "scale_parts",
        "precondition",
        "mxu_bf16",
        "lam_mult_add",
        "ring_mesh",
        "defer_solve",
    ),
)
def solve_bucket(
    parts: tuple,  # tuple of PartData
    a_prev: Optional[jax.Array],  # [R, K] warm start
    G0: Optional[jax.Array],  # [K, K]
    r0: Optional[jax.Array],  # [R, K]
    r0_vec: Optional[jax.Array],  # [K] shared rhs base (broadcast over rows)
    lam_vec: jax.Array,  # [K] (per-row-scaled if scale_lam)
    lam_const_vec: Optional[jax.Array],  # [K] additional unscaled diagonal
    l1_vec: Optional[jax.Array],  # [K] L1 penalties
    modes: tuple,  # static, one mode string per part
    method: str,  # "chol" | "cg"
    n_steps: int,
    nonneg: bool,
    max_cd_steps: int,
    scale_lam: bool,
    n_totals: tuple,  # static, per part: total column count (for na0 scaling)
    scale_parts: tuple = (),  # static, per part: counts toward lam scaling
    precondition: bool = False,  # Jacobi PCG (precondition_cg)
    mxu_bf16: bool = False,  # bf16 matmul operands (f32 accumulate)
    lam_mult_add: float = 0.0,  # constant added to the scale_lam multiplier
    # (dense side-info observation count, common.c:689-724)
    ring_mesh=None,  # Mesh: opposing matrices stay row-sharded; Gram/rhs
    # assembled by the ppermute ring (parallel/ring.py).  Chol/CD only.
    defer_solve: bool = False,  # Cholesky path only: return the assembled
    # (G, rhs, live) instead of solving, so the caller can concatenate all
    # buckets into ONE batched Cholesky (update_side) — fewer, larger
    # decompositions compile faster and batch better.
):
    sparse_parts = [_coefficients(p, m) for p, m in zip(parts, modes)]

    if r0_vec is not None:
        R = parts[0].idx.shape[0]
        base = jnp.broadcast_to(r0_vec[None, :], (R, r0_vec.shape[0]))
        r0 = base if r0 is None else r0 + base

    lam_mult = None
    if scale_lam:
        if not scale_parts:
            scale_parts = (True,) * len(parts)
        lam_mult = sum(
            _lam_multiplier(p, m, nt)
            for p, m, nt, sc in zip(parts, modes, n_totals, scale_parts)
            if sc
        ) + lam_mult_add
        # Empty (or padding) rows would make the system singular; they are
        # zeroed below anyway (the reference's zero_out, common.c:676-681).
        lam_mult = jnp.maximum(lam_mult, 1.0)

    # Rows with no observations anywhere solve to exactly zero — unless an
    # NA-as-zero part or a dense rhs base makes every row "live".
    live = None
    if r0 is None and r0_vec is None and "na0" not in modes:
        for p in parts:
            lv = p.length > 0
            live = lv if live is None else (live | lv)

    use_cd = nonneg or (l1_vec is not None)

    # Shared-Gram fast path: when every part's per-row Gram correction
    # vanishes STATICALLY (na0 mode with no weights => cw == 0) and the
    # scale_lam multiplier is row-constant (na0/no-weights multiplier is
    # the full column count), all rows share one [K, K] system matrix.
    # One Cholesky + triangular solves over [R, K] replaces the [R, K, K]
    # assembly + batched Cholesky — the Bi/Ai implicit-feature half-steps
    # (collective.c:8479/8520) and unweighted NA-as-zero fits always land
    # here.  Solutions are identical to the batched path to float
    # precision (same factorization of the same matrix).
    if (
        method == "chol"
        and not use_cd
        and ring_mesh is None
        and len(parts) > 0
        and all(m == "na0" and p.wgt is None for p, m in zip(parts, modes))
    ):
        # NOTE: this path ignores defer_solve (the solve is one tiny
        # Cholesky); callers detect deferral by the tuple-vs-array return
        # structure, which is static under jit.
        mult = 1.0
        if scale_lam:
            sc_flags = scale_parts if scale_parts else (True,) * len(parts)
            mult = sum(
                float(nt)
                for nt, sc in zip(n_totals, sc_flags)
                if sc
            ) + lam_mult_add
            mult = max(mult, 1.0)
        G = jnp.diag(lam_vec * lam_vec.dtype.type(mult))
        if G0 is not None:
            G = G + G0
        if lam_const_vec is not None:
            G = G + jnp.diag(lam_const_vec)
        rhs = sum(rowsolve.part_rhs(p, mxu_bf16) for p in sparse_parts)
        if r0 is not None:
            rhs = rhs + r0
        return rowsolve.solve_shared_chol(G, rhs.astype(lam_vec.dtype))

    if ring_mesh is not None and not (method == "chol" or use_cd):
        raise ValueError(
            "ring-sharded opposing factors support Cholesky/CD solves only "
            "(truncated CG would cost one ring per matvec); "
            "pass use_cg=False"
        )
    if method == "chol" or use_cd:
        G, rhs = rowsolve.assemble_system(
            sparse_parts, lam_vec, lam_mult=lam_mult, G0=G0, r0=r0,
            mxu_bf16=mxu_bf16, ring_mesh=ring_mesh,
        )
        if lam_const_vec is not None:
            K = lam_vec.shape[0]
            G = G + jnp.diag(lam_const_vec)[None, :, :]
        if use_cd:
            l1 = l1_vec if l1_vec is not None else jnp.zeros_like(lam_vec)
            if lam_mult is not None:
                # L1 scales with the same per-row multiplier as L2
                # (common.c:717-722): promote to [R, K].
                l1 = l1[None, :] * lam_mult[:, None]
            a = rowsolve.solve_cd(
                G, rhs, l1, nonneg=nonneg, max_steps=max_cd_steps, a0=None
            )
        else:
            if defer_solve:
                return G, rhs, live
            a = rowsolve.solve_chol(G, rhs)
        if live is not None:
            a = jnp.where(live[:, None], a, 0.0)
        return a
    # CG path
    lam_eff = lam_vec
    G0_eff = G0
    if lam_const_vec is not None:
        if G0 is None:
            G0_eff = jnp.diag(lam_const_vec)
        else:
            G0_eff = G0 + jnp.diag(lam_const_vec)
    a = rowsolve.solve_cg(
        sparse_parts,
        lam_eff,
        a_prev,
        n_steps=n_steps,
        lam_mult=lam_mult,
        G0=G0_eff,
        r0=r0,
        jacobi=precondition,
        mxu_bf16=mxu_bf16,
    )
    if live is not None:
        a = jnp.where(live[:, None], a, 0.0)
    return a


class SidePlan(NamedTuple):
    """Everything needed to run one half-iteration for one factor side."""

    bucketed: BucketedRows  # sparse data, rows = this side
    mode: str  # part mode for the X-part
    n_total: int  # column count of this orientation


def bucket_arrays(bucketed: BucketedRows) -> tuple:
    """Extract the per-bucket device arrays as a jit-traceable pytree
    (so fused iteration functions can take the sparse data as arguments
    rather than baking it in as constants)."""
    return tuple(
        (b.idx, b.val, b.length, b.wgt) for b in bucketed.buckets
    )


def update_side(
    plan: SidePlan,
    blocks: list,  # current per-bucket factor blocks (warm starts)
    opp: jax.Array,  # [S, K] extended opposing matrix
    opp_bias: Optional[jax.Array],
    lam_vec: jax.Array,
    *,
    buckets_data: Optional[tuple] = None,  # overrides plan.bucketed arrays
    # (pass when tracing under an outer jit so the sparse data stays an
    # argument instead of an embedded constant)
    w: float = 1.0,
    alpha: Optional[float] = None,
    mu: Optional[float] = None,
    G0: Optional[jax.Array] = None,
    r0_vec: Optional[jax.Array] = None,  # [K] shared rhs base
    r0_blocks: Optional[list] = None,  # per-bucket [R, K] rhs bases
    extra_parts: Optional[list] = None,  # per bucket: list of
    #   (PartData, mode, n_total, counts_toward_scale_lam) tuples
    main_in_scale: bool = True,  # X part counts toward scale_lam multiplier
    ones_val: bool = False,  # replace values with 1.0 (Xones implicit feats)
    lam_const_vec: Optional[jax.Array] = None,
    l1_vec: Optional[jax.Array] = None,
    method: str = "chol",
    n_steps: int = 3,
    nonneg: bool = False,
    max_cd_steps: int = 100,
    scale_lam: bool = False,
    lam_mult_add: float = 0.0,
    precondition: bool = False,
    mxu_bf16: bool = False,
    ring_mesh=None,
    dtype=jnp.float32,
) -> list:
    """Solve all buckets of one side; returns the new block list."""
    w_arr = jnp.asarray(w, dtype)
    alpha_arr = None if alpha is None else jnp.asarray(alpha, dtype)
    mu_arr = None if mu is None else jnp.asarray(mu, dtype)
    data = (
        buckets_data
        if buckets_data is not None
        else bucket_arrays(plan.bucketed)
    )
    new_blocks = [None] * len(data)
    # Cholesky solves are deferred and concatenated into ONE batched
    # decomposition across buckets: 2 large Cholesky instances per
    # iteration instead of 2 x n_buckets compile faster and batch better.
    defer_ok = (
        method == "chol" and not nonneg and l1_vec is None
        and ring_mesh is None and len(data) > 1
    )
    deferred = []  # (bi, G, rhs, live)
    for bi, (b_idx, b_val, b_len, b_wgt) in enumerate(data):
        p_main = PartData(
            idx=b_idx,
            val=jnp.ones_like(b_val) if ones_val else b_val,
            length=b_len,
            # Xones (implicit-feature) solves are UNWEIGHTED even on
            # weighted fits: the reference's Bi/Ai optimizeA calls pass
            # weight = NULL (collective.c:8458-8530)
            wgt=None if ones_val else b_wgt,
            opp=opp,
            opp_bias=opp_bias,
            w=w_arr,
            alpha=alpha_arr,
            mu=mu_arr,
        )
        parts = (p_main,)
        modes = (plan.mode,)
        n_totals = (plan.n_total,)
        scale_parts = (main_in_scale,)
        if extra_parts is not None:
            for (pd, pmode, pn, psc) in extra_parts[bi]:
                parts = parts + (pd,)
                modes = modes + (pmode,)
                n_totals = n_totals + (pn,)
                scale_parts = scale_parts + (psc,)
        kw = dict(
            modes=modes,
            method=method,
            n_steps=n_steps,
            nonneg=nonneg,
            max_cd_steps=max_cd_steps,
            scale_lam=scale_lam,
            n_totals=n_totals,
            scale_parts=scale_parts,
            precondition=precondition,
            mxu_bf16=mxu_bf16,
            lam_mult_add=lam_mult_add,
            ring_mesh=ring_mesh,
        )
        args = (
            parts,
            blocks[bi],
            G0,
            None if r0_blocks is None else r0_blocks[bi],
            r0_vec,
            lam_vec,
            lam_const_vec,
            l1_vec,
        )
        if defer_ok:
            out = solve_bucket(*args, defer_solve=True, **kw)
            if isinstance(out, tuple):
                deferred.append((bi,) + out)
            else:
                # shared-Gram fast path solved in place (one tiny Cholesky)
                new_blocks[bi] = out
        else:
            new_blocks[bi] = solve_bucket(*args, **kw)
    if deferred:
        a_all = rowsolve.solve_chol(
            jnp.concatenate([g for _, g, _, _ in deferred]),
            jnp.concatenate([r for _, _, r, _ in deferred]),
        )
        off = 0
        for bi, _g, r, live in deferred:
            a = a_all[off:off + r.shape[0]]
            off += r.shape[0]
            if live is not None:
                a = jnp.where(live[:, None], a, 0.0)
            new_blocks[bi] = a
    return new_blocks


@partial(jax.jit, static_argnames=("n_rows",))
def blocks_to_orig(blocks: list, perm: jax.Array, n_rows: int) -> jax.Array:
    """Concatenate permuted bucket blocks and re-order to original row ids."""
    full = jnp.concatenate(blocks, axis=0)
    return jnp.take(full, perm, axis=0)


@partial(jax.jit, static_argnames=("row_counts", "k_tot", "k_pad", "jdtype"))
def _init_blocks_fused(key, *, row_counts, k_tot, k_pad, jdtype):
    """All buckets' random init in ONE executable, instead of the eager
    per-bucket version's ~3 programs x n_buckets x 2 sides, each compiled
    and dispatched on its own.  The split sequence matches
    the old per-bucket loop exactly, so streams (and every seeded test)
    are unchanged."""
    blocks = []
    scale = float(1.0 / np.sqrt(max(k_tot, 1)))
    for r in row_counts:
        key, sub = jax.random.split(key)
        blk = scale * jax.random.normal(sub, (r, k_pad), jdtype)
        if k_pad > k_tot:
            blk = blk.at[:, k_tot:].set(0.0)
        blocks.append(blk)
    return key, blocks


def init_blocks(key, bucketed: BucketedRows, k_tot: int, k_pad: int, dtype):
    """Random normal init scaled like the reference's random_parallel
    (/root/reference/src/helpers.c:927): N(0, 1/sqrt(k))-ish start."""
    return _init_blocks_fused(
        key, row_counts=tuple(b.n_rows for b in bucketed.buckets),
        k_tot=k_tot, k_pad=k_pad, jdtype=jnp.dtype(dtype))


def gram_matrix(mat: jax.Array) -> jax.Array:
    """M^T M (the BtB / CtC precompute, /root/reference/src/collective.c:6276)."""
    return jnp.einsum("nk,nm->km", mat, mat, precision=SOLVER_PRECISION)
