"""Collective matrix factorization ALS drivers.

The joint model (/root/reference/src/collective.c:78-355):

    X[m,n]  ~  A[:, k_user:] . B[:, k_item:]^T   (+ biases + mean)
    U[m,p]  ~  A[:, :k_user+k] . C^T             (weight w_user)
    I[n,q]  ~  B[:, :k_item+k] . D^T             (weight w_item)
    Xones   ~  A[:, k_user:] . Bi^T,  Xones^T ~ B[:, k_item:] . Ai^T
                                                  (weight w_implicit)

Each half-iteration solves one factor matrix against all others.  Here a
row's system is assembled from sparse "parts" sharing one coordinate space
(the reference's extended Be = [[0, Bs, Bm], [Cu, Cs, 0]] block matrix,
/root/reference/src/collective.c:179-214): the X part occupies coords
[k_user:], the U part coords [:k_user+k], the implicit-features part
[k_user:], and the bias column the last coord.  Dense fully-observed side
info contributes a shared Gram (CtC) plus a per-bucket dense rhs instead of
a sparse part — the analog of the reference's whole-matrix fast path
(/root/reference/src/collective.c:5118).

Update order per iteration matches the reference
(/root/reference/src/collective.c:8334-8860): C, D, Bi, Ai, B, A.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.profiling import profiled_fit
from ..utils.checkpoint import FitCheckpointer

from ..config import SOLVER_PRECISION
from ..data.shards import BucketedRows, build_bucketed_rows
from . import preprocess
from .als import (
    PartData,
    SidePlan,
    blocks_to_orig,
    bucket_arrays,
    gram_matrix,
    init_blocks,
    update_side,
)
from .drivers import (
    _ext_with_ones,
    _ext_with_zeros,
    _make_l1_vec,
    _make_lam_vec,
    _mesh_row_block,
    _na0_rhs_base,
    _resolve_lambdas,
    _set_bias_coord,
    round_up,
)


def _mesh_place_collective(mesh, state, dat, ring=False):
    """Shard a collective fit's state/dat pytrees over the mesh: bucketed
    interaction data, factor blocks, aligned side parts, dense slices and
    mean slices row-sharded on the data axis; opposing/full matrices
    (C_orig/D_orig, dense side matrices) and permutations replicated
    (SURVEY §2.4 P1/P5 — XLA inserts the psum/all-gather collectives).
    In ring (big-axis) mode the dense side matrices and concat-layout row
    masks are row-sharded too: they align with the sharded main factors."""
    from ..parallel.mesh import replicated, row_sharding

    rs, rep = row_sharding(mesh), replicated(mesh)

    def put(t, sh):
        return jax.tree.map(lambda x: jax.device_put(x, sh), t)

    d = list(dat)
    for i in range(8):  # dataA, dataB, dataU, dataI, U_al, I_al, U_ds, I_ds
        d[i] = put(d[i], rs)
    d[8] = put(d[8], rs if ring else rep)  # U dense matrix (C full solve)
    d[9] = put(d[9], rs if ring else rep)  # I dense matrix
    d[10] = put(d[10], rs)  # U mean slices
    d[11] = put(d[11], rs)  # I mean slices
    for i in range(12, 16):  # perms
        d[i] = put(d[i], rep)
    if len(d) > 16:  # concat-layout real-row masks (ring mode)
        d[16] = put(d[16], rs)
        d[17] = put(d[17], rs)
    s = list(state)
    for i, v in enumerate(s):
        if v is None:
            continue
        s[i] = put(v, rs if isinstance(v, list) else rep)
    return tuple(s), tuple(d)


def _ring_setup_collective(RB, CB, dataA, dataB, dataU, dataI, U, I, dtype):
    """Big-axis (ring) fit setup — the collective analog of
    drivers._ring_remap: the opposing main factors are consumed in their
    CONCAT block layout and never permuted back to original order (the
    permuted gather would all-gather the full [S, K] matrix — measured),
    so every id array that indexes a big-axis matrix is remapped once:
    dataA slots index B rows, dataB slots index A rows, and the dataU/dataI
    feature buckets index A/B rows.  Dense side matrices are permuted into
    concat order (zero padding rows) so they align with the sharded
    factors row-wise."""
    from .drivers import _remap_bucket_ids

    pA_i32 = jnp.asarray(RB.perm.astype(np.int32))
    pB_i32 = jnp.asarray(CB.perm.astype(np.int32))
    dataA = _remap_bucket_ids(dataA, pB_i32)
    dataB = _remap_bucket_ids(dataB, pA_i32)
    if dataU is not None:
        dataU = _remap_bucket_ids(dataU, pA_i32)
    if dataI is not None:
        dataI = _remap_bucket_ids(dataI, pB_i32)
    mask_A = jnp.asarray((RB.row_of >= 0).astype(dtype))
    mask_B = jnp.asarray((CB.row_of >= 0).astype(dtype))
    U_dense_arr = I_dense_arr = None
    if U is not None and U.dense is not None:
        Uc = np.zeros((RB.n_rows_pad, U.p), dtype)
        Uc[RB.perm] = np.asarray(U.dense, dtype)
        U_dense_arr = jnp.asarray(Uc)
    if I is not None and I.dense is not None:
        Ic = np.zeros((CB.n_rows_pad, I.p), dtype)
        Ic[CB.perm] = np.asarray(I.dense, dtype)
        I_dense_arr = jnp.asarray(Ic)
    return (dataA, dataB, dataU, dataI, mask_A, mask_B,
            U_dense_arr, I_dense_arr)


# --------------------------------------------------------------------- #
# side-info preparation                                                  #
# --------------------------------------------------------------------- #


@dataclass
class PreparedSide:
    p: int  # number of features (columns of U)
    n_ent: int  # number of entities (rows of U); may exceed the X dimension
    na0: bool
    colmeans: Optional[np.ndarray]
    dense: Optional[np.ndarray]  # centered [n_ent, p] when fully observed
    coo: Optional[tuple]  # (rows, cols, vals) — centered unless na0
    feat_bucketed: Optional[BucketedRows]  # U^T bucketing, for the C update
    aligned: Optional[list]  # per-main-bucket (idx, val, length) vs entities
    mean_slices: Optional[list]  # per-feat-bucket colmean slices (na0+center)


def prepare_side(side, center: bool, na0: bool, dtype) -> Optional[PreparedSide]:
    """Normalize an ingested side-info matrix (see _BaseModel._ingest_side)."""
    if side is None:
        return None
    rows, cols, vals, n_ent, p, is_dense, dense = side
    colmeans = None
    if is_dense:
        dense = np.asarray(dense, np.float64)
        if center:
            colmeans = dense.mean(axis=0)
            if na0:
                # means count missing-as-zero entries; fully-dense => same
                pass
            dense = dense - colmeans[None, :]
        return PreparedSide(
            p=p, n_ent=n_ent, na0=na0, colmeans=colmeans,
            dense=dense.astype(dtype), coo=None, feat_bucketed=None,
            aligned=None, mean_slices=None,
        )
    vals = np.asarray(vals, np.float64)
    if center:
        centered, colmeans = preprocess.center_columns(
            rows, cols, vals, p, na_as_zero=na0, n_rows=n_ent
        )
    else:
        centered = vals
    if na0:
        # store RAW values; the na0 coefficient path subtracts colmeans via
        # the opp_bias mechanism (see fit driver)
        coo = (rows, cols, vals)
    else:
        coo = (rows, cols, centered)
    return PreparedSide(
        p=p, n_ent=n_ent, na0=na0, colmeans=colmeans, dense=None, coo=coo,
        feat_bucketed=None, aligned=None, mean_slices=None,
    )


def build_aligned_parts(bucketed: BucketedRows, rows_s, cols_s, vals_s,
                        n_ent: int, dtype):
    """Pad a second sparse matrix's rows in the exact row order of an
    existing bucketing (so the X part and the U part of one row system sit
    in the same batch slot)."""
    rows_s = np.asarray(rows_s, np.int64)
    order = np.argsort(rows_s, kind="stable")
    sc = np.asarray(cols_s, np.int64)[order]
    sv = np.asarray(vals_s, np.float64)[order]
    counts = np.bincount(rows_s, minlength=max(n_ent, bucketed.n_rows)).astype(np.int64)
    indptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])

    out = []
    for b in bucketed.buckets:
        ids = bucketed.row_of[b.start : b.start + b.n_rows]  # -1 for padding
        valid = ids >= 0
        ns = np.where(valid, counts[np.maximum(ids, 0)], 0)
        L = round_up(max(int(ns.max()), 1), 8)
        idx = np.zeros((b.n_rows, L), np.int32)
        val = np.zeros((b.n_rows, L), dtype)
        total = int(ns.sum())
        if total:
            starts = np.where(valid, indptr[np.maximum(ids, 0)], 0)
            seg_off = np.repeat(np.cumsum(ns) - ns, ns)
            within = np.arange(total, dtype=np.int64) - seg_off
            src = np.repeat(starts, ns) + within
            dest_r = np.repeat(np.arange(b.n_rows, dtype=np.int64), ns)
            idx[dest_r, within] = sc[src]
            val[dest_r, within] = sv[src]
        out.append((jnp.asarray(idx), jnp.asarray(val), jnp.asarray(ns.astype(np.int32))))
    return out


def _bucket_dense_slices(bucketed: BucketedRows, M: np.ndarray, dtype):
    """Per-bucket dense row slices of M (rows beyond M -> zeros)."""
    out = []
    n = M.shape[0]
    for b in bucketed.buckets:
        ids = bucketed.row_of[b.start : b.start + b.n_rows]
        sl = np.zeros((b.n_rows, M.shape[1]), dtype)
        valid = ids >= 0
        in_range = valid & (ids < n)
        sl[in_range] = M[ids[in_range]]
        out.append(jnp.asarray(sl))
    return out


def _pad_cols(M, k_pad, offset, dtype):
    """Place M's columns at [offset : offset+width] of a k_pad-wide matrix."""
    out = jnp.zeros((M.shape[0], k_pad), dtype)
    return out.at[:, offset : offset + M.shape[1]].set(M)


@jax.jit
def _dense_rhs(U_slice, Ce, w):
    """w * U_bucket @ Ce — per-row rhs base from fully-dense side info."""
    return w * jnp.einsum("rp,pk->rk", U_slice, Ce, precision=SOLVER_PRECISION)


def _dense_full_solve(A1, U, lam_vec, w, nonneg, l1_vec, max_cd_steps, dtype,
                      lam_scale=1.0):
    """Whole-matrix update for C (or D) when the side matrix is fully dense:
    (w A1^T A1 + diag(lam)) C^T = w A1^T U
    (the reference's optimizeA case-1 fast path, common.c:2787).

    lam_scale: scale_lam multiplier — the per-feature observed count, = the
    number of side-info rows when fully dense (common.c case 1 uses lam*n)."""
    G = w * gram_matrix(A1) + jnp.diag(lam_vec * lam_scale)
    rhs = w * jnp.einsum("mk,mp->pk", A1, U, precision=SOLVER_PRECISION)
    if nonneg or (l1_vec is not None):
        from ..ops import rowsolve

        p = rhs.shape[0]
        Gb = jnp.broadcast_to(G[None], (p,) + G.shape)
        l1 = (l1_vec if l1_vec is not None else jnp.zeros_like(lam_vec))
        l1 = l1 * lam_scale
        return rowsolve.solve_cd(Gb, rhs, l1, nonneg=nonneg,
                                 max_steps=max_cd_steps)
    L = jax.lax.linalg.cholesky(G)
    y = jax.lax.linalg.triangular_solve(L, rhs.T, left_side=True, lower=True)
    out = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                          transpose_a=True)
    return out.T


def _init_dense_ok(init):
    """Whether a warm restart may ride the fused dense engine.  The engine
    seeds A/B/biasA/biasB; C/D/Ai/Bi warm values are trajectory-inert on
    the bucketed path too (the half-step order re-solves them from A/B
    before first use, collective.c:8345/8396/8479/8520), but keep fits
    that pass them on the bucketed path out of caution for niter=0."""
    if init is None:
        return True
    return all(init.get(key) is None for key in ("C", "D", "Ai", "Bi"))


# --------------------------------------------------------------------- #
# explicit collective fit                                                #
# --------------------------------------------------------------------- #


def _sparsify_short_dense_side(side, xdim):
    """A DENSE side matrix with fewer rows than the main dimension
    (m_u < m) is re-expressed as sparse triplets over its rows: the
    dense fast paths assume every main row has a side row (shared CtC
    Gram + whole-matrix solves), but entities beyond n_ent must get NO
    side contribution at all (the reference solves them X-only).  The
    sparse machinery's per-row gathers handle that naturally."""
    if side is None:
        return side
    rows, cols, vals, n_ent, p, is_dense, dense = side
    if not is_dense or n_ent >= xdim:
        return side
    dense = np.asarray(dense, np.float64)
    rr, cc = np.nonzero(~np.isnan(dense))
    return (rr, cc, dense[rr, cc], n_ent, p, False, None)


@profiled_fit
def fit_collective_explicit_als(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None,
    k=40, k_user=0, k_item=0, k_main=0,
    lambda_=10.0, l1_lambda=0.0,
    w_main=1.0, w_user=1.0, w_item=1.0, w_implicit=0.5,
    add_implicit_features=False,
    niter=10, use_cg=True, max_cg_steps=3, precondition_cg=False,
    finalize_chol=True,
    user_bias=True, item_bias=True, center=True,
    center_U=True, center_I=True,
    scale_lam=False, scale_lam_sideinfo=False, scale_bias_const=False,
    NA_as_zero=False, NA_as_zero_user=False, NA_as_zero_item=False,
    nonneg=False, nonneg_C=False, nonneg_D=False, max_cd_steps=100,
    weights=None, dtype=np.float32, seed=1, verbose=False,
    mesh=None,  # jax.sharding.Mesh: row-parallel multi-chip fit
    init=None,  # warm restart (reset_values=False analog): dict with any of
    # A, B, C, D, Ai, Bi, biasA, biasB — unpadded [rows, width] arrays
    checkpoint_path=None,  # mid-fit periodic checkpoints
    checkpoint_every=0,  # every N iterations (utils/checkpoint.py)
    shard_opposing_rows=False,  # big-axis mode: opposing factors stay
    # row-sharded; systems assembled by the ppermute ring (parallel/ring.py).
    # Requires mesh= and use_cg=False (same contract as fit_explicit_als).
) -> dict:
    dtype = np.dtype(dtype)
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter)
    scale_lam = scale_lam or scale_lam_sideinfo
    ring = bool(shard_opposing_rows)
    if ring:
        if mesh is None:
            raise ValueError("shard_opposing_rows requires mesh=")
        if use_cg:
            raise ValueError(
                "shard_opposing_rows supports Cholesky/CD solves only "
                "(truncated CG would cost one ring per matvec); "
                "pass use_cg=False"
            )
    if nonneg:
        use_cg = False

    side_U = _sparsify_short_dense_side(side_U, m)
    side_I = _sparsify_short_dense_side(side_I, n)
    U = prepare_side(side_U, center_U, NA_as_zero_user, dtype)
    I = prepare_side(side_I, center_I, NA_as_zero_item, dtype)

    m_eff = max(m, U.n_ent if U else 0)
    n_eff = max(n, I.n_ent if I else 0)

    glob_mean = preprocess.weighted_global_mean(vals, weights) if center else 0.0
    if NA_as_zero and center:
        # mean over all m*n cells (unobserved = 0, weight 1) — see
        # drivers.fit_explicit_als for the reference mapping + the
        # weighted-variant quirk we do not copy
        wsum = (float(len(vals)) if weights is None
                else float(np.sum(weights)))
        glob_mean *= wsum / (wsum + float(m) * float(n) - float(len(vals)))
    if nonneg:
        # centering stays on under nonneg; only the mean is clamped at zero
        # (common.c:3599)
        glob_mean = max(glob_mean, 0.0)
    vals_c = (np.asarray(vals, np.float64) - glob_mean).astype(dtype)

    # Fused dense-engine fast path: fully-dense side info, no k splits, no
    # constraints — the common collective configuration at benchmark scale.
    from .dense_engine import estimate_dense_bytes

    from ..config import dense_budget_bytes, exact_dense_enabled, on_accelerator

    budget = dense_budget_bytes()
    use_dense_pallas = (
        mesh is None
        and on_accelerator()
        and os.environ.get("CMFREC_TPU_NO_PALLAS", "0") != "1"
        and np.dtype(dtype) == np.float32
        # use_cg=False rides the fused engine in exact mode (Krylov-capped
        # converged CG, see drivers.fit_explicit_als)
        and (use_cg or exact_dense_enabled())
        # the fused kernels implement plain CG only (same exclusion as
        # drivers.fit_explicit_als) — PCG fits stay on the bucketed path
        and not (use_cg and precondition_cg)
        and _init_dense_ok(init)  # A/B/bias warm restarts ride along
        and not (nonneg or nonneg_C or nonneg_D)
        and not np.any(l16 > 0)
        and not (NA_as_zero or NA_as_zero_user or NA_as_zero_item)
        and k_user == 0 and k_item == 0 and k_main == 0
        # the fused engine solves the main X part at weight 1
        and w_main == 1.0
        # implicit features ride the dense engine's binary mask, which only
        # equals Xones when the fit is unweighted
        and (not add_implicit_features or weights is None)
        and m_eff == m and n_eff == n
        and (U is None or U.dense is not None)
        and (I is None or I.dense is not None)
        and estimate_dense_bytes(m, n, np.dtype(dtype).itemsize) <= budget
    )
    if use_dense_pallas:
        from ..ops.masked_matmul import pad_dim

        _mp, _np_ = pad_dim(m), pad_dim(n)
        wb = 4 if weights is not None else 1
        if (_mp * _np_ >= np.iinfo(np.int32).max
                or _mp * _np_ * (2 + wb) * 2 > budget):
            use_dense_pallas = False
    if use_dense_pallas:
        from .dense_pallas import fit_collective_dense_pallas

        res = fit_collective_dense_pallas(
            rows, cols, vals, m, n,
            U_dense=None if U is None else U.dense,
            I_dense=None if I is None else I.dense,
            weights=weights, k=k, lam6=lam6, w_user=w_user, w_item=w_item,
            niter=niter, max_cg_steps=max_cg_steps,
            finalize_chol=finalize_chol,
            finalize_steps=int(os.environ.get("CMFREC_TPU_FINALIZE_STEPS",
                                              "16")),
            user_bias=user_bias, item_bias=item_bias, glob_mean=glob_mean,
            scale_lam=scale_lam, scale_lam_sideinfo=scale_lam_sideinfo,
            scale_bias_const=scale_bias_const,
            add_implicit_features=add_implicit_features,
            w_implicit=w_implicit,
            dtype=dtype, seed=seed, verbose=verbose, exact=not use_cg,
            init=init,
        )
        res["U_colmeans"] = None if U is None else U.colmeans
        res["I_colmeans"] = None if I is None else I.colmeans
        return res

    biasA0 = biasB0 = None
    if user_bias or item_bias:
        biasA0, biasB0 = preprocess.initialize_biases(
            rows, cols, vals_c, m_eff, n_eff,
            lam_user=lam6[0], lam_item=lam6[1], wgt=weights,
            user_bias=user_bias, item_bias=item_bias,
            scale_lam=scale_lam, nonneg=nonneg,
        )

    from .drivers import _build_pair

    _rb = _mesh_row_block(mesh)
    _rbkw = {} if _rb is None else {"row_block": _rb}
    if m_eff == m and n_eff == n:
        RB, CB = _build_pair(rows, cols, vals_c, m, n, weights, dtype,
                             row_block=_rb)
    else:
        RB = build_bucketed_rows(rows, cols, vals_c, m_eff, n, weights,
                                 dtype=dtype, **_rbkw)
        CB = build_bucketed_rows(cols, rows, vals_c, n_eff, m, weights,
                                 dtype=dtype, **_rbkw)
    if mesh is None:
        RB.device_put()
        CB.device_put()

    ka = k_user + k + k_main  # width of A rows (w/o bias)
    kb = k_item + k + k_main
    ka_pad = round_up(ka + 1, 8)
    kb_pad = round_up(kb + 1, 8)
    kc = k_user + k
    kd = k_item + k
    kc_pad = round_up(kc, 8)
    kd_pad = round_up(kd, 8)
    ki_w = k + k_main  # implicit-features width
    ki_pad = round_up(ki_w, 8)

    key = jax.random.PRNGKey(seed)
    key, A_blocks = init_blocks(key, RB, ka, ka_pad, dtype)
    key, B_blocks = init_blocks(key, CB, kb, kb_pad, dtype)
    if user_bias:
        A_blocks = _set_bias_coord(A_blocks, RB, biasA0, ka, dtype)
    if item_bias:
        B_blocks = _set_bias_coord(B_blocks, CB, biasB0, kb, dtype)
    if init is not None:
        from .drivers import _seed_factor_blocks
        if init.get("A") is not None:
            A_blocks = _seed_factor_blocks(A_blocks, RB, init["A"], ka, dtype)
        if init.get("B") is not None:
            B_blocks = _seed_factor_blocks(B_blocks, CB, init["B"], kb, dtype)
        if user_bias and init.get("biasA") is not None:
            A_blocks = _set_bias_coord(
                A_blocks, RB, np.asarray(init["biasA"]), ka, dtype)
        if item_bias and init.get("biasB") is not None:
            B_blocks = _set_bias_coord(
                B_blocks, CB, np.asarray(init["biasB"]), kb, dtype)

    # --- side-info structures ---
    def setup_side(S: Optional[PreparedSide], main_bucketed):
        """feat bucketing (for C/D update) + alignment to the main bucketing."""
        if S is None:
            return None, None, None, None
        if S.dense is not None:
            dense_slices = _bucket_dense_slices(main_bucketed, S.dense, dtype)
            return None, None, dense_slices, None
        r_s, c_s, v_s = S.coo
        feat_b = build_bucketed_rows(c_s, r_s, v_s.astype(np.float64), S.p,
                                     S.n_ent, dtype=dtype, **_rbkw)
        aligned = build_aligned_parts(main_bucketed, r_s, c_s, v_s, S.n_ent, dtype)
        mean_slices = None
        if S.na0 and S.colmeans is not None:
            mean_slices = []
            for b in feat_b.buckets:
                ids = feat_b.row_of[b.start : b.start + b.n_rows]
                ms = np.zeros(b.n_rows, dtype)
                ok = ids >= 0
                ms[ok] = S.colmeans[ids[ok]]
                mean_slices.append(jnp.asarray(ms))
        return feat_b, aligned, None, mean_slices

    U_featb, U_aligned, U_dense_slices, U_mean_slices = setup_side(U, RB)
    I_featb, I_aligned, I_dense_slices, I_mean_slices = setup_side(I, CB)

    key2 = jax.random.PRNGKey(seed + 1)
    C_blocks = D_blocks = None
    C_orig = D_orig = None
    init_C = None if init is None else init.get("C")
    init_D = None if init is None else init.get("D")
    if U is not None:
        if U.dense is not None:
            C_orig = 0.01 * jax.random.normal(key2, (U.p, kc_pad), dtype)
            C_orig = C_orig.at[:, kc:].set(0.0)
            if init_C is not None:
                C_orig = C_orig.at[:, :kc].set(
                    jnp.asarray(np.asarray(init_C, dtype)))
        else:
            key2, C_blocks = init_blocks(key2, U_featb, kc, kc_pad, dtype)
            if init_C is not None:
                from .drivers import _seed_factor_blocks
                C_blocks = _seed_factor_blocks(
                    C_blocks, U_featb, init_C, kc, dtype)
            C_orig = blocks_to_orig(C_blocks, jnp.asarray(U_featb.perm), U.p)
    if I is not None:
        if I.dense is not None:
            key2, sub = jax.random.split(key2)
            D_orig = 0.01 * jax.random.normal(sub, (I.p, kd_pad), dtype)
            D_orig = D_orig.at[:, kd:].set(0.0)
            if init_D is not None:
                D_orig = D_orig.at[:, :kd].set(
                    jnp.asarray(np.asarray(init_D, dtype)))
        else:
            key2, D_blocks = init_blocks(key2, I_featb, kd, kd_pad, dtype)
            if init_D is not None:
                from .drivers import _seed_factor_blocks
                D_blocks = _seed_factor_blocks(
                    D_blocks, I_featb, init_D, kd, dtype)
            D_orig = blocks_to_orig(D_blocks, jnp.asarray(I_featb.perm), I.p)

    Bi_blocks = Ai_blocks = None
    Bi_orig = Ai_orig = None
    if add_implicit_features:
        key, Bi_blocks = init_blocks(key, CB, ki_w, ki_pad, dtype)
        key, Ai_blocks = init_blocks(key, RB, ki_w, ki_pad, dtype)
        if init is not None:
            from .drivers import _seed_factor_blocks
            if init.get("Bi") is not None:
                Bi_blocks = _seed_factor_blocks(
                    Bi_blocks, CB, init["Bi"], ki_w, dtype)
            if init.get("Ai") is not None:
                Ai_blocks = _seed_factor_blocks(
                    Ai_blocks, RB, init["Ai"], ki_w, dtype)
        Bi_orig = blocks_to_orig(Bi_blocks, jnp.asarray(CB.perm), n_eff)
        Ai_orig = blocks_to_orig(Ai_blocks, jnp.asarray(RB.perm), m_eff)

    # --- lambda vectors ---
    lam_vec_A = _make_lam_vec(ka, ka_pad, lam6[2], lam6[0], user_bias, dtype)
    lam_vec_B = _make_lam_vec(kb, kb_pad, lam6[3], lam6[1], item_bias, dtype)
    lam_vec_C = _make_lam_vec(kc, kc_pad, lam6[4], 0.0, False, dtype)
    lam_vec_D = _make_lam_vec(kd, kd_pad, lam6[5], 0.0, False, dtype)
    lam_vec_Bi = _make_lam_vec(ki_w, ki_pad, lam6[3] / w_implicit, 0.0, False, dtype)
    lam_vec_Ai = _make_lam_vec(ki_w, ki_pad, lam6[2] / w_implicit, 0.0, False, dtype)
    l1_vec_A = _make_l1_vec(ka, ka_pad, l16[2], l16[0], user_bias, dtype)
    l1_vec_B = _make_l1_vec(kb, kb_pad, l16[3], l16[1], item_bias, dtype)
    l1_vec_C = _make_l1_vec(kc, kc_pad, l16[4], 0.0, False, dtype)
    l1_vec_D = _make_l1_vec(kd, kd_pad, l16[5], 0.0, False, dtype)

    # scale_bias_const: the bias coordinate's penalty scales with the
    # AVERAGE observation count instead of the per-row count (same as
    # drivers.fit_explicit_als; common.c:717-722, reference gate
    # scale_lam || scale_lam_sideinfo)
    lam_const_A = lam_const_B = None
    scaling_biasA = scaling_biasB = None
    if (scale_lam or scale_lam_sideinfo) and scale_bias_const:
        wsum_total = (float(np.sum(weights)) if weights is not None
                      else float(len(vals)))

        def _side_wsum(S, lim):
            # side-entry mass landing in the first `lim` rows: the
            # scaling mean runs over the X dimension (collective.c:8114)
            # and, under scale_lam_sideinfo, includes side counts
            # (collective.c:8070)
            if S is None or not scale_lam_sideinfo:
                return 0.0
            if S.na0:
                return float(S.p) * lim
            if S.dense is not None:
                return float(min(S.n_ent, lim)) * S.p
            r_s = np.asarray(S.coo[0])
            return float(np.count_nonzero(r_s < lim))

        if user_bias:
            scaling_biasA = (wsum_total + _side_wsum(U, m)) / max(m, 1)
            v = np.zeros(ka_pad)
            v[ka] = lam6[0] * scaling_biasA
            lam_const_A = jnp.asarray(v, dtype)
            lam_vec_A = lam_vec_A.at[ka].set(0.0)
        if item_bias:
            scaling_biasB = (wsum_total + _side_wsum(I, n)) / max(n, 1)
            v = np.zeros(kb_pad)
            v[kb] = lam6[1] * scaling_biasB
            lam_const_B = jnp.asarray(v, dtype)
            lam_vec_B = lam_vec_B.at[kb].set(0.0)

    plan_A = SidePlan(None, "na0" if NA_as_zero else "explicit", n)
    plan_B = SidePlan(None, "na0" if NA_as_zero else "explicit", m)

    def factor_update(
        main_blocks, plan, main_data, opp_main, opp_bias, lam_vec, l1_vec,
        method, S: Optional[PreparedSide], S_aligned, S_dense_slices,
        C_mat, kx, w_side, Xones_opp, side_is_user,
        mu_main, lam_const_vec=None,
    ):
        """One A- or B-style update with optional side-info and implicit
        feature parts.  main_data carries the bucket arrays explicitly so
        the whole update can run under an outer jit without embedding the
        sparse data as constants."""
        k_off = k_user if side_is_user else k_item
        G0 = None
        r0_vec = None
        r0_blocks = None
        extra = None
        n_buckets = len(main_data)

        main_na0 = plan.mode == "na0"
        if main_na0:
            G0 = jnp.asarray(w_main, dtype) * gram_matrix(opp_main)
            r0_vec = jnp.asarray(w_main, dtype) * _na0_rhs_base(
                opp_main, opp_bias, mu_main
            )

        # side-info contributions
        lam_mult_add = 0.0
        if S is not None:
            Ce = _pad_cols(C_mat[:, :kx], lam_vec.shape[0], 0, dtype)
            if S.dense is not None:
                Gs = jnp.asarray(w_side, dtype) * gram_matrix(Ce)
                G0 = Gs if G0 is None else G0 + Gs
                r0_blocks = [
                    _dense_rhs(sl, Ce, jnp.asarray(w_side, dtype))
                    for sl in S_dense_slices
                ]
                if scale_lam_sideinfo:
                    # dense side info adds p observations per row to the
                    # lambda multiplier (common.c:689-724)
                    lam_mult_add = float(S.p)
            else:
                extra = [[] for _ in range(n_buckets)]
                s_mode = "na0" if S.na0 else "explicit"
                if S.na0:
                    Gs = jnp.asarray(w_side, dtype) * gram_matrix(Ce)
                    G0 = Gs if G0 is None else G0 + Gs
                    cm = (
                        jnp.asarray(S.colmeans.astype(dtype))
                        if S.colmeans is not None
                        else None
                    )
                    rv = jnp.asarray(w_side, dtype) * _na0_rhs_base(Ce, cm, 0.0)
                    r0_vec = rv if r0_vec is None else r0_vec + rv
                else:
                    cm = None
                for bi, (idx_s, val_s, len_s) in enumerate(S_aligned):
                    pd = PartData(
                        idx=idx_s, val=val_s, length=len_s, wgt=None,
                        opp=Ce, opp_bias=cm,
                        w=jnp.asarray(w_side, dtype), alpha=None,
                        mu=jnp.asarray(0.0, dtype) if S.na0 else None,
                    )
                    extra[bi].append((pd, s_mode, S.p, scale_lam_sideinfo))

        # implicit features: Xones ~ A[:, k_off:] . Bi^T
        if add_implicit_features:
            Bi_e = _pad_cols(Xones_opp[:, :ki_w], lam_vec.shape[0], k_off, dtype)
            Gi = jnp.asarray(w_implicit, dtype) * gram_matrix(Bi_e)
            G0 = Gi if G0 is None else G0 + Gi
            if extra is None:
                extra = [[] for _ in range(n_buckets)]
            for bi, (b_idx, b_val, b_len, _bw) in enumerate(main_data):
                pd = PartData(
                    idx=b_idx, val=jnp.ones_like(b_val), length=b_len,
                    wgt=None, opp=Bi_e, opp_bias=None,
                    w=jnp.asarray(w_implicit, dtype), alpha=None,
                    mu=jnp.asarray(0.0, dtype),
                )
                extra[bi].append((pd, "na0", plan.n_total, False))

        return update_side(
            plan, main_blocks, opp_main, opp_bias, lam_vec,
            buckets_data=main_data,
            w=w_main, mu=mu_main if main_na0 else None,
            G0=G0, r0_vec=r0_vec, r0_blocks=r0_blocks, extra_parts=extra,
            lam_const_vec=lam_const_vec,
            l1_vec=l1_vec, method=method, n_steps=max_cg_steps,
            nonneg=nonneg, max_cd_steps=max_cd_steps, scale_lam=scale_lam,
            lam_mult_add=lam_mult_add,
            precondition=precondition_cg, dtype=dtype,
            ring_mesh=mesh if ring else None,
        )

    def side_factor_update(S, featb_data, blocks, A1, lam_vec, l1_s, w_side,
                           nonneg_s, method, mean_slices):
        """Update C (or D): rows = side-info features, opp = A[:, :k_off+k].

        Under scale_lam OR scale_lam_sideinfo the reference scales this
        half-step's lambda by the per-feature observed-entry count too
        (collective.c:8373 forwards scale_lam||scale_lam_sideinfo from
        :7465 into optimizeA for C)."""
        plan = SidePlan(None, "na0" if S.na0 else "explicit", S.n_ent)
        G0 = None
        r0_blocks = None
        if S.na0:
            G0 = jnp.asarray(w_side, dtype) * gram_matrix(A1)
            if mean_slices is not None:
                colsum = jnp.sum(A1, axis=0)
                r0_blocks = [
                    -jnp.asarray(w_side, dtype) * ms[:, None] * colsum[None, :]
                    for ms in mean_slices
                ]
        return update_side(
            plan, blocks, A1, None, lam_vec,
            buckets_data=featb_data,
            w=w_side, G0=G0, r0_blocks=r0_blocks,
            l1_vec=l1_s, method=method, n_steps=max_cg_steps,
            nonneg=nonneg_s, max_cd_steps=max_cd_steps, scale_lam=scale_lam,
            precondition=precondition_cg, dtype=dtype,
            ring_mesh=mesh if ring else None,
        )

    perm_A = jnp.asarray(RB.perm)
    perm_B = jnp.asarray(CB.perm)
    perm_U = (None if (U is None or U.dense is not None)
              else jnp.asarray(U_featb.perm))
    perm_I = (None if (I is None or I.dense is not None)
              else jnp.asarray(I_featb.perm))

    dataA = bucket_arrays(RB)
    dataB = bucket_arrays(CB)
    dataU = None if U_featb is None else bucket_arrays(U_featb)
    dataI = None if I_featb is None else bucket_arrays(I_featb)
    U_dense_arr = None if (U is None or U.dense is None) else jnp.asarray(U.dense)
    I_dense_arr = None if (I is None or I.dense is None) else jnp.asarray(I.dense)

    mask_A = mask_B = None
    if ring:
        (dataA, dataB, dataU, dataI, mask_A, mask_B,
         U_dense_arr, I_dense_arr) = _ring_setup_collective(
            RB, CB, dataA, dataB, dataU, dataI, U, I, dtype)

    def _ring_cat(blocks, mask):
        from .drivers import _ring_cat_blocks

        return _ring_cat_blocks(blocks, mask, mesh)

    # X-dimension opposing-row masks: the shared Gram/rhs bases of the
    # B/A (and Bi/Ai, C/D) systems must sum over the X (or side)
    # dimension only — with extra side-only entities (m_u > m or
    # n_i > n, _supports_extra_side_rows) the factor matrices carry live
    # rows beyond the X dims which the reference's opposing row counts
    # exclude (optimizeA calls pass m/n, collective.c:8461/9924).
    # All-ones (an exact no-op) in the common m_u == m case.
    _npdt = np.float64 if np.dtype(dtype) == np.float64 else np.float32

    def _xdim_mask(limit, total, perm_np, concat_mask):
        if not ring:
            return jnp.asarray((np.arange(total) < limit).astype(_npdt))
        v = np.zeros(int(concat_mask.shape[0]), _npdt)
        v[np.asarray(perm_np)[:limit]] = 1.0
        return jnp.asarray(v)

    xmask_A = _xdim_mask(m, m_eff, RB.perm, mask_A)
    xmask_B = _xdim_mask(n, n_eff, CB.perm, mask_B)
    xmask_AU = (None if U is None or U.n_ent >= m_eff
                else _xdim_mask(U.n_ent, m_eff, RB.perm, mask_A))
    xmask_BI = (None if I is None or I.n_ent >= n_eff
                else _xdim_mask(I.n_ent, n_eff, CB.perm, mask_B))

    def _one_iteration(method, state, dat):
        """One full collective iteration (C, D, Bi/Ai, B, A updates), a pure
        function of (state, dat) so the whole thing can run under ONE jit:
        on the GPU this collapses the ~6 x n_buckets per-bucket dispatches
        into a single device call per iteration."""
        (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig,
         Ai_blocks, Bi_blocks) = state
        (dA, dB, dU, dI, U_al, I_al, U_ds, I_ds, U_dn, I_dn,
         U_ms, I_ms, pA, pB, pU, pI, mkA, mkB) = dat

        if ring:
            # big-axis mode: opposing factors consumed in concat layout
            # (ids in dat were remapped); NEVER permuted to orig order
            A_orig = _ring_cat(A_blocks, mkA)
            B_orig = _ring_cat(B_blocks, mkB)
        else:
            A_orig = blocks_to_orig(A_blocks, pA, m_eff)
            B_orig = blocks_to_orig(B_blocks, pB, n_eff)
        Ai_orig = Bi_orig = None

        # ---- C update ----
        if U is not None:
            A1 = _pad_cols(A_orig[:, :kc], kc_pad, 0, dtype)
            if U_dn is not None:
                # side matrix shorter than the factor matrix (m_u < m):
                # only the side-covered rows enter C's system
                A1u = (A1[:U.n_ent] if (not ring and U.n_ent < A1.shape[0])
                       else A1)
                C_orig = _dense_full_solve(
                    A1u, U_dn, lam_vec_C, w_user, nonneg_C,
                    l1_vec_C, max_cd_steps, dtype,
                    lam_scale=float(U.n_ent) if scale_lam else 1.0,
                )
            else:
                if xmask_AU is not None and not U.na0:
                    # under NA_as_zero_U the rows beyond the side matrix
                    # are genuine all-zero side rows (include them)
                    A1 = A1 * xmask_AU[:, None]
                C_blocks = side_factor_update(
                    U, dU, C_blocks, A1, lam_vec_C, l1_vec_C, w_user,
                    nonneg_C, method, U_ms,
                )
                C_orig = blocks_to_orig(C_blocks, pU, U.p)

        # ---- D update ----
        if I is not None:
            B1 = _pad_cols(B_orig[:, :kd], kd_pad, 0, dtype)
            if I_dn is not None:
                B1i = (B1[:I.n_ent] if (not ring and I.n_ent < B1.shape[0])
                       else B1)
                D_orig = _dense_full_solve(
                    B1i, I_dn, lam_vec_D, w_item, nonneg_D,
                    l1_vec_D, max_cd_steps, dtype,
                    lam_scale=float(I.n_ent) if scale_lam else 1.0,
                )
            else:
                if xmask_BI is not None and not I.na0:
                    B1 = B1 * xmask_BI[:, None]
                D_blocks = side_factor_update(
                    I, dI, D_blocks, B1, lam_vec_D, l1_vec_D, w_item,
                    nonneg_D, method, I_ms,
                )
                D_orig = blocks_to_orig(D_blocks, pI, I.p)

        # ---- Bi / Ai updates (implicit features) ----
        # Always closed-form: the reference hard-codes use_cg=false for
        # these half-steps even in CG fits (collective.c:8479/8520), and
        # the NA0 shared-Gram solve is the cheap path anyway.
        if add_implicit_features:
            A_x = _pad_cols(A_orig[:, k_user : k_user + ki_w], ki_pad, 0, dtype)
            A_x = A_x * xmask_A[:, None]  # Gram over the X rows only
            plan_bi = SidePlan(None, "na0", m)
            Bi_blocks = update_side(
                plan_bi, Bi_blocks, A_x, None, lam_vec_Bi,
                buckets_data=dB,
                G0=gram_matrix(A_x), ones_val=True,
                method="chol", n_steps=max_cg_steps, nonneg=nonneg,
                max_cd_steps=max_cd_steps, scale_lam=scale_lam, dtype=dtype,
                ring_mesh=mesh if ring else None,
            )
            Bi_orig = (_ring_cat(Bi_blocks, mkB) if ring
                       else blocks_to_orig(Bi_blocks, pB, n_eff))

            B_x = _pad_cols(B_orig[:, k_item : k_item + ki_w], ki_pad, 0, dtype)
            B_x = B_x * xmask_B[:, None]
            plan_ai = SidePlan(None, "na0", n)
            Ai_blocks = update_side(
                plan_ai, Ai_blocks, B_x, None, lam_vec_Ai,
                buckets_data=dA,
                G0=gram_matrix(B_x), ones_val=True,
                method="chol", n_steps=max_cg_steps, nonneg=nonneg,
                max_cd_steps=max_cd_steps, scale_lam=scale_lam, dtype=dtype,
                ring_mesh=mesh if ring else None,
            )
            Ai_orig = (_ring_cat(Ai_blocks, mkA) if ring
                       else blocks_to_orig(Ai_blocks, pA, m_eff))

        # ---- B update (items; opposing = A, D, Ai) ----
        opp = jnp.zeros((A_orig.shape[0], kb_pad), dtype)
        opp = opp.at[:, k_item : k_item + k + k_main].set(
            A_orig[:, k_user : k_user + k + k_main]
        )
        if item_bias:
            # concat layout: the bias-ones column must stay 0 on padding
            opp = opp.at[:, kb].set(mkA if ring else 1.0)
        if not NA_as_zero:
            # shared bases sum the X rows only — EXCEPT under NA_as_zero,
            # where extra side-only entities are genuine all-zero X rows
            # and the reference includes them (verified vs the binary)
            opp = opp * xmask_A[:, None]
        opp_bias = A_orig[:, ka] if user_bias else None
        B_blocks = factor_update(
            B_blocks, plan_B, dB, opp, opp_bias, lam_vec_B, l1_vec_B, method,
            I, I_al, I_ds, D_orig, kd,
            w_item,
            None if Ai_orig is None else Ai_orig * xmask_A[:, None],
            side_is_user=False, mu_main=glob_mean,
            lam_const_vec=lam_const_B,
        )
        B_orig = (_ring_cat(B_blocks, mkB) if ring
                  else blocks_to_orig(B_blocks, pB, n_eff))

        # ---- A update (users; opposing = B, C, Bi) ----
        opp = jnp.zeros((B_orig.shape[0], ka_pad), dtype)
        opp = opp.at[:, k_user : k_user + k + k_main].set(
            B_orig[:, k_item : k_item + k + k_main]
        )
        if user_bias:
            opp = opp.at[:, ka].set(mkB if ring else 1.0)
        if not NA_as_zero:
            opp = opp * xmask_B[:, None]
        opp_bias = B_orig[:, kb] if item_bias else None
        A_blocks = factor_update(
            A_blocks, plan_A, dA, opp, opp_bias, lam_vec_A, l1_vec_A, method,
            U, U_al, U_ds, C_orig, kc,
            w_user,
            None if Bi_orig is None else Bi_orig * xmask_B[:, None],
            side_is_user=True, mu_main=glob_mean,
            lam_const_vec=lam_const_A,
        )
        return (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig,
                Ai_blocks, Bi_blocks)

    # On the GPU the fused-iteration jit pays one compile per fit but
    # removes per-bucket dispatches; on CPU (tests, small problems) the
    # unfused path reuses the cross-fit solve_bucket executable cache.
    fuse_env = os.environ.get("CMFREC_TPU_FUSE_COLLECTIVE", "auto")
    if fuse_env == "auto":
        do_fuse = on_accelerator()
    else:
        do_fuse = fuse_env == "1"
    if do_fuse:
        from functools import partial as _partial

        _jit_iter = {}

        def run_iteration(method, state, dat):
            if method not in _jit_iter:
                _jit_iter[method] = jax.jit(_partial(_one_iteration, method))
            return _jit_iter[method](state, dat)
    else:
        run_iteration = _one_iteration

    state = (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig,
             Ai_blocks, Bi_blocks)
    dat = (dataA, dataB, dataU, dataI, U_aligned, I_aligned,
           U_dense_slices, I_dense_slices, U_dense_arr, I_dense_arr,
           U_mean_slices, I_mean_slices, perm_A, perm_B, perm_U, perm_I,
           mask_A, mask_B)
    if mesh is not None:
        state, dat = _mesh_place_collective(mesh, state, dat, ring=ring)

    def _ckpt_state(st):
        (Ab, Bb, _Cb, _Db, Co, Do, Aib, Bib) = st
        Ao = blocks_to_orig(Ab, perm_A, m_eff)
        Bo = blocks_to_orig(Bb, perm_B, n_eff)
        return {
            "A": Ao[:, :ka], "B": Bo[:, :kb],
            "biasA": Ao[:, ka] if user_bias else None,
            "biasB": Bo[:, kb] if item_bias else None,
            "C": None if Co is None else Co[:, :kc],
            "D": None if Do is None else Do[:, :kd],
            "Ai": (blocks_to_orig(Aib, perm_A, m_eff)[:, :ki_w]
                   if add_implicit_features else None),
            "Bi": (blocks_to_orig(Bib, perm_B, n_eff)[:, :ki_w]
                   if add_implicit_features else None),
        }

    try:
        for it in range(niter):
            method = ("cg" if (use_cg and not (finalize_chol
                                               and it == niter - 1))
                      else "chol")
            t0 = time.time()
            state = run_iteration(method, state, dat)
            if verbose:
                _ = float(jnp.sum(state[0][0]))  # fence the device queue
                print(f"iter {it + 1}/{niter} [{method}] "
                      f"{time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _ckpt_state(state))
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        # return the partially-fit model (the reference's handle_interrupt,
        # /root/reference/src/helpers.c:1493, act_on_interrupt cmfrec.h:622)
        print("interrupted — returning partially-fit model")

    # the return layout IS the checkpoint layout (1:1 with init=) — built
    # from the same extraction helper so they can never desync
    out = {key: (None if v is None else np.asarray(v))
           for key, v in _ckpt_state(state).items()}
    out.update({
        "U_colmeans": None if U is None else U.colmeans,
        "I_colmeans": None if I is None else I.colmeans,
        "scaling_biasA": scaling_biasA, "scaling_biasB": scaling_biasB,
        "glob_mean": float(glob_mean),
        "k": k,
    })
    return out


# --------------------------------------------------------------------- #
# implicit collective fit                                                #
# --------------------------------------------------------------------- #


@profiled_fit
def fit_collective_implicit_als(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None,
    k=50, k_user=0, k_item=0, k_main=0,
    lambda_=1.0, l1_lambda=0.0,
    w_main=1.0, w_user=1.0, w_item=1.0,
    alpha=1.0, apply_log_transf=False, adjust_weight=False,
    niter=10, use_cg=True, max_cg_steps=3, precondition_cg=False,
    finalize_chol=False,
    center_U=True, center_I=True,
    NA_as_zero_user=False, NA_as_zero_item=False,
    nonneg=False, nonneg_C=False, nonneg_D=False, max_cd_steps=100,
    dtype=np.float32, seed=1, verbose=False,
    mesh=None,  # jax.sharding.Mesh: row-parallel multi-chip fit
    init=None,  # warm restart (reset_values=False analog): dict with any
    # of A/B/C/D to continue training from
    checkpoint_path=None,  # mid-fit periodic checkpoints
    checkpoint_every=0,  # every N iterations (utils/checkpoint.py)
    shard_opposing_rows=False,  # big-axis mode (see fit_collective_explicit_als)
) -> dict:
    """WRMF with side info (/root/reference/src/collective.c:9375)."""
    dtype = np.dtype(dtype)
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter)
    ring = bool(shard_opposing_rows)
    if ring:
        if mesh is None:
            raise ValueError("shard_opposing_rows requires mesh=")
        if use_cg:
            raise ValueError(
                "shard_opposing_rows supports Cholesky/CD solves only "
                "(truncated CG would cost one ring per matvec); "
                "pass use_cg=False"
            )
    if nonneg:
        use_cg = False

    vals = np.asarray(vals, np.float64)
    if apply_log_transf:
        vals = np.log(vals)
    w_mult = 1.0
    if adjust_weight:
        w_mult = len(vals) / (float(m) * float(n))
    w_x = w_main * w_mult

    side_U = _sparsify_short_dense_side(side_U, m)
    side_I = _sparsify_short_dense_side(side_I, n)
    U = prepare_side(side_U, center_U, NA_as_zero_user, dtype)
    I = prepare_side(side_I, center_I, NA_as_zero_item, dtype)
    m_eff = max(m, U.n_ent if U else 0)
    n_eff = max(n, I.n_ent if I else 0)

    # fused dense-confidence fast path (dense side info, no k splits)
    from ..config import dense_budget_bytes, exact_dense_enabled, on_accelerator

    budget_i = dense_budget_bytes()
    use_dense_pallas = (
        mesh is None
        and on_accelerator()
        and os.environ.get("CMFREC_TPU_NO_PALLAS", "0") != "1"
        and np.dtype(dtype) == np.float32
        # use_cg=False rides the fused engine in exact mode (Krylov-capped
        # converged CG, see drivers.fit_explicit_als)
        and (use_cg or exact_dense_enabled())
        # the fused kernels implement plain CG only (same exclusion as
        # drivers.fit_explicit_als) — PCG fits stay on the bucketed path
        and not (use_cg and precondition_cg)
        and _init_dense_ok(init)  # A/B/bias warm restarts ride along
        and not (nonneg or nonneg_C or nonneg_D)
        and not np.any(l16 > 0)
        and not (NA_as_zero_user or NA_as_zero_item)
        and k_user == 0 and k_item == 0 and k_main == 0
        and m_eff == m and n_eff == n
        and (U is None or U.dense is not None)
        and (I is None or I.dense is not None)
    )
    if use_dense_pallas:
        from ..ops.masked_matmul import pad_dim as _pd

        _mp, _np_ = _pd(m), _pd(n)
        if (_mp * _np_ >= np.iinfo(np.int32).max
                or _mp * _np_ * 10 > budget_i):
            use_dense_pallas = False
    if use_dense_pallas:
        from .dense_pallas import fit_collective_implicit_dense_pallas

        res = fit_collective_implicit_dense_pallas(
            rows, cols, vals, m, n,
            U_dense=None if U is None else U.dense,
            I_dense=None if I is None else I.dense,
            k=k, lam6=lam6, w_user=w_user, w_item=w_item, niter=niter,
            max_cg_steps=max_cg_steps,
            finalize_steps=int(os.environ.get("CMFREC_TPU_FINALIZE_STEPS",
                                              "16")),
            finalize_chol=finalize_chol, alpha=alpha,
            w_main_multiplier=w_x, dtype=dtype, seed=seed,
            verbose=verbose, exact=not use_cg, init=init,
        )
        res["U_colmeans"] = None if U is None else U.colmeans
        res["I_colmeans"] = None if I is None else I.colmeans
        return res

    from .drivers import _build_pair

    _rb = _mesh_row_block(mesh)
    _rbkw = {} if _rb is None else {"row_block": _rb}
    if m_eff == m and n_eff == n:
        RB, CB = _build_pair(rows, cols, vals.astype(dtype), m, n, None,
                             dtype, row_block=_rb)
    else:
        RB = build_bucketed_rows(rows, cols, vals.astype(dtype), m_eff, n,
                                 dtype=dtype, **_rbkw)
        CB = build_bucketed_rows(cols, rows, vals.astype(dtype), n_eff, m,
                                 dtype=dtype, **_rbkw)
    if mesh is None:
        RB.device_put()
        CB.device_put()

    ka = k_user + k + k_main
    kb = k_item + k + k_main
    ka_pad = round_up(ka, 8)
    kb_pad = round_up(kb, 8)
    kc = k_user + k
    kd = k_item + k
    kc_pad = round_up(kc, 8)
    kd_pad = round_up(kd, 8)

    key = jax.random.PRNGKey(seed)
    key, A_blocks = init_blocks(key, RB, ka, ka_pad, dtype)
    key, B_blocks = init_blocks(key, CB, kb, kb_pad, dtype)
    if init is not None:
        from .drivers import _seed_factor_blocks
        if init.get("A") is not None:
            A_blocks = _seed_factor_blocks(A_blocks, RB, init["A"], ka, dtype)
        if init.get("B") is not None:
            B_blocks = _seed_factor_blocks(B_blocks, CB, init["B"], kb, dtype)

    def setup_side(S, main_bucketed):
        if S is None:
            return None, None, None, None
        if S.dense is not None:
            return None, None, _bucket_dense_slices(main_bucketed, S.dense, dtype), None
        r_s, c_s, v_s = S.coo
        feat_b = build_bucketed_rows(c_s, r_s, v_s.astype(np.float64), S.p,
                                     S.n_ent, dtype=dtype, **_rbkw)
        aligned = build_aligned_parts(main_bucketed, r_s, c_s, v_s, S.n_ent, dtype)
        mean_slices = None
        if S.na0 and S.colmeans is not None:
            mean_slices = []
            for b in feat_b.buckets:
                ids = feat_b.row_of[b.start : b.start + b.n_rows]
                ms = np.zeros(b.n_rows, dtype)
                ok = ids >= 0
                ms[ok] = S.colmeans[ids[ok]]
                mean_slices.append(jnp.asarray(ms))
        return feat_b, aligned, None, mean_slices

    U_featb, U_aligned, U_dense_slices, U_mean_slices = setup_side(U, RB)
    I_featb, I_aligned, I_dense_slices, I_mean_slices = setup_side(I, CB)

    key2 = jax.random.PRNGKey(seed + 1)
    C_blocks = D_blocks = None
    C_orig = D_orig = None
    init_C = None if init is None else init.get("C")
    init_D = None if init is None else init.get("D")
    if U is not None:
        if U.dense is not None:
            C_orig = 0.01 * jax.random.normal(key2, (U.p, kc_pad), dtype)
            C_orig = C_orig.at[:, kc:].set(0.0)
            if init_C is not None:
                C_orig = C_orig.at[:, :kc].set(
                    jnp.asarray(np.asarray(init_C, dtype)))
        else:
            key2, C_blocks = init_blocks(key2, U_featb, kc, kc_pad, dtype)
            if init_C is not None:
                from .drivers import _seed_factor_blocks
                C_blocks = _seed_factor_blocks(
                    C_blocks, U_featb, init_C, kc, dtype)
            C_orig = blocks_to_orig(C_blocks, jnp.asarray(U_featb.perm), U.p)
    if I is not None:
        if I.dense is not None:
            key2, sub = jax.random.split(key2)
            D_orig = 0.01 * jax.random.normal(sub, (I.p, kd_pad), dtype)
            D_orig = D_orig.at[:, kd:].set(0.0)
            if init_D is not None:
                D_orig = D_orig.at[:, :kd].set(
                    jnp.asarray(np.asarray(init_D, dtype)))
        else:
            key2, D_blocks = init_blocks(key2, I_featb, kd, kd_pad, dtype)
            if init_D is not None:
                from .drivers import _seed_factor_blocks
                D_blocks = _seed_factor_blocks(
                    D_blocks, I_featb, init_D, kd, dtype)
            D_orig = blocks_to_orig(D_blocks, jnp.asarray(I_featb.perm), I.p)

    lam_vec_A = _make_lam_vec(ka, ka_pad, lam6[2], 0.0, False, dtype)
    lam_vec_B = _make_lam_vec(kb, kb_pad, lam6[3], 0.0, False, dtype)
    lam_vec_C = _make_lam_vec(kc, kc_pad, lam6[4], 0.0, False, dtype)
    lam_vec_D = _make_lam_vec(kd, kd_pad, lam6[5], 0.0, False, dtype)
    l1_vec_A = _make_l1_vec(ka, ka_pad, l16[2], 0.0, False, dtype)
    l1_vec_B = _make_l1_vec(kb, kb_pad, l16[3], 0.0, False, dtype)
    l1_vec_C = _make_l1_vec(kc, kc_pad, l16[4], 0.0, False, dtype)
    l1_vec_D = _make_l1_vec(kd, kd_pad, l16[5], 0.0, False, dtype)

    plan_A = SidePlan(None, "implicit", n)
    plan_B = SidePlan(None, "implicit", m)

    perm_A = jnp.asarray(RB.perm)
    perm_B = jnp.asarray(CB.perm)
    perm_U = (None if (U is None or U.dense is not None)
              else jnp.asarray(U_featb.perm))
    perm_I = (None if (I is None or I.dense is not None)
              else jnp.asarray(I_featb.perm))
    dataA = bucket_arrays(RB)
    dataB = bucket_arrays(CB)
    dataU = None if U_featb is None else bucket_arrays(U_featb)
    dataI = None if I_featb is None else bucket_arrays(I_featb)
    U_dense_arr = None if (U is None or U.dense is None) else jnp.asarray(U.dense)
    I_dense_arr = None if (I is None or I.dense is None) else jnp.asarray(I.dense)

    mask_A = mask_B = None
    if ring:
        (dataA, dataB, dataU, dataI, mask_A, mask_B,
         U_dense_arr, I_dense_arr) = _ring_setup_collective(
            RB, CB, dataA, dataB, dataU, dataI, U, I, dtype)

    def _ring_cat(blocks, mask):
        from .drivers import _ring_cat_blocks

        return _ring_cat_blocks(blocks, mask, mesh)

    # X-dimension opposing-row masks: the shared Gram/rhs bases of the
    # B/A (and Bi/Ai, C/D) systems must sum over the X (or side)
    # dimension only — with extra side-only entities (m_u > m or
    # n_i > n, _supports_extra_side_rows) the factor matrices carry live
    # rows beyond the X dims which the reference's opposing row counts
    # exclude (optimizeA calls pass m/n, collective.c:8461/9924).
    # All-ones (an exact no-op) in the common m_u == m case.
    _npdt = np.float64 if np.dtype(dtype) == np.float64 else np.float32

    def _xdim_mask(limit, total, perm_np, concat_mask):
        if not ring:
            return jnp.asarray((np.arange(total) < limit).astype(_npdt))
        v = np.zeros(int(concat_mask.shape[0]), _npdt)
        v[np.asarray(perm_np)[:limit]] = 1.0
        return jnp.asarray(v)

    xmask_A = _xdim_mask(m, m_eff, RB.perm, mask_A)
    xmask_B = _xdim_mask(n, n_eff, CB.perm, mask_B)
    xmask_AU = (None if U is None or U.n_ent >= m_eff
                else _xdim_mask(U.n_ent, m_eff, RB.perm, mask_A))
    xmask_BI = (None if I is None or I.n_ent >= n_eff
                else _xdim_mask(I.n_ent, n_eff, CB.perm, mask_B))

    def factor_update(main_blocks, plan, main_data, opp_main, lam_vec,
                      l1_vec, method, S, S_aligned, S_dense_slices, C_mat,
                      kx, w_side):
        G0 = jnp.asarray(w_x, dtype) * gram_matrix(opp_main)
        r0_vec = None
        r0_blocks = None
        extra = None
        n_buckets = len(main_data)
        if S is not None:
            Ce = _pad_cols(C_mat[:, :kx], lam_vec.shape[0], 0, dtype)
            if S.dense is not None:
                G0 = G0 + jnp.asarray(w_side, dtype) * gram_matrix(Ce)
                r0_blocks = [
                    _dense_rhs(sl, Ce, jnp.asarray(w_side, dtype))
                    for sl in S_dense_slices
                ]
            else:
                extra = [[] for _ in range(n_buckets)]
                s_mode = "na0" if S.na0 else "explicit"
                cm = None
                if S.na0:
                    G0 = G0 + jnp.asarray(w_side, dtype) * gram_matrix(Ce)
                    cm = (
                        jnp.asarray(S.colmeans.astype(dtype))
                        if S.colmeans is not None else None
                    )
                    rv = jnp.asarray(w_side, dtype) * _na0_rhs_base(Ce, cm, 0.0)
                    r0_vec = rv
                for bi, (idx_s, val_s, len_s) in enumerate(S_aligned):
                    pd = PartData(
                        idx=idx_s, val=val_s, length=len_s, wgt=None,
                        opp=Ce, opp_bias=cm, w=jnp.asarray(w_side, dtype),
                        alpha=None,
                        mu=jnp.asarray(0.0, dtype) if S.na0 else None,
                    )
                    extra[bi].append((pd, s_mode, S.p, False))
        return update_side(
            plan, main_blocks, opp_main, None, lam_vec,
            buckets_data=main_data,
            w=w_x, alpha=alpha, G0=G0, r0_vec=r0_vec, r0_blocks=r0_blocks,
            extra_parts=extra, l1_vec=l1_vec, method=method,
            n_steps=max_cg_steps, nonneg=nonneg, max_cd_steps=max_cd_steps,
            precondition=precondition_cg, dtype=dtype,
            ring_mesh=mesh if ring else None,
        )

    def side_factor_update(S, featb_data, blocks, A1, lam_vec, l1_s, w_side,
                           nonneg_s, method, mean_slices):
        plan = SidePlan(None, "na0" if S.na0 else "explicit", S.n_ent)
        G0 = None
        r0_blocks = None
        if S.na0:
            G0 = jnp.asarray(w_side, dtype) * gram_matrix(A1)
            if mean_slices is not None:
                colsum = jnp.sum(A1, axis=0)
                r0_blocks = [
                    -jnp.asarray(w_side, dtype) * ms[:, None] * colsum[None, :]
                    for ms in mean_slices
                ]
        return update_side(
            plan, blocks, A1, None, lam_vec, w=w_side, G0=G0,
            buckets_data=featb_data,
            r0_blocks=r0_blocks, l1_vec=l1_s, method=method,
            n_steps=max_cg_steps, nonneg=nonneg_s, max_cd_steps=max_cd_steps,
            precondition=precondition_cg, dtype=dtype,
            ring_mesh=mesh if ring else None,
        )

    def _one_iteration(method, state, dat):
        """One full implicit-collective iteration (C, D, B, A) as a pure
        function — runs under one jit on the GPU (see the explicit fit)."""
        A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig = state
        (dA, dB, dU, dI, U_al, I_al, U_ds, I_ds, U_dn, I_dn,
         U_ms, I_ms, pA, pB, pU, pI, mkA, mkB) = dat

        if ring:
            A_orig = _ring_cat(A_blocks, mkA)
            B_orig = _ring_cat(B_blocks, mkB)
        else:
            A_orig = blocks_to_orig(A_blocks, pA, m_eff)
            B_orig = blocks_to_orig(B_blocks, pB, n_eff)

        if U is not None:
            A1 = _pad_cols(A_orig[:, :kc], kc_pad, 0, dtype)
            if U_dn is not None:
                A1u = (A1[:U.n_ent] if (not ring and U.n_ent < A1.shape[0])
                       else A1)
                C_orig = _dense_full_solve(
                    A1u, U_dn, lam_vec_C, w_user, nonneg_C,
                    l1_vec_C, max_cd_steps, dtype,
                )
            else:
                if xmask_AU is not None and not U.na0:
                    # under NA_as_zero_U the rows beyond the side matrix
                    # are genuine all-zero side rows (include them)
                    A1 = A1 * xmask_AU[:, None]
                C_blocks = side_factor_update(
                    U, dU, C_blocks, A1, lam_vec_C, l1_vec_C, w_user,
                    nonneg_C, method, U_ms,
                )
                C_orig = blocks_to_orig(C_blocks, pU, U.p)

        if I is not None:
            B1 = _pad_cols(B_orig[:, :kd], kd_pad, 0, dtype)
            if I_dn is not None:
                B1i = (B1[:I.n_ent] if (not ring and I.n_ent < B1.shape[0])
                       else B1)
                D_orig = _dense_full_solve(
                    B1i, I_dn, lam_vec_D, w_item, nonneg_D,
                    l1_vec_D, max_cd_steps, dtype,
                )
            else:
                if xmask_BI is not None and not I.na0:
                    B1 = B1 * xmask_BI[:, None]
                D_blocks = side_factor_update(
                    I, dI, D_blocks, B1, lam_vec_D, l1_vec_D, w_item,
                    nonneg_D, method, I_ms,
                )
                D_orig = blocks_to_orig(D_blocks, pI, I.p)

        # B update
        opp = jnp.zeros((A_orig.shape[0], kb_pad), dtype)
        opp = opp.at[:, k_item : k_item + k + k_main].set(
            A_orig[:, k_user : k_user + k + k_main]
        )
        opp = opp * xmask_A[:, None]  # shared Gram sums the X rows only
        B_blocks = factor_update(
            B_blocks, plan_B, dB, opp, lam_vec_B, l1_vec_B, method,
            I, I_al, I_ds, D_orig, kd, w_item,
        )
        B_orig = (_ring_cat(B_blocks, mkB) if ring
                  else blocks_to_orig(B_blocks, pB, n_eff))

        # A update
        opp = jnp.zeros((B_orig.shape[0], ka_pad), dtype)
        opp = opp.at[:, k_user : k_user + k + k_main].set(
            B_orig[:, k_item : k_item + k + k_main]
        )
        opp = opp * xmask_B[:, None]
        A_blocks = factor_update(
            A_blocks, plan_A, dA, opp, lam_vec_A, l1_vec_A, method,
            U, U_al, U_ds, C_orig, kc, w_user,
        )
        return (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig)

    fuse_env = os.environ.get("CMFREC_TPU_FUSE_COLLECTIVE", "auto")
    if fuse_env == "auto":
        do_fuse = on_accelerator()  # see fit_collective_explicit_als
    else:
        do_fuse = fuse_env == "1"
    if do_fuse:
        from functools import partial as _partial

        _jit_iter = {}

        def run_iteration(method, state, dat):
            if method not in _jit_iter:
                _jit_iter[method] = jax.jit(_partial(_one_iteration, method))
            return _jit_iter[method](state, dat)
    else:
        run_iteration = _one_iteration

    state = (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig)
    dat = (dataA, dataB, dataU, dataI, U_aligned, I_aligned,
           U_dense_slices, I_dense_slices, U_dense_arr, I_dense_arr,
           U_mean_slices, I_mean_slices, perm_A, perm_B, perm_U, perm_I,
           mask_A, mask_B)
    if mesh is not None:
        state, dat = _mesh_place_collective(mesh, state, dat, ring=ring)

    def _ckpt_state(st):
        (Ab, Bb, _Cb, _Db, Co, Do) = st
        return {
            "A": blocks_to_orig(Ab, perm_A, m_eff)[:, :ka],
            "B": blocks_to_orig(Bb, perm_B, n_eff)[:, :kb],
            "C": None if Co is None else Co[:, :kc],
            "D": None if Do is None else Do[:, :kd],
        }

    try:
        for it in range(niter):
            method = ("cg" if (use_cg and not (finalize_chol
                                               and it == niter - 1))
                      else "chol")
            t0 = time.time()
            state = run_iteration(method, state, dat)
            if verbose:
                _ = float(jnp.sum(state[0][0]))  # fence the device queue
                print(f"iter {it + 1}/{niter} [{method}] "
                      f"{time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _ckpt_state(state))

    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    # return layout == checkpoint layout (1:1 with init=) by construction
    out = {key: (None if v is None else np.asarray(v))
           for key, v in _ckpt_state(state).items()}
    out.update({
        "U_colmeans": None if U is None else U.colmeans,
        "I_colmeans": None if I is None else I.colmeans,
        "glob_mean": 0.0,
        "w_main_multiplier": w_mult,
        "alpha": alpha,
        "k": k,
    })
    return out
