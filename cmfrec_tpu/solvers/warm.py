"""Warm- and cold-start factor inference for fitted models.

Implements the reference's collective_factors_warm / collective_factors_cold
/ factors_implicit (/root/reference/src/collective.c:3555,3309,
/root/reference/src/common.c:2063) as batched closed-form solves: new rows
never use CG (the reference notes CG "should not be used for new data",
/root/reference/src/common.c:650).

build_precomputed assembles the prediction-time caches corresponding to
precompute_collective_explicit (/root/reference/src/collective.c:10209):
the extended Gram BtB (and CtC for side info), kept on device for repeated
warm/cold calls.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ops import rowsolve
from ..ops.rowsolve import SparsePart, length_mask
from .als import gram_matrix
from .drivers import _make_lam_vec, _resolve_lambdas, round_up


def _ext_B(model):
    """Extended opposing matrix for a new-user solve: coords
    [k_user | k | k_main | bias] built from B[:, k_item:] (+ ones).
    Served from the model's precompute cache when present
    (force_precompute_for_predictions /
    /root/reference/src/collective.c:10209)."""
    pre = getattr(model, "_precomputed", None) or {}
    if "extB" in pre:
        return pre["extB"], pre["width"], pre["k_pad"], pre["user_bias"]
    k = model.k
    ku = getattr(model, "k_user", 0)
    km = getattr(model, "k_main", 0)
    user_bias = model.user_bias_ is not None
    width = ku + k + km
    k_pad = round_up(width + 1, 8)
    B = np.asarray(model.B_, np.float64)
    n = B.shape[0]
    ki = getattr(model, "k_item", 0)
    ext = np.zeros((n, k_pad))
    ext[:, ku : ku + k + km] = B[:, ki:]
    if user_bias:
        ext[:, width] = 1.0
    return ext, width, k_pad, user_bias


def _ext_C(model, k_pad):
    """C occupies coords [0 : k_user+k] of the user system."""
    pre = getattr(model, "_precomputed", None) or {}
    if "extC" in pre and pre["extC"].shape[1] == k_pad:
        return pre["extC"]
    C = np.asarray(model.C_, np.float64)
    p = C.shape[0]
    ext = np.zeros((p, k_pad))
    ext[:, : C.shape[1]] = C
    return ext


def _u_part(model, U, k_pad, dtype):
    """Dense new-user side-info rows (NaN = missing) -> SparsePart inputs.

    Under NA_as_zero_user the missing entries participate with value 0
    (minus the column means): the part carries only observed-entry
    corrections (cw = 0, cv = w_u * raw value) on top of the shared
    G0 = w_u CtC and r0 = CtUbias bases returned alongside
    (/root/reference/src/collective.c:3389 NA_as_zero_U + :10466).
    Returns (part, counts, G0_extra, r0_vec_extra)."""
    if U is None or model.C_ is None:
        return None
    na0_u = bool(getattr(model, "NA_as_zero_user", False))
    U = np.asarray(U, np.float64)
    if model.U_colmeans_ is not None and not na0_u:
        U = U - model.U_colmeans_[None, :]
    R, p = U.shape
    obs = ~np.isnan(U)
    rows, cols = np.nonzero(obs)
    idx, vals, _, counts = pack_padded_rows(rows, cols, U[rows, cols], None, R)
    L = idx.shape[1]
    Ce = _ext_C(model, k_pad)
    msk = (np.arange(L)[None, :] < counts[:, None]).astype(np.float64)
    w_user = getattr(model, "w_user", 1.0)
    G0x = r0x = None
    if na0_u:
        cw = np.zeros_like(msk)
        cv = w_user * vals * msk
        pre = getattr(model, "_precomputed", None) or {}
        stats = model.__dict__.setdefault("_cache_stats", {})
        if "CtCw" in pre:
            CtCw = pre["CtCw"]
            stats["ctcw"] = stats.get("ctcw", 0) + 1
        else:
            CtCw = w_user * (Ce.T @ Ce)
        G0x = jnp.asarray(_pad_sq(CtCw, k_pad), dtype)
        if model.U_colmeans_ is not None:
            if "CtUbias" in pre:
                ctu = pre["CtUbias"]
            else:
                kc = np.asarray(model.C_).shape[1]
                ctu = -w_user * (Ce[:, :kc].T
                                 @ np.asarray(model.U_colmeans_))
            r0np = np.zeros(k_pad)
            r0np[: ctu.shape[0]] = ctu
            r0x = jnp.asarray(r0np, dtype)
    else:
        cw = w_user * msk
        cv = w_user * vals * msk
    part = SparsePart(
        _dev_cached(model, "extC_dev", Ce, dtype,
                    token=id(model.C_)), jnp.asarray(idx),
        jnp.asarray(cw, dtype),
        jnp.asarray(cv, dtype),
    )
    return part, counts, G0x, r0x


def _dev_cached(model, name, arr, dtype, token=None):
    """Device-resident dtype-cast copy of a precompute matrix, memoized in
    the model's precompute dict (dropped with it on refit).  Without this
    every warm call re-casts and re-uploads the [n, k_pad] extended
    matrix — at serving batch rates the uploads dominate the solves.

    Staleness: small arrays (lam vectors, scalars) key by VALUE; big
    matrices key by the id() of the model attribute they derive from
    (``token``), so replacing e.g. ``model.B_`` post-fit invalidates the
    device copy even without a refit (a refit replaces the whole
    precompute dict anyway)."""
    pre = getattr(model, "_precomputed", None)
    if pre is None:
        return jnp.asarray(arr, dtype)
    arr = np.asarray(arr)
    if token is None:
        token = arr.tobytes() if arr.size <= 256 else id(arr)
    key = (name, np.dtype(dtype).str, arr.shape, token)
    ent = pre.get(key)
    if ent is None:
        ent = jnp.asarray(arr, dtype)
        pre[key] = ent
    return ent


def _pad_sq(M, k_pad):
    if M.shape[0] == k_pad:
        return M
    out = np.zeros((k_pad, k_pad))
    out[: M.shape[0], : M.shape[1]] = M
    return out


def _trans_btb_inv_bt(model):
    """Lazy TransBtBinvBt = (w BtB + diag(lam))^-1 w extB^T
    (/root/reference/src/collective.c:10363): built on first use and
    memoized in the precompute dict."""
    pre = getattr(model, "_precomputed", None) or {}
    if "TransBtBinvBt" in pre:
        return pre["TransBtBinvBt"]
    if "TransBtBinvBt_G" not in pre:
        return None
    w_main = float(getattr(model, "w_main", 1.0)) * float(
        getattr(model, "w_main_multiplier_", 1.0))
    T = np.linalg.solve(pre["TransBtBinvBt_G"], w_main * pre["extB"].T)
    pre["TransBtBinvBt"] = T
    return T


@partial(jax.jit, static_argnames=("w_main", "scale_lam"))
def _warm_plain_kernel(ext, idx, vals, lengths, item_bias, glob_mean,
                       lam_vec, lam_const, w_main, scale_lam):
    """Fused plain-warm solve: mask, residual (mean + item bias), Gram,
    and batched Cholesky in ONE executable, fed by raw idx/vals uploads.
    The eager path ships host-computed [R, L] cw/cv (16 B/slot) and pays
    several dispatches; at serving rates the uploaded bytes and dispatch
    latency can outweigh the actual solves."""
    L = idx.shape[1]
    dt = ext.dtype
    msk = (jnp.arange(L)[None, :] < lengths[:, None]).astype(dt)
    v = vals.astype(dt) - glob_mean - jnp.take(item_bias, idx)
    cw = w_main * msk
    cv = cw * v
    lam_mult = (jnp.maximum(lengths, 1).astype(dt) if scale_lam else None)
    G, rhs = rowsolve.assemble_system(
        [SparsePart(ext, idx, cw, cv)], lam_vec, lam_mult=lam_mult)
    # scale_bias_const: the bias coordinate's penalty stays at
    # lam_bias * scaling_biasA regardless of the per-row multiplier
    # (common.c:717-722); zeros when unused
    G = G + jnp.diag(lam_const)[None, :, :]
    a = rowsolve.solve_chol(G, rhs)
    return jnp.where(lengths[:, None] == 0, jnp.zeros((), dt), a)


def factors_explicit_batch(model, idx, vals, wgt, lengths, U=None,
                           return_device=False, _no_fused=False):
    """Closed-form warm factors for a batch of new users.

    idx/vals/wgt: [R, L] padded item ids / (raw) values / weights;
    lengths: [R] observation counts; U: optional [R, p] dense side info.
    Returns (a [R, k_user+k+k_main], bias [R]).  ``return_device=True``
    keeps the results as device arrays (no sync) so callers batching many
    sub-calls (factors_explicit_grouped) pay ONE download at the end.
    ``_no_fused=True`` forces the eager multi-dispatch path (tests pin
    the fused kernel against it).
    """
    dtype = jnp.float64 if np.dtype(model.dtype_) == np.float64 else jnp.float32
    ext, width, k_pad, user_bias = _ext_B(model)
    lam6, l16 = _resolve_lambdas(model.lambda_, getattr(model, "l1_lambda", 0.0))
    k = model.k
    ku = getattr(model, "k_user", 0)
    km = getattr(model, "k_main", 0)
    pre = getattr(model, "_precomputed", None) or {}
    stats = model.__dict__.setdefault("_cache_stats", {})

    R, L = idx.shape

    has_bi = getattr(model, "Bi_", None) is not None

    # Cold fast path: side-info-only rows with a full observation go through
    # the TransCtCinvCt cache — ONE matmul, no per-call factorization
    # (the reference's use at /root/reference/src/collective.c:3389).
    # The reference only dispatches to collective_factors_cold when
    # !add_implicit_features (collective.c:3656); with Bi present, cold
    # rows go through the warm path and pick up the BiTBi Gram below.
    if (L == 0 and U is not None and "TransCtCinvCt" in pre
            and not has_bi
            and not getattr(model, "NA_as_zero", False)
            and not getattr(model, "NA_as_zero_user", False)
            and not getattr(model, "nonneg", False)
            and not np.any(l16 > 0)):
        Uarr = np.asarray(U, np.float64)
        if not np.isnan(Uarr).any():
            if model.U_colmeans_ is not None:
                Uarr = Uarr - np.asarray(model.U_colmeans_)[None, :]
            T = pre["TransCtCinvCt"]  # [kc, p]
            a = np.zeros((Uarr.shape[0], ku + k + km))
            a[:, : T.shape[0]] = Uarr @ T.T
            stats["cold_matmul"] = stats.get("cold_matmul", 0) + 1
            return a, np.zeros(Uarr.shape[0])
    # Fused plain-warm path (the common serving shape): everything the
    # eager path computes on host over [R, L] float64 — mask, centering,
    # item-bias gather, cw/cv — moves into one device executable, halving
    # the wire (raw i32 idx + vals only) and collapsing the dispatches.
    if (not _no_fused and L > 0 and wgt is None and U is None
            and not has_bi
            and not getattr(model, "NA_as_zero", False)
            and not getattr(model, "nonneg", False)
            and not np.any(l16 > 0)
            and not getattr(model, "scale_lam_sideinfo", False)
            and not (L == ext.shape[0] and "TransBtBinvBt_G" in pre)):
        ib = (np.zeros(ext.shape[0]) if model.item_bias_ is None
              else np.asarray(model.item_bias_, np.float64))
        lam_np = np.ones(k_pad)
        lam_np[: ku + k + km] = lam6[2]
        lam_const_np = np.zeros(k_pad)
        if user_bias:
            lam_np[width] = lam6[0]
            if (getattr(model, "scale_lam", False)
                    and getattr(model, "scale_bias_const", False)):
                # hold the bias penalty at lam_bias * scaling_biasA
                # constant (common.c:717-722; scaling = fit-time wsum/m,
                # collective.c:3787)
                lam_np[width] = 0.0
                lam_const_np[width] = lam6[0] * float(
                    getattr(model, "scaling_biasA_", 0.0))
        vdt = np.float64 if dtype == jnp.float64 else np.float32
        a = _warm_plain_kernel(
            _dev_cached(model, "extB_dev", ext, dtype,
                        token=id(model.B_)),
            jnp.asarray(np.ascontiguousarray(idx, np.int32)),
            jnp.asarray(np.ascontiguousarray(vals, vdt)),
            jnp.asarray(np.ascontiguousarray(lengths, np.int32)),
            _dev_cached(model, "item_bias_dev", ib, dtype,
                        token=(0 if model.item_bias_ is None
                               else id(model.item_bias_))),
            _dev_cached(model, "glob_mean_dev",
                        np.asarray(model.glob_mean_), dtype),
            _dev_cached(model, "lam_vec_warm_dev", lam_np, dtype),
            _dev_cached(model, "lam_const_warm_dev", lam_const_np, dtype),
            w_main=float(getattr(model, "w_main", 1.0)),
            scale_lam=bool(getattr(model, "scale_lam", False)))
        stats["warm_fused"] = stats.get("warm_fused", 0) + 1
        if return_device:
            bias = a[:, width] if user_bias else jnp.zeros(R, dtype)
            return a[:, : ku + k + km], bias
        a = np.array(a)
        bias = a[:, width] if user_bias else np.zeros(R)
        return a[:, : ku + k + km], bias

    msk = (np.arange(max(L, 1))[None, :] < lengths[:, None]).astype(np.float64)
    v = np.asarray(vals, np.float64) - model.glob_mean_
    if model.item_bias_ is not None and L > 0:
        v = v - model.item_bias_[np.asarray(idx, np.int64)]
    w_main = getattr(model, "w_main", 1.0)
    ww = np.ones((R, L)) if wgt is None else np.asarray(wgt, np.float64)
    na0 = bool(getattr(model, "NA_as_zero", False))

    # Fully-observed unweighted warm rows (dense transform workloads):
    # ONE matmul through the lazy TransBtBinvBt cache
    # (/root/reference/src/collective.c:10363 usage at :3790).
    n_items = ext.shape[0]
    if (L == n_items and wgt is None and not na0 and U is None
            and not getattr(model, "nonneg", False)
            and not np.any(l16 > 0)
            and not getattr(model, "scale_lam", False)
            and not getattr(model, "scale_lam_sideinfo", False)
            and "TransBtBinvBt_G" in pre
            and np.all(np.asarray(lengths) == n_items)
            and np.array_equal(
                np.asarray(idx),
                np.broadcast_to(np.arange(n_items), (R, n_items)))):
        T = _trans_btb_inv_bt(model)
        if T is not None:
            a = v @ T.T  # [R, k_pad]
            stats["warm_dense_matmul"] = stats.get(
                "warm_dense_matmul", 0) + 1
            bias = a[:, width] if user_bias else np.zeros(R)
            return a[:, : ku + k + km], bias

    parts = []
    G0 = None
    r0 = None
    if L > 0:
        if na0:
            cw = w_main * (ww - 1.0) * msk
            cv = w_main * (ww * v + (model.glob_mean_
                  + (model.item_bias_[np.asarray(idx, np.int64)]
                     if model.item_bias_ is not None else 0.0))) * msk
        else:
            cw = w_main * ww * msk
            cv = cw * v
        parts.append(SparsePart(
            _dev_cached(model, "extB_dev", ext, dtype,
                        token=id(model.B_)), jnp.asarray(idx),
            jnp.asarray(cw, dtype), jnp.asarray(cv, dtype),
        ))
    if na0:
        if "BtBw" in pre and "BtXbias" in pre:
            # served from the precompute caches (BtB / BtXbias,
            # /root/reference/src/collective.c:10300-10352)
            G0 = jnp.asarray(pre["BtBw"], dtype)
            r0 = jnp.asarray(pre["BtXbias"], dtype)[None, :] * jnp.ones(
                (R, 1), dtype)
            stats["na0_base"] = stats.get("na0_base", 0) + 1
        else:
            G0 = w_main * gram_matrix(jnp.asarray(ext, dtype))
            t = -model.glob_mean_ * np.ones(ext.shape[0])
            if model.item_bias_ is not None:
                t = t - model.item_bias_
            r0 = jnp.asarray(w_main * ext.T @ t, dtype)[None, :] * jnp.ones(
                (R, 1), dtype)

    # implicit-features part (add_implicit_features): Xones ~ a[ku:] Bi^T
    # treated NA-as-zero — Gram base w_imp*BiTBi, rhs w_imp * sum_obs Bi_j
    # (/root/reference/src/collective.c:1428-1443 + BiTBi at :1465).
    # The Gram base applies to cold (L==0) rows too: the reference routes
    # add_implicit_features cold solves through the warm path
    # (collective.c:3656 requires !add_implicit_features for the cold
    # dispatch), which adds BiTBi unconditionally (collective.c:1487).
    if has_bi:
        Bi = np.asarray(model.Bi_, np.float64)
        kiw = Bi.shape[1]
        wi = float(getattr(model, "w_implicit", 0.5))
        if "extBi" in pre and "BiTBi" in pre:
            ext_bi = pre["extBi"]
            Gi = jnp.asarray(pre["BiTBi"], dtype)
            stats["bitbi"] = stats.get("bitbi", 0) + 1
        else:
            ext_bi = np.zeros((Bi.shape[0], k_pad))
            ext_bi[:, ku : ku + kiw] = Bi
            Gnp = np.zeros((k_pad, k_pad))
            Gnp[ku : ku + kiw, ku : ku + kiw] = wi * (Bi.T @ Bi)
            Gi = jnp.asarray(Gnp, dtype)
        G0 = Gi if G0 is None else G0 + Gi
        if L > 0:
            parts.append(SparsePart(
                _dev_cached(model, "extBi_dev", ext_bi, dtype,
                        token=id(model.Bi_)),
                jnp.asarray(idx),
                jnp.asarray(np.zeros((R, L)), dtype),
                jnp.asarray(wi * msk, dtype),
            ))

    lam_mult = None
    u_counts = 0
    up = _u_part(model, U, k_pad, dtype) if U is not None else None
    if up is not None:
        parts.append(up[0])
        u_counts = up[1]
        if up[2] is not None:  # NA_as_zero_user: shared w_u CtC base
            G0 = up[2] if G0 is None else G0 + up[2]
        if up[3] is not None:  # CtUbias centering term
            r0u = up[3][None, :] * jnp.ones((R, 1), dtype)
            r0 = r0u if r0 is None else r0 + r0u

    scale_l = bool(getattr(model, "scale_lam", False))
    scale_si = bool(getattr(model, "scale_lam_sideinfo", False))
    if scale_l or scale_si:
        # scale_lam_sideinfo implies scaling even when scale_lam is off
        # (collective.c:1286 gates on scale_lam || scale_lam_sideinfo).
        if na0:
            # weighted: wsum over observed + 1 per missing entry; unweighted
            # degenerates to the full column count (common.c:708-710)
            base = ((ww * msk).sum(axis=1)
                    + (float(ext.shape[0]) - np.asarray(lengths, np.float64)))
        else:
            base = (ww * msk).sum(axis=1)
            # Rows with no X observations: the warm path (taken when Bi is
            # present) uses multiplier 1 (collective.c:1332-1337); the no-Bi
            # cold dispatch scales by the side count only (collective.c:3656
            # -> factors_closed_form with u as the data vector).
            base = np.where(np.asarray(lengths, np.float64) > 0, base,
                            1.0 if has_bi else 0.0)
        if scale_si and np.ndim(u_counts):
            base = base + u_counts
        lam_mult = jnp.asarray(np.maximum(base, 1.0), dtype)

    lam_vec = np.ones(k_pad)
    lam_vec[: ku + k + km] = lam6[2]
    if user_bias:
        lam_vec[width] = lam6[0]
    if (lam_mult is not None and user_bias
            and bool(getattr(model, "scale_bias_const", False))):
        # scale_bias_const: the bias coordinate's penalty is
        # lam_bias * scaling_biasA, CONSTANT across rows — not scaled by
        # the per-row multiplier (common.c:717-722; the scaling constant
        # is the fit-time mean observation weight, collective.c:3787)
        bias_const = np.zeros((k_pad, k_pad))
        bias_const[width, width] = lam6[0] * float(
            getattr(model, "scaling_biasA_", 0.0))
        lam_vec[width] = 0.0
        Gc = jnp.asarray(bias_const, dtype)
        G0 = Gc if G0 is None else G0 + Gc
    lam_vec = jnp.asarray(lam_vec, dtype)

    nonneg = bool(getattr(model, "nonneg", False))

    # BeTBeChol fast path (/root/reference/src/collective.c:1365, cache
    # built at :10425): when every row's Gram equals the cached extended
    # system — fully-observed unweighted X (or NA-as-zero with rhs-only
    # corrections) plus fully-observed dense U — skip the per-row Gram
    # assembly and batched factorization entirely: one rhs matmul plus two
    # triangular solves against the cached Cholesky factor.
    if ("BeTBeChol" in pre and lam_mult is None and not nonneg
            and not np.any(l16 > 0) and up is not None
            and not np.isnan(np.asarray(U, np.float64)).any()):
        n_items = ext.shape[0]
        full_obs = (not na0 and wgt is None and L == n_items
                    and np.all(np.asarray(lengths) == n_items)
                    and np.array_equal(
                        np.asarray(idx),
                        np.broadcast_to(np.arange(n_items), (R, n_items))))
        if full_obs or (na0 and wgt is None):
            rhs = jnp.zeros((R, k_pad), dtype)
            for prt in parts:
                rhs = rhs + rowsolve.part_rhs(prt)
            if r0 is not None:
                rhs = rhs + r0
            Lc = jnp.asarray(pre["BeTBeChol"], dtype)
            y = jax.scipy.linalg.solve_triangular(Lc, rhs.T, lower=True)
            a = jax.scipy.linalg.solve_triangular(
                Lc, y, lower=True, trans=1).T
            stats["bechol"] = stats.get("bechol", 0) + 1
            if not return_device:
                a = np.array(a)
            bias = a[:, width] if user_bias else (
                jnp.zeros(R, dtype) if return_device else np.zeros(R))
            return a[:, : ku + k + km], bias

    G, rhs = rowsolve.assemble_system(parts, lam_vec, lam_mult=lam_mult,
                                      G0=G0, r0=r0)
    if nonneg or np.any(l16 > 0):
        l1v = np.zeros(k_pad)
        l1v[: ku + k + km] = l16[2]
        l1a = jnp.asarray(l1v, dtype)
        if lam_mult is not None:
            # L1 scales with the same per-row multiplier (common.c:717-722)
            l1a = l1a[None, :] * lam_mult[:, None]
        a = rowsolve.solve_cd(G, rhs, l1a, nonneg=nonneg,
                              max_steps=int(getattr(model, "max_cd_steps", 100)))
    else:
        a = rowsolve.solve_chol(G, rhs)
    if return_device:
        # rows with no data anywhere -> zeros (reference zero_out)
        if not na0 and U is None:
            a = jnp.where(jnp.asarray(lengths)[:, None] == 0, 0.0, a)
        bias = a[:, width] if user_bias else jnp.zeros(R, dtype)
        return a[:, : ku + k + km], bias
    a = np.array(a)
    # rows with no data anywhere -> zeros (reference zero_out)
    if not na0 and U is None:
        a[np.asarray(lengths) == 0] = 0.0
    bias = a[:, width] if user_bias else np.zeros(R)
    return a[:, : ku + k + km], bias


def factors_implicit_grouped(model, rows, cols, vals, R, U=None,
                             row_block=128):
    """Degree-grouped implicit-warm factors (see factors_explicit_grouped);
    returns a [R, k_user+k+k_main]."""
    a, _ = factors_explicit_grouped(model, rows, cols, vals, None, R, U=U,
                                    row_block=row_block, implicit=True)
    return a


def factors_explicit_grouped(model, rows, cols, vals, wgt, R, U=None,
                             row_block=128, implicit=False):
    """Degree-grouped batched warm factors for serving-scale batches.

    pack_padded_rows pads every row to the batch's MAX degree; with
    power-law degree profiles (max >> mean) the [R, L] blocks waste
    10-30x host, wire, and solve work.  This groups rows descending by
    degree — cutting a new group when the degree falls below half the
    group's max (padding waste <= 2x, <= ~log2(max_degree) groups) —
    pads group sizes to ``row_block`` multiples and widths to powers of
    two (stable executable shapes across calls), runs each group through
    factors_explicit_batch with device-resident results, and pays ONE
    download at the end.  Row-for-row identical to the ungrouped call.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    counts = np.bincount(rows, minlength=R)
    if R == 0:
        return np.zeros((0, getattr(model, "k_user", 0) + model.k
                         + getattr(model, "k_main", 0))), np.zeros(0)
    order = np.argsort(-counts, kind="stable")
    boundaries = [0]
    for i in range(1, R):
        if counts[order[i]] * 2 < counts[order[boundaries[-1]]]:
            boundaries.append(i)
    boundaries.append(R)

    eorder = np.argsort(rows, kind="stable")
    r_s, c_s, v_s = rows[eorder], cols[eorder], vals[eorder]
    w_s = None if wgt is None else np.asarray(wgt, np.float64)[eorder]
    starts = np.concatenate([[0], np.cumsum(counts)])
    within_all = np.arange(r_s.size) - starts[r_s]
    Uarr = None if U is None else np.asarray(U, np.float64)

    kw = getattr(model, "k_user", 0) + model.k + getattr(model, "k_main", 0)
    # zero-degree rows with nothing else feeding the system are zeros by
    # definition (the reference's zero_out); groups that still need a
    # solve (side info / NA-as-zero / implicit features) keep width >= 1
    plain_zero = (U is None
                  and (implicit
                       or (not getattr(model, "NA_as_zero", False)
                           and getattr(model, "Bi_", None) is None)))
    a_dev, b_dev, spans = [], [], []
    for i0, i1 in zip(boundaries[:-1], boundaries[1:]):
        g_rows = order[i0:i1]
        Lg = int(counts[g_rows[0]])
        if Lg == 0 and plain_zero:
            continue  # outputs pre-zeroed
        Lg_pad = max(int(1 << max(Lg - 1, 0).bit_length()), 1)
        Rg = g_rows.size
        Rg_pad = -(-Rg // row_block) * row_block
        idx_g = np.zeros((Rg_pad, Lg_pad), np.int64)
        val_g = np.zeros((Rg_pad, Lg_pad))
        wgt_g = None if wgt is None else np.zeros((Rg_pad, Lg_pad))
        lens_g = np.zeros(Rg_pad, np.int64)
        lens_g[:Rg] = counts[g_rows]
        if Lg_pad:
            local = np.full(R, -1, np.int64)
            local[g_rows] = np.arange(Rg)
            sel = local[r_s] >= 0
            li, wi = local[r_s[sel]], within_all[sel]
            idx_g[li, wi] = c_s[sel]
            val_g[li, wi] = v_s[sel]
            if wgt_g is not None:
                wgt_g[li, wi] = w_s[sel]
        U_g = None
        if Uarr is not None:
            U_g = np.zeros((Rg_pad, Uarr.shape[1]))
            U_g[:Rg] = Uarr[g_rows]
        if implicit:
            a_g = factors_implicit_batch(
                model, idx_g, val_g, lens_g, U=U_g, return_device=True)
            bias_g = jnp.zeros(Rg_pad)
        else:
            a_g, bias_g = factors_explicit_batch(
                model, idx_g, val_g, wgt_g, lens_g, U=U_g,
                return_device=True)
        a_dev.append(a_g)
        b_dev.append(bias_g)
        spans.append((g_rows, Rg))

    a_out = np.zeros((R, kw))
    bias_out = np.zeros(R)
    if spans:
        # one download for ALL groups (each np.asarray is a separate
        # device-to-host round-trip otherwise)
        a_all = np.asarray(jnp.concatenate(
            [jnp.asarray(a) for a in a_dev], axis=0))
        b_all = np.asarray(jnp.concatenate(
            [jnp.asarray(b).reshape(-1) for b in b_dev]))
        off = 0
        for (g_rows, Rg), a_g in zip(spans, a_dev):
            Rg_pad = np.shape(a_g)[0]
            a_out[g_rows] = a_all[off:off + Rg]
            bias_out[g_rows] = b_all[off:off + Rg]
            off += Rg_pad
        return a_out, bias_out
    return a_out, bias_out


@partial(jax.jit, static_argnames=("alpha", "w_mult"))
def _warm_implicit_kernel(ext, idx, vals, lengths, G0, lam_vec, alpha,
                          w_mult):
    """Fused plain implicit-warm solve (see _warm_plain_kernel): mask,
    confidence weighting, Gram, batched Cholesky in one executable fed
    by raw idx/vals uploads."""
    L = idx.shape[1]
    dt = ext.dtype
    msk = (jnp.arange(L)[None, :] < lengths[:, None]).astype(dt)
    av = alpha * vals.astype(dt)
    cw = w_mult * av * msk
    cv = w_mult * (1.0 + av) * msk
    G, rhs = rowsolve.assemble_system(
        [SparsePart(ext, idx, cw, cv)], lam_vec, G0=G0)
    a = rowsolve.solve_chol(G, rhs)
    return jnp.where(lengths[:, None] == 0, jnp.zeros((), dt), a)


def factors_implicit_batch(model, idx, vals, lengths, U=None,
                           return_device=False, _no_fused=False):
    """WRMF warm factors: (BtB + sum alpha*x B B^T + lam) a = sum (1+alpha*x) B.

    With side info, the w_user * C parts join the system over the
    [k_user | k] coordinates exactly as in the explicit batch
    (collective_factors_warm_implicit,
    /root/reference/src/collective.c:3640: CtC added to the Gram, C^T u
    to the rhs).  The shared Gram base is served from the precompute
    cache when present (precomputedBtB,
    /root/reference/src/collective.c:3498)."""
    dtype = jnp.float64 if np.dtype(model.dtype_) == np.float64 else jnp.float32
    k = model.k
    ku = getattr(model, "k_user", 0)
    km = getattr(model, "k_main", 0)
    width = ku + k + km
    ext, _, k_pad, _ = _ext_B(model)
    lam6, l16 = _resolve_lambdas(model.lambda_, getattr(model, "l1_lambda", 0.0))
    w_mult = float(getattr(model, "w_main_multiplier_", 1.0)) * float(
        getattr(model, "w_main", 1.0)
    )
    pre = getattr(model, "_precomputed", None) or {}
    stats = model.__dict__.setdefault("_cache_stats", {})

    R, L = idx.shape
    if "BtBw" in pre:
        G0 = jnp.asarray(pre["BtBw"], dtype)
        stats["implicit_gram"] = stats.get("implicit_gram", 0) + 1
    else:
        G0 = w_mult * gram_matrix(_dev_cached(
            model, "extB_dev", ext, dtype, token=id(model.B_)))
    lam_vec = np.ones(k_pad)
    lam_vec[:width] = lam6[2]
    nonneg = bool(getattr(model, "nonneg", False))

    # fused serving path (the common implicit-warm shape): confidence
    # weighting + Gram + Cholesky in one executable, raw idx/vals wire
    if (not _no_fused and L > 0 and U is None and not nonneg
            and not np.any(l16 > 0)):
        vdt = np.float64 if dtype == jnp.float64 else np.float32
        a = _warm_implicit_kernel(
            _dev_cached(model, "extB_dev", ext, dtype,
                        token=id(model.B_)),
            jnp.asarray(np.ascontiguousarray(idx, np.int32)),
            jnp.asarray(np.ascontiguousarray(vals, vdt)),
            jnp.asarray(np.ascontiguousarray(lengths, np.int32)),
            G0, _dev_cached(model, "lam_vec_imp_dev", lam_vec, dtype),
            alpha=float(model.alpha), w_mult=w_mult)
        stats["warm_fused_implicit"] = stats.get(
            "warm_fused_implicit", 0) + 1
        return (a[:, :width] if return_device
                else np.array(a)[:, :width])

    msk = (np.arange(max(L, 1))[None, :] < lengths[:, None]).astype(np.float64)
    av = float(model.alpha) * np.asarray(vals, np.float64)
    cw = w_mult * av * msk
    cv = w_mult * (1.0 + av) * msk
    part = SparsePart(
        _dev_cached(model, "extB_dev", ext, dtype,
                    token=id(model.B_)), jnp.asarray(idx),
        jnp.asarray(cw, dtype), jnp.asarray(cv, dtype),
    )
    parts = [part]
    r0 = None
    if U is not None and getattr(model, "C_", None) is not None:
        up, _, G0x, r0x = _u_part(model, U, k_pad, dtype)
        if up is not None:
            parts.append(up)
        if G0x is not None:
            G0 = G0 + G0x
        if r0x is not None:
            r0 = r0x[None, :] * jnp.ones((R, 1), dtype)
    G, rhs = rowsolve.assemble_system(parts, jnp.asarray(lam_vec, dtype),
                                      G0=G0, r0=r0)
    if nonneg or np.any(l16 > 0):
        l1v = np.zeros(k_pad)
        l1v[:width] = l16[2]
        a = rowsolve.solve_cd(G, rhs, jnp.asarray(l1v, dtype), nonneg=nonneg,
                              max_steps=int(getattr(model, "max_cd_steps", 100)))
    else:
        a = rowsolve.solve_chol(G, rhs)
    if return_device:
        if U is None:
            a = jnp.where(jnp.asarray(lengths)[:, None] == 0, 0.0, a)
        return a[:, :width]
    a = np.array(a)
    if U is None:
        # no X observations and no side info -> zero factors; with U the
        # row still gets a side-info-only (cold) solve
        a[np.asarray(lengths) == 0] = 0.0
    return a[:, :width]


def pack_padded_rows(rows, cols, vals, wgt, m):
    """COO triplets -> padded [m, L] idx/val/weight blocks + per-row counts.

    Vectorized equivalent of the reference's per-row CSR slicing for
    new-data calls (no Python loop over rows)."""
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")
    rows = rows[order]
    cols = np.asarray(cols, np.int64)[order]
    vals = np.asarray(vals, np.float64)[order]
    if wgt is not None:
        wgt = np.asarray(wgt, np.float64)[order]
    counts = np.bincount(rows, minlength=m).astype(np.int64)
    L = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(rows.size) - starts[rows]
    idx = np.zeros((m, L), np.int64)
    vv = np.zeros((m, L))
    idx[rows, within] = cols
    vv[rows, within] = vals
    ww = None
    if wgt is not None:
        ww = np.zeros((m, L))
        ww[rows, within] = wgt
    return idx, vv, ww, counts


def offsets_warm_batch(model, idx, vals, lengths, wgt=None, base=None,
                       implicit=False, alpha=1.0, return_bias=False,
                       exact=None):
    """Batched warm factors for the offsets model
    (offsets_factors_warm, /root/reference/src/offsets.c:578).

    Three cases matching the reference exactly:
      * implicit: plain WRMF solve over the full Am width, attributes
        ignored (offsets.c:654 takes the `|| implicit` branch and zeroes
        a_vec before factors_implicit_chol).
      * explicit, not exact and k_sec == 0: plain ridge over the OBSERVED
        entries on the full Am width, attributes ignored — regularization
        lands on Am rather than the free A (offsets.c:665-672 comment).
      * explicit, exact or k_sec > 0: transform X' = X - uc @ Bm[:, :ks+k]^T
        treated as FULLY DENSE (unobserved entries become 0 - projection,
        weight 1), solve the free A over only columns [k_sec :
        k_sec+k+k_main] of Bm, then Am[:ks+k] += uc (offsets.c:747-852).

    base: [R, ks+k+k_main] attribute-projection rows (only the first
    ks+k columns are used, and only in the exact/k_sec path).
    Returns Am rows [R, ks+k+k_main] (and the warm bias when
    return_bias and the model has user biases — Bm_plus_bias analog).
    """
    dtype = jnp.float64 if np.dtype(model.dtype_) == np.float64 else jnp.float32
    Bm = np.asarray(model.Bm_, np.float64)
    n, kk = Bm.shape
    ks = int(getattr(model, "k_sec", 0))
    k = int(getattr(model, "k", 0))
    km = int(getattr(model, "k_main", 0))
    if exact is None:
        exact = bool(getattr(model, "exact", False))
    lam6, _ = _resolve_lambdas(model.lambda_, 0.0)
    lam = float(lam6[2])
    lam_bias = float(lam6[0])
    idx = np.asarray(idx, np.int64)
    R, L = idx.shape
    msk = (np.arange(max(L, 1))[None, :]
           < np.asarray(lengths)[:, None]).astype(np.float64)
    v = np.asarray(vals, np.float64)
    append_bias = (not implicit and return_bias
                   and model.user_bias_ is not None)

    if implicit:
        # WRMF warm solve on Bm, attributes ignored (offsets.c:707-729).
        k_pad = round_up(kk, 8)
        ext = np.zeros((n, k_pad))
        ext[:, :kk] = Bm
        av = alpha * v
        cw = av * msk
        cv = (1.0 + av) * msk
        BmtBm, _, _ = _omf_gram_pieces(model, kk, ks, k, False)
        G0np = np.zeros((k_pad, k_pad))
        G0np[:kk, :kk] = BmtBm
        G0 = jnp.asarray(G0np, dtype)
        lam_vec = np.full(k_pad, lam)
        lam_vec[kk:] = 1.0  # padded coords stay exactly zero even at lam=0
        part = SparsePart(
            jnp.asarray(ext, dtype), jnp.asarray(idx),
            jnp.asarray(cw, dtype), jnp.asarray(cv, dtype),
        )
        G, rhs = rowsolve.assemble_system([part], jnp.asarray(lam_vec, dtype),
                                          G0=G0)
        a = np.array(rowsolve.solve_chol(G, rhs))[:, :kk]
        a[np.asarray(lengths) == 0] = 0.0
        return a

    vv = v - model.glob_mean_
    if model.item_bias_ is not None and L > 0:
        vv = vv - np.asarray(model.item_bias_)[idx]
    ww = np.ones((R, L)) if wgt is None else np.asarray(wgt, np.float64)

    if not exact and ks == 0:
        # Ridge over observed entries on the full Am width; u_vec ignored
        # (regularization applied to Am, offsets.c:665 comment).
        width = kk + append_bias
        k_pad = round_up(width, 8)
        ext = np.zeros((n, k_pad))
        ext[:, :kk] = Bm
        if append_bias:
            ext[:, kk] = 1.0
        cw = ww * msk
        cv = cw * vv
        lam_vec = np.full(k_pad, lam)
        lam_vec[width:] = 1.0  # padding guard (singular at lam=0 otherwise)
        if append_bias:
            lam_vec[kk] = lam_bias
        part = SparsePart(
            jnp.asarray(ext, dtype), jnp.asarray(idx),
            jnp.asarray(cw, dtype), jnp.asarray(cv, dtype),
        )
        G, rhs = rowsolve.assemble_system([part], jnp.asarray(lam_vec, dtype))
        a = np.array(rowsolve.solve_chol(G, rhs))
        a[np.asarray(lengths) == 0] = 0.0
        bias = a[:, kk] if append_bias else np.zeros(R)
        return (a[:, :kk], bias) if return_bias else a[:, :kk]

    # Exact / k_sec path: full-dense transformed solve on the free block.
    if base is None:
        base = np.zeros((R, kk))
    uc = np.asarray(base, np.float64)[:, : ks + k]
    out = np.zeros((R, kk))
    out[:, : ks + k] = uc
    kf = k + km
    if kf == 0:
        return (out, np.zeros(R)) if return_bias else out
    Bc = Bm[:, : ks + k]
    Bf = Bm[:, ks:]
    width = kf + append_bias
    k_pad = round_up(width, 8)
    ext = np.zeros((n, k_pad))
    ext[:, :kf] = Bf
    if append_bias:
        ext[:, kf] = 1.0
    # Full-dense Gram: ext^T ext; observed entries carry weight w (so the
    # sparse correction uses (w - 1)); rhs gets -Bf^T Bc uc from the
    # unobserved projection plus the observed-entry terms.  The blocks come
    # from the BmtBm/colsum caches when precomputed (offsets.c:870).
    BmtBm, colsum, n_cache = _omf_gram_pieces(model, kk, ks, k, append_bias)
    G0np = np.zeros((k_pad, k_pad))
    G0np[:kf, :kf] = BmtBm[ks:, ks:]
    if append_bias:
        G0np[kf, :kf] = colsum[ks:]
        G0np[:kf, kf] = colsum[ks:]
        G0np[kf, kf] = float(n_cache)
    G0 = jnp.asarray(G0np, dtype)
    M = np.zeros((ks + k, k_pad))  # Bc^T ext
    M[:, :kf] = BmtBm[: ks + k, ks:]
    if append_bias:
        M[:, kf] = colsum[: ks + k]
    r0 = jnp.asarray(-(uc @ M), dtype)
    proj = np.einsum("rlk,rk->rl", Bc[idx], uc)
    cw = (ww - 1.0) * msk
    cv = (ww * vv - (ww - 1.0) * proj) * msk
    lam_vec = np.full(k_pad, lam)
    lam_vec[kf + (1 if append_bias else 0):] = 1.0  # padding guard
    if append_bias:
        lam_vec[kf] = lam_bias
    part = SparsePart(
        jnp.asarray(ext, dtype), jnp.asarray(idx),
        jnp.asarray(cw, dtype), jnp.asarray(cv, dtype),
    )
    G, rhs = rowsolve.assemble_system([part], jnp.asarray(lam_vec, dtype),
                                      G0=G0, r0=r0)
    a = np.asarray(rowsolve.solve_chol(G, rhs))
    out[:, ks:] += a[:, :kf]
    bias = a[:, kf] if append_bias else np.zeros(R)
    return (out, bias) if return_bias else out


@partial(jax.jit, static_argnames=("n_steps", "memory", "kc"))
def _lbfgs_rows(a0, args, n_steps, memory, kc):
    """Minimize the summed per-row objective with optax.lbfgs.

    Rows are independent, so the joint minimizer equals the per-row
    minimizers (the batched analog of the reference's per-row liblbfgs,
    /root/reference/src/collective.c:1146 collective_factors_lbfgs)."""
    (Bx, idx, cw, cv, Cm, u, umask, Cb, ub, ubmask, lam_vec,
     w_main, w_user) = args

    def loss_fn(a):
        f = jnp.asarray(0.0, a.dtype)
        if Bx is not None:
            # X part: coords [ku:] of a vs B[:, ki:] (+ bias column)
            pred = jnp.einsum("rlk,rk->rl", jnp.take(Bx, idx, axis=0), a)
            r = cv - pred
            f = f + 0.5 * w_main * jnp.sum(cw * r * r)
        au = a[:, :kc]
        if Cm is not None:
            ru = (u - au @ Cm.T) * umask
            f = f + 0.5 * w_user * jnp.sum(ru * ru)
        if Cb is not None:
            rb = (ub - jax.nn.sigmoid(au @ Cb.T)) * ubmask
            f = f + 0.5 * w_user * jnp.sum(rb * rb)
        f = f + 0.5 * jnp.sum(lam_vec[None, :] * a * a)
        return f

    opt = optax.lbfgs(memory_size=memory)
    state = opt.init(a0)
    value_and_grad = optax.value_and_grad_from_state(loss_fn)
    tol = jnp.asarray(1e-7, a0.dtype)

    # Early-stop on the gradient sup-norm (liblbfgs-style relative
    # criterion): avoids paying the full n_steps on every warm/cold call
    # when the batched objective converges in a handful of iterations.
    def cond(carry):
        a, state, it, gnorm = carry
        anorm = jnp.maximum(1.0, jnp.max(jnp.abs(a)))
        return jnp.logical_and(it < n_steps, gnorm >= tol * anorm)

    def body(carry):
        a, state, it, _ = carry
        value, grad = value_and_grad(a, state=state)
        updates, state2 = opt.update(
            grad, state, a, value=value, grad=grad, value_fn=loss_fn
        )
        a = optax.apply_updates(a, updates)
        return (a, state2, it + 1, jnp.max(jnp.abs(grad)))

    init = (a0, state, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, a0.dtype))
    a, _, _, _ = jax.lax.while_loop(cond, body, init)
    return a


def factors_bin_batch(model, idx, vals, wgt, lengths, U=None, U_bin=None,
                      cold=False, return_bias=False, maxiter=None):
    """Warm/cold factors when binary side info is involved: no closed form
    exists, so run the reference's per-row gradient solve
    (collective_factors_lbfgs, /root/reference/src/collective.c:1146;
    gated at /root/reference/src/collective.c:3825-3862) as ONE batched
    device L-BFGS over all R rows.

    idx/vals/wgt: [R, L] padded X observations (ignored when cold);
    U: [R, p] dense (NaN = missing) or None; U_bin: [R, pbin] dense.
    """
    dtype = jnp.float64 if np.dtype(model.dtype_) == np.float64 else jnp.float32
    k = model.k
    ku = getattr(model, "k_user", 0)
    km = getattr(model, "k_main", 0)
    ki = getattr(model, "k_item", 0)
    kc = ku + k
    lam6, _ = _resolve_lambdas(model.lambda_, 0.0)
    w_main = float(getattr(model, "w_main", 1.0))
    w_user = float(getattr(model, "w_user", 1.0))
    R = int(np.asarray(lengths).shape[0])
    append_bias = (not cold and return_bias and model.user_bias_ is not None)

    if cold:
        width = kc  # k_main coords stay zero (collective.c:3412 passes 0,0)
        w_main = 1.0
        Bx = idxj = cwj = cvj = None
    else:
        width = ku + k + km + (1 if append_bias else 0)
        B = np.asarray(model.B_, np.float64)
        Bx = np.zeros((B.shape[0], width - ku))
        Bx[:, : k + km] = B[:, ki:]
        if append_bias:
            Bx[:, k + km] = 1.0
        L = idx.shape[1]
        msk = (np.arange(max(L, 1))[None, :]
               < np.asarray(lengths)[:, None]).astype(np.float64)
        v = np.asarray(vals, np.float64) - model.glob_mean_
        if model.item_bias_ is not None and L > 0:
            v = v - np.asarray(model.item_bias_)[np.asarray(idx, np.int64)]
        ww = msk if wgt is None else np.asarray(wgt, np.float64) * msk
        idxj = jnp.asarray(np.asarray(idx, np.int64))
        cwj = jnp.asarray(ww, dtype)
        cvj = jnp.asarray(v * msk, dtype)

    # pad the X-coordinate block so a[:, ku:] aligns with Bx columns
    a0 = jnp.zeros((R, width), dtype)

    Cm = u = umask = None
    if U is not None and model.C_ is not None:
        Uarr = np.asarray(U, np.float64)
        if model.U_colmeans_ is not None:
            Uarr = Uarr - np.asarray(model.U_colmeans_)[None, :]
        umask = jnp.asarray((~np.isnan(Uarr)).astype(np.float64), dtype)
        u = jnp.asarray(np.nan_to_num(Uarr), dtype)
        Cm = jnp.asarray(np.asarray(model.C_, np.float64), dtype)
    Cb = ub = ubmask = None
    if U_bin is not None:
        if getattr(model, "Cb_", None) is None:
            raise ValueError("Model was fit without binary user side info")
        Ub = np.asarray(U_bin, np.float64)
        ubmask = jnp.asarray((~np.isnan(Ub)).astype(np.float64), dtype)
        ub = jnp.asarray(np.nan_to_num(Ub), dtype)
        Cb = jnp.asarray(np.asarray(model.Cb_, np.float64), dtype)

    lam_vec = np.full(width, float(lam6[2]))
    if append_bias:
        lam_vec[width - 1] = float(lam6[0])

    # The X part sees a[:, ku:]; fold that into the objective by expanding
    # Bx to full width with zeros on the k_user block.
    if Bx is not None:
        Bfull = np.zeros((Bx.shape[0], width))
        Bfull[:, ku:] = Bx
        Bxj = jnp.asarray(Bfull, dtype)
    else:
        Bxj = None

    args = (Bxj, idxj if Bx is not None else None,
            cwj if Bx is not None else None,
            cvj if Bx is not None else None,
            Cm, u, umask, Cb, ub, ubmask,
            jnp.asarray(lam_vec, dtype),
            jnp.asarray(w_main, dtype), jnp.asarray(w_user, dtype))
    # explicit maxiter= wins; otherwise honor the model's maxiter (the
    # reference's collective_factors_lbfgs inherits the fit setting) with
    # a 200-step floorless default only when the model has none
    if maxiter is None:
        maxiter = getattr(model, "maxiter", None)
    n_steps = int(maxiter) if maxiter is not None else 200
    a = np.array(_lbfgs_rows(a0, args, n_steps=n_steps, memory=5, kc=kc))
    if cold:
        out = np.zeros((R, ku + k + km))
        out[:, :kc] = a
        return out
    bias = a[:, width - 1] if append_bias else np.zeros(R)
    out = a[:, : ku + k + km]
    return (out, bias) if return_bias else out


def build_precomputed_offsets(model) -> dict:
    """Prediction caches for the offsets models (precompute_offsets_both,
    /root/reference/src/offsets.c:870): the combined matrix Bm, its Gram,
    and column sums, from which every offsets_warm_batch variant derives
    its shared base without per-call O(n k^2) matmuls."""
    model._precomputed = {}
    out = {}
    Bm = np.asarray(model.Bm_, np.float64)
    out["Bm"] = Bm
    out["BmtBm"] = Bm.T @ Bm
    out["Bm_colsum"] = Bm.sum(axis=0)
    out["n"] = Bm.shape[0]
    return out


def _omf_gram_pieces(model, kk, ks, k, append_bias):
    """(BmtBm, colsum, n) from the cache or computed fresh."""
    pre = getattr(model, "_precomputed", None) or {}
    stats = model.__dict__.setdefault("_cache_stats", {})
    if "BmtBm" in pre:
        stats["omf_gram"] = stats.get("omf_gram", 0) + 1
        return pre["BmtBm"], pre["Bm_colsum"], pre["n"]
    Bm = np.asarray(model.Bm_, np.float64)
    return Bm.T @ Bm, Bm.sum(axis=0), Bm.shape[0]


def factors_cold_implicit(model, U):
    """Side-info-only factors for the implicit model.

    The reference's cold implicit system INCLUDES the B Gram: after
    normalizing by w_main, collective_factors_cold_implicit
    (/root/reference/src/collective.c:3442,3491) solves
    (w_main*BtB + w_user*CtC + lam) a = w_user C^T u — exactly the warm
    system with zero X observations, so delegate to the batch solver."""
    U = np.asarray(U, np.float64)
    R = U.shape[0]
    # one zero-length padded slot per row (length 0 masks it out)
    return factors_implicit_batch(
        model,
        np.zeros((R, 1), np.int64), np.zeros((R, 1)),
        np.zeros(R, np.int64), U=U,
    )


def build_precomputed(model) -> dict:
    """Prediction caches (precompute_collective_explicit,
    /root/reference/src/collective.c:10209-10470).

    Cached pieces (coordinate space = the extended [k_user|k|k_main|bias]
    layout used by every warm/cold solve):
      extB          — extended opposing matrix [n, k_pad] (B_plus_bias)
      BtB           — extB^T extB (unweighted Gram)
      BtBw          — w_main * BtB: the shared G0 of NA-as-zero warm solves
      BtXbias       — w_main * extB^T (-mu - biasB): the shared r0 of
                      NA-as-zero warm solves (collective.c:10300-10342)
      TransBtBinvBt — (w_main BtB + diag(lam))^-1 extB^T: one matmul for
                      fully-dense unweighted warm rows (collective.c:10363)
      BiTBi         — w_implicit * Bi^T Bi (add_implicit_features)
      extC / CtC / CtCw — side-info projection matrix, Gram, w_user-scaled
      TransCtCinvCt — (w_u CtC + lam_C)^-1 w_u C^T: one matmul per cold
                      call (collective.c:10396)
      CtUbias       — -w_user * C^T U_colmeans (NA_as_zero_U centering,
                      collective.c:10466)
      BeTBeChol     — chol(w_main BtB + w_user CtC [+ BiTBi] + diag(lam)):
                      the no-correction extended system (collective.c:10425)
    """
    model._precomputed = {}
    out = {}
    ext, width, k_pad, user_bias = _ext_B(model)
    lam6, _ = _resolve_lambdas(model.lambda_, 0.0)
    k = model.k
    ku = getattr(model, "k_user", 0)
    km = getattr(model, "k_main", 0)
    w_main = float(getattr(model, "w_main", 1.0)) * float(
        getattr(model, "w_main_multiplier_", 1.0))
    w_u = float(getattr(model, "w_user", 1.0))
    scale_lam = bool(getattr(model, "scale_lam", False))
    scale_lam_side = bool(getattr(model, "scale_lam_sideinfo", False))
    nonneg = bool(getattr(model, "nonneg", False))
    n = ext.shape[0]

    out["extB"] = ext
    out["width"] = width
    out["k_pad"] = k_pad
    out["user_bias"] = user_bias
    BtB = np.asarray(gram_matrix(jnp.asarray(ext)))
    out["BtB"] = BtB
    out["BtBw"] = w_main * BtB

    lam_vec = np.ones(k_pad)
    lam_vec[: ku + k + km] = lam6[2]
    if user_bias:
        lam_vec[width] = lam6[0]
    mult = 1.0
    if scale_lam or scale_lam_side:
        p_side = np.asarray(model.C_).shape[0] if model.C_ is not None else 0
        mult = float(n + (p_side if scale_lam_side else 0))
    if not nonneg and not getattr(model, "add_implicit_features", False):
        # TransBtBinvBt itself is O(n k^2) on the host
        # and only serves FULLY-observed unweighted warm rows — store the
        # ingredients and build it lazily on first use (_trans_btb_inv_bt)
        out["TransBtBinvBt_G"] = w_main * BtB + np.diag(lam_vec * mult)

    # NA-as-zero rhs base: w_main * extB^T (-mu - biasB)
    if getattr(model, "NA_as_zero", False):
        t = -float(model.glob_mean_) * np.ones(n)
        if model.item_bias_ is not None:
            t = t - np.asarray(model.item_bias_)
        out["BtXbias"] = w_main * (ext.T @ t)

    if getattr(model, "Bi_", None) is not None:
        Bi = np.asarray(model.Bi_, np.float64)
        BiTBi = np.zeros((k_pad, k_pad))
        wi = float(getattr(model, "w_implicit", 0.5))
        kiw = Bi.shape[1]
        BiTBi[ku : ku + kiw, ku : ku + kiw] = wi * (Bi.T @ Bi)
        out["BiTBi"] = BiTBi
        ext_bi = np.zeros((Bi.shape[0], k_pad))
        ext_bi[:, ku : ku + kiw] = Bi
        out["extBi"] = ext_bi

    if model.C_ is not None:
        Ce = _ext_C(model, k_pad)
        out["extC"] = Ce
        CtC = Ce.T @ Ce
        out["CtC"] = CtC
        out["CtCw"] = w_u * CtC
        kc = np.asarray(model.C_).shape[1]
        lam_C = lam6[2]
        if scale_lam_side:
            # cold solves scale lam by the side-info column count only
            # under scale_lam_sideinfo (collective.c:3389 passes it as
            # both scale flags)
            lam_C = lam_C * float(Ce.shape[0])
        if not nonneg:
            Gc = w_u * CtC[:kc, :kc] + lam_C * np.eye(kc)
            out["TransCtCinvCt"] = np.linalg.solve(Gc, w_u * Ce[:, :kc].T)
        if (getattr(model, "NA_as_zero_user", False)
                and model.U_colmeans_ is not None):
            out["CtUbias"] = -w_u * (
                Ce[:, :kc].T @ np.asarray(model.U_colmeans_)
            )
        if not nonneg:
            Ge = w_main * BtB + w_u * CtC + np.diag(lam_vec * mult)
            if "BiTBi" in out:
                Ge = Ge + out["BiTBi"]
            out["BeTBeChol"] = np.linalg.cholesky(Ge)
    if model.item_bias_ is not None:
        out["B_plus_bias"] = ext
    return out
