"""End-to-end ALS fit drivers for the classic (non-collective) models.

fit_explicit_als mirrors the reference's fit path for a plain X-only model
(/root/reference/src/collective.c:7263 with no side info): center -> bias
init -> alternating half-iterations over item/user orientations, with
CG-until-last-iteration-then-Cholesky (finalize_chol,
/root/reference/src/collective.c:8336-8340).

fit_implicit_als mirrors fit_collective_implicit_als
(/root/reference/src/collective.c:9375): optional log transform, alpha
confidence scaling, adjust_weight -> w_main_multiplier = nnz/(m*n)
(/root/reference/src/collective.c:9776-9782).
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.profiling import profiled_fit
from ..utils.checkpoint import FitCheckpointer

from ..config import (
    SOLVER_PRECISION,
    dense_budget_bytes as default_dense_budget,
    exact_dense_enabled,
    on_accelerator,
    resolve_dtype,
)
from ..data.shards import BucketedRows, build_bucketed_rows
from . import preprocess
from .als import (
    SidePlan,
    blocks_to_orig,
    bucket_arrays,
    gram_matrix,
    init_blocks,
    update_side,
)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _sparse_fit_state(A_blocks, B_blocks, perm_A, perm_B, m, n, k,
                      user_bias, item_bias):
    """Bucketed-engine state -> the init= dict shape (checkpointing)."""
    A_orig = blocks_to_orig(A_blocks, perm_A, m)
    B_orig = blocks_to_orig(B_blocks, perm_B, n)
    return {
        "A": A_orig[:, :k], "B": B_orig[:, :k],
        "biasA": A_orig[:, k] if user_bias else None,
        "biasB": B_orig[:, k] if item_bias else None,
    }


@partial(jax.jit, static_argnames=("col",))
def _ext_with_ones(orig: jax.Array, col: int) -> jax.Array:
    """Set column `col` to ones (bias column trick,
    /root/reference/src/common.c:561-565)."""
    return orig.at[:, col].set(1.0)


@partial(jax.jit, static_argnames=("col",))
def _ext_with_zeros(orig: jax.Array, col: int) -> jax.Array:
    return orig.at[:, col].set(0.0)


def _make_lam_vec(k: int, k_pad: int, lam: float, lam_bias: float, has_bias: bool, dtype):
    """Per-coordinate L2: [lam]*k + [lam_bias] + 1s on padding coords (a
    positive diagonal keeps padded coordinates at exactly zero)."""
    v = np.ones(k_pad, np.float64)
    v[:k] = lam
    if has_bias:
        v[k] = lam_bias
    return jnp.asarray(v, dtype)


def _make_l1_vec(k: int, k_pad: int, l1: float, l1_bias: float, has_bias: bool, dtype):
    if l1 == 0.0 and (not has_bias or l1_bias == 0.0):
        return None
    v = np.zeros(k_pad, np.float64)
    v[:k] = l1
    if has_bias:
        v[k] = l1_bias
    return jnp.asarray(v, dtype)


def _resolve_lambdas(lambda_, l1_lambda):
    """lambda_ may be a scalar or a length-6 array ordered as
    (user_bias, item_bias, A, B, C, D) — /root/reference/src/cmfrec.h:1858."""

    def expand(x):
        x = np.asarray(x, np.float64).ravel()
        if x.size == 1:
            return np.full(6, float(x[0]))
        if x.size != 6:
            raise ValueError("lambda_ must be a scalar or have 6 entries")
        return x

    return expand(lambda_), expand(l1_lambda)


def _mesh_row_block(mesh) -> Optional[int]:
    """Bucket row counts must divide evenly over the mesh axis; widen the
    row block when the mesh is larger than the default."""
    if mesh is None:
        return None
    msize = int(mesh.size)
    from ..config import DEFAULT_ROW_BLOCK

    return int(np.lcm(DEFAULT_ROW_BLOCK, msize))


def _shard_driver_state(mesh, bucketed_list, block_lists, replicated_arrays):
    """Place bucketed data + factor blocks row-sharded over the mesh and
    replicate the small arrays (SURVEY §2.4 P1/P5: rows over the data axis,
    opposing factors everywhere, XLA inserts the collectives)."""
    from ..parallel.mesh import replicated, row_sharding

    rs, rep = row_sharding(mesh), replicated(mesh)
    for bk in bucketed_list:
        if bk is not None:
            bk.device_put(rs)
    out_blocks = [
        None if bl is None else [jax.device_put(b, rs) for b in bl]
        for bl in block_lists
    ]
    out_rep = [
        None if a is None else jax.device_put(a, rep)
        for a in replicated_arrays
    ]
    return out_blocks, out_rep


def _build_pair(rows, cols, vals_c, m, n, weights, dtype, row_block=None):
    """Dual-orientation bucketed layout: device-side fill on the GPU (one
    compact CSR upload), host fill elsewhere.  An explicit row_block
    (mesh-divisible) forces the host path."""
    if (row_block is None
            and on_accelerator()
            and os.environ.get("CMFREC_TPU_DEVICE_FILL", "1") == "1"):
        from ..data.device_fill import build_bucketed_pair_device

        return build_bucketed_pair_device(rows, cols, vals_c, m, n,
                                          weights, dtype=dtype)
    kw = {} if row_block is None else {"row_block": row_block}
    RB = build_bucketed_rows(rows, cols, vals_c, m, n, weights, dtype=dtype,
                             **kw)
    CB = build_bucketed_rows(cols, rows, vals_c, n, m, weights, dtype=dtype,
                             **kw)
    return RB, CB


@profiled_fit
def fit_explicit_als(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    *,
    k: int = 40,
    lambda_=10.0,
    l1_lambda=0.0,
    niter: int = 10,
    use_cg: bool = True,
    max_cg_steps: int = 3,
    precondition_cg: bool = False,
    finalize_chol: bool = True,
    user_bias: bool = True,
    item_bias: bool = True,
    center: bool = True,
    scale_lam: bool = False,
    scale_bias_const: bool = False,
    NA_as_zero: bool = False,
    nonneg: bool = False,
    max_cd_steps: int = 100,
    weights: Optional[np.ndarray] = None,
    dtype=np.float32,
    seed: int = 1,
    verbose: bool = False,
    engine: str = "auto",  # "auto" | "sparse" | "dense"
    dense_budget_bytes: Optional[int] = None,
    mesh=None,  # jax.sharding.Mesh for multi-device data parallelism
    init=None,  # warm restart: dict(A=, B=[, biasA=, biasB=]) to continue
    # training from (the reference's reset_values=False)
    checkpoint_path: Optional[str] = None,  # mid-fit periodic checkpoints
    checkpoint_every: int = 0,  # every N iterations (utils/checkpoint.py)
    shard_opposing_rows: bool = False,  # big-axis mode: keep the opposing
    # factor matrix row-sharded over the mesh and assemble row systems by
    # rotating its shards around the ring (parallel/ring.py).  Use when
    # n*k (or m*k) no longer fits one device's memory; costs ~mesh-size masked
    # gather passes per half-step.  Requires mesh= and use_cg=False.
) -> dict:
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)

    if shard_opposing_rows:
        if mesh is None:
            raise ValueError("shard_opposing_rows requires mesh=")
        if use_cg:
            raise ValueError(
                "shard_opposing_rows supports Cholesky/CD solves only "
                "(truncated CG would cost one ring per matvec); "
                "pass use_cg=False"
            )
        engine = "sparse"  # the bucketed engine is the sharded-B path

    if nonneg:
        use_cg = False
    glob_mean = (
        preprocess.weighted_global_mean(vals, weights) if center else 0.0
    )
    if NA_as_zero and center:
        # under NA-as-zero the mean is over ALL m*n cells (unobserved = 0,
        # weight 1): sum/(wsum + m*n - nnz) — common.c:3513 unweighted;
        # the reference's WEIGHTED variant inverts this ratio
        # (common.c:3585 divides by wsum/(wsum+extra)), which amplifies
        # the mean instead of shrinking it — we keep the intended form
        wsum = (float(len(vals)) if weights is None
                else float(np.sum(weights)))
        glob_mean *= wsum / (wsum + float(m) * float(n) - float(len(vals)))
    if nonneg:
        # nonneg models center like any other, but clamp the global mean
        # at zero (common.c:3599 `*glob_mean = fmax(*glob_mean, 0)`)
        glob_mean = max(glob_mean, 0.0)
    # (vals - glob_mean) is computed LAZILY: the fused engine ships RAW
    # vals and folds the mean into its rhs, so this full host pass over
    # nnz entries would be dead work on the GPU's default path
    _vc = [None]

    def _centered_vals():
        if _vc[0] is None:
            _vc[0] = (vals - glob_mean).astype(dtype)
        return _vc[0]

    # Engine selection: the dense-masked engine turns the CG half-iterations
    # into whole-matrix products (see dense_engine.py) instead of gather-
    # based sparse solves, whenever [m, n] fits the dense budget.
    from .dense_engine import estimate_dense_bytes

    budget = dense_budget_bytes or default_dense_budget()
    if engine == "dense" and (nonneg or np.any(l16 > 0)):
        raise ValueError(
            "engine='dense' does not support nonneg/l1_lambda; "
            "use engine='auto' or 'sparse'"
        )
    # unweighted NA-as-zero has a shared-Gram closed form on the dense
    # engine (optimizeA case 3); weighted NA-as-zero stays bucketed
    na0_dense = NA_as_zero and weights is None
    # use_cg=False fits ride the fused masked engine too on the GPU, in
    # exact mode: each half-step's CG runs to the per-row 1e-8 freeze under
    # the Krylov step cap (dense_pallas._exact_cap) — Cholesky-quality
    # solutions at masked-matvec cost instead of the bucketed engine's
    # nnz*k^2 Gram assembly.  engine="sparse" or
    # CMFREC_TPU_NO_EXACT_DENSE=1 keeps the per-row Cholesky path.
    exact_pallas = (
        not use_cg
        and not NA_as_zero
        and on_accelerator()
        and np.dtype(dtype) == np.float32
        and os.environ.get("CMFREC_TPU_NO_PALLAS", "0") != "1"
        and exact_dense_enabled()
    )
    use_dense = engine == "dense" or (
        engine == "auto"
        and (use_cg or na0_dense or exact_pallas)
        and not nonneg
        and not np.any(l16 > 0)
        and (not NA_as_zero or na0_dense)
        and estimate_dense_bytes(m, n, np.dtype(dtype).itemsize) <= budget
    )
    # The fused-kernel engine is the GPU fast path; the XLA einsum
    # engine remains for CPU runs and f64.  Its actual residency is the
    # PADDED dims in four arrays (bf16 X + mask W, both orientations), and
    # its int32 scatter index requires m_pad*n_pad < 2**31.
    # precondition_cg: the fused pallas kernels implement plain CG only;
    # PCG fits run on the XLA dense/bucketed engines (same fixed point;
    # trajectory reference-exact for the plain model, see solve_cg).  The
    # flag is inert without use_cg (the reference ignores it too).
    use_pallas = use_dense and (
        on_accelerator()
        and np.dtype(dtype) == np.float32
        and not (use_cg and precondition_cg)
        and os.environ.get("CMFREC_TPU_NO_PALLAS", "0") != "1"
    )
    if use_pallas:
        from ..ops.masked_matmul import pad_dim

        m_pad = pad_dim(m)
        n_pad = pad_dim(n)
        wbytes = 4 if weights is not None else 1
        pallas_bytes = m_pad * n_pad * (2 + wbytes) * 2
        if (m_pad * n_pad >= np.iinfo(np.int32).max
                or pallas_bytes > budget):
            use_pallas = False
            if engine != "dense":
                use_dense = False  # padded form doesn't fit: go sparse
    if NA_as_zero and use_dense and not use_pallas:
        if engine == "dense":
            raise ValueError(
                "engine='dense' NA_as_zero requires the fused GPU engine "
                "(unweighted, f32); use engine='auto' or 'sparse'"
            )
        use_dense = False  # the XLA fallback engine lacks the na0 form

    biasA0 = biasB0 = None
    if (user_bias or item_bias) and not use_pallas:
        # (the fused engine computes starting biases on device)
        biasA0, biasB0 = preprocess.initialize_biases(
            rows, cols, _centered_vals(), m, n,
            lam_user=lam6[0], lam_item=lam6[1],
            wgt=weights,
            user_bias=user_bias, item_bias=item_bias,
            scale_lam=scale_lam, nonneg=nonneg,
        )

    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter)

    if use_dense:
        if use_pallas:
            from .dense_pallas import fit_explicit_dense_pallas

            return fit_explicit_dense_pallas(
                rows, cols, vals, m, n, weights=weights,
                k=k, lam6=lam6, niter=niter, max_cg_steps=max_cg_steps,
                finalize_chol=finalize_chol,
                finalize_steps=int(
                    os.environ.get("CMFREC_TPU_FINALIZE_STEPS", "16")
                ),
                user_bias=user_bias, item_bias=item_bias,
                glob_mean=glob_mean, scale_lam=scale_lam,
                scale_bias_const=scale_bias_const,
                biasA0=biasA0, biasB0=biasB0,
                dtype=dtype, seed=seed, verbose=verbose, mesh=mesh,
                init=init, na_as_zero=NA_as_zero, ckpt=ckpt,
                exact=not use_cg,
            )
        return _fit_explicit_dense(
            rows, cols, _centered_vals(), m, n, weights=weights,
            k=k, lam6=lam6, niter=niter,
            # explicit engine="dense" request with use_cg=False: run every
            # iteration's CG to convergence (30 steps == exact on these
            # k x k ridge systems), the XLA-engine analog of exact mode
            max_cg_steps=max_cg_steps if use_cg else 30,
            finalize_chol=finalize_chol, user_bias=user_bias,
            item_bias=item_bias, glob_mean=glob_mean,
            scale_lam=scale_lam, scale_bias_const=scale_bias_const,
            biasA0=biasA0, biasB0=biasB0,
            dtype=dtype, seed=seed, verbose=verbose, init=init,
            precondition_cg=precondition_cg, ckpt=ckpt,
        )

    RB, CB = _build_pair(rows, cols, _centered_vals(), m, n, weights,
                         dtype, row_block=_mesh_row_block(mesh))
    if mesh is None:
        RB.device_put()
        CB.device_put()
    perm_A = jnp.asarray(RB.perm)
    perm_B = jnp.asarray(CB.perm)

    k_pad = round_up(k + 1, 8)
    key = jax.random.PRNGKey(seed)
    key, A_blocks = init_blocks(key, RB, k, k_pad, dtype)
    key, B_blocks = init_blocks(key, CB, k, k_pad, dtype)

    # Seed the bias coordinates with the closed-form initial biases.
    if user_bias:
        A_blocks = _set_bias_coord(A_blocks, RB, biasA0, k, dtype)
    if item_bias:
        B_blocks = _set_bias_coord(B_blocks, CB, biasB0, k, dtype)
    if init is not None:
        if init.get("A") is not None:
            A_blocks = _seed_factor_blocks(A_blocks, RB, init["A"], k, dtype)
        if init.get("B") is not None:
            B_blocks = _seed_factor_blocks(B_blocks, CB, init["B"], k, dtype)
        if user_bias and init.get("biasA") is not None:
            A_blocks = _set_bias_coord(A_blocks, RB,
                                       np.asarray(init["biasA"]), k, dtype)
        if item_bias and init.get("biasB") is not None:
            B_blocks = _set_bias_coord(B_blocks, CB,
                                       np.asarray(init["biasB"]), k, dtype)
    if mesh is not None:
        (A_blocks, B_blocks), (perm_A, perm_B) = _shard_driver_state(
            mesh, [RB, CB], [A_blocks, B_blocks], [perm_A, perm_B],
        )

    lam_vec_A = _make_lam_vec(k, k_pad, lam6[2], lam6[0], user_bias, dtype)
    lam_vec_B = _make_lam_vec(k, k_pad, lam6[3], lam6[1], item_bias, dtype)
    l1_vec_A = _make_l1_vec(k, k_pad, l16[2], l16[0], user_bias, dtype)
    l1_vec_B = _make_l1_vec(k, k_pad, l16[3], l16[1], item_bias, dtype)

    # scale_bias_const: the bias coordinate's penalty scales with the AVERAGE
    # observation count instead of the per-row count
    # (/root/reference/src/common.c:717-722, docstring __init__.py:2579).
    lam_const_A = lam_const_B = None
    if scale_lam and scale_bias_const:
        wsum_total = float(np.sum(weights)) if weights is not None else float(len(vals))
        if user_bias:
            v = np.zeros(k_pad)
            v[k] = lam6[0] * (wsum_total / max(m, 1))
            lam_const_A = jnp.asarray(v, dtype)
            lam_vec_A = lam_vec_A.at[k].set(0.0)
        if item_bias:
            v = np.zeros(k_pad)
            v[k] = lam6[1] * (wsum_total / max(n, 1))
            lam_const_B = jnp.asarray(v, dtype)
            lam_vec_B = lam_vec_B.at[k].set(0.0)

    # bf16 matmul operands on the GPU for the CG iterations (f32
    # accumulate); Cholesky/final iterations stay f32 (exact polish,
    # finalize_chol).
    bf16_ok = (
        on_accelerator()
        and np.dtype(dtype) == np.float32
        and os.environ.get("CMFREC_TPU_NO_BF16", "0") != "1"
    )

    dataA = bucket_arrays(RB)
    dataB = bucket_arrays(CB)
    mask_A = mask_B = None
    if shard_opposing_rows:
        dataA, dataB, mask_A, mask_B = _ring_remap(RB, CB, dataA, dataB)

    mu_dev = jnp.asarray(glob_mean, dtype)
    try:
        for it in range(niter):
            method = "cg" if (use_cg and not (finalize_chol and it == niter - 1)) else "chol"
            t0 = time.time()
            A_blocks, B_blocks = _explicit_sparse_iteration(
                A_blocks, B_blocks, dataA, dataB, perm_A, perm_B,
                lam_vec_A, lam_vec_B, l1_vec_A, l1_vec_B,
                lam_const_A, lam_const_B, mu_dev,
                m=m, n=n, k=k, user_bias=user_bias, item_bias=item_bias,
                NA_as_zero=NA_as_zero, method=method,
                max_cg_steps=max_cg_steps, nonneg=nonneg,
                max_cd_steps=max_cd_steps, scale_lam=scale_lam,
                precondition_cg=precondition_cg,
                mxu_bf16=bf16_ok and method == "cg",
                jdtype=jnp.dtype(dtype),
                ring_mesh=mesh if shard_opposing_rows else None,
                mask_A=mask_A, mask_B=mask_B,
            )
            if verbose:
                jax.block_until_ready(A_blocks)
                print(f"iter {it + 1}/{niter} [{method}] {time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _sparse_fit_state(
                A_blocks, B_blocks, perm_A, perm_B, m, n, k,
                user_bias, item_bias))
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        # return the partially-fit model, mirroring the reference's
        # handle_interrupt (/root/reference/src/helpers.c:1493,
        # act_on_interrupt cmfrec.h:622)
        print("interrupted — returning partially-fit model")

    # device arrays returned lazily; downloads are the caller's cost.
    # Return layout == checkpoint layout (1:1 with init=) by construction.
    out = _sparse_fit_state(A_blocks, B_blocks, perm_A, perm_B, m, n, k,
                            user_bias, item_bias)
    out.update({"glob_mean": float(glob_mean), "k": k})
    return out



@partial(
    jax.jit,
    static_argnames=("m", "n", "k", "user_bias", "item_bias", "NA_as_zero",
                     "method", "max_cg_steps", "nonneg", "max_cd_steps",
                     "scale_lam", "precondition_cg", "mxu_bf16", "jdtype",
                     "ring_mesh"),
)
def _explicit_sparse_iteration(
    A_blocks, B_blocks, dataA, dataB, perm_A, perm_B,
    lam_vec_A, lam_vec_B, l1_vec_A, l1_vec_B, lam_const_A, lam_const_B,
    glob_mean,
    *, m, n, k, user_bias, item_bias, NA_as_zero, method, max_cg_steps,
    nonneg, max_cd_steps, scale_lam, precondition_cg, mxu_bf16, jdtype,
    ring_mesh=None, mask_A=None, mask_B=None,
):
    """One full explicit ALS iteration (B half-step then A, the reference's
    order — collective.c:8614/8802; fixed-point tests check A last) over bucketed
    data — module-level so the compilation caches across fits."""
    mode = "na0" if NA_as_zero else "explicit"
    plan_A = SidePlan(None, mode, n)
    plan_B = SidePlan(None, mode, m)

    # Reference update order within an iteration: B first, then A
    # (/root/reference/src/collective.c:8614 "Updating B" precedes :8802
    # "Updating A") — A is the matrix solved last against the final B.
    if ring_mesh is None:
        A_orig = blocks_to_orig(A_blocks, perm_A, m)
        opp = (_ext_with_ones(A_orig, k) if item_bias
               else _ext_with_zeros(A_orig, k))
        opp_bias = A_orig[:, k] if user_bias else None
    else:
        opp, opp_bias = _ring_opp_from_blocks(
            A_blocks, mask_A, k, item_bias, ring_mesh)
        opp_bias = opp_bias if user_bias else None
    G0 = r0_vec = None
    if NA_as_zero:
        G0 = gram_matrix(opp)
        r0_vec = _na0_rhs_base(opp, opp_bias, glob_mean)
    B_blocks = update_side(
        plan_B, B_blocks, opp, opp_bias, lam_vec_B,
        buckets_data=dataB,
        mu=glob_mean if NA_as_zero else None,
        G0=G0, r0_vec=r0_vec,
        lam_const_vec=lam_const_B,
        l1_vec=l1_vec_B, method=method, n_steps=max_cg_steps,
        nonneg=nonneg, max_cd_steps=max_cd_steps, scale_lam=scale_lam,
        precondition=precondition_cg, mxu_bf16=mxu_bf16, dtype=jdtype,
        ring_mesh=ring_mesh,
    )
    if ring_mesh is None:
        B_orig = blocks_to_orig(B_blocks, perm_B, n)
        opp = (_ext_with_ones(B_orig, k) if user_bias
               else _ext_with_zeros(B_orig, k))
        opp_bias = B_orig[:, k] if item_bias else None
    else:
        opp, opp_bias = _ring_opp_from_blocks(
            B_blocks, mask_B, k, user_bias, ring_mesh)
        opp_bias = opp_bias if item_bias else None
    G0 = r0_vec = None
    if NA_as_zero:
        G0 = gram_matrix(opp)
        r0_vec = _na0_rhs_base(opp, opp_bias, glob_mean)
    A_blocks = update_side(
        plan_A, A_blocks, opp, opp_bias, lam_vec_A,
        buckets_data=dataA,
        mu=glob_mean if NA_as_zero else None,
        G0=G0, r0_vec=r0_vec,
        lam_const_vec=lam_const_A,
        l1_vec=l1_vec_A, method=method, n_steps=max_cg_steps,
        nonneg=nonneg, max_cd_steps=max_cd_steps, scale_lam=scale_lam,
        precondition=precondition_cg, mxu_bf16=mxu_bf16, dtype=jdtype,
        ring_mesh=ring_mesh,
    )
    return A_blocks, B_blocks


def _ring_shard(opp, ring_mesh):
    """Pin the assembled opposing matrix to a row-sharded layout so the
    replicated [S, K] form never materializes in big-axis mode."""
    if ring_mesh is None:
        return opp
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.lax.with_sharding_constraint(
        opp, NamedSharding(ring_mesh, P("d"))
    )


def _ring_remap(RB, CB, dataA, dataB):
    """Big-axis fit setup: remap each side's bucket ids into the opposing
    side's concat layout and build the real-row masks (1.0 at real rows,
    0.0 at bucket padding rows)."""
    perm_A = jnp.asarray(RB.perm.astype(np.int32))
    perm_B = jnp.asarray(CB.perm.astype(np.int32))
    dataA = _remap_bucket_ids(dataA, perm_B)  # A's slots index B rows
    dataB = _remap_bucket_ids(dataB, perm_A)
    mask_A = jnp.asarray((RB.row_of >= 0).astype(np.float32))
    mask_B = jnp.asarray((CB.row_of >= 0).astype(np.float32))
    return dataA, dataB, mask_A, mask_B


@jax.jit
def _remap_bucket_ids(data, perm_opp):
    """Rewrite bucket column ids from original ids to positions in the
    opposing side's CONCATENATED block layout (perm_opp[g] = concat
    position of original row g).

    Big-axis mode never re-orders the opposing factors to original row
    order — the permuted gather would make XLA all-gather the full [S, K]
    matrix (measured), exactly the array that doesn't fit.  Remapping the
    (static) ids once per fit lets each half-step consume the factor
    blocks in their resident sharded layout."""
    return tuple(
        (jnp.take(perm_opp, idx), val, ln, wgt)
        for (idx, val, ln, wgt) in data
    )


def _ring_cat_blocks(blocks, mask_real, ring_mesh):
    """Concat-layout opposing matrix for ring mode: bucket padding rows
    carry random init values and would pollute shared Grams — zero them,
    then pin the row-sharded layout."""
    return _ring_shard(
        jnp.concatenate(blocks, axis=0) * mask_real[:, None], ring_mesh)


def _ring_opp_from_blocks(blocks, mask_real, bias_col, set_ones, ring_mesh):
    """Assemble the opposing matrix for a ring half-step from the factor
    blocks in concat order: zero the padding rows (they carry random init
    values and would pollute shared Grams), then write the bias-ones
    column in place of _ext_with_ones.  Returns (opp, opp_bias), both in
    concat order, row-sharded."""
    full = jnp.concatenate(blocks, axis=0) * mask_real[:, None]
    opp_bias = full[:, bias_col]
    opp = full.at[:, bias_col].set(mask_real if set_ones else 0.0)
    return _ring_shard(opp, ring_mesh), opp_bias


def _seed_factor_blocks(blocks, bucketed: BucketedRows, M, k, dtype):
    """Write warm-start factor rows into the bucketed block layout."""
    M = np.asarray(M, np.float64)
    out = []
    ext = np.concatenate([M, np.zeros((1, M.shape[1]))], axis=0)
    for b, blk in zip(bucketed.buckets, blocks):
        sl = bucketed.row_of[b.start : b.start + b.n_rows]
        vals = jnp.asarray(ext[sl, :k].astype(dtype))
        out.append(blk.at[:, :k].set(vals))
    return out


def _set_bias_coord(blocks, bucketed: BucketedRows, bias_vec, coord, dtype):
    """Write initial biases into each block's bias coordinate."""
    out = []
    ext = np.concatenate([bias_vec, [0.0]])  # padding rows map to row_of == -1
    for b, blk in zip(bucketed.buckets, blocks):
        sl = bucketed.row_of[b.start : b.start + b.n_rows]
        vals = jnp.asarray(ext[sl].astype(dtype))
        out.append(blk.at[:, coord].set(vals))
    return out


@jax.jit
def _na0_rhs_base(opp, opp_bias, glob_mean):
    """opp^T (-mu - opp_bias): rhs contribution of the all-zero entries
    under NA-as-zero (the reference's BtXbias,
    /root/reference/src/collective.c:303-312)."""
    t = -glob_mean * jnp.ones(opp.shape[0], opp.dtype)
    if opp_bias is not None:
        t = t - opp_bias
    return jnp.einsum("sk,s->k", opp, t, precision=SOLVER_PRECISION)


@profiled_fit
def fit_implicit_als(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    *,
    k: int = 50,
    lambda_=1.0,
    l1_lambda=0.0,
    niter: int = 15,
    use_cg: bool = True,
    max_cg_steps: int = 3,
    precondition_cg: bool = False,
    finalize_chol: bool = False,
    alpha: float = 1.0,
    apply_log_transf: bool = False,
    adjust_weight: bool = False,
    nonneg: bool = False,
    max_cd_steps: int = 100,
    dtype=np.float32,
    seed: int = 1,
    verbose: bool = False,
    mesh=None,  # jax.sharding.Mesh for multi-device row-parallel solves
    init=None,  # warm restart: dict(A=, B=)
    checkpoint_path: Optional[str] = None,  # mid-fit periodic checkpoints
    checkpoint_every: int = 0,
    shard_opposing_rows: bool = False,  # big-axis mode (see fit_explicit_als)
) -> dict:
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter)
    if nonneg:
        use_cg = False

    if shard_opposing_rows:
        if mesh is None:
            raise ValueError("shard_opposing_rows requires mesh=")
        if use_cg:
            raise ValueError(
                "shard_opposing_rows supports Cholesky/CD solves only "
                "(truncated CG would cost one ring per matvec); "
                "pass use_cg=False"
            )

    vals = np.asarray(vals, np.float64)
    if apply_log_transf:
        vals = np.log(vals)
    vals = vals.astype(dtype)

    w_main = 1.0
    if adjust_weight:
        w_main = len(vals) / (float(m) * float(n))

    # Fused dense-confidence engine when the padded [m, n] form fits the
    # dense budget (Wx/Xp bf16 + int8 mask, both orientations = 10 bytes
    # per padded entry).  use_cg=False rides it in exact mode (Krylov-capped
    # converged CG, see fit_explicit_als) unless CMFREC_TPU_NO_EXACT_DENSE=1.
    if (mesh is None
            and on_accelerator()
            and np.dtype(dtype) == np.float32
            and os.environ.get("CMFREC_TPU_NO_PALLAS", "0") != "1"
            and (use_cg or exact_dense_enabled())
            and not nonneg and not np.any(l16 > 0)):
        from ..ops.masked_matmul import pad_dim

        m_pad = pad_dim(m)
        n_pad = pad_dim(n)
        if (m_pad * n_pad < np.iinfo(np.int32).max
                and m_pad * n_pad * 10 <= default_dense_budget()):
            from .dense_pallas import fit_implicit_dense_pallas

            return fit_implicit_dense_pallas(
                rows, cols, vals, m, n, k=k, lam6=lam6, niter=niter,
                max_cg_steps=max_cg_steps,
                finalize_steps=int(
                    os.environ.get("CMFREC_TPU_FINALIZE_STEPS", "16")
                ),
                finalize_chol=finalize_chol, alpha=alpha,
                w_main_multiplier=w_main, dtype=dtype, seed=seed,
                verbose=verbose, init=init, ckpt=ckpt, exact=not use_cg,
            )

    RB, CB = _build_pair(rows, cols, vals, m, n, None, dtype,
                         row_block=_mesh_row_block(mesh))
    if mesh is None:
        RB.device_put()
        CB.device_put()
    perm_A = jnp.asarray(RB.perm)
    perm_B = jnp.asarray(CB.perm)

    k_pad = round_up(k, 8)
    key = jax.random.PRNGKey(seed)
    key, A_blocks = init_blocks(key, RB, k, k_pad, dtype)
    key, B_blocks = init_blocks(key, CB, k, k_pad, dtype)
    if init is not None:
        if init.get("A") is not None:
            A_blocks = _seed_factor_blocks(A_blocks, RB, init["A"], k, dtype)
        if init.get("B") is not None:
            B_blocks = _seed_factor_blocks(B_blocks, CB, init["B"], k, dtype)
    if mesh is not None:
        (A_blocks, B_blocks), (perm_A, perm_B) = _shard_driver_state(
            mesh, [RB, CB], [A_blocks, B_blocks], [perm_A, perm_B],
        )

    lam_vec_A = _make_lam_vec(k, k_pad, lam6[2], 0.0, False, dtype)
    lam_vec_B = _make_lam_vec(k, k_pad, lam6[3], 0.0, False, dtype)
    l1_vec_A = _make_l1_vec(k, k_pad, l16[2], 0.0, False, dtype)
    l1_vec_B = _make_l1_vec(k, k_pad, l16[3], 0.0, False, dtype)

    bf16_ok = (
        on_accelerator()
        and np.dtype(dtype) == np.float32
        and os.environ.get("CMFREC_TPU_NO_BF16", "0") != "1"
    )

    dataA = bucket_arrays(RB)
    dataB = bucket_arrays(CB)
    mask_A = mask_B = None
    if shard_opposing_rows:
        dataA, dataB, mask_A, mask_B = _ring_remap(RB, CB, dataA, dataB)
    w_dev = jnp.asarray(w_main, dtype)
    alpha_dev = jnp.asarray(alpha, dtype)

    try:
        for it in range(niter):
            method = "cg" if (use_cg and not (finalize_chol and it == niter - 1)) else "chol"
            t0 = time.time()
            A_blocks, B_blocks = _implicit_sparse_iteration(
                A_blocks, B_blocks, dataA, dataB, perm_A, perm_B,
                lam_vec_A, lam_vec_B, l1_vec_A, l1_vec_B, w_dev, alpha_dev,
                m=m, n=n, method=method, max_cg_steps=max_cg_steps,
                nonneg=nonneg, max_cd_steps=max_cd_steps,
                precondition_cg=precondition_cg,
                mxu_bf16=bf16_ok and method == "cg",
                jdtype=jnp.dtype(dtype),
                ring_mesh=mesh if shard_opposing_rows else None,
                mask_A=mask_A, mask_B=mask_B,
            )
            if verbose:
                jax.block_until_ready(A_blocks)
                print(f"iter {it + 1}/{niter} [{method}] {time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _sparse_fit_state(
                A_blocks, B_blocks, perm_A, perm_B, m, n, k, False, False))
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    # return layout == checkpoint layout (1:1 with init=) by construction
    out = _sparse_fit_state(A_blocks, B_blocks, perm_A, perm_B, m, n, k,
                            False, False)
    out.update({"glob_mean": 0.0, "k": k,
                "w_main_multiplier": w_main, "alpha": alpha})
    return out



@partial(
    jax.jit,
    static_argnames=("m", "n", "method", "max_cg_steps", "nonneg",
                     "max_cd_steps", "precondition_cg", "mxu_bf16",
                     "jdtype", "ring_mesh"),
)
def _implicit_sparse_iteration(
    A_blocks, B_blocks, dataA, dataB, perm_A, perm_B,
    lam_vec_A, lam_vec_B, l1_vec_A, l1_vec_B, w_main, alpha,
    *, m, n, method, max_cg_steps, nonneg, max_cd_steps, precondition_cg,
    mxu_bf16, jdtype, ring_mesh=None, mask_A=None, mask_B=None,
):
    """One full WRMF iteration over bucketed data — module-level so the
    compilation caches across fits."""
    plan_A = SidePlan(None, "implicit", n)
    plan_B = SidePlan(None, "implicit", m)
    # Reference order: B first, then A (collective.c:9927 precedes :9981).
    if ring_mesh is None:
        A_orig = blocks_to_orig(A_blocks, perm_A, m)
    else:  # concat order, padding rows zeroed (see _ring_opp_from_blocks)
        A_orig = _ring_shard(
            jnp.concatenate(A_blocks, axis=0) * mask_A[:, None], ring_mesh)
    G0 = w_main * gram_matrix(A_orig)
    B_blocks = update_side(
        plan_B, B_blocks, A_orig, None, lam_vec_B,
        buckets_data=dataB,
        w=w_main, alpha=alpha, G0=G0,
        l1_vec=l1_vec_B, method=method, n_steps=max_cg_steps,
        nonneg=nonneg, max_cd_steps=max_cd_steps,
        precondition=precondition_cg, mxu_bf16=mxu_bf16, dtype=jdtype,
        ring_mesh=ring_mesh,
    )
    if ring_mesh is None:
        B_orig = blocks_to_orig(B_blocks, perm_B, n)
    else:
        B_orig = _ring_shard(
            jnp.concatenate(B_blocks, axis=0) * mask_B[:, None], ring_mesh)
    G0 = w_main * gram_matrix(B_orig)
    A_blocks = update_side(
        plan_A, A_blocks, B_orig, None, lam_vec_A,
        buckets_data=dataA,
        w=w_main, alpha=alpha, G0=G0,
        l1_vec=l1_vec_A, method=method, n_steps=max_cg_steps,
        nonneg=nonneg, max_cd_steps=max_cd_steps,
        precondition=precondition_cg, mxu_bf16=mxu_bf16, dtype=jdtype,
        ring_mesh=ring_mesh,
    )
    return A_blocks, B_blocks


def _fit_explicit_dense(
    rows, cols, vals_c, m, n, *, weights,
    k, lam6, niter, max_cg_steps, finalize_chol, user_bias, item_bias,
    glob_mean, scale_lam, scale_bias_const, biasA0, biasB0,
    dtype, seed, verbose, init=None, precondition_cg=False, ckpt=None,
) -> dict:
    """Dense-masked CG fit (see dense_engine.py).  finalize_chol runs the
    final iteration through the bucketed engine (per-row Cholesky)."""
    from .dense_engine import dense_cg_update, dense_from_coo

    Xd, Wd = dense_from_coo(rows, cols, vals_c, m, n, weights, dtype)

    K = k + 1  # bias coordinate always allocated (zero + lam 1 when unused)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    scale = 1.0 / np.sqrt(max(k, 1))
    A = scale * jax.random.normal(k1, (m, K), dtype)
    B = scale * jax.random.normal(k2, (n, K), dtype)
    if init is not None:
        if init.get("A") is not None:
            A = A.at[:, :k].set(jnp.asarray(np.asarray(init["A"], dtype)))
        if init.get("B") is not None:
            B = B.at[:, :k].set(jnp.asarray(np.asarray(init["B"], dtype)))
        if user_bias and init.get("biasA") is not None:
            biasA0 = np.asarray(init["biasA"], dtype)
        if item_bias and init.get("biasB") is not None:
            biasB0 = np.asarray(init["biasB"], dtype)
    A = A.at[:, k].set(
        jnp.asarray(biasA0.astype(dtype)) if user_bias else 0.0
    )
    B = B.at[:, k].set(
        jnp.asarray(biasB0.astype(dtype)) if item_bias else 0.0
    )

    lam_vec_A = _make_lam_vec(k, K, lam6[2], lam6[0], user_bias, dtype)
    lam_vec_B = _make_lam_vec(k, K, lam6[3], lam6[1], item_bias, dtype)
    lam_const_A = lam_const_B = None
    lam_mult_A = lam_mult_B = None
    if scale_lam:
        lam_mult_A = jnp.sum(Wd.astype(jnp.float32), axis=1).astype(dtype)
        lam_mult_B = jnp.sum(Wd.astype(jnp.float32), axis=0).astype(dtype)
        if scale_bias_const:
            wsum_total = float(np.sum(weights)) if weights is not None else float(len(vals_c))
            if user_bias:
                v = np.zeros(K)
                v[k] = lam6[0] * (wsum_total / max(m, 1))
                lam_const_A = jnp.asarray(v, dtype)
                lam_vec_A = lam_vec_A.at[k].set(0.0)
            if item_bias:
                v = np.zeros(K)
                v[k] = lam6[1] * (wsum_total / max(n, 1))
                lam_const_B = jnp.asarray(v, dtype)
                lam_vec_B = lam_vec_B.at[k].set(0.0)

    # finalize_chol: the reference switches the last iteration to exact
    # per-row Cholesky to remove CG truncation error
    # (/root/reference/src/collective.c:8336-8340).  Here the final
    # iteration instead runs CG to convergence (30 steps on a
    # well-conditioned k x k ridge system reaches f32 machine precision),
    # which solves the identical linear systems without leaving the
    # dense path.
    try:
        for it in range(niter):
            final = finalize_chol and (it == niter - 1)
            steps = 30 if final else max_cg_steps
            t0 = time.time()
            # Reference order: B before A (collective.c:8614 / :8802).
            Ae = _ext_with_ones(A, k) if item_bias else _ext_with_zeros(A, k)
            B = dense_cg_update(
                B, Xd, Wd, Ae, A[:, k] if user_bias else None,
                lam_vec_B, lam_mult_B, lam_const_B, steps, 1,
                jacobi=precondition_cg and not final,
            )
            Be = _ext_with_ones(B, k) if user_bias else _ext_with_zeros(B, k)
            A = dense_cg_update(
                A, Xd, Wd, Be, B[:, k] if item_bias else None,
                lam_vec_A, lam_mult_A, lam_const_A, steps, 0,
                jacobi=precondition_cg and not final,
            )
            if verbose:
                jax.block_until_ready(B)
                tag = "dense-cg*" if final else "dense-cg"
                print(f"iter {it + 1}/{niter} [{tag}] {time.time() - t0:.3f}s")
            if ckpt is not None:
                ckpt.maybe_save(it + 1, lambda: {
                    "A": A[:, :k], "B": B[:, :k],
                    "biasA": A[:, k] if user_bias else None,
                    "biasB": B[:, k] if item_bias else None,
                })
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    A_final = np.asarray(A)
    B_final = np.asarray(B)
    return {
        "A": A_final[:, :k],
        "B": B_final[:, :k],
        "biasA": A_final[:, k] if user_bias else None,
        "biasB": B_final[:, k] if item_bias else None,
        "glob_mean": float(glob_mean),
        "k": k,
    }
