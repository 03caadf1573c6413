"""Dense-masked ALS on the fused masked-Gram kernel — the GPU fit path.

Same mathematics as solvers/dense_engine.py (whole-matrix masked CG on the
per-row ridge systems of /root/reference/src/common.c:2742 optimizeA), but
the masked products run through the fused Pallas kernels of
ops/masked_matmul.py, so each CG matvec costs one streamed read of the
int8/bf16 mask instead of two [m, n] f32 round-trips through device memory.

Numerics: X is kept raw (uncentered) in bf16 — explicit-feedback ratings on
half-point grids are exact in bf16 — with the global mean and opposing bias
folded into the rhs kernel's f32 `mb` vector.  The factor matrices are f32;
they are rounded to bf16 only at the matmul input of each CG step.  The final
`finalize_chol` iteration runs more CG steps with f32 matmul operands, landing
the factors at the f32 fixed point just as the reference's final Cholesky
does (/root/reference/src/collective.c:8336-8340).

All jitted steps live at module level with explicit arguments (no closure
captures) so compilations are cached across fits within a process.
"""

from __future__ import annotations

import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.masked_matmul import masked_gram_matvec, masked_rhs, pad_dim, pad_k


@jax.jit
def _cat_uploads(f_c, v_c, w_c):
    """Concatenate chunked uploads in ONE dispatch (instead of one eager
    concatenate per array)."""
    cat = (lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs))
    return (cat(f_c), cat(v_c),
            cat(w_c) if w_c else jnp.zeros(0, jnp.float32))


def _ship_interactions(rows, cols, vals_raw, weights, n_pad, *, scale=None):
    """Flat-index (i32) + bf16-value uploads for the dense engines, in
    row-wise chunks whose device_put enqueues are ASYNC: chunk i crosses
    PCIe while the host converts chunk i+1 (the int64 multiply-add and
    f64->bf16 casts).  ~6 B/entry are uploaded; what the overlap saves on
    the GPU is not measured.  Returns (flat, vals_bf16, wgt_f32|empty).
    ``scale`` premultiplies values (the implicit alpha)."""
    from ..data.device_fill import plan_wire_chunks

    rows64 = np.asarray(rows, np.int64)
    cols64 = np.asarray(cols, np.int64)
    nnz = rows64.shape[0]
    weighted = weights is not None
    ch = plan_wire_chunks(nnz, 6 + (4 if weighted else 0),
                          opt_out_env="CMFREC_TPU_NO_WIRE_OVERLAP")
    bnds = [(i * nnz) // ch for i in range(ch + 1)]
    vsrc = np.asarray(vals_raw, np.float64)
    f_c, v_c, w_c = [], [], []
    for a, b in zip(bnds[:-1], bnds[1:]):
        fh = (rows64[a:b] * n_pad + cols64[a:b]).astype(np.int32)
        f_c.append(jnp.asarray(fh))
        v = vsrc[a:b] if scale is None else scale * vsrc[a:b]
        v_c.append(jnp.asarray(v.astype(jnp.bfloat16)))
        if weighted:
            w_c.append(jnp.asarray(
                np.asarray(weights[a:b], np.float32)))
    return _cat_uploads(tuple(f_c), tuple(v_c), tuple(w_c))


@partial(jax.jit, static_argnames=("m_pad", "n_pad", "weighted"))
def _setup(flat_idx, vals, wvals, m_pad, n_pad, weighted):
    """Scatter COO -> padded dense [m_pad, n_pad] bf16 X + mask/weights W,
    both orientations, plus row/col observation counts."""
    X = (
        jnp.zeros(m_pad * n_pad, jnp.bfloat16)
        .at[flat_idx]
        .set(vals.astype(jnp.bfloat16))
        .reshape(m_pad, n_pad)
    )
    if weighted:
        W = (
            jnp.zeros(m_pad * n_pad, jnp.float32)
            .at[flat_idx]
            .set(wvals)
            .reshape(m_pad, n_pad)
        )
        cnt_A = jnp.sum(W, axis=1)
        cnt_B = jnp.sum(W, axis=0)
    else:
        W = (
            jnp.zeros(m_pad * n_pad, jnp.int8)
            .at[flat_idx]
            .set(1)
            .reshape(m_pad, n_pad)
        )
        cnt_A = jnp.sum(W, axis=1, dtype=jnp.float32)
        cnt_B = jnp.sum(W, axis=0, dtype=jnp.float32)
    return X, W, X.T, W.T, cnt_A, cnt_B


def _cg(P, rhs, matvec, n_steps, dyn_stop=False):
    """Truncated CG with per-row early freeze (masked step size).

    Two-tolerance stopping matching the reference exactly
    (/root/reference/src/common.c:1147,1181) and rowsolve.solve_cg /
    dense_engine._masked_cg: rows whose initial residual is <= 1e-12 are
    skipped; a live row stops once its post-step residual falls <= 1e-8.

    dyn_stop=True (exact mode) additionally stops the whole loop once
    EVERY row is frozen (lax.while_loop instead of scan).  Frozen rows
    are exact no-ops in the scan form (alpha = 0), so the result is
    identical — this only removes wasted matvecs.  Exact mode also adds
    a RELATIVE stop floor, max(1e-8, (1e-6*|rhs_r|)^2): the absolute
    1e-8 squared-residual target is unreachable in f32 for rows whose
    rhs norm is large (f32 CG stagnates around 1e-7*|rhs| relative), and
    without the floor such rows would never freeze and every half-step
    would pay the full step cap.  At the floor the solution error is
    ~1e-6*|rhs|/lam_min — the same noise class as an f32 Cholesky."""
    r = rhs - matvec(P)
    rs0 = jnp.sum(r * r, axis=-1)
    live0 = rs0 > 1e-12
    if dyn_stop:
        tol = jnp.maximum(
            jnp.float32(1e-8), 1e-12 * jnp.sum(rhs * rhs, axis=-1))
    else:
        tol = jnp.float32(1e-8)

    def step(a, r, p, rs, live):
        Ap = matvec(p)
        denom = jnp.sum(p * Ap, axis=-1)
        alpha = jnp.where(live, rs / jnp.where(denom == 0, 1, denom), 0.0)
        a = a + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = jnp.sum(r * r, axis=-1)
        live = live & (rs_new > tol)
        beta = jnp.where(live, rs_new / jnp.where(rs == 0, 1, rs), 0.0)
        p = jnp.where(live[:, None], r + beta[:, None] * p, p)
        return a, r, p, jnp.where(live, rs_new, rs), live

    if dyn_stop:
        def cond(carry):
            _, _, _, _, live, i = carry
            return (i < n_steps) & jnp.any(live)

        def body_w(carry):
            a, r, p, rs, live, i = carry
            a, r, p, rs, live = step(a, r, p, rs, live)
            return (a, r, p, rs, live, i + 1)

        out = jax.lax.while_loop(
            cond, body_w, (P, r, r, rs0, live0, jnp.int32(0)))
        return out[0]

    def body(carry, _):
        return step(*carry), None

    (a, _, _, _, _), _ = jax.lax.scan(
        body, (P, r, r, rs0, live0), None, length=n_steps)
    return a


def _half_step(P, X, W, Be, mb, lam_row, live, *, n_steps, compute_dtype,
               mesh=None, G0=None, R0=None, dyn_stop=False):
    """One side's update: solve (Be^T diag(W_r) Be + G0 + lam_r) a_r =
    rhs_r + R0_r for all rows r at once via fused-kernel CG.  G0/R0 carry
    the collective model's side-info terms (w_u·CtC and w_u·U@C)."""
    Bek = Be.astype(compute_dtype)
    rhs = masked_rhs(X, W, mb, Bek, mesh=mesh)
    if R0 is not None:
        rhs = rhs + R0

    def matvec(v):
        mv = masked_gram_matvec(v.astype(compute_dtype), Bek, W, mesh=mesh)
        if G0 is not None:
            mv = mv + jnp.einsum("km,rm->rk", G0, v,
                                 precision=jax.lax.Precision.HIGHEST)
        return mv + v * lam_row

    a = _cg(P, rhs, matvec, n_steps, dyn_stop=dyn_stop)
    return jnp.where(live[:, None], a, 0.0)


def _half_step_na0(X, Be, mb, live_opp, lam_diag):
    """NA-as-zero (unweighted) half-step: every column participates with
    value 0 at missing entries, so the Gram is SHARED across rows and the
    update is one closed-form solve (the reference's optimizeA case 3,
    /root/reference/src/common.c:3118):
        (Be_live^T Be_live + diag(lam)) a_r = (X @ Be)_r - mb @ Be_live
    """
    hp = jax.lax.Precision.HIGHEST
    Bl = jnp.where(live_opp[:, None], Be, 0.0)
    G = (jnp.einsum("sk,sl->kl", Bl, Bl, precision=hp)
         + jnp.diag(lam_diag))
    rhs = (jnp.einsum("rs,sk->rk", X.astype(jnp.float32), Bl, precision=hp)
           - jnp.einsum("s,sk->k", mb, Bl, precision=hp)[None, :])
    L = jax.lax.linalg.cholesky(G)
    y = jax.lax.linalg.triangular_solve(L, rhs.T, left_side=True, lower=True)
    out = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                          transpose_a=True)
    return out.T


@partial(
    jax.jit,
    static_argnames=("k", "user_bias", "item_bias", "n_steps", "compute",
                     "mesh", "na0", "dyn_stop"),
)
def _iteration(
    A, B, X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu,
    *, k, user_bias, item_bias, n_steps, compute, mesh=None, na0=False,
    dyn_stop=False,
):
    """One full ALS iteration: B half-step then A half-step (the
    reference's in-iteration order, /root/reference/src/collective.c:8614
    "Updating B" before :8802 "Updating A")."""
    cdt = jnp.bfloat16 if compute == "bf16" else jnp.float32
    n_pad = B.shape[0]
    m_pad = A.shape[0]
    Ae = A.at[:, k].set(1.0 if item_bias else 0.0)
    mbB = mu * jnp.ones(m_pad, jnp.float32)
    if user_bias:
        mbB = mbB + A[:, k]
    if na0:
        # lam_row_* is the shared [Kp] diagonal in this mode
        B2 = _half_step_na0(XT, Ae, mbB, live_A, lam_row_B)
        B = jnp.where(live_B[:, None], B2, 0.0)
    else:
        B = _half_step(B, XT, WT, Ae, mbB, lam_row_B, live_B,
                       n_steps=n_steps, compute_dtype=cdt, mesh=mesh,
                       dyn_stop=dyn_stop)
    Be = B.at[:, k].set(1.0 if user_bias else 0.0)
    mbA = mu * jnp.ones(n_pad, jnp.float32)
    if item_bias:
        mbA = mbA + B[:, k]
    if na0:
        A2 = _half_step_na0(X, Be, mbA, live_B, lam_row_A)
        A = jnp.where(live_A[:, None], A2, 0.0)
    else:
        A = _half_step(A, X, W, Be, mbA, lam_row_A, live_A,
                       n_steps=n_steps, compute_dtype=cdt, mesh=mesh,
                       dyn_stop=dyn_stop)
    return A, B


@partial(jax.jit, static_argnames=("shape", "coord", "seed_bias"))
def _init_factors(key, live, bias0, shape, coord, seed_bias):
    scale = float(1.0 / np.sqrt(max(coord, 1)))
    M = scale * jax.random.normal(key, shape, jnp.float32)
    coord_pad = jnp.arange(shape[1]) > coord
    M = jnp.where(coord_pad[None, :] | ~live[:, None], 0.0, M)
    return M.at[:, coord].set(bias0 if seed_bias else 0.0)


@partial(jax.jit, static_argnames=("scale_lam", "user_bias", "item_bias"))
def _device_bias_init(X, W, cnt_A, cnt_B, mu, lam_user, lam_item,
                      scale_lam, user_bias, item_bias):
    """Iterated alternating closed-form bias init from the dense forms
    (device-side equivalent of preprocess.initialize_biases /
    initialize_biases_twosided, /root/reference/src/common.c:4410): 5
    alternating full re-solves when both biases are on (items first),
    one pass otherwise."""
    Wf = W.astype(jnp.float32)
    Xf = X.astype(jnp.float32)
    sB0 = jnp.einsum("rs,rs->s", Xf, Wf) - mu * cnt_B
    sA0 = jnp.einsum("rs,rs->r", Xf, Wf) - mu * cnt_A
    denomB = cnt_B + lam_item * (jnp.maximum(cnt_B, 1.0) if scale_lam else 1.0)
    denomA = cnt_A + lam_user * (jnp.maximum(cnt_A, 1.0) if scale_lam else 1.0)
    biasA = jnp.zeros(Xf.shape[0], jnp.float32)
    biasB = jnp.zeros(Xf.shape[1], jnp.float32)
    n_pass = 5 if (user_bias and item_bias) else 1

    def one_pass(carry, _):
        biasA, biasB = carry
        if item_bias:
            sB = sB0 - biasA @ Wf
            biasB = jnp.where(denomB > 0,
                              sB / jnp.where(denomB > 0, denomB, 1.0), 0.0)
        if user_bias:
            sA = sA0 - Wf @ biasB
            biasA = jnp.where(denomA > 0,
                              sA / jnp.where(denomA > 0, denomA, 1.0), 0.0)
        return (biasA, biasB), None

    (biasA, biasB), _ = jax.lax.scan(one_pass, (biasA, biasB), None,
                                     length=n_pass)
    return biasA, biasB


@partial(
    jax.jit,
    static_argnames=("k", "user_bias", "item_bias", "n_steps", "compute",
                     "n_iters", "mesh", "na0", "dyn_stop"),
)
def _run_iterations(
    A, B, X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu,
    *, n_iters, k, user_bias, item_bias, n_steps, compute, mesh=None,
    na0=False, dyn_stop=False,
):
    """n_iters full ALS iterations in ONE device dispatch."""

    def body(carry, _):
        A, B = carry
        A, B = _iteration(
            A, B, X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu,
            k=k, user_bias=user_bias, item_bias=item_bias, n_steps=n_steps,
            compute=compute, mesh=mesh, na0=na0, dyn_stop=dyn_stop,
        )
        return (A, B), None

    (A, B), _ = jax.lax.scan(body, (A, B), None, length=n_iters)
    return A, B


def _exact_cap(k_sys):
    """Step cap for exact mode: twice the Krylov bound (CG on an SPD
    system of dimension d terminates in d steps in exact arithmetic;
    f32 rounding delays termination, so allow 2d + 4).  The per-row
    freeze (see _cg) plus the global all-frozen stop (dyn_stop) means
    typical data pays far fewer steps; the cap only bounds pathological
    rows.  CMFREC_TPU_EXACT_STEPS overrides."""
    import os

    v = int(os.environ.get("CMFREC_TPU_EXACT_STEPS", "0"))
    return v if v > 0 else 2 * k_sys + 4


def fit_explicit_dense_pallas(
    rows, cols, vals_raw, m, n, *, weights,
    k, lam6, niter, max_cg_steps, finalize_chol, finalize_steps,
    user_bias, item_bias, glob_mean,
    scale_lam, scale_bias_const, biasA0, biasB0,
    dtype, seed, verbose, mesh=None, init=None,
    na_as_zero=False, ckpt=None, exact=False,
) -> dict:
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    m_pad = pad_dim(m, row_mult=n_dev)
    n_pad = pad_dim(n, row_mult=n_dev)
    Kp = pad_k(k + 1)

    weighted = weights is not None
    # Direct flat-index upload (int32) + bf16 values: explicit ratings are
    # exact in bf16, and the flat index is one vectorized multiply-add.
    flat, vals_dev, w_dev = _ship_interactions(
        rows, cols, vals_raw, weights, n_pad)
    X, W, XT, WT, cnt_A, cnt_B = _setup(
        flat, vals_dev, w_dev, m_pad, n_pad, weighted
    )
    if mesh is not None:
        # DP layout: interactions and factors row-sharded on each side's
        # orientation; the opposing factors are all-gathered per half-step
        # by the shard_map'd kernels (the ALX layout, SURVEY.md §2.4 P5).
        from jax.sharding import NamedSharding, PartitionSpec as _P

        rs = NamedSharding(mesh, _P("d"))
        X, W = jax.device_put(X, rs), jax.device_put(W, rs)
        XT, WT = jax.device_put(XT, rs), jax.device_put(WT, rs)
    if na_as_zero:
        # every real row/column participates (missing entries are zeros)
        live_A = jnp.arange(m_pad) < m
        live_B = jnp.arange(n_pad) < n
    else:
        live_A = cnt_A > 0
        live_B = cnt_B > 0

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    mu = jnp.float32(glob_mean)
    if biasA0 is None and biasB0 is None and (user_bias or item_bias):
        # compute the closed-form starting biases on device (the host
        # bincount pass is a second full pass over the interactions)
        bA_dev, bB_dev = _device_bias_init(
            X, W, cnt_A, cnt_B, mu, float(lam6[0]), float(lam6[1]),
            scale_lam, user_bias, item_bias,
        )
    else:
        bA0 = np.zeros(m_pad, np.float32)
        bB0 = np.zeros(n_pad, np.float32)
        if user_bias and biasA0 is not None:
            bA0[:m] = biasA0
        if item_bias and biasB0 is not None:
            bB0[:n] = biasB0
        bA_dev, bB_dev = jnp.asarray(bA0), jnp.asarray(bB0)
    A = _init_factors(k1, live_A, bA_dev, (m_pad, Kp), k, user_bias)
    B = _init_factors(k2, live_B, bB_dev, (n_pad, Kp), k, item_bias)
    if init is not None:
        # warm restart (the reference's reset_values=False,
        # /root/reference/src/cmfrec.h:1858): continue from given factors
        if init.get("A") is not None:
            A = A.at[:m, :k].set(
                jnp.asarray(np.asarray(init["A"], np.float32)))
        if init.get("B") is not None:
            B = B.at[:n, :k].set(
                jnp.asarray(np.asarray(init["B"], np.float32)))
        if user_bias and init.get("biasA") is not None:
            A = A.at[:m, k].set(
                jnp.asarray(np.asarray(init["biasA"], np.float32)))
        if item_bias and init.get("biasB") is not None:
            B = B.at[:n, k].set(
                jnp.asarray(np.asarray(init["biasB"], np.float32)))

    def lam_row_for(lam_f, lam_bias, has_bias, cnt, count_avg):
        v = np.ones(Kp, np.float32)
        v[:k] = lam_f
        v[k] = lam_bias if has_bias else 1.0
        vec = jnp.asarray(v)
        if not scale_lam:
            return vec[None, :]
        lam_row = vec[None, :] * jnp.maximum(cnt, 1.0)[:, None]
        if scale_bias_const and has_bias:
            lam_row = lam_row.at[:, k].set(lam_bias * count_avg)
        return lam_row

    count_avg_A = count_avg_B = 1.0
    if scale_lam:
        tot = float(np.sum(weights)) if weighted else float(len(flat))
        count_avg_A = tot / max(m, 1)
        count_avg_B = tot / max(n, 1)
    if na_as_zero:
        # shared [Kp] diagonal: under NA-as-zero every row sees the full
        # column count, so the scaled lambda is row-independent
        def lam_diag_for(lam_f, lam_bias, has_bias, n_opp, count_avg):
            v = np.ones(Kp, np.float32)
            v[:k] = lam_f * (n_opp if scale_lam else 1.0)
            if has_bias:
                v[k] = lam_bias * (
                    count_avg if (scale_lam and scale_bias_const)
                    else (n_opp if scale_lam else 1.0)
                )
            return jnp.asarray(v)

        lam_row_A = lam_diag_for(lam6[2], lam6[0], user_bias, n, count_avg_A)
        lam_row_B = lam_diag_for(lam6[3], lam6[1], item_bias, m, count_avg_B)
    else:
        lam_row_A = lam_row_for(lam6[2], lam6[0], user_bias, cnt_A,
                                count_avg_A)
        lam_row_B = lam_row_for(lam6[3], lam6[1], item_bias, cnt_B,
                                count_avg_B)

    statics = dict(k=k, user_bias=user_bias, item_bias=item_bias, mesh=mesh,
                   na0=na_as_zero)
    args = (X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu)

    def _state():
        # checkpoint layout == return layout (1:1 with init=)
        dt = jnp.dtype(dtype)
        return {
            "A": A[:m, :k].astype(dt),
            "B": B[:n, :k].astype(dt),
            "biasA": A[:m, k].astype(dt) if user_bias else None,
            "biasB": B[:n, k].astype(dt) if item_bias else None,
        }

    checkpointing = ckpt is not None and ckpt.every > 0
    # Exact mode (the driver's use_cg=False on this engine): every
    # half-step's CG runs in f32 to the per-row freeze under the Krylov
    # step cap with the all-frozen early exit — the masked-kernel
    # equivalent of the bucketed engine's per-row Cholesky (identical
    # per-row systems, solutions at the f32 fixed point, whole-trajectory
    # f32 like the reference's Chol path).  Warm-started later iterations
    # freeze in a handful of steps, so the all-f32 cost is adaptive.
    exact = exact and not na_as_zero
    if exact:
        bulk_steps = polish_steps = _exact_cap(k + 1)
        bulk_dyn = True
        bulk_compute = "f32"
        do_polish = False
    else:
        bulk_steps, polish_steps = max_cg_steps, finalize_steps
        bulk_dyn = False
        bulk_compute = "bf16"
        # NA-as-zero solves are exact closed forms — no f32 polish needed.
        # The same rule MUST hold on every dispatch strategy below or
        # checkpointing/verbose would change the fit result.
        do_polish = finalize_chol and not na_as_zero and niter > 0
    n_bulk = niter - 1 if do_polish else niter
    try:
        if verbose or checkpointing:
            # dispatch in host-visible chunks: every iteration when
            # verbose, else checkpoint_every iterations
            step = 1 if verbose else ckpt.every
            it = 0
            while it < n_bulk:
                n_now = min(step, n_bulk - it)
                t0 = time.time()
                A, B = _run_iterations(
                    A, B, *args, n_iters=n_now, n_steps=bulk_steps,
                    compute=bulk_compute, dyn_stop=bulk_dyn, **statics,
                )
                it += n_now
                if verbose:
                    jax.block_until_ready(B)
                    print(f"iter {it}/{niter} [pallas-bf16] "
                          f"{time.time() - t0:.3f}s")
                if checkpointing:
                    ckpt.maybe_save(it, _state)
            if do_polish:
                t0 = time.time()
                A, B = _iteration(
                    A, B, *args, n_steps=polish_steps, compute="f32",
                    dyn_stop=bulk_dyn, **statics,
                )
                if verbose:
                    jax.block_until_ready(B)
                    print(f"iter {niter}/{niter} [pallas-f32*] "
                          f"{time.time() - t0:.3f}s")
        else:
            # all bulk iterations in one dispatch, the f32 polish in another
            if n_bulk > 0:
                A, B = _run_iterations(
                    A, B, *args, n_iters=n_bulk, n_steps=bulk_steps,
                    compute=bulk_compute, dyn_stop=bulk_dyn, **statics,
                )
            if do_polish:
                A, B = _iteration(
                    A, B, *args, n_steps=polish_steps, compute="f32",
                    dyn_stop=bulk_dyn, **statics,
                )
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    # Returned as device arrays: downloading them is the caller's (lazy)
    # cost, exactly as the C reference hands back arrays that already live
    # in RAM.
    out = _state()
    out.update({"glob_mean": float(glob_mean), "k": k})
    return out


# --------------------------------------------------------------------- #
# collective model on the fused dense engine                             #
# --------------------------------------------------------------------- #


def _solve_side_factor(Ak, Ud, w_side, lam, k):
    """(w A_k^T A_k + lam I) C^T = w A_k^T U — the whole-matrix C/D update
    for fully-dense side info (collective.py _dense_full_solve)."""
    hp = jax.lax.Precision.HIGHEST
    G = (w_side * jnp.einsum("mk,ml->kl", Ak, Ak, precision=hp)
         + lam * jnp.eye(k, dtype=Ak.dtype))
    rhs = w_side * jnp.einsum("mk,mp->kp", Ak, Ud, precision=hp)
    L = jax.lax.linalg.cholesky(G)
    y = jax.lax.linalg.triangular_solve(L, rhs, left_side=True, lower=True)
    out = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                          transpose_a=True)
    return out.T  # [p, k]


def _shared_na0_solve(Fk, Mask, lam_diag, cdt):
    """Implicit-features half-step (Ai or Bi): Xones is the FULL binary
    matrix (zeros at missing entries), so every row of the solved side
    shares one system matrix and the whole update is a single Cholesky:

        (Fk^T Fk + diag(lam)) out_r = (Mask @ Fk)_r

    The reference hard-codes the closed form for these half-steps even in
    CG fits (/root/reference/src/collective.c:8479,8520)."""
    hp = jax.lax.Precision.HIGHEST
    G = (jnp.einsum("mk,ml->kl", Fk, Fk, precision=hp)
         + jnp.diag(lam_diag))
    rhs = jnp.einsum("nm,mk->nk", Mask.astype(cdt), Fk.astype(cdt),
                     precision=hp, preferred_element_type=jnp.float32)
    L = jax.lax.linalg.cholesky(G)
    y = jax.lax.linalg.triangular_solve(L, rhs.T, left_side=True, lower=True)
    out = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                          transpose_a=True)
    return out.T  # [rows, k] f32


@partial(
    jax.jit,
    static_argnames=("k", "user_bias", "item_bias", "n_steps", "compute",
                     "mesh", "has_U", "has_I", "has_impl", "n_iters",
                     "dyn_stop"),
)
def _run_collective_iterations(
    A, B, Ai, Bi, X, W, XT, WT, Ud, Id, lam_row_A, lam_row_B,
    live_A, live_B, mu, lamC, lamD, w_user, w_item,
    lam_ai, lam_bi, w_imp,
    *, n_iters, k, user_bias, item_bias, n_steps, compute, mesh, has_U,
    has_I, has_impl, dyn_stop=False,
):
    """n_iters collective ALS iterations (C, D, Bi, Ai, B, A updates) in
    one dispatch.  Side info must be fully dense (the reference's case-1
    fast path applies, /root/reference/src/collective.c:5118)."""
    cdt = jnp.bfloat16 if compute == "bf16" else jnp.float32
    # operand dtype of the plain einsums over the [m, n] mask: bf16 on the
    # GPU (tensor cores, f32 accumulation); f32 on the CPU, whose XLA has
    # no bf16 x bf16 -> f32 dot
    mdt = jnp.float32 if jax.default_backend() == "cpu" else cdt
    Kp = A.shape[1]
    m_pad, n_pad = A.shape[0], B.shape[0]
    hp = jax.lax.Precision.HIGHEST

    def body(carry, _):
        A, B, Ai, Bi, _C, _D = carry
        # Reference in-iteration order: C, D, Bi, Ai, then B, then A
        # (/root/reference/src/collective.c:8345,8396,8479,8520,8614,8802).
        # C/D ride the carry so the RETURNED side factors are the ones
        # computed at the final iteration's start (from the pre-update
        # A/B), exactly what the bucketed path and the reference store —
        # NOT a recompute against the post-update factors.
        C = _solve_side_factor(A[:, :k], Ud, w_user, lamC, k) if has_U else None
        D = _solve_side_factor(B[:, :k], Id, w_item, lamD, k) if has_I else None
        if has_impl:
            # Xones ~ A[:, :k] Bi^T and Xones^T ~ B[:, :k] Ai^T; both use
            # the PRE-update main factors (bucketed path order).
            Bi = _shared_na0_solve(A[:, :k], WT, lam_bi, mdt)
            Ai = _shared_na0_solve(B[:, :k], W, lam_ai, mdt)

        G0B = R0B = None
        if has_I or has_impl:
            G0B = jnp.zeros((Kp, Kp), jnp.float32)
            R0B = jnp.zeros((n_pad, Kp), jnp.float32)
            if has_I:
                G0B = G0B.at[:k, :k].add(
                    w_item * jnp.einsum("qk,ql->kl", D, D, precision=hp))
                R0B = R0B.at[:, :k].add(
                    w_item * jnp.einsum("nq,qk->nk", Id, D, precision=hp))
            if has_impl:
                G0B = G0B.at[:k, :k].add(
                    w_imp * jnp.einsum("mk,ml->kl", Ai, Ai, precision=hp))
                R0B = R0B.at[:, :k].add(w_imp * jnp.einsum(
                    "nm,mk->nk", WT.astype(mdt), Ai.astype(mdt),
                    precision=hp, preferred_element_type=jnp.float32))
        Ae = A.at[:, k].set(1.0 if item_bias else 0.0)
        mbB = mu * jnp.ones(m_pad, jnp.float32)
        if user_bias:
            mbB = mbB + A[:, k]
        B = _half_step(B, XT, WT, Ae, mbB, lam_row_B, live_B,
                       n_steps=n_steps, compute_dtype=cdt, mesh=mesh,
                       G0=G0B, R0=R0B, dyn_stop=dyn_stop)

        G0A = R0A = None
        if has_U or has_impl:
            G0A = jnp.zeros((Kp, Kp), jnp.float32)
            R0A = jnp.zeros((m_pad, Kp), jnp.float32)
            if has_U:
                G0A = G0A.at[:k, :k].add(
                    w_user * jnp.einsum("pk,pl->kl", C, C, precision=hp))
                R0A = R0A.at[:, :k].add(
                    w_user * jnp.einsum("mp,pk->mk", Ud, C, precision=hp))
            if has_impl:
                G0A = G0A.at[:k, :k].add(
                    w_imp * jnp.einsum("nk,nl->kl", Bi, Bi, precision=hp))
                R0A = R0A.at[:, :k].add(w_imp * jnp.einsum(
                    "mn,nk->mk", W.astype(mdt), Bi.astype(mdt),
                    precision=hp, preferred_element_type=jnp.float32))
        Be = B.at[:, k].set(1.0 if user_bias else 0.0)
        mbA = mu * jnp.ones(n_pad, jnp.float32)
        if item_bias:
            mbA = mbA + B[:, k]
        A = _half_step(A, X, W, Be, mbA, lam_row_A, live_A,
                       n_steps=n_steps, compute_dtype=cdt, mesh=mesh,
                       G0=G0A, R0=R0A, dyn_stop=dyn_stop)
        return (A, B, Ai, Bi,
                C if has_U else _C, D if has_I else _D), None

    C0 = jnp.zeros((Ud.shape[1] if has_U else 0, k), jnp.float32)
    D0 = jnp.zeros((Id.shape[1] if has_I else 0, k), jnp.float32)
    (A, B, Ai, Bi, C, D), _ = jax.lax.scan(
        body, (A, B, Ai, Bi, C0, D0), None, length=n_iters)
    return A, B, C if has_U else None, D if has_I else None, Ai, Bi


def fit_collective_dense_pallas(
    rows, cols, vals_raw, m, n, *, U_dense, I_dense, weights,
    k, lam6, w_user, w_item, niter, max_cg_steps, finalize_chol,
    finalize_steps, user_bias, item_bias, glob_mean, scale_lam,
    scale_lam_sideinfo=False,
    scale_bias_const=False, dtype=np.float32, seed=1, verbose=False,
    mesh=None, init=None, add_implicit_features=False, w_implicit=0.5,
    exact=False,
) -> dict:
    """Collective explicit ALS with fully-dense side info and/or implicit
    features on the fused masked-kernel engine (k_user = k_item = k_main =
    0, unweighted when add_implicit_features).  Solves the same per-row
    systems as solvers/collective.py's bucketed path.  exact=True (the
    driver's use_cg=False) runs every A/B half-step's CG to the per-row
    1e-8 freeze under the Krylov cap — Cholesky-quality solutions at
    masked-matvec cost; C/D/Ai/Bi half-steps are closed-form already."""
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    m_pad = pad_dim(m, row_mult=n_dev)
    n_pad = pad_dim(n, row_mult=n_dev)
    Kp = pad_k(k + 1)

    weighted = weights is not None
    flat, vals_dev, w_dev = _ship_interactions(
        rows, cols, vals_raw, weights, n_pad)
    X, W, XT, WT, cnt_A, cnt_B = _setup(
        flat, vals_dev, w_dev, m_pad, n_pad, weighted)

    has_U = U_dense is not None
    has_I = I_dense is not None
    Ud = Id = jnp.zeros(0, jnp.float32)
    if has_U:
        Ud = jnp.asarray(
            np.pad(np.asarray(U_dense, np.float32), ((0, m_pad - m), (0, 0))))
    if has_I:
        Id = jnp.asarray(
            np.pad(np.asarray(I_dense, np.float32), ((0, n_pad - n), (0, 0))))

    # with dense side info (or implicit features, whose Xones part gives
    # every row a full-rank system) every real row participates
    has_impl = bool(add_implicit_features)
    real_A = jnp.arange(m_pad) < m
    real_B = jnp.arange(n_pad) < n
    live_A = real_A if (has_U or has_impl) else (cnt_A > 0)
    live_B = real_B if (has_I or has_impl) else (cnt_B > 0)

    mu = jnp.float32(glob_mean)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    if user_bias or item_bias:
        bA_dev, bB_dev = _device_bias_init(
            X, W, cnt_A, cnt_B, mu, float(lam6[0]), float(lam6[1]),
            scale_lam, user_bias, item_bias)
    else:
        bA_dev = jnp.zeros(m_pad, jnp.float32)
        bB_dev = jnp.zeros(n_pad, jnp.float32)
    A = _init_factors(k1, live_A, bA_dev, (m_pad, Kp), k, user_bias)
    B = _init_factors(k2, live_B, bB_dev, (n_pad, Kp), k, item_bias)
    if init is not None:
        # warm restart (the reference's reset_values=False,
        # /root/reference/src/cmfrec.h:1858): continue from given factors
        if init.get("A") is not None:
            A = A.at[:m, :k].set(
                jnp.asarray(np.asarray(init["A"], np.float32)))
        if init.get("B") is not None:
            B = B.at[:n, :k].set(
                jnp.asarray(np.asarray(init["B"], np.float32)))
        if user_bias and init.get("biasA") is not None:
            A = A.at[:m, k].set(
                jnp.asarray(np.asarray(init["biasA"], np.float32)))
        if item_bias and init.get("biasB") is not None:
            B = B.at[:n, k].set(
                jnp.asarray(np.asarray(init["biasB"], np.float32)))

    def lam_row_for(lam_f, lam_bias, has_bias, cnt, count_avg):
        v = np.ones(Kp, np.float32)
        v[:k] = lam_f
        v[k] = lam_bias if has_bias else 1.0
        vec = jnp.asarray(v)
        if not scale_lam:
            return vec[None, :]
        lam_row = vec[None, :] * jnp.maximum(cnt, 1.0)[:, None]
        if scale_bias_const and has_bias:
            lam_row = lam_row.at[:, k].set(lam_bias * count_avg)
        return lam_row

    count_avg_A = count_avg_B = 1.0
    if scale_lam:
        tot = float(np.sum(weights)) if weighted else float(len(flat))
        count_avg_A = tot / max(m, 1)
        count_avg_B = tot / max(n, 1)
    # dense side info adds p (resp. q) observations per row when
    # scale_lam_sideinfo is on (common.c:689-724)
    cnt_lam_A = cnt_A + (float(U_dense.shape[1])
                         if scale_lam_sideinfo and has_U else 0.0)
    cnt_lam_B = cnt_B + (float(I_dense.shape[1])
                         if scale_lam_sideinfo and has_I else 0.0)
    lam_row_A = lam_row_for(lam6[2], lam6[0], user_bias, cnt_lam_A,
                            count_avg_A)
    lam_row_B = lam_row_for(lam6[3], lam6[1], item_bias, cnt_lam_B,
                            count_avg_B)

    # Implicit-features (Xones) half-steps: the bucketed path's scale_lam
    # multiplier for these NA0 plans is the full opposing length (als.py
    # _lam_multiplier, mode "na0"), shared across rows, and lambda is
    # divided by w_implicit so the unweighted shared-Gram solve lands on
    # the reference's weighted system (collective.c:8479/8520).
    lam_ai = jnp.full((k,), np.float32(
        lam6[2] / w_implicit * (float(n) if scale_lam else 1.0)))
    lam_bi = jnp.full((k,), np.float32(
        lam6[3] / w_implicit * (float(m) if scale_lam else 1.0)))
    w_imp = jnp.float32(w_implicit)
    # Ai/Bi carry: overwritten from the pre-update main factors at the top
    # of every iteration, so the initial value only seeds dead shapes.
    Ai = jnp.zeros((m_pad, k), jnp.float32)
    Bi = jnp.zeros((n_pad, k), jnp.float32)

    statics = dict(k=k, user_bias=user_bias, item_bias=item_bias, mesh=mesh,
                   has_U=has_U, has_I=has_I, has_impl=has_impl)
    args = (X, W, XT, WT, Ud, Id, lam_row_A, lam_row_B, live_A, live_B, mu,
            jnp.float32(lam6[4]), jnp.float32(lam6[5]),
            jnp.float32(w_user), jnp.float32(w_item),
            lam_ai, lam_bi, w_imp)

    if exact:
        # whole-trajectory f32 converged solves (see fit_explicit_dense_pallas)
        bulk_steps = final_steps = _exact_cap(k + 1)
        bulk_dyn = True
        bulk_compute = "f32"
        do_final = False
    else:
        bulk_steps, final_steps = max_cg_steps, finalize_steps
        bulk_dyn = False
        bulk_compute = "bf16"
        do_final = finalize_chol
    try:
        n_bulk = niter - 1 if do_final else niter
        C = D = None
        if n_bulk > 0:
            A, B, C, D, Ai, Bi = _run_collective_iterations(
                A, B, Ai, Bi, *args, n_iters=n_bulk, n_steps=bulk_steps,
                compute=bulk_compute, dyn_stop=bulk_dyn, **statics)
        if do_final and niter > 0:
            A, B, C, D, Ai, Bi = _run_collective_iterations(
                A, B, Ai, Bi, *args, n_iters=1, n_steps=final_steps,
                compute="f32", dyn_stop=bulk_dyn, **statics)
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    if C is None and has_U:
        C = _solve_side_factor(A[:, :k], Ud, jnp.float32(w_user),
                               jnp.float32(lam6[4]), k)
    if D is None and has_I:
        D = _solve_side_factor(B[:, :k], Id, jnp.float32(w_item),
                               jnp.float32(lam6[5]), k)

    dtype = jnp.dtype(dtype)
    return {
        "A": A[:m, :k].astype(dtype),
        "B": B[:n, :k].astype(dtype),
        "biasA": A[:m, k].astype(dtype) if user_bias else None,
        "biasB": B[:n, k].astype(dtype) if item_bias else None,
        "C": None if C is None else C.astype(dtype),
        "D": None if D is None else D.astype(dtype),
        "Ai": Ai[:m].astype(dtype) if has_impl else None,
        "Bi": Bi[:n].astype(dtype) if has_impl else None,
        "glob_mean": float(glob_mean),
        "k": k,
    }


# --------------------------------------------------------------------- #
# implicit WRMF on the fused dense engine                                #
# --------------------------------------------------------------------- #


@partial(jax.jit, static_argnames=("m_pad", "n_pad"))
def _setup_implicit(flat_idx, av, m_pad, n_pad):
    """Scatter confidence terms: Wx = alpha*x (Gram coefficients), Xp =
    1 + alpha*x (rhs coefficients), mask — both orientations."""
    Wx = (jnp.zeros(m_pad * n_pad, jnp.bfloat16)
          .at[flat_idx].set(av.astype(jnp.bfloat16)).reshape(m_pad, n_pad))
    Xp = (jnp.zeros(m_pad * n_pad, jnp.bfloat16)
          .at[flat_idx].set((1.0 + av).astype(jnp.bfloat16))
          .reshape(m_pad, n_pad))
    M = (jnp.zeros(m_pad * n_pad, jnp.int8)
         .at[flat_idx].set(1).reshape(m_pad, n_pad))
    cnt_A = jnp.sum(M, axis=1, dtype=jnp.float32)
    cnt_B = jnp.sum(M, axis=0, dtype=jnp.float32)
    return Wx, Xp, M, Wx.T, Xp.T, M.T, cnt_A, cnt_B


def _half_step_implicit(P, Wx, Xp, M, Be, live, live_opp, lam_vec, w_mult,
                        *, n_steps, compute_dtype, mesh, dyn_stop=False):
    """WRMF half-step: (w(B^T B + sum_obs alpha*x bb^T) + lam) a =
    w * sum_obs (1+alpha*x) b  (/root/reference/src/common.c:1914)."""
    hp = jax.lax.Precision.HIGHEST
    Bl = jnp.where(live_opp[:, None], Be, 0.0)
    Bek = Bl.astype(compute_dtype)
    G0 = jnp.einsum("sk,sl->kl", Bl, Bl, precision=hp)
    zero_mb = jnp.zeros(Bl.shape[0], jnp.float32)
    rhs = w_mult * masked_rhs(Xp, M, zero_mb, Bek, mesh=mesh)

    def matvec(v):
        mv = masked_gram_matvec(v.astype(compute_dtype), Bek, Wx, mesh=mesh)
        mv = mv + jnp.einsum("km,rm->rk", G0, v, precision=hp)
        return w_mult * mv + v * lam_vec[None, :]

    a = _cg(P, rhs, matvec, n_steps, dyn_stop=dyn_stop)
    return jnp.where(live[:, None], a, 0.0)


@partial(
    jax.jit,
    static_argnames=("k", "n_steps", "compute", "mesh", "n_iters",
                     "dyn_stop"),
)
def _run_implicit_iterations(
    A, B, Wx, Xp, M, WxT, XpT, MT, lam_vec_A, lam_vec_B, live_A, live_B,
    w_mult,
    *, n_iters, k, n_steps, compute, mesh=None, dyn_stop=False,
):
    cdt = jnp.bfloat16 if compute == "bf16" else jnp.float32

    def body(carry, _):
        A, B = carry
        # Reference order: B before A (collective.c:9927 / :9981).
        B = _half_step_implicit(
            B, WxT, XpT, MT, A, live_B, live_A, lam_vec_B, w_mult,
            n_steps=n_steps, compute_dtype=cdt, mesh=mesh, dyn_stop=dyn_stop)
        A = _half_step_implicit(
            A, Wx, Xp, M, B, live_A, live_B, lam_vec_A, w_mult,
            n_steps=n_steps, compute_dtype=cdt, mesh=mesh, dyn_stop=dyn_stop)
        return (A, B), None

    (A, B), _ = jax.lax.scan(body, (A, B), None, length=n_iters)
    return A, B


def fit_implicit_dense_pallas(
    rows, cols, vals, m, n, *, k, lam6, niter, max_cg_steps, finalize_steps,
    finalize_chol, alpha, w_main_multiplier, dtype, seed, verbose,
    mesh=None, init=None, ckpt=None, exact=False,
) -> dict:
    """WRMF on the fused masked kernels (dense confidence form); same
    systems as the bucketed implicit path (optimizeA_implicit,
    /root/reference/src/common.c:3305).  exact=True (use_cg=False) runs
    each half-step's CG to the per-row 1e-8 freeze under the Krylov cap —
    Cholesky-quality solutions at masked-matvec cost."""
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    m_pad = pad_dim(m, row_mult=n_dev)
    n_pad = pad_dim(n, row_mult=n_dev)
    Kp = pad_k(k)

    flat, av, _ = _ship_interactions(rows, cols, vals, None, n_pad,
                                     scale=float(alpha))
    Wx, Xp, M, WxT, XpT, MT, cnt_A, cnt_B = _setup_implicit(
        flat, av, m_pad, n_pad)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        rs = NamedSharding(mesh, _P("d"))
        Wx, Xp, M = (jax.device_put(x, rs) for x in (Wx, Xp, M))
        WxT, XpT, MT = (jax.device_put(x, rs) for x in (WxT, XpT, MT))
    live_A = cnt_A > 0
    live_B = cnt_B > 0

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    zeros_m = jnp.zeros(m_pad, jnp.float32)
    zeros_n = jnp.zeros(n_pad, jnp.float32)
    A = _init_factors(k1, live_A, zeros_m, (m_pad, Kp), k, False)
    B = _init_factors(k2, live_B, zeros_n, (n_pad, Kp), k, False)
    if init is not None:
        if init.get("A") is not None:
            A = A.at[:m, :k].set(
                jnp.asarray(np.asarray(init["A"], np.float32)))
        if init.get("B") is not None:
            B = B.at[:n, :k].set(
                jnp.asarray(np.asarray(init["B"], np.float32)))

    def lam_vec_for(lam_f):
        v = np.ones(Kp, np.float32)
        v[:k] = lam_f
        return jnp.asarray(v)

    lam_vec_A = lam_vec_for(lam6[2])
    lam_vec_B = lam_vec_for(lam6[3])
    w_mult = jnp.float32(w_main_multiplier)

    statics = dict(k=k, mesh=mesh)
    args = (Wx, Xp, M, WxT, XpT, MT, lam_vec_A, lam_vec_B, live_A, live_B,
            w_mult)

    def _state():
        # checkpoint layout == return layout (1:1 with init=)
        dt = jnp.dtype(dtype)
        return {"A": A[:m, :k].astype(dt), "B": B[:n, :k].astype(dt)}

    checkpointing = ckpt is not None and ckpt.every > 0
    if exact:
        # whole-trajectory f32 converged solves (see fit_explicit_dense_pallas)
        bulk_steps = final_steps = _exact_cap(k)
        bulk_dyn = True
        bulk_compute = "f32"
        do_final = False
    else:
        bulk_steps, final_steps = max_cg_steps, finalize_steps
        bulk_dyn = False
        bulk_compute = "bf16"
        do_final = finalize_chol
    try:
        n_bulk = niter - 1 if do_final else niter
        if checkpointing:
            # chunked dispatch: one dispatch per checkpoint interval
            it = 0
            while it < n_bulk:
                n_now = min(ckpt.every, n_bulk - it)
                A, B = _run_implicit_iterations(
                    A, B, *args, n_iters=n_now, n_steps=bulk_steps,
                    compute=bulk_compute, dyn_stop=bulk_dyn, **statics)
                it += n_now
                ckpt.maybe_save(it, _state)
            if do_final and niter > 0:
                A, B = _run_implicit_iterations(
                    A, B, *args, n_iters=1, n_steps=final_steps,
                    compute="f32", dyn_stop=bulk_dyn, **statics)
        else:
            if n_bulk > 0:
                A, B = _run_implicit_iterations(
                    A, B, *args, n_iters=n_bulk, n_steps=bulk_steps,
                    compute=bulk_compute, dyn_stop=bulk_dyn, **statics)
            if do_final and niter > 0:
                A, B = _run_implicit_iterations(
                    A, B, *args, n_iters=1, n_steps=final_steps,
                    compute="f32", dyn_stop=bulk_dyn, **statics)
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    out = _state()
    out.update({"biasA": None, "biasB": None, "glob_mean": 0.0, "k": k,
                "w_main_multiplier": float(w_main_multiplier),
                "alpha": alpha})
    return out


@partial(
    jax.jit,
    static_argnames=("k", "n_steps", "compute", "mesh", "n_iters", "has_U",
                     "has_I", "dyn_stop"),
)
def _run_collective_implicit_iterations(
    A, B, Wx, Xp, M, WxT, XpT, MT, Ud, Id, lam_vec_A, lam_vec_B,
    live_A, live_B, w_mult, lamC, lamD, w_user, w_item,
    *, n_iters, k, n_steps, compute, mesh=None, has_U=False, has_I=False,
    dyn_stop=False,
):
    """Collective WRMF iterations on the fused engine: the implicit
    confidence system plus dense side-info terms (w_u CtC Gram + w_u U@C
    rhs), C/D solved whole-matrix (optimizeA_collective_implicit,
    /root/reference/src/collective.c:5971)."""
    cdt = jnp.bfloat16 if compute == "bf16" else jnp.float32
    hp = jax.lax.Precision.HIGHEST
    Kp = A.shape[1]

    def half(P, Wx_, Xp_, M_, Be, live, live_opp, lam_vec, C, Sd, w_side):
        Bl = jnp.where(live_opp[:, None], Be, 0.0)
        Bek = Bl.astype(cdt)
        G0 = jnp.einsum("sk,sl->kl", Bl, Bl, precision=hp) * w_mult
        R0 = None
        if C is not None:
            G0 = G0 + w_side * (
                jnp.zeros((Kp, Kp), jnp.float32).at[:k, :k].set(
                    jnp.einsum("pk,pl->kl", C, C, precision=hp)))
            R0 = jnp.zeros((P.shape[0], Kp), jnp.float32).at[:, :k].set(
                w_side * jnp.einsum("mp,pk->mk", Sd, C, precision=hp))
        zero_mb = jnp.zeros(Bl.shape[0], jnp.float32)
        rhs = w_mult * masked_rhs(Xp_, M_, zero_mb, Bek, mesh=mesh)
        if R0 is not None:
            rhs = rhs + R0

        def matvec(v):
            mv = w_mult * masked_gram_matvec(v.astype(cdt), Bek, Wx_,
                                             mesh=mesh)
            mv = mv + jnp.einsum("km,rm->rk", G0, v, precision=hp)
            return mv + v * lam_vec[None, :]

        a = _cg(P, rhs, matvec, n_steps, dyn_stop=dyn_stop)
        return jnp.where(live[:, None], a, 0.0)

    def body(carry, _):
        A, B, C, D = carry
        if has_U:
            C = _solve_side_factor(A[:, :k], Ud, w_user, lamC, k)
        if has_I:
            D = _solve_side_factor(B[:, :k], Id, w_item, lamD, k)
        # Reference half-step order: C, D, then B before A
        # (collective.c:9927 "Optimize B" -> :9981 "Optimize A"), matching
        # the bucketed collective-implicit path and the plain-implicit
        # fused engine.  C/D ride the carry so the RETURNED side factors
        # are the last-optimized ones (from the final iteration's
        # start-of-iteration A/B), as the reference stores them.
        B = half(B, WxT, XpT, MT, A, live_B, live_A, lam_vec_B,
                 D if has_I else None, Id, w_item)
        A = half(A, Wx, Xp, M, B, live_A, live_B, lam_vec_A,
                 C if has_U else None, Ud, w_user)
        return (A, B, C, D), None

    C0 = jnp.zeros((Ud.shape[1] if has_U else 0, k), jnp.float32)
    D0 = jnp.zeros((Id.shape[1] if has_I else 0, k), jnp.float32)
    (A, B, C, D), _ = jax.lax.scan(body, (A, B, C0, D0), None,
                                   length=n_iters)
    return A, B, C if has_U else None, D if has_I else None


def fit_collective_implicit_dense_pallas(
    rows, cols, vals, m, n, *, U_dense, I_dense, k, lam6, w_user, w_item,
    niter, max_cg_steps, finalize_steps, finalize_chol, alpha,
    w_main_multiplier, dtype, seed, verbose, mesh=None, init=None,
    exact=False,
) -> dict:
    """Collective WRMF with fully-dense side info on the fused engine
    (k_user = k_item = k_main = 0).  exact=True (use_cg=False) runs each
    half-step's CG to the per-row 1e-8 freeze under the Krylov cap."""
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    m_pad = pad_dim(m, row_mult=n_dev)
    n_pad = pad_dim(n, row_mult=n_dev)
    Kp = pad_k(k)

    flat, av, _ = _ship_interactions(rows, cols, vals, None, n_pad,
                                     scale=float(alpha))
    Wx, Xp, M, WxT, XpT, MT, cnt_A, cnt_B = _setup_implicit(
        flat, av, m_pad, n_pad)

    has_U = U_dense is not None
    has_I = I_dense is not None
    Ud = Id = jnp.zeros(0, jnp.float32)
    if has_U:
        Ud = jnp.asarray(
            np.pad(np.asarray(U_dense, np.float32), ((0, m_pad - m), (0, 0))))
    if has_I:
        Id = jnp.asarray(
            np.pad(np.asarray(I_dense, np.float32), ((0, n_pad - n), (0, 0))))
    real_A = jnp.arange(m_pad) < m
    real_B = jnp.arange(n_pad) < n
    live_A = real_A if has_U else (cnt_A > 0)
    live_B = real_B if has_I else (cnt_B > 0)

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    A = _init_factors(k1, live_A, jnp.zeros(m_pad, jnp.float32), (m_pad, Kp),
                      k, False)
    B = _init_factors(k2, live_B, jnp.zeros(n_pad, jnp.float32), (n_pad, Kp),
                      k, False)
    if init is not None:
        if init.get("A") is not None:
            A = A.at[:m, :k].set(
                jnp.asarray(np.asarray(init["A"], np.float32)))
        if init.get("B") is not None:
            B = B.at[:n, :k].set(
                jnp.asarray(np.asarray(init["B"], np.float32)))

    def lam_vec_for(lam_f):
        v = np.ones(Kp, np.float32)
        v[:k] = lam_f
        return jnp.asarray(v)

    args = (Wx, Xp, M, WxT, XpT, MT, Ud, Id,
            lam_vec_for(lam6[2]), lam_vec_for(lam6[3]), live_A, live_B,
            jnp.float32(w_main_multiplier), jnp.float32(lam6[4]),
            jnp.float32(lam6[5]), jnp.float32(w_user), jnp.float32(w_item))
    statics = dict(k=k, mesh=mesh, has_U=has_U, has_I=has_I)
    C = D = None
    if exact:
        # whole-trajectory f32 converged solves (see fit_explicit_dense_pallas)
        bulk_steps = final_steps = _exact_cap(k)
        bulk_dyn = True
        bulk_compute = "f32"
        do_final = False
    else:
        bulk_steps, final_steps = max_cg_steps, finalize_steps
        bulk_dyn = False
        bulk_compute = "bf16"
        do_final = finalize_chol
    try:
        n_bulk = niter - 1 if do_final else niter
        if n_bulk > 0:
            A, B, C, D = _run_collective_implicit_iterations(
                A, B, *args, n_iters=n_bulk, n_steps=bulk_steps,
                compute=bulk_compute, dyn_stop=bulk_dyn, **statics)
        if do_final and niter > 0:
            A, B, C, D = _run_collective_implicit_iterations(
                A, B, *args, n_iters=1, n_steps=final_steps,
                compute="f32", dyn_stop=bulk_dyn, **statics)
    except KeyboardInterrupt:
        from ..config import should_handle_interrupt
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    if C is None and has_U:
        C = _solve_side_factor(A[:, :k], Ud, jnp.float32(w_user),
                               jnp.float32(lam6[4]), k)
    if D is None and has_I:
        D = _solve_side_factor(B[:, :k], Id, jnp.float32(w_item),
                               jnp.float32(lam6[5]), k)

    dtype = jnp.dtype(dtype)
    return {
        "A": A[:m, :k].astype(dtype),
        "B": B[:n, :k].astype(dtype),
        "C": None if C is None else C.astype(dtype),
        "D": None if D is None else D.astype(dtype),
        "biasA": None, "biasB": None, "glob_mean": 0.0, "k": k,
        "w_main_multiplier": float(w_main_multiplier),
        "alpha": alpha,
    }
