"""Dense-masked ALS engine — plain XLA products for moderate item counts.

Row gathers run far below the device's memory bandwidth, so for data
whose dense [m, n] form fits in device memory it can be faster to
materialize X (zeros at missing entries) plus a weight/mask matrix W and
run the per-row CG solves for ALL rows simultaneously as masked
whole-matrix products:

    rhs    = ((X - bias_opp) . W) @ Be                       [m, K]
    Gv(P)  = ((P @ Be^T) . W) @ Be + lam . P                 [m, K]

Three CG steps of that are six [m, n] x [n, K] matmuls.
This solves exactly the same per-row ridge systems as the bucketed sparse
engine (ops/rowsolve.py) and the reference's per-row kernels
(/root/reference/src/common.c:1098); only the schedule differs.  The same
arrays serve the B half-iteration through transposed contractions, so no
X^T copy is materialized.

Cholesky-mode updates stay on the bucketed engine (per-row Grams are
nnz*k^2 work regardless); ``finalize_chol`` therefore switches engines for
the final iteration.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SOLVER_PRECISION

# Full f32 products (Precision.HIGHEST, not TF32): this engine is the
# plain f32 reference the fused engine is checked against, and the mask
# multiply must not lose the distinction between zero and tiny weights.
_PREC = SOLVER_PRECISION


@partial(jax.jit, static_argnames=("m", "n", "w_dtype"), donate_argnums=())
def _scatter_dense(flat_idx, vals, wvals, m, n, w_dtype):
    X = jnp.zeros(m * n, vals.dtype).at[flat_idx].set(vals).reshape(m, n)
    if wvals is None:  # unweighted: build the 0/1 mask on device
        W = jnp.zeros(m * n, w_dtype).at[flat_idx].set(1.0).reshape(m, n)
    else:
        W = jnp.zeros(m * n, w_dtype).at[flat_idx].set(
            wvals.astype(w_dtype)
        ).reshape(m, n)
    return X, W


def dense_from_coo(rows, cols, vals, m, n, weights=None, dtype=np.float32):
    """Materialize (X_zeroed, W) ON DEVICE by scattering the COO triplets.

    The host->device link is far slower than device memory, so we ship
    only the nnz-sized triplet arrays and build the [m, n] dense forms
    with one device-side scatter.
    X holds centered values with 0 at missing entries; W holds observation
    weights (0 = missing)."""
    flat_h = np.asarray(rows, np.int64) * n + np.asarray(cols, np.int64)
    if m * n < np.iinfo(np.int32).max:
        flat_h = flat_h.astype(np.int32)  # halves the upload
    flat = jnp.asarray(flat_h)
    v = jnp.asarray(np.asarray(vals, dtype))
    w = None if weights is None else jnp.asarray(np.asarray(weights, dtype))
    # An unweighted mask is exactly representable in bf16 — halves residency.
    w_dtype = jnp.bfloat16 if weights is None else jnp.dtype(dtype)
    return _scatter_dense(flat, v, w, m, n, w_dtype)


def estimate_dense_bytes(m, n, itemsize=4):
    return 2 * m * n * itemsize


@partial(jax.jit, static_argnames=("n_steps", "rows_axis", "jacobi"))
def dense_cg_update(
    P,  # [R, K] warm start (R = m for the A side, n for the B side)
    X,  # [m, n] zero-filled centered values
    W,  # [m, n] weights (0 = missing)
    Be,  # [S, K] extended opposing matrix (bias column included)
    opp_bias,  # [S] or None — opposing bias to subtract from values
    lam_vec,  # [K]
    lam_mult,  # [R] or None (scale_lam)
    lam_const_vec,  # [K] or None — unscaled extra diagonal (scale_bias_const)
    n_steps: int,
    rows_axis: int,  # 0: solving X's rows (A update); 1: columns (B update)
    rel_tol: float = 1e-12,
    jacobi: bool = False,  # precondition_cg: diagonal-preconditioned PCG
):
    """Batched truncated CG over every row of one side at once."""
    dt = P.dtype

    if rows_axis == 0:
        def big(mat):  # [R, K] -> [m, n]
            return jnp.einsum("rk,sk->rs", mat, Be, precision=_PREC)

        def small(T):  # [m, n] -> [R, K]
            return jnp.einsum("rs,sk->rk", T, Be, precision=_PREC)

        V = X if opp_bias is None else X - opp_bias[None, :]
    else:
        def big(mat):  # [R, K] -> [m, n] with R == n
            return jnp.einsum("rk,sk->sr", mat, Be, precision=_PREC)

        def small(T):  # [m, n] -> [R, K]
            return jnp.einsum("sr,sk->rk", T, Be, precision=_PREC)

        V = X if opp_bias is None else X - opp_bias[:, None]

    lam_row = (
        lam_vec[None, :]
        if lam_mult is None
        else lam_vec[None, :] * jnp.maximum(lam_mult, 1.0)[:, None]
    )
    if lam_const_vec is not None:
        lam_row = lam_row + lam_const_vec[None, :]

    def matvec(Q):
        return small(big(Q) * W) + Q * lam_row

    if jacobi:
        # Jacobi diagonal: sum_s W[r,s] * Be[s,k]^2 + lam (the reference's
        # factors_explicit_pcg preconditioner, common.c:1234).
        Be2 = Be * Be
        if rows_axis == 0:
            diag = jnp.einsum("rs,sk->rk", W, Be2, precision=_PREC)
        else:
            diag = jnp.einsum("sr,sk->rk", W, Be2, precision=_PREC)
        diag = diag + lam_row
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0),
                             1.0)
    else:
        inv_diag = None

    def precond(r):
        return r if inv_diag is None else r * inv_diag

    rhs = small(V * W)
    r = rhs - matvec(P)
    z = precond(r)
    rs0 = jnp.sum(r * z, axis=-1)
    # Two-tolerance stopping, matching the reference exactly
    # (/root/reference/src/common.c:1147,1181): skip rows already below
    # 1e-12, and stop a row once its post-step residual falls below 1e-8.
    # The reference's PCG (factors_explicit_pcg, common.c:1198) has NO
    # stopping tests — under jacobi every row runs all n_steps.
    live0 = (jnp.ones(rs0.shape, bool) if jacobi
             else rs0 > jnp.asarray(rel_tol, dt))

    def body(carry, _):
        a, r, p, rs, live = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap, axis=-1)
        alpha = jnp.where(live, rs / jnp.where(denom == 0, 1, denom), 0.0)
        a = a + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond(r)
        rs_new = jnp.sum(r * z, axis=-1)
        if not jacobi:
            live = live & (rs_new > 1e-8)
        beta = jnp.where(live, rs_new / jnp.where(rs == 0, 1, rs), 0.0)
        p = jnp.where(live[:, None], z + beta[:, None] * p, p)
        return (a, r, p, jnp.where(live, rs_new, rs), live), None

    (a, _, _, _, _), _ = jax.lax.scan(
        body, (P, r, z, rs0, live0), None, length=n_steps)
    # rows with no observations solve to zero (reference zero_out)
    live_rows = jnp.sum(W.astype(jnp.float32), axis=1 - rows_axis) > 0
    return jnp.where(live_rows[:, None], a, 0.0)
