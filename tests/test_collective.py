"""Oracle tests for the collective ALS driver.

Fixed-point strategy: A is the last matrix updated in each iteration
(/root/reference/src/collective.c:8334 order C,D,Bi,Ai,B,A), so after a
Cholesky-mode fit every row of A must satisfy its exact extended-system
normal equations given the final B, C, Bi — verified against a dense NumPy
assembly of the Be block system (/root/reference/src/collective.c:179-214).
"""

import numpy as np
import pytest

from cmfrec_tpu.solvers.collective import (
    fit_collective_explicit_als,
    fit_collective_implicit_als,
)


def make_data(rng, m=50, n=35, p=8, q=6, k_true=3, density=0.4,
              u_density=1.0, i_density=1.0):
    A = rng.normal(size=(m, k_true))
    B = rng.normal(size=(n, k_true))
    X = 2.0 + A @ B.T + 0.1 * rng.normal(size=(m, n))
    mask = rng.uniform(size=(m, n)) < density
    rows, cols = np.nonzero(mask)
    vals = X[rows, cols]
    U = A @ rng.normal(size=(k_true, p)) + 0.1 * rng.normal(size=(m, p))
    I = B @ rng.normal(size=(k_true, q)) + 0.1 * rng.normal(size=(n, q))
    if u_density < 1.0:
        U[rng.uniform(size=U.shape) >= u_density] = np.nan
    if i_density < 1.0:
        I[rng.uniform(size=I.shape) >= i_density] = np.nan
    return rows, cols, vals, U, I, m, n


def ingest_dense(M):
    """Replicates _BaseModel._side_from_dense."""
    if np.isnan(M).any():
        r, c = np.nonzero(~np.isnan(M))
        return r, c, M[r, c], M.shape[0], M.shape[1], False, None
    return None, None, None, M.shape[0], M.shape[1], True, M


def oracle_A_row(i, rows, cols, vals, B, C, Uc, mu, biasB, lam, lam_bias,
                 k, k_user, k_item, k_main, w_main, w_user, user_bias,
                 Bi=None, w_implicit=0.5, obs_cols=None):
    """Exact extended-system solve for one row of A."""
    ka = k_user + k + k_main
    K = ka + (1 if user_bias else 0)
    G = np.zeros((K, K))
    rhs = np.zeros(K)
    sel = rows == i
    for j, x in zip(cols[sel], vals[sel]):
        be = np.zeros(K)
        be[k_user:ka] = B[j, k_item:]
        if user_bias:
            be[ka] = 1.0
        t = x - mu - (biasB[j] if biasB is not None else 0.0)
        G += w_main * np.outer(be, be)
        rhs += w_main * t * be
    if C is not None:
        for f in range(C.shape[0]):
            if np.isnan(Uc[i, f]):
                continue
            ce = np.zeros(K)
            ce[: k_user + k] = C[f]
            G += w_user * np.outer(ce, ce)
            rhs += w_user * Uc[i, f] * ce
    if Bi is not None:
        # Xones ~ A[:, k_user:] Bi^T with NA-as-zero: all n items in the Gram
        for j in range(Bi.shape[0]):
            be = np.zeros(K)
            be[k_user:ka] = Bi[j]
            G += w_implicit * np.outer(be, be)
            if obs_cols is not None and j in obs_cols:
                rhs += w_implicit * be
    lam_vec = np.full(K, lam)
    if user_bias:
        lam_vec[ka] = lam_bias
    G += np.diag(lam_vec)
    return np.linalg.solve(G, rhs)


@pytest.mark.parametrize("dense_U", [True, False])
def test_explicit_fixed_point_with_side_info(rng, dense_U):
    u_density = 1.0 if dense_U else 0.5
    rows, cols, vals, U, I, m, n = make_data(rng, u_density=u_density)
    k, k_user, k_item, k_main = 4, 1, 2, 1
    lam = 0.8
    res = fit_collective_explicit_als(
        rows, cols, vals, m, n,
        side_U=ingest_dense(U), side_I=ingest_dense(I),
        k=k, k_user=k_user, k_item=k_item, k_main=k_main,
        lambda_=lam, w_main=1.0, w_user=0.7, w_item=0.4,
        niter=4, use_cg=False, user_bias=True, item_bias=True,
        center=True, center_U=False, center_I=False,
        dtype=np.float64,
    )
    A, B, C, D = res["A"], res["B"], res["C"], res["D"]
    mu, biasA, biasB = res["glob_mean"], res["biasA"], res["biasB"]
    assert A.shape == (m, k_user + k + k_main)
    assert B.shape == (n, k_item + k + k_main)
    assert C.shape == (U.shape[1], k_user + k)
    assert D.shape == (I.shape[1], k_item + k)

    for i in [0, 3, 11]:
        want = oracle_A_row(
            i, rows, cols, vals, B, C, U, mu, biasB, lam, lam,
            k, k_user, k_item, k_main, 1.0, 0.7, True,
        )
        got = np.concatenate([A[i], [biasA[i]]])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_explicit_cg_matches_chol(rng):
    rows, cols, vals, U, I, m, n = make_data(rng)
    common = dict(
        side_U=ingest_dense(U), side_I=ingest_dense(I),
        k=4, k_user=1, k_item=0, k_main=1, lambda_=0.8,
        w_user=0.5, w_item=0.5, niter=12, user_bias=True, item_bias=True,
        dtype=np.float64,
    )
    r1 = fit_collective_explicit_als(rows, cols, vals, m, n, use_cg=False, **common)
    r2 = fit_collective_explicit_als(
        rows, cols, vals, m, n, use_cg=True, finalize_chol=True, **common
    )

    def rmse(r):
        pred = (r["glob_mean"] + r["biasA"][rows] + r["biasB"][cols]
                + np.sum(r["A"][rows, 1:] * r["B"][cols, :], axis=1))
        return np.sqrt(np.mean((pred - vals) ** 2))

    assert rmse(r1) < 0.2
    assert abs(rmse(r1) - rmse(r2)) < 0.05


def test_implicit_features_fixed_point(rng):
    """add_implicit_features: A's system gains the w_implicit * Bi^T Bi term
    and rhs contributions at observed columns."""
    rows, cols, vals, U, I, m, n = make_data(rng, density=0.3)
    k = 4
    lam = 1.0
    res = fit_collective_explicit_als(
        rows, cols, vals, m, n, side_U=None, side_I=None,
        k=k, lambda_=lam, niter=4, use_cg=False,
        user_bias=False, item_bias=False, center=False,
        add_implicit_features=True, w_implicit=0.6,
        dtype=np.float64,
    )
    A, B, Bi, Ai = res["A"], res["B"], res["Bi"], res["Ai"]
    assert Bi.shape == (n, k) and Ai.shape == (m, k)
    for i in [0, 5]:
        obs = set(cols[rows == i])
        want = oracle_A_row(
            i, rows, cols, vals, B, None, None, 0.0, None, lam, lam,
            k, 0, 0, 0, 1.0, 1.0, False, Bi=Bi, w_implicit=0.6, obs_cols=obs,
        )
        np.testing.assert_allclose(A[i], want, rtol=1e-6, atol=1e-8)


def test_implicit_collective_fixed_point(rng):
    """WRMF with dense side info: verify A's extended normal equations."""
    m, n, p = 40, 30, 6
    k, k_user = 3, 1
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.3)
    vals = rng.integers(1, 10, size=rows.size).astype(np.float64)
    U = rng.normal(size=(m, p))
    lam, alpha, w_user = 1.5, 0.7, 0.6
    res = fit_collective_implicit_als(
        rows, cols, vals, m, n,
        side_U=ingest_dense(U), side_I=None,
        k=k, k_user=k_user, lambda_=lam, alpha=alpha, w_user=w_user,
        niter=6, use_cg=False, center_U=False, dtype=np.float64,
    )
    A, B, C = res["A"], res["B"], res["C"]
    ka = k_user + k
    Uc = U
    for i in [0, 7]:
        K = ka
        G = np.zeros((K, K))
        rhs = np.zeros(K)
        # X part: BtB over all items + confidence corrections, coords [k_user:]
        Bx = np.zeros((n, K))
        Bx[:, k_user:] = B
        G += Bx.T @ Bx
        sel = rows == i
        for j, x in zip(cols[sel], vals[sel]):
            G += alpha * x * np.outer(Bx[j], Bx[j])
            rhs += (1 + alpha * x) * Bx[j]
        # U part: dense, coords [:k_user+k] == all coords here
        Ce = np.zeros((p, K))
        Ce[:, : k_user + k] = C
        G += w_user * Ce.T @ Ce
        rhs += w_user * Ce.T @ Uc[i]
        G += lam * np.eye(K)
        want = np.linalg.solve(G, rhs)
        np.testing.assert_allclose(A[i], want, rtol=1e-6, atol=1e-8)


def test_side_info_improves_cold_start(rng):
    """Side info must transfer signal: per-iteration RMSE on users with very
    few ratings should beat a no-side-info model of the same size."""
    m, n, p, k_true = 120, 60, 10, 4
    Atrue = rng.normal(size=(m, k_true))
    Btrue = rng.normal(size=(n, k_true))
    X = Atrue @ Btrue.T
    U = Atrue @ rng.normal(size=(k_true, p))  # fully informative side info
    # most users have only 2 ratings
    mask = np.zeros((m, n), bool)
    for i in range(m):
        nr = 20 if i < 20 else 2
        mask[i, rng.choice(n, nr, replace=False)] = True
    rows, cols = np.nonzero(mask)
    vals = X[rows, cols]
    test_mask = ~mask & (rng.uniform(size=(m, n)) < 0.2)
    tr_, tc_ = np.nonzero(test_mask)

    common = dict(k=4, lambda_=0.5, niter=10, use_cg=False,
                  user_bias=False, item_bias=False, center=False,
                  dtype=np.float64)
    r0 = fit_collective_explicit_als(rows, cols, vals, m, n,
                                     side_U=None, side_I=None, **common)
    r1 = fit_collective_explicit_als(rows, cols, vals, m, n,
                                     side_U=ingest_dense(U), side_I=None,
                                     w_user=2.0, center_U=False, **common)

    def rmse(r):
        pred = np.sum(r["A"][tr_, :4] * r["B"][tc_, :], axis=1)
        return np.sqrt(np.mean((pred - X[tr_, tc_]) ** 2))

    assert rmse(r1) < rmse(r0) * 0.8


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))


@pytest.mark.parametrize("implicit", [False, True])
def test_fused_iteration_matches_unfused(rng, implicit, monkeypatch):
    """CMFREC_TPU_FUSE_COLLECTIVE=1 (the GPU default: one jit per
    iteration) must reproduce the per-bucket dispatch path exactly."""
    rows, cols, vals, U, I, m, n = make_data(rng, u_density=0.6)
    side_U = ingest_dense(U)
    side_I = ingest_dense(I)
    if implicit:
        vals = np.abs(vals) + 1.0
        kw = dict(k=5, k_user=1, niter=4, use_cg=True, seed=11, alpha=2.0)
        fit = fit_collective_implicit_als
        keys = ["A", "B", "C", "D"]
    else:
        kw = dict(k=5, k_user=1, k_main=1, niter=4, use_cg=True, seed=11,
                  add_implicit_features=True)
        fit = fit_collective_explicit_als
        keys = ["A", "B", "C", "D", "biasA", "biasB", "Ai", "Bi"]
    monkeypatch.setenv("CMFREC_TPU_FUSE_COLLECTIVE", "0")
    r0 = fit(rows, cols, vals, m, n, side_U=side_U, side_I=side_I, **kw)
    monkeypatch.setenv("CMFREC_TPU_FUSE_COLLECTIVE", "1")
    r1 = fit(rows, cols, vals, m, n, side_U=side_U, side_I=side_I, **kw)
    for key in keys:
        a, b = r0.get(key), r1.get(key)
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8, err_msg=key)
