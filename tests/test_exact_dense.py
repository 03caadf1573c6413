"""Exact mode on the fused dense engines: use_cg=False fits run each
half-step's CG to the per-row 1e-8 freeze under the Krylov step cap
(system dim + 1), with a global all-frozen early exit (lax.while_loop).
These tests pin (a) the while-loop form against the static scan form,
(b) exact-mode solutions against the bucketed per-row Cholesky engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest



@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_cg_dyn_stop_equals_scan(rng):
    """dyn_stop=True is the scan result with the wasted steps removed:
    identical output (frozen rows are exact no-ops in the scan form)."""
    from cmfrec_tpu.solvers.dense_pallas import _cg

    R, K = 64, 8
    M = rng.normal(size=(R, K, K))
    G = np.einsum("rik,rjk->rij", M, M) + 2.0 * np.eye(K)
    rhs = jnp.asarray(rng.normal(size=(R, K)), jnp.float32)
    Gd = jnp.asarray(G, jnp.float32)

    def matvec(v):
        return jnp.einsum("rij,rj->ri", Gd, v)

    P0 = jnp.zeros((R, K), jnp.float32)
    a_scan = _cg(P0, rhs, matvec, K + 1, dyn_stop=False)
    a_dyn = _cg(P0, rhs, matvec, K + 1, dyn_stop=True)
    np.testing.assert_array_equal(np.asarray(a_scan), np.asarray(a_dyn))
    # and both solve the systems
    ref = np.linalg.solve(G, np.asarray(rhs, np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(a_dyn, np.float64), ref,
                               rtol=0, atol=1e-4)


def test_explicit_exact_one_iter_matches_bucketed_chol(rng):
    """One controlled iteration from a shared init: exact mode must land
    on the bucketed engine's per-row Cholesky solutions (same systems,
    CG run to convergence) — tolerance is solver-noise, not CG-stop
    noise."""
    from cmfrec_tpu.solvers import drivers
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas

    m, n, k = 48, 32, 5
    mask = rng.uniform(size=(m, n)) < 0.5
    ro, co = np.nonzero(mask)
    # half-point grid: exact in the engine's bf16 X storage
    vals = np.round(2 * (rng.normal(size=ro.size) + 3.0)) / 2
    A0 = rng.normal(size=(m, k)).astype(np.float32)
    B0 = rng.normal(size=(n, k)).astype(np.float32)

    rb = drivers.fit_explicit_als(
        ro, co, vals, m, n, k=k, lambda_=0.5, niter=1, use_cg=False,
        engine="sparse", user_bias=False, item_bias=False, center=False,
        init=dict(A=A0, B=B0))
    rp = fit_explicit_dense_pallas(
        ro, co, vals, m, n, weights=None, k=k, lam6=np.full(6, 0.5),
        niter=1, max_cg_steps=3, finalize_chol=True, finalize_steps=5,
        user_bias=False, item_bias=False, glob_mean=0.0, scale_lam=False,
        scale_bias_const=False, biasA0=None, biasB0=None,
        dtype=np.float32, seed=3, verbose=False,
        init=dict(A=A0, B=B0), exact=True)
    np.testing.assert_allclose(np.asarray(rp["B"], np.float64),
                               np.asarray(rb["B"], np.float64),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(rp["A"], np.float64),
                               np.asarray(rb["A"], np.float64),
                               rtol=0, atol=2e-4)


def test_explicit_exact_weighted_scale_lam(rng):
    """Exact mode with weights + scale_lam + biases (the als_chol bench
    hyperparameters): one iteration from a shared init matches the
    bucketed Cholesky path."""
    from cmfrec_tpu.solvers import drivers
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas
    from cmfrec_tpu.solvers.preprocess import initialize_biases

    m, n, k = 40, 28, 4
    mask = rng.uniform(size=(m, n)) < 0.6
    ro, co = np.nonzero(mask)
    vals = np.round(2 * (rng.normal(size=ro.size) + 3.0)) / 2  # bf16-exact
    wts = np.round(rng.uniform(0.5, 2.0, size=ro.size) * 8) / 8
    A0 = rng.normal(size=(m, k)).astype(np.float32)
    B0 = rng.normal(size=(n, k)).astype(np.float32)
    mu = float(np.average(vals, weights=wts))
    bA, bB = initialize_biases(
        ro, co, (vals - mu).astype(np.float32), m, n, lam_user=0.1,
        lam_item=0.1, wgt=wts, user_bias=True, item_bias=True,
        scale_lam=True, nonneg=False)

    rb = drivers.fit_explicit_als(
        ro, co, vals, m, n, k=k, lambda_=0.1, niter=1, use_cg=False,
        engine="sparse", user_bias=True, item_bias=True, center=True,
        scale_lam=True, weights=wts, init=dict(A=A0, B=B0, biasA=bA,
                                               biasB=bB))
    rp = fit_explicit_dense_pallas(
        ro, co, vals, m, n, weights=wts, k=k, lam6=np.full(6, 0.1),
        niter=1, max_cg_steps=3, finalize_chol=True, finalize_steps=5,
        user_bias=True, item_bias=True, glob_mean=mu, scale_lam=True,
        scale_bias_const=False, biasA0=None, biasB0=None,
        dtype=np.float32, seed=3, verbose=False,
        init=dict(A=A0, B=B0, biasA=bA, biasB=bB), exact=True)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_allclose(np.asarray(rp[key], np.float64),
                                   np.asarray(rb[key], np.float64),
                                   rtol=0, atol=5e-4, err_msg=key)


def test_collective_exact_one_iter_matches_bucketed_chol(rng):
    """Collective exact mode (implicit features, the chol_implicit_feat
    bench config): one controlled iteration from shared inits equals the
    bucketed Cholesky path to solver noise."""
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als
    from cmfrec_tpu.solvers.dense_pallas import fit_collective_dense_pallas

    m, n, k = 30, 20, 3
    mask = rng.uniform(size=(m, n)) < 0.6
    ro, co = np.nonzero(mask)
    # half-point grid: exact in the engine's bf16 X storage
    vals = np.round(2 * (rng.normal(size=ro.size) + 3.0)) / 2
    A0 = rng.normal(size=(m, k)).astype(np.float32)
    B0 = rng.normal(size=(n, k)).astype(np.float32)

    kw = dict(k=k, niter=1, user_bias=False, item_bias=False,
              dtype=np.float32, seed=5)
    res_b = fit_collective_explicit_als(
        ro, co, vals, m, n, lambda_=0.5, use_cg=False, finalize_chol=True,
        center=False, add_implicit_features=True, w_implicit=0.5,
        init=dict(A=A0, B=B0), **kw)
    res_p = fit_collective_dense_pallas(
        ro, co, vals, m, n, U_dense=None, I_dense=None, weights=None,
        lam6=np.full(6, 0.5), w_user=1.0, w_item=1.0, max_cg_steps=3,
        finalize_chol=True, finalize_steps=5, glob_mean=0.0,
        scale_lam=False, scale_bias_const=False, verbose=False,
        add_implicit_features=True, w_implicit=0.5,
        init=dict(A=A0, B=B0), exact=True, **kw)
    for key, tol in (("Bi", 1e-5), ("Ai", 1e-5), ("B", 2e-4), ("A", 2e-4)):
        b = np.asarray(res_b[key], np.float64)[:, :k]
        p = np.asarray(res_p[key], np.float64)[:, :k]
        np.testing.assert_allclose(p, b, rtol=0, atol=tol, err_msg=key)


def test_implicit_exact_one_iter_matches_bucketed_chol(rng):
    """WRMF exact mode: one iteration from a common init equals the
    bucketed implicit Cholesky half-steps."""
    from cmfrec_tpu.solvers import drivers
    from cmfrec_tpu.solvers.dense_pallas import fit_implicit_dense_pallas

    m, n, k = 72, 48, 4
    rows = rng.integers(0, m, 900)
    cols = rng.integers(0, n, 900)
    pairs = np.unique(rows * n + cols)  # the dense scatter dedupes; match it
    rows, cols = pairs // n, pairs % n
    vals = rng.integers(1, 17, rows.size).astype(np.float64)
    A0 = 0.3 * rng.normal(size=(m, k)).astype(np.float32)
    B0 = 0.3 * rng.normal(size=(n, k)).astype(np.float32)
    init = dict(A=A0, B=B0)
    rb = drivers.fit_implicit_als(rows, cols, vals, m, n, k=k, lambda_=2.0,
                                  alpha=0.5, niter=1, use_cg=False,
                                  init=init)
    rp = fit_implicit_dense_pallas(
        rows, cols, vals, m, n, k=k, lam6=np.full(6, 2.0), niter=1,
        max_cg_steps=3, finalize_steps=5, finalize_chol=False, alpha=0.5,
        w_main_multiplier=1.0, dtype=np.float32, seed=1, verbose=False,
        init=init, exact=True)
    np.testing.assert_allclose(np.asarray(rp["A"]), np.asarray(rb["A"]),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(rp["B"]), np.asarray(rb["B"]),
                               rtol=0, atol=2e-4)


def _collective_implicit_pair(rng):
    """Shared problem for the collective-implicit fused-vs-bucketed pins:
    every row and column observed (degree-0 rows are handled differently
    by design — the fused engine zeroes them, the bucketed keeps init)."""
    m, n, k, p = 40, 28, 4, 5
    rows = rng.integers(0, m, 600)
    cols = rng.integers(0, n, 600)
    rows = np.concatenate([rows, np.arange(m), (np.arange(n) % m)])
    cols = np.concatenate([cols, np.arange(m) % n, np.arange(n)])
    pairs = np.unique(rows * n + cols)  # dense scatter dedupes; match it
    rows, cols = pairs // n, pairs % n
    vals = rng.integers(1, 17, rows.size).astype(np.float64)
    U = rng.normal(size=(m, p)).astype(np.float32)
    A0 = 0.3 * rng.normal(size=(m, k)).astype(np.float32)
    B0 = 0.3 * rng.normal(size=(n, k)).astype(np.float32)
    return m, n, k, rows, cols, vals, U, A0, B0


def test_collective_implicit_exact_one_iter_matches_bucketed_chol(rng):
    """Collective-implicit exact mode (use_cg=False on the fused engine):
    one controlled iteration from shared inits equals the bucketed
    per-row Cholesky path — pins BOTH the exact solves and the reference
    half-step order (B before A, collective.c:9927 -> :9981)."""
    from cmfrec_tpu.solvers.collective import fit_collective_implicit_als
    from cmfrec_tpu.solvers.dense_pallas import (
        fit_collective_implicit_dense_pallas,
    )

    m, n, k, rows, cols, vals, U, A0, B0 = _collective_implicit_pair(rng)
    lam, wu, alpha = 2.0, 0.7, 0.5
    res_b = fit_collective_implicit_als(
        rows, cols, vals, m, n,
        side_U=(None, None, None, m, U.shape[1], True, U),
        k=k, lambda_=lam, w_user=wu,
        alpha=alpha, niter=1, use_cg=False, center_U=False,
        dtype=np.float32, seed=5, init=dict(A=A0, B=B0))
    res_p = fit_collective_implicit_dense_pallas(
        rows, cols, vals, m, n, U_dense=U, I_dense=None, k=k,
        lam6=np.full(6, lam), w_user=wu, w_item=1.0, niter=1,
        max_cg_steps=3, finalize_steps=5, finalize_chol=False, alpha=alpha,
        w_main_multiplier=1.0, dtype=np.float32, seed=1, verbose=False,
        init=dict(A=A0, B=B0), exact=True)
    for key, tol in (("C", 1e-4), ("B", 2e-4), ("A", 2e-4)):
        b = np.asarray(res_b[key], np.float64)[:, :k]
        p = np.asarray(res_p[key], np.float64)[:, :k]
        np.testing.assert_allclose(p, b, rtol=0, atol=tol, err_msg=key)


def test_collective_implicit_cg_one_iter_matches_bucketed_cg(rng):
    """Collective-implicit CG mode: one f32 3-step-CG iteration from
    shared inits follows the bucketed CG trajectory (tolerance =
    CG-stop noise) — the half-step-order pin for the default CG path."""
    from cmfrec_tpu.solvers.collective import fit_collective_implicit_als
    from cmfrec_tpu.solvers.dense_pallas import (
        fit_collective_implicit_dense_pallas,
    )

    m, n, k, rows, cols, vals, U, A0, B0 = _collective_implicit_pair(rng)
    lam, wu, alpha = 2.0, 0.7, 0.5
    res_b = fit_collective_implicit_als(
        rows, cols, vals, m, n,
        side_U=(None, None, None, m, U.shape[1], True, U),
        k=k, lambda_=lam, w_user=wu,
        alpha=alpha, niter=1, use_cg=True, max_cg_steps=3,
        finalize_chol=False, center_U=False, dtype=np.float32, seed=5,
        init=dict(A=A0, B=B0))
    # niter=1 + finalize_chol=True runs the single iteration in f32 with
    # exactly finalize_steps CG steps (no bf16 bulk) — same math as the
    # bucketed 3-step CG when no row hits the early-stop tolerances
    res_p = fit_collective_implicit_dense_pallas(
        rows, cols, vals, m, n, U_dense=U, I_dense=None, k=k,
        lam6=np.full(6, lam), w_user=wu, w_item=1.0, niter=1,
        max_cg_steps=3, finalize_steps=3, finalize_chol=True, alpha=alpha,
        w_main_multiplier=1.0, dtype=np.float32, seed=1, verbose=False,
        init=dict(A=A0, B=B0), exact=False)
    for key, tol in (("C", 1e-4), ("B", 5e-4), ("A", 5e-4)):
        b = np.asarray(res_b[key], np.float64)[:, :k]
        p = np.asarray(res_p[key], np.float64)[:, :k]
        np.testing.assert_allclose(p, b, rtol=0, atol=tol, err_msg=key)


@pytest.mark.slow
def test_explicit_exact_multi_iter_quality(rng):
    """Free-running exact-mode fit (bf16 bulk + f32 final, like the GPU
    path) reaches the bucketed Cholesky engine's quality."""
    from cmfrec_tpu.solvers import drivers
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas
    from cmfrec_tpu.solvers.preprocess import initialize_biases

    m, n, k = 64, 48, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    mask = rng.uniform(size=(m, n)) < 0.5
    ro, co = np.nonzero(mask)
    # 1/8 grid: exact in the engine's bf16 X storage
    vals = np.round(8 * ((A0 @ B0.T)[ro, co] + 3.0
                         + 0.05 * rng.normal(size=ro.size))) / 8
    mu = float(vals.mean())
    bA, bB = initialize_biases(
        ro, co, (vals - mu).astype(np.float32), m, n, lam_user=0.5,
        lam_item=0.5, wgt=None, user_bias=True, item_bias=True,
        scale_lam=False, nonneg=False)

    # common starting point: with exact solves both engines follow the
    # same deterministic trajectory (random inits differ per engine and
    # land on different finite-iteration points at this tiny scale)
    Ai0 = rng.normal(size=(m, k)).astype(np.float32) * 0.5
    Bi0 = rng.normal(size=(n, k)).astype(np.float32) * 0.5
    init = dict(A=Ai0, B=Bi0, biasA=bA, biasB=bB)
    rb = drivers.fit_explicit_als(
        ro, co, vals, m, n, k=k, lambda_=0.5, niter=12, use_cg=False,
        engine="sparse", user_bias=True, item_bias=True, center=True,
        init=init)
    rp = fit_explicit_dense_pallas(
        ro, co, vals, m, n, weights=None, k=k, lam6=np.full(6, 0.5),
        niter=12, max_cg_steps=3, finalize_chol=True, finalize_steps=5,
        user_bias=True, item_bias=True, glob_mean=mu, scale_lam=False,
        scale_bias_const=False, biasA0=bA, biasB0=bB,
        dtype=np.float32, seed=3, verbose=False,
        init=init, exact=True)

    def pred(res):
        return (res["glob_mean"] + np.asarray(res["biasA"])[ro]
                + np.asarray(res["biasB"])[co]
                + np.einsum("ek,ek->e", np.asarray(res["A"])[ro],
                            np.asarray(res["B"])[co]))

    rmse_b = np.sqrt(np.mean((pred(rb) - vals) ** 2))
    rmse_p = np.sqrt(np.mean((pred(rp) - vals) ** 2))
    assert abs(rmse_p - rmse_b) < 2e-3, (rmse_p, rmse_b)


def test_collective_side_info_one_iter_pins_C_and_D(rng):
    """Fused collective-explicit with dense side info, one controlled
    iteration from shared inits: A/B AND the returned C/D equal the
    bucketed path's — pinning that C/D are the side factors computed at
    the final iteration's START (from the pre-update A/B, the
    reference's stored values, collective.c:8345/8396) and NOT a
    recompute against the post-update factors."""
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als
    from cmfrec_tpu.solvers.dense_pallas import fit_collective_dense_pallas

    m, n, k, p, q = 34, 22, 3, 5, 4
    mask = rng.uniform(size=(m, n)) < 0.6
    ro, co = np.nonzero(mask)
    vals = np.round(2 * (rng.normal(size=ro.size) + 3.0)) / 2
    U = rng.normal(size=(m, p))
    I = rng.normal(size=(n, q))
    A0 = rng.normal(size=(m, k)).astype(np.float32)
    B0 = rng.normal(size=(n, k)).astype(np.float32)

    kw = dict(k=k, niter=1, user_bias=False, item_bias=False,
              dtype=np.float32, seed=5)
    res_b = fit_collective_explicit_als(
        ro, co, vals, m, n, lambda_=0.5, use_cg=False, finalize_chol=True,
        center=False, w_user=0.8, w_item=0.7,
        side_U=(None, None, None, m, p, True, U),
        side_I=(None, None, None, n, q, True, I),
        center_U=False, center_I=False,
        init=dict(A=A0, B=B0), **kw)
    res_p = fit_collective_dense_pallas(
        ro, co, vals, m, n, U_dense=U, I_dense=I, weights=None,
        lam6=np.full(6, 0.5), w_user=0.8, w_item=0.7, max_cg_steps=3,
        finalize_chol=True, finalize_steps=5, glob_mean=0.0,
        scale_lam=False, scale_bias_const=False, verbose=False,
        init=dict(A=A0, B=B0), exact=True, **kw)
    for key, tol in (("C", 1e-4), ("D", 1e-4), ("B", 2e-4), ("A", 2e-4)):
        b = np.asarray(res_b[key], np.float64)[:, :k]
        pp = np.asarray(res_p[key], np.float64)[:, :k]
        np.testing.assert_allclose(pp, b, rtol=0, atol=tol, err_msg=key)
