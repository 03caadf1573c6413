"""Oracle tests for the fused masked-Gram kernel (Pallas interpret mode on
the CPU), the padding rules around it, and the dense engines built on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmfrec_tpu.ops import masked_matmul
from cmfrec_tpu.ops.masked_matmul import (
    BLOCK_R,
    BLOCK_S,
    MAX_SPLIT,
    masked_gram_matvec,
    masked_rhs,
    pad_dim,
    pad_k,
)

HI = jax.lax.Precision.HIGHEST
# bf16 operands round the factors (~0.4% on each product); f32 operands run
# at Precision.HIGHEST and differ from the reference by summation order only
TOL = {jnp.bfloat16: 1e-2, jnp.float32: 1e-5}


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")


def _padded_problem(rng, R, S, k, w_dtype, op_dtype):
    """A ragged [R, S] problem zero-padded to the kernel's shapes; returns
    the padded device operands and the unpadded f64 originals."""
    Rp, Sp, Kp = pad_dim(R), pad_dim(S), pad_k(k)
    Q = rng.normal(size=(R, k))
    Be = rng.normal(size=(S, k))
    mask = rng.uniform(size=(R, S)) < 0.3
    W = mask * (1.0 if w_dtype == jnp.int8 else rng.uniform(0.5, 2.0, (R, S)))
    if w_dtype == jnp.bfloat16:
        W = np.asarray(jnp.asarray(W, jnp.bfloat16), np.float64)

    def pad(x, shape, dt):
        out = np.zeros(shape)
        out[tuple(slice(0, d) for d in x.shape)] = x
        return jnp.asarray(out, dt)

    dev = (pad(Q, (Rp, Kp), op_dtype), pad(Be, (Sp, Kp), op_dtype),
           pad(W, (Rp, Sp), w_dtype))
    return dev, (Q, Be, W)


@pytest.mark.parametrize("op_dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("w_dtype", [jnp.int8, jnp.bfloat16, jnp.float32])
def test_masked_gram_matvec_matches_einsum(rng, w_dtype, op_dtype):
    R, S, k = 100, 300, 51
    (Qd, Bd, Wd), (Q, Be, W) = _padded_problem(rng, R, S, k, w_dtype,
                                               op_dtype)
    out = np.asarray(masked_gram_matvec(Qd, Bd, Wd))
    assert out.shape == Qd.shape and out.dtype == np.float32
    ref = np.asarray(jnp.einsum(
        "rs,sk->rk",
        jnp.einsum("rk,sk->rs", jnp.asarray(Q, jnp.float32),
                   jnp.asarray(Be, jnp.float32), precision=HI)
        * jnp.asarray(W, jnp.float32),
        jnp.asarray(Be, jnp.float32), precision=HI))
    err = np.linalg.norm(out[:R, :k] - ref) / np.linalg.norm(ref)
    assert err <= TOL[op_dtype], err
    # zero padding stays zero: padded rows and factor columns
    assert not out[R:].any() and not out[:, k:].any()


@pytest.mark.parametrize("op_dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("w_dtype", [jnp.int8, jnp.bfloat16, jnp.float32])
def test_masked_rhs_matches_einsum(rng, w_dtype, op_dtype):
    R, S, k = 70, 200, 20
    (_, Bd, Wd), (_, Be, W) = _padded_problem(rng, R, S, k, w_dtype,
                                              op_dtype)
    X = np.round(rng.uniform(1, 10, size=(R, S))) / 2  # exact in bf16
    Xd = jnp.zeros(Wd.shape, jnp.bfloat16).at[:R, :S].set(
        jnp.asarray(X, jnp.bfloat16))
    mb = np.zeros(Bd.shape[0])
    mb[:S] = rng.normal(size=S)
    out = np.asarray(masked_rhs(Xd, Wd, jnp.asarray(mb, jnp.float32), Bd))
    ref = np.asarray(jnp.einsum(
        "rs,sk->rk", jnp.asarray((X - mb[None, :S]) * W, jnp.float32),
        jnp.asarray(Be, jnp.float32), precision=HI))
    err = np.linalg.norm(out[:R, :k] - ref) / np.linalg.norm(ref)
    assert err <= TOL[op_dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [jnp.int8, jnp.bfloat16, jnp.float32])
def test_kernels_compiled_for_the_card(gpu, rng, w_dtype):
    """The Triton kernels as compiled for the card (not interpreted)
    against the f32 HIGHEST reference, at a width that splits the
    streamed axis."""
    (Qd, Bd, Wd), (Q, Be, W) = _padded_problem(rng, 700, 3000, 50, w_dtype,
                                               jnp.bfloat16)
    out = np.asarray(masked_gram_matvec(Qd, Bd, Wd))[:700, :50]
    ref = ((Q @ Be.T) * W) @ Be
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-2
    Xd = jnp.asarray(Wd, jnp.bfloat16)
    mb = jnp.zeros(Bd.shape[0], jnp.float32)
    out = np.asarray(masked_rhs(Xd, Wd, mb, Bd))[:700, :50]
    ref = (W * W) @ Be
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-2


@pytest.mark.parametrize("dim", [1, 60, 513, 10677, 69878])
@pytest.mark.parametrize("row_mult", [1, 4, 8])
def test_pad_dim_constraints(dim, row_mult):
    padded = pad_dim(dim, row_mult=row_mult)
    assert padded >= dim
    # row axis: whole row blocks on every device of the mesh
    assert (padded // row_mult) % BLOCK_R == 0
    # streamed axis: whole tiles at the largest split
    assert padded % (BLOCK_S * MAX_SPLIT) == 0
    # minimal: one step less would not hold dim
    step = int(np.lcm(BLOCK_R * row_mult, BLOCK_S * MAX_SPLIT))
    assert padded - step < dim


@pytest.mark.parametrize("k,expect", [(1, 64), (50, 64), (64, 64),
                                      (65, 128), (100, 128), (150, 256)])
def test_pad_k_power_of_two(k, expect):
    assert pad_k(k) == expect


@pytest.fixture
def h100_sms(monkeypatch):
    """The split rule as on an H100 (132 SMs); interpret mode has none."""
    monkeypatch.setattr(masked_matmul, "_sm_count", lambda: 132)


def test_split_fills_short_row_axis(h100_sms):
    """A short row axis splits the streamed axis so the card still gets
    enough programs; a long one does not split; the split always divides
    the streamed axis into whole tiles."""
    long_r, short_r = pad_dim(69878), pad_dim(10677)
    assert masked_matmul._split(long_r, short_r) == 1
    s = masked_matmul._split(short_r, long_r)
    assert 1 < s <= MAX_SPLIT
    assert long_r % (BLOCK_S * s) == 0
    assert masked_matmul._split(BLOCK_R, BLOCK_S) == 1


def test_split_needs_sms():
    """In interpret mode there is no card to fill: one program per row
    block."""
    assert masked_matmul._sm_count() == 0
    assert masked_matmul._split(pad_dim(10677), pad_dim(69878)) == 1


def test_matvec_split_matches_unsplit(rng, h100_sms, monkeypatch):
    """Partial sums over a split streamed axis add up to the one-pass
    result."""
    R, S, K = pad_dim(100), pad_dim(1000), 64
    Q = jnp.asarray(rng.normal(size=(R, K)), jnp.bfloat16)
    Be = jnp.asarray(rng.normal(size=(S, K)), jnp.bfloat16)
    W = jnp.asarray(rng.uniform(size=(R, S)) < 0.3, jnp.int8)
    assert masked_matmul._split(R, S) > 1
    jax.clear_caches()
    split = np.asarray(masked_gram_matvec(Q, Be, W))
    monkeypatch.setattr(masked_matmul, "_split", lambda R, S: 1)
    jax.clear_caches()
    whole = np.asarray(masked_gram_matvec(Q, Be, W))
    np.testing.assert_allclose(split, whole, rtol=1e-4, atol=1e-3)


def test_kernel_rejects_unpadded_shapes():
    bf = jnp.bfloat16
    Q = jnp.ones((BLOCK_R + 1, 64), bf)
    Be = jnp.ones((pad_dim(10), 64), bf)
    W = jnp.ones((BLOCK_R + 1, Be.shape[0]), jnp.int8)
    with pytest.raises(ValueError, match="unpadded"):
        masked_gram_matvec(Q, Be, W)
    with pytest.raises(ValueError, match="unpadded"):
        masked_gram_matvec(jnp.ones((BLOCK_R, 51), bf),
                           jnp.ones((BLOCK_S, 51), bf),
                           jnp.ones((BLOCK_R, BLOCK_S), jnp.int8))
    with pytest.raises(ValueError, match="unpadded"):
        masked_rhs(W, W, jnp.zeros(Be.shape[0]), Be)


def test_dense_pallas_fit_matches_xla_engine(rng):
    """End-to-end: interpret-mode pallas fit vs the XLA dense engine on the
    same data reaches the same predictions (same ridge fixed point)."""
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas
    from cmfrec_tpu.solvers import drivers

    m, n, k = 64, 48, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    mask = rng.uniform(size=(m, n)) < 0.5
    X = A0 @ B0.T + 0.05 * rng.normal(size=(m, n)) + 3.0
    ro, co = np.nonzero(mask)
    vals = X[ro, co]
    lam6 = np.full(6, 0.5)
    mu = float(vals.mean())

    common = dict(
        weights=None, k=k, lam6=lam6, niter=20, max_cg_steps=3,
        finalize_chol=True, user_bias=True, item_bias=True, glob_mean=mu,
        scale_lam=False, scale_bias_const=False,
        dtype=np.float32, seed=3, verbose=False,
    )
    from cmfrec_tpu.solvers.preprocess import initialize_biases

    bA, bB = initialize_biases(ro, co, (vals - mu).astype(np.float32), m, n,
                               lam_user=0.5, lam_item=0.5, wgt=None,
                               user_bias=True, item_bias=True,
                               scale_lam=False, nonneg=False)
    res_p = fit_explicit_dense_pallas(
        ro, co, vals, m, n, finalize_steps=30, biasA0=bA, biasB0=bB,
        **common,
    )
    res_x = drivers._fit_explicit_dense(
        ro, co, (vals - mu).astype(np.float32), m, n,
        biasA0=bA, biasB0=bB, **common,
    )
    pred_p = (res_p["glob_mean"] + res_p["biasA"][ro] + res_p["biasB"][co]
              + np.einsum("nk,nk->n", res_p["A"][ro], res_p["B"][co]))
    pred_x = (res_x["glob_mean"] + res_x["biasA"][ro] + res_x["biasB"][co]
              + np.einsum("nk,nk->n", res_x["A"][ro], res_x["B"][co]))
    # both engines solve the same ALS; predictions agree to CG/bf16 noise
    np.testing.assert_allclose(pred_p, pred_x, rtol=0, atol=5e-2)
    rmse_p = np.sqrt(np.mean((pred_p - vals) ** 2))
    rmse_x = np.sqrt(np.mean((pred_x - vals) ** 2))
    assert abs(rmse_p - rmse_x) < 5e-3


@pytest.mark.slow
def test_collective_dense_pallas_matches_bucketed(rng):
    """The fused collective engine (interpret mode) reaches the same fixed
    point as the bucketed collective path on dense side info."""
    import os

    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als
    from cmfrec_tpu.solvers.dense_pallas import fit_collective_dense_pallas

    m, n, k, p, q = 80, 60, 4, 5, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    U = A0 @ rng.normal(size=(k, p)) + 0.05 * rng.normal(size=(m, p))
    I = B0 @ rng.normal(size=(k, q)) + 0.05 * rng.normal(size=(n, q))
    mask = rng.uniform(size=(m, n)) < 0.5
    ro, co = np.nonzero(mask)
    vals = (A0 @ B0.T)[ro, co] + 3.0 + 0.05 * rng.normal(size=ro.size)
    mu = float(vals.mean())
    Uc = U - U.mean(0)
    Ic = I - I.mean(0)

    res_p = fit_collective_dense_pallas(
        ro, co, vals, m, n, U_dense=Uc.astype(np.float32),
        I_dense=Ic.astype(np.float32), weights=None,
        k=k, lam6=np.full(6, 0.6), w_user=0.7, w_item=0.9,
        niter=15, max_cg_steps=3, finalize_chol=True, finalize_steps=25,
        user_bias=True, item_bias=True, glob_mean=mu, scale_lam=False,
        scale_bias_const=False, dtype=np.float32, seed=5, verbose=False,
       
    )
    res_b = fit_collective_explicit_als(
        ro, co, vals, m, n,
        side_U=(None, None, None, m, p, True, Uc),
        side_I=(None, None, None, n, q, True, Ic),
        k=k, lambda_=0.6, w_user=0.7, w_item=0.9, niter=15,
        use_cg=False, finalize_chol=True, user_bias=True, item_bias=True,
        center_U=False, center_I=False, dtype=np.float32, seed=5,
    )
    pred_p = (res_p["glob_mean"] + np.asarray(res_p["biasA"])[ro]
              + np.asarray(res_p["biasB"])[co]
              + np.einsum("ek,ek->e", np.asarray(res_p["A"])[ro],
                          np.asarray(res_p["B"])[co]))
    pred_b = (res_b["glob_mean"] + np.asarray(res_b["biasA"])[ro]
              + np.asarray(res_b["biasB"])[co]
              + np.einsum("ek,ek->e", np.asarray(res_b["A"])[ro],
                          np.asarray(res_b["B"])[co]))
    # engines differ in bias-init path and CG step ordering, so finite-
    # iteration fixed points differ by O(1e-2); quality must match tightly
    np.testing.assert_allclose(pred_p, pred_b, rtol=0, atol=0.15)
    rmse_p = np.sqrt(np.mean((pred_p - vals) ** 2))
    rmse_b = np.sqrt(np.mean((pred_b - vals) ** 2))
    assert abs(rmse_p - rmse_b) < 1e-2, (rmse_p, rmse_b)
    # side-info projections agree too (up to sign/rotation the predictions
    # already pin them; check the U-reconstruction quality matches)
    eu_p = np.linalg.norm(Uc - np.asarray(res_p["A"]) @ np.asarray(res_p["C"]).T)
    eu_b = np.linalg.norm(Uc - np.asarray(res_b["A"])[:, :k] @ np.asarray(res_b["C"]).T)
    assert abs(eu_p - eu_b) / max(eu_b, 1e-9) < 0.3  # pallas recomputes C post-A-update (fresher)


@pytest.mark.slow
@pytest.mark.parametrize("with_side,scale_lam", [(False, True),
                                                 (True, False)])
def test_collective_dense_pallas_implicit_features(rng, with_side, scale_lam):
    """The fused collective engine with add_implicit_features (the
    reference's best-RMSE benchmark config, benchmark/README.md:28-29)
    reaches the bucketed collective path's fixed point — both the plain
    scale_lam config bench.py times and the side-info+implicit combo."""
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als
    from cmfrec_tpu.solvers.dense_pallas import fit_collective_dense_pallas

    m, n, k, p = 80, 60, 4, 5
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    U = A0 @ rng.normal(size=(k, p)) + 0.05 * rng.normal(size=(m, p))
    Uc = (U - U.mean(0)).astype(np.float32)
    mask = rng.uniform(size=(m, n)) < 0.5
    ro, co = np.nonzero(mask)
    vals = (A0 @ B0.T)[ro, co] + 3.0 + 0.05 * rng.normal(size=ro.size)
    mu = float(vals.mean())

    res_p = fit_collective_dense_pallas(
        ro, co, vals, m, n,
        U_dense=Uc if with_side else None, I_dense=None, weights=None,
        k=k, lam6=np.full(6, 0.6 if not scale_lam else 0.02),
        w_user=0.7, w_item=1.0,
        niter=15, max_cg_steps=3, finalize_chol=True, finalize_steps=25,
        user_bias=True, item_bias=True, glob_mean=mu, scale_lam=scale_lam,
        scale_bias_const=False, dtype=np.float32, seed=5, verbose=False,
        add_implicit_features=True, w_implicit=0.5,
    )
    res_b = fit_collective_explicit_als(
        ro, co, vals, m, n,
        side_U=(None, None, None, m, p, True, Uc) if with_side else None,
        k=k, lambda_=0.6 if not scale_lam else 0.02, w_user=0.7,
        niter=15, use_cg=False, finalize_chol=True,
        user_bias=True, item_bias=True, scale_lam=scale_lam,
        center_U=False, dtype=np.float32, seed=5,
        add_implicit_features=True, w_implicit=0.5,
    )
    assert res_p["Ai"] is not None and res_p["Bi"] is not None
    assert res_p["Ai"].shape == (m, k) and res_p["Bi"].shape == (n, k)

    def pred(res):
        return (res["glob_mean"] + np.asarray(res["biasA"])[ro]
                + np.asarray(res["biasB"])[co]
                + np.einsum("ek,ek->e", np.asarray(res["A"])[ro, :k],
                            np.asarray(res["B"])[co, :k]))

    pred_p, pred_b = pred(res_p), pred(res_b)
    # finite-iteration points differ through bias-init and CG-stop noise
    # compounding (single-iteration semantics are pinned tightly below);
    # quality must agree closely
    np.testing.assert_allclose(pred_p, pred_b, rtol=0, atol=0.6)
    rmse_p = np.sqrt(np.mean((pred_p - vals) ** 2))
    rmse_b = np.sqrt(np.mean((pred_b - vals) ** 2))
    assert abs(rmse_p - rmse_b) < 1.5e-2, (rmse_p, rmse_b)
    # the Xones factorizations agree in quality: both engines reconstruct
    # the binary mask from A@Bi^T equally well
    ones_p = np.asarray(res_p["A"])[:, :k] @ np.asarray(res_p["Bi"]).T
    ones_b = (np.asarray(res_b["A"])[:, :k]
              @ np.asarray(res_b["Bi"])[:, :k].T)
    e_p = np.linalg.norm(mask.astype(np.float64) - ones_p)
    e_b = np.linalg.norm(mask.astype(np.float64) - ones_b)
    assert abs(e_p - e_b) / max(e_b, 1e-9) < 0.05, (e_p, e_b)


def test_collective_dense_pallas_implicit_one_iter_trajectory(rng):
    """Single controlled iteration from shared inits: the fused engine's
    Ai/Bi half-steps must equal the bucketed path's shared-Gram solves to
    float precision, and the A/B half-steps to CG-stop noise (rows freeze
    at residual <=1e-8, so ~1e-2 absolute — the same tolerance class the
    plain-model engines carry)."""
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als
    from cmfrec_tpu.solvers.dense_pallas import fit_collective_dense_pallas

    m, n, k = 30, 20, 3
    mask = rng.uniform(size=(m, n)) < 0.6
    ro, co = np.nonzero(mask)
    vals = rng.normal(size=ro.size) + 3.0
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
        finalize_chol=True, finalize_steps=40, glob_mean=0.0,
        scale_lam=False, scale_bias_const=False, verbose=False,
        add_implicit_features=True, w_implicit=0.5,
        init=dict(A=A0, B=B0), **kw)
    for key, tol in (("Bi", 1e-5), ("Ai", 1e-5), ("B", 0.05), ("A", 0.05)):
        b = np.asarray(res_b[key], np.float64)[:, :k]
        p = np.asarray(res_p[key], np.float64)[:, :k]
        np.testing.assert_allclose(p, b, rtol=0, atol=tol, err_msg=key)


def test_dense_na0_matches_bucketed(rng):
    """The shared-Gram NA-as-zero closed form (interpret mode) matches the
    bucketed engine's na0 coefficient path."""
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas
    from cmfrec_tpu.solvers import drivers

    m, n, k = 72, 48, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    mask = rng.uniform(size=(m, n)) < 0.4
    ro, co = np.nonzero(mask)
    vals = (A0 @ B0.T)[ro, co] + 0.05 * rng.normal(size=ro.size)
    common = dict(k=k, lambda_=0.4, niter=30, NA_as_zero=True,
                  user_bias=True, item_bias=True, center=True, seed=3)
    rb = drivers.fit_explicit_als(ro, co, vals, m, n, engine="sparse",
                                  use_cg=False, **common)
    mu = rb["glob_mean"]
    rp = fit_explicit_dense_pallas(
        ro, co, vals, m, n, weights=None, k=k, lam6=np.full(6, 0.4),
        niter=30, max_cg_steps=3, finalize_chol=False, finalize_steps=10,
        user_bias=True, item_bias=True, glob_mean=mu, scale_lam=False,
        scale_bias_const=False, biasA0=None, biasB0=None,
        dtype=np.float32, seed=3, verbose=False,
        na_as_zero=True,
    )
    # compare full predicted matrices (na0 defines them everywhere)
    P_b = (mu + np.asarray(rb["biasA"])[:, None]
           + np.asarray(rb["biasB"])[None, :]
           + np.asarray(rb["A"]) @ np.asarray(rb["B"]).T)
    P_p = (mu + np.asarray(rp["biasA"])[:, None]
           + np.asarray(rp["biasB"])[None, :]
           + np.asarray(rp["A"]) @ np.asarray(rp["B"]).T)
    np.testing.assert_allclose(P_p, P_b, rtol=0, atol=5e-2)


def test_dense_implicit_matches_bucketed(rng):
    """The fused dense WRMF engine solves the same per-row systems as the
    bucketed implicit path: from a COMMON init, one exact iteration of each
    engine must agree (WRMF is init-sensitive, so free-running fits are not
    comparable — seed-to-seed variation alone is ~0.4)."""
    from cmfrec_tpu.solvers.dense_pallas import fit_implicit_dense_pallas
    from cmfrec_tpu.solvers import drivers

    m, n, k = 72, 48, 4
    rows = rng.integers(0, m, 900)
    cols = rng.integers(0, n, 900)
    pairs = np.unique(rows * n + cols)  # the dense scatter dedupes; match it
    rows, cols = pairs // n, pairs % n
    # alpha*x and 1+alpha*x exactly representable in bf16 (the engine's
    # storage dtype): alpha=0.5, small integer play counts
    vals = rng.integers(1, 17, rows.size).astype(np.float64)
    A0 = 0.3 * rng.normal(size=(m, k)).astype(np.float32)
    B0 = 0.3 * rng.normal(size=(n, k)).astype(np.float32)
    init = dict(A=A0, B=B0)
    w_mult = rows.size / (m * n)
    # bucketed: one exact (Cholesky) iteration from the common init
    rb = drivers.fit_implicit_als(rows, cols, vals, m, n, k=k, lambda_=2.0,
                                  alpha=0.5, niter=1, use_cg=False,
                                  adjust_weight=True, init=init)
    # dense: one iteration solved to convergence (30-step CG == exact)
    rp = fit_implicit_dense_pallas(
        rows, cols, vals, m, n, k=k, lam6=np.full(6, 2.0), niter=1,
        max_cg_steps=3, finalize_steps=30, finalize_chol=True, alpha=0.5,
        w_main_multiplier=w_mult, dtype=np.float32,
        seed=1, verbose=False, init=init,
    )
    np.testing.assert_allclose(np.asarray(rp["A"]), np.asarray(rb["A"]),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(rp["B"]), np.asarray(rb["B"]),
                               rtol=0, atol=5e-3)


def test_dense_collective_implicit_matches_numpy(rng):
    """Collective WRMF on the fused engine: one exact iteration from a
    common init matches the direct NumPy normal equations (implicit
    confidence + w_u CtC side term,
    /root/reference/src/collective.c:5971), in the reference half-step
    order — C from the carried A, then B against the carried A, then A
    against the UPDATED B (collective.c:9927 -> :9981)."""
    from cmfrec_tpu.solvers.dense_pallas import (
        fit_collective_implicit_dense_pallas,
    )

    m, n, k, p = 64, 40, 4, 5
    rows = rng.integers(0, m, 700)
    cols = rng.integers(0, n, 700)
    pairs = np.unique(rows * n + cols)
    rows, cols = pairs // n, pairs % n
    vals = rng.integers(1, 17, rows.size).astype(np.float64)
    U = rng.normal(size=(m, p)).astype(np.float32)
    A0 = 0.3 * rng.normal(size=(m, k)).astype(np.float32)
    B0 = 0.3 * rng.normal(size=(n, k)).astype(np.float32)
    alpha, lam, wu = 0.5, 2.0, 0.7

    Uf = U.astype(np.float64)
    Af = A0.astype(np.float64)
    C = np.linalg.solve(wu * Af.T @ Af + lam * np.eye(k),
                        wu * Af.T @ Uf).T
    # B half-step against the carried A (no item side info here); columns
    # with no observations stay dead (the engine's live mask zeroes them)
    GA = Af.T @ Af
    B1 = np.zeros((n, k))
    for c in range(n):
        sel = cols == c
        rs, xs = rows[sel], vals[sel]
        if rs.size == 0:
            continue
        G = GA + (Af[rs].T * (alpha * xs)) @ Af[rs] + lam * np.eye(k)
        rhs = Af[rs].T @ (1 + alpha * xs)
        B1[c] = np.linalg.solve(G, rhs)
    # A half-step against the UPDATED B
    GB = B1.T @ B1
    A_ref = np.zeros((m, k))
    for r in range(m):
        sel = rows == r
        cs, xs = cols[sel], vals[sel]
        G = (GB + (B1[cs].T * (alpha * xs)) @ B1[cs]
             + wu * C.T @ C + lam * np.eye(k))
        rhs = B1[cs].T @ (1 + alpha * xs) + wu * C.T @ Uf[r]
        A_ref[r] = np.linalg.solve(G, rhs)

    rp = fit_collective_implicit_dense_pallas(
        rows, cols, vals, m, n, U_dense=U, I_dense=None,
        k=k, lam6=np.full(6, lam), w_user=wu, w_item=1.0, niter=1,
        max_cg_steps=3, finalize_steps=30, finalize_chol=True, alpha=alpha,
        w_main_multiplier=1.0, dtype=np.float32, seed=1, verbose=False,
        init=dict(A=A0, B=B0),
    )
    np.testing.assert_allclose(np.asarray(rp["B"], np.float64), B1,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rp["A"], np.float64), A_ref,
                               rtol=0, atol=1e-4)


def test_chunked_interaction_upload_matches_single(rng, monkeypatch):
    """_ship_interactions' chunk-overlapped uploads are bitwise identical
    to the single-shot upload (explicit weighted + implicit scaled)."""
    import jax.numpy as jnp

    from cmfrec_tpu.solvers.dense_pallas import _ship_interactions

    m, n, nnz = 300, 120, 30000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz) * 3
    wgt = rng.uniform(0.5, 2.0, nnz)

    monkeypatch.setenv("CMFREC_TPU_NO_WIRE_OVERLAP", "1")
    f1, v1, w1 = _ship_interactions(rows, cols, vals, wgt, n)
    fi1, vi1, _ = _ship_interactions(rows, cols, vals, None, n, scale=0.7)
    monkeypatch.setenv("CMFREC_TPU_NO_WIRE_OVERLAP", "0")
    monkeypatch.setenv("CMFREC_TPU_WIRE_CHUNK_MB", "0.01")
    f2, v2, w2 = _ship_interactions(rows, cols, vals, wgt, n)
    fi2, vi2, _ = _ship_interactions(rows, cols, vals, None, n, scale=0.7)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(v1, np.float32),
                                  np.asarray(v2, np.float32))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(fi1), np.asarray(fi2))
    np.testing.assert_array_equal(np.asarray(vi1, np.float32),
                                  np.asarray(vi2, np.float32))
