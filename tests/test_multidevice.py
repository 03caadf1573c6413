"""Multi-device parity: the same fit on 1 device vs an 8-device mesh.

SURVEY.md §4: "test multi-host by running the same pjit program on 1 vs N
simulated devices asserting tolerance parity".  conftest.py provides the
8 virtual CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# 1-vs-8-device trajectory pins re-run every fit twice; inner loop skips
# them (pytest -m "not slow"), the round-end full suite runs everything
pytestmark = pytest.mark.slow

from cmfrec_tpu.data.shards import build_bucketed_rows
from cmfrec_tpu.parallel.mesh import (
    make_mesh,
    replicated,
    row_sharding,
    shard_bucketed,
)
from cmfrec_tpu.solvers.als import (
    SidePlan,
    blocks_to_orig,
    gram_matrix,
    init_blocks,
    update_side,
)


@pytest.fixture
def problem(rng):
    m, n, k_true = 128, 96, 4
    A = rng.normal(size=(m, k_true))
    B = rng.normal(size=(n, k_true))
    mask = rng.uniform(size=(m, n)) < 0.3
    rows, cols = np.nonzero(mask)
    vals = (A @ B.T)[rows, cols] + 0.1 * rng.normal(size=rows.size)
    return rows, cols, vals, m, n


def _one_halfstep(rows, cols, vals, m, n, mesh=None):
    """One explicit A half-step on the bucketed engine, optionally sharded."""
    dtype = np.float32
    k, k_pad = 6, 8
    RB = build_bucketed_rows(rows, cols, vals, m, n, dtype=dtype, row_block=8)
    if mesh is not None:
        shard_bucketed(RB, mesh)
    key = jax.random.PRNGKey(0)
    key, A_blocks = init_blocks(key, RB, k, k_pad, dtype)
    B0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n, k_pad), dtype)
    if mesh is not None:
        rs = row_sharding(mesh)
        A_blocks = [jax.device_put(b, rs) for b in A_blocks]
        B0 = jax.device_put(B0, replicated(mesh))
    lam_vec = jnp.ones(k_pad, dtype)
    plan = SidePlan(RB, "explicit", n)
    ctx = mesh if mesh is not None else _nullcontext()
    with ctx:
        A_blocks = update_side(plan, A_blocks, B0, None, lam_vec,
                               method="chol", dtype=dtype)
        out = blocks_to_orig(A_blocks, jnp.asarray(RB.perm), m)
    return np.asarray(out)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_halfstep_parity_1_vs_8_devices(problem):
    rows, cols, vals, m, n = problem
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    single = _one_halfstep(rows, cols, vals, m, n, mesh=None)
    mesh = make_mesh(8)
    sharded = _one_halfstep(rows, cols, vals, m, n, mesh=mesh)
    np.testing.assert_allclose(single, sharded, rtol=1e-5, atol=1e-6)


def test_full_fit_parity_sharded_inputs(problem):
    """fit_explicit_als produces the same model when bucket arrays are
    sharded over the mesh before the iteration loop (XLA inserts the
    collectives; results must match the single-device run)."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    r1 = drivers.fit_explicit_als(rows, cols, vals, m, n, k=5, lambda_=0.7,
                                  niter=4, engine="sparse", seed=3)
    # same fit but with the driver's arrays placed on an 8-device mesh:
    # device placement must not change the mathematics
    mesh = make_mesh(8)
    with mesh:
        r2 = drivers.fit_explicit_als(rows, cols, vals, m, n, k=5,
                                      lambda_=0.7, niter=4, engine="sparse",
                                      seed=3)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)


def test_explicit_driver_mesh_param_parity(problem):
    """fit_explicit_als(mesh=...) shards the buckets/blocks over the mesh
    and must reproduce the single-device fit (SURVEY §2.4 P5)."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    r1 = drivers.fit_explicit_als(rows, cols, vals, m, n, k=5, lambda_=0.7,
                                  niter=4, engine="sparse", seed=3)
    r2 = drivers.fit_explicit_als(rows, cols, vals, m, n, k=5, lambda_=0.7,
                                  niter=4, engine="sparse", seed=3,
                                  mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1["biasB"]),
                               np.asarray(r2["biasB"]), rtol=1e-4, atol=1e-5)


def test_implicit_driver_mesh_param_parity(problem):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    v = np.abs(vals) + 1.0
    r1 = drivers.fit_implicit_als(rows, cols, v, m, n, k=5, lambda_=1.0,
                                  niter=4, seed=3)
    r2 = drivers.fit_implicit_als(rows, cols, v, m, n, k=5, lambda_=1.0,
                                  niter=4, seed=3, mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)


def test_collective_explicit_mesh_param_parity(problem, rng):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als

    U = rng.normal(size=(m, 7))
    side_U = (None, None, None, m, 7, True, U)
    common = dict(side_U=side_U, k=4, k_user=1, k_main=1, lambda_=0.8,
                  niter=3, use_cg=True, max_cg_steps=3, seed=3,
                  dtype=np.float32)
    r1 = fit_collective_explicit_als(rows, cols, vals, m, n, **common)
    r2 = fit_collective_explicit_als(rows, cols, vals, m, n,
                                     mesh=make_mesh(8), **common)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1["C"]), np.asarray(r2["C"]),
                               rtol=1e-4, atol=1e-5)


def test_collective_implicit_mesh_param_parity(problem, rng):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.collective import fit_collective_implicit_als

    v = np.abs(vals) + 1.0
    # sparse side info exercises the aligned-parts + feature-bucket path
    Ur = rng.integers(0, m, 300)
    Uc = rng.integers(0, 6, 300)
    Uv = rng.normal(size=300)
    side_U = (Ur, Uc, Uv, m, 6, False, None)
    common = dict(side_U=side_U, k=4, lambda_=1.0, niter=3, seed=3,
                  dtype=np.float32)
    r1 = fit_collective_implicit_als(rows, cols, v, m, n, **common)
    r2 = fit_collective_implicit_als(rows, cols, v, m, n,
                                     mesh=make_mesh(8), **common)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)


def test_distributed_topn_matches_single(rng):
    """P6: sharded scoring + per-shard top-k + global merge == plain top-k."""
    from cmfrec_tpu.parallel.topn import topn_sharded

    n, k = 1024, 16
    B = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    a = jnp.asarray(rng.normal(size=k), jnp.float32)
    bias = jnp.asarray(rng.normal(size=n), jnp.float32)
    mesh = make_mesh(8)
    idx, scores = topn_sharded(a, B, 10, bias, mesh)
    ref_scores = np.asarray(B @ a + bias)
    ref_idx = np.argsort(-ref_scores)[:10]
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(scores), ref_scores[ref_idx],
                               rtol=1e-6)


def test_dense_pallas_fit_sharded_matches_single(rng):
    """The mesh-sharded fused-kernel engine (interpret mode on the CPU mesh)
    must reproduce the single-device fit."""
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas

    m, n, k = 96, 64, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    mask = rng.uniform(size=(m, n)) < 0.5
    ro, co = np.nonzero(mask)
    vals = (A0 @ B0.T)[ro, co] + 3.0 + 0.05 * rng.normal(size=ro.size)
    common = dict(
        weights=None, k=k, lam6=np.full(6, 0.5), niter=6, max_cg_steps=3,
        finalize_chol=True, finalize_steps=20, user_bias=True,
        item_bias=True, glob_mean=float(vals.mean()), scale_lam=False,
        scale_bias_const=False, biasA0=None, biasB0=None,
        dtype=np.float32, seed=3, verbose=False,
    )
    r1 = fit_explicit_dense_pallas(ro, co, vals, m, n, **common)
    mesh = make_mesh(8)
    r2 = fit_explicit_dense_pallas(ro, co, vals, m, n, mesh=mesh, **common)
    p1 = (np.asarray(r1["A"])[ro] * np.asarray(r1["B"])[co]).sum(1)
    p2 = (np.asarray(r2["A"])[ro] * np.asarray(r2["B"])[co]).sum(1)
    np.testing.assert_allclose(p1, p2, rtol=1e-3, atol=1e-3)


def test_dense_pallas_exact_sharded_matches_single(rng):
    """Exact mode under a mesh: the while-loop CG's global all-frozen stop
    reduces over the sharded live mask — the sharded fit must reproduce
    the single-device exact fit."""
    from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas

    m, n, k = 96, 64, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    mask = rng.uniform(size=(m, n)) < 0.5
    ro, co = np.nonzero(mask)
    vals = np.round(8 * ((A0 @ B0.T)[ro, co] + 3.0
                         + 0.05 * rng.normal(size=ro.size))) / 8
    common = dict(
        weights=None, k=k, lam6=np.full(6, 0.5), niter=4, max_cg_steps=3,
        finalize_chol=True, finalize_steps=20, user_bias=True,
        item_bias=True, glob_mean=float(vals.mean()), scale_lam=False,
        scale_bias_const=False, biasA0=None, biasB0=None,
        dtype=np.float32, seed=3, verbose=False,
        exact=True,
    )
    r1 = fit_explicit_dense_pallas(ro, co, vals, m, n, **common)
    mesh = make_mesh(8)
    r2 = fit_explicit_dense_pallas(ro, co, vals, m, n, mesh=mesh, **common)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=0, atol=5e-4, err_msg=key)


def test_model_level_mesh_kwarg(problem):
    """CMF.fit(mesh=...) / CMF_implicit.fit(mesh=...) shard the fit and
    reproduce the unsharded model."""
    import scipy.sparse as sp
    from cmfrec_tpu import CMF, CMF_implicit

    rows, cols, vals, m, n = problem
    Xs = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    m1 = CMF(k=4, lambda_=0.7, niter=3, use_float=True).fit(Xs)
    m2 = CMF(k=4, lambda_=0.7, niter=3, use_float=True).fit(
        Xs, mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(m1.A_), np.asarray(m2.A_),
                               rtol=1e-3, atol=1e-4)
    Xi = sp.coo_matrix((np.abs(vals) + 1.0, (rows, cols)), shape=(m, n))
    i1 = CMF_implicit(k=4, lambda_=1.0, niter=3).fit(Xi)
    i2 = CMF_implicit(k=4, lambda_=1.0, niter=3).fit(Xi, mesh=make_mesh(8))
    # sharded psums reorder f32 accumulation; iterate amplifies slightly
    np.testing.assert_allclose(np.asarray(i1.A_), np.asarray(i2.A_),
                               rtol=8e-3, atol=1e-4)


def test_non_power_of_two_mesh(problem):
    """Mesh sizes with odd prime factors (6 devices) must not hang the
    row-block computation (regression: lcm, not doubling) and still give
    parity."""
    from cmfrec_tpu.solvers import drivers

    assert drivers._mesh_row_block(make_mesh(6)) == 24
    rows, cols, vals, m, n = problem
    r1 = drivers.fit_explicit_als(rows, cols, vals, m, n, k=4, lambda_=0.7,
                                  niter=2, engine="sparse", seed=3)
    r2 = drivers.fit_explicit_als(rows, cols, vals, m, n, k=4, lambda_=0.7,
                                  niter=2, engine="sparse", seed=3,
                                  mesh=make_mesh(6))
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=5e-3, atol=1e-4)


def test_sharded_opposing_matrix_halfstep(problem):
    """P7 / big-axis scaling: when n*k outgrows one device's memory the
    opposing matrix B can be ROW-SHARDED over the mesh instead of
    replicated; the gather then rides an XLA collective and the half-step
    result is unchanged (SURVEY §2.4 P7, shard_opposing)."""
    from cmfrec_tpu.parallel.mesh import shard_opposing

    rows, cols, vals, m, n = problem
    dtype = np.float32
    k, k_pad = 6, 8
    RB = build_bucketed_rows(rows, cols, vals, m, n, dtype=dtype,
                             row_block=8)
    mesh = make_mesh(8)
    shard_bucketed(RB, mesh)
    key = jax.random.PRNGKey(0)
    key, A_blocks = init_blocks(key, RB, k, k_pad, dtype)
    rs = row_sharding(mesh)
    A_blocks = [jax.device_put(b, rs) for b in A_blocks]
    B0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n, k_pad), dtype)
    B0_sharded = shard_opposing(B0, mesh, shard_rows=True)
    lam_vec = jnp.ones(k_pad, dtype)
    plan = SidePlan(RB, "explicit", n)
    out_sharded = update_side(plan, A_blocks, B0_sharded, None, lam_vec,
                              method="chol", dtype=dtype)
    out_repl = update_side(plan, [jax.device_put(b, rs) for b in A_blocks],
                           jax.device_put(B0, None), None, lam_vec,
                           method="chol", dtype=dtype)
    for a, b in zip(out_sharded, out_repl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# Big-axis mode: opposing factors ring-sharded (parallel/ring.py)        #
# --------------------------------------------------------------------- #


def test_ring_part_system_matches_assemble(rng):
    """ring_part_system (ppermute ring over B shards) assembles the same
    per-row (G, rhs) as the replicated-gather assemble_system."""
    from cmfrec_tpu.ops.rowsolve import SparsePart, assemble_system
    from cmfrec_tpu.parallel.ring import (
        pad_rows_to,
        ring_part_system,
        shard_rows,
    )

    S, K, R, L = 100, 12, 40, 16  # S *not* divisible by 8 -> padded
    mat = rng.standard_normal((S, K)).astype(np.float32)
    idx = rng.integers(0, S, (R, L)).astype(np.int32)
    cw = rng.random((R, L)).astype(np.float32)
    cv = rng.standard_normal((R, L)).astype(np.float32)
    cw[:, 12:] = 0  # slot padding
    cv[:, 12:] = 0

    mesh = make_mesh(8)
    G1, r1 = ring_part_system(
        shard_rows(pad_rows_to(jnp.asarray(mat), 8), mesh),
        shard_rows(jnp.asarray(idx), mesh),
        shard_rows(jnp.asarray(cw), mesh),
        shard_rows(jnp.asarray(cv), mesh),
        mesh=mesh,
    )
    G2, r2 = assemble_system(
        [SparsePart(jnp.asarray(mat), jnp.asarray(idx), jnp.asarray(cw),
                    jnp.asarray(cv))],
        jnp.zeros(K, jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(G1), np.asarray(G2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                               rtol=1e-5, atol=1e-5)


def test_ring_explicit_fit_parity(problem):
    """fit_explicit_als(shard_opposing_rows=True) — opposing factors kept
    row-sharded, systems assembled via the ring — reproduces the
    replicated-opposing fit (biases included)."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    mesh = make_mesh(8)
    kw = dict(k=5, lambda_=0.7, niter=4, use_cg=False, seed=3)
    r1 = drivers.fit_explicit_als(rows, cols, vals, m, n, mesh=mesh, **kw)
    r2 = drivers.fit_explicit_als(rows, cols, vals, m, n, mesh=mesh,
                                  shard_opposing_rows=True, **kw)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1["B"]), np.asarray(r2["B"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1["biasA"]),
                               np.asarray(r2["biasA"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["na0", "nonneg"])
def test_ring_explicit_variants(problem, variant):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    mesh = make_mesh(8)
    kw = dict(k=4, lambda_=1.5, niter=2, use_cg=False, seed=3,
              engine="sparse")
    if variant == "na0":
        kw["NA_as_zero"] = True
    else:
        kw["nonneg"] = True
        vals = np.abs(vals)
    r1 = drivers.fit_explicit_als(rows, cols, vals, m, n, mesh=mesh, **kw)
    r2 = drivers.fit_explicit_als(rows, cols, vals, m, n, mesh=mesh,
                                  shard_opposing_rows=True, **kw)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-4, atol=1e-5)


def test_ring_explicit_f64(problem):
    """float64 big-axis fit: the ring accumulation carry must match the
    f64 einsum outputs (regression — the fori_loop carry was pinned f32)."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    mesh = make_mesh(8)
    kw = dict(k=4, lambda_=0.9, niter=2, use_cg=False, seed=7,
              dtype=np.float64)
    r1 = drivers.fit_explicit_als(rows, cols, vals, m, n, mesh=mesh, **kw)
    r2 = drivers.fit_explicit_als(rows, cols, vals, m, n, mesh=mesh,
                                  shard_opposing_rows=True, **kw)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=1e-9, atol=1e-10)


def test_ring_implicit_fit_parity(problem):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    vi = np.maximum(1.0, np.abs(vals) * 4)
    mesh = make_mesh(8)
    kw = dict(k=5, lambda_=1.0, niter=3, use_cg=False, alpha=2.0, seed=5)
    r1 = drivers.fit_implicit_als(rows, cols, vi, m, n, mesh=mesh, **kw)
    r2 = drivers.fit_implicit_als(rows, cols, vi, m, n, mesh=mesh,
                                  shard_opposing_rows=True, **kw)
    np.testing.assert_allclose(np.asarray(r1["A"]), np.asarray(r2["A"]),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(r1["B"]), np.asarray(r2["B"]),
                               rtol=2e-3, atol=1e-4)


def test_ring_gates(problem):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers import drivers

    with pytest.raises(ValueError, match="use_cg=False"):
        drivers.fit_explicit_als(rows, cols, vals, m, n, k=4,
                                 mesh=make_mesh(8), use_cg=True,
                                 shard_opposing_rows=True)
    with pytest.raises(ValueError, match="mesh"):
        drivers.fit_implicit_als(rows, cols, vals, m, n, k=4,
                                 use_cg=False, shard_opposing_rows=True)


def test_ring_never_materializes_opposing():
    """The point of big-axis mode: the compiled ring program must contain
    NO all-gather (an all-gather of the opposing matrix is exactly the
    [S, K] materialization that doesn't fit)."""
    from cmfrec_tpu.parallel.ring import ring_part_system

    mesh = make_mesh(8)
    S, K, R, L = 4096, 32, 256, 16
    mat = jnp.ones((S, K), jnp.float32)
    idx = jnp.zeros((R, L), jnp.int32)
    cw = jnp.ones((R, L), jnp.float32)
    cv = jnp.ones((R, L), jnp.float32)
    txt = (
        jax.jit(lambda a, b, c, d: ring_part_system(a, b, c, d, mesh=mesh))
        .lower(mat, idx, cw, cv)
        .compile()
        .as_text()
    )
    assert "all-gather" not in txt
    assert "collective-permute" in txt


# ----------------------------------------------------------------------- #
# Big-axis mode for the COLLECTIVE drivers                                 #
# ----------------------------------------------------------------------- #


def _side_sparse(rng, n_ent, p, density=0.5):
    mask = rng.uniform(size=(n_ent, p)) < density
    r, c = np.nonzero(mask)
    v = rng.normal(size=r.size)
    return (r, c, v, n_ent, p, False, None)


def test_ring_collective_explicit_parity(problem, rng):
    """fit_collective_explicit_als(shard_opposing_rows=True) with sparse
    side info + biases reproduces the replicated-opposing fit."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als

    mesh = make_mesh(8)
    kw = dict(k=5, lambda_=0.8, w_user=0.6, niter=3, use_cg=False,
              user_bias=True, item_bias=True, seed=3,
              side_U=_side_sparse(rng, m, 6))
    r1 = fit_collective_explicit_als(rows, cols, vals, m, n, mesh=mesh, **kw)
    r2 = fit_collective_explicit_als(rows, cols, vals, m, n, mesh=mesh,
                                     shard_opposing_rows=True, **kw)
    for key in ("A", "B", "C", "biasA", "biasB"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_ring_collective_explicit_dense_side_and_implicit_feat(problem, rng):
    """Ring mode with DENSE side info (whole-matrix C solve on the
    concat-permuted U) plus add_implicit_features (Ai/Bi half-steps
    assembled via the ring)."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als

    mesh = make_mesh(8)
    U = rng.normal(size=(m, 5))
    U = (U - U.mean(0)).astype(np.float32)
    kw = dict(k=4, lambda_=0.9, w_user=0.7, niter=3, use_cg=False,
              user_bias=False, item_bias=False, seed=5, center_U=False,
              side_U=(None, None, None, m, 5, True, U),
              add_implicit_features=True, w_implicit=0.5)
    r1 = fit_collective_explicit_als(rows, cols, vals, m, n, mesh=mesh, **kw)
    r2 = fit_collective_explicit_als(rows, cols, vals, m, n, mesh=mesh,
                                     shard_opposing_rows=True, **kw)
    for key in ("A", "B", "C", "Ai", "Bi"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_ring_collective_implicit_parity(problem, rng):
    """fit_collective_implicit_als(shard_opposing_rows=True) with sparse
    side info reproduces the replicated fit."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.collective import fit_collective_implicit_als

    vi = np.maximum(1.0, np.abs(vals) * 4)
    mesh = make_mesh(8)
    kw = dict(k=5, lambda_=1.2, alpha=2.0, niter=3, use_cg=False, seed=5,
              side_U=_side_sparse(rng, m, 6))
    r1 = fit_collective_implicit_als(rows, cols, vi, m, n, mesh=mesh, **kw)
    r2 = fit_collective_implicit_als(rows, cols, vi, m, n, mesh=mesh,
                                     shard_opposing_rows=True, **kw)
    for key in ("A", "B", "C"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=2e-3, atol=1e-4, err_msg=key)


def test_ring_collective_gates(problem):
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.collective import (
        fit_collective_explicit_als,
        fit_collective_implicit_als,
    )

    with pytest.raises(ValueError, match="use_cg=False"):
        fit_collective_explicit_als(rows, cols, vals, m, n, k=4,
                                    mesh=make_mesh(8), use_cg=True,
                                    shard_opposing_rows=True)
    with pytest.raises(ValueError, match="mesh"):
        fit_collective_implicit_als(rows, cols, vals, m, n, k=4,
                                    use_cg=False, shard_opposing_rows=True)


def test_lbfgs_collective_mesh_param_parity(problem, rng):
    """The joint-gradient L-BFGS fit (the only path for binary side info)
    sharded over 8 devices reproduces the single-device trajectory:
    observations + factor pytrees row-sharded, loss/grad psum'd by GSPMD
    (the reference's OpenMP-over-observations strategy, common.c:107-123)."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.lbfgs import fit_collective_explicit_lbfgs

    U = rng.normal(size=(m, 7))
    Ub = (rng.uniform(size=(m, 3)) < 0.5).astype(np.float64)
    Ir = rng.integers(0, n, 200)
    Ic = rng.integers(0, 4, 200)
    Iv = rng.normal(size=200)
    common = dict(
        side_U=(None, None, None, m, 7, True, U),
        side_I=(Ir, Ic, Iv, n, 4, False, None),
        side_Ub=(None, None, None, m, 3, True, Ub),
        k=4, k_user=1, k_main=1, lambda_=0.8, w_user=0.9,
        maxiter=25, corr_pairs=4, dtype=np.float64, seed=3,
    )
    r1 = fit_collective_explicit_lbfgs(rows, cols, vals, m, n, **common)
    r2 = fit_collective_explicit_lbfgs(rows, cols, vals, m, n,
                                       mesh=make_mesh(8), **common)
    for key in ("A", "B", "C", "D", "Cb", "biasA", "biasB"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=1e-6, atol=1e-8, err_msg=key)


def test_offsets_lbfgs_mesh_param_parity(problem, rng):
    """OMF exact fit at k=128 sharded over the mesh (BASELINE config 5)
    reproduces the single-device fit."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.offsets import fit_offsets_explicit_lbfgs

    U = rng.normal(size=(m, 6))
    I = rng.normal(size=(n, 5))
    common = dict(
        side_U=(None, None, None, m, 6, True, U),
        side_I=(None, None, None, n, 5, True, I),
        k=128, k_sec=2, k_main=1, lambda_=1.0, w_user=0.8,
        maxiter=25, corr_pairs=5, dtype=np.float64, seed=3,
    )
    r1 = fit_offsets_explicit_lbfgs(rows, cols, vals, m, n, **common)
    r2 = fit_offsets_explicit_lbfgs(rows, cols, vals, m, n,
                                    mesh=make_mesh(8), **common)
    for key in ("A", "B", "C", "D", "C_bias", "Am", "Bm", "biasA"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=1e-6, atol=1e-8, err_msg=key)


def test_offsets_als_mesh_passthrough(problem, rng):
    """fit_offsets_als(mesh=) forwards to the inner ALS row-parallel fit."""
    rows, cols, vals, m, n = problem
    from cmfrec_tpu.solvers.offsets import fit_offsets_als

    U = rng.normal(size=(m, 6))
    common = dict(side_U=(None, None, None, m, 6, True, U), k=5,
                  lambda_=0.9, niter=3, seed=3, dtype=np.float32)
    r1 = fit_offsets_als(rows, cols, vals, m, n, **common)
    r2 = fit_offsets_als(rows, cols, vals, m, n, mesh=make_mesh(8), **common)
    for key in ("Am", "C", "A"):
        np.testing.assert_allclose(np.asarray(r1[key]), np.asarray(r2[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
