"""Oracle tests for the batched row solvers vs naive NumPy implementations.

Follows the reference's test_math pattern (/root/reference/test_math/
test_closed_form.py): build small random problems, solve with the batched
device kernels, compare against direct NumPy linear solves and
scipy.optimize-verified constrained solutions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cmfrec_tpu.ops.rowsolve import (
    SparsePart,
    assemble_system,
    length_mask,
    solve_cd,
    solve_cg,
    solve_chol,
)


def random_problem(rng, R=7, L=12, S=30, K=9, dtype=np.float64, weighted=False):
    mat = rng.normal(size=(S, K)).astype(dtype)
    idx = rng.integers(0, S, size=(R, L)).astype(np.int32)
    length = rng.integers(1, L + 1, size=R).astype(np.int32)
    val = rng.normal(size=(R, L)).astype(dtype)
    wgt = (
        rng.uniform(0.5, 2.0, size=(R, L)).astype(dtype)
        if weighted
        else np.ones((R, L), dtype)
    )
    msk = (np.arange(L)[None, :] < length[:, None]).astype(dtype)
    return mat, idx, val, wgt, msk, length


def numpy_solve(mat, idx, cw, cv, lam_vec, G0=None, r0=None, lam_mult=None):
    R, L = idx.shape
    K = mat.shape[1]
    out = np.zeros((R, K))
    for r in range(R):
        G = np.zeros((K, K))
        rhs = np.zeros(K)
        for l in range(L):
            m = mat[idx[r, l]]
            G += cw[r, l] * np.outer(m, m)
            rhs += cv[r, l] * m
        if G0 is not None:
            G += G0
        if r0 is not None:
            rhs += r0[r]
        mult = 1.0 if lam_mult is None else lam_mult[r]
        G += np.diag(lam_vec * mult)
        out[r] = np.linalg.solve(G, rhs)
    return out


class TestCholesky:
    def test_explicit_weighted(self, rng):
        mat, idx, val, wgt, msk, length = random_problem(rng, weighted=True)
        cw = wgt * msk
        cv = wgt * val * msk
        lam_vec = np.full(mat.shape[1], 0.3)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        G, rhs = assemble_system([part], jnp.array(lam_vec))
        got = np.array(solve_chol(G, rhs))
        want = numpy_solve(mat, idx, cw, cv, lam_vec)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)

    def test_with_shared_gram_and_rhs_base(self, rng):
        """NA-as-zero / implicit style: G0 = M^T M shared, per-row corrections."""
        mat, idx, val, wgt, msk, length = random_problem(rng)
        alpha = 0.7
        cw = alpha * np.abs(val) * msk  # confidence - 1
        cv = (1.0 + alpha * np.abs(val)) * msk
        G0 = mat.T @ mat
        lam_vec = np.full(mat.shape[1], 1.1)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        G, rhs = assemble_system([part], jnp.array(lam_vec), G0=jnp.array(G0))
        got = np.array(solve_chol(G, rhs))
        want = numpy_solve(mat, idx, cw, cv, lam_vec, G0=G0)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)

    def test_per_row_lambda_scaling(self, rng):
        """scale_lam: lambda multiplied by per-row observation count
        (/root/reference/src/common.c:689-724)."""
        mat, idx, val, wgt, msk, length = random_problem(rng)
        cw = msk.copy()
        cv = val * msk
        lam_vec = np.full(mat.shape[1], 0.05)
        lam_mult = length.astype(np.float64)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        G, rhs = assemble_system(
            [part], jnp.array(lam_vec), lam_mult=jnp.array(lam_mult)
        )
        got = np.array(solve_chol(G, rhs))
        want = numpy_solve(mat, idx, cw, cv, lam_vec, lam_mult=lam_mult)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)

    def test_padded_coordinates_stay_zero(self, rng):
        """K padded to tile multiples: padding coords must solve to 0."""
        mat, idx, val, wgt, msk, length = random_problem(rng, K=9)
        K_pad = 16
        mat_p = np.zeros((mat.shape[0], K_pad))
        mat_p[:, :9] = mat
        lam_vec = np.concatenate([np.full(9, 0.3), np.ones(K_pad - 9)])
        cw, cv = msk, val * msk
        part = SparsePart(
            jnp.array(mat_p), jnp.array(idx), jnp.array(cw), jnp.array(cv)
        )
        G, rhs = assemble_system([part], jnp.array(lam_vec))
        got = np.array(solve_chol(G, rhs))
        np.testing.assert_allclose(got[:, 9:], 0.0, atol=1e-12)
        want = numpy_solve(mat, idx, cw, cv, np.full(9, 0.3))
        np.testing.assert_allclose(got[:, :9], want, rtol=1e-8, atol=1e-10)


class TestCG:
    def test_converges_to_chol_solution(self, rng):
        mat, idx, val, wgt, msk, length = random_problem(rng, weighted=True)
        cw = wgt * msk
        cv = wgt * val * msk
        lam_vec = np.full(mat.shape[1], 0.3)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        a0 = jnp.array(rng.normal(size=(idx.shape[0], mat.shape[1])) * 0.1)
        got = np.array(solve_cg([part], jnp.array(lam_vec), a0, n_steps=60))
        want = numpy_solve(mat, idx, cw, cv, lam_vec)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)

    def test_truncated_cg_reduces_residual(self, rng):
        mat, idx, val, wgt, msk, length = random_problem(rng)
        cw = msk
        cv = val * msk
        lam_vec = np.full(mat.shape[1], 0.3)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        want = numpy_solve(mat, idx, cw, cv, lam_vec)
        a0 = jnp.zeros((idx.shape[0], mat.shape[1]))
        e_prev = None
        for steps in (1, 3, 6):
            got = np.array(solve_cg([part], jnp.array(lam_vec), a0, n_steps=steps))
            e = np.abs(got - want).max()
            if e_prev is not None:
                assert e < e_prev * 1.01
            e_prev = e

    def test_implicit_system_matches_chol(self, rng):
        """The WRMF CG must converge to the same fixed point as Cholesky
        (unlike the reference; see rowsolve.py module docstring)."""
        mat, idx, val, wgt, msk, length = random_problem(rng)
        alpha = 1.3
        xval = np.abs(val)
        cw = alpha * xval * msk
        cv = (1.0 + alpha * xval) * msk
        G0 = mat.T @ mat
        lam_vec = np.full(mat.shape[1], 2.0)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        a0 = jnp.array(rng.normal(size=(idx.shape[0], mat.shape[1])) * 0.05)
        got = np.array(
            solve_cg([part], jnp.array(lam_vec), a0, n_steps=50, G0=jnp.array(G0))
        )
        G, rhs = assemble_system([part], jnp.array(lam_vec), G0=jnp.array(G0))
        want = np.array(solve_chol(G, rhs))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


class TestCD:
    def test_nonneg_matches_scipy(self, rng):
        from scipy.optimize import nnls

        mat, idx, val, wgt, msk, length = random_problem(rng, R=5, K=6)
        cw = msk
        cv = val * msk
        lam_vec = np.full(6, 0.2)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        G, rhs = assemble_system([part], jnp.array(lam_vec))
        got = np.array(
            solve_cd(G, rhs, jnp.zeros(6), nonneg=True, max_steps=500)
        )
        for r in range(5):
            Gr = np.array(G[r])
            # NNLS on the square-root system: min ||L^T a - L^-1 rhs||, a>=0
            Lr = np.linalg.cholesky(Gr)
            want, _ = nnls(Lr.T, np.linalg.solve(Lr, np.array(rhs[r])))
            np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-6)

    def test_l1_soft_threshold(self, rng):
        """Elastic-net CD vs scipy.optimize.minimize on the same objective."""
        from scipy.optimize import minimize

        mat, idx, val, wgt, msk, length = random_problem(rng, R=4, K=5)
        cw, cv = msk, val * msk
        lam_vec = np.full(5, 0.1)
        l1 = np.full(5, 0.3)
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw), jnp.array(cv))
        G, rhs = assemble_system([part], jnp.array(lam_vec))
        got = np.array(solve_cd(G, rhs, jnp.array(l1), nonneg=False, max_steps=800))
        for r in range(4):
            Gr, rr = np.array(G[r]), np.array(rhs[r])
            f = lambda a: 0.5 * a @ Gr @ a - rr @ a + l1 @ np.abs(a)
            want = minimize(f, np.zeros(5), method="Powell", tol=1e-12).x
            assert f(got[r]) <= f(want) + 1e-7


    def test_per_row_l1(self, rng):
        """2-D [R, K] l1 (scale_lam x l1_lambda): each row must match a
        solo solve with that row's own scaled penalty
        (/root/reference/src/common.c:717-722)."""
        mat, idx, val, wgt, msk, length = random_problem(rng, R=6, K=5)
        cw, cv = msk, val * msk
        lam_vec = np.full(5, 0.1)
        l1_base = np.full(5, 0.25)
        mult = length.astype(np.float64)  # heterogeneous row counts
        part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw),
                          jnp.array(cv))
        G, rhs = assemble_system([part], jnp.array(lam_vec),
                                 lam_mult=jnp.array(mult))
        l1_rows = l1_base[None, :] * mult[:, None]
        got = np.array(solve_cd(G, rhs, jnp.array(l1_rows), nonneg=False,
                                max_steps=800))
        for r in range(6):
            solo = np.array(solve_cd(G[r][None], rhs[r][None],
                                     jnp.array(l1_base * mult[r]),
                                     nonneg=False, max_steps=800))[0]
            np.testing.assert_allclose(got[r], solo, rtol=1e-7, atol=1e-9)


def test_solve_bucket_scale_lam_l1(rng):
    """End-to-end: solve_bucket under scale_lam + l1 uses the PER-ROW
    multiplier, not a bucket mean (common.c:717-722)."""
    from cmfrec_tpu.solvers.als import PartData, solve_bucket

    mat, idx, val, wgt, msk, length = random_problem(rng, R=6, K=5)
    cw, cv = msk, val * msk
    lam_vec = np.full(5, 0.1)
    l1_base = np.full(5, 0.3)
    p = PartData(
        idx=jnp.array(idx), val=jnp.array(val), length=jnp.array(length),
        wgt=None, opp=jnp.array(mat), opp_bias=None,
        w=jnp.asarray(1.0, jnp.float64), alpha=None, mu=None,
    )
    got = np.array(solve_bucket(
        (p,), None, None, None, None, jnp.array(lam_vec), None,
        jnp.array(l1_base), modes=("explicit",), method="chol", n_steps=0,
        nonneg=False, max_cd_steps=800, scale_lam=True,
        n_totals=(mat.shape[0],),
    ))
    part = SparsePart(jnp.array(mat), jnp.array(idx), jnp.array(cw),
                      jnp.array(cv))
    mult = np.maximum(length.astype(np.float64), 1.0)
    G, rhs = assemble_system([part], jnp.array(lam_vec),
                             lam_mult=jnp.array(mult))
    for r in range(6):
        solo = np.array(solve_cd(G[r][None], rhs[r][None],
                                 jnp.array(l1_base * mult[r]),
                                 nonneg=False, max_steps=800))[0]
        np.testing.assert_allclose(got[r], solo, rtol=1e-7, atol=1e-9)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
