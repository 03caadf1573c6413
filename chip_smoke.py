"""Smoke test of the CMF fit and serving path on NVIDIA GPUs.

    python chip_smoke.py          # one card: kernels, fits and serving
    python chip_smoke.py --multi  # four cards: the mesh fits only

Drives the system's main path through its public API at the reference
benchmark's shapes (an ML10M-shaped explicit model; implicit models at the
ML10M shape, on the fused dense engine, and at the LastFM-360K shape, on
the bucketed engine; all data generated from a seed), and checks every
result against a plain reference.  Prints the card's name and power limit, then, as its
last line,

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

A failed check raises, so the exit code is non-zero and that line is never
printed.  Without a GPU it stops at the device check.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ML10M_SHAPE, ML10M_NNZ = (69878, 10677), 10_000_054
LASTFM_SHAPE, LASTFM_NNZ = (359347, 160168), 17_000_000
FLAGSHIP = dict(k=50, lambda_=0.05, scale_lam=True, niter=15, use_cg=True,
                finalize_chol=True)
# Held-out RMSE must beat the global mean by more than this.  The ML10M-
# shaped generator's rating noise (sd 0.7, half-point rounding) floors the
# held-out RMSE near 0.71 against a global-mean RMSE near 0.945, so no fit
# can gain much more than 25%; biases alone gain ~12%, the factors the rest.
RMSE_GAIN = 0.20
RMSE_TOL = 1e-3  # ... and match the plain reference fit within this
TOL = {"bfloat16": 1e-2, "float32": 1e-5}  # kernel parity, relative Frobenius


class CheckFailed(Exception):
    pass


def check(ok, what):
    print(f"  [{'ok' if ok else 'FAILED'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


class EngineLog:
    """Records which fused dense engine entry points a fit called."""

    NAMES = ("fit_explicit_dense_pallas", "fit_collective_dense_pallas",
             "fit_implicit_dense_pallas",
             "fit_collective_implicit_dense_pallas")

    def __init__(self):
        from cmfrec_tpu.solvers import dense_pallas

        self.calls = []
        for name in self.NAMES:
            fn = getattr(dense_pallas, name)
            setattr(dense_pallas, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self.calls.append((name, kwargs.get("exact", False)))
            return fn(*args, **kwargs)
        return wrapper

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def section(title):
    print(f"\n== {title}", flush=True)


# --------------------------------------------------------------------- #
# 1. device                                                              #
# --------------------------------------------------------------------- #


def device_check(need):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise CheckFailed(f"no GPU: JAX's first device is on "
                          f"{devices[0].platform!r}")
    if len(devices) < need:
        raise CheckFailed(f"{need} GPUs needed, JAX finds {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    for line in smi.strip().splitlines():
        print(f"card: {line}")
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    return devices


# --------------------------------------------------------------------- #
# 2. kernels                                                             #
# --------------------------------------------------------------------- #


def _time_ms(f, *args, reps=20):
    """Median per-call milliseconds of `reps` chained calls in one jit
    (each call's first operand depends on the previous call's output)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(q, *rest):
        def body(_, q):
            tie = 1e-30 * jnp.sum(f(q, *rest))
            return (q.astype(jnp.float32) + tie).astype(q.dtype)
        return jax.lax.fori_loop(0, reps, body, q)

    chain(*args).block_until_ready()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        chain(*args).block_until_ready()
        times.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(times))


def _xla_matvec(Q, Be, W):
    """What XLA makes of the plain masked-Gram product, same dtypes."""
    import jax
    import jax.numpy as jnp

    T = jnp.einsum("rk,sk->rs", Q, Be, preferred_element_type=jnp.float32)
    T = (T * W.astype(jnp.float32)).astype(Q.dtype)
    return jnp.einsum("rs,sk->rk", T, Be, preferred_element_type=jnp.float32)


def _xla_rhs(Be, X, W, mb):
    import jax.numpy as jnp

    V = (X.astype(jnp.float32) - mb[None, :]) * W.astype(jnp.float32)
    return jnp.einsum("rs,sk->rk", V.astype(Be.dtype), Be,
                      preferred_element_type=jnp.float32)


def kernel_parity(m, n, k, density):
    """Each kernel against the plain f32 product at Precision.HIGHEST, in
    both orientations of an [m, n] problem, int8, bf16 and f32 weights
    (the engines pass int8 masks, the implicit engine's bf16 confidences
    and f32 weights), bf16 and f32 operands; and the kernel's time beside
    XLA's plain version."""
    import jax
    import jax.numpy as jnp

    from cmfrec_tpu.ops.masked_matmul import (
        masked_gram_matvec, masked_rhs, pad_dim, pad_k)

    hi = jax.lax.Precision.HIGHEST
    mp, np_, K = pad_dim(m), pad_dim(n), pad_k(k + 1)
    print(f"padded [{m}, {n}] -> [{mp}, {np_}], K={K}")
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    W8 = (jax.random.uniform(k1, (mp, np_)) < density).astype(jnp.int8)
    A = jax.random.normal(k2, (mp, K), jnp.float32)
    B = jax.random.normal(k3, (np_, K), jnp.float32)

    def rel(out, ref):
        return float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))

    for side, (Q, Be, W) in (("R=m", (A, B, W8)), ("R=n", (B, A, W8.T))):
        R, S = W.shape
        X = ((jnp.round(jax.random.uniform(k4, (R, S)) * 9) + 1) / 2
             ).astype(jnp.bfloat16)
        mb = jax.random.normal(k4, (S,), jnp.float32)
        for wname in ("int8", "bfloat16", "float32"):
            Wx = W.astype(wname)
            ref = jnp.einsum("rs,sk->rk",
                             jnp.einsum("rk,sk->rs", Q, Be, precision=hi)
                             * Wx.astype(jnp.float32), Be, precision=hi)
            ref_rhs = jnp.einsum("rs,sk->rk", (X.astype(jnp.float32)
                                               - mb[None, :]) * Wx, Be,
                                 precision=hi)
            for dt in ("bfloat16", "float32"):
                Qd, Bd = Q.astype(dt), Be.astype(dt)
                err = rel(masked_gram_matvec(Qd, Bd, Wx), ref)
                check(err <= TOL[dt],
                      f"masked_gram_matvec {side} W={wname} ops={dt}: "
                      f"err {err:.3e} <= {TOL[dt]}")
                err = rel(masked_rhs(X, Wx, mb, Bd), ref_rhs)
                check(err <= TOL[dt],
                      f"masked_rhs {side} W={wname} ops={dt}: "
                      f"err {err:.3e} <= {TOL[dt]}")
            del ref, ref_rhs
            # the f32 operands run XLA's own products (no kernel to time)
            Qb, Bb = Q.astype(jnp.bfloat16), Be.astype(jnp.bfloat16)
            tk = _time_ms(masked_gram_matvec, Qb, Bb, Wx)
            tx = _time_ms(_xla_matvec, Qb, Bb, Wx)
            print(f"  masked_gram_matvec {side} W={wname} bf16: kernel "
                  f"{tk:.3f} ms, XLA {tx:.3f} ms")
            rk = _time_ms(lambda be, x, w, b: masked_rhs(x, w, b, be),
                          Bb, X, Wx, mb)
            rx = _time_ms(_xla_rhs, Bb, X, Wx, mb)
            print(f"  masked_rhs {side} W={wname} bf16: kernel {rk:.3f} ms, "
                  f"XLA {rx:.3f} ms")
        del X
    jax.clear_caches()


# --------------------------------------------------------------------- #
# 3-5. explicit fits                                                     #
# --------------------------------------------------------------------- #


def explicit_data():
    import scipy.sparse as sp

    import bench

    m, n = ML10M_SHAPE
    t0 = time.perf_counter()
    rows, cols, vals = bench.make_ml10m_shaped(seed=0)
    test = np.random.default_rng(1).uniform(size=rows.size) < 0.05
    X = sp.coo_matrix((vals[~test], (rows[~test], cols[~test])),
                      shape=(m, n))
    print(f"ML10M-shaped data: {m} x {n}, {rows.size} ratings "
          f"({int(test.sum())} held out), {time.perf_counter() - t0:.1f}s")
    held = (rows[test], cols[test], vals[test])
    baseline = float(np.sqrt(np.mean((held[2] - vals[~test].mean()) ** 2)))
    return X, held, baseline


def rmse_of(res, held):
    """Held-out RMSE of a fit driver's result dict."""
    r, c, v = held
    A, B = np.asarray(res["A"], np.float64), np.asarray(res["B"], np.float64)
    pred = res["glob_mean"] + np.einsum("ek,ek->e", A[r], B[c])
    if res.get("biasA") is not None:
        pred += np.asarray(res["biasA"])[r]
    if res.get("biasB") is not None:
        pred += np.asarray(res["biasB"])[c]
    return float(np.sqrt(np.mean((pred - v) ** 2)))


def model_rmse(model, held):
    r, c, v = held
    return float(np.sqrt(np.mean((model.predict(r, c) - v) ** 2)))


def timed_fit(make, X, **fit_kw):
    import jax

    t0 = time.perf_counter()
    model = make().fit(X, **fit_kw)
    jax.block_until_ready((model.A_, model.B_))
    return model, time.perf_counter() - t0


def explicit_fit(X, held, baseline, log, ref_rmse, label, expect, **kw):
    """Fit cold and warm through CMF.fit, check the engine and quality."""
    from cmfrec_tpu import CMF

    make = functools.partial(CMF, **{**FLAGSHIP, **kw})
    model, cold = timed_fit(make, X)
    calls = log.take()
    model, warm = timed_fit(make, X)
    log.take()
    rmse = model_rmse(model, held)
    print(f"{label}: engine {calls}, cold {cold:.2f}s, warm {warm:.3f}s, "
          f"held-out RMSE {rmse:.5f} (global mean {baseline:.5f}, "
          f"plain reference {ref_rmse:.5f})")
    check(calls == [expect], f"{label} ran on {expect}")
    check(rmse < (1 - RMSE_GAIN) * baseline,
          f"{label} RMSE beats the global mean by > {RMSE_GAIN:.0%}")
    check(abs(rmse - ref_rmse) <= RMSE_TOL,
          f"{label} RMSE within {RMSE_TOL} of the plain reference "
          f"(|diff| {abs(rmse - ref_rmse):.2e})")
    return model


def reference_fit(X, held, log):
    """The plain reference: the same flagship fit on the XLA dense engine,
    f32 at Precision.HIGHEST, same seed (the fused engine switched off)."""
    from cmfrec_tpu import CMF

    with env(CMFREC_TPU_NO_PALLAS="1"):
        model, secs = timed_fit(functools.partial(CMF, **FLAGSHIP), X)
    check(not log.take(), "reference fit stayed off the fused engine")
    rmse = model_rmse(model, held)
    print(f"plain reference (XLA dense engine, f32, HIGHEST): {secs:.2f}s, "
          f"held-out RMSE {rmse:.5f}")
    return rmse


# --------------------------------------------------------------------- #
# 6. implicit                                                            #
# --------------------------------------------------------------------- #


def implicit_fit(log, shape, nnz, expect):
    """CMF_implicit(k=50), 3 iterations, on topic-structured play counts of
    the given shape; checks the engine, finite factors, and held-out P@10
    against the popularity ranking."""
    import jax
    import scipy.sparse as sp

    import bench_implicit
    from cmfrec_tpu import CMF_implicit

    m, n = shape
    t0 = time.perf_counter()
    rows, cols, vals = bench_implicit.make_lastfm_shaped(seed=0, m=m, n=n,
                                                         nnz=nnz)
    tr_r, tr_c, tr_v, te_r, te_c, users = bench_implicit.split_heldout(
        rows, cols, vals, m)
    X = sp.coo_matrix((tr_v, (tr_r, tr_c)), shape=(m, n))
    print(f"data: {m} x {n}, {rows.size} plays, "
          f"{time.perf_counter() - t0:.1f}s")
    make = functools.partial(CMF_implicit, k=50, niter=3)
    model, cold = timed_fit(make, X)
    calls = log.take()
    engine = calls or "bucketed gather engine"
    if expect:
        model, warm = timed_fit(make, X)
        log.take()
        print(f"implicit WRMF k=50, 3 iterations: engine {engine}, cold "
              f"{cold:.2f}s, warm {warm:.3f}s")
    else:
        print(f"implicit WRMF k=50, 3 iterations: engine {engine}, "
              f"{cold:.2f}s (cold)")
    where = expect or "the bucketed engine (over the dense budget)"
    check(calls == expect, f"implicit fit ran on {where}")
    A, B = np.asarray(model.A_), np.asarray(model.B_)
    check(A.shape == (m, 50) and B.shape == (n, 50), "factor shapes")
    check(np.isfinite(A).all() and np.isfinite(B).all(), "factors finite")
    p10, map10, p10_pop = bench_implicit.ranking_quality(
        A, B, tr_r, tr_c, te_r, te_c, users, n)
    check(p10 > p10_pop, f"P@10 {p10:.4f} beats popularity {p10_pop:.4f} "
          f"(MAP@10 {map10:.4f})")
    del model, X
    jax.clear_caches()


# --------------------------------------------------------------------- #
# 7. serving                                                             #
# --------------------------------------------------------------------- #


def serving(model, X):
    import scipy.sparse as sp

    m, n = X.shape
    rng = np.random.default_rng(2)
    A = np.asarray(model.A_, np.float32)
    B = np.asarray(model.B_, np.float32)
    bA = np.asarray(model.user_bias_, np.float32)
    bB = np.asarray(model.item_bias_, np.float32)
    mu = np.float32(model.glob_mean_)

    users = rng.choice(m, 256, replace=False)
    model.topN(int(users[0]), n=10)  # compile
    t0 = time.perf_counter()
    tops = [np.asarray(model.topN(int(u), n=10)) for u in users]
    secs = time.perf_counter() - t0
    worst = 0.0
    for u, top in zip(users, tops):
        scores = mu + bA[u] + bB + B @ A[u]
        host = np.argsort(-scores, kind="stable")[:10]
        tenth = scores[host[-1]]
        diff = np.setxor1d(top, host)
        worst = max(worst, float(np.max(np.abs(scores[diff] - tenth),
                                        initial=0.0)))
    check(worst <= 1e-5, f"topN for 256 users ({secs * 1e3 / 256:.2f} ms "
          f"each): top-10 sets equal the host argsort (ties within 1e-5; "
          f"worst {worst:.1e})")

    pu = rng.integers(0, m, 1_000_000)
    pi = rng.integers(0, n, 1_000_000)
    model.predict(pu[:10], pi[:10])
    t0 = time.perf_counter()
    pred = model.predict(pu, pi)
    secs = time.perf_counter() - t0
    host = (np.float64(mu) + bA[pu] + bB[pi]
            + np.einsum("ek,ek->e", A[pu].astype(np.float64), B[pi]))
    err = float(np.max(np.abs(pred - host)))
    check(err <= 1e-4, f"predict on 1M pairs ({secs:.3f}s): max |error| "
          f"{err:.1e} <= 1e-4")

    Xr = X.tocsr()
    new = Xr[users]
    new.sort_indices()
    t0 = time.perf_counter()
    a, bias = model.factors_multiple(new, return_bias=True)
    secs = time.perf_counter() - t0
    lam = float(model.lambda_)
    Be = np.hstack([B.astype(np.float64), np.ones((n, 1))])
    worst = 0.0
    for i in range(len(users)):
        lo, hi_ = new.indptr[i], new.indptr[i + 1]
        cols_u, x = new.indices[lo:hi_], new.data[lo:hi_]
        E = Be[cols_u]
        G = E.T @ E + lam * max(len(cols_u), 1) * np.eye(Be.shape[1])
        ref = np.linalg.solve(G, E.T @ (x - mu - bB[cols_u]))
        got = np.append(np.asarray(a[i], np.float64), float(bias[i]))
        worst = max(worst, float(np.linalg.norm(got - ref)
                                 / max(np.linalg.norm(ref), 1e-12)))
    check(np.isfinite(a).all() and worst <= 1e-3,
          f"warm factors for 256 users ({secs:.3f}s): within 1e-3 relative "
          f"of the host solve (worst {worst:.1e})")
    i = int(np.argmax(np.diff(new.indptr) > 0))
    one = model.factors_warm(X_col=new[i].indices, X_val=new[i].data)
    check(np.allclose(one, a[i], rtol=1e-4, atol=1e-5),
          "factors_warm of one user equals its batched row")


# --------------------------------------------------------------------- #
# four cards                                                             #
# --------------------------------------------------------------------- #


def multi(X, held, n_dev):
    """The mesh fits against the same fits on one card: the fused dense
    engine (shard_map around the kernels), the bucketed engine, and the
    ring-sharded bucketed engine."""
    from cmfrec_tpu.parallel.mesh import make_mesh
    from cmfrec_tpu.solvers.drivers import fit_explicit_als

    mesh = make_mesh(n_dev)
    log = EngineLog()
    coo = X.tocoo()
    tri = (coo.row.astype(np.int64), coo.col.astype(np.int64),
           coo.data.astype(np.float64), X.shape[0], X.shape[1])
    fused = [("fit_explicit_dense_pallas", False)]
    runs = (
        ("fused dense engine", dict(FLAGSHIP), fused),
        ("bucketed engine", dict(FLAGSHIP, engine="sparse"), []),
        ("ring-sharded bucketed engine",
         dict(FLAGSHIP, use_cg=False, shard_opposing_rows=True), []),
    )
    for label, kw, expect in runs:
        one_kw = {k: v for k, v in kw.items() if k != "shard_opposing_rows"}
        if "shard_opposing_rows" in kw:
            one_kw["engine"] = "sparse"
        t0 = time.perf_counter()
        rmse_1 = rmse_of(fit_explicit_als(*tri, **one_kw), held)
        t1 = time.perf_counter()
        calls_1 = log.take()
        rmse_n = rmse_of(fit_explicit_als(*tri, mesh=mesh, **kw), held)
        t2 = time.perf_counter()
        calls_n = log.take()
        print(f"{label}: 1 card RMSE {rmse_1:.5f} ({t1 - t0:.1f}s cold), "
              f"{n_dev} cards RMSE {rmse_n:.5f} ({t2 - t1:.1f}s cold)")
        check(calls_1 == expect and calls_n == expect,
              f"{label} ran on 1 and {n_dev} cards (fused engine calls "
              f"{calls_1} and {calls_n})")
        check(abs(rmse_n - rmse_1) <= RMSE_TOL,
              f"{label} on {n_dev} cards matches one card within "
              f"{RMSE_TOL} (|diff| {abs(rmse_n - rmse_1):.2e})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card mesh fits")
    args = parser.parse_args()

    from cmfrec_tpu.config import enable_persistent_compilation_cache

    cache = enable_persistent_compilation_cache()
    section("device")
    n_dev = 4 if args.multi else 1
    devices = device_check(n_dev)
    print(f"compilation cache: {cache}")

    if args.multi:
        section(f"mesh fits on {n_dev} cards")
        X, held, _ = explicit_data()
        multi(X, held, n_dev)
    else:
        m, n = ML10M_SHAPE
        section("kernel parity at the ML10M shape")
        kernel_parity(m, n, FLAGSHIP["k"], density=1e7 / (m * n))
        log = EngineLog()
        section("explicit fits (CMF, k=50, 15 iterations)")
        X, held, baseline = explicit_data()
        ref = reference_fit(X, held, log)
        model = explicit_fit(X, held, baseline, log, ref,
                             "explicit ALS-CG + finalize",
                             ("fit_explicit_dense_pallas", False))
        explicit_fit(X, held, baseline, log, ref, "exact mode (use_cg=False)",
                     ("fit_explicit_dense_pallas", True), use_cg=False)
        explicit_fit(X, held, baseline, log, ref,
                     "collective, add_implicit_features=True",
                     ("fit_collective_dense_pallas", False),
                     add_implicit_features=True)
        section("serving on the explicit model")
        serving(model, X)
        del model
        section("implicit WRMF at the ML10M shape")
        implicit_fit(log, ML10M_SHAPE, ML10M_NNZ,
                     [("fit_implicit_dense_pallas", False)])
        section("implicit WRMF at the LastFM-360K shape")
        implicit_fit(log, LASTFM_SHAPE, LASTFM_NNZ, [])

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    sys.exit(main())
