"""Serving-path benchmark: batched topN, batch predict, batched warm
factors on the fitted flagship model — head-to-head against the REAL
reference binary's serving routines (topN_old_collective_explicit
/root/reference/src/common.c:5127 via collective.c, predict_X_old
collective.c:11797, factors_collective_explicit_multiple
collective.c:10865), timed through tests/ref_binary.py's ctypes harness
at the same shapes.

The reference serves one query per call (OpenMP gemv + argpartition);
the device path batches queries into one fused matmul + top_k dispatch
(ops/predict.py), so the comparison is throughput (queries/s), each side
driven the way its API is meant to be used.  The timed loops deliberately
let batches PIPELINE on device (repeat dispatches, one trailing fence) —
that is serving semantics, not a latency microbenchmark, hence the
*_pipelined naming; CLAUDE.md's chain-the-dependencies rule is for
latency measurements.  Run standalone
(`python bench_serving.py`, fits nothing — random factors at flagship
shape) or embedded by bench.py with the actually-fitted model.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

N_TOP = 10
Q_TOPN = 1024          # users per batched topN dispatch
NB_TOPN = 8            # batches timed
Q_REF_TOPN = 64        # reference topN calls timed (extrapolated to qps)
N_PRED = 2_000_000     # batch-predict pairs
Q_WARM = 8192          # users per warm-factors batch (degree-grouped)
Q_REF_WARM = 256


def _ref():
    """The reference binary harness, or None (bench still reports ours)."""
    try:
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        import ref_binary

        if ref_binary.get_lib() is None:
            return None
        return ref_binary
    except Exception as e:  # noqa: BLE001 - bench must not die on this
        print(f"serving: reference binary unavailable ({e!r})",
              file=sys.stderr)
        return None


def run(res, tr_rows, tr_cols, tr_vals, m, n, k):
    """Time the serving paths on a fitted model result dict (A, B, biasA,
    biasB, glob_mean) and return the record for bench.py's JSON."""
    import jax
    import jax.numpy as jnp

    from cmfrec_tpu.ops.predict import predict_pairs

    rng = np.random.default_rng(7)
    A = np.asarray(res["A"], np.float32)
    B = np.asarray(res["B"], np.float32)
    biasA = (np.zeros(m, np.float32) if res.get("biasA") is None
             else np.asarray(res["biasA"], np.float32))
    biasB = (np.zeros(n, np.float32) if res.get("biasB") is None
             else np.asarray(res["biasB"], np.float32))
    glob_mean = float(res.get("glob_mean", 0.0))

    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    biasAj, biasBj = jnp.asarray(biasA), jnp.asarray(biasB)

    def fence(x):
        jax.block_until_ready(x)

    out = {}

    # ---- batched topN (exclude each user's train items) -----------------
    users = rng.choice(m, size=Q_TOPN, replace=False)
    u_index = {u: i for i, u in enumerate(users)}
    sel = np.isin(tr_rows, users)
    ex_u = np.fromiter((u_index[u] for u in tr_rows[sel]), np.int64,
                       sel.sum())
    ex_i = tr_cols[sel].astype(np.int64)

    @jax.jit
    def topn_batch(Au, bAu, Bm, bB, ex_u, ex_i):
        scores = Au @ Bm.T + bB[None, :] + bAu[:, None] + glob_mean
        scores = scores.at[ex_u, ex_i].set(-jnp.inf)
        vals, idx = jax.lax.top_k(scores, N_TOP)
        return idx, vals

    args = (Aj[jnp.asarray(users)], biasAj[jnp.asarray(users)], Bj, biasBj,
            jnp.asarray(ex_u), jnp.asarray(ex_i))
    idx, _vals = topn_batch(*args)   # compile + warm
    _ = fence(idx)
    idx, _vals = topn_batch(*args)
    _ = fence(idx)
    t0 = time.time()
    for _ in range(NB_TOPN):
        idx, _vals = topn_batch(*args)
    _ = fence(idx)
    el = time.time() - t0
    out["topn_qps"] = round(NB_TOPN * Q_TOPN / el, 1)
    out["topn_batch_ms_pipelined"] = round(1e3 * el / NB_TOPN, 2)

    ref = _ref()
    if ref is not None:
        # reference: one call per user, exclude list per user, f64 model
        A64, B64 = A.astype(np.float64), B.astype(np.float64)
        bB64 = biasB.astype(np.float64)
        ex_by_u = {}
        for u, i in zip(ex_u[:200000], ex_i[:200000]):
            ex_by_u.setdefault(int(u), []).append(int(i))
        t0 = time.time()
        for q in range(Q_REF_TOPN):
            exc = np.asarray(ex_by_u.get(q, []), np.int32)
            ref.ref_topn_old_collective_explicit(
                a_vec=A64[users[q]], a_bias=float(biasA[users[q]]),
                B=B64, biasB=bB64, glob_mean=glob_mean, k=k,
                n_top=N_TOP, n=n,
                exclude=exc if exc.size else None)
        el_ref = time.time() - t0
        out["topn_qps_ref_binary"] = round(Q_REF_TOPN / el_ref, 1)
        out["topn_vs_binary"] = round(
            out["topn_qps"] / out["topn_qps_ref_binary"], 2)

    # ---- batch predict ---------------------------------------------------
    pr = rng.integers(0, m, N_PRED)
    pc = rng.integers(0, n, N_PRED)
    prj, pcj = jnp.asarray(pr), jnp.asarray(pc)
    p = predict_pairs(Aj, Bj, prj, pcj, biasAj, biasBj, glob_mean)
    _ = fence(p)
    t0 = time.time()
    for _ in range(4):
        p = predict_pairs(Aj, Bj, prj, pcj, biasAj, biasBj, glob_mean)
    _ = fence(p)
    el = time.time() - t0
    out["predict_pairs_per_s"] = round(4 * N_PRED / el)

    if ref is not None:
        t0 = time.time()
        ref.ref_predict_X_old_collective_explicit(
            row=pr[:N_PRED // 4], col=pc[:N_PRED // 4],
            A=A.astype(np.float64), B=B.astype(np.float64),
            biasA=biasA.astype(np.float64), biasB=biasB.astype(np.float64),
            glob_mean=glob_mean, k=k, m=m, n_max=n)
        el_ref = time.time() - t0
        out["predict_pairs_per_s_ref_binary"] = round(
            (N_PRED // 4) / el_ref)
        out["predict_vs_binary"] = round(
            out["predict_pairs_per_s"]
            / out["predict_pairs_per_s_ref_binary"], 2)

    # ---- batched warm factors (closed-form ridge per user, degree-
    # grouped so power-law batches don't pad to the max degree) ----------
    from cmfrec_tpu.models.cmf import CMF
    from cmfrec_tpu.solvers.warm import factors_explicit_grouped

    wusers = rng.choice(m, size=Q_WARM, replace=False)
    w_index = {u: i for i, u in enumerate(wusers)}
    selw = np.isin(tr_rows, wusers)
    wr = np.fromiter((w_index[u] for u in tr_rows[selw]), np.int64,
                     selw.sum())
    wc, wv = tr_cols[selw], tr_vals[selw]

    model = CMF.from_model_matrices(
        A=A, B=B, glob_mean=glob_mean, user_bias=biasA, item_bias=biasB,
        lambda_=res.get("lambda_", 10.0), precompute=True)

    a, bias = factors_explicit_grouped(model, wr, wc, wv, None, Q_WARM)
    t0 = time.time()
    for _ in range(4):
        a, bias = factors_explicit_grouped(model, wr, wc, wv, None, Q_WARM)
    _ = float(np.sum(a))
    el = time.time() - t0
    out["warm_factors_users_per_s"] = round(4 * Q_WARM / el)

    if ref is not None:
        sub = wr < Q_REF_WARM
        t0 = time.time()
        ref.ref_factors_collective_explicit_multiple(
            m_new=Q_REF_WARM, rows=wr[sub], cols=wc[sub], vals=wv[sub],
            n=n, B=B.astype(np.float64), k=k,
            lam=float(res.get("lambda_", 10.0)),
            biasB=biasB.astype(np.float64), glob_mean=glob_mean,
            user_bias=True)
        el_ref = time.time() - t0
        out["warm_factors_users_per_s_ref_binary"] = round(
            Q_REF_WARM / el_ref)
        out["warm_vs_binary"] = round(
            out["warm_factors_users_per_s"]
            / out["warm_factors_users_per_s_ref_binary"], 2)

    return out


def run_implicit(tr_rows, tr_cols, tr_vals, m, n, k=50, lam=5.0,
                 alpha=1.0, seed=11):
    """Implicit (WRMF) serving at LastFM scale: batched topN over the
    full 160k-item catalog and degree-grouped warm factors, head-to-head
    against topN_old_collective_implicit (cmfrec.h:2117) and
    factors_collective_implicit_multiple (collective.c:11176).  Factor
    values are random at the model's shapes — serving throughput does not
    depend on them."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    A = (0.3 * rng.normal(size=(m, k))).astype(np.float32)
    B = (0.3 * rng.normal(size=(n, k))).astype(np.float32)
    Bj = jnp.asarray(B)

    def fence(x):
        jax.block_until_ready(x)

    out = {}
    Q = 256  # users per dispatch: scores are Q x n = 256 x 160k f32
    users = rng.choice(m, size=Q, replace=False)
    u_index = {u: i for i, u in enumerate(users)}
    sel = np.isin(tr_rows, users)
    ex_u = np.fromiter((u_index[u] for u in tr_rows[sel]), np.int64,
                       sel.sum())
    ex_i = tr_cols[sel].astype(np.int64)

    @jax.jit
    def topn_batch(Au, Bm, ex_u, ex_i):
        scores = Au @ Bm.T
        scores = scores.at[ex_u, ex_i].set(-jnp.inf)
        vals, idx = jax.lax.top_k(scores, N_TOP)
        return idx, vals

    args = (jnp.asarray(A[users]), Bj, jnp.asarray(ex_u), jnp.asarray(ex_i))
    idx, _ = topn_batch(*args)
    _ = fence(idx)
    idx, _ = topn_batch(*args)
    _ = fence(idx)
    t0 = time.time()
    for _ in range(NB_TOPN):
        idx, _ = topn_batch(*args)
    _ = fence(idx)
    el = time.time() - t0
    out["topn_qps"] = round(NB_TOPN * Q / el, 1)
    out["topn_batch_ms_pipelined"] = round(1e3 * el / NB_TOPN, 2)

    ref = _ref()
    if ref is not None:
        A64, B64 = A.astype(np.float64), B.astype(np.float64)
        ex_by_u = {}
        for u, i in zip(ex_u[:100000], ex_i[:100000]):
            ex_by_u.setdefault(int(u), []).append(int(i))
        n_ref = 16  # each call scans the full 160k catalog
        t0 = time.time()
        for q in range(n_ref):
            exc = np.asarray(ex_by_u.get(q, []), np.int32)
            ref.ref_topn_old_collective_implicit(
                a_vec=A64[users[q]], B=B64, k=k, n_top=N_TOP, n=n,
                exclude=exc if exc.size else None)
        el_ref = time.time() - t0
        out["topn_qps_ref_binary"] = round(n_ref / el_ref, 1)
        out["topn_vs_binary"] = round(
            out["topn_qps"] / out["topn_qps_ref_binary"], 2)

    # warm implicit factors, degree-grouped
    from cmfrec_tpu.models.cmf import CMF_implicit
    from cmfrec_tpu.solvers.warm import factors_implicit_grouped

    Qw = 2048
    wusers = rng.choice(m, size=Qw, replace=False)
    w_index = {u: i for i, u in enumerate(wusers)}
    selw = np.isin(tr_rows, wusers)
    wr = np.fromiter((w_index[u] for u in tr_rows[selw]), np.int64,
                     selw.sum())
    wc, wv = tr_cols[selw], tr_vals[selw]

    model = CMF_implicit.from_model_matrices(
        A=A, B=B, lambda_=lam, alpha=alpha, precompute=True)

    a = factors_implicit_grouped(model, wr, wc, wv, Qw)
    t0 = time.time()
    for _ in range(4):
        a = factors_implicit_grouped(model, wr, wc, wv, Qw)
    _ = float(np.sum(a))
    el = time.time() - t0
    out["warm_factors_users_per_s"] = round(4 * Qw / el)

    if ref is not None:
        qr = 128
        sub = wr < qr
        t0 = time.time()
        ref.ref_factors_collective_implicit_multiple(
            m_new=qr, rows=wr[sub], cols=wc[sub], vals=wv[sub],
            n=n, B=B.astype(np.float64), k=k, lam=lam, alpha=alpha)
        el_ref = time.time() - t0
        out["warm_factors_users_per_s_ref_binary"] = round(qr / el_ref)
        out["warm_vs_binary"] = round(
            out["warm_factors_users_per_s"]
            / out["warm_factors_users_per_s_ref_binary"], 2)
    return out


def main():
    """Standalone: random factors at the flagship (ML10M) shape."""
    from cmfrec_tpu.config import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    rng = np.random.default_rng(0)
    m, n, k = 69878, 10677, 50
    from bench import _cached, make_ml10m_shaped

    rows, cols, vals = _cached(make_ml10m_shaped, "ml10m.npz")
    res = {
        "A": 0.3 * rng.normal(size=(m, k)).astype(np.float32),
        "B": 0.3 * rng.normal(size=(n, k)).astype(np.float32),
        "biasA": 0.1 * rng.normal(size=m).astype(np.float32),
        "biasB": 0.1 * rng.normal(size=n).astype(np.float32),
        "glob_mean": 3.5, "lambda_": 10.0,
    }
    print(json.dumps(run(res, rows, cols, vals, m, n, k)))


if __name__ == "__main__":
    main()
