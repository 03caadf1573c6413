"""Implicit-feedback benchmark: WRMF ALS-CG fit, LastFM-360K-shaped data.

Mirrors the reference's implicit benchmark protocol (BASELINE.md /
/root/reference/benchmark/README.md:69-104: LastFM-360K, k=50, lambda=5,
alpha=1, 15 ALS-CG iterations -> 31.9 s on a Ryzen 2700, P@10 0.16969).
No datasets ship in this environment, so the data is synthetic with
LastFM's shape (359347 x 160168, ~17M plays) and a TOPIC-STRUCTURED
generative model: each user mixes over latent topics, each topic ranks
items by its own Zipf permutation.  That gives the data real preference
structure, so ranking quality (P@10 / MAP@10 vs the popularity baseline)
is measurable — a uniform-popularity mask would carry no signal.

Prints ONE JSON line like bench.py: fit seconds as the headline metric,
with p_at_10 / p_at_10_popularity / map_at_10 in "extra".
Run separately from the headline benchmark: `python bench_implicit.py`.
"""

import json
import sys
import time

import numpy as np

BASELINE_S = 31.9  # benchmark/README.md:90 — ALS-CG k=50, Python
N_TOPICS = 12
N_TEST_USERS = 2000
TOPN = 10


def make_lastfm_shaped(seed=0, m=359347, n=160168, nnz=17_000_000):
    """Topic-mixture play counts with LastFM-360K margins.

    user ~ Zipf(0.4); each user has a Dirichlet-ish 2-topic mixture;
    item | topic ~ Zipf(0.9) through the topic's own item permutation.
    Play counts are Pareto like real listening data.
    """
    rng = np.random.default_rng(seed)
    item_p = 1.0 / np.arange(1, n + 1) ** 0.9
    item_p /= item_p.sum()
    user_p = 1.0 / np.arange(1, m + 1) ** 0.4
    user_p /= user_p.sum()

    # per-user topic mixture: a primary topic (80%) + a secondary (20%)
    prim = rng.integers(0, N_TOPICS, m)
    sec = (prim + 1 + rng.integers(0, N_TOPICS - 1, m)) % N_TOPICS
    # per-topic item permutation: topic t's "taste ranking" of all items
    perms = np.stack([rng.permutation(n) for _ in range(N_TOPICS)])

    draw = int(nnz * 1.15)
    rows = rng.choice(m, size=draw, p=user_p)
    use_sec = rng.uniform(size=draw) < 0.2
    topic = np.where(use_sec, sec[rows], prim[rows])
    rank = rng.choice(n, size=draw, p=item_p)  # Zipf rank within the topic
    cols = perms[topic, rank]
    pairs = np.unique(rows.astype(np.int64) * n + cols)
    rng.shuffle(pairs)
    pairs = pairs[:nnz]
    rows = (pairs // n).astype(np.int64)
    cols = (pairs % n).astype(np.int64)
    vals = np.maximum(1.0, rng.pareto(1.2, rows.size) * 10)
    return rows, cols, vals


def split_heldout(rows, cols, vals, m, seed=1):
    """Leave-20%-out for a sample of test users (the reference protocol
    evaluates P@10 on users' held-out items,
    /root/reference/benchmark/README.md:69)."""
    rng = np.random.default_rng(seed)
    counts = np.bincount(rows, minlength=m)
    eligible = np.nonzero(counts >= 10)[0]
    test_users = rng.choice(eligible, size=min(N_TEST_USERS, eligible.size),
                            replace=False)
    is_tu = np.zeros(m, bool)
    is_tu[test_users] = True
    cand = is_tu[rows] & (rng.uniform(size=rows.size) < 0.2)
    test_mask = cand
    train = ~test_mask
    return (rows[train], cols[train], vals[train],
            rows[test_mask], cols[test_mask], test_users)


def ranking_quality(A, B, tr_rows, tr_cols, te_rows, te_cols, test_users, n):
    """P@10 and MAP@10 on device: one batched matmul + top_k, train items
    masked out (the protocol of benchmark/README.md:69-104)."""
    import jax
    import jax.numpy as jnp

    u_index = {u: i for i, u in enumerate(test_users)}
    R = len(test_users)
    sel_tr = np.isin(tr_rows, test_users)
    tru = np.fromiter((u_index[u] for u in tr_rows[sel_tr]), np.int64,
                      sel_tr.sum())
    trc = tr_cols[sel_tr]
    sel_te = np.isin(te_rows, test_users)
    teu = np.fromiter((u_index[u] for u in te_rows[sel_te]), np.int64,
                      sel_te.sum())
    tec = te_cols[sel_te]

    Aj = jnp.asarray(np.asarray(A)[test_users], jnp.float32)
    Bj = jnp.asarray(np.asarray(B), jnp.float32)

    @jax.jit
    def top_items(Au, Bm, tru, trc):
        scores = Au @ Bm.T
        scores = scores.at[tru, trc].set(-jnp.inf)
        _, idx = jax.lax.top_k(scores, TOPN)
        return idx

    top = np.asarray(top_items(Aj, Bj, jnp.asarray(tru), jnp.asarray(trc)))

    # popularity baseline: same masking, one score vector
    pop = np.bincount(tr_cols, minlength=n).astype(np.float32)

    @jax.jit
    def top_pop(pop, tru, trc):
        scores = jnp.broadcast_to(pop[None, :], (R, pop.shape[0]))
        scores = scores.at[tru, trc].set(-jnp.inf)
        _, idx = jax.lax.top_k(scores, TOPN)
        return idx

    top_p = np.asarray(top_pop(jnp.asarray(pop), jnp.asarray(tru),
                               jnp.asarray(trc)))

    # held-out item sets per test user
    import collections
    heldout = collections.defaultdict(set)
    for u, c in zip(teu, tec):
        heldout[int(u)].add(int(c))

    def p_at_k(topmat):
        hits = []
        aps = []
        for r in range(R):
            hs = heldout.get(r)
            if not hs:
                continue
            row = topmat[r]
            rel = [1 if int(c) in hs else 0 for c in row]
            hits.append(sum(rel) / min(TOPN, len(hs)))
            num_hit = 0
            ap = 0.0
            for i, rv in enumerate(rel):
                if rv:
                    num_hit += 1
                    ap += num_hit / (i + 1)
            aps.append(ap / min(TOPN, len(hs)))
        return float(np.mean(hits)), float(np.mean(aps))

    p10, map10 = p_at_k(top)
    p10_pop, _ = p_at_k(top_p)
    return p10, map10, p10_pop


def run():
    """Run the protocol and return the result record (bench.py embeds it
    in its own JSON so the driver captures the implicit number too)."""
    t_setup = time.time()
    from cmfrec_tpu.config import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    import jax

    from cmfrec_tpu.solvers.drivers import fit_implicit_als

    from bench import _cached

    m, n = 359347, 160168
    rows, cols, vals = _cached(make_lastfm_shaped, "lastfm.npz")
    tr_r, tr_c, tr_v, te_r, te_c, test_users = split_heldout(
        rows, cols, vals, m)
    print(f"data ready in {time.time() - t_setup:.1f}s nnz={rows.size} "
          f"(train {tr_r.size}, heldout {te_r.size})", file=sys.stderr)

    kwargs = dict(k=50, lambda_=5.0, alpha=1.0, niter=15, use_cg=True,
                  max_cg_steps=3)

    def one_fit():
        t0 = time.time()
        res = fit_implicit_als(tr_r, tr_c, tr_v, m, n, **kwargs)
        jax.block_until_ready(res)
        return time.time() - t0, res

    warm = prev = float("inf")
    for _ in range(4):
        prev = warm
        warm, _r = one_fit()
        print(f"warm-up fit: {warm:.2f}s", file=sys.stderr)
        if warm > 0.85 * prev:
            break

    # best of 5
    elapsed, res = one_fit()
    for _ in range(4):
        e2, r2 = one_fit()
        if e2 < elapsed:
            elapsed, res = e2, r2

    # per-iteration time: difference two fits at 30 vs 15 iterations
    # (each builds its own data, so build variance lands in this number)
    def fit_niter(ni):
        t0 = time.time()
        r = fit_implicit_als(tr_r, tr_c, tr_v, m, n,
                             **{**kwargs, "niter": ni})
        jax.block_until_ready(r)
        return time.time() - t0

    t30 = min(fit_niter(30), fit_niter(30))
    iter_s_measured = max(t30 - elapsed, 0.0) / 15
    print(f"iter_s measured (t30-t15)/15: {iter_s_measured:.4f}s "
          f"(t30={t30:.2f}s)", file=sys.stderr)

    import os

    from cmfrec_tpu.data.device_fill import build_bucketed_pair_device

    # the chunked wire build enqueues each row-range's upload while the
    # host fills the next; the serialized variant shows what the overlap
    # saves (best of 2 per mode)
    def _one_build(overlap):
        os.environ["CMFREC_TPU_WIRE_OVERLAP"] = overlap
        t0 = time.time()
        RB, _CB = build_bucketed_pair_device(
            tr_r, tr_c, tr_v.astype(np.float32), m, n, None,
            dtype=np.float32)
        jax.block_until_ready([b.val for b in RB.buckets])
        return time.time() - t0

    build_s = min(_one_build("1"), _one_build("1"))
    build_serial_s = min(_one_build("0"), _one_build("0"))
    os.environ.pop("CMFREC_TPU_WIRE_OVERLAP", None)
    print(f"stage: bucketed pair build {build_s:.2f}s warm (overlapped "
          f"chunked wire) vs {build_serial_s:.2f}s serialized "
          f"(best of 2 each)", file=sys.stderr)

    serving = None
    if os.environ.get("CMFREC_TPU_BENCH_NO_SERVING", "0") != "1":
        import bench_serving

        serving = bench_serving.run_implicit(tr_r, tr_c, tr_v, m, n,
                                             k=kwargs["k"],
                                             lam=kwargs["lambda_"],
                                             alpha=kwargs["alpha"])
        print(f"implicit serving: {serving}", file=sys.stderr)

    t_q = time.time()
    p10, map10, p10_pop = ranking_quality(
        res["A"], res["B"], tr_r, tr_c, te_r, te_c, test_users, n)
    print(f"quality eval in {time.time() - t_q:.1f}s: P@10={p10:.4f} "
          f"(popularity {p10_pop:.4f}), MAP@10={map10:.4f}",
          file=sys.stderr)

    return {
        "metric": "lastfm_shaped_implicit_als_cg_k50_15iter_fit_seconds",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_S / elapsed, 3),
        "extra": {"nnz": int(rows.size),
                  "rows_solved_per_s_per_chip":
                      round((m + n) * kwargs["niter"] / elapsed),
                  "build_s_warm": round(build_s, 3),
                  "build_s_warm_serialized": round(build_serial_s, 3),
                  "iter_s_derived": round(max(elapsed - build_s, 0.0)
                                          / kwargs["niter"], 4),
                  "iter_s_measured": round(iter_s_measured, 4),
                  "p_at_10": round(p10, 5),
                  "p_at_10_popularity": round(p10_pop, 5),
                  "map_at_10": round(map10, 5),
                  "p_at_10_lift_vs_popularity":
                      round(p10 / max(p10_pop, 1e-9), 3),
                  **({"serving": serving} if serving else {})},
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
