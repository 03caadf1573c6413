"""Production-serving and multi-device patterns.

Demonstrates the round-2 surface: prediction-time caches, binary side
info at inference, the production memory trim, and mesh-sharded fits.
Runs on CPU (set JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
to simulate 8 devices) or on GPUs unchanged.
"""

import numpy as np

from cmfrec_tpu import CMF
from cmfrec_tpu.parallel.mesh import make_mesh

rng = np.random.default_rng(0)
m, n, k_true, p = 500, 200, 6, 12
A = rng.normal(size=(m, k_true))
B = rng.normal(size=(n, k_true))
X = np.where(rng.uniform(size=(m, n)) < 0.1, 3.5 + A @ B.T, np.nan)
U = A @ rng.normal(size=(k_true, p)) + 0.1 * rng.normal(size=(m, p))
U_bin = (A[:, :3] > 0).astype(np.float64)

# ------------------------------------------------------------------ #
# 1. Mesh-sharded fit: rows shard over the device mesh, XLA inserts   #
#    the collectives.  For multi-host, use mesh.init_distributed().   #
# ------------------------------------------------------------------ #
import jax

mesh = make_mesh() if len(jax.devices()) > 1 else None
model = CMF(k=8, lambda_=2.0, niter=8, use_float=False).fit(
    X, U=U, mesh=mesh)
print("fit done; devices:", len(jax.devices()))

# ------------------------------------------------------------------ #
# 2. Prediction-time caches (built by default at fit): cold factors   #
#    are ONE matmul through TransCtCinvCt — no per-call factorization #
# ------------------------------------------------------------------ #
u_new = rng.normal(size=p)
a_cold = model.factors_cold(U=u_new)
print("cold factors via cache:", model._cache_stats)

# ------------------------------------------------------------------ #
# 3. Binary side info at inference: batched per-row L-BFGS on the     #
#    sigmoid objective (no closed form exists)                        #
# ------------------------------------------------------------------ #
model_bin = CMF(method="lbfgs", k=6, lambda_=1.0, maxiter=150,
                use_float=False).fit(X, U=U, U_bin=U_bin)
a_warm = model_bin.factors_warm(
    X_col=np.arange(0, n, 10), X_val=np.full(n // 10, 4.0),
    U=u_new, U_bin=(u_new[:3] > 0).astype(float),
)
print("warm-with-binary factors:", np.round(a_warm, 3))

# ------------------------------------------------------------------ #
# 4. Production memory trim: keep only what new-user serving needs    #
# ------------------------------------------------------------------ #
model.drop_nonessential_matrices()
top = model.topN_cold(n=5, U=u_new)
print("top-5 for a cold user after trim:", top)

# ------------------------------------------------------------------ #
# 5. Batched serving (round-5 surface): power-law request batches     #
#    route through the degree-grouped fused warm kernel — one device  #
#    executable per degree group, one download for the whole batch.   #
#    (bench_serving.py times this against the reference binary.)      #
# ------------------------------------------------------------------ #
import pandas as pd

R = 600
deg = np.minimum((rng.pareto(1.0, R) * 4 + 1).astype(int), n)
req_rows = np.repeat(np.arange(R), deg)
req_cols = np.concatenate([rng.choice(n, size=d, replace=False)
                           for d in deg])
req_vals = np.clip(3.5 + rng.normal(size=req_rows.size), 0.5, 5.0)
Xnew = pd.DataFrame({"UserId": req_rows, "ItemId": req_cols,
                     "Rating": req_vals})
a_batch = model.factors_multiple(X=Xnew)
print("batched warm factors:", a_batch.shape,
      "fused-kernel calls:", model._cache_stats.get("warm_fused", 0))

# ------------------------------------------------------------------ #
# 6. The L-BFGS family is mesh-shardable too (round 5): observations  #
#    and factor pytrees row-shard, GSPMD psums the loss/gradients     #
# ------------------------------------------------------------------ #
model_sharded = CMF(method="lbfgs", k=6, lambda_=1.0, maxiter=60,
                    use_float=False).fit(X, U=U, mesh=mesh)
print("sharded L-BFGS fit done; A:", model_sharded.A_.shape)
