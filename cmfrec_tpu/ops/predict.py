"""Prediction and top-N ranking kernels.

The reference scores candidates with a gemv then partial-argsorts on the
host (/root/reference/src/common.c:5066 predict_multiple, :5127 topN,
qs_argpartition helpers.c:1567).  Here the whole ranking is one fused
matmul + jax.lax.top_k; masking handles include/exclude lists.  For a
device mesh, B can be row-sharded and the per-shard top-k merged (P6 in
SURVEY.md §2.4) — the einsum + top_k formulation below lets XLA insert that
partitioning automatically when inputs carry shardings.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SOLVER_PRECISION


@jax.jit
def predict_pairs(
    A: jax.Array,
    B: jax.Array,
    rows: jax.Array,
    cols: jax.Array,
    biasA: Optional[jax.Array] = None,
    biasB: Optional[jax.Array] = None,
    glob_mean: float = 0.0,
) -> jax.Array:
    """Batched <a_row, b_col> + biases + mean at arbitrary (row, col) pairs
    (the reference's predict_multiple, /root/reference/src/common.c:5066)."""
    p = jnp.einsum(
        "nk,nk->n", jnp.take(A, rows, axis=0), jnp.take(B, cols, axis=0),
        precision=SOLVER_PRECISION,
    )
    if biasA is not None:
        p = p + jnp.take(biasA, rows)
    if biasB is not None:
        p = p + jnp.take(biasB, cols)
    return p + glob_mean


@jax.jit
def score_items(
    a_vec: jax.Array,  # [k]
    B: jax.Array,  # [n, k]
    biasB: Optional[jax.Array] = None,
    glob_mean: float = 0.0,
    a_bias: float = 0.0,
) -> jax.Array:
    s = jnp.einsum("nk,k->n", B, a_vec, precision=SOLVER_PRECISION)
    if biasB is not None:
        s = s + biasB
    return s + (glob_mean + a_bias)


@partial(jax.jit, static_argnames=("n_top",))
def topn_from_scores(
    scores: jax.Array, allow_mask: Optional[jax.Array], n_top: int
):
    """Top-N with an optional allow mask (include/exclude lists,
    /root/reference/src/common.c:5240-5345)."""
    if allow_mask is not None:
        scores = jnp.where(allow_mask, scores, -jnp.inf)
    vals, idx = jax.lax.top_k(scores, n_top)
    return idx, vals


def topn(
    a_vec,
    B,
    n_top: int = 10,
    biasB=None,
    glob_mean: float = 0.0,
    a_bias: float = 0.0,
    include: Optional[np.ndarray] = None,
    exclude: Optional[np.ndarray] = None,
):
    """Rank all items for one user-factor vector; returns (indices, scores)."""
    scores = score_items(a_vec, B, biasB, glob_mean, a_bias)
    n = B.shape[0]
    allow = None
    if include is not None:
        allow = jnp.zeros(n, bool).at[jnp.asarray(include)].set(True)
        n_top = min(n_top, len(include))
    elif exclude is not None:
        allow = jnp.ones(n, bool).at[jnp.asarray(exclude)].set(False)
    idx, vals = topn_from_scores(scores, allow, min(n_top, n))
    return np.asarray(idx), np.asarray(vals)
