"""Distributed top-N: sharded scoring + per-shard top-k + global merge.

The device replacement for the reference's single-node gemv +
qs_argpartition ranking (/root/reference/src/common.c:5127-5370,
/root/reference/src/helpers.c:1567): the item-factor matrix is row-sharded
over the mesh, each shard computes its local top-k with jax.lax.top_k, and
one all-gather of k*n_dev candidates resolves the global top-k (SURVEY.md
§2.4 P6).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def topn_sharded(a_vec, B, n_top, item_bias, mesh):
    """Top-n item ids and scores for one user vector over a mesh.

    a_vec: [k]; B: [n, k] (will be row-sharded); item_bias: [n] or None.
    Returns (idx [n_top], scores [n_top]) in descending score order.
    """
    n = B.shape[0]
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    if pad:
        B = jnp.pad(B, ((0, pad), (0, 0)))
        if item_bias is not None:
            item_bias = jnp.pad(item_bias, (0, pad),
                                constant_values=-jnp.inf)
    npad = B.shape[0]
    rs = NamedSharding(mesh, P("d"))
    rep = NamedSharding(mesh, P())
    B = jax.device_put(B, rs)
    a_vec = jax.device_put(a_vec, rep)
    bias = (jax.device_put(item_bias, rs)
            if item_bias is not None else None)
    n_top = min(n_top, n)
    local = npad // n_dev

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("d"), P("d") if bias is not None else None),
        out_specs=(P("d"), P("d")),
    )
    def _local_topk(a, Bs, bs):
        scores = jnp.einsum("nk,k->n", Bs, a,
                            precision=jax.lax.Precision.HIGHEST)
        if bs is not None:
            scores = scores + bs
        if pad:
            rank = jax.lax.axis_index("d")
            gids = rank * local + jnp.arange(local)
            scores = jnp.where(gids < n, scores, -jnp.inf)
        kk = min(n_top, local)
        top_s, top_i = jax.lax.top_k(scores, kk)
        rank = jax.lax.axis_index("d")
        return top_s, top_i + rank * local

    cand_s, cand_i = _local_topk(a_vec, B, bias)
    # global merge: n_dev * min(n_top, local) candidates, one final top_k
    fin_s, pos = jax.lax.top_k(cand_s, n_top)
    return jnp.take(cand_i, pos), fin_s
