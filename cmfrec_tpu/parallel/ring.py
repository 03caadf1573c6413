"""Ring-sharded opposing-factor half-steps (SURVEY §2.4 P7 / §5 big-axis).

The standard bucketed half-step keeps the opposing factor matrix B
replicated on every device: gathers are local and the only collective is
the psum behind shared Gram bases.  That breaks down when ``n·k`` (plus
the transient gather slabs) no longer fits in one device's memory.

This module provides the big-axis escape hatch: B stays **row-sharded at
rest and in transit**.  Each device holds one 1/D shard of B and its own
1/D of the bucket rows; the per-row Gram/rhs systems are assembled by
rotating the B shards around the ring (``ppermute`` over the mesh axis,
which XLA hands to NCCL) and accumulating, at every stop, the contributions of the
slots whose column ids live in the visiting shard:

    for t in 0..D-1:                  # device d holds shard (d+t) mod D
        ms   = take(visiting_shard, idx - offset, masked)
        G   += Σ_l cw·ms msᵀ ;  rhs += Σ_l cv·ms
        visiting_shard = ppermute(visiting_shard, d -> d-1)

No array of size n·k is ever materialized: peak per-device residency is
``n·k/D`` for the shard plus one ``R_loc·L·K`` gather slab.  The price is
D masked passes over the local slots (each slot's column lives in exactly
one shard, so D-1 of its visits contribute zeros), so the ring
half-step is expected to cost ~D× the replicated one (not measured on
the GPU).
Use it when B does not fit, not as the fast path.  The reference has no
counterpart (its OpenMP solver assumes B in shared host memory, e.g.
/root/reference/src/common.c:2922); this layout is what the same
algorithm looks like across devices that each hold a slice of B.

Cholesky/CD only: truncated CG would need one ring per matvec (4·D
passes), which is never the right trade — the driver raises on
``use_cg=True`` with ring sharding enabled.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SOLVER_PRECISION


def pad_rows_to(mat: jax.Array, mult: int) -> jax.Array:
    """Pad the leading axis to a multiple of ``mult`` (zero rows)."""
    S = mat.shape[0]
    pad = (-S) % mult
    if pad == 0:
        return mat
    return jnp.pad(mat, ((0, pad),) + ((0, 0),) * (mat.ndim - 1))


def _ring_body(mat_loc, idx_loc, cw_loc, cv_loc, *, n_dev: int,
               axis: str, mxu_bf16: bool):
    """shard_map body: one device's slice of the ring accumulation.

    mat_loc [S/D, K] local B shard; idx_loc/cw_loc/cv_loc [R/D, L] local
    bucket slots with GLOBAL column ids.  Returns local (G, rhs).
    """
    chunk = mat_loc.shape[0]
    K = mat_loc.shape[1]
    R, L = idx_loc.shape
    dev = jax.lax.axis_index(axis)
    gdt = jnp.bfloat16 if mxu_bf16 else mat_loc.dtype
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def step(t, carry):
        G, rhs, visiting = carry
        # shard id currently visiting (int32 throughout — x64 mode must
        # not promote the loop counter arithmetic)
        src = jax.lax.rem(
            dev.astype(jnp.int32) + jnp.asarray(t, jnp.int32),
            jnp.int32(n_dev),
        )
        off = src * jnp.int32(chunk)
        loc = idx_loc - off
        ok = (loc >= 0) & (loc < chunk)
        ms = jnp.take(visiting.astype(gdt), jnp.clip(loc, 0, chunk - 1),
                      axis=0)  # [R, L, K]
        cwm = jnp.where(ok, cw_loc, 0.0)
        cvm = jnp.where(ok, cv_loc, 0.0)
        if mxu_bf16:
            lhs = (ms * cwm[..., None].astype(gdt)).astype(gdt)
            G = G + jnp.einsum("rlk,rlm->rkm", lhs, ms,
                               preferred_element_type=jnp.float32)
            rhs = rhs + jnp.einsum("rlk,rl->rk", ms, cvm.astype(gdt),
                                   preferred_element_type=jnp.float32)
        else:
            G = G + jnp.einsum("rlk,rlm->rkm", ms * cwm[..., None], ms,
                               precision=SOLVER_PRECISION)
            rhs = rhs + jnp.einsum("rlk,rl->rk", ms, cvm,
                                   precision=SOLVER_PRECISION)
        visiting = jax.lax.ppermute(visiting, axis, perm)
        return G, rhs, visiting

    # Zero initial carries are device-invariant; mark them as varying over
    # the mesh axis so the scan carry type matches the accumulated outputs.
    # bf16 mode accumulates in f32 (preferred_element_type); otherwise the
    # einsums produce mat_loc.dtype (f64 under x64) and the carry must match.
    acc_dt = jnp.float32 if mxu_bf16 else mat_loc.dtype
    G0 = jax.lax.pcast(jnp.zeros((R, K, K), acc_dt), (axis,),
                       to="varying")
    r0 = jax.lax.pcast(jnp.zeros((R, K), acc_dt), (axis,),
                       to="varying")
    # D-1 ppermutes suffice, but a uniform loop body keeps the program one
    # compiled block; the final rotation restores the resident layout.
    G, rhs, _ = jax.lax.fori_loop(0, n_dev, step, (G0, r0, mat_loc))
    return G, rhs


@partial(jax.jit, static_argnames=("mesh", "axis", "mxu_bf16"))
def ring_part_system(mat, idx, cw, cv, *, mesh: Mesh, axis: str = "d",
                     mxu_bf16: bool = False):
    """Per-row Gram/rhs of one sparse part with the opposing matrix kept
    row-sharded: [S, K], [R, L]x3 -> (G [R, K, K], rhs [R, K]).

    ``S`` and ``R`` must divide by the mesh size (pad with
    :func:`pad_rows_to`; padded B rows are zero so stray clipped gathers
    contribute nothing beyond the mask already applied).
    """
    n_dev = int(np.prod(list(mesh.shape.values())))
    body = partial(_ring_body, n_dev=n_dev, axis=axis, mxu_bf16=mxu_bf16)
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    return f(mat, idx, cw, cv)


def shard_rows(x, mesh: Mesh, axis: str = "d"):
    return jax.device_put(x, NamedSharding(mesh, P(axis)))
