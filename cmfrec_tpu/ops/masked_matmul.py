"""Masked-Gram products — the hot path of the dense ALS engines.

Every CG step of a dense-masked ALS half-iteration is

    out = ((Q @ Be^T) * W) @ Be          # [R,K],[S,K],[R,S] -> [R,K]

(the dense-batch form of the reference's per-row normal equations,
/root/reference/src/common.c:1098,2787).  Through XLA this writes the
[R, S] f32 product to device memory and reads it back: XLA does not fuse a
dot, a multiply and a second dot.  The bf16 path of ``masked_gram_matvec``
is a Pallas kernel on the Triton route that keeps each [BLOCK_R, BLOCK_S]
tile of the product in registers, so a matvec reads only W (1 byte per
cell for the int8 mask) plus the small operands.  It has the shape of an
attention kernel without the softmax.  ``masked_rhs`` is written the same
way: XLA materializes the masked f32 values before its product.

  * masked_gram_matvec:  ((Q Be^T) . W) Be           (CG operator)
  * masked_rhs:          ((X - mb) . W) Be           (CG right-hand side)

X is stored *uncentered* in bf16 (explicit-feedback ratings on half-point
grids are exactly representable), with the global mean and the opposing
bias folded into mb[s] = mu + opp_bias[s]; W is an int8 0/1 mask when
unweighted or the f32 weights.  With bf16 Q/Be the products run on the
tensor cores with f32 accumulation; the only inexactness is the rounding of
the factor matrices themselves (~0.4% on the Gram), far less than the CG
truncation the reference already accepts (max_cg_steps=3).  With f32 Q/Be
the products are XLA's at Precision.HIGHEST (full f32, not TF32) — used by
exact mode and the final polish iteration.

On the CPU the kernel runs in Pallas interpret mode (tests only).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Tiles of the Triton kernels: each program owns BLOCK_R rows and walks the
# streamed axis BLOCK_S columns at a time, accumulating [BLOCK_R, K] in
# registers.  Powers of two, as Triton requires.  Chosen on an H100 at the
# ML10M shape among (64|128) x (32|64|128) tiles (PERF.md).
BLOCK_R = 64
BLOCK_S = 128
# A program may also own only 1/split of the streamed axis (partial sums
# added by XLA afterwards), so that a short row axis still gives the card
# _WAVES programs per SM (PERF.md: the R=n matvec at the ML10M shape).
MAX_SPLIT = 4
_WAVES = 4
_NUM_WARPS = 4
_NUM_STAGES = 3
_HI = jax.lax.Precision.HIGHEST


def pad_dim(dim: int, row_mult: int = 1) -> int:
    """Padded size of one side of the dense [m, n] form.

    Each padded dimension is the row axis R of one orientation and the
    streamed axis S of the other, so it must divide by BLOCK_R * row_mult
    (row_mult = mesh size when the row axis is device-sharded: every
    device's shard holds whole row blocks) and by BLOCK_S * MAX_SPLIT.
    """
    step = math.lcm(BLOCK_R * max(row_mult, 1), BLOCK_S * MAX_SPLIT)
    return -(-dim // step) * step


def pad_k(k: int) -> int:
    """Padded factor width: a power of two, at least 64 (Triton's tiles
    are powers of two, and 64 fills a tensor-core tile)."""
    return max(64, 1 << (int(k) - 1).bit_length())


def _interpret() -> bool:
    return jax.default_backend() == "cpu"


@functools.cache
def _sm_count() -> int:
    """Streaming multiprocessors of the card (0 in interpret mode)."""
    return 0 if _interpret() else jax.devices()[0].core_count


def _split(R: int, S: int) -> int:
    """How many programs share one row block's streamed axis."""
    split = 1
    while (split < MAX_SPLIT and (R // BLOCK_R) * split < _WAVES * _sm_count()
           and S % (BLOCK_S * split * 2) == 0):
        split *= 2
    return split


def _dot_operand(x):
    """The CPU's XLA has no bf16 x bf16 -> f32 dot: there, bf16 operands
    enter the products as the f32 values they represent."""
    return x.astype(jnp.float32) if _interpret() else x


def _tiles(j):
    return pl.ds(pl.multiple_of(j * BLOCK_S, BLOCK_S), BLOCK_S)


def _matvec_kernel(q_ref, be_ref, w_ref, out_ref, *, n_tiles, precision):
    q = q_ref[...]

    def body(j, acc):
        sl = _tiles(j)
        be = be_ref[sl, :]
        t = pl.dot(q, be, trans_b=True, precision=precision)
        t = (t * w_ref[:, sl].astype(jnp.float32)).astype(jnp.bfloat16)
        return acc + pl.dot(t.astype(be.dtype), be, precision=precision)

    acc = jnp.zeros(out_ref.shape, jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, n_tiles, body, acc)


def _rhs_kernel(x_ref, w_ref, mb_ref, be_ref, out_ref, *, n_tiles,
                precision):
    def body(j, acc):
        sl = _tiles(j)
        v = ((x_ref[:, sl].astype(jnp.float32) - mb_ref[0, sl][None, :])
             * w_ref[:, sl].astype(jnp.float32)).astype(jnp.bfloat16)
        be = be_ref[sl, :]
        return acc + pl.dot(v.astype(be.dtype), be, precision=precision)

    acc = jnp.zeros(out_ref.shape, jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, n_tiles, body, acc)


def _launch(kernel, name, R, S, K, blocks, *args):
    """Run a row-block kernel over a [R, S] problem; ``blocks`` names each
    operand's layout: "rows" [R, K], "tiles" [R, S], "cols" [S, K] or
    "vec" [1, S].  Returns the [R, K] f32 result."""
    if R % BLOCK_R or S % BLOCK_S or K != pad_k(K):
        raise ValueError(f"unpadded shapes R={R} S={S} K={K}")
    split = _split(R, S)
    s_len = S // split
    specs = {
        "rows": pl.BlockSpec((BLOCK_R, K), lambda i, j: (i, 0)),
        "tiles": pl.BlockSpec((BLOCK_R, s_len), lambda i, j: (i, j)),
        "cols": pl.BlockSpec((s_len, K), lambda i, j: (j, 0)),
        "vec": pl.BlockSpec((1, s_len), lambda i, j: (0, j)),
    }
    args = [a if b == "tiles" else _dot_operand(a)
            for a, b in zip(args, blocks)]
    precision = _HI if _interpret() else None
    parts = pl.pallas_call(
        functools.partial(kernel, n_tiles=s_len // BLOCK_S,
                          precision=precision),
        grid=(R // BLOCK_R, split),
        in_specs=[specs[b] for b in blocks],
        out_specs=pl.BlockSpec((None, BLOCK_R, K), lambda i, j: (j, i, 0)),
        out_shape=jax.ShapeDtypeStruct((split, R, K), jnp.float32),
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=_NUM_STAGES),
        backend="triton",
        interpret=_interpret(),
        name=name,
    )(*args)
    return parts[0] if split == 1 else jnp.sum(parts, axis=0)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def masked_gram_matvec(Q, Be, W, *, mesh=None, axis: str = "d"):
    """((Q @ Be^T) * W) @ Be.  Q:[R,K] Be:[S,K] W:[R,S] -> [R,K] f32.

    R and S must be padded by pad_dim (with a mesh, R's shard on each
    device too), K by pad_k.  W may be int8 (0/1 mask), bf16 or f32.  Q and
    Be share one dtype: bf16 runs the fused Triton kernel (tensor cores,
    f32 accumulation); f32 runs the plain XLA products at
    Precision.HIGHEST, which beat a Triton kernel at full f32 precision on
    the H100 (PERF.md).  With ``mesh``, Q and W are row-sharded over
    ``axis``, Be replicated, and each device runs on its row shard — zero
    collectives (SURVEY.md §2.4 P1: the DP axis).
    """
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        return jax.shard_map(
            masked_gram_matvec,
            mesh=mesh,
            in_specs=(P(axis), P(), P(axis)),
            out_specs=P(axis),
            check_vma=False,  # pallas_call outputs carry no vma info
        )(Q, Be, W)
    Be = Be.astype(Q.dtype)
    if Q.dtype == jnp.float32:
        T = jnp.einsum("rk,sk->rs", Q, Be, precision=_HI)
        return jnp.einsum("rs,sk->rk", T * W.astype(jnp.float32), Be,
                          precision=_HI)
    R, K = Q.shape
    return _launch(_matvec_kernel, "masked_gram_matvec", R, Be.shape[0], K,
                   ("rows", "cols", "tiles"), Q, Be, W)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def masked_rhs(X, W, mb, Be, *, mesh=None, axis: str = "d"):
    """((X - mb[None, :]) * W) @ Be.  X,W:[R,S] mb:[S] Be:[S,K] -> [R,K] f32.

    Shapes padded as for masked_gram_matvec.  bf16 Be runs the fused
    Triton kernel, the masked values rounded to bf16 before the product;
    f32 Be runs the plain XLA product at Precision.HIGHEST.  With
    ``mesh``, X/W are row-sharded over ``axis``, mb/Be replicated."""
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        return jax.shard_map(
            masked_rhs,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P()),
            out_specs=P(axis),
            check_vma=False,
        )(X, W, mb, Be)
    mb = mb.astype(jnp.float32)
    if Be.dtype == jnp.float32:
        V = (X.astype(jnp.float32) - mb[None, :]) * W.astype(jnp.float32)
        return jnp.einsum("rs,sk->rk", V, Be, precision=_HI)
    R, S = X.shape
    return _launch(_rhs_kernel, "masked_rhs", R, S, Be.shape[1],
                   ("tiles", "tiles", "vec", "cols"), X, W,
                   mb.reshape(1, S), Be)
