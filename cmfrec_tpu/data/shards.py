"""Degree-bucketed padded CSR — the accelerator's sparse interaction layout.

The reference keeps a dual CSR+CSC copy of X and dispatches per-row solves
dynamically over OpenMP threads (/root/reference/src/collective.c:6452,
/root/reference/src/common.c:2922).  An XLA device needs static shapes and batched
work instead, so we:

  1. sort rows by nnz (descending),
  2. group them into buckets whose padded width L is a power of two,
  3. pad each bucket's row count R to a multiple of ``row_block`` (a
     multiple of the device-mesh size so buckets shard evenly), and
  4. split buckets so a gathered [R, L, K] opposing-factor slab stays under
     a memory cap.

Each bucket is then one batched solve with a single static shape; across ALS
iterations every shape compiles exactly once.  Rows inside a bucket have
near-equal nnz so padding waste is bounded by ~2x worst case (power-of-two
widths), typically ~1.2x.

The same structure is built once for X in row-major (user) orientation and
once transposed (item orientation) — the direct analog of the reference's
Xcsr/Xcsc pair — and likewise for side-info matrices U/I and their
transposes (for the C/D updates).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..config import DEFAULT_MAX_BLOCK_ELEMS, DEFAULT_ROW_BLOCK


@dataclass
class Bucket:
    """One statically-shaped batch of padded sparse rows."""

    start: int  # offset of this bucket's first row in the permuted row space
    n_rows: int  # R (includes padding rows at the tail)
    n_real: int  # number of genuine rows (<= n_rows)
    width: int  # L
    idx: Any  # [R, L] int32 column ids, 0-padded
    val: Any  # [R, L] values, 0-padded
    length: Any  # [R] int32 nnz per row (0 for padding rows)
    wgt: Optional[Any] = None  # [R, L] observation weights or None

    @property
    def shape_key(self):
        return (self.n_rows, self.width, self.wgt is not None)


@dataclass
class BucketedRows:
    """A sparse matrix laid out as degree-sorted padded row buckets.

    ``perm[i]`` gives the position of original row ``i`` in the permuted
    (concatenated-bucket) row space; ``row_of[p]`` maps a permuted position
    back to the original row id (or -1 for padding rows).
    """

    n_rows: int  # real number of rows (m)
    n_cols: int  # number of columns (n)
    n_rows_pad: int  # sum of bucket n_rows
    perm: np.ndarray  # [m] int32: original row -> permuted position
    row_of: np.ndarray  # [n_rows_pad] int32: permuted position -> original row
    counts: np.ndarray  # [m] int64 nnz per original row
    buckets: list[Bucket] = field(default_factory=list)

    @property
    def nnz(self) -> int:
        return int(self.counts.sum())

    def device_put(self, sharding=None):
        """Move bucket arrays to device (optionally sharded along rows)."""
        import jax

        for b in self.buckets:
            b.idx = jax.device_put(b.idx, sharding)
            b.val = jax.device_put(b.val, sharding)
            b.length = jax.device_put(b.length, sharding)
            if b.wgt is not None:
                b.wgt = jax.device_put(b.wgt, sharding)
        return self


def _pow2_width(x: int, min_width: int = 8) -> int:
    w = min_width
    while w < x:
        w <<= 1
    return w


def _optimal_boundaries(sorted_counts: np.ndarray, row_block: int,
                        min_width: int, max_chunks: int, lane: int = 8):
    """Slot-optimal bucket boundaries.

    The gather engine's time is taken to scale with the total padded
    slots Σ R·w (its rate on the GPU is not measured), so the planner
    minimizes those rather than alignment or row bytes.  Power-of-two widths waste ~1.45x; this DP picks
    ≤``max_chunks`` contiguous chunks of the degree-sorted rows minimizing
    Σ ceil(R/row_block)·row_block · roundup(max_count, lane), which lands
    at ~1.15-1.2x on power-law data with the same chunk count (ML10M /
    LastFM shapes measured).  Returns [(start, end, width), ...].
    """
    if max_chunks < 1:
        raise ValueError(
            f"max_chunks must be >= 1 (got {max_chunks}); check "
            "CMFREC_TPU_MAX_BUCKETS")
    n = sorted_counts.size
    if n == 0:
        return []
    sc = np.maximum(sorted_counts, 1)
    # candidate boundaries: starts of distinct-value runs (+ n); the DP is
    # O(K·C²) so subsample BOTH ends when there are too many — power-law
    # data can have thousands of distinct degrees >=128 in the head, and
    # the planner runs on the host in every fit
    _, first_idx = np.unique(-sc, return_index=True)
    cand = np.unique(np.concatenate([first_idx, [n]]))
    if cand.size > 400:
        cin = cand[:-1]
        head = cin[sc[cin] >= 128]
        tail = cin[sc[cin] < 128]
        if head.size > 0:
            head = head[np.linspace(0, head.size - 1,
                                    min(head.size, 200)).astype(int)]
        if tail.size > 0:
            tail = tail[np.linspace(0, tail.size - 1,
                                    min(tail.size, 300)).astype(int)]
        cand = np.unique(np.concatenate([head, tail, [0, n]]))
    C = cand.size
    w_at = np.maximum(
        np.ceil(sc[np.minimum(cand, n - 1)] / lane) * lane, min_width
    ).astype(np.int64)
    INF = np.int64(1) << 62
    dp = np.full((max_chunks + 1, C), INF, np.int64)
    nxt = np.zeros((max_chunks + 1, C), np.int32)
    dp[:, C - 1] = 0
    lens = cand  # cand[j] - cand[i] via broadcasting below
    for k in range(1, max_chunks + 1):
        for i in range(C - 2, -1, -1):
            R = -(-(lens[i + 1:] - lens[i]) // row_block) * row_block
            cost = R * w_at[i] + dp[k - 1, i + 1:]
            j = int(np.argmin(cost))
            dp[k, i] = cost[j]
            nxt[k, i] = i + 1 + j
    out = []
    i, k = 0, max_chunks
    while i < C - 1:
        j = nxt[k, i]
        out.append((int(cand[i]), int(cand[j]), int(w_at[i])))
        i, k = j, k - 1
    return out


def plan_layout(counts: np.ndarray, row_order: np.ndarray, n_rows: int,
          row_block: int, max_block_elems: int, min_width: int):
    """Bucket layout (no filling): list of (pos, R, n_real, width, cs)
    chunks plus perm / row_of / n_rows_pad.  THE single planner — both the
    host fill below and the device fill (data/device_fill.py) consume it,
    so the two builders cannot drift structurally."""
    import os

    sorted_counts = counts[row_order]
    if os.environ.get("CMFREC_TPU_POW2_BUCKETS", "0") == "1":
        boundaries = []
        i = 0
        while i < n_rows:
            w = _pow2_width(max(int(sorted_counts[i]), 1), min_width)
            lo_excl = w // 2 if w > min_width else 0
            if lo_excl == 0:
                j = n_rows
            else:
                j = int(np.searchsorted(-sorted_counts, -lo_excl,
                                        side="left"))
            j = max(j, i + 1)
            boundaries.append((i, j, w))
            i = j
    else:
        max_chunks = int(os.environ.get("CMFREC_TPU_MAX_BUCKETS", "12"))
        # Fixed reference row_block in the DP cost: boundaries (and hence
        # bucket membership + per-bucket RNG) must not depend on the mesh
        # size, so 1-device and N-device fits init identically.
        boundaries = _optimal_boundaries(
            sorted_counts, DEFAULT_ROW_BLOCK, min_width, max_chunks)

    chunks = []  # (pos, R, n_real, width, cs) where cs indexes row_order
    perm = np.zeros(n_rows, dtype=np.int64)
    row_of_parts = []
    pos = 0
    for (bs, be, w) in boundaries:
        max_rows = max(row_block,
                       (max_block_elems // max(w, 1)) // row_block * row_block)
        cs = bs
        while cs < be:
            ce = min(be, cs + max_rows)
            n_real = ce - cs
            R = -(-n_real // row_block) * row_block
            chunks.append((pos, R, n_real, w, cs))
            perm[row_order[cs:ce]] = pos + np.arange(n_real)
            part = np.full(R, -1, dtype=np.int64)
            part[:n_real] = row_order[cs:ce]
            row_of_parts.append(part)
            pos += R
            cs = ce
    row_of = (np.concatenate(row_of_parts) if row_of_parts
              else np.zeros(0, np.int64))
    return chunks, perm, row_of, pos



def build_bucketed_rows(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    weights: Optional[np.ndarray] = None,
    dtype=np.float32,
    row_block: int = DEFAULT_ROW_BLOCK,
    max_block_elems: int = DEFAULT_MAX_BLOCK_ELEMS,
    min_width: int = 8,
) -> BucketedRows:
    """Build the bucketed layout from COO triplets.

    The CSR conversion, degree sort, and padded-block fills run through the
    native C++ layer (cmfrec_tpu/native/bucketize.cpp — the analog of the
    reference's helpers.c sparse preprocessing) when the toolchain is
    available, with a pure-NumPy fallback.
    """
    from .. import native

    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)

    csr = native.csr_from_coo(rows, cols, vals, weights, n_rows, dtype)
    if csr is not None:
        counts, indptr, sorted_cols, sorted_vals, sorted_wgt = csr
        row_order = native.degree_order(counts)
    else:
        vals = np.asarray(vals, dtype=dtype)
        if weights is not None:
            weights = np.asarray(weights, dtype=dtype)
        counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
        # CSR-ify: sort entries by row (stable keeps column order).
        order = np.argsort(rows, kind="stable")
        sorted_cols = cols[order]
        sorted_vals = vals[order]
        sorted_wgt = weights[order] if weights is not None else None
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # Degree-descending stable row order -> buckets are contiguous.
        row_order = np.argsort(-counts, kind="stable").astype(np.int64)
    chunks, perm, row_of, n_rows_pad = plan_layout(
        counts, row_order, n_rows, row_block, max_block_elems, min_width
    )

    out = BucketedRows(
        n_rows=n_rows,
        n_cols=n_cols,
        n_rows_pad=n_rows_pad,
        perm=perm,
        row_of=row_of,
        counts=counts,
    )

    for (pos, R, n_real, w, cs) in chunks:
        orig_rows = row_order[cs:cs + n_real]
        filled = native.fill_bucket(
            orig_rows, indptr, counts, sorted_cols, sorted_vals,
            sorted_wgt, w, R, dtype,
        ) if csr is not None else None
        if filled is not None:
            idx, val, wgt, length = filled
        else:
            idx = np.zeros((R, w), dtype=np.int32)
            val = np.zeros((R, w), dtype=dtype)
            wgt = (np.zeros((R, w), dtype=dtype)
                   if weights is not None else None)
            length = np.zeros(R, dtype=np.int32)
            # Vectorized fill: flat (row, within-row) destination
            # coordinates for every nonzero of every row in this chunk.
            ns = counts[orig_rows]
            length[:n_real] = ns
            total = int(ns.sum())
            if total:
                starts = indptr[orig_rows]
                seg_off = np.repeat(np.cumsum(ns) - ns, ns)
                within = np.arange(total, dtype=np.int64) - seg_off
                src = np.repeat(starts, ns) + within
                dest_r = np.repeat(np.arange(n_real, dtype=np.int64), ns)
                idx[dest_r, within] = sorted_cols[src]
                val[dest_r, within] = sorted_vals[src]
                if wgt is not None:
                    wgt[dest_r, within] = sorted_wgt[src]
        out.buckets.append(
            Bucket(
                start=pos,
                n_rows=R,
                n_real=n_real,
                width=w,
                idx=idx,
                val=val,
                length=length,
                wgt=wgt,
            )
        )
    return out


def coo_transpose(rows, cols, vals, weights=None):
    """Swap row/col for building the opposite orientation (Xcsc analog)."""
    return cols, rows, vals, weights


def dense_to_coo(X: np.ndarray, weights: Optional[np.ndarray] = None):
    """Dense matrix with NaN-coded missing entries -> COO triplets.

    Mirrors the reference's acceptance of dense X with NAN holes
    (/root/reference/src/common.c:585-590).
    """
    X = np.asarray(X)
    mask = ~np.isnan(X)
    rows, cols = np.nonzero(mask)
    vals = X[rows, cols]
    wv = weights[rows, cols] if weights is not None else None
    return rows, cols, vals, wv
