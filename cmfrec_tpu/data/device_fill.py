"""Device-side padded-bucket construction from one compact CSR upload.

The host-to-device link (PCIe) is far slower than device memory, so
shipping pre-padded [R, L] bucket blocks for BOTH orientations (~2.6x nnz)
is wasteful.  This module uploads only
the CSR payload once — counts[m], sorted column ids[nnz] (int32), values
[nnz] — and builds both orientations' padded buckets on device:

  * per-entry destination = flat_offset(bucket) + slot*width + within-row
    rank, all computable from counts + the row permutation (scatter);
  * the transposed orientation's entry order comes from one device sort of
    the column ids — no second upload of index/value arrays.

The resulting BucketedRows matches data/shards.build_bucketed_rows
structurally (same buckets, perm, row_of); only the within-row entry order
may differ (both are valid CSR layouts and solve identical systems).
This is the device-side replacement for the reference's host-side dual
CSR+CSC build (/root/reference/src/collective.c:6452 convert_sparse_X).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_MAX_BLOCK_ELEMS, DEFAULT_ROW_BLOCK
from .shards import Bucket, BucketedRows, plan_layout as _plan


@partial(jax.jit, static_argnames=("nnz", "n_rows", "F", "weighted", "vdtype"))
def _fill_device(sorted_ids, sorted_vals, sorted_wgt, counts, perm,
                 pos_starts, widths, flat_offsets,
                 nnz, n_rows, F, weighted, vdtype):
    """Scatter CSR entries into the flat padded-bucket buffer."""
    # int32 index arithmetic: F and nnz are far below 2**31 here (the flat
    # buffer is ~1.3x nnz); int64 would be silently truncated without x64
    # anyway.
    counts = counts.astype(jnp.int32)
    indptr_ex = jnp.cumsum(counts) - counts
    row_e = jnp.repeat(jnp.arange(n_rows, dtype=jnp.int32), counts,
                       total_repeat_length=nnz)
    within = jnp.arange(nnz, dtype=jnp.int32) - indptr_ex[row_e]
    p = perm[row_e]
    b = jnp.searchsorted(pos_starts, p, side="right") - 1
    dest = flat_offsets[b] + (p - pos_starts[b]) * widths[b] + within
    idx_flat = jnp.zeros(F, jnp.int32).at[dest].set(sorted_ids)
    val_flat = jnp.zeros(F, vdtype).at[dest].set(sorted_vals.astype(vdtype))
    wgt_flat = (jnp.zeros(F, vdtype).at[dest].set(sorted_wgt.astype(vdtype))
                if weighted else None)
    return idx_flat, val_flat, wgt_flat, row_e


@partial(jax.jit, static_argnames=("nnz",))
def _transpose_order(sorted_ids, nnz):
    """Stable order of entries by column id (device sort)."""
    return jnp.argsort(sorted_ids, stable=True)


@partial(jax.jit, static_argnames=("nnz", "weighted"))
def _device_sort_coo(rows_dev, cols_dev, vals_dev, wgt_dev, nnz, weighted):
    """CSR entry order from RAW COO — the device-side replacement for the
    host counting sort (a 10M+-entry host pass takes seconds; the device
    sorts while the next arrays are still uploading)."""
    order = jnp.argsort(rows_dev, stable=True)
    sorted_ids = jnp.take(cols_dev, order)
    sorted_vals = jnp.take(vals_dev, order)
    sorted_wgt = jnp.take(wgt_dev, order) if weighted else wgt_dev
    return sorted_ids, sorted_vals, sorted_wgt


@partial(jax.jit, static_argnames=("weighted",))
def _combine_wire_chunks(lo_c, hi_c, vb_c, wb_c, weighted):
    """Concatenate the per-row-range wire chunk uploads and assemble
    (ids i32, vals bf16, wgt bf16) on device — the same u16/u8 combine the
    single-pass wire path uses, in one executable.  (An interleaved
    uint8-record decode was tried and reverted: strided u8 access
    compiled and ran poorly on the device.)"""
    cat = (lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs))
    ids = (cat(lo_c).astype(jnp.int32)
           | (cat(hi_c).astype(jnp.int32) << 16))
    vals = jax.lax.bitcast_convert_type(cat(vb_c), jnp.bfloat16)
    if weighted:
        wgt = jax.lax.bitcast_convert_type(cat(wb_c), jnp.bfloat16)
    else:
        wgt = jnp.zeros(0, jnp.bfloat16)
    return ids, vals, wgt


def plan_wire_chunks(nnz: int, per_entry: int, *, opt_in_env=None,
                     opt_out_env=None) -> int:
    """Shared planning for chunk-overlapped uploads: number of chunks
    (1 = no chunking), honoring CMFREC_TPU_WIRE_CHUNK_MB and the gate
    env — either an opt-in flag (must be "1" to chunk) or an opt-out
    flag ("1" disables).  Used by the bucketed wire build here and the
    dense engines' _ship_interactions."""
    chunk_bytes = max(1, int(float(os.environ.get(
        "CMFREC_TPU_WIRE_CHUNK_MB", "16")) * (1 << 20)))
    if opt_in_env is not None:
        enabled = os.environ.get(opt_in_env, "0") == "1"
    else:
        enabled = os.environ.get(opt_out_env, "0") != "1"
    if not enabled or nnz * per_entry < 2 * chunk_bytes:
        return 1
    return int(min(16, (nnz * per_entry) // chunk_bytes))


def _ship_ids(x: np.ndarray, dim: int):
    """Upload int ids compactly: 3 bytes/entry (uint16 lo + uint8 hi) when
    the id space allows, re-assembled on device."""
    x32 = np.ascontiguousarray(x, np.int32)
    if dim < (1 << 24):
        lo = (x32 & 0xFFFF).astype(np.uint16)
        hi = (x32 >> 16).astype(np.uint8)
        return (jnp.asarray(lo).astype(jnp.int32)
                | (jnp.asarray(hi).astype(jnp.int32) << 16))
    return jnp.asarray(x32)


def build_bucketed_pair_device(
    rows, cols, vals, m: int, n: int,
    weights=None, dtype=np.float32,
    row_block: int = DEFAULT_ROW_BLOCK,
    max_block_elems: int = DEFAULT_MAX_BLOCK_ELEMS,
    min_width: int = 8,
):
    """Build (row-oriented, col-oriented) BucketedRows with ONE compact
    upload and device-side padding.  Returns (RB, CB)."""
    from .. import native

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nnz = rows.shape[0]
    dt = np.dtype(dtype)
    ship_bf16 = dt == np.float32
    weighted = weights is not None

    # CSR-sorted input (pre-sorted COO, scipy-CSR-origin triplets, …) needs
    # neither a row-id upload nor a sort: one cheap host pass detects it
    # and saves 3 bytes/entry on the wire (the scarcest resource).
    rows_sorted = nnz <= 1 or bool(np.all(rows[1:] >= rows[:-1]))
    counts_c_native = None  # col histogram from the fused wire pass, if any

    def _ship_vals(v):
        """Enqueue values/weights in the wire dtype (bf16 when the compute
        dtype is f32 — exact for half-point ratings, ~0.4% rounding else)."""
        v = np.asarray(v)
        return jnp.asarray(v.astype(jnp.bfloat16) if ship_bf16
                           else v.astype(dt))

    # Default: host-CSR (native counting sort, ~2s for 10M entries) and
    # ship 5 B/entry — the raw-COO path ships 8 B/entry to save that host
    # pass.  Which wins over PCIe is not measured.
    # CMFREC_TPU_RAW_UPLOAD=1 selects the overlapped raw path.
    raw_upload = (os.environ.get("CMFREC_TPU_RAW_UPLOAD", "0") == "1"
                  and not rows_sorted
                  and m < np.iinfo(np.int32).max
                  and n < np.iinfo(np.int32).max)
    if raw_upload:
        # RAW-COO path (opt-in): enqueue the compact uploads FIRST —
        # row ids 3B + col ids 3B + bf16 values 2B per entry — and do the
        # CSR sort on DEVICE (_device_sort_coo).  The host spends
        # seconds on a 10M+-entry counting sort; here it only bincounts
        # and plans buckets, fully overlapped with the upload stream.
        rows_dev = _ship_ids(rows, m)
        ids_raw = _ship_ids(cols, n)
        vals_raw = _ship_vals(vals)
        wgt_raw = _ship_vals(weights) if weighted else jnp.zeros(0, dt)
        counts_r = np.bincount(rows, minlength=m).astype(np.int64)
        row_order_r = native.degree_order(counts_r)
        if row_order_r is None:
            row_order_r = np.argsort(-counts_r, kind="stable")
        ids_dev = vals_dev = wgt_dev = None  # filled after the device sort
    elif rows_sorted:
        counts_r = np.bincount(rows, minlength=m).astype(np.int64)
        row_order_r = native.degree_order(counts_r)
        if row_order_r is None:
            row_order_r = np.argsort(-counts_r, kind="stable")
        ids_dev = _ship_ids(cols, n)
        vals_dev = _ship_vals(vals)
        wgt_dev = _ship_vals(weights) if weighted else jnp.zeros(0, dt)
    else:
        wire_ok = ship_bf16 and n < (1 << 24) and native.get_lib() is not None
        rec = 7 if weighted else 5
        # Chunked overlapped wire build (OPT-IN via CMFREC_TPU_WIRE_OVERLAP=1):
        # histogram pass, then the distribution pass runs per row-range
        # chunk and each finished chunk's upload is ENQUEUED (device_put
        # is async — measured: 20 MB enqueues in 0.09 s) while the host
        # fills the next.  Measured a WASH at this host's fill speed (the
        # G range-rescans and extra enqueue RPCs offset the overlap;
        # bench_implicit prints both modes), so the simpler single-pass
        # build is the default; the overlap is not measured over PCIe.  The DENSE engines' upload chunking
        # (dense_pallas._ship_interactions) is separate and default-ON.
        G = plan_wire_chunks(nnz, rec, opt_in_env="CMFREC_TPU_WIRE_OVERLAP") \
            if wire_ok else 1
        if G > 1:
            rows_c = np.ascontiguousarray(rows)
            cols_c = np.ascontiguousarray(cols)
            vals64 = np.ascontiguousarray(vals, np.float64)
            wgt64 = (np.ascontiguousarray(weights, np.float64)
                     if weighted else None)
            counts_r, indptr_r, counts_c_native = native.coo_hist(
                rows_c, cols_c, m, n)
            lo = np.empty(nnz, np.uint16)
            hi = np.empty(nnz, np.uint8)
            vb = np.empty(nnz, np.uint16)
            wb = np.empty(nnz, np.uint16) if weighted else None
            targets = (np.arange(1, G) * nnz) // G
            bnds = [0, *np.searchsorted(indptr_r, targets).tolist(), m]
            lo_c, hi_c, vb_c, wb_c = [], [], [], []
            for r0, r1 in zip(bnds[:-1], bnds[1:]):
                if r0 >= r1:
                    continue
                native.wire_fill_range(rows_c, cols_c, vals64, wgt64,
                                       indptr_r, r0, r1, lo, hi, vb, wb)
                o0, o1 = int(indptr_r[r0]), int(indptr_r[r1])
                lo_c.append(jnp.asarray(lo[o0:o1]))
                hi_c.append(jnp.asarray(hi[o0:o1]))
                vb_c.append(jnp.asarray(vb[o0:o1]))
                if weighted:
                    wb_c.append(jnp.asarray(wb[o0:o1]))
            row_order_r = native.degree_order(counts_r)
            ids_dev, vals_dev, wgt_dev = _combine_wire_chunks(
                tuple(lo_c), tuple(hi_c), tuple(vb_c), tuple(wb_c),
                weighted=weighted)
            if not weighted:
                wgt_dev = jnp.zeros(0, dt)
        elif wire_ok:
            # fused native path (default): ONE distribution pass emits
            # the wire-ready buffers (3-byte split ids + bf16 values) —
            # no perm materialization, no gather or Python astype passes
            wire = native.csr_wire_from_coo(rows, cols, vals, weights,
                                            m, n)
            counts_r, _ip, lo, hi, vb, wb, counts_c_native = wire
            row_order_r = native.degree_order(counts_r)
            ids_dev = (jnp.asarray(lo).astype(jnp.int32)
                       | (jnp.asarray(hi).astype(jnp.int32) << 16))
            vals_dev = jnp.asarray(vb.view(jnp.bfloat16))
            wgt_dev = (jnp.asarray(wb.view(jnp.bfloat16)) if weighted
                       else jnp.zeros(0, dt))
        else:
            csr = native.csr_from_coo(rows, cols, vals, weights, m, dt)
            if csr is not None:
                counts_r, _, csr_cols, csr_vals, csr_wgt = csr
                row_order_r = native.degree_order(counts_r)
            else:
                counts_r = np.bincount(rows, minlength=m).astype(np.int64)
                order = np.argsort(rows, kind="stable")
                csr_cols = cols[order].astype(np.int32)
                csr_vals = np.asarray(vals, dt)[order]
                csr_wgt = (np.asarray(weights, dt)[order]
                           if weighted else None)
                row_order_r = np.argsort(-counts_r,
                                         kind="stable").astype(np.int64)
            # kick off the big uploads NOW — they stream over the slow
            # host link while the host does degree ordering and planning
            ids_dev = _ship_ids(csr_cols, n)
            vals_dev = _ship_vals(csr_vals)
            wgt_dev = (_ship_vals(csr_wgt) if csr_wgt is not None
                       else jnp.zeros(0, dt))

    counts_c = counts_c_native
    if counts_c is None:
        counts_c = np.bincount(cols, minlength=n).astype(np.int64)
    row_order_c = native.degree_order(counts_c)
    if row_order_c is None:
        row_order_c = np.argsort(-counts_c, kind="stable").astype(np.int64)

    def one_side(counts, row_order, n_rows, n_cols):
        chunks, perm, row_of, n_rows_pad = _plan(
            counts, row_order, n_rows, row_block, max_block_elems, min_width)
        # flat layout: chunk order, each chunk occupying R*w
        flat_offsets = np.zeros(len(chunks), np.int64)
        pos_starts = np.zeros(len(chunks), np.int64)
        widths = np.zeros(len(chunks), np.int64)
        F = 0
        for ci, (pos, R, n_real, w, _cs) in enumerate(chunks):
            flat_offsets[ci] = F
            pos_starts[ci] = pos
            widths[ci] = w
            F += R * w
        out = BucketedRows(
            n_rows=n_rows, n_cols=n_cols, n_rows_pad=n_rows_pad,
            perm=perm, row_of=row_of, counts=counts,
        )
        if F >= np.iinfo(np.int32).max:
            raise ValueError(
                "flat bucket buffer exceeds int32 range; "
                "use the host builder for >2B-entry problems"
            )
        meta = dict(
            chunks=chunks, F=int(F),
            pos_starts=jnp.asarray(pos_starts.astype(np.int32)),
            widths=jnp.asarray(widths.astype(np.int32)),
            flat_offsets=jnp.asarray(flat_offsets.astype(np.int32)),
            perm_dev=jnp.asarray(perm.astype(np.int32)),
            counts_dev=jnp.asarray(counts.astype(np.int32)),
        )
        return out, meta

    RB, meta_r = one_side(counts_r, row_order_r, m, n)
    CB, meta_c = one_side(counts_c, row_order_c, n, m)

    # (f32 values shipped as bf16 above — interaction values/confidences
    # tolerate 0.4% rounding; the solver math stays f32 after the device
    # cast in _fill_device)
    if raw_upload:
        ids_dev, vals_dev, wgt_dev = _device_sort_coo(
            rows_dev, ids_raw, vals_raw, wgt_raw, nnz, weighted)

    jdt = jnp.dtype(dt)
    idx_f, val_f, wgt_f, row_e = _fill_device(
        ids_dev, vals_dev, wgt_dev, meta_r["counts_dev"], meta_r["perm_dev"],
        meta_r["pos_starts"], meta_r["widths"], meta_r["flat_offsets"],
        nnz=nnz, n_rows=m, F=meta_r["F"], weighted=weighted, vdtype=jdt,
    )
    # transposed orientation: resort entries by column id on device
    order2 = _transpose_order(ids_dev, nnz=nnz)
    ids2 = jnp.take(row_e, order2).astype(jnp.int32)
    vals2 = jnp.take(vals_dev, order2)
    wgt2 = jnp.take(wgt_dev, order2) if weighted else wgt_dev
    idx_f2, val_f2, wgt_f2, _ = _fill_device(
        ids2, vals2, wgt2, meta_c["counts_dev"], meta_c["perm_dev"],
        meta_c["pos_starts"], meta_c["widths"], meta_c["flat_offsets"],
        nnz=nnz, n_rows=n, F=meta_c["F"], weighted=weighted, vdtype=jdt,
    )

    def attach(out: BucketedRows, meta, idx_f, val_f, wgt_f, n_rows_pad):
        layout = tuple((pos, R, w) for (pos, R, _nr, w, _cs)
                       in meta["chunks"])
        parts = _attach_fused(
            idx_f, val_f,
            wgt_f if (wgt_f is not None and weighted) else None,
            meta["perm_dev"], meta["counts_dev"],
            layout=layout, n_rows_pad=n_rows_pad)
        for (pos, R, n_real, w, _cs), (bi, bv, bl, bw) in zip(
                meta["chunks"], parts):
            out.buckets.append(Bucket(
                start=pos, n_rows=R, n_real=n_real, width=w,
                idx=bi, val=bv, length=bl, wgt=bw,
            ))
        return out

    attach(RB, meta_r, idx_f, val_f, wgt_f, RB.n_rows_pad)
    attach(CB, meta_c, idx_f2, val_f2, wgt_f2, CB.n_rows_pad)
    return RB, CB


@partial(jax.jit, static_argnames=("layout", "n_rows_pad"))
def _attach_fused(idx_f, val_f, wgt_f, perm_dev, counts_dev, *, layout,
                  n_rows_pad):
    """Slice the flat fill buffers into per-bucket [R, w] views in ONE
    executable.  The eager per-bucket version dispatched ~4 tiny programs
    per bucket per side, each compiled and dispatched on its own."""
    lengths_pad = (jnp.zeros(n_rows_pad, jnp.int32)
                   .at[perm_dev].set(counts_dev.astype(jnp.int32)))
    parts = []
    off = 0
    for (pos, R, w) in layout:
        sz = R * w
        parts.append((
            idx_f[off:off + sz].reshape(R, w),
            val_f[off:off + sz].reshape(R, w),
            jax.lax.dynamic_slice(lengths_pad, (pos,), (R,)),
            None if wgt_f is None else wgt_f[off:off + sz].reshape(R, w),
        ))
        off += sz
    return parts
