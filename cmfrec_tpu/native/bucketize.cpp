// Native data layer: COO -> CSR -> degree-bucketed padded blocks.
//
// Counterpart of the reference's C sparse preprocessing
// (/root/reference/src/helpers.c:1135-1232 coo_to_csr_and_csc,
// /root/reference/src/collective.c:6452 convert_sparse_X): the host-side
// hot path that feeds the device engines.  A counting sort by row is O(nnz)
// (NumPy's argsort is O(nnz log nnz) and the vectorized fancy-index fill
// pays several full passes); at 10M+ entries this is the difference
// between milliseconds and seconds per fit.
//
// Exposed via a plain C ABI and loaded with ctypes (no pybind11 in the
// image).  All buffers are allocated by the caller (NumPy arrays).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Counting-sort COO entries by row.
//   rows[nnz]        row id of each entry
//   counts[n_rows]   out: nnz per row
//   indptr[n_rows+1] out: CSR row pointers
//   perm[nnz]        out: source entry index for each CSR slot
void coo_csr_perm(const int64_t* rows, int64_t nnz, int64_t n_rows,
                  int64_t* counts, int64_t* indptr, int64_t* perm) {
  std::memset(counts, 0, (size_t)n_rows * sizeof(int64_t));
  for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
  indptr[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] = indptr[r] + counts[r];
  std::vector<int64_t> head(indptr, indptr + n_rows);
  for (int64_t i = 0; i < nnz; ++i) perm[head[rows[i]]++] = i;
}

// Gather COO payloads through the CSR permutation, downcasting columns to
// int32 and values/weights to the requested precision.
#define DEFINE_GATHER(NAME, VT)                                            \
  void NAME(const int64_t* perm, int64_t nnz, const int64_t* cols,         \
            const double* vals, const double* wgt, int32_t* out_cols,      \
            VT* out_vals, VT* out_wgt) {                                   \
    _Pragma("omp parallel for schedule(static)")                           \
    for (int64_t i = 0; i < nnz; ++i) {                                    \
      const int64_t s = perm[i];                                           \
      out_cols[i] = (int32_t)cols[s];                                      \
      out_vals[i] = (VT)vals[s];                                           \
      if (wgt) out_wgt[i] = (VT)wgt[s];                                    \
    }                                                                      \
  }

DEFINE_GATHER(gather_entries_f32, float)
DEFINE_GATHER(gather_entries_f64, double)

// Fill one padded bucket: for each of n_real rows (original ids in
// row_order), copy its CSR segment into row r of the [R, width] blocks.
// idx/val/wgt must arrive zero-initialized (calloc'd by the caller).
#define DEFINE_FILL(NAME, VT)                                              \
  void NAME(const int64_t* row_order, int64_t n_real, const int64_t* indptr, \
            const int64_t* counts, const int32_t* csr_cols,                \
            const VT* csr_vals, const VT* csr_wgt, int64_t width,          \
            int32_t* idx, VT* val, VT* wgt, int32_t* length) {             \
    _Pragma("omp parallel for schedule(static)")                           \
    for (int64_t r = 0; r < n_real; ++r) {                                 \
      const int64_t orig = row_order[r];                                   \
      const int64_t c = counts[orig];                                      \
      const int64_t off = indptr[orig];                                    \
      length[r] = (int32_t)c;                                              \
      std::memcpy(idx + r * width, csr_cols + off, (size_t)c * 4);         \
      std::memcpy(val + r * width, csr_vals + off, (size_t)c * sizeof(VT)); \
      if (wgt && csr_wgt)                                                  \
        std::memcpy(wgt + r * width, csr_wgt + off, (size_t)c * sizeof(VT)); \
    }                                                                      \
  }

DEFINE_FILL(fill_bucket_f32, float)
DEFINE_FILL(fill_bucket_f64, double)

// Fused COO->CSR distribution emitting WIRE-READY buffers in one pass.
//
// Replaces coo_csr_perm + gather_entries + the Python-side bf16 cast and
// lo16/hi8 id split (each a full pass over 10M+ entries): counts, then a single distribution pass that writes, per entry,
// the split column id (uint16 low half + uint8 high byte — the 3-byte
// wire format of data/device_fill._ship_ids) and the value rounded to
// bf16 (round-to-nearest-even, matching XLA/NumPy f32->bf16) straight
// into the upload buffers.  ~2 random writes per entry instead of the
// previous write-perm + gather-read pattern.
static inline uint16_t f32_to_bf16(float x) {
  uint32_t bits;
  std::memcpy(&bits, &x, 4);
  const uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  bits += rounding;
  return (uint16_t)(bits >> 16);
}

void coo_csr_fill_wire(const int64_t* rows, const int64_t* cols,
                       const double* vals, const double* wgt, int64_t nnz,
                       int64_t n_rows, int64_t n_cols_hist,
                       int64_t* counts, int64_t* indptr, int64_t* col_counts,
                       uint16_t* out_lo, uint8_t* out_hi,
                       uint16_t* out_vals_bf16, uint16_t* out_wgt_bf16) {
  std::memset(counts, 0, (size_t)n_rows * sizeof(int64_t));
  if (col_counts)
    std::memset(col_counts, 0, (size_t)n_cols_hist * sizeof(int64_t));
  for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
  indptr[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] = indptr[r] + counts[r];
  std::vector<int64_t> head(indptr, indptr + n_rows);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t p = head[rows[i]]++;
    const uint32_t c = (uint32_t)cols[i];
    if (col_counts) col_counts[c]++;  // opposing-orientation histogram
    out_lo[p] = (uint16_t)(c & 0xFFFF);
    out_hi[p] = (uint8_t)(c >> 16);
    out_vals_bf16[p] = f32_to_bf16((float)vals[i]);
    if (wgt) out_wgt_bf16[p] = f32_to_bf16((float)wgt[i]);
  }
}

// Histogram-only pass: row counts, CSR indptr, optional opposing-side
// column histogram.  The cheap prefix of the wire build, split out so the
// distribution pass can run in row-range chunks whose uploads overlap the
// host work on later chunks (serializing the upload and the host fill
// costs their sum).
void coo_hist(const int64_t* rows, const int64_t* cols, int64_t nnz,
              int64_t n_rows, int64_t n_cols_hist,
              int64_t* counts, int64_t* indptr, int64_t* col_counts) {
  std::memset(counts, 0, (size_t)n_rows * sizeof(int64_t));
  if (col_counts) {
    std::memset(col_counts, 0, (size_t)n_cols_hist * sizeof(int64_t));
    for (int64_t i = 0; i < nnz; ++i) {
      counts[rows[i]]++;
      col_counts[cols[i]]++;
    }
  } else {
    for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
  }
  indptr[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] = indptr[r] + counts[r];
}

// Distribution pass restricted to rows [r0, r1): writes the same wire
// buffers as coo_csr_fill_wire (u16 id-low + u8 id-high + bf16 values),
// at each entry's global CSR position.  For a row range those positions
// are contiguous in [indptr[r0], indptr[r1]), so the caller can enqueue
// that slice of each buffer for upload while this function fills the
// next range.  (An interleaved 5-byte-record variant was tried and
// reverted: the strided uint8 decode compiled and ran poorly on the
// device.)
void coo_fill_wire_range(const int64_t* rows, const int64_t* cols,
                         const double* vals, const double* wgt, int64_t nnz,
                         const int64_t* indptr, int64_t r0, int64_t r1,
                         uint16_t* out_lo, uint8_t* out_hi,
                         uint16_t* out_vals_bf16, uint16_t* out_wgt_bf16) {
  std::vector<int64_t> head(indptr + r0, indptr + r1);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t r = rows[i];
    if (r < r0 || r >= r1) continue;
    const int64_t p = head[r - r0]++;
    const uint32_t c = (uint32_t)cols[i];
    out_lo[p] = (uint16_t)(c & 0xFFFF);
    out_hi[p] = (uint8_t)(c >> 16);
    out_vals_bf16[p] = f32_to_bf16((float)vals[i]);
    if (wgt) out_wgt_bf16[p] = f32_to_bf16((float)wgt[i]);
  }
}

// Same single-pass distribution keeping f32 payloads (float64 fits and
// the CSR-consuming host paths): int32 columns + f32 values/weights.
void coo_csr_fill_f32(const int64_t* rows, const int64_t* cols,
                      const double* vals, const double* wgt, int64_t nnz,
                      int64_t n_rows, int64_t* counts, int64_t* indptr,
                      int32_t* out_cols, float* out_vals, float* out_wgt) {
  std::memset(counts, 0, (size_t)n_rows * sizeof(int64_t));
  for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
  indptr[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] = indptr[r] + counts[r];
  std::vector<int64_t> head(indptr, indptr + n_rows);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t p = head[rows[i]]++;
    out_cols[p] = (int32_t)cols[i];
    out_vals[p] = (float)vals[i];
    if (wgt) out_wgt[p] = (float)wgt[i];
  }
}

// Degree-descending stable row order via counting sort over nnz values
// (keys bounded by max degree).  Equivalent to np.argsort(-counts,
// kind="stable") in O(n_rows + max_degree).
void degree_sort(const int64_t* counts, int64_t n_rows, int64_t* order) {
  int64_t maxc = 0;
  for (int64_t r = 0; r < n_rows; ++r)
    if (counts[r] > maxc) maxc = counts[r];
  std::vector<int64_t> hist((size_t)maxc + 2, 0);
  for (int64_t r = 0; r < n_rows; ++r) hist[counts[r]]++;
  // descending: position of degree d starts after all degrees > d
  std::vector<int64_t> start((size_t)maxc + 2, 0);
  int64_t acc = 0;
  for (int64_t d = maxc; d >= 0; --d) {
    start[d] = acc;
    acc += hist[d];
  }
  for (int64_t r = 0; r < n_rows; ++r) order[start[counts[r]]++] = r;
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
