// DIA (banded) SpMV: y[i] = sum_d bands[d, i] * x[i + off_d], zero outside
// the matrix, for nb columns at once.  The columns are rows of a (nb, n)
// array (the block expansion's b contiguous basis rows), read and written in
// that layout: column j of x starts at x + j*n, column j of y at y + j*n.
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_banded.py, banded_matvec_pallas, and
// its b-column form (BandedOperator.matmat, a vmap in the JAX package).
//
// Bound: device-memory bytes.  Each row reads k band values and k x values
// per column and writes one y value per column: (k + nb*(k + 1)) elements
// for 2*k*nb flops, far below the card's flop-to-byte ratio.  At
// laplace_2d(724) (k = 5, n = 524,176) in f64 a single column is at least
// 29 MB a call (bands, x once, y), when the caches serve x's reuse across
// the k offsets; eight columns are at least 88 MB, where eight single calls
// read the bands eight times (235 MB in all).
//
// Design: one thread per row, so a warp reads 32 consecutive entries of
// each band and of each shifted x window (coalesced).  The neighbouring x
// entries the rows share are served by L1/L2, which replaces the TPU
// kernel's explicit three-reshape halo staging in VMEM.  The b-column form
// keeps up to kCols columns' sums in registers and loads each band value
// once for all of them; grid.y walks further chunks of kCols columns.  The
// offsets travel as a kernel argument (at most 16, the routing rule of
// as_operator), so the loop reads them from the constant bank.
// BandedOperator zero-pads bands outside the matrix, but i + off still
// leaves [0, n), so the x load is guarded.  Each column's sum runs over d in
// the same order in both forms, so the b-column form gives each column the
// bits the single-column form gives it.
//
// Complex forms (c64, c128): the same kernel over arn::complex values, each
// product a fixed-order complex multiply-add (common.cuh); a complex128
// element is 16 bytes, so the bound doubles float64's bytes.
//
// The shard form (spmv_dia_ext, replacing the same Pallas kernel under a
// device mesh): the rows [row0, row0 + rows) of a row block of the bands
// (row stride bstride), against an x window of x_len entries a column in
// which row i reads x[i + x_base + off].  The ring-halo SpMV runs it over
// [left halo | own block | right halo] (x_base = halo), the all-gather SpMV
// over the whole vector (x_base = the block's first global row), and the
// halo fix-up over the first and last halo rows alone.  The square entry
// points are its x_base = 0, x_len = n case: the same sums in the same
// order, so their bits do not change.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 16;
constexpr int kThreads = 256;
constexpr int kCols = 8;    // columns a thread keeps in registers

struct DiaOffsets {
    long long off[kMaxOffsets];
    int k;
};

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
spmv_dia_kernel(const T* __restrict__ bands, const T* __restrict__ x,
                T* __restrict__ y, long long rows, long long row0,
                long long bstride, long long x_base, long long x_len, int nb,
                DiaOffsets o) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= rows) return;
    const long long i = row0 + t;
    const int j0 = blockIdx.y * NB;
    const int cnt = min(NB, nb - j0);
    x += static_cast<long long>(j0) * x_len;
    y += static_cast<long long>(j0) * rows;
    T acc[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = T(0);
    for (int d = 0; d < o.k; ++d) {
        const long long s = i + x_base + o.off[d];
        if (s < 0 || s >= x_len) continue;
        const T bv = bands[static_cast<long long>(d) * bstride + i];
#pragma unroll
        for (int j = 0; j < NB; ++j)
            if (j < cnt) acc[j] = arn::madd(acc[j], bv, x[static_cast<long long>(j) * x_len + s]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
        if (j < cnt) y[static_cast<long long>(j) * rows + t] = acc[j];
}

// Rows [row0, row0 + rows) of a shard whose bands have row stride bstride,
// against the x window x_ext of x_len entries per column (row i reads
// x_ext[i + x_base + off]); y holds the rows' results, rows per column.
template <typename T>
int launch_dia(const T* bands, const T* x, T* y, long long rows, int k,
               const long long* offsets, int nb, long long bstride,
               long long row0, long long x_base, long long x_len, void* stream) {
    if (k < 0 || k > kMaxOffsets || rows < 0 || nb < 1 || row0 < 0 ||
        x_len < 0 || (rows > 0 && row0 + rows > bstride))
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    DiaOffsets o{};
    o.k = k;
    for (int d = 0; d < k; ++d) o.off[d] = offsets[d];
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
    if (nb == 1) {
        spmv_dia_kernel<T, 1><<<dim3(blocks, 1), kThreads, 0, s>>>(
            bands, x, y, rows, row0, bstride, x_base, x_len, 1, o);
    } else {
        const unsigned chunks = static_cast<unsigned>((nb + kCols - 1) / kCols);
        spmv_dia_kernel<T, kCols><<<dim3(blocks, chunks), kThreads, 0, s>>>(
            bands, x, y, rows, row0, bstride, x_base, x_len, nb, o);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The square operator: every row, x of n entries (x_base 0, x_len n).
#define ARN_DIA_ENTRY(SUFFIX, T)                                                  \
    extern "C" int arn_spmv_dia_##SUFFIX(const T* bands, const T* x, T* y,        \
                                         long long n, int k,                      \
                                         const long long* offsets, int nb,        \
                                         void* stream) {                          \
        return launch_dia<T>(bands, x, y, n, k, offsets, nb, n, 0, 0, n, stream); \
    }                                                                             \
    extern "C" int arn_spmv_dia_ext_##SUFFIX(                                     \
        const T* bands, const T* x, T* y, long long rows, int k,                  \
        const long long* offsets, int nb, long long bstride, long long row0,      \
        long long x_base, long long x_len, void* stream) {                        \
        return launch_dia<T>(bands, x, y, rows, k, offsets, nb, bstride, row0,    \
                             x_base, x_len, stream);                              \
    }

ARN_DIA_ENTRY(f32, float)
ARN_DIA_ENTRY(f64, double)
ARN_DIA_ENTRY(c64, arn::c64)
ARN_DIA_ENTRY(c128, arn::c128)
