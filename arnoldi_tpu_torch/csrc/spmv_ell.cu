// ELLPACK SpMV: y[r] = sum_l data[r, l] * x[cols[r, l]], for nb columns at
// once.  The columns are rows of (nb, n_cols) and (nb, n_rows) arrays (the
// block expansion's b contiguous basis rows): column j of x starts at
// x + j*n_cols, column j of y at y + j*n_rows.
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_ell.py, ell_matvec_pallas, and its
// b-column form (EllOperator.matmat, a take + einsum in the JAX package).
//
// Bound: device-memory bytes, and the latency of the scattered x loads.  A
// row reads L values and L int32 column ids (row-major (n_rows, L) arrays)
// plus L gathered x entries per column, for 2*L*nb flops.  At the scattered
// 2^20-row test matrix (L = 25) in f64 a single column is at least 331 MB a
// call (values, column ids, x once, y), when the caches serve the repeated
// x gathers; its banded column pattern keeps most of them in L2.  The
// values and ids are 315 MB of that, so eight columns in one pass need at
// least 449 MB where eight single calls read 2.6 GB.
//
// Design: a group of G threads per row, G the power of two >= L and at most
// a warp, so neighbouring threads read neighbouring slots of the row-major
// arrays (coalesced) and keep their x gathers in flight together; a shuffle
// tree then sums the group.  Rows longer than 32 slots stride over them.
// The TPU kernel held all of x in VMEM because its vector unit cannot gather
// from device memory; here the hardware gathers and the caches keep x's hot
// part on chip.  Padding slots hold column 0 with weight 0, so they need no
// branch.
//
// The b-column form reads each value and id once and gathers the kCols
// columns' entries straight from the (nb, n_cols) layout: kCols independent
// loads of one index, issued together.  The alternative, staging x as
// (n_cols, nb) so that one gather fetches all columns' entries from one
// 64-byte line, costs a transpose of x (two passes over nb*n_cols values)
// and a scratch array on every call; the direct form needs neither, and
// each column's x window of a banded matrix stays in L2 either way.
// Each column's sum runs in the same order in both forms, so the b-column
// form gives each column the bits the single-column form gives it.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;    // columns a thread keeps in registers

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                long long n_cols, int L, int G, int nb) {
    const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long row = tid / G;
    const int lane = static_cast<int>(threadIdx.x) & (G - 1);
    const int j0 = blockIdx.y * NB;
    const int cnt = min(NB, nb - j0);
    x += static_cast<long long>(j0) * n_cols;
    y += static_cast<long long>(j0) * n_rows;
    T acc[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = T(0);
    if (row < n_rows) {
        const T* d = data + row * L;
        const int* c = cols + row * L;
        for (int l = lane; l < L; l += G) {
            const T v = d[l];
            const long long col = c[l];
#pragma unroll
            for (int j = 0; j < NB; ++j)
                if (j < cnt) acc[j] += v * x[static_cast<long long>(j) * n_cols + col];
        }
    }
    // Every thread of the warp reaches the shuffles (no early return).
#pragma unroll
    for (int j = 0; j < NB; ++j)
        for (int off = G >> 1; off > 0; off >>= 1)
            acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off, G);
    if (row < n_rows && lane == 0) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
            if (j < cnt) y[static_cast<long long>(j) * n_rows + row] = acc[j];
    }
}

template <typename T>
int launch_ell(const T* data, const int* cols, const T* x, T* y,
               long long n_rows, long long n_cols, int L, int nb, void* stream) {
    if (n_rows < 0 || n_cols < 0 || L < 1 || nb < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    int G = 1;
    while (G < L && G < 32) G <<= 1;
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((n_rows * G + kThreads - 1) / kThreads);
    if (nb == 1) {
        spmv_ell_kernel<T, 1><<<dim3(blocks, 1), kThreads, 0, s>>>(
            data, cols, x, y, n_rows, n_cols, L, G, 1);
    } else {
        const unsigned chunks = static_cast<unsigned>((nb + kCols - 1) / kCols);
        spmv_ell_kernel<T, kCols><<<dim3(blocks, chunks), kThreads, 0, s>>>(
            data, cols, x, y, n_rows, n_cols, L, G, nb);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arn_spmv_ell_f32(const float* data, const int* cols, const float* x,
                                float* y, long long n_rows, long long n_cols, int L,
                                int nb, void* stream) {
    return launch_ell<float>(data, cols, x, y, n_rows, n_cols, L, nb, stream);
}

extern "C" int arn_spmv_ell_f64(const double* data, const int* cols, const double* x,
                                double* y, long long n_rows, long long n_cols, int L,
                                int nb, void* stream) {
    return launch_ell<double>(data, cols, x, y, n_rows, n_cols, L, nb, stream);
}
