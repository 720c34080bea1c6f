// ELLPACK SpMV: y[r] = sum_l data[r, l] * x[cols[r, l]].
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_ell.py, ell_matvec_pallas.
//
// Bound: device-memory bytes, and the latency of the scattered x loads.  A
// row reads L values and L int32 column ids (row-major (n_rows, L) arrays)
// plus L gathered x entries, for 2L flops.  At the scattered 2^20-row test
// matrix (L = 25) in f64 that is at least 331 MB a call (values, column ids,
// x once, y), when the caches serve the repeated x gathers; its banded
// column pattern keeps most of them in L2.
//
// Design: a group of G threads per row, G the power of two >= L and at most
// a warp, so neighbouring threads read neighbouring slots of the row-major
// arrays (coalesced) and keep their x gathers in flight together; a shuffle tree
// then sums the group.  Rows longer than 32 slots stride over them.  The
// TPU kernel held all of x in VMEM because its vector unit cannot gather
// from device memory; here the hardware gathers and the caches keep x's hot
// part on chip.  Padding slots hold column 0 with weight 0, so they need no
// branch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                int L, int G) {
    const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long row = tid / G;
    const int lane = static_cast<int>(threadIdx.x) & (G - 1);
    T acc = T(0);
    if (row < n_rows) {
        const T* d = data + row * L;
        const int* c = cols + row * L;
        for (int l = lane; l < L; l += G) acc += d[l] * x[c[l]];
    }
    // Every thread of the warp reaches the shuffles (no early return).
    for (int off = G >> 1; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off, G);
    if (row < n_rows && lane == 0) y[row] = acc;
}

template <typename T>
int launch_ell(const T* data, const int* cols, const T* x, T* y,
               long long n_rows, int L, void* stream) {
    if (n_rows < 0 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    int G = 1;
    while (G < L && G < 32) G <<= 1;
    const long long blocks = (n_rows * G + kThreads - 1) / kThreads;
    spmv_ell_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(data, cols, x, y,
                                                              n_rows, L, G);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arn_spmv_ell_f32(const float* data, const int* cols, const float* x,
                                float* y, long long n_rows, int L, void* stream) {
    return launch_ell<float>(data, cols, x, y, n_rows, L, stream);
}

extern "C" int arn_spmv_ell_f64(const double* data, const int* cols, const double* x,
                                double* y, long long n_rows, int L, void* stream) {
    return launch_ell<double>(data, cols, x, y, n_rows, L, stream);
}
