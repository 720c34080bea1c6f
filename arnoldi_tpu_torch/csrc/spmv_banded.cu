// DIA (banded) SpMV: y[i] = sum_d bands[d, i] * x[i + off_d], zero outside
// the matrix.
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_banded.py, banded_matvec_pallas.
//
// Bound: device-memory bytes.  Each row reads k band values and k x values
// and writes one y value: (2k + 1) elements for 2k flops, far below the
// card's flop-to-byte ratio.  At laplace_2d(724) (k = 5, n = 524,176) in f64
// that is at least 29 MB a call (bands, x once, y), when the caches serve
// x's reuse across the k offsets.
//
// Design: one thread per row, so a warp reads 32 consecutive entries of
// each band and of each shifted x window (coalesced).  The neighbouring x
// entries the rows share are served by L1/L2, which replaces the TPU
// kernel's explicit three-reshape halo staging in VMEM.  The offsets travel
// as a kernel argument (at most 16, the routing rule of as_operator), so the
// loop reads them from the constant bank.  BandedOperator zero-pads bands
// outside the matrix, but i + off still leaves [0, n), so the x load is
// guarded.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 16;
constexpr int kThreads = 256;

struct DiaOffsets {
    long long off[kMaxOffsets];
    int k;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_dia_kernel(const T* __restrict__ bands, const T* __restrict__ x,
                T* __restrict__ y, long long n, DiaOffsets o) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    T acc = T(0);
    for (int d = 0; d < o.k; ++d) {
        const long long j = i + o.off[d];
        if (j >= 0 && j < n) acc += bands[static_cast<long long>(d) * n + i] * x[j];
    }
    y[i] = acc;
}

template <typename T>
int launch_dia(const T* bands, const T* x, T* y, long long n, int k,
               const long long* offsets, void* stream) {
    if (k < 0 || k > kMaxOffsets || n < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    DiaOffsets o{};
    o.k = k;
    for (int d = 0; d < k; ++d) o.off[d] = offsets[d];
    const long long blocks = (n + kThreads - 1) / kThreads;
    spmv_dia_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(bands, x, y, n, o);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arn_spmv_dia_f32(const float* bands, const float* x, float* y,
                                long long n, int k, const long long* offsets,
                                void* stream) {
    return launch_dia<float>(bands, x, y, n, k, offsets, stream);
}

extern "C" int arn_spmv_dia_f64(const double* bands, const double* x, double* y,
                                long long n, int k, const long long* offsets,
                                void* stream) {
    return launch_dia<double>(bands, x, y, n, k, offsets, stream);
}
