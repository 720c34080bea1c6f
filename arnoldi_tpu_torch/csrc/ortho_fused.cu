// The two streaming passes of classical Gram-Schmidt over the transposed
// Krylov basis Vt (rows are basis vectors, row stride n):
//
//   masked_project:       c[r] = Vt[r, :] . w   for r < n_active, 0 after
//   project_update_norm:  w' = w - sum_{r < n_active} c[r] Vt[r, :], and
//                         ||w'||^2 in the same pass
//
// Replaces: arnoldi_tpu/ops/pallas/ortho_fused.py, masked_project_pallas and
// project_update_norm_pallas (their composition cgs2_pallas is Python).
//
// Bound: device-memory bytes.  Each pass reads the n_active active rows of
// Vt once (n_active * n elements; 335 MB at n_active = 80, n = 524,176 in
// f64) for 2 flops an element.  The TPU kernels masked stale rows with a
// 0/1 vector and still streamed the whole workspace; here the mask becomes
// a row count and rows past n_active are never read.
//
// Design: the TPU carried c and ||w'||^2 across its sequential grid in VMEM.
// Hopper blocks run in parallel and in no order, so both passes are
// split-K over n: each block writes per-row (or per-block) partial sums to
// scratch, and a second small kernel sums the partials in a fixed order.
// Nothing is summed with atomics, so results are identical from run to run,
// which the parity checks rely on.
//  * masked_project: a block owns a chunk of columns, stages its slice of w
//    in shared memory, and each warp walks rows r = warp, warp + 8, ...
//    reading the row's chunk with consecutive lanes on consecutive
//    addresses; a shuffle tree gives the row's partial.
//  * project_update_norm: a thread owns ITEMS columns (strided by the block
//    width, so each row read is coalesced), keeps them in registers while it
//    streams the active rows, with c staged in shared memory; a block sum
//    of w'^2 gives the block's partial.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                         // columns per thread (update pass)
constexpr int kUpdateCols = kThreads * kItems;    // columns per block (update pass)
constexpr int kMaxSharedBytes = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_project_partial(const T* __restrict__ Vt, const T* __restrict__ w,
                       T* __restrict__ partials, long long n, int n_active,
                       int chunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* ws = reinterpret_cast<T*>(smem);
    const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
    const int len = static_cast<int>(min(static_cast<long long>(chunk), n - c0));
    for (int i = threadIdx.x; i < len; i += blockDim.x) ws[i] = w[c0 + i];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int r = warp; r < n_active; r += n_warps) {
        const T* row = Vt + static_cast<long long>(r) * n + c0;
        T acc = T(0);
#pragma unroll 4
        for (int i = lane; i < len; i += 32) acc += row[i] * ws[i];
        acc = arn::warp_sum(acc);
        if (lane == 0) partials[static_cast<long long>(r) * gridDim.x + blockIdx.x] = acc;
    }
}

// One block per workspace row: c[r] = sum of row r's partials, 0 past n_active.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_project_reduce(const T* __restrict__ partials, T* __restrict__ c,
                      int n_active, int n_chunks) {
    const int r = blockIdx.x;
    T acc = T(0);
    if (r < n_active)
        for (int b = threadIdx.x; b < n_chunks; b += blockDim.x)
            acc += partials[static_cast<long long>(r) * n_chunks + b];
    acc = arn::block_sum(acc);
    if (threadIdx.x == 0) c[r] = (r < n_active) ? acc : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
project_update_norm_kernel(const T* __restrict__ Vt, const T* __restrict__ w,
                           const T* __restrict__ c, T* __restrict__ w_out,
                           T* __restrict__ partials, long long n, int n_active) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* cs = reinterpret_cast<T*>(smem);
    for (int r = threadIdx.x; r < n_active; r += blockDim.x) cs[r] = c[r];
    __syncthreads();
    const long long base = static_cast<long long>(blockIdx.x) * kUpdateCols + threadIdx.x;
    T acc[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const long long i = base + static_cast<long long>(k) * kThreads;
        acc[k] = (i < n) ? w[i] : T(0);
    }
    for (int r = 0; r < n_active; ++r) {
        const T cr = cs[r];
        const T* row = Vt + static_cast<long long>(r) * n;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            const long long i = base + static_cast<long long>(k) * kThreads;
            if (i < n) acc[k] -= cr * row[i];
        }
    }
    T sq = T(0);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const long long i = base + static_cast<long long>(k) * kThreads;
        if (i < n) {
            w_out[i] = acc[k];
            sq += acc[k] * acc[k];
        }
    }
    sq = arn::block_sum(sq);
    if (threadIdx.x == 0) partials[blockIdx.x] = sq;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials(const T* __restrict__ partials, T* __restrict__ out, int count) {
    T acc = T(0);
    for (int b = threadIdx.x; b < count; b += blockDim.x) acc += partials[b];
    acc = arn::block_sum(acc);
    if (threadIdx.x == 0) *out = acc;
}

template <typename T>
int launch_masked_project(const T* Vt, const T* w, T* c, T* partials,
                          long long n, int mp1, int n_active, int chunk,
                          int n_chunks, void* stream) {
    if (n < 1 || mp1 < 1 || n_active < 0 || n_active > mp1 || chunk < 1 ||
        static_cast<long long>(chunk) * sizeof(T) > kMaxSharedBytes ||
        static_cast<long long>(n_chunks) != (n + chunk - 1) / chunk)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_active > 0) {
        masked_project_partial<T><<<n_chunks, kThreads, chunk * sizeof(T), s>>>(
            Vt, w, partials, n, n_active, chunk);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    masked_project_reduce<T><<<mp1, kThreads, 0, s>>>(partials, c, n_active, n_chunks);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_project_update_norm(const T* Vt, const T* w, const T* c, T* w_out,
                               T* partials, T* norm_sq, long long n,
                               int n_active, int n_blocks, void* stream) {
    if (n < 1 || n_active < 0 ||
        static_cast<long long>(n_active) * sizeof(T) > kMaxSharedBytes ||
        static_cast<long long>(n_blocks) != (n + kUpdateCols - 1) / kUpdateCols)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    project_update_norm_kernel<T><<<n_blocks, kThreads, n_active * sizeof(T), s>>>(
        Vt, w, c, w_out, partials, n, n_active);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    sum_partials<T><<<1, kThreads, 0, s>>>(partials, norm_sq, n_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arn_update_cols_per_block() { return kUpdateCols; }

extern "C" int arn_masked_project_f32(const float* Vt, const float* w, float* c,
                                      float* partials, long long n, int mp1,
                                      int n_active, int chunk, int n_chunks,
                                      void* stream) {
    return launch_masked_project<float>(Vt, w, c, partials, n, mp1, n_active,
                                        chunk, n_chunks, stream);
}

extern "C" int arn_masked_project_f64(const double* Vt, const double* w, double* c,
                                      double* partials, long long n, int mp1,
                                      int n_active, int chunk, int n_chunks,
                                      void* stream) {
    return launch_masked_project<double>(Vt, w, c, partials, n, mp1, n_active,
                                         chunk, n_chunks, stream);
}

extern "C" int arn_project_update_norm_f32(const float* Vt, const float* w,
                                           const float* c, float* w_out,
                                           float* partials, float* norm_sq,
                                           long long n, int n_active,
                                           int n_blocks, void* stream) {
    return launch_project_update_norm<float>(Vt, w, c, w_out, partials, norm_sq,
                                             n, n_active, n_blocks, stream);
}

extern "C" int arn_project_update_norm_f64(const double* Vt, const double* w,
                                           const double* c, double* w_out,
                                           double* partials, double* norm_sq,
                                           long long n, int n_active,
                                           int n_blocks, void* stream) {
    return launch_project_update_norm<double>(Vt, w, c, w_out, partials, norm_sq,
                                              n, n_active, n_blocks, stream);
}
