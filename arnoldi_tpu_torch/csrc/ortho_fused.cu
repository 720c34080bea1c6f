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
// scratch, and the partials are summed in a fixed order.  Nothing is summed
// with atomics, so results are identical from run to run, which the parity
// checks rely on.
//  * masked_project: a group of 8 warps owns a chunk of columns, stages its
//    slice of w in shared memory, and each warp walks rows r = warp, warp +
//    8, ... reading the row's chunk with consecutive lanes on consecutive
//    addresses; a shuffle tree gives the row's partial.  After a grid-wide
//    barrier (atomic counters, the only atomics) the grid sums each row's
//    partials, so the pass is one launch, as cuBLAS's gemv is: as two
//    launches it lost to gemv by event time (0.1174 ms against 0.1155 ms
//    on an NVIDIA H100 80GB HBM3, 700.00 W).
//  * project_update_norm: a thread owns ITEMS columns (strided by the block
//    width, so each row read is coalesced), keeps them in registers while it
//    streams the active rows, with c staged in shared memory; a block sum
//    of w'^2 gives the block's partial.
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                         // columns per thread (update pass)
constexpr int kUpdateCols = kThreads * kItems;    // columns per block (update pass)
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int kWarps = kThreads / 32;             // warps per chunk (projection pass)
constexpr int kGroups = 4;                        // chunks a projection block runs at once
constexpr int kProjThreads = kGroups * kThreads;
constexpr int kBatch = 4;                         // partials a thread loads at once (sums)

// Barrier of the kThreads threads of group g (named barrier g + 1).
__device__ __forceinline__ void group_sync(int g) {
    asm volatile("bar.sync %0, %1;" :: "r"(g + 1), "n"(kThreads) : "memory");
}

// One cooperative launch (every block resident at once): a persistent grid
// of one block an SM, a grid-wide barrier, then a sum spread over the grid.
//  1. Chunk b of the n_chunks chunks of columns is [b chunk, (b + 1)
//     chunk).  A block is kGroups groups of kWarps warps; group g of block
//     B takes the chunks b = B kGroups + g, + gridDim.x kGroups, ....  For
//     each, the group stages its slice of w in shared memory, warp i walks
//     the rows r = i, i + kWarps, ... and writes each row's partial to
//     partials[r * n_chunks + b]: the bits of one 256-thread block a chunk.
//  2. A barrier: each block's thread 0 fences and counts itself in
//     ticket[0], then waits until all gridDim.x have.
//  3. Group g of block B sums the rows r = B kGroups + g, + gridDim.x
//     kGroups, ... (writing 0 past n_active) as one 256-thread block sums a
//     row, so c keeps the bits of the two-launch split-K: thread t adds
//     partials t, t + 256, ... in turn, then arn::block_sum's two shuffle
//     trees.  Each block then counts itself in ticket[1]; the last resets
//     both tickets to 0 for the next call, so calls that share them must be
//     ordered (the wrapper keeps one pair per device and stream).
// Why so: a thread loads its partials of a row (512 at n = 524,176) at
// once, and 4 gridDim.x rows are summed side by side.  A single last block
// summing them (an atomic ticket) waited on a chain of dependent L2 loads:
// 0.134-0.143 ms of device time against 0.114-0.117 for the two-launch
// form on an NVIDIA H100 80GB HBM3, 700.00 W (scripts/ortho_ab.py).  Rows
// of Vt stream evict-first (3 us less by event time there).
template <typename T>
__global__ void __launch_bounds__(kProjThreads, 1)
masked_project_kernel(const T* __restrict__ Vt, const T* __restrict__ w,
                      T* __restrict__ c, T* __restrict__ partials,
                      unsigned* __restrict__ ticket, long long n, int mp1,
                      int n_active, int chunk, int n_chunks) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ T warp_sums[kGroups][kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = warp / kWarps, gw = warp % kWarps, gt = threadIdx.x % kThreads;
    T* ws = reinterpret_cast<T*>(smem) + g * chunk;
    for (int b = blockIdx.x * kGroups + g; b < n_chunks && n_active > 0;
         b += gridDim.x * kGroups) {
        const long long c0 = static_cast<long long>(b) * chunk;
        const int len = static_cast<int>(min(static_cast<long long>(chunk), n - c0));
        group_sync(g);                      // the slice's last reads are done
        for (int i = gt; i < len; i += kThreads) ws[i] = w[c0 + i];
        group_sync(g);
        for (int r = gw; r < n_active; r += kWarps) {
            const T* row = Vt + static_cast<long long>(r) * n + c0;
            T acc = T(0);
#pragma unroll 4
            for (int i = lane; i < len; i += 32) acc += __ldcs(row + i) * ws[i];
            acc = arn::warp_sum(acc);
            if (lane == 0) partials[static_cast<long long>(r) * n_chunks + b] = acc;
        }
    }

    __syncthreads();                        // the block's partials are written
    if (threadIdx.x == 0) {
        __threadfence();                    // and visible before it is counted
        atomicAdd(ticket, 1u);
        while (*reinterpret_cast<volatile unsigned*>(ticket) < gridDim.x) {}
        __threadfence();                    // every block's partials before the sums
    }
    __syncthreads();
    for (int r = blockIdx.x * kGroups + g; r < mp1; r += gridDim.x * kGroups) {
        const T* pr = partials + static_cast<long long>(r) * n_chunks;
        T acc = T(0);
        for (int b0 = gt; b0 < n_chunks && r < n_active; b0 += kBatch * kThreads) {
            T v[kBatch];                    // the loads of a batch, then its adds in order
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
                v[u] = b0 + u * kThreads < n_chunks ? __ldcg(pr + b0 + u * kThreads) : T(0);
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
                if (b0 + u * kThreads < n_chunks) acc += v[u];
        }
        acc = arn::warp_sum(acc);           // arn::block_sum over the group
        if (lane == 0) warp_sums[g][gw] = acc;
        group_sync(g);
        if (gw == 0) {
            acc = lane < kWarps ? warp_sums[g][lane] : T(0);
            acc = arn::warp_sum(acc);
            if (lane == 0) c[r] = r < n_active ? acc : T(0);
        }
        group_sync(g);                      // warp_sums is read out
    }
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(ticket + 1, 1u) == gridDim.x - 1) {
        ticket[0] = 0u;                     // every block has passed the barrier
        ticket[1] = 0u;
    }
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
int launch_masked_project(const T* Vt, const T* w, T* c, T* partials, unsigned* ticket,
                          long long n, int mp1, int n_active, int chunk, int n_chunks,
                          void* stream) {
    if (n < 1 || mp1 < 1 || n_active < 0 || n_active > mp1 || chunk < 1 ||
        static_cast<long long>(chunk) * sizeof(T) * kGroups > kMaxSharedBytes ||
        static_cast<long long>(n_chunks) != (n + chunk - 1) / chunk)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_sm = arn::sm_count();
    if (n_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
    // One block an SM (the launch bounds allow no more), none without a
    // chunk; one block writes the zeros of an empty projection.
    const int grid = n_active > 0 ? std::min(n_sm, (n_chunks + kGroups - 1) / kGroups) : 1;
    void* args[] = {&Vt, &w, &c, &partials, &ticket, &n, &mp1, &n_active, &chunk, &n_chunks};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        masked_project_kernel<T>, grid, kProjThreads, args, kGroups * chunk * sizeof(T),
        static_cast<cudaStream_t>(stream)));
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
                                      float* partials, unsigned* ticket, long long n,
                                      int mp1, int n_active, int chunk, int n_chunks,
                                      void* stream) {
    return launch_masked_project<float>(Vt, w, c, partials, ticket, n, mp1, n_active,
                                        chunk, n_chunks, stream);
}

extern "C" int arn_masked_project_f64(const double* Vt, const double* w, double* c,
                                      double* partials, unsigned* ticket, long long n,
                                      int mp1, int n_active, int chunk, int n_chunks,
                                      void* stream) {
    return launch_masked_project<double>(Vt, w, c, partials, ticket, n, mp1, n_active,
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
