// Shared device helpers for the port's kernels.
//
// Every reduction here runs in a fixed order (shuffle tree inside a warp,
// then warp 0 over the per-warp sums), so a kernel built from them gives
// bit-identical results from run to run on the same launch geometry.
#pragma once

#include <cuda_runtime.h>

namespace arn {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// Sum over the block; the result is valid in thread 0.  blockDim.x must be
// a multiple of 32, and the call must be reached by every thread.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
    __shared__ T warp_sums[32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) warp_sums[wid] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    v = (static_cast<int>(threadIdx.x) < n_warps) ? warp_sums[threadIdx.x] : T(0);
    if (wid == 0) v = warp_sum(v);
    return v;
}

// The current device's SM count (read once; -1 if it cannot be read), for
// the persistent grids.
inline int sm_count() {
    static int n = -1;
    if (n < 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n = -1;
    }
    return n;
}

}  // namespace arn
