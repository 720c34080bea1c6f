// BSR SpMV: y_blk[i] = sum_l blocks[i, l] @ x_blk[cols[i, l]] over r x c
// dense blocks stored ELL-style (n_brow, L, r, c), zero-padded, for nb
// columns at once.  The columns are rows of (nb, n_cols) and (nb, n_rows)
// arrays (the block expansion's b contiguous basis rows).
//
// Two kernels:
//  * spmv_bsr_kernel (gather) replaces arnoldi_tpu/ops/pallas/spmv_bsr.py,
//    bsr_matvec_pallas: x is read straight from device memory.
//  * spmv_bsr_window_kernel replaces bsr_matvec_pallas16 (with its host
//    packing pack_bsr16): a tile of block-rows reads x only from the window
//    [tile_base, tile_base + Wt) block-columns, which the thread block stages
//    in shared memory first.
// Neither Pallas kernel compiled on the TPU; the JAX package runs BSR as an
// XLA take + einsum, and its BsrOperator.matvec is the oracle of both.
//
// Bound: device-memory bytes.  A block-row reads L*r*c values and L int32
// ids (one id per 64 values at 8 x 8, where ELL stores one per value) plus
// L*c x entries per column, for 2*L*r*c*nb flops.  At the scattered 2^20-row
// test matrix as BSR-8 (L = 4: 33.6M stored values, zero-fill and padding
// included, for 26.2M nonzeros) in f64 a single column is at least 286 MB a
// call (blocks, ids, x once, y), where ELL needs 331 MB.
//
// Design (both kernels): one warp per block-row.  Lane t owns the block
// elements e = t + 32*k (k < K, K = ceil(r*c / 32)), so the warp reads each
// stored block as K coalesced 256-byte lines (an 8 x 8 f64 block is 512
// contiguous bytes).  Since c divides 32, lane t always meets block column
// t % c, so its x entry is x[cols*c + t % c] for every k, and the c lanes
// that share a block row sit in one aligned group of c lanes.  After the
// loop over l a shuffle tree over each group sums the row (fixed order, no
// atomics: the same bits from run to run), and the group's first lane
// writes it.  The block-row's ids are loaded by the warp 32 at a time and
// broadcast with shuffles.  The x index is bounds-checked against [0, n_cols),
// so no padded copy of x is built per call (the JAX version pads x on every
// call), and only the first n_rows rows are written.  The b-column form
// keeps up to kCols columns' sums in registers and loads each block value
// and id once for all of them; grid.y walks further chunks of columns.
//
// The window kernel ports the TPU kernel's window idea, not its lane
// packing (lane = cc*16 + b16 existed only to fill 128 VPU lanes): a thread
// block owns tile_brows consecutive block-rows, stages the window of each of
// its columns in dynamic shared memory with plain cooperative loads (zero
// past n_cols), then runs the same contraction reading x from shared
// memory.  The host packing (ops/kernels/spmv_bsr.py, pack_bsr_window)
// repoints padding slots into their row's own column range, so every id of
// a tile lies in its window; ids outside it would read zero.  The base is
// clamped as spmv_bsr.py:224 does.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                  // columns a warp keeps in registers
constexpr int kMaxSmem = 232448;          // 227 KB, one block's dynamic limit

// The contraction of one block-row, x read through `load(j, block_col)`;
// returns nothing, writes the row's outputs.  Every lane of the warp must
// call it (shuffles inside).
template <typename T, int K, int NB, typename LoadX>
__device__ __forceinline__ void block_row(
        const T* __restrict__ blocks, const int* __restrict__ cols, T* __restrict__ y,
        long long brow, bool live, int L, int r, int c, long long n_rows, int cnt,
        LoadX load) {
    const int lane = threadIdx.x & 31;
    const int E = r * c;
    const int cc = lane & (c - 1);
    T acc[NB][K];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[j][k] = T(0);
    if (live) {
        const T* bp = blocks + brow * L * E;
        const int* cp = cols + brow * L;
        for (int l0 = 0; l0 < L; l0 += 32) {
            const int my_col = (l0 + lane < L) ? cp[l0 + lane] : 0;
            const int lend = min(32, L - l0);
            for (int t = 0; t < lend; ++t) {
                const int bc = __shfl_sync(0xffffffffu, my_col, t);
                const T* blk = bp + static_cast<long long>(l0 + t) * E;
                T bv[K];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int e = lane + 32 * k;
                    bv[k] = (e < E) ? blk[e] : T(0);
                }
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    if (j < cnt) {
                        const T xv = load(j, static_cast<long long>(bc) * c + cc);
#pragma unroll
                        for (int k = 0; k < K; ++k) acc[j][k] += bv[k] * xv;
                    }
                }
            }
        }
    }
    // Sum each aligned group of c lanes (one block row) into its first lane.
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k)
            for (int off = c >> 1; off > 0; off >>= 1)
                acc[j][k] += __shfl_down_sync(0xffffffffu, acc[j][k], off, c);
    if (!live || cc != 0) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        if (e >= E) break;
        const long long row = brow * r + e / c;
        if (row >= n_rows) break;
#pragma unroll
        for (int j = 0; j < NB; ++j)
            if (j < cnt) y[static_cast<long long>(j) * n_rows + row] = acc[j][k];
    }
}

template <typename T, int K, int NB>
__global__ void __launch_bounds__(kThreads)
spmv_bsr_kernel(const T* __restrict__ blocks, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, long long n_brow, int L,
                int r, int c, long long n_rows, long long n_cols, int nb) {
    const long long brow = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int j0 = blockIdx.y * NB;
    const int cnt = min(NB, nb - j0);
    const T* xj = x + static_cast<long long>(j0) * n_cols;
    T* yj = y + static_cast<long long>(j0) * n_rows;
    auto load = [=](int j, long long xc) {
        return (xc >= 0 && xc < n_cols) ? xj[static_cast<long long>(j) * n_cols + xc] : T(0);
    };
    block_row<T, K, NB>(blocks, cols, yj, brow, brow < n_brow, L, r, c, n_rows,
                        cnt, load);
}

template <typename T, int K, int NB>
__global__ void __launch_bounds__(kThreads)
spmv_bsr_window_kernel(const T* __restrict__ blocks, const int* __restrict__ wcols,
                       const int* __restrict__ tile_base, const T* __restrict__ x,
                       T* __restrict__ y, long long n_brow, int L, int r, int c,
                       long long n_rows, long long n_cols, int nb, int tile_brows,
                       int Wt, int per_pass) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = reinterpret_cast<T*>(smem);
    const int j0 = blockIdx.y * per_pass;
    const int cnt = min(per_pass, nb - j0);
    // Window base in block-columns, clamped so the window stays inside
    // max(n_bcol, Wt) block-columns (spmv_bsr.py:224).
    const long long n_bcol = max((n_cols + c - 1) / c, static_cast<long long>(Wt));
    long long base = tile_base[blockIdx.x];
    base = min(max(base, 0LL), n_bcol - Wt);
    const int W = Wt * c;
    const long long x0 = base * c;
    for (int i = threadIdx.x; i < cnt * W; i += blockDim.x) {
        const int j = i / W;
        const long long g = x0 + (i - j * W);
        xs[i] = g < n_cols ? x[static_cast<long long>(j0 + j) * n_cols + g] : T(0);
    }
    __syncthreads();
    T* yj = y + static_cast<long long>(j0) * n_rows;
    auto load = [=](int j, long long xc) {
        const long long w = xc - x0;
        return (w >= 0 && w < W) ? xs[j * W + w] : T(0);
    };
    const long long first = static_cast<long long>(blockIdx.x) * tile_brows;
    const long long last = min(first + tile_brows, n_brow);
    for (long long brow = first + (threadIdx.x >> 5); brow < last; brow += kWarps)
        block_row<T, K, NB>(blocks, wcols, yj, brow, true, L, r, c, n_rows, cnt,
                            load);
}

bool valid_block(int r, int c) {
    return r >= 1 && c >= 1 && c <= 32 && (c & (c - 1)) == 0 && r * c <= 256;
}

int k_of(int r, int c) {
    const int e = r * c;
    return e <= 32 ? 1 : e <= 64 ? 2 : e <= 128 ? 4 : 8;
}

template <typename T, int K>
int launch_gather_k(const T* blocks, const int* cols, const T* x, T* y,
                    long long n_brow, int L, int r, int c, long long n_rows,
                    long long n_cols, int nb, cudaStream_t s) {
    const unsigned blocks_x = static_cast<unsigned>((n_brow + kWarps - 1) / kWarps);
    if (nb == 1) {
        spmv_bsr_kernel<T, K, 1><<<dim3(blocks_x, 1), kThreads, 0, s>>>(
            blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, 1);
    } else {
        const unsigned chunks = static_cast<unsigned>((nb + kCols - 1) / kCols);
        spmv_bsr_kernel<T, K, kCols><<<dim3(blocks_x, chunks), kThreads, 0, s>>>(
            blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const T* blocks, const int* cols, const T* x, T* y,
                  long long n_brow, int L, int r, int c, long long n_rows,
                  long long n_cols, int nb, void* stream) {
    if (n_brow < 0 || L < 1 || nb < 1 || !valid_block(r, c))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_brow == 0 || n_rows == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    switch (k_of(r, c)) {
        case 1: return launch_gather_k<T, 1>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, s);
        case 2: return launch_gather_k<T, 2>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, s);
        case 4: return launch_gather_k<T, 4>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, s);
        default: return launch_gather_k<T, 8>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, s);
    }
}

template <typename T, int K, int NB>
int launch_window_kn(const T* blocks, const int* wcols, const int* tile_base,
                     const T* x, T* y, long long n_brow, int L, int r, int c,
                     long long n_rows, long long n_cols, int nb, int tile_brows,
                     int Wt, int per_pass, cudaStream_t s) {
    auto kernel = spmv_bsr_window_kernel<T, K, NB>;
    // Let this instantiation take up to kMaxSmem of dynamic shared memory
    // (48 KB without it), once: the static is per <T, K, NB>.
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t smem = static_cast<size_t>(per_pass) * Wt * c * sizeof(T);
    const unsigned tiles = static_cast<unsigned>((n_brow + tile_brows - 1) / tile_brows);
    const unsigned passes = static_cast<unsigned>((nb + per_pass - 1) / per_pass);
    kernel<<<dim3(tiles, passes), kThreads, smem, s>>>(
        blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols, nb,
        tile_brows, Wt, per_pass);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_window_k(const T* blocks, const int* wcols, const int* tile_base,
                    const T* x, T* y, long long n_brow, int L, int r, int c,
                    long long n_rows, long long n_cols, int nb, int tile_brows,
                    int Wt, int per_pass, cudaStream_t s) {
    if (per_pass == 1)
        return launch_window_kn<T, K, 1>(blocks, wcols, tile_base, x, y, n_brow, L, r, c,
                                         n_rows, n_cols, nb, tile_brows, Wt, 1, s);
    return launch_window_kn<T, K, kCols>(blocks, wcols, tile_base, x, y, n_brow, L, r, c,
                                         n_rows, n_cols, nb, tile_brows, Wt, per_pass, s);
}

template <typename T>
int launch_window(const T* blocks, const int* wcols, const int* tile_base,
                  const T* x, T* y, long long n_brow, int L, int r, int c,
                  long long n_rows, long long n_cols, int nb, int tile_brows,
                  int Wt, int per_pass, void* stream) {
    if (n_brow < 0 || L < 1 || nb < 1 || !valid_block(r, c) || tile_brows < 1
        || Wt < 1 || per_pass < 1 || per_pass > kCols
        || static_cast<long long>(per_pass) * Wt * c * sizeof(T) > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_brow == 0 || n_rows == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    switch (k_of(r, c)) {
        case 1: return launch_window_k<T, 1>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols, nb, tile_brows, Wt, per_pass, s);
        case 2: return launch_window_k<T, 2>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols, nb, tile_brows, Wt, per_pass, s);
        case 4: return launch_window_k<T, 4>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols, nb, tile_brows, Wt, per_pass, s);
        default: return launch_window_k<T, 8>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols, nb, tile_brows, Wt, per_pass, s);
    }
}

}  // namespace

extern "C" int arn_spmv_bsr_f32(const float* blocks, const int* cols, const float* x,
                                float* y, long long n_brow, int L, int r, int c,
                                long long n_rows, long long n_cols, int nb, void* stream) {
    return launch_gather<float>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, stream);
}

extern "C" int arn_spmv_bsr_f64(const double* blocks, const int* cols, const double* x,
                                double* y, long long n_brow, int L, int r, int c,
                                long long n_rows, long long n_cols, int nb, void* stream) {
    return launch_gather<double>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, stream);
}

extern "C" int arn_spmv_bsr_window_f32(const float* blocks, const int* wcols,
                                       const int* tile_base, const float* x, float* y,
                                       long long n_brow, int L, int r, int c,
                                       long long n_rows, long long n_cols, int nb,
                                       int tile_brows, int Wt, int per_pass, void* stream) {
    return launch_window<float>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows,
                                n_cols, nb, tile_brows, Wt, per_pass, stream);
}

extern "C" int arn_spmv_bsr_window_f64(const double* blocks, const int* wcols,
                                       const int* tile_base, const double* x, double* y,
                                       long long n_brow, int L, int r, int c,
                                       long long n_rows, long long n_cols, int nb,
                                       int tile_brows, int Wt, int per_pass, void* stream) {
    return launch_window<double>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows,
                                 n_cols, nb, tile_brows, Wt, per_pass, stream);
}
