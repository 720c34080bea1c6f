// BSR SpMV: y_blk[i] = sum_l blocks[i, l] @ x_blk[cols[i, l]] over r x c
// dense blocks stored ELL-style (n_brow, L, r, c), zero-padded, for nb
// columns at once.  The columns are rows of (nb, n_cols) and (nb, n_rows)
// arrays (the block expansion's b contiguous basis rows).
//
// Two kernels:
//  * spmv_bsr_kernel (gather) replaces arnoldi_tpu/ops/pallas/spmv_bsr.py,
//    bsr_matvec_pallas: x is read straight from device memory.
//  * the window kernel replaces bsr_matvec_pallas16 (with its host packing
//    pack_bsr16): a tile of block-rows reads x only from the window
//    [tile_base, tile_base + Wt) block-columns, staged in shared memory.
//    spmv_bsr_window8_kernel runs 8 x 8 blocks (the format's use),
//    spmv_bsr_window_kernel every other shape.
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
// Design (the gather kernel and the general window kernel): one warp per
// block-row.  Lane t owns the block
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
// packing (lane = cc*16 + b16 existed only to fill 128 VPU lanes): a tile of
// tile_brows consecutive block-rows reads x only from its window of Wt
// block-columns, staged in shared memory.  The host packing
// (ops/kernels/spmv_bsr.py, pack_bsr_window) repoints padding slots into
// their row's own column range, so every id of a tile lies in its window;
// ids outside it read zero.  The base is clamped as spmv_bsr.py:224 does.
//
// Window kernel bound: the nonzeros' bytes (as above), and a floor of the
// stored blocks: any kernel that reads the zero-filled 8 x 8 blocks moves
// at least 287 MB (one column) or 405 MB (eight) in f64 on the banded-1024
// matrix, 79 % and 85 % of the nonzero bound's time.
//
// 8 x 8 blocks take spmv_bsr_window8_kernel.  What held the first window
// kernel (a block per tile that staged, synced, then contracted; 49 % of
// the bound at one column and 10 % at eight on the H100) and what this
// design does about each:
//  * staging was synchronous and never overlapped: each block copied its
//    window with plain loads (a division per element) and waited.  Now a
//    persistent grid (the blocks that fit an SM times the SMs) walks a
//    fixed, contiguous run of (tile, pass) items a block, and one thread
//    copies each column's window with one cp.async.bulk (1-D TMA, counted
//    on an mbarrier).  Where two stages fit (one column: 24.6 KB at
//    Wt = 384 in f64) the next item's copy overlaps this item's
//    contraction; where one does (eight columns: 197 KB) it follows it.
//    x views whose pointer or column stride is not 16-byte aligned take
//    4/8-byte cp.async copies instead (a fixed rule on the pointer and on
//    n_cols * itemsize).
//  * too few bytes in flight: a warp loaded one 512-byte block at a time in
//    a loop of dynamic trip count.  Now a warp requests up to 4 blocks of
//    each of two block-rows (a half-warp each) before their FMAs: 4 KB a
//    warp, 64-96 KB an SM.  The blocks and ids are read with the streaming
//    hint (evict first), so that they do not push the windows, which
//    consecutive tiles share, out of L2.
//  * at eight columns one block of 8 warps held an SM (196 KB of windows)
//    and each warp walked 16 block-rows in turn.  Now one pass stages every
//    column one stage fits (8 in f64 at Wt = 384), so each block is read
//    once for all of them (passes of 4 read the blocks twice from device
//    memory: L2 does not keep a tile's 256 KB across 132 SMs), a warp
//    contracts a block-row pair with 4 columns at a time, and a block runs
//    16 warps when it holds an SM.
//  * the window is still ~3x a tile's own span (384 block-columns for rows
//    that reach +-128 from the diagonal); it is staged mostly from L2.  A
//    ring that copies only the block-columns entering the window measured
//    slower on the H100 (its copies are many and small).
// Summation order: lane (h, rq, q) holds rows rq and rq + 4 at block
// columns q and q + 4 of every block of its block-row, keeps one partial a
// row, column and q (FMAs over l in ascending order, as the gather kernel's
// lane does), and sums a row as reduce_write says: the tree
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) that the gather kernel's
// shuffle-down over its 8 lanes builds.  So the window kernel gives the
// gather kernel's bits, and every column of a pass the single-column bits.
// Other block shapes keep the first window kernel (spmv_bsr_window_kernel).
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                  // columns a warp keeps in registers
constexpr int kMaxSmem = 232448;          // 227 KB, one block's dynamic limit
constexpr int kBarBytes = 16;             // the 8x8 window kernel's two mbarriers

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

// ---- The 8 x 8 window kernel --------------------------------------------

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One 1-D TMA copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sums a lane's partials into its row outputs.  Lane (h, rq, q) holds, for
// each column j of its group, the partials p[j] of rows rq and rq + 4 of
// its block-row at block columns q and q + 4: [rq, q], [rq, q + 4],
// [rq + 4, q], [rq + 4, q + 4].  Every row's sum is the tree
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) over its 8 block columns
// (the gather kernel's shuffle-down order; IEEE addition commutes): the
// lane adds its own pair (p_q + p_{q+4}), then a reduce-scatter over q adds
// the partner's at xor 2 (the lane keeps row rq + 4 * (q >> 1)) and at xor 1
// (the lane keeps half of that row's columns; one column is summed in both
// lanes).
template <typename T, int G>
__device__ __forceinline__ void reduce_write(const T (&p)[G][4], int q, int rq,
                                             long long brow, bool live, int cnt,
                                             T* __restrict__ y, long long n_rows) {
    const bool hi1 = q & 2;
    T v1[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const T top = p[j][0] + p[j][1], bottom = p[j][2] + p[j][3];
        v1[j] = (hi1 ? bottom : top) + __shfl_xor_sync(0xffffffffu, hi1 ? top : bottom, 2);
    }
    const long long row = brow * 8 + rq + (hi1 ? 4 : 0);
    if (G == 1) {
        const T sum = v1[0] + __shfl_xor_sync(0xffffffffu, v1[0], 1);
        if (live && (q & 1) == 0 && row < n_rows) y[row] = sum;
        return;
    }
    constexpr int H = G / 2;
    const bool hi2 = q & 1;
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const T keep = hi2 ? v1[H + k] : v1[k], give = hi2 ? v1[k] : v1[H + k];
        const T sum = keep + __shfl_xor_sync(0xffffffffu, give, 1);
        const int j = (hi2 ? H : 0) + k;
        if (live && j < cnt && row < n_rows) y[j * n_rows + row] = sum;
    }
}

// Item i of a launch is (tile i / passes, pass i % passes); pass p covers
// columns [p * per_pass, min(nb, (p + 1) * per_pass)).  Block g of G runs
// items [g * n / G, (g + 1) * n / G): ops/kernels/spmv_bsr.py,
// window_items, is the same plan on the host.  A staged column holds the
// window's Wt block-columns, then a zero block-column that ids outside the
// window read.  With two stages the next item's windows are copied while
// this item is contracted; with one (when two do not fit), after it.  A
// sweep loads a block-row pair's blocks once and contracts them with the
// pass's columns G at a time (G partial sets in registers).
template <typename T, int G, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
spmv_bsr_window8_kernel(const T* __restrict__ blocks, const int* __restrict__ wcols,
                        const int* __restrict__ tile_base, const T* __restrict__ x,
                        T* __restrict__ y, long long n_brow, int L, long long n_rows,
                        long long n_cols, int nb, int tile_brows, int Wt, int per_pass,
                        int stages, long long n_tiles, int vec) {
    constexpr int kW = THREADS / 32;
    constexpr int kU = 4;                   // blocks of a row requested together
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
    T* stage_mem = reinterpret_cast<T*>(smem + kBarBytes);
    const int W = Wt * 8;
    const int CW = W + 8;                   // a staged column: window + zeros
    const int stage_elems = per_pass * CW;
    const int passes = (nb + per_pass - 1) / per_pass;
    const long long items = n_tiles * passes;
    const long long first = static_cast<long long>(blockIdx.x) * items / gridDim.x;
    const long long last = static_cast<long long>(blockIdx.x + 1) * items / gridDim.x;
    // Window base clamped so the window stays inside max(n_bcol, Wt)
    // block-columns (spmv_bsr.py:224).
    const long long n_bcol = max((n_cols + 7) / 8, static_cast<long long>(Wt));
    auto base_of = [&](long long tile) {
        return min(max(static_cast<long long>(tile_base[tile]), 0LL), n_bcol - Wt);
    };
    if (threadIdx.x == 0) {
        mbar_init(bar);
        mbar_init(bar + 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int i = threadIdx.x; i < stages * per_pass * 8; i += THREADS)
        stage_mem[(i >> 3) * CW + W + (i & 7)] = T(0);
    __syncthreads();

    // Start copying item `item`'s windows (its columns' x[x0 : x0 + W],
    // zero past n_cols) into stage s.
    auto stage = [&](long long item, int s) {
        const long long tile = item / passes;
        const int j0 = static_cast<int>(item - tile * passes) * per_pass;
        const int cnt = min(per_pass, nb - j0);
        const long long x0 = base_of(tile) * 8;
        const int valid = static_cast<int>(
            max(0LL, min(static_cast<long long>(W), n_cols - x0)));
        T* dst = stage_mem + s * stage_elems;
        const T* src = x + static_cast<long long>(j0) * n_cols + x0;
        if (vec) {
            if (threadIdx.x == 0) {
                // The stage was last read through the generic proxy.
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                mbar_expect_tx(bar + s, static_cast<unsigned>(cnt * valid * sizeof(T)));
                if (valid > 0)
                    for (int j = 0; j < cnt; ++j)
                        bulk_copy(dst + j * CW, src + j * n_cols,
                                  static_cast<unsigned>(valid * sizeof(T)), bar + s);
            }
            for (int j = 0; j < cnt; ++j)
                for (int w = valid + threadIdx.x; w < W; w += THREADS) dst[j * CW + w] = T(0);
        } else {
            for (int j = 0; j < cnt; ++j)
                for (int w = threadIdx.x; w < W; w += THREADS) {
                    if (w < valid)
                        cp_async_small<sizeof(T)>(dst + j * CW + w, src + j * n_cols + w);
                    else
                        dst[j * CW + w] = T(0);
                }
        }
    };

    // Lane (h, rq, q): block-row h of the warp's pair, rows rq and rq + 4 of
    // its blocks, block columns q and q + 4 (element e0 and e0 + 4, e0 + 32,
    // e0 + 36 of a block).
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h = lane >> 4, q = lane & 3, rq = (lane & 15) >> 2;
    const int e0 = rq * 8 + q;
    if (first < last) stage(first, 0);
    cp_async_commit();
    for (long long it = first; it < last; ++it) {
        const int k = static_cast<int>(it - first);
        const int s = stages == 2 ? k & 1 : 0;
        if (stages == 2) {
            if (it + 1 < last) stage(it + 1, s ^ 1);
            cp_async_commit();
            cp_async_wait_prev();               // this thread's copies of `it` landed
        } else {
            cp_async_wait_all();
        }
        const long long tile = it / passes;
        const int j0 = static_cast<int>(it - tile * passes) * per_pass;
        const int cnt = min(per_pass, nb - j0);
        const long long base = base_of(tile);
        const T* xs = stage_mem + s * stage_elems + q;
        T* yj = y + static_cast<long long>(j0) * n_rows;
        const long long row_end = min((tile + 1) * tile_brows, n_brow);
        T bv[kU][4];
        int off[kU];
        // Request slots [l0, l0 + kU) of block-row brow: every block in
        // flight before the first FMA.
        auto load = [&](long long brow, bool live, int l0) {
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const bool ok = live && l0 + u < L;
                const long long slot = brow * L + l0 + u;
                const long long w = ok ? __ldcs(wcols + slot) - base : -1;
                off[u] = (w >= 0 && w < Wt) ? static_cast<int>(w) * 8 : W;
                const T* blk = blocks + slot * 64 + e0;
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    bv[u][e] = ok ? __ldcs(blk + (e & 1) * 4 + (e >> 1) * 32) : T(0);
            }
        };
        if (vec) mbar_wait(bar + s, (stages == 2 ? k >> 1 : k) & 1);   // the bulk copies
        __syncthreads();                        // and everyone else's
        for (long long b0 = tile * tile_brows + 2 * warp; b0 < row_end; b0 += 2 * kW) {
            const long long brow = b0 + h;
            const bool live = brow < row_end;   // per half-warp: no early exit
            // FMAs of the loaded slots with columns [g0, g0 + G), slots in
            // ascending order.
            auto contract = [&](int l0, int g0, T (&p)[G][4]) {
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    if (l0 + u >= L) break;     // the same in the whole warp
#pragma unroll
                    for (int j = 0; j < G; ++j) {
                        if (g0 + j < cnt) {
                            const T* xj = xs + (g0 + j) * CW + off[u];
                            const T x_q = xj[0], x_q4 = xj[4];
                            p[j][0] = fma_rn(bv[u][0], x_q, p[j][0]);
                            p[j][1] = fma_rn(bv[u][1], x_q4, p[j][1]);
                            p[j][2] = fma_rn(bv[u][2], x_q, p[j][2]);
                            p[j][3] = fma_rn(bv[u][3], x_q4, p[j][3]);
                        }
                    }
                }
            };
            if (L <= kU) load(brow, live, 0);   // once for every group
            for (int g0 = 0; g0 < cnt; g0 += G) {
                T p[G][4];
#pragma unroll
                for (int j = 0; j < G; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) p[j][e] = T(0);
                if (L <= kU) {
                    contract(0, g0, p);
                } else {
                    for (int l0 = 0; l0 < L; l0 += kU) {
                        load(brow, live, l0);
                        contract(l0, g0, p);
                    }
                }
                reduce_write<T, G>(p, q, rq, brow, live, cnt - g0, yj + g0 * n_rows, n_rows);
            }
        }
        __syncthreads();                        // the stage is read out before it is refilled
        if (stages == 1 && it + 1 < last) {
            stage(it + 1, 0);
            cp_async_commit();
        }
    }
}

int sm_count() {
    static int n = -1;
    if (n < 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n = -1;
    }
    return n;
}

// Stages: two when two stages of per_pass columns fit (the next item's
// copy overlaps this item), else one.  Threads: a one-column pass runs 8
// warps (several blocks share an SM); more columns take 16 warps, since
// their stages fill most of an SM.  Both are fixed rules on the shapes.
template <typename T, int G, int THREADS, int MIN_BLOCKS>
int launch_window8_n(const T* blocks, const int* wcols, const int* tile_base,
                     const T* x, T* y, long long n_brow, int L, long long n_rows,
                     long long n_cols, int nb, int tile_brows, int Wt, int per_pass,
                     cudaStream_t s) {
    auto kernel = spmv_bsr_window8_kernel<T, G, THREADS, MIN_BLOCKS>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t stage = static_cast<size_t>(per_pass) * (Wt + 1) * 8 * sizeof(T);
    const int stages = kBarBytes + 2 * stage <= kMaxSmem ? 2 : 1;
    const size_t smem = kBarBytes + stages * stage;
    // Blocks that fit an SM, per instantiation and started KB of shared
    // memory, taken at the rounded-up size: a fixed rule on the shapes.
    static int per_sm[kMaxSmem / 1024 + 1] = {};
    const int kb = static_cast<int>((smem + 1023) / 1024);
    if (per_sm[kb] == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[kb], kernel, THREADS, static_cast<size_t>(kb) * 1024);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm[kb] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const int n_sm = sm_count();
    if (n_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
    const long long n_tiles = (n_brow + tile_brows - 1) / tile_brows;
    const long long items = n_tiles * ((nb + per_pass - 1) / per_pass);
    const unsigned grid = static_cast<unsigned>(
        std::min(items, static_cast<long long>(per_sm[kb]) * n_sm));
    // Bulk copies need 16-byte aligned windows: every column's start (the
    // pointer and the column stride) and x0 (a multiple of 8 values).
    const int vec = reinterpret_cast<size_t>(x) % 16 == 0
                    && (n_cols * static_cast<long long>(sizeof(T))) % 16 == 0;
    kernel<<<grid, THREADS, smem, s>>>(blocks, wcols, tile_base, x, y, n_brow, L, n_rows,
                                       n_cols, nb, tile_brows, Wt, per_pass, stages,
                                       n_tiles, vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_window8(const T* blocks, const int* wcols, const int* tile_base, const T* x,
                   T* y, long long n_brow, int L, long long n_rows, long long n_cols,
                   int nb, int tile_brows, int Wt, int per_pass, cudaStream_t s) {
    if (per_pass == 1)
        return launch_window8_n<T, 1, 256, 3>(blocks, wcols, tile_base, x, y, n_brow, L,
                                              n_rows, n_cols, nb, tile_brows, Wt, 1, s);
    return launch_window8_n<T, 4, 512, 1>(blocks, wcols, tile_base, x, y, n_brow, L, n_rows,
                                          n_cols, nb, tile_brows, Wt, per_pass, s);
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
    // 8 x 8 blocks take the staged kernel (one or two stages of per_pass
    // windows, each with a zero block-column), every other shape the first
    // window kernel (one stage of per_pass windows).
    const bool eight = r == 8 && c == 8;
    const long long smem = eight
        ? static_cast<long long>(per_pass) * (Wt + 1) * c * sizeof(T) + kBarBytes
        : static_cast<long long>(per_pass) * Wt * c * sizeof(T);
    if (n_brow < 0 || L < 1 || nb < 1 || !valid_block(r, c) || tile_brows < 1
        || Wt < 1 || per_pass < 1 || per_pass > kCols || smem > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_brow == 0 || n_rows == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (eight)
        return launch_window8<T>(blocks, wcols, tile_base, x, y, n_brow, L, n_rows, n_cols,
                                 nb, tile_brows, Wt, per_pass, s);
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
