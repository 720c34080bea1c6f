// BSR SpMV: y_blk[i] = sum_l blocks[i, l] @ x_blk[cols[i, l]] over r x c
// dense blocks stored ELL-style (n_brow, L, r, c), zero-padded, for nb
// columns at once.  The columns are rows of (nb, n_cols) and (nb, n_rows)
// arrays (the block expansion's b contiguous basis rows).
//
// Two kernels:
//  * spmv_bsr_kernel (gather) replaces arnoldi_tpu/ops/pallas/spmv_bsr.py,
//    bsr_matvec_pallas: x is read straight from device memory.  Its
//    b-column form on 8 x 8 blocks (b >= 2) is spmv_bsr_gather8_kernel.
//  * the window kernel replaces bsr_matvec_pallas16 (with its host packing
//    pack_bsr16): a tile of block-rows reads x only from the window
//    [tile_base, tile_base + Wt) block-columns.  On 8 x 8 blocks (the
//    format's use) one column takes spmv_bsr_window8_kernel, which stages
//    the window in shared memory, and b >= 2 columns the walk of
//    spmv_bsr_gather8_kernel over the window layout (WINDOW = true);
//    spmv_bsr_window_kernel runs every other shape.
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
// One column on 8 x 8 blocks takes spmv_bsr_window8_kernel.  What held the
// first window kernel (a block per tile that staged, synced, then
// contracted; 49 % of the bound on the H100) and what this design does
// about each:
//  * staging was synchronous and never overlapped: each block copied its
//    window with plain loads (a division per element) and waited.  Now a
//    persistent grid (the blocks that fit an SM times the SMs) walks a
//    fixed, contiguous run of tiles a block, and one thread copies the
//    tile's window with one cp.async.bulk (1-D TMA, counted on an
//    mbarrier).  Where two stages fit (24.6 KB at Wt = 384 in f64) the next
//    tile's copy overlaps this tile's contraction.  x views whose pointer
//    or length is not 16-byte aligned take 4/8-byte cp.async copies instead
//    (a fixed rule on the pointer and on n_cols * itemsize).
//  * too few bytes in flight: a warp loaded one 512-byte block at a time in
//    a loop of dynamic trip count.  Now a warp requests up to 4 blocks of
//    each of two block-rows (a half-warp each) before their FMAs: 4 KB a
//    warp, 64-96 KB an SM.  The blocks and ids are read with the streaming
//    hint (evict first), so that they do not push the windows, which
//    consecutive tiles share, out of L2.
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
// gather kernel's bits.  Other block shapes keep the first window kernel
// (spmv_bsr_window_kernel), kCols columns a pass.
//
// b >= 2 columns on 8 x 8 blocks: the earlier b-column form of this kernel
// held every column's window of a tile in shared memory, so a pass
// carried as many columns as fit 227 KB: 8 in f64 (197 KB), 4 in
// complex128 (49,280 B a column at Wt = 384), which read the 537 MB of
// stored blocks twice at b = 8 (L2 does not keep a tile's 512 KB across
// 132 SMs) and copied each tile's whole window, ~3x its span, from L2.
// Now the b-column form is the staged gather kernel's walk (below) over the
// window layout: no window is staged, a warp copies only the 64-byte x
// segments its step's blocks need, and 8 columns ride in registers, so
// each block is read once for b <= 8 in every dtype and the copies of the
// next step overlap this step's FMAs (one launch a call).  An id outside
// its tile's window reads zero, as the staged kernel's zero block-column
// does; the check is folded into the id load, a step ahead, and the tile's
// clamped base is read once a block-row pair.  Measured on an NVIDIA H100
// 80GB HBM3, 700.00 W (scripts/bsr_ab.py, banded-1024, b = 8, device ms,
// parent and variants in turns in one call): complex128 0.3309-0.3317
// (staged: 0.5879-0.5881; the gather kernel on the same matrix 0.3419),
// complex64 0.1723-0.1725 (0.2030-0.2038; gather 0.1746), float64
// 0.1599-0.1623 (0.1824-0.1832; its walk spills 40 bytes, the gather 16),
// float32 0.0855 (0.1161-0.1169).  Variants in complex128: the base read
// and divided (64-bit) every step 0.3746, which the 32-bit division a pair
// took to 0.3322 (a block holds 8 warps an SM, so every instruction of a
// step shows); no window check at all 0.3432; the tile index by a shift
// where tile_brows is a power of two 0.3506-0.3524 (float64 0.153, the
// other dtypes slower too); L1-cached 16-byte x copies (cp.async.ca)
// 0.3709 against 0.3698 for the L1-bypassing ones.  Not built: a pair of
// CTAs in a cluster, each staging 4 columns' windows (197 KB in
// complex128) and reading the partner's through distributed shared memory
// (it would still stage the 3x window from L2, one stage a tile), and a
// tile's blocks staged once with passes over the windows (4 window stages
// a tile in complex128); the walk reads each block once with neither.
//
// spmv_bsr_gather8_kernel (8 x 8 blocks, b >= 2 columns) is the b-column
// gather kernel rebuilt on that layout.  What held the first one (the b
// columns in spmv_bsr_kernel: 0.608 ms at b = 8 on the scattered 2^20-row
// matrix, 17 % of its bound, behind cuSPARSE's BSR SpMM at 0.565 ms) and
// what this design does about each:
//  * one block in flight a warp (a loop of dynamic trip count, each block's
//    loads behind a shuffle of its id): now 4 blocks of each of two
//    block-rows, with the next step's ids loaded ahead, evict-first;
//  * x requested as often as the blocks: each lane loaded 8 scalar x values
//    a block, every address 4 times a warp.  Now a half-warp copies each
//    64-byte x segment once (16-byte cp.async when X's pointer and row
//    stride allow, else value by value) into its shared slice;
//  * 16,384 thread blocks: now a persistent grid whose warps walk the
//    block-row pairs grid-stride, so the rows in flight, and the band of X
//    they read, stay compact in L2.  Contiguous runs of pairs a block lost
//    (0.208 against 0.157 ms: 264 bands of X live at once);
//  * scattered scalar y stores: reduce_write, as above.
// One pass covers up to kGatherCols = 8 columns (more re-read the blocks),
// with the window kernel's sum tree, so every column equals spmv_bsr's bits and the
// window kernel's.  At b = 8 in f64: 0.148 ms on an NVIDIA H100 80GB HBM3,
// 700.00 W (scripts/bsr_ab.py --matrix scattered), 512 threads (16 bytes of
// spill; 384 threads, without spill, took 0.163).
//
// Complex forms (c64, c128): every kernel over arn::complex values, each
// block value times x a fixed-order complex multiply-add (arn::fma_rn:
// four FMAs, real part first) and each shuffle moving the two halves of a
// value, so the sum trees, and the bit rules above, are the real ones.  The
// product is blocks @ x with no conjugate (an adjoint is a materialized
// conjugate transpose).  A complex128 value is one 16-byte unit: windows
// and x segments stay 16-byte aligned (a complex64 column stride is when
// n_cols is even, else the value-by-value copies run).  It takes twice a
// float64 value's registers, so complex128 carries kCols = 4 columns a
// pass in the general kernels (Plan below), and runs the 8 x 8 walk at
// 256 threads with 8 columns (244 registers, no spill; -Xptxas -v, printed
// by chip_smoke.py phase 0): 0.346 ms at b = 8 on the phased scattered
// 2^20-row matrix, where 4 columns a pass (reading the blocks twice) took
// 0.466 ms (scripts/bsr_ab.py --dtype complex128; NVIDIA H100 80GB HBM3,
// 700.00 W).
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;          // 227 KB, one block's dynamic limit
constexpr int kBarBytes = 16;             // the 8x8 window kernel's two mbarriers
constexpr int kGatherCols = 8;            // the staged 8x8 gather kernel's columns a pass

// Launch shapes by value type.  kCols: columns a warp keeps in registers
// in the general kernels, and the most the general window kernel stages a
// pass (ops/kernels/spmv_bsr.py, cols_per_pass); the staged 8 x 8 gather
// kernel's (and the window walk's) threads; the one-column 8 x 8 window
// kernel's blocks an SM (256 threads).
template <typename T>
struct Plan {
    static constexpr int kCols = 8, kGatherThreads = 512, kOneBlocks = 3;
};

template <>
struct Plan<arn::c128> {
    static constexpr int kCols = 4, kGatherThreads = 256, kOneBlocks = 2;
};

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
                        for (int k = 0; k < K; ++k) acc[j][k] = arn::madd(acc[j][k], bv[k], xv);
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
                acc[j][k] += arn::shfl_down(acc[j][k], off, c);
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

// Minimum one block an SM: with the thread count alone ptxas held some
// instantiations (complex128 among them) to 32-64 registers and spilled.
template <typename T, int K, int NB>
__global__ void __launch_bounds__(kThreads, 1)
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
        v1[j] = (hi1 ? bottom : top) + arn::shfl_xor(hi1 ? top : bottom, 2);
    }
    const long long row = brow * 8 + rq + (hi1 ? 4 : 0);
    if (G == 1) {
        const T sum = v1[0] + arn::shfl_xor(v1[0], 1);
        if (live && (q & 1) == 0 && row < n_rows) y[row] = sum;
        return;
    }
    constexpr int H = G / 2;
    const bool hi2 = q & 1;
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const T keep = hi2 ? v1[H + k] : v1[k], give = hi2 ? v1[k] : v1[H + k];
        const T sum = keep + arn::shfl_xor(give, 1);
        const int j = (hi2 ? H : 0) + k;
        if (live && j < cnt && row < n_rows) y[j * n_rows + row] = sum;
    }
}

// The one-column 8 x 8 window kernel.  Block g of G runs tiles
// [g * n / G, (g + 1) * n / G) (ops/kernels/spmv_bsr.py, window_items, is
// the same plan on the host).  A stage holds the tile's window of Wt
// block-columns, then a zero block-column that ids outside the window read.
// With two stages the next tile's window is copied while this tile is
// contracted; with one (when two do not fit), after it.
template <typename T, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
spmv_bsr_window8_kernel(const T* __restrict__ blocks, const int* __restrict__ wcols,
                        const int* __restrict__ tile_base, const T* __restrict__ x,
                        T* __restrict__ y, long long n_brow, int L, long long n_rows,
                        long long n_cols, int tile_brows, int Wt, int stages,
                        long long n_tiles, int vec) {
    constexpr int kW = THREADS / 32;
    constexpr int kU = 4;                   // blocks of a row requested together
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
    T* stage_mem = reinterpret_cast<T*>(smem + kBarBytes);
    const int W = Wt * 8;
    const int CW = W + 8;                   // a stage: window + zeros
    const long long first = static_cast<long long>(blockIdx.x) * n_tiles / gridDim.x;
    const long long last = static_cast<long long>(blockIdx.x + 1) * n_tiles / gridDim.x;
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
    for (int i = threadIdx.x; i < stages * 8; i += THREADS)
        stage_mem[(i >> 3) * CW + W + (i & 7)] = T(0);
    __syncthreads();

    // Start copying tile `tile`'s window (x[x0 : x0 + W], zero past n_cols)
    // into stage s.
    auto stage = [&](long long tile, int s) {
        const long long x0 = base_of(tile) * 8;
        const int valid = static_cast<int>(
            max(0LL, min(static_cast<long long>(W), n_cols - x0)));
        T* dst = stage_mem + s * CW;
        const T* src = x + x0;
        if (vec) {
            if (threadIdx.x == 0) {
                // The stage was last read through the generic proxy.
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                mbar_expect_tx(bar + s, static_cast<unsigned>(valid * sizeof(T)));
                if (valid > 0)
                    bulk_copy(dst, src, static_cast<unsigned>(valid * sizeof(T)), bar + s);
            }
            for (int w = valid + threadIdx.x; w < W; w += THREADS) dst[w] = T(0);
        } else {
            for (int w = threadIdx.x; w < W; w += THREADS) {
                if (w < valid)
                    cp_async_small<sizeof(T)>(dst + w, src + w);
                else
                    dst[w] = T(0);
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
    for (long long tile = first; tile < last; ++tile) {
        const int k = static_cast<int>(tile - first);
        const int s = stages == 2 ? k & 1 : 0;
        if (stages == 2) {
            if (tile + 1 < last) stage(tile + 1, s ^ 1);
            cp_async_commit();
            cp_async_wait_prev();               // this thread's copies of `tile` landed
        } else {
            cp_async_wait_all();
        }
        const long long base = base_of(tile);
        const T* xs = stage_mem + s * CW + q;
        const long long row_end = min((tile + 1) * tile_brows, n_brow);
        if (vec) mbar_wait(bar + s, (stages == 2 ? k >> 1 : k) & 1);   // the bulk copy
        __syncthreads();                        // and everyone else's
        for (long long b0 = tile * tile_brows + 2 * warp; b0 < row_end; b0 += 2 * kW) {
            const long long brow = b0 + h;
            const bool live = brow < row_end;   // per half-warp: no early exit
            T p[1][4] = {{T(0), T(0), T(0), T(0)}};
            // Slots [l0, l0 + kU) of the block-row: every block in flight
            // before the first FMA, slots in ascending order.
            for (int l0 = 0; l0 < L; l0 += kU) {
                T bv[kU][4];
                int off[kU];
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const bool ok = live && l0 + u < L;
                    const long long slot = brow * L + l0 + u;
                    const long long w = ok ? __ldcs(wcols + slot) - base : -1;
                    off[u] = (w >= 0 && w < Wt) ? static_cast<int>(w) * 8 : W;
                    const T* blk = blocks + slot * 64 + e0;
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        bv[u][e] = ok ? arn::ldcs(blk + (e & 1) * 4 + (e >> 1) * 32) : T(0);
                }
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    if (l0 + u >= L) break;     // the same in the whole warp
                    const T x_q = xs[off[u]], x_q4 = xs[off[u] + 4];
                    p[0][0] = arn::fma_rn(bv[u][0], x_q, p[0][0]);
                    p[0][1] = arn::fma_rn(bv[u][1], x_q4, p[0][1]);
                    p[0][2] = arn::fma_rn(bv[u][2], x_q, p[0][2]);
                    p[0][3] = arn::fma_rn(bv[u][3], x_q4, p[0][3]);
                }
            }
            reduce_write<T, 1>(p, q, rq, brow, live, 1, y, n_rows);
        }
        __syncthreads();                        // the stage is read out before it is refilled
        if (stages == 1 && tile + 1 < last) {
            stage(tile + 1, 0);
            cp_async_commit();
        }
    }
}

// ---- The 8 x 8 b-column gather kernel -----------------------------------

// N bytes from src into shared memory, or N zero bytes (src not read) when
// !ok.  16-byte copies bypass L1 (x is not reused within an SM).
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool ok) {
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "n"(N), "r"(ok ? N : 0)
                     : "memory");
}

// Warp w of the persistent grid's NW warps takes the block-row pairs w,
// w + NW, w + 2 NW, ... (ops/kernels/spmv_bsr.py, gather8_steps, is the same
// walk on the host), so the rows in flight form one compact range and the
// band of X they read stays in L2.  A pair's steps are (pass, chunk of kU
// slots) in order; pass p covers columns [p G, min(nb, (p + 1) G)).  A step
// copies the x segments of its blocks (kU slots of each block-row, cnt
// columns, 64 B each in f64) into the half-warp's slice of shared memory
// with cp.async, loads the blocks into registers (evict first), loads the
// next step's ids, and contracts once both have landed; the last chunk of
// a pass finishes its rows with reduce_write.
// WINDOW: the window kernel's walk (its b-column form on 8 x 8 blocks,
// where the wrapper's plan takes it): the ids are the window layout's, and
// an id outside its tile's window [base, base + Wt) (base clamped as the
// staged kernel clamps it) reads zero, as the staged kernel's zero
// block-column does.  The check is made where the ids are loaded, a step
// ahead.
template <typename T, int G, int THREADS, int MIN_BLOCKS, bool WINDOW>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
spmv_bsr_gather8_kernel(const T* __restrict__ blocks, const int* __restrict__ cols,
                        const T* __restrict__ x, T* __restrict__ y, long long n_brow,
                        int L, long long n_rows, long long n_cols, int nb, int vec,
                        const int* __restrict__ tile_base, int tile_brows, int Wt) {
    constexpr int kW = THREADS / 32;
    constexpr int kU = 4;                   // slots of a block-row a step
    constexpr int kV = 16 / sizeof(T);      // values of one 16-byte copy
    constexpr int kPad = 32 / sizeof(T);    // puts the half-warps on other banks
    constexpr int kSlice = kU * G * 8 + kPad;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h = lane >> 4, hl = lane & 15, q = lane & 3, rq = hl >> 2;
    const int e0 = rq * 8 + q;
    T* xs = reinterpret_cast<T*>(smem) + (warp * 2 + h) * kSlice;
    const long long nw = static_cast<long long>(gridDim.x) * kW;
    const long long n_pairs = (n_brow + 1) / 2;
    const int chunks = (L + kU - 1) / kU;
    const int per_pair = ((nb + G - 1) / G) * chunks;

    // Step r of pair `pair`: its half-warp's block-row, first column and
    // first slot.
    auto where = [&](long long pair, int r, long long& brow, int& j0, int& l0) {
        const int pass = r / chunks;
        j0 = pass * G;
        l0 = (r - pass * chunks) * kU;
        brow = 2 * pair + h;
    };
    // The window's base, clamped so that it stays inside max(n_bcol, Wt)
    // block-columns (spmv_bsr.py:224): read when load_ids starts a pair.
    const long long base_max = max((n_cols + 7) / 8, static_cast<long long>(Wt)) - Wt;
    long long base = 0;
    auto load_ids = [&](long long pair, int r, int (&id)[kU]) {
        long long brow;
        int j0, l0;
        where(pair, r, brow, j0, l0);
        const bool live = pair < n_pairs && brow < n_brow;
        if constexpr (WINDOW)
            if (r == 0 && live)
                base = min(max(static_cast<long long>(
                                   tile_base[static_cast<int>(brow) / tile_brows]), 0LL),
                           base_max);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            id[u] = live && l0 + u < L ? __ldcs(cols + brow * L + l0 + u) : -1;
            if constexpr (WINDOW)
                if (id[u] - base < 0 || id[u] - base >= Wt) id[u] = -1;
        }
    };

    int id[kU], nid[kU];
    T p[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = T(0);
    long long pair = static_cast<long long>(blockIdx.x) * kW + warp;
    int r = 0;
    load_ids(pair, 0, id);
    while (pair < n_pairs) {
        long long brow;
        int j0, l0;
        where(pair, r, brow, j0, l0);
        long long pair_next = pair;
        int r_next = r + 1;
        if (r_next == per_pair) {
            r_next = 0;
            pair_next += nw;
        }
        const bool live = brow < n_brow;
        const int cnt = min(G, nb - j0);
        const T* xj0 = x + static_cast<long long>(j0) * n_cols;
        // x segment (u, j) -> xs[(u * G + j) * 8 ...]; an id outside
        // [0, n_bcol) or values past n_cols read zero.  Slots past L, columns
        // past cnt and the rows of a dead half-warp are not copied (and never
        // reach y).
        if (vec) {
            constexpr int kC = 8 / kV, kItems = kU * G * kC;
#pragma unroll
            for (int s = 0; s < kItems / 16; ++s) {
                const int i = hl + 16 * s;
                const int u = i / (G * kC), j = (i / kC) % G, c = i % kC;
                if (live && l0 + u < L && j < cnt) {
                    const long long g = static_cast<long long>(id[u]) * 8 + c * kV;
                    const bool ok = id[u] >= 0 && g < n_cols;
                    cp_async_zfill<16>(xs + (u * G + j) * 8 + c * kV,
                                       ok ? xj0 + j * n_cols + g : x, ok);
                }
            }
        } else {
            constexpr int kItems = kU * G * 8;
#pragma unroll
            for (int s = 0; s < kItems / 16; ++s) {
                const int i = hl + 16 * s;
                const int u = i / (G * 8), j = (i / 8) % G, e = i % 8;
                if (live && l0 + u < L && j < cnt) {
                    const long long g = static_cast<long long>(id[u]) * 8 + e;
                    const bool ok = id[u] >= 0 && g < n_cols;
                    cp_async_zfill<sizeof(T)>(xs + (u * G + j) * 8 + e,
                                              ok ? xj0 + j * n_cols + g : x, ok);
                }
            }
        }
        cp_async_commit();
        T bv[kU][4];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const bool ok = live && l0 + u < L;
            const T* blk = blocks + (brow * L + l0 + u) * 64 + e0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                bv[u][e] = ok ? arn::ldcs(blk + (e & 1) * 4 + (e >> 1) * 32) : T(0);
        }
        load_ids(pair_next, r_next, nid);
        cp_async_wait_all();
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            if (l0 + u >= L) break;             // the same in the whole warp
#pragma unroll
            for (int j = 0; j < G; ++j) {
                if (j < cnt) {
                    const T* xu = xs + (u * G + j) * 8 + q;
                    const T x_q = xu[0], x_q4 = xu[4];
                    p[j][0] = arn::fma_rn(bv[u][0], x_q, p[j][0]);
                    p[j][1] = arn::fma_rn(bv[u][1], x_q4, p[j][1]);
                    p[j][2] = arn::fma_rn(bv[u][2], x_q, p[j][2]);
                    p[j][3] = arn::fma_rn(bv[u][3], x_q4, p[j][3]);
                }
            }
        }
        __syncwarp();                           // the slice is read out before it is refilled
        if (l0 + kU >= L) {                     // the pass's last chunk
            reduce_write<T, G>(p, q, rq, brow, live, cnt,
                               y + static_cast<long long>(j0) * n_rows, n_rows);
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) p[j][e] = T(0);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) id[u] = nid[u];
        pair = pair_next;
        r = r_next;
    }
}

// Stages: two when two of the window's stages fit (the next tile's copy
// overlaps this tile), else one: a fixed rule on the shapes.
template <typename T, int THREADS, int MIN_BLOCKS>
int launch_window8_n(const T* blocks, const int* wcols, const int* tile_base,
                     const T* x, T* y, long long n_brow, int L, long long n_rows,
                     long long n_cols, int tile_brows, int Wt, cudaStream_t s) {
    auto kernel = spmv_bsr_window8_kernel<T, THREADS, MIN_BLOCKS>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t stage = static_cast<size_t>(Wt + 1) * 8 * sizeof(T);
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
    const int n_sm = arn::sm_count();
    if (n_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
    const long long n_tiles = (n_brow + tile_brows - 1) / tile_brows;
    const unsigned grid = static_cast<unsigned>(
        std::min(n_tiles, static_cast<long long>(per_sm[kb]) * n_sm));
    // Bulk copies need 16-byte aligned windows and lengths: x's pointer, x0
    // (a multiple of 8 values) and the last window's end, n_cols.
    const int vec = reinterpret_cast<size_t>(x) % 16 == 0
                    && (n_cols * static_cast<long long>(sizeof(T))) % 16 == 0;
    kernel<<<grid, THREADS, smem, s>>>(blocks, wcols, tile_base, x, y, n_brow, L, n_rows,
                                       n_cols, tile_brows, Wt, stages, n_tiles, vec);
    return static_cast<int>(cudaGetLastError());
}

bool valid_block(int r, int c) {
    return r >= 1 && c >= 1 && c <= 32 && (c & (c - 1)) == 0 && r * c <= 256;
}

int k_of(int r, int c) {
    const int e = r * c;
    return e <= 32 ? 1 : e <= 64 ? 2 : e <= 128 ? 4 : 8;
}

// The 8 x 8 gather kernel's launch: a persistent grid of the blocks that fit
// an SM (cached per instantiation) times the SMs, at most one warp a pair.
// 16-byte copies need X's pointer and row stride 16-byte aligned (block
// columns start at multiples of 8 values); other views copy value by value.
// WINDOW: the window kernel's walk (tile_base, tile_brows and Wt are the
// window layout's; the gather passes nullptr, 1, 1).
template <typename T, int G, int THREADS, int MIN_BLOCKS, bool WINDOW>
int launch_gather8_n(const T* blocks, const int* cols, const T* x, T* y, long long n_brow,
                     int L, long long n_rows, long long n_cols, int nb, cudaStream_t s,
                     const int* tile_base, int tile_brows, int Wt) {
    auto kernel = spmv_bsr_gather8_kernel<T, G, THREADS, MIN_BLOCKS, WINDOW>;
    constexpr int kW = THREADS / 32;
    constexpr size_t smem = kW * 2 * (4 * G * 8 + 32 / sizeof(T)) * sizeof(T);
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    static int per_sm = 0;
    if (per_sm == 0) {
        const cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const int n_sm = arn::sm_count();
    if (n_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
    const long long n_pairs = (n_brow + 1) / 2;
    const unsigned grid = static_cast<unsigned>(
        std::min((n_pairs + kW - 1) / kW, static_cast<long long>(per_sm) * n_sm));
    const int vec = reinterpret_cast<size_t>(x) % 16 == 0
                    && (n_cols * static_cast<long long>(sizeof(T))) % 16 == 0;
    kernel<<<grid, THREADS, smem, s>>>(blocks, cols, x, y, n_brow, L, n_rows, n_cols, nb, vec,
                                       tile_base, tile_brows, Wt);
    return static_cast<int>(cudaGetLastError());
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
        constexpr int kCols = Plan<T>::kCols;
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
    // 8 x 8 blocks at b >= 2 take the staged gather kernel; every other
    // shape, and every single column, the first gather kernel.
    if (r == 8 && c == 8 && nb >= 2)
        return launch_gather8_n<T, kGatherCols, Plan<T>::kGatherThreads, 1, false>(
            blocks, cols, x, y, n_brow, L, n_rows, n_cols, nb, s, nullptr, 1, 1);
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
    return launch_window_kn<T, K, Plan<T>::kCols>(blocks, wcols, tile_base, x, y, n_brow, L, r, c,
                                         n_rows, n_cols, nb, tile_brows, Wt, per_pass, s);
}

template <typename T>
int launch_window(const T* blocks, const int* wcols, const int* tile_base,
                  const T* x, T* y, long long n_brow, int L, int r, int c,
                  long long n_rows, long long n_cols, int nb, int tile_brows,
                  int Wt, int per_pass, void* stream) {
    // 8 x 8 blocks: b >= 2 columns take the walk, which stages no window,
    // and one column the staged kernel (one or two stages of its window and
    // a zero block-column); per_pass is not read (ops/kernels/spmv_bsr.py,
    // window_plan, is the rule).  Every other shape takes the first window
    // kernel (one stage of per_pass windows).
    const bool eight = r == 8 && c == 8;
    const bool walk = eight && nb >= 2;
    const long long smem = eight
        ? static_cast<long long>(Wt + 1) * c * sizeof(T) + kBarBytes
        : static_cast<long long>(per_pass) * Wt * c * sizeof(T);
    if (n_brow < 0 || L < 1 || nb < 1 || !valid_block(r, c) || tile_brows < 1 || Wt < 1
        || (!eight && (per_pass < 1 || per_pass > Plan<T>::kCols))
        || (!walk && smem > kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_brow == 0 || n_rows == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (walk)
        return launch_gather8_n<T, kGatherCols, Plan<T>::kGatherThreads, 1, true>(
            blocks, wcols, x, y, n_brow, L, n_rows, n_cols, nb, s, tile_base, tile_brows, Wt);
    if (eight)
        return launch_window8_n<T, 256, Plan<T>::kOneBlocks>(
            blocks, wcols, tile_base, x, y, n_brow, L, n_rows, n_cols, tile_brows, Wt, s);
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

extern "C" int arn_spmv_bsr_c64(const arn::c64* blocks, const int* cols, const arn::c64* x,
                                arn::c64* y, long long n_brow, int L, int r, int c,
                                long long n_rows, long long n_cols, int nb, void* stream) {
    return launch_gather<arn::c64>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb,
                                   stream);
}

extern "C" int arn_spmv_bsr_c128(const arn::c128* blocks, const int* cols,
                                 const arn::c128* x, arn::c128* y, long long n_brow, int L,
                                 int r, int c, long long n_rows, long long n_cols, int nb,
                                 void* stream) {
    return launch_gather<arn::c128>(blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb,
                                    stream);
}

extern "C" int arn_spmv_bsr_window_c64(const arn::c64* blocks, const int* wcols,
                                       const int* tile_base, const arn::c64* x, arn::c64* y,
                                       long long n_brow, int L, int r, int c,
                                       long long n_rows, long long n_cols, int nb,
                                       int tile_brows, int Wt, int per_pass, void* stream) {
    return launch_window<arn::c64>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows,
                                   n_cols, nb, tile_brows, Wt, per_pass, stream);
}

extern "C" int arn_spmv_bsr_window_c128(const arn::c128* blocks, const int* wcols,
                                        const int* tile_base, const arn::c128* x,
                                        arn::c128* y, long long n_brow, int L, int r, int c,
                                        long long n_rows, long long n_cols, int nb,
                                        int tile_brows, int Wt, int per_pass, void* stream) {
    return launch_window<arn::c128>(blocks, wcols, tile_base, x, y, n_brow, L, r, c, n_rows,
                                    n_cols, nb, tile_brows, Wt, per_pass, stream);
}
