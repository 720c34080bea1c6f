// ELLPACK SpMV: y[r] = sum_l data[r, l] * x[cols[r, l]], for nb columns at
// once.  The columns are rows of (nb, n_cols) and (nb, n_rows) arrays (the
// block expansion's b contiguous basis rows, the filter's s): column j of x
// starts at x + j*n_cols, column j of y at y + j*n_rows.
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_ell.py, ell_matvec_pallas, and its
// b-column form (EllOperator.matmat, a take + einsum in the JAX package).
// The TPU kernel held all of x in VMEM because its vector unit cannot gather
// from device memory; here the hardware gathers and L1/L2 keep x's hot part
// on chip.  Padding slots hold column 0 with weight 0, so they need no branch.
//
// Bound: device-memory bytes, and the latency of the x gathers.  A row
// reads L values and L int32 column ids (row-major (n_rows, L) arrays) plus
// L gathered x entries per column, for 2*L*nb flops.  At the scattered
// 2^20-row test matrix (L = 25) in f64 a single column needs at least 331 MB
// a call (values, ids, x once, y); eight columns 449 MB.  At the filter's b
// = s the slots are 2 % of the bytes and x and y the rest: 154 MB at b =
// 327 in f32 on laplace_3d(48)'s 2-rank halo shard (55,296 rows against
// 59,904 columns, L = 7), 295 MB on laplace_3d(48) itself: only one launch
// that streams all of x and y once can come near the bound.
//
// Every call is one launch.  The path is a fixed rule on (L, nb), and so
// are its tile height and grid (ell_plan in ops/kernels/spmv_ell.py mirrors
// it):
//  * L <= kMaxShortL (32), one column: the persistent-tile kernel of the
//    first redesign.  A persistent grid stages whole tiles of 32 rows
//    (32*L values and ids) with 16-byte cp.async copies, double buffered:
//    the next tile's copy is in flight while the current tile's x gathers
//    run.  A thread owns a row, walks its slots in ascending order from
//    shared memory and issues 8 slots' gathers before their FMAs; a warp
//    writes 32 consecutive y values.  That design took the first kernel (a
//    group of pow2(L) threads per row, a shuffle tree per row) from 41 % of
//    the bound to 86 % (PERF.md).
//  * L <= kMaxShortL, b >= 2 (the block driver's b = 8, the filter's b = s):
//    the column-group kernel.  The first redesign sent b columns 8 to a launch
//    of the persistent-tile kernel (2 columns a thread): at the filter's b =
//    327 that made 41 launches, each moving 4-7 MB in 4.6-6.8 us of device
//    time on an H100 80GB HBM3 at 700.00 W, mostly its grid's ramp and tail,
//    each staging every tile's slots again, and 264 us of host enqueue a call,
//    which put the event time of the halo shard above cuSPARSE's single SpMM.
//    Now block (tile, group) stages its 64-row tile once (one cp.async pass:
//    the block has one tile) and serves the group's 64 columns from shared
//    memory; a tile's slots come from device memory once and from L2 for the
//    other groups (the slots of the main path's matrices fit L2). Threads map
//    to (row, column) pairs with rows fastest, so a warp's gathers of one
//    column fall on neighbouring x entries on a stencil; a thread keeps NC
//    columns' sums in registers, issues each group of 4 slots' gathers before
//    their FMAs, and writes y with streaming stores; a block takes no more
//    threads a row (at most 4) than its group fills. NC is 4 above 8 columns
//    (2 in complex128) and 2 up to 8.  Measured on that card
//    (scripts/ell_ab.py on variants of this file, PERF.md §6): at b = 327 one
//    group of all columns a block (a block that walks its tile's columns) lost
//    3-15 %, 256-row tiles at short rows 8-21 % on three of four forms (the
//    halo shard's 1,296 blocks are 1.2 waves of those that fit), 32-row tiles
//    5-10 %, 32- or 128-column groups up to 4 %, 8 columns a thread 3-25 % and
//    2 a thread 3-18 % (f32, f64); at b = 8, 4 columns a thread took 0.2270 ms
//    (f64) and 0.2667 (c64) against 2's 0.1798 and 0.1873, and 2 beat the
//    persistent tiles in f64 and c128 (0.1925 and 0.3729 ms) and matched them
//    in c64 (0.1853).
//  * L > kMaxShortL: a warp per row reads its slots straight from device
//    memory (32 consecutive slots per load, long rows keep enough bytes in
//    flight); the single-column form keeps the first design's shuffle tree
//    and its bits, and the b-column form sums 8 columns at a time in the
//    same tree by a reduce-scatter (4 + 2 + 1 + 1 + 1 shuffles), its chunks
//    of 8 looping inside the one launch at b > 8 (each chunk reading the
//    row's slots again, from L1).
// The staged paths read slots L elements apart in shared memory, so for odd
// L a half-warp's f64 reads (and a warp's id reads) hit distinct banks;
// even L costs bank conflicts (up to 8-way at L = 24), which the main
// path's matrices (L = 7, 25) do not meet.
//
// The bits: every reduction runs in a fixed order (no atomics), so runs are
// bit-identical, and every column of the b-column form gets the bits the
// single-column form gives it: both forms of a path sum a column's slots in
// the same order (ascending l through arn::fma_rn from zero in a thread;
// the same xor tree in a warp).  Tiles, groups, passes and chunks change
// where and when a (row, column) pair is summed, never its order, so the
// outputs equal the first kernel's bit for bit.  Sums accumulate in the
// operand dtype.
//
// Complex forms (c64, c128): all paths over arn::complex values, each slot
// a fixed-order complex multiply-add (arn::fma_rn) and each shuffle moving
// the two halves of a value.  A complex128 slot stages 20 bytes (value and
// id); every stage stays under 48 KB (40 KB at most), and every tile starts
// 16-byte aligned, since R is a multiple of 32 and a value is 4-16 bytes.
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxShortL = 32;    // the staged paths' longest row
constexpr int kWarpThreads = 256; // threads per block of the warp-per-row path
constexpr int kMaxCols = 8;       // columns of a warp chunk; b of 2 a thread
constexpr int kStages = 2;        // stages of the single-column kernel
constexpr int kTileRows = 32;     // rows per tile of the single-column kernel
constexpr int kGroupRows = 64;    // rows per tile of the column-group kernel
constexpr int kGroupCols = 64;    // columns per block of the column-group kernel
constexpr int kGroupThreads = 256;  // the most threads a column-group block takes

// Columns a thread of the column-group kernel keeps in registers (its sums
// and U slots' gathers) above kMaxCols columns: 4, or 2 for complex128; at
// b <= kMaxCols it keeps 2 (more threads a row).
template <typename T>
constexpr int kRegCols = sizeof(T) == 16 ? 2 : 4;

template <typename T>
constexpr size_t stage_bytes(int rows, int L) {
    return static_cast<size_t>(rows) * L * (sizeof(T) + sizeof(int));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
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
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying tile `tile` (rows [tile*R, +R)) into one stage.  A full
// tile of a 16-byte-aligned operator moves as 16-byte copies (a tile starts
// 16-byte aligned because R is a multiple of 4); the tail tile and unaligned
// operators copy element by element.
template <typename T, int R>
__device__ __forceinline__ void stage_tile(T* sv, int* sc, const T* data,
                                           const int* cols, long long tile,
                                           long long n_rows, int L, bool vec) {
    const long long r0 = tile * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), n_rows - r0));
    const long long e0 = r0 * L;
    const int n = rows * L;
    if (vec && rows == R) {
        const char* gv = reinterpret_cast<const char*>(data + e0);
        const char* gc = reinterpret_cast<const char*>(cols + e0);
        char* dv = reinterpret_cast<char*>(sv);
        char* dc = reinterpret_cast<char*>(sc);
        const int nv = n * static_cast<int>(sizeof(T)) / 16;
        const int nc = n * static_cast<int>(sizeof(int)) / 16;
        for (int i = threadIdx.x; i < nv; i += blockDim.x) cp_async16(dv + 16 * i, gv + 16 * i);
        for (int i = threadIdx.x; i < nc; i += blockDim.x) cp_async16(dc + 16 * i, gc + 16 * i);
    } else {
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            cp_async_small<sizeof(T)>(sv + i, data + e0 + i);
            cp_async_small<sizeof(int)>(sc + i, cols + e0 + i);
        }
    }
}

// y = value, by a plain store or a streaming one (evict first).
template <bool kStream, typename T>
__device__ __forceinline__ void store(T* p, T v) {
    if (kStream)
        arn::stcs(p, v);
    else
        *p = v;
}

// One row's product with NC columns: the slots in ascending order from
// shared memory, U slots' gathers issued before their FMAs.
template <typename T, int NC, bool kStream = false>
__device__ __forceinline__ void row_product(const T* d, const int* c, int L,
                                            const T* __restrict__ x, long long n_cols,
                                            T* __restrict__ y, long long n_rows,
                                            long long row) {
    constexpr int U = NC >= 2 ? 4 : 8;
    const T* xs[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) xs[j] = x + j * n_cols;
    T acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = T(0);
    int l = 0;
    for (; l + U <= L; l += U) {
        T v[U], g[U][NC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int col = c[l + u];
            v[u] = d[l + u];
#pragma unroll
            for (int j = 0; j < NC; ++j) g[u][j] = arn::ldg(xs[j] + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[j] = arn::fma_rn(v[u], g[u][j], acc[j]);
    }
    for (; l < L; ++l) {
        const int col = c[l];
        const T v = d[l];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] = arn::fma_rn(v, arn::ldg(xs[j] + col), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) store<kStream>(y + j * n_rows + row, acc[j]);
}

// One column: a persistent grid walks the tiles, a thread a row, the next
// tile's copy in flight while the current tile's gathers run.
template <typename T>
__global__ void __launch_bounds__(kTileRows)
spmv_ell_tiles_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                      const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                      long long n_cols, int L, long long n_tiles, int vec) {
    constexpr int R = kTileRows;
    extern __shared__ __align__(16) unsigned char smem[];
    T* sv = reinterpret_cast<T*>(smem);                      // [kStages][R*L]
    int* sc = reinterpret_cast<int*>(sv + kStages * R * L);  // [kStages][R*L]
    const int r = threadIdx.x;

    long long tile = blockIdx.x;
    int stage = 0;
    if (tile < n_tiles) stage_tile<T, R>(sv, sc, data, cols, tile, n_rows, L, vec);
    cp_async_commit();
    for (; tile < n_tiles; tile += gridDim.x) {
        const long long next = tile + gridDim.x;
        if (next < n_tiles)
            stage_tile<T, R>(sv + (stage ^ 1) * R * L, sc + (stage ^ 1) * R * L,
                             data, cols, next, n_rows, L, vec);
        cp_async_commit();
        cp_async_wait_prev();      // this thread's copies of `tile` have landed
        __syncthreads();           // and everyone else's
        const long long row = tile * R + r;
        if (row < n_rows)
            row_product<T, 1>(sv + stage * R * L + r * L, sc + stage * R * L + r * L,
                              L, x, n_cols, y, n_rows, row);
        __syncthreads();           // the stage is read out before it is refilled
        stage ^= 1;
    }
}

// b >= 2 columns (the block driver's b = 8, the filter's b = s): block
// (tile, group) stages its R-row tile once and serves the group's
// kGroupCols columns from it.  Thread t takes row t % R of the tile (rows
// fastest: a warp's gathers of one column fall on neighbouring x entries on
// a stencil) and, of each pass of (blockDim.x / R) * NC columns, the NC at
// (t / R) * NC; the launch gives a block no more lanes (threads a row) than
// its group's columns fill.
template <typename T, int NC>
__global__ void __launch_bounds__(kGroupThreads)
spmv_ell_group_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                      const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                      long long n_cols, int L, int nb, int vec) {
    constexpr int R = kGroupRows;
    extern __shared__ __align__(16) unsigned char smem[];
    T* sv = reinterpret_cast<T*>(smem);             // [R*L]
    int* sc = reinterpret_cast<int*>(sv + R * L);   // [R*L]
    const long long tile = blockIdx.x;
    stage_tile<T, R>(sv, sc, data, cols, tile, n_rows, L, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int r = threadIdx.x % R;
    const long long row = tile * R + r;
    if (row >= n_rows) return;   // no barrier follows
    const T* d = sv + r * L;
    const int* c = sc + r * L;
    const int pass = static_cast<int>(blockDim.x / R) * NC;
    const int j_end = min(nb, static_cast<int>(blockIdx.y + 1) * kGroupCols);
    for (int j = static_cast<int>(blockIdx.y) * kGroupCols
                 + static_cast<int>(threadIdx.x / R) * NC;
         j < j_end; j += pass) {
        const T* xj = x + static_cast<long long>(j) * n_cols;
        T* yj = y + static_cast<long long>(j) * n_rows;
        const int cnt = min(NC, j_end - j);
        if (cnt == NC) {
            row_product<T, NC, true>(d, c, L, xj, n_cols, yj, n_rows, row);
        } else {   // the group's ragged end: two columns, then one
            int k = 0;
            for (; k + 2 <= cnt; k += 2)
                row_product<T, 2, true>(d, c, L, xj + k * n_cols, n_cols,
                                        yj + k * n_rows, n_rows, row);
            if (k < cnt)
                row_product<T, 1, true>(d, c, L, xj + k * n_cols, n_cols,
                                        yj + k * n_rows, n_rows, row);
        }
    }
}

// Long rows: a warp per row, slots l = lane, lane + 32, ...  kChunks: the
// columns go kMaxCols at a time through one launch (b > kMaxCols; the last
// chunk may be short), each chunk reading the row's slots again (from L1).
template <typename T, int NB, bool kChunks>
__global__ void __launch_bounds__(kWarpThreads)
spmv_ell_warp_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                     const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                     long long n_cols, int L, int nb) {
    const long long row = static_cast<long long>(blockIdx.x) * (kWarpThreads / 32)
                          + (threadIdx.x >> 5);
    if (row >= n_rows) return;   // the whole warp: a warp holds one row
    const int lane = threadIdx.x & 31;
    const T* d = data + row * L;
    const int* c = cols + row * L;
    for (int j0 = 0; j0 < (kChunks ? nb : NB); j0 += kMaxCols) {
        const int cnt = kChunks ? min(kMaxCols, nb - j0) : NB;
        const T* xs[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) xs[j] = x + static_cast<long long>(j0 + j) * n_cols;
        T acc[kMaxCols];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) acc[j] = T(0);
        for (int l = lane; l < L; l += 32) {
            const T v = d[l];
            const int col = c[l];
#pragma unroll
            for (int j = 0; j < NB; ++j)
                if (j < cnt) acc[j] = arn::fma_rn(v, arn::ldg(xs[j] + col), acc[j]);
        }
        if (NB == 1) {
            for (int off = 16; off > 0; off >>= 1)
                acc[0] += arn::shfl_down(acc[0], off);
            if (lane == 0) y[row] = acc[0];
            return;
        }
        // Reduce-scatter over the 8 column slots (unused ones hold 0 and are
        // not written): at each level a lane keeps half of its columns and
        // adds its xor partner's copies of them.  Each column is the xor
        // tree of the 32 lanes' partial sums, the tree the single-column
        // form's shuffle-down leaves in lane 0 (each level adds the same two
        // subtotals, and IEEE addition commutes).  Lane 4j ends with column j.
        const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
        T h4[4], h2[2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const T give = b4 ? acc[k] : acc[4 + k];
            const T keep = b4 ? acc[4 + k] : acc[k];
            h4[k] = keep + arn::shfl_xor(give, 16);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const T give = b3 ? h4[k] : h4[2 + k];
            const T keep = b3 ? h4[2 + k] : h4[k];
            h2[k] = keep + arn::shfl_xor(give, 8);
        }
        T s = (b2 ? h2[1] : h2[0]) + arn::shfl_xor(b2 ? h2[0] : h2[1], 4);
        s += arn::shfl_xor(s, 2);
        s += arn::shfl_xor(s, 1);
        const int j = lane >> 2;
        if ((lane & 3) == 0 && j < cnt) y[(j0 + j) * n_rows + row] = s;
    }
}

template <typename T>
int launch_tiles(const T* data, const int* cols, const T* x, T* y, long long n_rows,
                 long long n_cols, int L, cudaStream_t s) {
    constexpr int R = kTileRows;
    auto kernel = spmv_ell_tiles_kernel<T>;
    // Blocks that fit an SM at this L, per dtype and L (a fixed rule on the
    // shapes: the grid never changes which thread sums which row).  The
    // two stages of the longest rows take 40 KB at most: no attribute.
    static int per_sm[kMaxShortL + 1] = {};
    const size_t smem = kStages * stage_bytes<T>(R, L);
    if (per_sm[L] == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[L], kernel, R, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm[L] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const int n_sm = arn::sm_count();
    if (n_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
    const long long n_tiles = (n_rows + R - 1) / R;
    const unsigned blocks = static_cast<unsigned>(
        std::min(n_tiles, static_cast<long long>(per_sm[L]) * n_sm));
    const int vec = (reinterpret_cast<size_t>(data) % 16 == 0)
                    && (reinterpret_cast<size_t>(cols) % 16 == 0);
    kernel<<<blocks, R, smem, s>>>(data, cols, x, y, n_rows, n_cols, L, n_tiles, vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int launch_group(const T* data, const int* cols, const T* x, T* y, long long n_rows,
                 long long n_cols, int L, int nb, cudaStream_t s) {
    constexpr int R = kGroupRows;
    const int lanes = std::min(kGroupThreads / R,
                               (std::min(nb, kGroupCols) + NC - 1) / NC);
    const dim3 grid(static_cast<unsigned>((n_rows + R - 1) / R),
                    static_cast<unsigned>((nb + kGroupCols - 1) / kGroupCols));
    const int vec = (reinterpret_cast<size_t>(data) % 16 == 0)
                    && (reinterpret_cast<size_t>(cols) % 16 == 0);
    spmv_ell_group_kernel<T, NC><<<grid, R * lanes, stage_bytes<T>(R, L), s>>>(
        data, cols, x, y, n_rows, n_cols, L, nb, vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB, bool kChunks = false>
int launch_warp(const T* data, const int* cols, const T* x, T* y, long long n_rows,
                long long n_cols, int L, int nb, cudaStream_t s) {
    const unsigned blocks = static_cast<unsigned>(
        (n_rows + kWarpThreads / 32 - 1) / (kWarpThreads / 32));
    spmv_ell_warp_kernel<T, NB, kChunks><<<blocks, kWarpThreads, 0, s>>>(
        data, cols, x, y, n_rows, n_cols, L, nb);
    return static_cast<int>(cudaGetLastError());
}

// One launch a call.  The path is a fixed rule on (L, nb): L > kMaxShortL
// the warp per row (nb > kMaxCols in chunks of kMaxCols); else nb = 1 the
// single-column tiles, nb >= 2 the column groups.
template <typename T>
int launch_ell(const T* data, const int* cols, const T* x, T* y,
               long long n_rows, long long n_cols, int L, int nb, void* stream) {
    if (n_rows < 0 || n_cols < 0 || L < 1 || nb < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (L > kMaxShortL) {
        switch (nb) {
            case 1: return launch_warp<T, 1>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 2: return launch_warp<T, 2>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 3: return launch_warp<T, 3>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 4: return launch_warp<T, 4>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 5: return launch_warp<T, 5>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 6: return launch_warp<T, 6>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 7: return launch_warp<T, 7>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            case 8: return launch_warp<T, 8>(data, cols, x, y, n_rows, n_cols, L, nb, s);
            default: return launch_warp<T, kMaxCols, true>(data, cols, x, y, n_rows,
                                                           n_cols, L, nb, s);
        }
    }
    if (nb == 1) return launch_tiles<T>(data, cols, x, y, n_rows, n_cols, L, s);
    if (nb <= kMaxCols)
        return launch_group<T, 2>(data, cols, x, y, n_rows, n_cols, L, nb, s);
    return launch_group<T, kRegCols<T>>(data, cols, x, y, n_rows, n_cols, L, nb, s);
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

extern "C" int arn_spmv_ell_c64(const arn::c64* data, const int* cols, const arn::c64* x,
                                arn::c64* y, long long n_rows, long long n_cols, int L,
                                int nb, void* stream) {
    return launch_ell<arn::c64>(data, cols, x, y, n_rows, n_cols, L, nb, stream);
}

extern "C" int arn_spmv_ell_c128(const arn::c128* data, const int* cols,
                                 const arn::c128* x, arn::c128* y, long long n_rows,
                                 long long n_cols, int L, int nb, void* stream) {
    return launch_ell<arn::c128>(data, cols, x, y, n_rows, n_cols, L, nb, stream);
}
