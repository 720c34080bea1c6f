// ELLPACK SpMV: y[r] = sum_l data[r, l] * x[cols[r, l]], for nb columns at
// once.  The columns are rows of (nb, n_cols) and (nb, n_rows) arrays (the
// block expansion's b contiguous basis rows): column j of x starts at
// x + j*n_cols, column j of y at y + j*n_rows.
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_ell.py, ell_matvec_pallas, and its
// b-column form (EllOperator.matmat, a take + einsum in the JAX package).
// The TPU kernel held all of x in VMEM because its vector unit cannot gather
// from device memory; here the hardware gathers and L1/L2 keep x's hot part
// on chip.  Padding slots hold column 0 with weight 0, so they need no branch.
//
// Bound: device-memory bytes, and the latency of the scattered x gathers.  A
// row reads L values and L int32 column ids (row-major (n_rows, L) arrays)
// plus L gathered x entries per column, for 2*L*nb flops.  At the scattered
// 2^20-row test matrix (L = 25) in f64 a single column needs at least 331 MB
// a call (values, ids, x once, y); eight columns 449 MB.
//
// What held the first design (a group of G = pow2(L) <= 32 threads per row,
// a shuffle tree per row) at 41 % (one column) and 13 % (eight) of that
// bound, and what this design does about each:
//  * idle lanes: G = 32 at L = 25 left 7 of 32 lanes idle.  Short rows now
//    take one thread each, so every lane works.
//  * too little in flight: a warp had one row's 300 B of values and ids in
//    flight at a time.  Now a block stages whole tiles of R rows (one
//    contiguous run of R*L values and ids, 19.2 KB for R = 64 at L = 25 in
//    f64) with 16-byte cp.async copies, double-buffered in a persistent grid:
//    the next tile's copy is in flight while the current tile's x gathers
//    run.  Each thread also issues a whole group of gathers before it uses
//    them.  Tiles are small (R = 32 rows for one column, 64 for several) so
//    that many blocks, and their gathers, are in flight on an SM: on the
//    H100 at L = 25, 128-row tiles took 0.119 ms (one column) and 0.266 ms
//    (eight), 64-row tiles 0.121 and 0.189 ms, 32-row tiles 0.116 and
//    0.267 ms (scripts/ell_ab.py on variants of this file).
//  * shuffle cost: each row ended in a 5-level shuffle tree (10 shuffles per
//    f64 column).  A thread that owns its row needs none.
//  * costly indexing: row = tid / G was a 64-bit division by a runtime value.
//    The row is now threadIdx.x plus the tile's base; a gather is one 32-bit
//    index scaled onto its column's base pointer (one IMAD.WIDE), whatever
//    nb * n_cols is.
//  * scattered y writes: lane 0 of each group wrote alone.  Now a warp
//    writes 32 consecutive y values of each column.
//  * the b-column form multiplied all of that (8 accumulators per lane, 8 x
//    5 shuffle levels per row, a j < cnt test on every gather).  It now
//    stages each value and id once for all its columns, puts ceil(b/2)
//    threads on a staged row (two columns each: more gathers in flight), is
//    instantiated per column count (NB = 1..8, no per-gather test), and
//    writes each column coalesced.
//
// Which path runs is a fixed rule on L, and the tile height one on the
// column count (never a caught failure):
//  * L <= kMaxShortL (32): the staged tile kernel, a thread per row and
//    column pair.  A thread walks its row's slots in order from shared
//    memory.  Rows are
//    L elements apart there, so for odd L a half-warp's f64 reads (and a
//    warp's id reads) hit distinct banks; even L costs bank conflicts (up to
//    8-way at L = 24), which the main path's matrices (L = 25) do not meet.
//    Above 32 slots a row fills a warp's loads by itself, and a thread per
//    row would leave fewer rows, so fewer gathers, in flight on an SM
//    (an SM stages about 228 KB / (2 * L * 12 B) rows in f64).
//  * L > kMaxShortL: a warp per row reads its slots straight from device
//    memory (32 consecutive slots per load, long rows keep enough bytes in
//    flight: 80 % of HBM peak at L = 129 in the first design); the
//    single-column form keeps the first design's shuffle tree and its bits,
//    and the b-column form replaces 8 x 5 tree levels by a reduce-scatter
//    (4 + 2 + 1 + 1 + 1 shuffles) that sums every column in the same tree.
// Every reduction runs in a fixed order (no atomics), so runs are
// bit-identical, and every column of the b-column form gets the bits the
// single-column form gives it: both forms of a path sum a column's slots in
// the same order (ascending l in a thread; the same xor tree in a warp).
// Sums accumulate in the operand dtype.
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxShortL = 32;    // the staged path's longest row
constexpr int kWarpThreads = 256; // threads per block of the warp-per-row path
constexpr int kMaxCols = 8;       // columns per launch
constexpr int kStages = 2;
constexpr int kThreadCols = 2;    // columns per thread of the staged path

// Rows per staged tile of an NB-column launch: a multiple of 32, so that
// every tile starts 16-byte aligned and no warp straddles two column groups.
template <int NB>
constexpr int kTileRows = NB == 1 ? 32 : 64;

// Threads per row of the staged path: each takes kThreadCols of the NB
// columns (the last one the rest), so b columns put ceil(b/2) threads on a
// staged row and more gathers in flight per SM.
template <int NB>
constexpr int kGroups = (NB + kThreadCols - 1) / kThreadCols;

template <typename T>
constexpr size_t stage_bytes(int rows, int L) {
    return static_cast<size_t>(rows) * L * (sizeof(T) + sizeof(int));
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

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

// One row's product with NC columns: the slots in ascending order from
// shared memory, U slots' gathers issued before their FMAs.
template <typename T, int NC>
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
            for (int j = 0; j < NC; ++j) g[u][j] = __ldg(xs[j] + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[j] = fma_rn(v[u], g[u][j], acc[j]);
    }
    for (; l < L; ++l) {
        const int col = c[l];
        const T v = d[l];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] = fma_rn(v, __ldg(xs[j] + col), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) y[j * n_rows + row] = acc[j];
}

template <typename T, int NB>
__global__ void __launch_bounds__(kTileRows<NB> * kGroups<NB>)
spmv_ell_tiles_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                      const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                      long long n_cols, int L, long long n_tiles, int vec) {
    constexpr int R = kTileRows<NB>;
    extern __shared__ __align__(16) unsigned char smem[];
    T* sv = reinterpret_cast<T*>(smem);                      // [kStages][R*L]
    int* sc = reinterpret_cast<int*>(sv + kStages * R * L);  // [kStages][R*L]
    const int r = threadIdx.x % R;
    const int j0 = static_cast<int>(threadIdx.x / R) * kThreadCols;
    x += j0 * n_cols;
    y += j0 * n_rows;

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
        if (row < n_rows) {
            const T* d = sv + stage * R * L + r * L;
            const int* c = sc + stage * R * L + r * L;
            constexpr int kLast = NB - (kGroups<NB> - 1) * kThreadCols;
            if (kLast == kThreadCols || j0 + kThreadCols <= NB)
                row_product<T, (NB < kThreadCols ? NB : kThreadCols)>(
                    d, c, L, x, n_cols, y, n_rows, row);
            else
                row_product<T, kLast>(d, c, L, x, n_cols, y, n_rows, row);
        }
        __syncthreads();           // the stage is read out before it is refilled
        stage ^= 1;
    }
}

// Long rows: a warp per row, slots l = lane, lane + 32, ...
template <typename T, int NB>
__global__ void __launch_bounds__(kWarpThreads)
spmv_ell_warp_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                     const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                     long long n_cols, int L) {
    const long long row = static_cast<long long>(blockIdx.x) * (kWarpThreads / 32)
                          + (threadIdx.x >> 5);
    if (row >= n_rows) return;   // the whole warp: a warp holds one row
    const int lane = threadIdx.x & 31;
    const T* d = data + row * L;
    const int* c = cols + row * L;
    const T* xs[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) xs[j] = x + j * n_cols;
    T acc[kMaxCols];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[j] = T(0);
    for (int l = lane; l < L; l += 32) {
        const T v = d[l];
        const int col = c[l];
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[j] = fma_rn(v, __ldg(xs[j] + col), acc[j]);
    }
    if (NB == 1) {
        for (int off = 16; off > 0; off >>= 1)
            acc[0] += __shfl_down_sync(0xffffffffu, acc[0], off);
        if (lane == 0) y[row] = acc[0];
        return;
    }
    // Reduce-scatter over the 8 column slots (unused ones hold 0 and are not
    // written): at each level a lane keeps half of its columns and adds its
    // xor partner's copies of them.  Each column is the xor tree of the
    // 32 lanes' partial sums, the tree the single-column form's shuffle-down
    // leaves in lane 0 (each level adds the same two subtotals, and IEEE
    // addition commutes).  Lane 4j ends with column j.
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    T h4[4], h2[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const T give = b4 ? acc[k] : acc[4 + k];
        const T keep = b4 ? acc[4 + k] : acc[k];
        h4[k] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const T give = b3 ? h4[k] : h4[2 + k];
        const T keep = b3 ? h4[2 + k] : h4[k];
        h2[k] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
    }
    T s = (b2 ? h2[1] : h2[0]) + __shfl_xor_sync(0xffffffffu, b2 ? h2[0] : h2[1], 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    const int j = lane >> 2;
    if ((lane & 3) == 0 && j < NB) y[j * n_rows + row] = s;
}

template <typename T, int NB>
int launch_tiles(const T* data, const int* cols, const T* x, T* y, long long n_rows,
                 long long n_cols, int L, cudaStream_t s) {
    constexpr int R = kTileRows<NB>, threads = R * kGroups<NB>;
    auto kernel = spmv_ell_tiles_kernel<T, NB>;
    // Let this instantiation take the longest rows' two stages (48 KB for 64
    // rows in f64, the most a launch gets without the attribute), once: the
    // static is per <T, NB>.
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kStages * stage_bytes<T>(R, kMaxShortL)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    // Blocks that fit an SM at this L, per instantiation and L (a fixed rule
    // on the shapes: the grid never changes which thread sums which row).
    static int per_sm[kMaxShortL + 1] = {};
    const size_t smem = kStages * stage_bytes<T>(R, L);
    if (per_sm[L] == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[L], kernel, threads, smem);
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
    kernel<<<blocks, threads, smem, s>>>(data, cols, x, y, n_rows, n_cols, L, n_tiles, vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB>
int launch_nb(const T* data, const int* cols, const T* x, T* y, long long n_rows,
              long long n_cols, int L, cudaStream_t s) {
    if (L <= kMaxShortL) return launch_tiles<T, NB>(data, cols, x, y, n_rows, n_cols, L, s);
    const unsigned blocks = static_cast<unsigned>(
        (n_rows + kWarpThreads / 32 - 1) / (kWarpThreads / 32));
    spmv_ell_warp_kernel<T, NB><<<blocks, kWarpThreads, 0, s>>>(
        data, cols, x, y, n_rows, n_cols, L);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ell(const T* data, const int* cols, const T* x, T* y,
               long long n_rows, long long n_cols, int L, int nb, void* stream) {
    if (n_rows < 0 || n_cols < 0 || L < 1 || nb < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    // Columns go kMaxCols to a launch; each launch reads the values and ids
    // once for its columns.
    for (int j0 = 0; j0 < nb; j0 += kMaxCols) {
        const T* xj = x + static_cast<long long>(j0) * n_cols;
        T* yj = y + static_cast<long long>(j0) * n_rows;
        int rc;
        switch (std::min(kMaxCols, nb - j0)) {
            case 1: rc = launch_nb<T, 1>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            case 2: rc = launch_nb<T, 2>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            case 3: rc = launch_nb<T, 3>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            case 4: rc = launch_nb<T, 4>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            case 5: rc = launch_nb<T, 5>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            case 6: rc = launch_nb<T, 6>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            case 7: rc = launch_nb<T, 7>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
            default: rc = launch_nb<T, 8>(data, cols, xj, yj, n_rows, n_cols, L, s); break;
        }
        if (rc != 0) return rc;
    }
    return 0;
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
