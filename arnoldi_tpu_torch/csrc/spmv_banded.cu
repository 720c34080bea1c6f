// DIA (banded) SpMV: y[i] = sum_d bands[d, i] * x[i + off_d], zero outside
// the matrix, for nb columns at once.  The columns are rows of a (nb, n)
// array (the block expansion's b contiguous basis rows), read and written in
// that layout: column j of x starts at x + j*n, column j of y at y + j*n.
//
// Replaces: arnoldi_tpu/ops/pallas/spmv_banded.py, banded_matvec_pallas, and
// its b-column form (BandedOperator.matmat, a vmap in the JAX package).
//
// One entry point a dtype runs every form: the rows [row0, row0 + rows) of
// a row block of the bands (row stride bstride), against an x window of
// x_len entries a column in which row i reads x[i + x_base + off].  The
// square operator is its x_base = 0, x_len = n = bstride case; the shard
// form (spmv_dia_ext, the sharded operators of parallel/) runs it over
// [left halo | own block | right halo] (x_base = halo), over the whole
// vector (x_base = the block's first global row), and over the first and
// last halo rows alone (the halo fix-up).
//
// Bound: device-memory bytes.  Each row reads k band values and k x values
// per column and writes one y value per column: (k + nb*(k + 1)) elements
// for 2*k*nb flops, far below the card's flop-to-byte ratio.  When the
// caches serve x's reuse across the k offsets the least traffic is the
// bands once, x once and y once: at laplace_2d(724) (k = 5, n = 524,176) in
// float64 29 MB (0.0088 ms at 3.35 TB/s); at the filter's b = 297 on
// laplace_3d(64) (k = 7, n = 262,144) 1.26 GB (0.376 ms), of which the
// bands are 14.7 MB.
//
// What bounds each form, and the design (times: chip runs of
// scripts/dia_ab.py on an H100 80GB HBM3 at 700 W, PERF.md):
// - One column (nb = 1), the kernel of every scalar solve and of each CG
//   iteration of shift-invert.  At ~0.01 ms of device time a call, the
//   host's launch path set its pace (0.034-0.046 ms a call by events with
//   the first wrapper), which the lean launch in spmv_banded.py addresses.
//   On the device: each thread takes kPer16<T> consecutive rows (4 float,
//   2 double or complex64, 1 complex128), so each band is one 16-byte
//   streaming load (ldcs: read once a call, evict first) where the band
//   rows are 16-byte aligned, scalar loads otherwise and at the ragged
//   end; x comes through the read-only path, whose L1 serves the
//   neighbouring rows' reuse of it (0.0101 ms cold at laplace_2d(724) in
//   float64, 87 % of the bound; the first kernel 0.0118).  Staging each row
//   tile's x window in shared memory with one bulk (TMA) copy, the TPU
//   kernel's halo staging, measured slower (0.0127 ms) and is not used:
//   the window of a 512-row tile is 3.8 tiles wide at that span, and L1
//   already serves the reuse.
// - b columns (nb >= 2; the block driver's b = 8 and the filter's b = s).
//   The first b-column kernel kept 8 columns in registers and put each
//   further chunk of 8 in grid.y, so every chunk read the bands again (38
//   times at b = 297), and each offset's loads waited on the multiply-adds
//   before them.  Now a block of kColThreads rows walks up to kGroupCols
//   columns (its group, blockIdx.y) in chunks of kCols, keeping kCols sums
//   in registers: the first chunk reads each row's band values from device
//   memory and, where more chunks follow, keeps them in shared memory (each
//   thread its own row's, no barrier), so the bands are read once per 64
//   columns (5 times at b = 297) and the grid still has enough blocks to
//   end in an even last wave.  The loads of two offsets go out together
//   before their multiply-adds, which keeps more bytes in flight; written
//   as a loop over an array of steps the same step compiled slower, so it
//   is spelled out.  At b <= 8 an instance with one chunk and no group
//   runs.  The blocks resident at one time hold neighbouring row tiles of
//   one group, so x's reuse across the offsets comes from L2; y is written
//   with streaming stores.  At laplace_3d(64), b = 297: 0.536 ms, 70 % of
//   the bound (the first kernel 0.658); what is left bounds it: x read
//   through L2 for every offset, the +-4096 planes 16 row tiles away.
//
// The bits: every form gives each output element the same sum as the first
// kernel: the multiply-add chain over d = 0..k-1 in order through
// arn::madd, starting from zero, a term skipped when its x index leaves
// [0, x_len).  Rows per thread, load batching and column groups change
// where and when the operands are read, never the order of the operations,
// so each column of the b-column form equals the single-column form bit
// for bit, and the square form the shard form's x_base = 0 case.
//
// Complex forms (c64, c128): the same kernels over arn::complex values, each
// product a fixed-order complex multiply-add (common.cuh); a complex128
// element is 16 bytes, so the bound doubles float64's bytes.
//
// The Chebyshev filter's degree step (arn_cheby_dia, float32 and float64;
// ops/kernels/cheby_banded.py) replaces no Pallas kernel: the JAX package
// gets the same fusion from XLA, which fuses the recurrence's elementwise
// updates into one loop body under lax.fori_loop
// (arnoldi_tpu/solvers/filtered.py:181-208).  In eager PyTorch a step was
// five launches over (s, n) blocks: the b-column product, then four
// elementwise passes (13 block passes in all).  The step needs the bands
// once and five block passes: T_j and T_{j-1} read, T_{j+1} written, Y read
// and written; at laplace_3d(64), b = 297 in float64 3.13 GB, 0.934 ms at
// 3.35 TB/s.  Design: the b-column kernel's chunking as it is, with the
// recurrence as its epilogue in place of y's store (dia_cols, a template
// over the epilogue; the product kernel itself is left as it was): each
// thread loads its chunk's T_{j-1} and Y before the product, so that those
// loads are in flight with the product's x loads, turns its kCols sums into
// T_{j+1} in registers with T_j's own element (the offset-0 x value the
// product has just read, from the L1 or L2), and writes T_{j+1} over
// T_{j-1} in place (the wrapper rotates three blocks: T_{j-1}, T_j and Y).
// The first step writes T_1 and Y = c_0 X + c_1 T_1 without reading Y.
// Loading T_{j-1} and Y after the product measured 1.350 ms a step at b =
// 297 in float64 (69 % of the bound), before it 1.177 ms (79 %).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 16;
constexpr int kThreads = 256;      // the single-column kernel's block
constexpr int kColThreads = 256;   // the b-column kernel's block (row tile)
constexpr int kCols = 8;           // columns a thread keeps in registers
constexpr int kGroupCols = 64;     // columns a b-column block walks

struct DiaOffsets {
    long long off[kMaxOffsets];
    int k;
};

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

// One column: kPer16<T> consecutive rows a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_dia_rows_kernel(const T* __restrict__ bands, const T* __restrict__ x,
                     T* __restrict__ y, long long rows, long long row0,
                     long long bstride, long long x_base, long long x_len,
                     bool vec, DiaOffsets o) {
    constexpr int R = arn::kPer16<T>;
    const long long t0 =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * R;
    if (t0 >= rows) return;
    const long long i0 = row0 + t0;
    const int cnt = static_cast<int>(min(static_cast<long long>(R), rows - t0));
    const bool full = vec && cnt == R;
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
    for (int d = 0; d < o.k; ++d) {
        const T* bp = bands + static_cast<long long>(d) * bstride + i0;
        T bv[R];
        if (full) {
            arn::ldcs16(bv, bp);
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) bv[r] = r < cnt ? arn::ldcs(bp + r) : T(0);
        }
        const long long s0 = i0 + x_base + o.off[d];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const long long s = s0 + r;
            if (r < cnt && s >= 0 && s < x_len)
                acc[r] = arn::madd(acc[r], bv[r], arn::ldg(x + s));
        }
    }
    if (full) {
        arn::st16(y + t0, acc);
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (r < cnt) y[t0 + r] = acc[r];
    }
}

// b columns: one row a thread, up to kGroupCols columns (blockIdx.y's
// group) in chunks of kCols.  The first chunk reads the row's band values
// from device memory and, where more chunks follow, keeps them in shared
// memory for those.  kOne: b <= kCols, a single chunk and no group (the
// block driver's b = 8), compiled without the chunk bookkeeping.
template <typename T, bool kOne>
__global__ void __launch_bounds__(kColThreads)
spmv_dia_cols_kernel(const T* __restrict__ bands, const T* __restrict__ x,
                     T* __restrict__ y, long long rows, long long row0,
                     long long bstride, long long x_base, long long x_len,
                     int nb, DiaOffsets o) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* bs = reinterpret_cast<T*>(smem) + threadIdx.x;   // bs[d * kColThreads]
    const long long t = static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x;
    if (t >= rows) return;
    const long long i = row0 + t;
    const int j_begin = kOne ? 0 : static_cast<int>(blockIdx.y) * kGroupCols;
    const int j_end = kOne ? nb : min(nb, j_begin + kGroupCols);
    const bool keep = !kOne && j_end - j_begin > kCols;
    for (int j0 = j_begin; j0 < j_end; j0 += kCols) {
        const int cnt = kOne ? nb : min(kCols, j_end - j0);
        const T* xj = x + static_cast<long long>(j0) * x_len;
        T acc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = T(0);
        // Two offsets a step: their x loads and band values are all issued
        // before their multiply-adds, which run in the order of d.
        for (int d = 0; d < o.k; d += 2) {
            const bool two = d + 1 < o.k;
            const long long s0 = i + x_base + o.off[d];
            const long long s1 = two ? i + x_base + o.off[d + 1] : -1;
            const bool in0 = s0 >= 0 && s0 < x_len;
            const bool in1 = two && s1 >= 0 && s1 < x_len;
            T x0[kCols], x1[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const long long col = static_cast<long long>(j) * x_len;
                x0[j] = (in0 && j < cnt) ? arn::ldg(xj + col + s0) : T(0);
                x1[j] = (in1 && j < cnt) ? arn::ldg(xj + col + s1) : T(0);
            }
            T b0 = T(0), b1 = T(0);
            if (kOne || j0 == j_begin) {
                if (in0) b0 = arn::ldcs(bands + static_cast<long long>(d) * bstride + i);
                if (in1) b1 = arn::ldcs(bands + static_cast<long long>(d + 1) * bstride + i);
                if (keep) {
                    if (in0) bs[d * kColThreads] = b0;
                    if (in1) bs[(d + 1) * kColThreads] = b1;
                }
            } else {
                if (in0) b0 = bs[d * kColThreads];
                if (in1) b1 = bs[(d + 1) * kColThreads];
            }
            if (in0) {
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                    if (j < cnt) acc[j] = arn::madd(acc[j], b0, x0[j]);
            }
            if (in1) {
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                    if (j < cnt) acc[j] = arn::madd(acc[j], b1, x1[j]);
            }
        }
        T* yj = y + static_cast<long long>(j0) * rows + t;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
            if (j < cnt) arn::stcs(yj + static_cast<long long>(j) * rows, acc[j]);
    }
}

// spmv_dia_cols_kernel's body with an epilogue ep in place of y's store:
// each chunk's kCols sums go to ep with the output y and the chunk's x (xj,
// which the square form's epilogue indexes by t); ChebStep, the Chebyshev
// filter's degree step, is its epilogue.  The product kernel keeps its own
// copy of the body: run through this inlined function, its real instances
// at b > 8 compiled to another schedule (480 SASS instructions against 472
// in float64), 0.6 % slower at b = 297 in float64 and 2.5 % in float32.
template <typename T, bool kOne, typename Epilogue>
__device__ __forceinline__ void
dia_cols(const T* __restrict__ bands, const T* __restrict__ x, long long rows,
         long long row0, long long bstride, long long x_base, long long x_len,
         int nb, const DiaOffsets& o, T* __restrict__ y, const Epilogue& ep) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* bs = reinterpret_cast<T*>(smem) + threadIdx.x;   // bs[d * kColThreads]
    const long long t = static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x;
    if (t >= rows) return;
    const long long i = row0 + t;
    const int j_begin = kOne ? 0 : static_cast<int>(blockIdx.y) * kGroupCols;
    const int j_end = kOne ? nb : min(nb, j_begin + kGroupCols);
    const bool keep = !kOne && j_end - j_begin > kCols;
    for (int j0 = j_begin; j0 < j_end; j0 += kCols) {
        const int cnt = kOne ? nb : min(kCols, j_end - j0);
        const T* xj = x + static_cast<long long>(j0) * x_len;
        const auto pre = ep.load(y, cnt, j0, t);
        T acc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = T(0);
        // Two offsets a step: their x loads and band values are all issued
        // before their multiply-adds, which run in the order of d.
        for (int d = 0; d < o.k; d += 2) {
            const bool two = d + 1 < o.k;
            const long long s0 = i + x_base + o.off[d];
            const long long s1 = two ? i + x_base + o.off[d + 1] : -1;
            const bool in0 = s0 >= 0 && s0 < x_len;
            const bool in1 = two && s1 >= 0 && s1 < x_len;
            T x0[kCols], x1[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const long long col = static_cast<long long>(j) * x_len;
                x0[j] = (in0 && j < cnt) ? arn::ldg(xj + col + s0) : T(0);
                x1[j] = (in1 && j < cnt) ? arn::ldg(xj + col + s1) : T(0);
            }
            T b0 = T(0), b1 = T(0);
            if (kOne || j0 == j_begin) {
                if (in0) b0 = arn::ldcs(bands + static_cast<long long>(d) * bstride + i);
                if (in1) b1 = arn::ldcs(bands + static_cast<long long>(d + 1) * bstride + i);
                if (keep) {
                    if (in0) bs[d * kColThreads] = b0;
                    if (in1) bs[(d + 1) * kColThreads] = b1;
                }
            } else {
                if (in0) b0 = bs[d * kColThreads];
                if (in1) b1 = bs[(d + 1) * kColThreads];
            }
            if (in0) {
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                    if (j < cnt) acc[j] = arn::madd(acc[j], b0, x0[j]);
            }
            if (in1) {
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                    if (j < cnt) acc[j] = arn::madd(acc[j], b1, x1[j]);
            }
        }
        ep(y, acc, pre, cnt, j0, t, xj);
    }
}

// The Chebyshev filter's degree step, dia_cols' epilogue (square operator:
// rows = x_len = n).  With acc = (A T)[j, i] and tj = T[j, i] (the offset-0
// x value, which the product has just read):
//   first step (kFirst):  T_1 = (acc - c tj) scale;  Y = c_0 tj + c_1 T_1
//   later steps:          T_next = (acc - c tj) scale - T_prev;  Y += c_j T_next
// in the eager recurrence's order of operations, each update one fused
// multiply-add as PyTorch's add with alpha computes it.  out may be prev
// (T_next overwrites T_{j-1}): each element is read and written by one
// thread, the read first, so neither pointer is __restrict__.  prev, Y (the
// y of dia_cols) and out stream (ldcs / stcs): no later load of the step
// reads them.
template <typename T, bool kFirst>
struct ChebStep {
    const T* prev;     // T_{j-1} (unused in the first step)
    T* out;            // T_{j+1}
    long long n;
    T c, scale, c0, coef;

    // T_{j-1} and Y of the chunk, loaded before the product so that their
    // loads are in flight with its x loads.
    struct Pre { T p[kCols], y[kCols]; };
    __device__ __forceinline__ Pre load(const T* __restrict__ y, int cnt, int j0,
                                        long long t) const {
        Pre q;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            const long long ej = static_cast<long long>(j0 + j) * n + t;
            q.p[j] = (!kFirst && j < cnt) ? arn::ldcs(prev + ej) : T(0);
            q.y[j] = (!kFirst && j < cnt) ? arn::ldcs(y + ej) : T(0);
        }
        return q;
    }

    __device__ __forceinline__ void operator()(T* __restrict__ y,
                                               const T (&acc)[kCols], const Pre& q,
                                               int cnt, int j0, long long t,
                                               const T* xj) const {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            if (j >= cnt) continue;
            const long long ej = static_cast<long long>(j0 + j) * n + t;
            const T tj = arn::ldg(xj + static_cast<long long>(j) * n + t);
            T tn = arn::fma_rn(-c, tj, acc[j]) * scale;
            if (kFirst) {
                arn::stcs(out + ej, tn);
                arn::stcs(y + ej, arn::fma_rn(coef, tn, c0 * tj));
            } else {
                tn = tn - q.p[j];
                arn::stcs(out + ej, tn);
                arn::stcs(y + ej, arn::fma_rn(coef, tn, q.y[j]));
            }
        }
    }
};

template <typename T, bool kOne, bool kFirst>
__global__ void __launch_bounds__(kColThreads)
cheby_dia_cols_kernel(const T* __restrict__ bands, const T* __restrict__ x,
                      T* __restrict__ y, long long n, int nb, DiaOffsets o,
                      ChebStep<T, kFirst> ep) {
    dia_cols<T, kOne>(bands, x, n, 0, n, 0, n, nb, o, y, ep);
}

// The b-column grid: row tiles of kColThreads by groups of kGroupCols
// columns.
dim3 cols_grid(long long rows, int nb) {
    return dim3(static_cast<unsigned>((rows + kColThreads - 1) / kColThreads),
                static_cast<unsigned>((nb + kGroupCols - 1) / kGroupCols));
}

// Shared memory holds the bands where a group has more than one chunk.
template <typename T>
size_t cols_smem(int nb, int k) {
    return nb > kCols ? static_cast<size_t>(k) * kColThreads * sizeof(T) : 0;
}

// Rows [row0, row0 + rows) of a shard whose bands have row stride bstride,
// against the x window of x_len entries per column (row i reads
// x[i + x_base + off]); y holds the rows' results, rows per column.
template <typename T>
int launch_dia(const T* bands, const T* x, T* y, long long rows, int k,
               const long long* offsets, int nb, long long bstride,
               long long row0, long long x_base, long long x_len, void* stream) {
    if (k < 0 || k > kMaxOffsets || rows < 0 || nb < 1 || row0 < 0 ||
        x_len < 0 || (rows > 0 && row0 + rows > bstride))
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    DiaOffsets o{};
    o.k = k;
    for (int d = 0; d < k; ++d) o.off[d] = offsets[d];
    const auto s = static_cast<cudaStream_t>(stream);
    if (nb == 1) {
        constexpr int R = arn::kPer16<T>;
        const unsigned blocks =
            static_cast<unsigned>((rows + kThreads * R - 1) / (kThreads * R));
        const bool vec = aligned16(bands) && aligned16(y) && bstride % R == 0 &&
                         row0 % R == 0;
        spmv_dia_rows_kernel<T><<<blocks, kThreads, 0, s>>>(
            bands, x, y, rows, row0, bstride, x_base, x_len, vec, o);
    } else {
        const size_t smem = cols_smem<T>(nb, k);
        if (smem > 48 * 1024) {   // complex128 with more than 12 offsets
            static const cudaError_t attr = cudaFuncSetAttribute(
                spmv_dia_cols_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(kMaxOffsets * kColThreads * sizeof(T)));
            if (attr != cudaSuccess) return static_cast<int>(attr);
        }
        const dim3 grid = cols_grid(rows, nb);
        if (nb <= kCols)
            spmv_dia_cols_kernel<T, true><<<grid, kColThreads, 0, s>>>(
                bands, x, y, rows, row0, bstride, x_base, x_len, nb, o);
        else
            spmv_dia_cols_kernel<T, false><<<grid, kColThreads, smem, s>>>(
                bands, x, y, rows, row0, bstride, x_base, x_len, nb, o);
    }
    return static_cast<int>(cudaGetLastError());
}

// One degree step of the Chebyshev filter over the square operator's (nb,
// n) blocks: x = T_j, prev = T_{j-1}, out = T_{j+1} (may be prev), y = Y.
// first: the first step (T_1 from x = X; Y written, not read; prev unused).
template <typename T>
int launch_cheby(const T* bands, const T* x, const T* prev, T* out, T* y,
                 long long n, int k, const long long* offsets, int nb,
                 double c, double scale, double c0, double coef, int first,
                 void* stream) {
    if (k < 0 || k > kMaxOffsets || n < 0 || nb < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    DiaOffsets o{};
    o.k = k;
    for (int d = 0; d < k; ++d) o.off[d] = offsets[d];
    const auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = cols_grid(n, nb);
    const size_t smem = cols_smem<T>(nb, k);
    if (first) {
        const ChebStep<T, true> ep{prev, out, n, T(c), T(scale), T(c0), T(coef)};
        if (nb <= kCols)
            cheby_dia_cols_kernel<T, true, true><<<grid, kColThreads, 0, s>>>(
                bands, x, y, n, nb, o, ep);
        else
            cheby_dia_cols_kernel<T, false, true><<<grid, kColThreads, smem, s>>>(
                bands, x, y, n, nb, o, ep);
    } else {
        const ChebStep<T, false> ep{prev, out, n, T(c), T(scale), T(c0), T(coef)};
        if (nb <= kCols)
            cheby_dia_cols_kernel<T, true, false><<<grid, kColThreads, 0, s>>>(
                bands, x, y, n, nb, o, ep);
        else
            cheby_dia_cols_kernel<T, false, false><<<grid, kColThreads, smem, s>>>(
                bands, x, y, n, nb, o, ep);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ARN_DIA_ENTRY(SUFFIX, T)                                                \
    extern "C" int arn_spmv_dia_##SUFFIX(                                       \
        const T* bands, const T* x, T* y, long long rows, int k,                \
        const long long* offsets, int nb, long long bstride, long long row0,    \
        long long x_base, long long x_len, void* stream) {                      \
        return launch_dia<T>(bands, x, y, rows, k, offsets, nb, bstride, row0,  \
                             x_base, x_len, stream);                            \
    }

ARN_DIA_ENTRY(f32, float)
ARN_DIA_ENTRY(f64, double)
ARN_DIA_ENTRY(c64, arn::c64)
ARN_DIA_ENTRY(c128, arn::c128)

// The Chebyshev filter's degree step (real operands only: the filtered
// drivers refuse complex operators).
#define ARN_CHEBY_ENTRY(SUFFIX, T)                                              \
    extern "C" int arn_cheby_dia_##SUFFIX(                                      \
        const T* bands, const T* x, const T* prev, T* out, T* y, long long n,   \
        int k, const long long* offsets, int nb, double c, double scale,        \
        double c0, double coef, int first, void* stream) {                      \
        return launch_cheby<T>(bands, x, prev, out, y, n, k, offsets, nb, c,    \
                               scale, c0, coef, first, stream);                 \
    }

ARN_CHEBY_ENTRY(f32, float)
ARN_CHEBY_ENTRY(f64, double)
