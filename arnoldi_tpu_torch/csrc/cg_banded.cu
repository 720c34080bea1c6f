// Conjugate gradients on a shifted DIA operator, the whole solve in one
// cooperative launch:
//
//   (A - sigma I) x = b,   x0 = 0, no preconditioner, sigma real,
//
// A given by its bands and offsets as spmv_banded.cu takes them.  It stops
// once r.r <= max(tol^2 ||b||^2, atol^2) or after maxiter iterations, the
// rule of solvers/inner.py:cg, and writes x and the iterations taken.
//
// Replaces no Pallas kernel: the JAX package solves the shift-invert
// systems with jax.scipy.sparse.linalg.cg, one while_loop on the device.
// The port's eager loop (inner.cg over the DIA kernel) launches about 12
// kernels an iteration and reads r.r on the host once an iteration, so the
// host sets its pace: at laplace_2d(724), sigma = 0.01, 148 us of wall an
// iteration by events against 41 us of device time (PERF.md).  Here the
// host launches once and reads the iteration count once a solve.
//
// Bound: on-chip traffic and the grid barriers.  An iteration does 2k + 10
// flops a row against the k bands and a few vectors; at laplace_2d(724) in
// float64 the bands are 21 MB and a vector 4.19 MB, all of which fits the
// 50 MB L2, so no HBM roofline share is kept for it.  With every vector in
// L2 (the first designs) an iteration moved ~45 MB through L2 and took
// 22-28 us on an H100 80GB HBM3 at 700 W; keeping on the chip what only
// its block reads (below) took it to 11-14 us, of which the two barriers
// and their sums are 6-8 (PERF.md).
//
// Design: a persistent grid of one 512-thread block an SM (all resident:
// a cooperative launch); block b owns the rows [b rows, (b + 1) rows).  Two
// grid barriers an iteration:
//  A. p_k = r_k + beta p_{k-1} (p_0 = r_0 = b) is formed for every x entry
//     the block's row products read, so the direction update needs no
//     barrier of its own: an entry another block owns is formed from the r
//     and p_{k-1} its owner wrote, with the one fused multiply-add the owner
//     uses, so both hold the same bits.  p alternates between two buffers
//     (p_{k-1} is read while p_k is written).  Ap_k = (A - sigma I) p_k on
//     the block's rows and its partial of p_k.Ap_k.  Barrier.
//  B. Every block sums the partials in one fixed order (alpha = gamma /
//     p.Ap), updates x += alpha p and r -= alpha Ap on its rows and its
//     partial of r.r.  Barrier.
//  Every block then sums the r.r partials in the same order, so every block
//  takes the same stop decision and all leave the loop together: no masked
//  iteration runs.  ||b||^2 is one such sum before the loop.
// Two forms, by what fits (the launcher's choice):
//  * resident (a thread's rows fit kRows, the block's window and bands its
//    shared memory: laplace_2d(724) on 132 SMs, 3,972 rows a block): a
//    thread keeps x, r, p and Ap of its rows in registers, the block its
//    rows' bands (read once a solve) and p over its rows and halo (the
//    entries the offsets reach past its edges) in shared memory.  Only the
//    rows another block's window reads write r and p to device memory, and
//    x is written at the end.  The products run offset by offset, the
//    thread's rows' loads out together;
//  * direct (any other size or reach): x, r, p and Ap in device memory, p
//    formed at every entry a row product reads, kStep offsets' loads out at
//    once.
// The row product keeps the DIA kernel's order: the arn::madd chain over
// d = 0..k-1 from zero, a term skipped where its x index leaves [0, n),
// then -sigma p_i by one fused multiply-add (torch.add(y, p, alpha=-sigma)
// of the eager loop).
//
// The sums: a thread adds its rows' terms in row order, arn::block_sum
// gives the block's partial, and each warp sums the grid's partials (lane l
// the partials l, l + 32, ... in turn, then an xor butterfly, whose every
// lane ends with the same bits), so every reduction is the same from run to
// run on one launch geometry, and every block holds the same scalars.
//
// The barrier: ticket[0] counts every block's arrivals over the launch
// (a release add), and the i-th barrier waits (acquire loads) for
// i * gridDim.x of them; the block's other threads are ordered by
// __syncthreads on both sides.  Each block counts itself out in ticket[1]
// at the end; the last resets both to 0 for the next launch on the stream,
// so launches that share them must be ordered (the wrapper keeps one pair
// per device and stream).  The partials are read from L2 (ldcg).
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 16;
constexpr int kThreads = 512;                // one block an SM
constexpr int kRows = 8;                     // rows a thread keeps (resident form)
constexpr int kStep = 4;                     // offsets loaded at once (direct form)
constexpr int kMaxGrid = 256;                // blocks a launch may have
constexpr int kLanePartials = kMaxGrid / 32; // partials a lane sums

struct DiaOffsets {
    long long off[kMaxOffsets];
    int k;
};

// What a launch's blocks share: a block's rows (block b owns [b rows,
// (b + 1) rows)) and the x window's reach below and above a row.
struct Plan {
    long long rows;
    long long halo_lo;
    long long halo_hi;
};

__device__ __forceinline__ void grid_barrier(unsigned long long* ticket,
                                             unsigned long long target) {
    __syncthreads();                         // the block's writes are issued
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u64 [%0], %1;"
                     :: "l"(ticket), "l"(1ull) : "memory");
        unsigned long long seen;
        do {
            asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                         : "=l"(seen) : "l"(ticket) : "memory");
        } while (seen < target);
    }
    __syncthreads();
}

// The block's partial (thread 0's arn::block_sum) into partials[blockIdx.x].
template <typename T>
__device__ __forceinline__ void put_partial(T* partials, T v) {
    v = arn::block_sum(v);
    if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

// The sum of the grid's count partials, the same bits in every lane of
// every warp of every block.
template <typename T>
__device__ __forceinline__ T grid_total(const T* partials, int count) {
    const int lane = threadIdx.x & 31;
    T v[kLanePartials];
#pragma unroll
    for (int u = 0; u < kLanePartials; ++u) {
        const int b = lane + 32 * u;
        v[u] = b < count ? arn::ldcg(partials + b) : T(0);
    }
    T acc = T(0);
#pragma unroll
    for (int u = 0; u < kLanePartials; ++u) acc += v[u];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += arn::shfl_xor(acc, m);
    return acc;
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
cg_dia_kernel(const T* __restrict__ bands, DiaOffsets o, long long n, T shift,
              const T* __restrict__ b, T* x, T* r, T* p0, T* p1, T* Ap,
              T* partials, unsigned long long* ticket, long long* iters,
              double tol2, double atol2, long long maxiter, Plan plan) {
    extern __shared__ __align__(16) unsigned char smem[];
    // Resident: p over the block's rows and their halo, then the rows' bands.
    T* win = reinterpret_cast<T*>(smem);
    T* sbands = win + plan.rows + plan.halo_lo + plan.halo_hi;
    const long long lo = min(n, static_cast<long long>(blockIdx.x) * plan.rows);
    const long long hi = min(n, lo + plan.rows);
    T* pap_partials = partials;              // p.Ap
    T* rr_partials = partials + gridDim.x;   // r.r (b.b before the loop)
    unsigned long long arrivals = 0;
    // The resident form: row lo + t is this thread's row u for t = slot(u)
    // (int offsets: a block has at most kThreads * kRows rows), and rows
    // another block's window reads are shared.
    constexpr int R = kResident ? kRows : 1;
    T xs[R], rs[R], ps[R], aps[R];
    const int count = static_cast<int>(hi - lo);
    const int reach_lo = static_cast<int>(plan.halo_lo);
    auto slot = [](int u) { return static_cast<int>(threadIdx.x) + u * kThreads; };
    auto shared_row = [&](int t) { return t < plan.halo_hi || t >= count - reach_lo; };

    T acc = T(0);
    if constexpr (kResident) {
        for (int d = 0; d < o.k; ++d)
            for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
                sbands[d * plan.rows + (i - lo)] =
                    arn::ldg(bands + static_cast<long long>(d) * n + i);
#pragma unroll
        for (int u = 0; u < R; ++u) {
            const int t = slot(u);
            if (t < count) {
                const T bi = b[lo + t];
                xs[u] = T(0);
                rs[u] = bi;
                if (shared_row(t)) r[lo + t] = bi;
                acc = arn::madd(acc, bi, bi);
            }
        }
    } else {
        for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
            const T bi = b[i];
            x[i] = T(0);
            r[i] = bi;
            acc = arn::madd(acc, bi, bi);
        }
    }
    put_partial(rr_partials, acc);
    grid_barrier(ticket, arrivals += gridDim.x);
    T gamma = grid_total(rr_partials, gridDim.x);
    // max(tol^2 ||b||^2, atol^2) as inner.cg takes it (a NaN stops).
    double thresh = tol2 * static_cast<double>(gamma);
    if (atol2 > thresh) thresh = atol2;
    T gamma_prev = T(1);
    long long k = 0;
    while (k < maxiter && static_cast<double>(gamma) > thresh) {
        const T* p_old = (k & 1) ? p0 : p1;  // p_{k-1}
        T* p_new = (k & 1) ? p1 : p0;        // p_k
        const bool first = k == 0;
        const T beta = gamma / gamma_prev;   // unread at k = 0
        auto direction = [&](long long j) -> T {
            return first ? r[j] : arn::fma_rn(beta, p_old[j], r[j]);
        };
        acc = T(0);
        if constexpr (kResident) {
            // The halo from device memory (its entries' loads out together),
            // the block's rows from registers.
            const long long base = lo - plan.halo_lo;   // win[j - base]
            const long long below = lo - max(0ll, base);
            const long long halo = below + min(n, hi + plan.halo_hi) - hi;
#pragma unroll 4
            for (long long e = threadIdx.x; e < halo; e += kThreads) {
                const long long j = e < below ? lo - below + e : hi + (e - below);
                win[j - base] = direction(j);
            }
#pragma unroll
            for (int u = 0; u < R; ++u) {
                const int t = slot(u);
                if (t < count) {
                    ps[u] = first ? rs[u] : arn::fma_rn(beta, ps[u], rs[u]);
                    win[reach_lo + t] = ps[u];
                    if (shared_row(t)) p_new[lo + t] = ps[u];
                }
                aps[u] = T(0);
            }
            __syncthreads();
            // The products offset by offset, the R rows' loads out together;
            // each row's terms still in the order of d.
            for (int d = 0; d < o.k; ++d) {
                const long long first_j = lo + o.off[d];   // row lo's x index
                const T* bd = sbands + d * plan.rows;
                const T* wd = win + reach_lo + o.off[d];
#pragma unroll
                for (int u = 0; u < R; ++u) {
                    const int t = slot(u);
                    const long long j = first_j + t;
                    if (t < count && j >= 0 && j < n)
                        aps[u] = arn::madd(aps[u], bd[t], wd[t]);
                }
            }
#pragma unroll
            for (int u = 0; u < R; ++u) {
                if (slot(u) < count) {
                    aps[u] = arn::fma_rn(shift, ps[u], aps[u]);
                    acc = arn::madd(acc, ps[u], aps[u]);
                }
            }
        } else {
            for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
                T sum = T(0);
                for (int d0 = 0; d0 < o.k; d0 += kStep) {
                    T bv[kStep], pv[kStep];
                    bool in[kStep];
#pragma unroll
                    for (int u = 0; u < kStep; ++u) {
                        const int d = d0 + u;
                        const long long j = i + o.off[d];
                        in[u] = d < o.k && j >= 0 && j < n;
                        bv[u] = in[u] ? arn::ldg(bands + static_cast<long long>(d) * n + i)
                                      : T(0);
                        pv[u] = in[u] ? direction(j) : T(0);
                    }
#pragma unroll
                    for (int u = 0; u < kStep; ++u)
                        if (in[u]) sum = arn::madd(sum, bv[u], pv[u]);
                }
                const T pi = direction(i);
                const T api = arn::fma_rn(shift, pi, sum);
                p_new[i] = pi;
                Ap[i] = api;
                acc = arn::madd(acc, pi, api);
            }
        }
        put_partial(pap_partials, acc);
        grid_barrier(ticket, arrivals += gridDim.x);
        const T alpha = gamma / grid_total(pap_partials, gridDim.x);
        acc = T(0);
        if constexpr (kResident) {
#pragma unroll
            for (int u = 0; u < R; ++u) {
                const int t = slot(u);
                if (t < count) {
                    xs[u] = arn::fma_rn(alpha, ps[u], xs[u]);
                    rs[u] = arn::fma_rn(-alpha, aps[u], rs[u]);
                    if (shared_row(t)) r[lo + t] = rs[u];
                    acc = arn::madd(acc, rs[u], rs[u]);
                }
            }
        } else {
#pragma unroll 4
            for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
                x[i] = arn::fma_rn(alpha, p_new[i], x[i]);
                const T ri = arn::fma_rn(-alpha, Ap[i], r[i]);
                r[i] = ri;
                acc = arn::madd(acc, ri, ri);
            }
        }
        put_partial(rr_partials, acc);
        grid_barrier(ticket, arrivals += gridDim.x);
        gamma_prev = gamma;
        gamma = grid_total(rr_partials, gridDim.x);
        ++k;
    }
    if constexpr (kResident) {
#pragma unroll
        for (int u = 0; u < R; ++u)
            if (slot(u) < count) x[lo + slot(u)] = xs[u];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *iters = k;
    if (threadIdx.x == 0 && atomicAdd(ticket + 1, 1ull) == gridDim.x - 1) {
        ticket[0] = 0ull;                    // every block has left every barrier
        ticket[1] = 0ull;
    }
}

// The dynamic shared memory a block may take (the opt-in limit less a
// margin for the static arrays), read once.
inline long long smem_budget() {
    static long long bytes = -1;
    if (bytes < 0) {
        int dev = 0, optin = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev) != cudaSuccess)
            return 0;
        bytes = std::max(0, optin - 1024);
    }
    return bytes;
}

// Blocks an SM holds of the form at the whole budget (its opt-in set
// once): 0 when that cannot be read.
template <typename T, bool kResident>
int blocks_per_sm(long long budget, cudaError_t* err) {
    static int per_sm = -1;
    if (per_sm < 0) {
        int blocks = 0;
        cudaError_t e = cudaFuncSetAttribute(
            cg_dia_kernel<T, kResident>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(budget));
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, cg_dia_kernel<T, kResident>, kThreads,
                static_cast<size_t>(budget));
        if (e != cudaSuccess) {
            *err = e;
            return 0;
        }
        per_sm = blocks;
    }
    return per_sm;
}

template <typename T>
int launch_cg_dia(const T* bands, int k, const long long* offsets, long long n,
                  double sigma, const T* b, T* x, T* r, T* p0, T* p1, T* Ap,
                  T* partials, int capacity, unsigned long long* ticket,
                  long long* iters, double tol2, double atol2, long long maxiter,
                  void* stream) {
    if (n < 1 || k < 1 || k > kMaxOffsets || capacity < 2 * kMaxGrid)
        return static_cast<int>(cudaErrorInvalidValue);
    DiaOffsets o{};
    o.k = k;
    long long lowest = 0, highest = 0;
    for (int d = 0; d < k; ++d) {
        o.off[d] = offsets[d];
        lowest = std::min(lowest, offsets[d]);
        highest = std::max(highest, offsets[d]);
    }
    const long long budget = smem_budget();
    cudaError_t err = cudaSuccess;
    const int per_sm = std::min(blocks_per_sm<T, true>(budget, &err),
                                blocks_per_sm<T, false>(budget, &err));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_sm = arn::sm_count();
    if (n_sm < 1 || per_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
    const int grid = static_cast<int>(std::min<long long>(
        std::min(n_sm * per_sm, kMaxGrid), (n + kThreads - 1) / kThreads));
    Plan plan{(n + grid - 1) / grid, -lowest, highest};
    // Resident where a thread's rows fit its registers and the block's
    // window and bands its shared memory.
    const size_t smem = static_cast<size_t>(
        plan.rows * (k + 1) + plan.halo_lo + plan.halo_hi) * sizeof(T);
    const bool resident = plan.rows <= static_cast<long long>(kThreads) * kRows &&
                          smem <= static_cast<size_t>(budget);
    T shift = static_cast<T>(-sigma);
    void* args[] = {&bands, &o, &n, &shift, &b, &x, &r, &p0, &p1, &Ap, &partials,
                    &ticket, &iters, &tol2, &atol2, &maxiter, &plan};
    const void* kernel = resident
        ? reinterpret_cast<const void*>(cg_dia_kernel<T, true>)
        : reinterpret_cast<const void*>(cg_dia_kernel<T, false>);
    return static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, grid, kThreads, args, resident ? smem : 0,
        static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int arn_cg_dia_partials() { return 2 * kMaxGrid; }

#define ARN_CG_ENTRY(SUFFIX, T)                                                   \
    extern "C" int arn_cg_dia_##SUFFIX(                                           \
        const T* bands, int k, const long long* offsets, long long n,             \
        double sigma, const T* b, T* x, T* r, T* p0, T* p1, T* Ap, T* partials,   \
        int capacity, unsigned long long* ticket, long long* iters, double tol2,  \
        double atol2, long long maxiter, void* stream) {                          \
        return launch_cg_dia<T>(bands, k, offsets, n, sigma, b, x, r, p0, p1, Ap, \
                                partials, capacity, ticket, iters, tol2, atol2,   \
                                maxiter, stream);                                 \
    }

ARN_CG_ENTRY(f32, float)
ARN_CG_ENTRY(f64, double)
