// Shared device helpers for the port's kernels.
//
// Every reduction here runs in a fixed order (shuffle tree inside a warp,
// then warp 0 over the per-warp sums), so a kernel built from them gives
// bit-identical results from run to run on the same launch geometry.
//
// The scalar helpers (loads, shuffles, multiply-adds) take float, double
// and arn::complex<float/double>.  The real overloads are the intrinsics or
// the expressions the kernels wrote before they had complex forms, so a
// real instantiation compiles to the code it had.  A complex multiply-add
// is four fused multiply-adds in a fixed order.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace arn {

// A complex scalar in torch's layout (real part, then imaginary part),
// aligned as torch.complex64 / complex128 elements are (8 / 16 bytes), so
// a load is one 8- or 16-byte access.
template <typename R>
struct alignas(2 * sizeof(R)) complex {
    R re, im;
    complex() = default;
    __host__ __device__ constexpr complex(R r, R i = R(0)) : re(r), im(i) {}
};

using c64 = complex<float>;
using c128 = complex<double>;

// The real type of a scalar type: float for float and c64, double for
// double and c128.
template <typename T> struct real_of { using type = T; };
template <typename R> struct real_of<complex<R>> { using type = R; };
template <typename T> using real_t = typename real_of<T>::type;

template <typename R> struct vec2_of;
template <> struct vec2_of<float> { using type = float2; };
template <> struct vec2_of<double> { using type = double2; };

template <typename R>
__device__ __forceinline__ complex<R> operator+(complex<R> a, complex<R> b) {
    return {a.re + b.re, a.im + b.im};
}

template <typename R>
__device__ __forceinline__ complex<R>& operator+=(complex<R>& a, complex<R> b) {
    a = a + b;
    return a;
}

__device__ __forceinline__ float conj(float v) { return v; }
__device__ __forceinline__ double conj(double v) { return v; }
template <typename R>
__device__ __forceinline__ complex<R> conj(complex<R> v) { return {v.re, -v.im}; }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// c + a b, real part first: re = a.re b.re + (c.re - a.im b.im),
// im = a.re b.im + (c.im + a.im b.re).
template <typename R>
__device__ __forceinline__ complex<R> fma_rn(complex<R> a, complex<R> b, complex<R> c) {
    return {fma_rn(a.re, b.re, fma_rn(-a.im, b.im, c.re)),
            fma_rn(a.re, b.im, fma_rn(a.im, b.re, c.im))};
}

// acc + a b.  Real: the expression the kernels used (nvcc contracts it).
__device__ __forceinline__ float madd(float acc, float a, float b) { return acc + a * b; }
__device__ __forceinline__ double madd(double acc, double a, double b) { return acc + a * b; }
template <typename R>
__device__ __forceinline__ complex<R> madd(complex<R> acc, complex<R> a, complex<R> b) {
    return fma_rn(a, b, acc);
}

// acc - a b.
__device__ __forceinline__ float msub(float acc, float a, float b) { return acc - a * b; }
__device__ __forceinline__ double msub(double acc, double a, double b) { return acc - a * b; }
template <typename R>
__device__ __forceinline__ complex<R> msub(complex<R> acc, complex<R> a, complex<R> b) {
    return {fma_rn(-a.re, b.re, fma_rn(a.im, b.im, acc.re)),
            fma_rn(-a.re, b.im, fma_rn(-a.im, b.re, acc.im))};
}

// acc + |v|^2, in the real type.
__device__ __forceinline__ float add_abs2(float acc, float v) { return acc + v * v; }
__device__ __forceinline__ double add_abs2(double acc, double v) { return acc + v * v; }
template <typename R>
__device__ __forceinline__ R add_abs2(R acc, complex<R> v) {
    return fma_rn(v.re, v.re, fma_rn(v.im, v.im, acc));
}

// Loads through the read-only path (ldg), streaming (ldcs) and L2 only
// (ldcg): a complex value is one float2 / double2 access.
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }
template <typename R>
__device__ __forceinline__ complex<R> ldg(const complex<R>* p) {
    const auto v = __ldg(reinterpret_cast<const typename vec2_of<R>::type*>(p));
    return {v.x, v.y};
}

__device__ __forceinline__ float ldcs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ldcs(const double* p) { return __ldcs(p); }
template <typename R>
__device__ __forceinline__ complex<R> ldcs(const complex<R>* p) {
    const auto v = __ldcs(reinterpret_cast<const typename vec2_of<R>::type*>(p));
    return {v.x, v.y};
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
template <typename R>
__device__ __forceinline__ complex<R> ldcg(const complex<R>* p) {
    const auto v = __ldcg(reinterpret_cast<const typename vec2_of<R>::type*>(p));
    return {v.x, v.y};
}

// Streaming store (stcs: evict-first), for outputs no later load of the
// kernel reads.
__device__ __forceinline__ void stcs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(double* p, double v) { __stcs(p, v); }
template <typename R>
__device__ __forceinline__ void stcs(complex<R>* p, complex<R> v) {
    typename vec2_of<R>::type q;
    q.x = v.re;
    q.y = v.im;
    __stcs(reinterpret_cast<typename vec2_of<R>::type*>(p), q);
}

// 16 bytes of T as one access: 4 float, 2 double or c64, 1 c128.  The
// address must be 16-byte aligned.
template <typename T> constexpr int kPer16 = 16 / sizeof(T);
template <typename T> struct vec16_of { using type = float4; };
template <> struct vec16_of<double> { using type = double2; };
template <> struct vec16_of<c128> { using type = double2; };

template <typename T>
__device__ __forceinline__ void ldcs16(T (&v)[kPer16<T>], const T* p) {
    using V = typename vec16_of<T>::type;
    const V q = __ldcs(reinterpret_cast<const V*>(p));
    static_assert(sizeof(q) == sizeof(v), "16 bytes");
    memcpy(v, &q, sizeof(v));
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const T (&v)[kPer16<T>]) {
    using V = typename vec16_of<T>::type;
    V q;
    memcpy(&q, v, sizeof(q));
    *reinterpret_cast<V*>(p) = q;
}

// Warp shuffles over all 32 lanes (shfl_down: within aligned groups of
// `width` lanes); a complex value moves as its two halves, which take the
// same lanes, so a tree sums both in the same order.
__device__ __forceinline__ float shfl_down(float v, int off, int width = 32) {
    return __shfl_down_sync(0xffffffffu, v, off, width);
}
__device__ __forceinline__ double shfl_down(double v, int off, int width = 32) {
    return __shfl_down_sync(0xffffffffu, v, off, width);
}
template <typename R>
__device__ __forceinline__ complex<R> shfl_down(complex<R> v, int off, int width = 32) {
    return {shfl_down(v.re, off, width), shfl_down(v.im, off, width)};
}

__device__ __forceinline__ float shfl_xor(float v, int mask) {
    return __shfl_xor_sync(0xffffffffu, v, mask);
}
__device__ __forceinline__ double shfl_xor(double v, int mask) {
    return __shfl_xor_sync(0xffffffffu, v, mask);
}
template <typename R>
__device__ __forceinline__ complex<R> shfl_xor(complex<R> v, int mask) {
    return {shfl_xor(v.re, mask), shfl_xor(v.im, mask)};
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += shfl_down(v, off);
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
