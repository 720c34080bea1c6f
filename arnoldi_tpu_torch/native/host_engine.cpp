// The port's copy of arnoldi_tpu/native/host_engine.cpp, unchanged but for
// this line; built by native/host_engine.py.
//
// Host-tier Krylov restart engine (real float64).
//
// The host tier (solvers/decomposition.py::host_arnoldi_expand) runs the
// reference's regime — small-n solves where ARPACK lives — as a NumPy/BLAS
// loop.  Measured on the mark(100) stress grid, ~25% of each expansion
// iteration was Python dispatch (4 numpy calls + norm + slicing per
// iteration, ~35 us at n=5050), and each restart paid another ~0.5 ms of
// marshalling.  This engine runs ONE C call per restart cycle:
//
//     truncate (dgemm into the spare buffer)  +  Arnoldi expansion
//     (CSR SpMV + CGS/DGKS projections as dgemv pairs)
//
// with BLAS reached through function pointers handed over at init from
// scipy's cython_blas capsules (same BLAS the NumPy path uses — no extra
// link-time dependency; parity with the reference's "BLAS via scipy"
// layering, reference ortho.py:4).
//
// Semantics mirror host_arnoldi_expand exactly (CGS with the DGKS
// eta=sqrt(1/2) criterion and at most one re-orthogonalization pass, or an
// unconditional second pass for cgs2, or MGS+DGKS; breakdown when the
// post-orthogonalization norm < tol stores the raw vector with a zero
// coupling coefficient and returns early).  Reference contract:
// decomposition.py:13-68 and ortho.py:56-107.

#include <cmath>
#include <cstdint>

namespace {

// Fortran BLAS signatures (32-bit ints, everything by pointer).
typedef void (*dgemv_t)(const char *trans, const int *m, const int *n,
                        const double *alpha, const double *a, const int *lda,
                        const double *x, const int *incx, const double *beta,
                        double *y, const int *incy);
typedef void (*dgemm_t)(const char *transa, const char *transb, const int *m,
                        const int *n, const int *k, const double *alpha,
                        const double *a, const int *lda, const double *b,
                        const int *ldb, const double *beta, double *c,
                        const int *ldc);
typedef double (*dnrm2_t)(const int *n, const double *x, const int *incx);
typedef double (*ddot_t)(const int *n, const double *x, const int *incx,
                         const double *y, const int *incy);

dgemv_t g_dgemv = nullptr;
dgemm_t g_dgemm = nullptr;
dnrm2_t g_dnrm2 = nullptr;
ddot_t g_ddot = nullptr;

const double kEta = 0.7071067811865476;  // sqrt(1/2), DGKS criterion

inline void csr_matvec(int n, const int *indptr, const int *indices,
                       const double *data, const double *x, double *y) {
  for (int i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int k = indptr[i]; k < indptr[i + 1]; ++k)
      acc += data[k] * x[indices[k]];
    y[i] = acc;
  }
}

// One CGS(+DGKS) orthogonalization of w (length n) against the j+1 rows of
// Vt (row-major, row stride ldv), coefficients accumulated into h (strided
// into H by the caller).  Returns the post-orthogonalization norm.
double cgs_pass(int n, int rows, const double *Vt, int ldv, double *w,
                double *c, double *scratch) {
  // Row-major Vt (rows, n) is a Fortran (n, rows) matrix F with lda=ldv:
  // c = F^T w ; w -= F c.
  const int ione = 1;
  const double one = 1.0, zero = 0.0, neg = -1.0;
  g_dgemv("T", &n, &rows, &one, Vt, &ldv, w, &ione, &zero, scratch, &ione);
  g_dgemv("N", &n, &rows, &neg, Vt, &ldv, scratch, &ione, &one, w, &ione);
  for (int i = 0; i < rows; ++i) c[i] += scratch[i];
  return g_dnrm2(&n, w, &ione);
}

double mgs_pass(int n, int rows, const double *Vt, int ldv, double *w,
                double *c) {
  const int ione = 1;
  for (int i = 0; i < rows; ++i) {
    const double *vi = Vt + (size_t)i * ldv;
    double ci = g_ddot(&n, vi, &ione, w, &ione);
    for (int k = 0; k < n; ++k) w[k] -= ci * vi[k];
    c[i] += ci;
  }
  return g_dnrm2(&n, w, &ione);
}

}  // namespace

extern "C" {

// Install the BLAS entry points (raw pointers from scipy.linalg.cython_blas
// capsules).  Must be called once before any other entry.
void ks_init_blas(void *dgemv, void *dgemm, void *dnrm2, void *ddot) {
  g_dgemv = reinterpret_cast<dgemv_t>(dgemv);
  g_dgemm = reinterpret_cast<dgemm_t>(dgemm);
  g_dnrm2 = reinterpret_cast<dnrm2_t>(dnrm2);
  g_ddot = reinterpret_cast<ddot_t>(ddot);
}

int ks_blas_ready() {
  return g_dgemv && g_dgemm && g_dnrm2 && g_ddot ? 1 : 0;
}

// Arnoldi expansion over rows [start_dim, max_dim) of the transposed basis
// Vt ((max_dim+1, ldv) row-major, only the first n columns used), H
// ((max_dim+1, ldh) row-major).  scratch: caller-provided (2*max_dim+2)
// doubles.  ortho: 0 = cgs_dgks, 1 = cgs2, 2 = mgs_dgks.
// Returns the reached dimension (j+1 on breakdown, else max_dim).
int ks_expand_d(int n, const int *indptr, const int *indices,
                const double *data, double *Vt, int ldv, double *H, int ldh,
                int start_dim, int max_dim, double tol, int ortho,
                double *scratch) {
  double *c = scratch;                    // (max_dim+1) coefficients
  double *tmp = scratch + max_dim + 1;    // dgemv workspace
  const int ione = 1;
  for (int j = start_dim; j < max_dim; ++j) {
    const double *vj = Vt + (size_t)j * ldv;
    double *w = Vt + (size_t)(j + 1) * ldv;
    csr_matvec(n, indptr, indices, data, vj, w);
    int rows = j + 1;
    for (int i = 0; i < rows; ++i) c[i] = 0.0;
    double beta_before = g_dnrm2(&n, w, &ione);
    double beta;
    if (ortho == 2) {
      beta = mgs_pass(n, rows, Vt, ldv, w, c);
      if (beta < kEta * beta_before) beta = mgs_pass(n, rows, Vt, ldv, w, c);
    } else {
      beta = cgs_pass(n, rows, Vt, ldv, w, c, tmp);
      if (ortho == 1 || beta < kEta * beta_before)
        beta = cgs_pass(n, rows, Vt, ldv, w, c, tmp);
    }
    for (int i = 0; i < rows; ++i) H[(size_t)i * ldh + j] = c[i];
    if (beta < tol) {
      H[(size_t)(j + 1) * ldh + j] = 0.0;
      return j + 1;  // happy breakdown: raw vector stays, zero coupling
    }
    H[(size_t)(j + 1) * ldh + j] = beta;
    double inv = 1.0 / beta;
    for (int k = 0; k < n; ++k) w[k] *= inv;
  }
  return max_dim;
}

// Fused restart cycle: truncate Vt into `out` (out[:pa] = Qp^T Vt[:m],
// out[pa:pa+carry] = Vt[m:m+carry]; rows beyond stay stale) and expand
// `out` from pa to max_dim.  Qp is (m, pa) row-major.  H must already hold
// the truncated projected matrix (the driver assembles it on the host).
// Returns the reached dimension.
int ks_cycle_d(int n, const int *indptr, const int *indices,
               const double *data, const double *Vt, double *out, int ldv,
               double *H, int ldh, const double *Qp, int m, int pa, int carry,
               int max_dim, double tol, int ortho, double *scratch) {
  // out[:pa] = Qp^T Vt[:m].  Row-major out (pa, n) == Fortran (n, pa)
  // O_F = Vt[:m]^T Qp = V_F (n x m) * Qp_F^T with Qp_F = Qp^T (pa x m).
  const double one = 1.0, zero = 0.0;
  g_dgemm("N", "T", &n, &pa, &m, &one, Vt, &ldv, Qp, &pa, &zero, out, &ldv);
  for (int r = 0; r < carry; ++r) {
    const double *src = Vt + (size_t)(m + r) * ldv;
    double *dst = out + (size_t)(pa + r) * ldv;
    for (int k = 0; k < n; ++k) dst[k] = src[k];
  }
  return ks_expand_d(n, indptr, indices, data, out, ldv, H, ldh, pa, max_dim,
                     tol, ortho, scratch);
}

}  // extern "C"
