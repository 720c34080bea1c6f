// The port's copy of arnoldi_tpu/native/dense_tier.cpp, unchanged but for
// this line and two comment paths; built by native/dense_tier.py.
//
// Native dense tier: small dense complex eigen-machinery for the host side
// of the Krylov-Schur solver.
//
// The reference reaches this functionality through LAPACK (zgees at
// krylov_schur.py:69, ztrexc at utils.py:24-29, zgeev at decomposition.py:120
// of the reference Python package) one Python->Fortran call at a time; the greedy Schur
// reordering there is O(m^2) separate ztrexc round-trips (utils.py:45-63).
// Here the whole tier is self-contained C++ (no LAPACK dependency):
//
//   * schur_z        — complex Schur via Householder Hessenberg reduction +
//                      Wilkinson-shifted QR iteration with deflation
//   * trexc_z        — move a diagonal entry by adjacent unitary swaps
//   * ordered_schur_z— the full greedy reorder loop in ONE native call
//   * trevc_z        — eigenvectors of triangular T by back-substitution
//   * eig_z          — full eigendecomposition (schur + trevc + rotate)
//
// Matrices are row-major (C/NumPy default), complex128 as double pairs.
// Everything is O(m^3) with m <= a few hundred: host-tier sizes.

#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

using cd = std::complex<double>;

namespace {

inline cd &at(cd *A, int n, int i, int j) { return A[(size_t)i * n + j]; }

// Apply a 2x2 unitary U = [[u00,u01],[u10,u11]] on the LEFT to rows (r, r+1)
// of A restricted to columns [c0, c1):  rows <- U * rows.
void rot_rows(cd *A, int n, int r, int c0, int c1, cd u00, cd u01, cd u10,
              cd u11) {
  for (int j = c0; j < c1; ++j) {
    cd x = at(A, n, r, j), y = at(A, n, r + 1, j);
    at(A, n, r, j) = u00 * x + u01 * y;
    at(A, n, r + 1, j) = u10 * x + u11 * y;
  }
}

// Apply U on the RIGHT to columns (c, c+1) of A restricted to rows [r0, r1):
// cols <- cols * U.
void rot_cols(cd *A, int n, int c, int r0, int r1, cd u00, cd u01, cd u10,
              cd u11) {
  for (int i = r0; i < r1; ++i) {
    cd x = at(A, n, i, c), y = at(A, n, i, c + 1);
    at(A, n, i, c) = x * u00 + y * u10;
    at(A, n, i, c + 1) = x * u01 + y * u11;
  }
}

// Givens rotation zeroing g: G * [f; g] = [r; 0] with
// G = [[conj(c_)/|.|... ]] — returns c (real>=0 convention relaxed) and s
// such that [[c, s], [-conj(s), conj(c)]] * [f; g] = [r; 0].
// x / |x| computed safely: denormal x is upscaled by an exact power of two
// first (denormal/denormal division loses mantissa bits and can destroy the
// unit-modulus property, which would make the Givens rotation non-unitary).
inline cd safe_phase(cd x, double ax) {
  if (ax < 1e-290) {
    x *= 0x1p600;
    ax = std::abs(x);
  }
  return x / ax;
}

void zlartg(cd f, cd g, cd &c, cd &s) {
  double af = std::abs(f), ag = std::abs(g);
  if (ag == 0.0) {
    c = 1.0;
    s = 0.0;
    return;
  }
  if (af == 0.0) {
    c = 0.0;
    s = std::conj(safe_phase(g, ag));
    return;
  }
  double d = std::hypot(af, ag);  // overflow/underflow-safe modulus
  c = af / d;
  s = safe_phase(f, af) * std::conj(safe_phase(g, ag)) * (ag / d);
}

}  // namespace

// Debug/diagnostic counters (read via dense_tier_stats).  Atomics: the
// host tier carries no single-thread restriction, and unsynchronized
// read-modify-write on statics is UB under concurrent schur calls.
#include <atomic>
static std::atomic<long> g_rotations{0};
static std::atomic<double> g_worst_g{0.0};
static std::atomic<long> g_outer_iters{0};

extern "C" {

void dense_tier_stats(long *rotations, double *worst_g, long *outer_iters) {
  *rotations = g_rotations;
  *worst_g = g_worst_g;
  *outer_iters = g_outer_iters;
}

void dense_tier_stats_reset() {
  g_rotations = 0;
  g_worst_g = 0.0;
  g_outer_iters = 0;
}

// Reduce A (n x n, row-major) to upper Hessenberg form in place, accumulating
// the orthogonal similarity into Q (Q must hold identity or any unitary to
// compose with on entry? -- contract: Q_out is OVERWRITTEN with the
// accumulated transform, callers pass an uninitialized buffer).
// A_out = Q^H A_in Q with A_out Hessenberg.
void hessenberg_z(int n, cd *A, cd *Q) {
  // Q <- I
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) at(Q, n, i, j) = (i == j) ? 1.0 : 0.0;

  std::vector<cd> v((size_t)n);
  for (int k = 0; k < n - 2; ++k) {
    // Householder vector for column k, rows k+1..n-1
    double xnorm = 0.0;
    for (int i = k + 1; i < n; ++i) xnorm += std::norm(at(A, n, i, k));
    xnorm = std::sqrt(xnorm);
    if (xnorm == 0.0) continue;
    cd x0 = at(A, n, k + 1, k);
    double ax0 = std::abs(x0);
    cd phase = (ax0 == 0.0) ? cd(1.0) : x0 / ax0;
    cd alpha = -phase * xnorm;  // target value of A[k+1,k]
    // v = x - alpha*e1 ; normalize
    double vnorm2 = 0.0;
    for (int i = k + 1; i < n; ++i) {
      v[i] = at(A, n, i, k);
      if (i == k + 1) v[i] -= alpha;
      vnorm2 += std::norm(v[i]);
    }
    if (vnorm2 == 0.0) continue;
    // P = I - 2 v v^H / |v|^2 ; apply: A <- P A P, Q <- Q P
    double inv = 2.0 / vnorm2;
    // A <- P A  (rows k+1..n-1, all cols)
    for (int j = 0; j < n; ++j) {
      cd dot = 0.0;
      for (int i = k + 1; i < n; ++i) dot += std::conj(v[i]) * at(A, n, i, j);
      dot *= inv;
      for (int i = k + 1; i < n; ++i) at(A, n, i, j) -= v[i] * dot;
    }
    // A <- A P  (all rows, cols k+1..n-1)
    for (int i = 0; i < n; ++i) {
      cd dot = 0.0;
      for (int j = k + 1; j < n; ++j) dot += at(A, n, i, j) * v[j];
      dot *= inv;
      for (int j = k + 1; j < n; ++j) at(A, n, i, j) -= dot * std::conj(v[j]);
    }
    // Q <- Q P
    for (int i = 0; i < n; ++i) {
      cd dot = 0.0;
      for (int j = k + 1; j < n; ++j) dot += at(Q, n, i, j) * v[j];
      dot *= inv;
      for (int j = k + 1; j < n; ++j) at(Q, n, i, j) -= dot * std::conj(v[j]);
    }
    // clean the annihilated entries
    at(A, n, k + 1, k) = alpha;
    for (int i = k + 2; i < n; ++i) at(A, n, i, k) = 0.0;
  }
}

// Complex Schur of an upper-Hessenberg H (in place -> T), accumulating the
// rotations into Q (Q is pre-filled by the caller; pass identity for a fresh
// factorization or the Hessenberg transform to compose).
// Returns 0 on success, >0 if the QR iteration failed to converge.
int hess_schur_z(int n, cd *T, cd *Q, int max_sweeps) {
  if (max_sweeps <= 0) max_sweeps = 40 * n + 100;
  const double eps = 2.220446049250313e-16;
  // Absolute deflation floor: discarding subdiagonals below eps*||T|| is
  // backward-stable and prevents the iteration from chasing (de)normal dust
  // in graded/nilpotent matrices whose neighbouring diagonal entries vanish.
  double anorm = 0.0;
  for (int i = 0; i < n; ++i)
    for (int j = (i > 0 ? i - 1 : 0); j < n; ++j)
      anorm = std::max(anorm, std::abs(at(T, n, i, j)));
  const double floor_tol = eps * anorm;
  int hi = n - 1;
  int sweeps_at_hi = 0;
  int total = 0;
  while (hi > 0) {
    ++g_outer_iters;
    if (++total > max_sweeps * 4 + 1000) return 1;
    // deflate negligible subdiagonals in the active window
    int lo = hi;
    while (lo > 0) {
      double s = std::abs(at(T, n, lo - 1, lo - 1)) + std::abs(at(T, n, lo, lo));
      double thresh = std::max(eps * s, floor_tol);
      if (std::abs(at(T, n, lo, lo - 1)) <= thresh) {
        at(T, n, lo, lo - 1) = 0.0;
        break;
      }
      --lo;
    }
    if (lo == hi) {  // 1x1 deflated
      --hi;
      sweeps_at_hi = 0;
      continue;
    }
    // Wilkinson shift from trailing 2x2 of the window
    cd a = at(T, n, hi - 1, hi - 1), b = at(T, n, hi - 1, hi);
    cd c = at(T, n, hi, hi - 1), d = at(T, n, hi, hi);
    cd tr2 = (a + d) * 0.5;
    cd disc = std::sqrt(tr2 * tr2 - (a * d - b * c));
    cd mu1 = tr2 + disc, mu2 = tr2 - disc;
    cd mu = (std::abs(mu1 - d) < std::abs(mu2 - d)) ? mu1 : mu2;
    if (++sweeps_at_hi % 12 == 0) {
      // exceptional shift to break cycles
      mu = d + cd(1.5 * std::abs(at(T, n, hi, hi - 1)), 0.0);
    }
    if (sweeps_at_hi > max_sweeps) return 2;
    // Implicit single-shift QR sweep on window [lo, hi] via bulge chasing.
    for (int k = lo; k < hi; ++k) {
      cd f, g;
      if (k == lo) {
        f = at(T, n, lo, lo) - mu;
        g = at(T, n, lo + 1, lo);
      } else {
        f = at(T, n, k, k - 1);      // Hessenberg entry
        g = at(T, n, k + 1, k - 1);  // the bulge to annihilate
      }
      cd cs, sn;
      zlartg(f, g, cs, sn);
      // G = [[c, s], [-conj(s), c]] with c real: G [f; g] = [r; 0]
      cd g00 = cs, g01 = sn, g10 = -std::conj(sn), g11 = cs;
      ++g_rotations;
      {
        double w = std::abs(std::norm(cs) + std::norm(sn) - 1.0);
        double cur = g_worst_g.load(std::memory_order_relaxed);
        while (w > cur &&
               !g_worst_g.compare_exchange_weak(cur, w)) {
        }
      }
      int c0 = (k > lo) ? k - 1 : lo;
      rot_rows(T, n, k, c0, n, g00, g01, g10, g11);
      if (k > lo) at(T, n, k + 1, k - 1) = 0.0;  // rotated to zero exactly
      // right-multiply T and Q by G^H on columns k, k+1
      cd h00 = std::conj(g00), h01 = std::conj(g10);
      cd h10 = std::conj(g01), h11 = std::conj(g11);
      int rend = std::min(k + 3, hi + 1);  // row k+2 acquires the new bulge
      rot_cols(T, n, k, 0, rend, h00, h01, h10, h11);
      rot_cols(Q, n, k, 0, n, h00, h01, h10, h11);
    }
  }
  // zero the strictly-lower triangle (numerical dust)
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < i; ++j) at(T, n, i, j) = 0.0;
  return 0;
}

// Full complex Schur A = Q T Q^H. A is overwritten with T.
int schur_z(int n, cd *A, cd *Q) {
  hessenberg_z(n, A, Q);
  return hess_schur_z(n, A, Q, 0);
}

// Swap adjacent diagonal entries k and k+1 of triangular T by a unitary
// similarity; update Q (right-multiply). Exact analogue of one ztrexc step.
static void swap_adjacent(int n, cd *T, cd *Q, int k) {
  cd t11 = at(T, n, k, k), t12 = at(T, n, k, k + 1);
  cd t22 = at(T, n, k + 1, k + 1);
  // Rotation from the eigenvector [t12; t22-t11] of the 2x2 block for t22.
  cd f = t12, g = t22 - t11;
  if (std::abs(g) == 0.0) return;  // equal eigenvalues: nothing to move
  // U with first column proportional to [f; g]:
  double nrm = std::sqrt(std::norm(f) + std::norm(g));
  cd u00 = f / nrm, u10 = g / nrm;           // first column = normalized [f;g]
  cd u01 = -std::conj(u10), u11 = std::conj(u00);  // orthonormal complement
  // T <- U^H T U on rows/cols k, k+1 ; Q <- Q U
  cd h00 = std::conj(u00), h01 = std::conj(u10);
  cd h10 = std::conj(u01), h11 = std::conj(u11);
  rot_rows(T, n, k, 0, n, h00, h01, h10, h11);
  rot_cols(T, n, k, 0, n, u00, u01, u10, u11);
  rot_cols(Q, n, k, 0, n, u00, u01, u10, u11);
  // enforce exact triangularity of the swapped block
  at(T, n, k + 1, k) = 0.0;
}

// Move diagonal entry ifst to position ilst (0-based) via adjacent swaps.
int trexc_z(int n, cd *T, cd *Q, int ifst, int ilst) {
  if (ifst < 0 || ilst < 0 || ifst >= n || ilst >= n) return -1;
  if (ifst < ilst)
    for (int k = ifst; k < ilst; ++k) swap_adjacent(n, T, Q, k);
  else
    for (int k = ifst - 1; k >= ilst; --k) swap_adjacent(n, T, Q, k);
  return 0;
}

// Greedy reorder: order[t] gives, for each target position t, the index (in
// the ORIGINAL diagonal) of the eigenvalue that should end up at t.  This is
// the entire loop of the reference's ordered_schur (utils.py:45-63) in one
// native call with position tracking.
int ordered_schur_z(int n, cd *T, cd *Q, const int *order) {
  std::vector<int> pos((size_t)n);  // current position of original index i
  for (int i = 0; i < n; ++i) pos[i] = i;
  std::vector<int> at_pos((size_t)n);  // original index currently at position
  for (int i = 0; i < n; ++i) at_pos[i] = i;
  for (int target = 0; target < n; ++target) {
    int orig = order[target];
    int source = pos[orig];
    if (source == target) continue;
    int rc = trexc_z(n, T, Q, source, target);
    if (rc != 0) return rc;
    // entry moved from 'source' to 'target'; everything in [target, source)
    // shifted one to the right
    for (int p = source; p > target; --p) {
      at_pos[p] = at_pos[p - 1];
      pos[at_pos[p]] = p;
    }
    at_pos[target] = orig;
    pos[orig] = target;
  }
  return 0;
}

// Right eigenvectors of upper-triangular T by back-substitution; S is n x n
// output (unit-norm columns). Mirrors LAPACK ztrevc's safeguarded solve.
int trevc_z(int n, const cd *T, cd *S) {
  const double eps = 2.220446049250313e-16;
  double scale = 1.0;
  for (int i = 0; i < n; ++i)
    scale = std::max(scale, std::abs(T[(size_t)i * n + i]));
  for (int k = 0; k < n; ++k) {
    std::vector<cd> y((size_t)k + 1);
    y[k] = 1.0;
    cd lam = T[(size_t)k * n + k];
    for (int i = k - 1; i >= 0; --i) {
      cd rhs = 0.0;
      for (int j = i + 1; j <= k; ++j) rhs -= T[(size_t)i * n + j] * y[j];
      cd d = T[(size_t)i * n + i] - lam;
      if (std::abs(d) < eps * scale)
        d = cd((d.real() < 0 ? -1.0 : 1.0) * eps * scale, 0.0);
      y[i] = rhs / d;
      // LAPACK-style overflow guard: each near-defective level multiplies
      // the column by ~1/(eps*scale); a chain of clustered eigenvalues
      // otherwise overflows to inf and the normalization returns NaN.
      // The recurrence is linear, so rescaling the computed suffix keeps
      // the direction exactly.
      double ay = std::abs(y[i]);
      if (ay > 1e150) {
        double s = 1.0 / ay;
        for (int j = i; j <= k; ++j) y[j] *= s;
      }
    }
    double nrm = 0.0;
    for (int i = 0; i <= k; ++i) nrm += std::norm(y[i]);
    nrm = std::sqrt(nrm);
    for (int i = 0; i < n; ++i)
      S[(size_t)i * n + k] = (i <= k) ? y[i] / nrm : cd(0.0);
  }
  return 0;
}

// Full eigendecomposition of a small complex matrix: values + unit-norm
// right eigenvectors (vecs = Q @ trevc(T)).
int eig_z(int n, cd *A, cd *vals, cd *vecs) {
  std::vector<cd> Q((size_t)n * n);
  int rc = schur_z(n, A, Q.data());
  if (rc != 0) return rc;
  std::vector<cd> S((size_t)n * n);
  trevc_z(n, A, S.data());
  for (int i = 0; i < n; ++i) vals[i] = A[(size_t)i * n + i];
  // vecs = Q * S
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      cd acc = 0.0;
      for (int k = 0; k < n; ++k)
        acc += Q[(size_t)i * n + k] * S[(size_t)k * n + j];
      vecs[(size_t)i * n + j] = acc;
    }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// REAL tier: quasi-triangular Schur form (1x1 + 2x2 blocks) for the TPU-first
// real Krylov-Schur path.  The reference punts on real reordering
// ("real mode not implemented yet", src/arnoldi/utils.py:64-65 of the reference)
// and round 1 leaned on scipy's dgees/dtrexc here; this section removes that
// last LAPACK dependency from the flagship path:
//
//   * hessenberg_d   — real Householder reduction
//   * hess_schur_d   — Francis implicit double-shift QR with 2x2-block
//                      deflation and standardization
//   * schur_d        — the full real Schur factorization A = Q T Q^T
//   * reorder_blocks_d — greedy BLOCK reordering via direct adjacent-block
//                      swaps (Sylvester solve + orthogonal transform — the
//                      dlaexc/dtrexc method), one native call for the loop
// ---------------------------------------------------------------------------

namespace {

inline double &atd(double *A, int n, int i, int j) { return A[(size_t)i * n + j]; }

// Rotation G = [[c, s], [-s, c]] applied on the left to rows (r, r+1),
// columns [c0, c1): rows <- G * rows.
void drot_rows(double *A, int n, int r, int c0, int c1, double c, double s) {
  for (int j = c0; j < c1; ++j) {
    double x = atd(A, n, r, j), y = atd(A, n, r + 1, j);
    atd(A, n, r, j) = c * x + s * y;
    atd(A, n, r + 1, j) = -s * x + c * y;
  }
}

// G^T applied on the right to columns (col, col+1), rows [r0, r1):
// cols <- cols * G^T.
void drot_cols(double *A, int n, int col, int r0, int r1, double c, double s) {
  for (int i = r0; i < r1; ++i) {
    double x = atd(A, n, i, col), y = atd(A, n, i, col + 1);
    atd(A, n, i, col) = c * x + s * y;
    atd(A, n, i, col + 1) = -s * x + c * y;
  }
}

// Standardize the 2x2 block [[a, b], [cc, d]] at rows/cols (k, k+1) of T:
// returns rotation (cs, sn) such that the similarity G B G^T either
// triangularizes the block (real eigenvalues) or equalizes its diagonal
// (complex pair -> [p, q; r, p] with q*r < 0).  Pure rotation algebra —
// a' - d' = cos(2t)(a - d) + sin(2t)(b + cc).
void standardize_2x2(double a, double b, double cc, double d, double &cs,
                     double &sn, bool &real_pair) {
  double p = 0.5 * (a - d);
  double disc = p * p + b * cc;
  if (disc >= 0.0) {
    real_pair = true;
    // Real eigenvalues: rotate eigenvector of lam1 to e1.
    double sq = std::sqrt(disc);
    double lam = 0.5 * (a + d) + (p >= 0 ? sq : -sq);  // larger-|.| root
    // eigenvector candidates: [b, lam - a] or [lam - d, cc]
    double v0a = b, v1a = lam - a;
    double v0b = lam - d, v1b = cc;
    double na = std::hypot(v0a, v1a), nb = std::hypot(v0b, v1b);
    double v0, v1, nv;
    if (na >= nb) { v0 = v0a; v1 = v1a; nv = na; }
    else          { v0 = v0b; v1 = v1b; nv = nb; }
    if (nv == 0.0) { cs = 1.0; sn = 0.0; return; }
    cs = v0 / nv;
    sn = v1 / nv;
  } else {
    real_pair = false;
    // Complex pair: equalize the diagonal.
    double theta = 0.5 * std::atan2(-(a - d), b + cc);
    cs = std::cos(theta);
    sn = std::sin(theta);
  }
}

// Apply a 3-element Householder reflector (v normalized implicitly) to
// rows r..r+2, columns [c0, c1):  rows <- (I - tau v v^T) rows.
inline void house3_rows(double *A, int n, int r, int c0, int c1,
                        const double v[3], double tau) {
  for (int j = c0; j < c1; ++j) {
    double s = v[0] * atd(A, n, r, j) + v[1] * atd(A, n, r + 1, j) +
               v[2] * atd(A, n, r + 2, j);
    s *= tau;
    atd(A, n, r, j) -= s * v[0];
    atd(A, n, r + 1, j) -= s * v[1];
    atd(A, n, r + 2, j) -= s * v[2];
  }
}

inline void house3_cols(double *A, int n, int col, int r0, int r1,
                        const double v[3], double tau) {
  for (int i = r0; i < r1; ++i) {
    double s = v[0] * atd(A, n, i, col) + v[1] * atd(A, n, i, col + 1) +
               v[2] * atd(A, n, i, col + 2);
    s *= tau;
    atd(A, n, i, col) -= s * v[0];
    atd(A, n, i, col + 1) -= s * v[1];
    atd(A, n, i, col + 2) -= s * v[2];
  }
}

// Householder of a 3-vector x: v, tau with (I - tau v v^T) x = beta e1.
inline bool house3_vec(const double x[3], double v[3], double &tau) {
  double nrm = std::sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  if (nrm == 0.0) return false;
  double beta = (x[0] >= 0 ? -nrm : nrm);
  v[0] = x[0] - beta;
  v[1] = x[1];
  v[2] = x[2];
  double vn2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  if (vn2 == 0.0) return false;
  tau = 2.0 / vn2;
  return true;
}

}  // namespace

extern "C" {

// Real Householder Hessenberg reduction; Q is overwritten with the
// accumulated orthogonal transform (A_out = Q^T A_in Q).
void hessenberg_d(int n, double *A, double *Q) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) atd(Q, n, i, j) = (i == j) ? 1.0 : 0.0;
  std::vector<double> v((size_t)n);
  for (int k = 0; k < n - 2; ++k) {
    double xnorm = 0.0;
    for (int i = k + 1; i < n; ++i) xnorm += atd(A, n, i, k) * atd(A, n, i, k);
    xnorm = std::sqrt(xnorm);
    if (xnorm == 0.0) continue;
    double x0 = atd(A, n, k + 1, k);
    double alpha = (x0 >= 0 ? -xnorm : xnorm);
    double vnorm2 = 0.0;
    for (int i = k + 1; i < n; ++i) {
      v[i] = atd(A, n, i, k);
      if (i == k + 1) v[i] -= alpha;
      vnorm2 += v[i] * v[i];
    }
    if (vnorm2 == 0.0) continue;
    double inv = 2.0 / vnorm2;
    for (int j = 0; j < n; ++j) {  // A <- P A
      double dot = 0.0;
      for (int i = k + 1; i < n; ++i) dot += v[i] * atd(A, n, i, j);
      dot *= inv;
      for (int i = k + 1; i < n; ++i) atd(A, n, i, j) -= v[i] * dot;
    }
    for (int i = 0; i < n; ++i) {  // A <- A P
      double dot = 0.0;
      for (int j = k + 1; j < n; ++j) dot += atd(A, n, i, j) * v[j];
      dot *= inv;
      for (int j = k + 1; j < n; ++j) atd(A, n, i, j) -= dot * v[j];
    }
    for (int i = 0; i < n; ++i) {  // Q <- Q P
      double dot = 0.0;
      for (int j = k + 1; j < n; ++j) dot += atd(Q, n, i, j) * v[j];
      dot *= inv;
      for (int j = k + 1; j < n; ++j) atd(Q, n, i, j) -= dot * v[j];
    }
    atd(A, n, k + 1, k) = alpha;
    for (int i = k + 2; i < n; ++i) atd(A, n, i, k) = 0.0;
  }
}

// Francis implicit double-shift QR on an upper-Hessenberg T, accumulating
// into Q.  Produces the real Schur form: 1x1 blocks and STANDARDIZED 2x2
// blocks (equal diagonal, off-diagonal product < 0) for conjugate pairs.
int hess_schur_d(int n, double *T, double *Q, int max_sweeps) {
  if (max_sweeps <= 0) max_sweeps = 60 * n + 200;
  const double eps = 2.220446049250313e-16;
  double anorm = 0.0;
  for (int i = 0; i < n; ++i)
    for (int j = (i > 0 ? i - 1 : 0); j < n; ++j)
      anorm = std::max(anorm, std::abs(atd(T, n, i, j)));
  const double floor_tol = eps * anorm;
  int hi = n - 1;
  int sweeps_at_hi = 0;
  int total = 0;

  auto settle_2x2 = [&](int k) {
    // Standardize the block at (k, k+1); split it if its pair is real.
    double a = atd(T, n, k, k), b = atd(T, n, k, k + 1);
    double cc = atd(T, n, k + 1, k), d = atd(T, n, k + 1, k + 1);
    double cs, sn;
    bool real_pair;
    standardize_2x2(a, b, cc, d, cs, sn, real_pair);
    drot_rows(T, n, k, 0, n, cs, sn);
    drot_cols(T, n, k, 0, n, cs, sn);
    drot_cols(Q, n, k, 0, n, cs, sn);
    if (real_pair) atd(T, n, k + 1, k) = 0.0;
  };

  while (hi > 0) {
    ++g_outer_iters;
    if (++total > max_sweeps * 4 + 2000) return 1;
    int lo = hi;
    while (lo > 0) {
      double s = std::abs(atd(T, n, lo - 1, lo - 1)) +
                 std::abs(atd(T, n, lo, lo));
      double thresh = std::max(eps * s, floor_tol);
      if (std::abs(atd(T, n, lo, lo - 1)) <= thresh) {
        atd(T, n, lo, lo - 1) = 0.0;
        break;
      }
      --lo;
    }
    if (lo == hi) {  // 1x1 deflated
      --hi;
      sweeps_at_hi = 0;
      continue;
    }
    if (lo == hi - 1) {  // 2x2 window: standardize and deflate
      settle_2x2(lo);
      hi -= 2;
      sweeps_at_hi = 0;
      continue;
    }
    // Francis double shift from the trailing 2x2 of the window.
    double h00 = atd(T, n, hi - 1, hi - 1), h01 = atd(T, n, hi - 1, hi);
    double h10 = atd(T, n, hi, hi - 1), h11 = atd(T, n, hi, hi);
    double s_tr = h00 + h11;       // shift sum
    double p_det = h00 * h11 - h01 * h10;  // shift product
    if (++sweeps_at_hi % 10 == 0) {
      // Exceptional (ad hoc) shifts to break symmetric cycles.
      double w = std::abs(atd(T, n, hi, hi - 1)) +
                 std::abs(atd(T, n, hi - 1, hi - 2));
      s_tr = 2.0 * (atd(T, n, hi, hi) + 0.75 * w);
      double t1 = atd(T, n, hi, hi) + 0.4375 * w;
      p_det = t1 * t1;
    }
    if (sweeps_at_hi > max_sweeps) return 2;
    // First column of (H - aI)(H - bI) e1 restricted to the window.
    double a00 = atd(T, n, lo, lo), a01 = atd(T, n, lo, lo + 1);
    double a10 = atd(T, n, lo + 1, lo), a11 = atd(T, n, lo + 1, lo + 1);
    double a21 = atd(T, n, lo + 2, lo + 1);
    double x = a00 * a00 + a01 * a10 - s_tr * a00 + p_det;
    double y = a10 * (a00 + a11 - s_tr);
    double z = a21 * a10;
    for (int k = lo; k <= hi - 2; ++k) {
      double xv[3] = {x, y, z};
      double v[3], tau;
      if (house3_vec(xv, v, tau)) {
        int c0 = (k > lo) ? k - 1 : lo;
        house3_rows(T, n, k, c0, n, v, tau);
        int rend = std::min(k + 4, hi + 1);
        house3_cols(T, n, k, 0, rend, v, tau);
        house3_cols(Q, n, k, 0, n, v, tau);
        if (k > lo) {
          atd(T, n, k + 1, k - 1) = 0.0;
          atd(T, n, k + 2, k - 1) = 0.0;
        }
      }
      x = atd(T, n, k + 1, k);
      y = atd(T, n, k + 2, k);
      z = (k + 3 <= hi) ? atd(T, n, k + 3, k) : 0.0;
    }
    // Final 2-element rotation annihilating the last bulge entry.
    {
      int k = hi - 1;
      double f = x, g = y;
      double r = std::hypot(f, g);
      if (r > 0.0) {
        double cs = f / r, sn = g / r;
        drot_rows(T, n, k, k - 1, n, cs, sn);
        drot_cols(T, n, k, 0, std::min(k + 3, hi + 1), cs, sn);
        drot_cols(Q, n, k, 0, n, cs, sn);
        atd(T, n, k + 1, k - 1) = 0.0;
      }
    }
  }
  // Standardize any 2x2 blocks left with non-negligible subdiagonals and
  // clear the rest of the lower triangle.
  for (int i = 0; i + 1 < n; ++i) {
    if (atd(T, n, i + 1, i) != 0.0) {
      settle_2x2(i);
      ++i;
    }
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < i - 1; ++j) atd(T, n, i, j) = 0.0;
  return 0;
}

// Full real Schur A = Q T Q^T (A overwritten with T).
int schur_d(int n, double *A, double *Q) {
  hessenberg_d(n, A, Q);
  return hess_schur_d(n, A, Q, 0);
}

}  // extern "C"

namespace {

// Solve the tiny Sylvester system A11 X - X A22 = C  (A11 p x p, A22 q x q,
// C p x q; p, q <= 2) by dense Gaussian elimination with partial pivoting on
// the Kronecker form.  Returns false if the (near-singular) system indicates
// too-close spectra (swap would be unstable).
bool solve_sylvester_small(int p, int q, const double *A11, const double *A22,
                           const double *C, double *X) {
  int m = p * q;  // unknowns, vec by (i, j) -> i * q + j
  double M[16], rhs[4];
  for (int i = 0; i < m * m; ++i) M[i] = 0.0;
  for (int i = 0; i < p; ++i)
    for (int j = 0; j < q; ++j) {
      int row = i * q + j;
      rhs[row] = C[i * q + j];
      for (int k = 0; k < p; ++k) M[row * m + (k * q + j)] += A11[i * p + k];
      for (int k = 0; k < q; ++k) M[row * m + (i * q + k)] -= A22[k * q + j];
    }
  // Gaussian elimination with partial pivoting.
  for (int col = 0; col < m; ++col) {
    int best = col;
    for (int r = col + 1; r < m; ++r)
      if (std::abs(M[r * m + col]) > std::abs(M[best * m + col])) best = r;
    if (best != col) {
      for (int j = 0; j < m; ++j) std::swap(M[col * m + j], M[best * m + j]);
      std::swap(rhs[col], rhs[best]);
    }
    double d = M[col * m + col];
    if (std::abs(d) < 1e-300) return false;
    for (int r = col + 1; r < m; ++r) {
      double f = M[r * m + col] / d;
      if (f == 0.0) continue;
      for (int j = col; j < m; ++j) M[r * m + j] -= f * M[col * m + j];
      rhs[r] -= f * rhs[col];
    }
  }
  for (int r = m - 1; r >= 0; --r) {
    double acc = rhs[r];
    for (int j = r + 1; j < m; ++j) acc -= M[r * m + j] * rhs[j];
    rhs[r] = acc / M[r * m + r];
  }
  for (int i = 0; i < m; ++i) X[i] = rhs[i];
  return true;
}

// Swap ADJACENT diagonal blocks of sizes (p, q) starting at row j of the
// real quasi-triangular T (the dlaexc direct method): solve
// A11 X - X A22 = A12, orthogonalize [[-X], [I]] by Householder QR, apply
// the resulting (p+q)x(p+q) orthogonal W as a similarity on rows/cols
// [j, j+p+q), accumulate into Q, then re-standardize the moved 2x2 blocks.
bool swap_adjacent_blocks_d(int n, double *T, double *Q, int j, int p,
                            int q) {
  int w = p + q;
  double A11[4], A22[4], A12[4], X[4];
  for (int i = 0; i < p; ++i)
    for (int k = 0; k < p; ++k) A11[i * p + k] = atd(T, n, j + i, j + k);
  for (int i = 0; i < q; ++i)
    for (int k = 0; k < q; ++k)
      A22[i * q + k] = atd(T, n, j + p + i, j + p + k);
  for (int i = 0; i < p; ++i)
    for (int k = 0; k < q; ++k) A12[i * q + k] = atd(T, n, j + i, j + p + k);
  if (!solve_sylvester_small(p, q, A11, A22, A12, X)) return false;

  // M = [[-X], [I_q]]  ((p+q) x q), QR via Householder -> full W (w x w).
  double M[8];
  for (int i = 0; i < p; ++i)
    for (int k = 0; k < q; ++k) M[i * q + k] = -X[i * q + k];
  for (int i = 0; i < q; ++i)
    for (int k = 0; k < q; ++k)
      M[(p + i) * q + k] = (i == k) ? 1.0 : 0.0;
  double W[16];
  for (int i = 0; i < w; ++i)
    for (int k = 0; k < w; ++k) W[i * w + k] = (i == k) ? 1.0 : 0.0;
  for (int col = 0; col < q; ++col) {
    double nrm = 0.0;
    for (int i = col; i < w; ++i) nrm += M[i * q + col] * M[i * q + col];
    nrm = std::sqrt(nrm);
    if (nrm == 0.0) continue;
    double x0 = M[col * q + col];
    double beta = (x0 >= 0 ? -nrm : nrm);
    double v[4];
    double vn2 = 0.0;
    for (int i = col; i < w; ++i) {
      v[i] = M[i * q + col] - ((i == col) ? beta : 0.0);
      vn2 += v[i] * v[i];
    }
    if (vn2 == 0.0) continue;
    double tau = 2.0 / vn2;
    for (int k = col; k < q; ++k) {  // M <- P M
      double s = 0.0;
      for (int i = col; i < w; ++i) s += v[i] * M[i * q + k];
      s *= tau;
      for (int i = col; i < w; ++i) M[i * q + k] -= s * v[i];
    }
    for (int k = 0; k < w; ++k) {  // W <- W P   (accumulate product of Ps)
      double s = 0.0;
      for (int i = col; i < w; ++i) s += W[k * w + i] * v[i];
      s *= tau;
      for (int i = col; i < w; ++i) W[k * w + i] -= s * v[i];
    }
  }
  // dlaexc-style stability gate: rehearse the similarity on the w x w
  // window alone and reject the swap unless the block that must vanish
  // actually does.  Near-equal spectra make X (and hence W's rotation
  // angle error) huge; the pivot test in the Sylvester solve alone never
  // fires on such systems (the Kronecker matrix is ill-conditioned, not
  // exactly singular), and committing the swap would zero a sub-block
  // holding O(||X|| eps ||T||) ~ O(||T||) residue.  LAPACK's dlaexc
  // applies the same rehearse-then-test with thresh = 10 eps ||D||.
  {
    double D[16], WD[16], WDW[16];
    double dnorm = 0.0;
    for (int i = 0; i < w; ++i)
      for (int k = 0; k < w; ++k) {
        D[i * w + k] = atd(T, n, j + i, j + k);
        dnorm = std::max(dnorm, std::abs(D[i * w + k]));
      }
    for (int i = 0; i < w; ++i)
      for (int k = 0; k < w; ++k) {
        double acc = 0.0;
        for (int l = 0; l < w; ++l) acc += W[l * w + i] * D[l * w + k];
        WD[i * w + k] = acc;
      }
    for (int i = 0; i < w; ++i)
      for (int k = 0; k < w; ++k) {
        double acc = 0.0;
        for (int l = 0; l < w; ++l) acc += WD[i * w + l] * W[l * w + k];
        WDW[i * w + k] = acc;
      }
    double thresh = std::max(10.0 * 2.220446049250313e-16 * dnorm, 1e-300);
    for (int i = q; i < w; ++i)
      for (int k = 0; k < q; ++k)
        if (std::abs(WDW[i * w + k]) > thresh) return false;
  }

  // Similarity on the window: T <- (I x W^T) T (I x W), Q <- Q W.
  // Range-limited: rows j..j+w are zero in columns < j (T is
  // quasi-triangular and blocks never straddle column j), and columns
  // j..j+w are zero below row j+w — updating only the structurally
  // nonzero ranges halves the T traffic per swap (the reorder is the
  // hottest dense-tier op in the host restart loop: ~10^3 swaps per
  // rotate when the fresh QR order is far from the sort order).
  thread_local std::vector<double> buf;
  buf.resize((size_t)w * (n > j ? n - j : 0));
  for (int i = 0; i < w; ++i)  // rows: W^T * T[j..j+w), columns [j, n)
    for (int col = j; col < n; ++col) {
      double acc = 0.0;
      for (int k = 0; k < w; ++k) acc += W[k * w + i] * atd(T, n, j + k, col);
      buf[(size_t)i * (n - j) + (col - j)] = acc;
    }
  for (int i = 0; i < w; ++i)
    for (int col = j; col < n; ++col)
      atd(T, n, j + i, col) = buf[(size_t)i * (n - j) + (col - j)];
  int rend_sim = std::min(j + w, n);
  thread_local std::vector<double> tmpc;
  tmpc.resize((size_t)rend_sim * w);
  for (int r = 0; r < rend_sim; ++r)  // cols: T[:, j..j+w) * W, rows [0, j+w)
    for (int i = 0; i < w; ++i) {
      double acc = 0.0;
      for (int k = 0; k < w; ++k) acc += atd(T, n, r, j + k) * W[k * w + i];
      tmpc[(size_t)r * w + i] = acc;
    }
  for (int r = 0; r < rend_sim; ++r)
    for (int i = 0; i < w; ++i) atd(T, n, r, j + i) = tmpc[(size_t)r * w + i];
  for (int r = 0; r < n; ++r) {  // Q <- Q W
    double acc[4];
    for (int i = 0; i < w; ++i) {
      acc[i] = 0.0;
      for (int k = 0; k < w; ++k) acc[i] += atd(Q, n, r, j + k) * W[k * w + i];
    }
    for (int i = 0; i < w; ++i) atd(Q, n, r, j + i) = acc[i];
  }
  // Clean the now-zero sub-block and re-standardize moved 2x2 blocks.
  for (int i = q; i < w; ++i)
    for (int k = 0; k < q; ++k) atd(T, n, j + i, j + k) = 0.0;
  auto restd = [&](int k, int sz) {
    if (sz != 2) return;
    double a = atd(T, n, k, k), b = atd(T, n, k, k + 1);
    double cc = atd(T, n, k + 1, k), d = atd(T, n, k + 1, k + 1);
    double cs, sn;
    bool real_pair;
    standardize_2x2(a, b, cc, d, cs, sn, real_pair);
    drot_rows(T, n, k, 0, n, cs, sn);
    drot_cols(T, n, k, 0, n, cs, sn);
    drot_cols(Q, n, k, 0, n, cs, sn);
    if (real_pair) atd(T, n, k + 1, k) = 0.0;
  };
  restd(j, q);
  restd(j + q, p);
  return true;
}

}  // namespace

extern "C" {

// Greedy block reorder of a real quasi-triangular T: blocks are detected
// from the subdiagonal; order[t] = ORIGINAL block id to place at slot t
// (nb entries).  One native call for the whole loop (the real analog of
// ordered_schur_z); returns 0 on success, 1 on an unstable swap.
int reorder_blocks_d(int n, double *T, double *Q, int nb, const int *order) {
  // Detect blocks.
  std::vector<int> sizes;
  for (int i = 0; i < n;) {
    if (i + 1 < n && atd(T, n, i + 1, i) != 0.0) {
      sizes.push_back(2);
      i += 2;
    } else {
      sizes.push_back(1);
      i += 1;
    }
  }
  if ((int)sizes.size() != nb) return -1;
  std::vector<int> ids((size_t)nb);
  for (int i = 0; i < nb; ++i) ids[i] = i;
  std::vector<int> cur_sizes(sizes);
  for (int target = 0; target < nb; ++target) {
    int want = order[target];
    int slot = -1;
    for (int s = target; s < nb; ++s)
      if (ids[s] == want) { slot = s; break; }
    if (slot < 0) return -2;
    // Bubble the block left one neighbour at a time.
    while (slot > target) {
      // start row of block slot-1
      int row = 0;
      for (int s = 0; s < slot - 1; ++s) row += cur_sizes[s];
      int p = cur_sizes[slot - 1], q = cur_sizes[slot];
      if (!swap_adjacent_blocks_d(n, T, Q, row, p, q)) return 1;
      std::swap(ids[slot - 1], ids[slot]);
      std::swap(cur_sizes[slot - 1], cur_sizes[slot]);
      --slot;
    }
  }
  return 0;
}

}  // extern "C"
