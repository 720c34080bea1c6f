"""Small dense tier: Schur factorization, ordered Schur, eig of the projected
Hessenberg matrix.

The port's copy of ``arnoldi_tpu/ops/dense_tier.py``, unchanged but for this
paragraph and the source path below: host NumPy/SciPy code whose relative
imports resolve inside ``arnoldi_tpu_torch``.

In the solver these run on m x m matrices with m <= ~200 — off the hot path
(reference call stack §3.1: LAPACK zgees/ztrexc on the host while the sharded
tall matmuls run on device).  Two backends:

* ``native`` — the in-repo C++ implementation
  (``arnoldi_tpu_torch/native/dense_tier.cpp``): complex Hessenberg QR iteration,
  Givens-rotation eigenvalue reordering (trexc-equivalent, with the greedy
  sort loop done in one native call rather than m^2 Python->LAPACK hops —
  reference ``utils.py:45-63``), and triangular-eigenvector back-substitution.
* ``scipy`` — LAPACK via scipy (zgees/ztrexc), used as the validation oracle
  and automatic fallback.

Reference semantics this must honour (``src/arnoldi/utils.py:24-67``):
``ordered_schur`` greedily moves the sort-function's picks to the leading
diagonal positions via trexc swaps; complex output only (the real 2x2-block
mode is a capability gap in the reference — here the complex path is the
supported one, and real inputs are promoted).
"""

import os

import numpy as np

from ..utils.sorting import arg_largest_magnitude

_BACKEND = os.environ.get("ARNOLDI_TPU_DENSE_BACKEND", "auto")


def _native():
    """Return the native module, or None if unavailable."""
    if _BACKEND == "scipy":
        return None
    try:
        from ..native import dense_tier as native_mod

        return native_mod if native_mod.available() else None
    except Exception:
        if _BACKEND == "native":
            raise
        return None


def _complex_type(dtype):
    return np.result_type(np.dtype(dtype), np.complex64)


def schur_complex(A):
    """Complex Schur factorization ``A = Z T Z^H`` (T upper triangular).

    Returns ``(T, Z)`` with the complex type promoted from ``A.dtype``.
    """
    A = np.asarray(A)
    ct = _complex_type(A.dtype)
    nat = _native()
    if nat is not None:
        try:
            return nat.schur_complex(A.astype(ct))
        except RuntimeError:
            pass  # non-convergence in the native QR: fall back to LAPACK
    from scipy.linalg import schur

    return schur(A.astype(ct), output="complex")


def move_eigenvalue(T, Z, ifst, ilst):
    """trexc equivalent: move diagonal entry ``ifst`` to position ``ilst``
    (0-based) by a sequence of adjacent Givens swaps, updating ``T`` and
    ``Z`` in a unitary similarity.  Complex triangular ``T`` only.
    """
    nat = _native()
    if nat is not None:
        return nat.trexc(T, Z, ifst, ilst)
    from scipy.linalg.lapack import ctrexc, ztrexc

    fn = ztrexc if T.dtype == np.complex128 else ctrexc
    T, Z, info = fn(T, Z, ifst + 1, ilst + 1)  # LAPACK is 1-based
    if info != 0:
        raise RuntimeError(f"trexc failed with info={info}")
    return T, Z


def ordered_schur(a, output="complex", *, sort_function=None):
    """Schur decomposition with the diagonal ordered by ``sort_function``.

    Parity with reference ``utils.py:32-67``: greedy reordering — for each
    target position take the sort function's pick among the original
    eigenvalues and move it there with trexc swaps, tracking positions.
    Only ``output='complex'`` is supported (same restriction as the
    reference; real 2x2-block reordering raises).
    """
    if output != "complex":
        raise ValueError("output!='complex' not implemented yet")
    if sort_function is None:
        sort_function = arg_largest_magnitude

    a = np.asarray(a)
    T, Z = schur_complex(a)
    # Preserve the reference's dtype contract: the output dtype matches the
    # complex promotion of the input (complex in, same complex out).
    n = T.shape[0]

    eigenvalues = np.diag(T)
    ordered_indices = np.asarray(sort_function(eigenvalues))

    nat = _native()
    # the native loop needs a FULL permutation; a sort_function returning
    # a top-k prefix routes to the incremental Python path below
    if nat is not None and len(ordered_indices) == n:
        try:
            return nat.ordered_schur(T, Z, ordered_indices.astype(np.int32))
        except RuntimeError:
            pass  # fall through to the move_eigenvalue loop

    current_pos = list(range(n))
    for target, source_idx in enumerate(ordered_indices):
        source = current_pos.index(int(source_idx))
        if source != target:
            T, Z = move_eigenvalue(T, Z, source, target)
            moved = current_pos.pop(source)
            current_pos.insert(target, moved)
    return T, Z


def schur_real(A):
    """Real Schur factorization ``A = Z T Z^T`` with T quasi-triangular
    (1x1 blocks for real eigenvalues, standardized 2x2 blocks for
    conjugate pairs).  Native C++ (Householder + Francis double-shift QR,
    ``dense_tier.cpp``) with LAPACK-via-scipy as the fallback oracle."""
    A = np.asarray(A)
    assert not np.iscomplexobj(A)
    nat = _native()
    if nat is not None:
        try:
            return nat.schur_real(A)
        except RuntimeError:
            pass  # QR non-convergence: fall back to LAPACK
    from scipy.linalg import schur

    return schur(A, output="real")


def real_schur_blocks(T, tol=None):
    """Partition a real quasi-triangular T into diagonal blocks.

    Returns ``(starts, sizes)``: lists of the 0-based start row and size
    (1 or 2) of each block, detected from nonzero subdiagonal entries.
    """
    T = np.asarray(T)
    n = T.shape[0]
    if tol is None:
        tol = 0.0  # LAPACK sets sub-diagonal entries of 1x1 blocks exactly 0
    starts, sizes = [], []
    i = 0
    while i < n:
        if i + 1 < n and abs(T[i + 1, i]) > tol:
            starts.append(i)
            sizes.append(2)
            i += 2
        else:
            starts.append(i)
            sizes.append(1)
            i += 1
    return starts, sizes


def real_schur_eigvals(T):
    """Eigenvalues of a real quasi-triangular T, positionally: entry i is the
    eigenvalue 'living at' diagonal position i (conjugate pairs occupy their
    block's two positions as lambda, conj(lambda))."""
    T = np.asarray(T)
    n = T.shape[0]
    vals = np.zeros(n, dtype=np.complex128)
    starts, sizes = real_schur_blocks(T)
    for s, sz in zip(starts, sizes):
        if sz == 1:
            vals[s] = T[s, s]
        else:
            a, b = T[s, s], T[s, s + 1]
            c, d = T[s + 1, s], T[s + 1, s + 1]
            mu = (a + d) / 2.0
            disc = ((a - d) / 2.0) ** 2 + b * c
            # a 2x2 Schur block always has a complex pair (disc < 0)
            w = np.sqrt(complex(disc))
            vals[s] = mu + w
            vals[s + 1] = mu - w
            if vals[s].imag < 0:
                vals[s], vals[s + 1] = vals[s + 1], vals[s]
    return vals


def ordered_schur_real(a, *, sort_function=None):
    """Real Schur decomposition with diagonal *blocks* ordered by
    ``sort_function``.

    The reference punts on this ("real mode not implemented yet",
    ``utils.py:64-65``); it is required here because the TPU hot path runs
    in real arithmetic.  Greedy block reordering — a conjugate pair moves
    as one unit and is ranked by its first (positive-imaginary)
    eigenvalue.  Native path: direct adjacent-block swaps (Sylvester solve
    + orthogonal transform, the dlaexc method) with the WHOLE greedy loop
    in one C++ call (``dense_tier.cpp reorder_blocks_d``); fallback:
    LAPACK ``{s,d}trexc`` one move at a time.

    Returns ``(T, Z, eigvals)`` where ``eigvals`` is the positional complex
    eigenvalue array of the final T (see :func:`real_schur_eigvals`).
    """
    if sort_function is None:
        sort_function = arg_largest_magnitude

    a = np.asarray(a)
    T, Z = schur_real(a)

    starts, sizes = real_schur_blocks(T)
    vals = real_schur_eigvals(T)
    # One representative eigenvalue per block (for pairs, the +imag one:
    # LM/LR/SM/SR rank conjugate twins identically).
    reps = np.array([vals[s] for s in starts])
    block_order = np.asarray(sort_function(reps))

    nat = _native()
    if nat is not None:
        try:
            T, Z = nat.reorder_blocks_real(T, Z,
                                           block_order.astype(np.int32))
            return T, Z, real_schur_eigvals(T)
        except RuntimeError:
            pass  # unstable swap (pathologically close spectra): use LAPACK

    from scipy.linalg.lapack import dtrexc, strexc

    trexc = strexc if T.dtype == np.float32 else dtrexc
    ids = list(range(len(starts)))     # block ids in current T order
    cur_sizes = list(sizes)
    for target_slot, want_id in enumerate(block_order):
        cur_slot = ids.index(int(want_id))
        if cur_slot == target_slot:
            continue
        cur_starts = np.concatenate([[0], np.cumsum(cur_sizes)[:-1]])
        ifst = int(cur_starts[cur_slot])
        ilst = int(cur_starts[target_slot])
        T, Z, info = trexc(T, Z, ifst + 1, ilst + 1)  # LAPACK 1-based
        if info != 0:
            raise RuntimeError(f"trexc failed with info={info}")
        ids.pop(cur_slot)
        ids.insert(target_slot, int(want_id))
        moved = cur_sizes.pop(cur_slot)
        cur_sizes.insert(target_slot, moved)

    return T, Z, real_schur_eigvals(T)


def eig(A):
    """Dense eigendecomposition of a small matrix (host)."""
    A = np.asarray(A)
    nat = _native()
    if nat is not None and np.iscomplexobj(A):
        try:
            return nat.eig(A)
        except RuntimeError:
            pass  # QR non-convergence: LAPACK is the fallback oracle
    return np.linalg.eig(A)


def eig_from_schur(T, Z=None):
    """Eigenpairs from a complex Schur form: values = diag(T), vectors by
    back-substitution on the triangular T (optionally rotated by Z).
    """
    nat = _native()
    if nat is not None:
        S = nat.triangular_eigvecs(T)
    else:
        S = _triangular_eigvecs_np(T)
    if Z is not None:
        S = Z @ S
    return np.diag(T).copy(), S


def _triangular_eigvecs_np(T):
    """Right eigenvectors of an upper-triangular complex matrix, normalized,
    by back-substitution: for eigenvalue T[k,k], solve
    ``(T[:k,:k] - T[k,k] I) y = -T[:k, k]``, vector = [y; 1; 0...].
    """
    T = np.asarray(T)
    n = T.shape[0]
    S = np.zeros_like(T)
    diag = np.diag(T)
    eps = np.finfo(T.dtype).eps
    scale = max(np.abs(diag).max(initial=0.0), 1.0)
    for k in range(n):
        S[k, k] = 1.0
        if k > 0:
            M = T[:k, :k].copy()
            d = diag[:k] - diag[k]
            # Perturb (near-)defective shifts so the solve stays bounded
            # (LAPACK ztrevc uses the same safeguard idea).
            small = np.abs(d) < eps * scale
            d = np.where(small, eps * scale * np.where(d.real < 0, -1, 1), d)
            M[np.arange(k), np.arange(k)] = d
            from scipy.linalg import solve_triangular

            S[:k, k] = solve_triangular(M, -T[:k, k])
        S[:, k] /= np.linalg.norm(S[:, k])
    return S


def resolve_straddle(T, Z, cut, min_keep=0):
    """Make ``cut`` a clean block boundary of the real quasi-triangular
    ``T`` by swapping the straddling 2x2 block one slot across the cut
    (instead of moving the cut — the cut position is a STATIC shape in the
    jitted device code, and letting it drift forces a fresh XLA
    compilation per convergence path).

    Returns ``(T, Z)`` (unchanged when the cut is already clean).  The
    relocated 1x1 must come from (and land in) UNCONVERGED buffer
    positions — ``min_keep`` marks the sort-ranked prefix the caller is
    about to gate/return (its nev); a relocation that would write into or
    remove from ``[0, min_keep)`` raises instead, and the caller falls
    back to stepping the cut.
    """
    T = np.asarray(T)
    n = T.shape[0]
    if cut <= 0 or cut >= n or T[cut, cut - 1] == 0:
        return T, Z
    starts, sizes = real_schur_blocks(T)
    # the straddling pair starts at cut-1
    idx = starts.index(cut - 1)
    # A clean boundary at `cut` needs the leading block sizes to sum to
    # exactly `cut`.  Swapping the pair with a 2x2 neighbour just moves the
    # straddle, so instead relocate the NEAREST 1x1 block across the cut:
    # a 1x1 from after the pair moved to the pair's slot adds 1 to the
    # leading prefix (boundary lands at the pair's new start = cut); a 1x1
    # from before moved past the pair subtracts 1 (pair starts at cut-2).
    after = [j for j in range(idx + 1, len(sizes)) if sizes[j] == 1]
    before = [j for j in range(idx) if sizes[j] == 1]
    order = list(range(len(starts)))
    # min_keep gates: an "after" 1x1 lands at position cut-1 (must be a
    # buffer slot); a "before" 1x1 is removed from its own position (must
    # not be a wanted one).
    if after and (cut - 1) >= min_keep:
        j = after[0]
        order.insert(idx, order.pop(j))      # 1x1 moves to the pair's slot
    elif before and starts[before[-1]] >= min_keep:
        j = before[-1]
        order.insert(idx, order.pop(j))      # 1x1 moves just after the pair
    else:
        raise RuntimeError(
            "no relocation keeps the wanted prefix intact (all-2x2 parity "
            "or the cut sits at the wanted boundary)")

    nat = _native()
    if nat is not None:
        try:
            return nat.reorder_blocks_real(T, Z,
                                           np.asarray(order, np.int32))
        except RuntimeError:
            pass
    from scipy.linalg.lapack import dtrexc, strexc

    trexc = strexc if T.dtype == np.float32 else dtrexc
    if after:
        # move the 1x1 up to the pair's start (others shift down)
        ifst, ilst = starts[after[0]], starts[idx]
    else:
        # move the 1x1 down past the pair (others shift up)
        ifst, ilst = starts[before[-1]], starts[idx] + sizes[idx] - 1
    T, Z, info = trexc(T, Z, ifst + 1, ilst + 1)
    if info != 0:
        raise RuntimeError(f"trexc failed with info={info}")
    return T, Z
