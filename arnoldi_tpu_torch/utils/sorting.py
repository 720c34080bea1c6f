"""Eigenvalue 'which' selectors.

The port's copy of ``arnoldi_tpu/utils/sorting.py``, unchanged but for this
paragraph.

Protocol parity with the reference (``src/arnoldi/utils.py:16-21``): a sort
function maps an array of eigenvalue estimates to an index array ordering them
most-wanted first.  The string aliases ("LM", "LR", ...) follow ARPACK's
convention and the reference's script-layer mapping
(``scripts/utils.py:18-21``).

These run on small host-side arrays (Ritz/Schur eigenvalues of the m x m
projected matrix), so they are plain NumPy; they also accept JAX arrays.
"""

import numpy as np


def arg_largest_magnitude(x):
    """Indices sorting ``x`` by decreasing ``|x|`` (ARPACK "LM")."""
    return np.argsort(-np.abs(np.asarray(x)), kind="stable")


def arg_largest_real(x):
    """Indices sorting ``x`` by decreasing real part (ARPACK "LR")."""
    return np.argsort(-np.real(np.asarray(x)), kind="stable")


def arg_smallest_magnitude(x):
    """Indices sorting ``x`` by increasing ``|x|`` (ARPACK "SM")."""
    return np.argsort(np.abs(np.asarray(x)), kind="stable")


def arg_smallest_real(x):
    """Indices sorting ``x`` by increasing real part (ARPACK "SR")."""
    return np.argsort(np.real(np.asarray(x)), kind="stable")


def arg_largest_imaginary(x):
    """Indices sorting ``x`` by decreasing imaginary part (ARPACK "LI")."""
    return np.argsort(-np.imag(np.asarray(x)), kind="stable")


def arg_smallest_imaginary(x):
    """Indices sorting ``x`` by increasing imaginary part (ARPACK "SI")."""
    return np.argsort(np.imag(np.asarray(x)), kind="stable")


SORT_FUNCTIONS = {
    "LM": arg_largest_magnitude,
    "LR": arg_largest_real,
    "SM": arg_smallest_magnitude,
    "SR": arg_smallest_real,
    "LI": arg_largest_imaginary,
    "SI": arg_smallest_imaginary,
}


def sort_function_for(which):
    """Resolve a sort function from an ARPACK-style string or a callable."""
    if callable(which):
        return which
    try:
        return SORT_FUNCTIONS[which]
    except KeyError:
        raise ValueError(
            f"Unknown 'which' selector {which!r}; expected one of "
            f"{sorted(SORT_FUNCTIONS)} or a callable"
        ) from None
