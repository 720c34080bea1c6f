"""Device, dtype and matmul-precision rules of the port.

The JAX package asks every projection and truncation matmul for
``Precision.HIGHEST`` (``arnoldi_tpu/ops/ortho.py``), because a reduced
precision product loses basis orthogonality long before float32 epsilon.
The port's form of that rule: a float32 solve on a CUDA device refuses to
run while PyTorch may route float32 matmuls through TF32.
"""

import numpy as np
import torch

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype):
    """A torch dtype from a torch or NumPy dtype (or anything ``np.dtype``
    takes)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NUMPY_TO_TORCH[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype):
    """The NumPy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def is_inexact(dtype):
    """True for a floating or complex torch or NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point or dtype.is_complex
    return np.issubdtype(np.dtype(dtype), np.inexact)


def solver_dtype(dtype):
    """The torch dtype a solve of an operator of ``dtype`` (torch or NumPy)
    works in when none is asked for: a floating or complex dtype as it is,
    any other real one (integers, bool) promoted to ``np.result_type(dtype,
    np.float32)``, as the JAX package promotes it
    (``arnoldi_tpu/solvers/krylov_schur.py:_solver_dtype`` on the real path,
    ``lanczos.py:301-305``): int8/int16 to float32, int32/int64 to float64."""
    if is_inexact(dtype):
        return torch_dtype(dtype)
    if isinstance(dtype, torch.dtype):
        dtype = numpy_dtype(dtype)
    return torch_dtype(np.result_type(dtype, np.float32))


def check_matmul_precision(dtype, device):
    """Raise if a float32 solve on ``device`` could run its matmuls in TF32."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 solve with TF32 matmuls enabled: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")
