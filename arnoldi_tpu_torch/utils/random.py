"""Seeded start-vector generation.

Counterpart of ``arnoldi_tpu/utils/random.py`` with a ``torch.Generator``
in place of the ``jax.random`` key.  As in the reference, a real Gaussian
vector is drawn and then cast, so a complex start vector has a zero
imaginary part.  The two frameworks draw different numbers from the same
seed; tests that compare them pass one ``v0`` to both.
"""

import torch


def rand_normalized_vector(n, dtype, *, device, generator=None):
    """A unit-norm start vector of length ``n`` on ``device``.

    ``generator`` is a CPU ``torch.Generator`` (default: seeded with 0), so
    the vector does not depend on the device it ends up on.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    real = dtype.to_real() if dtype.is_complex else dtype
    v = torch.randn(n, generator=generator, dtype=real)
    v = v / torch.linalg.vector_norm(v)
    return v.to(device=device, dtype=dtype)
