"""The port's fused Gram-Schmidt passes (plain PyTorch versions of the
CUDA kernels) and ortho kernels against the JAX package's Pallas kernels in
interpret mode and its XLA ortho kernels, on the ``TestOrthoFusedPallas``
setup of ``tests/test_pallas.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldi_tpu.ops import ortho as jax_ortho
from arnoldi_tpu.ops.pallas.ortho_fused import (
    cgs2_pallas,
    masked_project_pallas,
    project_update_norm_pallas,
)
from arnoldi_tpu_torch.ops import ortho
from arnoldi_tpu_torch.ops.kernels.ortho_fused import (
    masked_project,
    project_update_norm,
)

torch.set_num_threads(1)

N, MP1, J = 900, 21, 12
#: Sums of up to 900 products in another order: float32 ~1e-6 relative.
ATOL = {np.float32: 1e-5, np.float64: 1e-12}


def _setup(dtype, w_in_span=0.0):
    """Orthonormal leading J rows, stale noise after them (which both
    packages must ignore), and a w with a chosen share inside the span."""
    rng = np.random.default_rng(7)
    Vt = np.zeros((MP1, N))
    Vt[:J] = np.linalg.qr(rng.standard_normal((N, J)))[0].T
    Vt[J:] = rng.standard_normal((MP1 - J, N))
    w = rng.standard_normal(N)
    if w_in_span:
        w = w_in_span * (rng.standard_normal(J) @ Vt[:J]) + (1 - w_in_span) * w
    return Vt.astype(dtype), w.astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_masked_project(dtype):
    Vt, w = _setup(dtype)
    mask = (jnp.arange(MP1) < J).astype(dtype)
    c_ref = np.asarray(masked_project_pallas(jnp.asarray(Vt), jnp.asarray(w),
                                             mask, interpret=True,
                                             block_cols=256))
    c = masked_project(_t(Vt), _t(w), J).numpy()
    np.testing.assert_allclose(c, c_ref, atol=ATOL[dtype])
    assert np.all(c[J:] == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_project_update_norm(dtype):
    Vt, w = _setup(dtype)
    c = np.zeros(MP1, dtype)
    c[:J] = 0.5
    w_ref, ns_ref = project_update_norm_pallas(
        jnp.asarray(Vt), jnp.asarray(w), jnp.asarray(c), interpret=True,
        block_cols=256)
    # Entries of c past n_active are ignored by the port (the JAX kernel
    # multiplies them by the stale rows): put garbage there.
    c_port = c.copy()
    c_port[J:] = 1e3
    w2, ns = project_update_norm(_t(Vt), _t(w), _t(c_port), J)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w_ref), atol=ATOL[dtype])
    np.testing.assert_allclose(float(ns), float(ns_ref),
                               rtol=100 * ATOL[dtype])


def test_stale_rows_are_never_read():
    Vt, w = _setup(np.float64)
    Vt[J:] = np.nan
    c = masked_project(_t(Vt), _t(w), J)
    w2, ns = project_update_norm(_t(Vt), _t(w), c, J)
    assert torch.isfinite(c).all() and torch.isfinite(w2).all()
    assert torch.isfinite(ns)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tol", [1e-6, 1e3])
def test_cgs2_matches_pallas(dtype, tol):
    Vt, w = _setup(dtype)
    ref = cgs2_pallas(jnp.asarray(Vt), jnp.asarray(w), J, tol=tol,
                      interpret=True, block_cols=256)
    got = ortho.ORTHO_KERNELS["cgs2_pallas"](_t(Vt), _t(w), J, tol=tol)
    _assert_same_contract(got, ref, dtype)
    # orthogonality of the result
    np.testing.assert_allclose(Vt[:J] @ got[1].numpy(), 0,
                               atol=10 * ATOL[dtype])


@pytest.mark.parametrize("name", ["cgs_dgks", "cgs2", "cgs"])
@pytest.mark.parametrize("w_in_span", [0.0, 0.9, 1.0])
def test_ortho_kernels_match_jax(name, w_in_span):
    """w in span 0.9 takes the DGKS second pass; 1.0 breaks down."""
    Vt, w = _setup(np.float64, w_in_span)
    ref = jax_ortho.ORTHO_KERNELS[name](jnp.asarray(Vt), jnp.asarray(w), J,
                                        tol=1e-8)
    got = ortho.ORTHO_KERNELS[name](_t(Vt), _t(w), J, tol=1e-8)
    _assert_same_contract(got, ref, np.float64)
    assert bool(got[3]) == (w_in_span == 1.0)


def _assert_same_contract(got, ref, dtype):
    h, w2, beta, br = got
    h0, w20, b0, br0 = ref
    assert h.shape == (MP1,) and w2.shape == (N,) and beta.ndim == 0
    np.testing.assert_allclose(h.numpy(), np.asarray(h0), atol=ATOL[dtype])
    assert np.all(h.numpy()[J:] == 0)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w20), atol=ATOL[dtype])
    assert abs(float(beta) - float(b0)) < ATOL[dtype]
    assert bool(br) == bool(br0)


def test_registry():
    assert ortho.resolve_ortho("cgs2_pallas") is ortho.resolve_ortho("cgs2")
    assert ortho.resolve_ortho(ortho.cgs_dgks) is ortho.cgs_dgks
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ortho.resolve_ortho("mgs_dgks")
    with pytest.raises(ValueError, match="Unknown"):
        ortho.resolve_ortho("householder")


def test_bad_active_count_raises():
    Vt, w = _setup(np.float64)
    with pytest.raises(ValueError, match="n_active"):
        masked_project(_t(Vt), _t(w), MP1 + 1)
