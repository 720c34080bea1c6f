"""The port's ring-halo and all-gather SpMV over a row mesh against the
JAX package's ``*_matvec_halo`` and GSPMD products on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual devices
(``banded_matvec_halo``, ``ell_matvec_halo``, ``bsr_matvec_halo`` with
``overlap=True``); the port's runs in
2 and 4 gloo processes (``torch_dist_worker.py``), the halo with ``overlap``
True and False, one column and three, and the all-gather, all against
JAX's halo results: banded ``laplace(1024)``, ``laplace_2d(32)``,
``laplace_2d(16, 32)``, a scattered band-limited matrix as ELL and as
BSR-8, and a diagonal (zero halo) in all three formats.  Every product
agrees within 1e-12.  In process: a one-rank halo operator is the format's
kernel bit for bit, the ``spmv_dia_ext`` shard form's plain version
against the square form's, the CUDA kernel against it on a card, and the
refusals.  Spawned at 4 ranks: a refined float32 ``partial_eigh`` (LA 3)
over the DIA halo of a 9-band matrix with a separated top, against
``eigvalsh``.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace
from arnoldi_tpu.parallel import (banded_matvec_halo, bsr_matvec_halo,
                                  ell_matvec_halo, make_mesh as jax_make_mesh,
                                  shard_operator as jax_shard_operator,
                                  sparsity_bandwidth as jax_sparsity_bandwidth)
from arnoldi_tpu_torch import as_operator
from arnoldi_tpu_torch.linop import cast_operator
from arnoldi_tpu_torch.ops.kernels import spmv_banded
from arnoldi_tpu_torch.parallel import (HaloOperator, halo_matvec_closure,
                                        make_mesh, sparsity_bandwidth)
from torch_dist_worker import MATVEC_CASES, matvec_inputs
from torch_parity import cuda_device  # noqa: F401 (fixture)

import torch_dist

torch.set_num_threads(1)
CASES = list(MATVEC_CASES)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8)


def _sharded(mesh, x):
    return jax.device_put(jax.numpy.asarray(x), NamedSharding(mesh, P("rows")))


@pytest.fixture(scope="module")
def jax_products(jax_mesh):
    """JAX's halo products of every case, ``{case: (y, Y, halo)}``: x and
    the three columns of X, each one ``*_matvec_halo`` call (one jit a
    case), with JAX's bandwidth."""
    halo_fn = {"banded": banded_matvec_halo, "ell": ell_matvec_halo}
    cols = NamedSharding(jax_mesh, P(None, "rows"))
    out = {}
    for seed, (name, (make, fmt)) in enumerate(MATVEC_CASES.items()):
        A = make()
        jop = jax_as_operator(A, format=fmt)
        sop = jax_shard_operator(jop, jax_mesh)
        fn = halo_fn.get(fmt if isinstance(fmt, str) else "bsr", bsr_matvec_halo)
        x, X = matvec_inputs(A.shape[0], seed)
        XX = jax.device_put(jax.numpy.asarray(np.vstack([x, X])), cols)
        Y = np.asarray(jax.jit(lambda XX: jax.numpy.stack(
            [fn(sop, XX[i], jax_mesh, overlap=True) for i in range(4)]))(XX))
        out[name] = (Y[0], Y[1:], jax_sparsity_bandwidth(jop))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def port_products(request, tmp_path_factory):
    size = request.param
    return size, torch_dist.spawn("matvecs", size,
                                  tmp_path_factory.mktemp(f"matvecs{size}"))


@pytest.mark.parametrize("case", CASES)
def test_halo_products_match_jax(case, port_products, jax_products):
    _, ranks = port_products
    y, Y, halo = jax_products[case]
    got = ranks[0]
    assert int(got[f"halo_width_{case}"]) == halo
    for overlap in (True, False):
        np.testing.assert_allclose(got[f"halo_{case}_{overlap}"], y,
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got[f"halo_cols_{case}_{overlap}"], Y,
                                   rtol=1e-12, atol=1e-12)
    for r in ranks[1:]:                     # every rank gathered the same
        np.testing.assert_array_equal(r[f"halo_{case}_True"],
                                      got[f"halo_{case}_True"])


@pytest.mark.parametrize("case", CASES)
def test_allgather_products_match_jax(case, port_products, jax_products):
    _, ranks = port_products
    y, Y, _ = jax_products[case]
    np.testing.assert_allclose(ranks[0][f"gather_{case}"], y,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ranks[0][f"gather_cols_{case}"], Y,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["laplace_2d_32", "scattered_ell",
                                  "scattered_bsr"])
def test_one_rank_halo_is_the_format_kernel(case):
    make, fmt = MATVEC_CASES[case]
    A = make()
    op = as_operator(A, format=fmt, device="cpu")
    halo = halo_matvec_closure(op, make_mesh(device="cpu"))
    assert isinstance(halo, HaloOperator) and halo.halo == sparsity_bandwidth(op)
    x, X = matvec_inputs(A.shape[0], 0)
    x, X = torch.from_numpy(x), torch.from_numpy(X)
    np.testing.assert_array_equal(halo.matvec(x).numpy(), op.matvec(x).numpy())
    np.testing.assert_array_equal(halo.matmat_rows(X).numpy(),
                                  op.matmat_rows(X).numpy())
    # fn_f64 of a float32 block: its own (float32) values, in float64
    op32 = cast_operator(cast_operator(op, torch.float32), torch.float64)
    np.testing.assert_array_equal(halo.cast(torch.float32).fn_f64(x).numpy(),
                                  op32.matvec(x).numpy())


@pytest.mark.parametrize("b", [1, 3])
def test_dia_shard_form_plain_version(b):
    rng = np.random.default_rng(5)
    n, offsets = 300, (-17, -1, 0, 1, 17)
    bands = torch.from_numpy(rng.standard_normal((5, n)))
    x = torch.from_numpy(rng.standard_normal((b, n) if b > 1 else n))
    square = spmv_banded.banded_matvec_plain(bands, x, offsets)
    np.testing.assert_array_equal(
        spmv_banded.banded_matvec_ext_plain(bands, x, offsets, x_base=0).numpy(),
        square.numpy())
    # rows [40, 90) of a block starting at global row 40, x the whole vector
    # (the all-gather's window), and against a window with a 17-row halo
    sub = spmv_banded.banded_matvec_ext_plain(
        bands[:, 40:140].contiguous(), x, offsets, x_base=40, row0=0, rows=50)
    np.testing.assert_array_equal(sub.numpy(), square[..., 40:90].numpy())
    win = x[..., 40 - 17:140 + 17]
    rows = spmv_banded.banded_matvec_ext_plain(
        bands[:, 40:140].contiguous(), win, offsets, x_base=17, row0=83, rows=17)
    np.testing.assert_array_equal(rows.numpy(), square[..., 123:140].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("b", [1, 8])
def test_dia_shard_kernel_matches_plain_on_the_card(b, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(b)
    n, h, offsets = 4096, 64, (-64, -1, 0, 1, 64)
    bands = torch.randn(5, n, generator=gen, device=cuda_device, dtype=dtype)
    X = torch.randn((b, n + 2 * h) if b > 1 else n + 2 * h, generator=gen,
                    device=cuda_device, dtype=dtype)
    wrap = spmv_banded.banded_matmat_ext if b > 1 else spmv_banded.banded_matvec_ext
    for row0, rows in ((0, n), (0, h), (n - h, h)):
        got = wrap(bands, X, offsets, x_base=h, row0=row0, rows=rows)
        want = spmv_banded.banded_matvec_ext_plain(bands.cpu(), X.cpu(), offsets,
                                                   x_base=h, row0=row0, rows=rows)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_refusals():
    mesh = make_mesh(device="cpu")
    with pytest.raises(TypeError, match="no halo path"):
        halo_matvec_closure(as_operator(np.eye(4), device="cpu"), mesh)
    from arnoldi_tpu_torch.parallel import Mesh

    two = Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="exceeds the shard"):
        halo_matvec_closure(as_operator(sp.diags([1.0, 1.0], [0, 60],
                                                 shape=(100, 100)).tocsr(),
                                        format="ell", device="cpu"), two)
    with pytest.raises(ValueError, match="x_base"):
        banded_port = halo_matvec_closure(as_operator(laplace(64), device="cpu"),
                                          mesh)
        import dataclasses

        from arnoldi_tpu_torch.parallel import banded_matvec_halo as port_halo
        port_halo(dataclasses.replace(banded_port.local, x_base=0),
                  torch.zeros(64, dtype=torch.float64), mesh)


def test_refined_partial_eigh_over_the_halo_on_four_ranks(tmp_path):
    from torch_dist_worker import separated_symmetric

    ranks = torch_dist.spawn("eigh_halo", 4, tmp_path)
    A = separated_symmetric()
    want = np.linalg.eigvalsh(A.toarray())[::-1][:3]
    assert len({int(r["matvecs"]) for r in ranks}) == 1
    vals, vecs = ranks[0]["values"], ranks[0]["vectors"]
    assert vecs.dtype == np.float64 and vecs.shape == (1024, 3)
    np.testing.assert_allclose(np.sort(vals)[::-1], want, rtol=1e-7, atol=1e-9)
    assert np.linalg.norm(A @ vecs - vecs * vals, axis=0).max() < 1e-7
