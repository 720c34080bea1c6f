"""Every kernel wrapper launches through ``_build``'s one launch path.

A CUDA device is faked at the operand check (``_build.operand_device``,
``_build.on_device``) and the C library at the one resolver
(``_build.resolve``), so no build runs.  Each wrapper of
``kernels.KERNELS`` is called on small float64 CPU operands, and the test
records what reaches the entry point that ``_build.launch`` calls: its
name, the stream handle, the launches counted.  No JAX here.
"""

import pytest
import torch

from arnoldi_tpu_torch.ops import kernels
from arnoldi_tpu_torch.ops.kernels import (_build, cg_banded, cheby_banded,
                                           ortho_fused, spmv_banded, spmv_bsr,
                                           spmv_ell)

F64 = torch.float64
N = 16
STREAM = 7          # the faked raw handle of the current stream
DEGREE = 3          # cheby_banded launches once a degree step


def _cases():
    """name -> (call, C entry point, launches, grid-barrier counter dtype)."""
    bands, offsets = torch.ones(3, N, dtype=F64), (-1, 0, 1)
    x, X = torch.ones(N, dtype=F64), torch.ones(3, N, dtype=F64)
    data, cols = torch.ones(N, 2, dtype=F64), torch.zeros(N, 2, dtype=torch.int32)
    blocks = torch.ones(2, 1, 8, 8, dtype=F64)
    bcols = torch.tensor([[0], [1]], dtype=torch.int32)
    window = spmv_bsr.bsr_window(blocks.numpy(), bcols.numpy(), device="cpu")
    Vt, c = torch.ones(5, N, dtype=F64), torch.ones(5, dtype=F64)
    coeffs = [1.0] * (DEGREE + 1)
    return {
        "spmv_dia": (lambda: spmv_banded.banded_matvec(bands, x, offsets),
                     "arn_spmv_dia", 1, None),
        "spmv_dia_cols": (lambda: spmv_banded.banded_matmat(bands, X, offsets),
                          "arn_spmv_dia", 1, None),
        "spmv_dia_ext": (lambda: spmv_banded.banded_matvec_ext(
            bands, x, offsets, x_base=0), "arn_spmv_dia", 1, None),
        "spmv_dia_ext_cols": (lambda: spmv_banded.banded_matmat_ext(
            bands, X, offsets, x_base=0), "arn_spmv_dia", 1, None),
        "spmv_ell": (lambda: spmv_ell.ell_matvec(data, cols, x),
                     "arn_spmv_ell", 1, None),
        "spmv_ell_cols": (lambda: spmv_ell.ell_matmat(data, cols, X),
                          "arn_spmv_ell", 1, None),
        "spmv_bsr": (lambda: spmv_bsr.bsr_matvec(blocks, bcols, x, N),
                     "arn_spmv_bsr", 1, None),
        "spmv_bsr_cols": (lambda: spmv_bsr.bsr_matmat(blocks, bcols, X, N),
                          "arn_spmv_bsr", 1, None),
        "spmv_bsr_window": (lambda: spmv_bsr.bsr_window_matvec(blocks, window, x, N),
                            "arn_spmv_bsr_window", 1, None),
        "spmv_bsr_window_cols": (lambda: spmv_bsr.bsr_window_matmat(
            blocks, window, X, N), "arn_spmv_bsr_window", 1, None),
        "masked_project": (lambda: ortho_fused.masked_project(Vt, x, 3),
                           "arn_masked_project", 1, torch.int32),
        "project_update_norm": (lambda: ortho_fused.project_update_norm(
            Vt, x, c, 3), "arn_project_update_norm", 1, None),
        "cg_banded": (lambda: cg_banded.cg_banded(bands, offsets, 0.5, x),
                      "arn_cg_dia", 1, torch.int64),
        "cheby_banded": (lambda: cheby_banded.cheby_banded(
            bands, offsets, X, coeffs, -1.0, 3.0), "arn_cheby_dia", DEGREE, None),
    }


@pytest.fixture
def fake_card(monkeypatch):
    """Operands on a faked CUDA device 0, entry points that record their
    arguments; returns ``(calls, tickets)``."""
    calls, tickets = [], []

    def resolve(name, dtype=None):
        if dtype is None:
            return {"arn_cg_dia_partials": 4, "arn_update_cols_per_block": 8}[name]

        def entry(*args):
            calls.append((f"{name}_{_build.SUFFIXES[dtype]}", args))
            return 0
        return entry

    def ticket(device, dtype):
        tickets.append((device, dtype))
        return 0

    monkeypatch.setattr(_build, "resolve", resolve)
    monkeypatch.setattr(_build, "ticket", ticket)
    monkeypatch.setattr(_build, "operand_device", lambda kernel, a, b: 0)
    monkeypatch.setattr(_build, "on_device", lambda t, device: True)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: STREAM, raising=False)
    return calls, tickets


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_every_wrapper_launches_resolves_and_counts_through_build(name, fake_card):
    calls, tickets = fake_card
    call, entry, n_launches, counter = _cases()[name]
    before = kernels.launch_counts()[name]
    before_f64 = kernels.dtype_launch_counts()[name].get("float64", 0)
    gather8 = spmv_bsr.bsr_matmat.gather8_launches
    walks = spmv_bsr.bsr_window_matmat.walk_launches
    call()
    assert [called for called, _ in calls] == [f"{entry}_f64"] * n_launches
    assert all(args[-1] == STREAM for _, args in calls)
    assert kernels.launch_counts()[name] == before + n_launches
    assert kernels.dtype_launch_counts()[name]["float64"] == before_f64 + n_launches
    assert tickets == ([] if counter is None else [(0, counter)])
    assert spmv_bsr.bsr_matmat.gather8_launches == gather8 + (name == "spmv_bsr_cols")
    assert (spmv_bsr.bsr_window_matmat.walk_launches
            == walks + (name == "spmv_bsr_window_cols"))


@pytest.mark.parametrize("bad_c,error,match", [
    (lambda c: c.float(), TypeError, "mixed dtypes torch.float64 and torch.float32"),
    (lambda c: torch.ones(5, dtype=F64, device="meta"), ValueError,
     "operands on cpu and meta"),
    (lambda c: torch.ones(10, dtype=F64)[::2], ValueError,
     "operands must be contiguous"),
])
def test_project_update_norm_checks_its_coefficients(bad_c, error, match):
    """``c``, the third operand, is checked as ``Vt`` and ``w`` are: dtype,
    device and contiguity, before any launch or plain version."""
    Vt, w = torch.ones(5, N, dtype=F64), torch.ones(N, dtype=F64)
    with pytest.raises(error, match=match):
        ortho_fused.project_update_norm(Vt, w, bad_c(torch.ones(5, dtype=F64)), 3)
