"""The port's harness (``arnoldi_tpu_torch.harness``) against the JAX
package's (``tests/test_harness.py``), on the CPU (``--device cpu``).

Matrix specs build the same CSR as JAX's, eigenvalue matching answers as
JAX's on its boundary-tie cases, the drivers agree with ARPACK, the CLIs
run (``compare_arpack``, ``stress_test --quick`` with JAX's CSV header and
grid, ``bench_partial_schur``, ``scaling_bench`` on 1 and 2 gloo ranks,
``plot_stress``), SLEPc and the reference implementation fail as JAX's do
where they are absent, and a CLI asked for the card fails without one.
"""

import csv

import numpy as np
import pytest
import torch

from arnoldi_tpu.harness import stress_test as jax_stress_test
from arnoldi_tpu.harness import suite as jax_suite
from arnoldi_tpu_torch.harness import (EigensolverParameters, arnoldi_tpu_eig,
                                       arpack_eig, find_best_matching,
                                       matrix_from_spec)
from arnoldi_tpu_torch.harness import suite

torch.set_num_threads(1)

SPECS = ["mark:10", "laplace:32", "laplace2d:6", "grcar:20", "clement:20"]


@pytest.mark.parametrize("spec", SPECS)
def test_matrix_specs_match_jax(spec):
    A, B = matrix_from_spec(spec), jax_suite.matrix_from_spec(spec)
    assert A.shape == B.shape and A.dtype == B.dtype
    assert abs(A - B).max() == 0
    with pytest.raises(ValueError, match="Unknown matrix generator"):
        matrix_from_spec("nosuch:5")
    with pytest.raises(ValueError, match="Cannot interpret"):
        matrix_from_spec("matrix.txt")


def test_clement_spectrum():
    n = 10
    vals = np.sort(np.linalg.eigvals(suite.clement_matrix(n).todense()).real)
    want = np.sort(np.concatenate([np.arange(-n + 1, 0, 2), np.arange(1, n, 2)]))
    np.testing.assert_allclose(vals, want, atol=1e-8)


_A5 = np.array([1.0, -1.0, 0.9977, 0.99, 0.98])
TIE_CASES = [   # JAX's test_eigenvalues_match_boundary_ties, case by case
    (_A5, _A5.copy(), "LM"),
    (_A5, np.where(np.arange(5) == 2, -0.9977, _A5), "LM"),
    (_A5, np.where(np.arange(5) == 4, -0.98, _A5), "LM"),
    (_A5, np.where(np.arange(5) == 4, 0.90, _A5), "LM"),
    (np.array([2.0 + 0j, 1.0 + 1j]), np.array([2.0 + 0j, 1.0 - 1j]), "LR"),
    (np.array([2.0 + 0j, 1.0 + 1j]), np.array([2.0 + 0j, 1.0 - 1j]), "LI"),
    (np.array([1.0, 0.9977, 0.9977]), np.array([1.0, 0.9977, -0.9977]), "LM"),
]


@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_eigenvalues_match_as_jax(case):
    a, b, which = TIE_CASES[case]
    assert suite.eigenvalues_match(a, b, which) == \
        jax_suite.eigenvalues_match(a, b, which)
    for got, want in zip(find_best_matching(a, b),
                         jax_suite.find_best_matching(a, b)):
        np.testing.assert_array_equal(got, want)


def test_eigenvalues_match_verdicts():
    verdicts = [suite.eigenvalues_match(a, b, w) for a, b, w in TIE_CASES]
    assert verdicts == [True, False, True, False, True, False, False]


def test_drivers_agree():
    A = matrix_from_spec("mark:10")
    params = EigensolverParameters(nev=3, ncv=12, tol=1e-9, max_restarts=5000,
                                   which="LR")
    r_vals, _, r_stats = arpack_eig(A, params)
    vals, vecs, stats = arnoldi_tpu_eig(A, params, device="cpu")
    d_vals, _, d_stats = suite.deflation_eig(
        A, params, device="cpu", generator=torch.Generator().manual_seed(0))
    for got in (vals, d_vals):
        a, b = find_best_matching(np.asarray(got), r_vals)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    assert stats.matvecs > 0 and stats.elapsed > 0 and stats.dtype == "float64"
    assert stats.matvecs < 3 * r_stats.matvecs
    # the device path (an operator on the CPU), same values
    from arnoldi_tpu_torch import as_operator

    op_vals, _, op_stats = arnoldi_tpu_eig(as_operator(A, device="cpu"), params,
                                           device="cpu")
    a, b = find_best_matching(np.asarray(op_vals), r_vals)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


def test_compare_arpack_cli(capsys):
    from arnoldi_tpu_torch.harness import compare_arpack

    rc = compare_arpack.main(["mark:20", "--nev", "3", "--which", "LR",
                              "--tol", "1e-8", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eigenvalues MATCH" in out
    assert "matvecs than ARPACK" in out


def test_stress_test_cli(tmp_path):
    from arnoldi_tpu_torch.harness import stress_test

    out = tmp_path / "stress.csv"
    rc = stress_test.main(["mark:12", "-o", str(out), "--quick", "--device",
                           "cpu"])
    assert rc == 0
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["method", "dtype", "nev", "ncv", "tol", "max_restarts",
                       "p", "which", "elapsed", "matvecs", "restarts", "match"]
    grid = [(str(p.nev), str(p.ncv), p.which)
            for p in jax_stress_test.QUICK_PARAMETERS for _ in range(2)]
    assert [(r[2], r[3], r[7]) for r in rows[1:]] == grid
    assert [r[0] for r in rows[1:]] == ["krylov-schur", "arpack"] * 4
    assert all(r[11] == "True" for r in rows[1:])
    assert [p.__dict__ for p in stress_test.PARAMETERS] == \
        [p.__dict__ for p in jax_stress_test.PARAMETERS]


def test_bench_partial_schur_cli(capsys):
    from arnoldi_tpu_torch.harness import bench_partial_schur

    rc = bench_partial_schur.main(["mark:15", "--nev", "3", "--tol", "1e-8",
                                   "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ms/matvec" in out and "eigenvalues MATCH" in out


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from arnoldi_tpu_torch.harness import bench_partial_schur

    with pytest.raises(SystemExit, match="--device cpu"):
        bench_partial_schur.main(["mark:15"])


def test_slepc_fails_as_jax():
    from arnoldi_tpu.harness import slepc as jax_slepc
    from arnoldi_tpu_torch.harness import slepc

    errors = []
    for mod in (slepc, jax_slepc):
        with pytest.raises(ImportError, match="petsc4py/slepc4py") as e:
            mod.slepc_eig(matrix_from_spec("mark:10"), EigensolverParameters(nev=2))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    status = slepc.probe()
    assert status["status"] == "blocked" and "network" not in status


def test_reference_method_absent_as_jax(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("ARNOLDI_REF_PATH", str(tmp_path))     # no arnoldi/ there
    assert suite._reference_package() is None
    assert jax_suite._reference_package() is None
    A = matrix_from_spec("mark:10")
    params = EigensolverParameters(nev=2, ncv=10)
    messages = []
    for mod in (suite, jax_suite):
        with pytest.raises(RuntimeError, match="ARNOLDI_REF_PATH") as e:
            mod.arnoldi_py_ref_eig(A, params)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    from arnoldi_tpu_torch.harness import stress_test

    out = tmp_path / "ref.csv"
    stress_test.main(["mark:10", "-o", str(out), "--quick", "--device", "cpu",
                      "--methods", "krylov-schur,arnoldi-py-ref", "--no-warmup"])
    with open(out) as f:
        rows = list(csv.reader(f))[1:]
    assert {r[11] for r in rows if r[0] == "arnoldi-py-ref"} == \
        {"error: RuntimeError"}


def test_scaling_bench_one_and_two_ranks():
    from arnoldi_tpu_torch.harness import scaling_bench

    rows = scaling_bench.run_scaling(n_grid=32, rank_counts=(1, 2), max_dim=12,
                                     cycles=1, dtype="float64", device="cpu")
    assert [r["ranks"] for r in rows] == [1, 2]
    assert rows[1]["backend"] == "gloo" and rows[0]["efficiency"] == 1.0
    assert all(r["kernel"] == "spmv_dia_ext" and r["nnz_per_s"] > 0
               and "not a scaling number" in r["measurement"] for r in rows)
    assert rows[1]["exchange_bytes_per_matvec"] == 2 * 32 * 8


def test_plot_stress_writes_a_png(tmp_path):
    from arnoldi_tpu_torch.harness import plot_stress

    path = tmp_path / "s.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["method", "dtype", "nev", "ncv", "tol", "max_restarts", "p",
                    "which", "elapsed", "matvecs", "restarts", "match"])
        for which in ("LM", "LR"):
            for method, t in (("krylov-schur", 0.01), ("arpack", 0.02)):
                w.writerow([method, "float64", 3, 20, 1e-8, 100, "", which, t,
                            50, 4, True])
    png = tmp_path / "s.png"
    assert plot_stress.main([str(path), "-o", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_settle_with_spectrum_on_hand_made_sets():
    exact = np.array([-3.0, -2.0, -2.0, -1.0, -1.0, 0.5])
    settle = suite.settle_with_spectrum
    assert settle([0.5, -1.0, -1.0], exact, "LR") == "wanted"
    assert settle([0.5, -1.0, -2.0], exact, "LR") == "copies missed"
    assert settle([0.5, -1.0, -3.0], exact, "LR") is None    # -2 skipped
    assert settle([0.5, 0.5, -1.0], exact, "LR") is None     # a ghost copy
    assert settle([0.5, -1.0, -1.5], exact, "LR") is None    # not an eigenvalue
    assert settle([-3.0, -2.0, -2.0], exact, "LM") == "wanted"


def test_stress_lr_row_of_laplace2d_200_as_jax():
    """The grid row LR nev 5 ncv 40 of ``stress_test --quick laplace2d:200``
    does not match: laplace_2d(200) has exact doubles at the cut, and
    krylov-schur returns the 5 rightmost distinct eigenvalues, missing a
    copy of each double (-0.00122137, -0.0024425), where ARPACK from the
    same start vector returns the 5 rightmost with multiplicity.  JAX's
    partial_schur returns the same values from its own start vector."""
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.harness import stress_test

    A = matrix_from_spec("laplace2d:200")
    exact = matrices.laplace_2d_eigen(200)
    params = next(p for p in stress_test.QUICK_PARAMETERS
                  if (p.nev, p.ncv, p.which) == (5, 40, "LR"))
    got = {m: np.sort(np.real(stress_test.run_one(m, A, params, 0, "cpu")[0]))
           for m in ("krylov-schur", "arpack")}
    jax_vals = np.sort(np.real(jax_stress_test.run_one(
        "krylov-schur", jax_suite.matrix_from_spec("laplace2d:200"), params, 0)[0]))
    assert suite.settle_with_spectrum(got["krylov-schur"], exact, "LR") == \
        "copies missed"
    assert suite.settle_with_spectrum(got["arpack"], exact, "LR") == "wanted"
    assert suite.settle_with_spectrum(jax_vals, exact, "LR") == "copies missed"
    np.testing.assert_allclose(got["krylov-schur"], jax_vals, rtol=0, atol=1e-12)
    assert not suite.eigenvalues_match(got["krylov-schur"], got["arpack"], "LR")
