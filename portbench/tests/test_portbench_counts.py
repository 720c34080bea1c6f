"""The byte counts against hand counts at tiny shapes."""

from portbench.counts import cgs2_bytes, cheby_filter_bytes, spmv_bytes
from portbench.peaks import peak


def test_cgs2_bytes():
    # n = 10, j = 3 rows, float64: the rows read three times (90 entries),
    # w read once (10) and the result written once (10): 110 entries.
    assert cgs2_bytes(10, 3, 8) == 110 * 8
    assert cgs2_bytes(10, 0, 4) == 20 * 4


def test_spmv_bytes():
    # 7 stored values, 4 rows, 2 columns: 7 + 8 (x) + 8 (y) entries
    assert spmv_bytes(7, 4, 2, 8) == 23 * 8


def test_cheby_filter_bytes():
    # nnz 7, n = 4, s = 2 (one block = 8 entries), degree 3:
    # step 1: A + T0 + T1 + Y write = 7 + 3 * 8
    # steps 2, 3: A + T_j + T_{j-1} + T_{j+1} + Y read and write = 7 + 5 * 8
    assert cheby_filter_bytes(7, 4, 2, 3, 8) == (7 + 24 + 2 * (7 + 40)) * 8
    assert cheby_filter_bytes(7, 4, 2, 1, 8) == (7 + 24) * 8
    assert cheby_filter_bytes(7, 4, 2, 0, 8) == 16 * 8


def test_peaks_by_device_name():
    assert peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert peak("NVIDIA H100 PCIe") is None
    assert peak("NVIDIA A100-SXM4-80GB") is None
