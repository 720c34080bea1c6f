#!/usr/bin/env python3
"""Phases 40-44 of ``chip_smoke.py`` alone on one NVIDIA card: the DIA
shard kernel and the ELL/BSR shards against their plain versions, then the
sharded path (a one-rank NCCL mesh here, two gloo ranks sharing the card
in spawned processes, a one-rank elastic resume).

    python3 scripts/parallel_smoke.py

Solve A on one card and ARPACK's five largest-real values of the
scattered matrix (on the host) stand for the references ``chip_smoke.py``
takes from phases 2-3.  Prints the same lines as those phases and, last,
a JSON object of their summary fields.  Exits nonzero without a card or
when a check fails.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    import torch

    import chip_smoke as cs
    from arnoldi_tpu_torch import as_operator, matrices
    from arnoldi_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.environ["ARNOLDI_PHASES"] = "1"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    kernels.build()
    print(f"built in {time.perf_counter() - t0:.2f} s")
    mats = {"laplace": matrices.laplace_2d(724),
            "scattered": cs.scattered_matrix(2**20)}

    def counts():
        cs.sync()
        return kernels.launch_counts()

    print("solve A on one card (the reference of phases 41 and 42)")
    op = as_operator(mats["laplace"], dtype=torch.float64, device="cuda")
    _, T, hist_a, _ = cs.solve("solve A", op, 5, "LM", 80, counts)
    del op
    refs = {"A_T": cs.host_array(T), "A_matvecs": hist_a.total_matvecs,
            "A_restarts": len(hist_a.residual_trace),
            "B": cs.arpack("the scattered 2^20 matrix", mats["scattered"])}
    rec = {name: cs.KernelRecord() for name in kernels.KERNELS}
    print("phase 40")
    cs.phase_shard_kernels(mats, rec, torch.Generator(device="cuda").manual_seed(6))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows, extra, rank_counts = cs.phase_parallel(mats, counts, refs)
    wall = time.perf_counter() - t0
    total = {k: v + rank_counts.get(k, 0) for k, v in counts().items()}
    idle = [k for k in cs.PARALLEL_KERNELS + (extra["C2"]["kernel"],) if total[k] == 0]
    if idle:
        cs.fail(f"kernels of phases 41-44 never launched there: {idle}")
    print(f"launches on the sharded path (phases 41-44): {total}")
    print(f"phases 41-44 wall {wall:.2f} s")
    summary = {label: {"matvecs": h.total_matvecs, "restarts": len(h.residual_trace),
                       "wall_s": w} for label, h, w in rows}
    for label, fields in extra.items():
        summary.setdefault(label, {}).update(fields)
    print(json.dumps({"kernels": {name: vars(rec[name]) | {"dtype": "float64"}
                                  for name in ("spmv_dia_ext", "spmv_dia_ext_cols")},
                      "solves": summary, "launches": total}, default=str))
    print(smi)


if __name__ == "__main__":
    main()
