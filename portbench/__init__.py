"""portbench: the benchmark of ``arnoldi_tpu_torch`` on one H100.

One run of one cell: ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` (see ``README.md``).
"""
