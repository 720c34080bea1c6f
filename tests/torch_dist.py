"""Spawning the port's gloo worker processes (``torch_dist_worker.py``)
for the sharded tests: one process a rank on the CPU, a free localhost
port each time, one thread a process."""

import os
import socket
import subprocess
import sys

import numpy as np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario, size, out, timeout=120):
    """Run ``scenario`` on ``size`` ranks, writing under ``out``; returns
    each rank's saved arrays (a list of dicts).  A rank that fails or
    outlives ``timeout`` seconds fails the caller with its output."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, scenario, str(rank),
                               str(size), str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for rank in range(size)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {scenario} exited " \
            f"{p.returncode}:\n{log[-4000:]}"
    results = []
    for rank in range(size):
        with np.load(os.path.join(out, f"{scenario}.r{rank}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results
