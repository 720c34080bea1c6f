"""The port's host C++ libraries (the native dense tier and the host-tier
engine), copies of the JAX package's, bound with ctypes.

Each builds with ``g++`` on first use into :data:`BUILD_DIR`,
``<checkout>/build/arnoldi_tpu_torch/`` (the CUDA kernel library's directory
too, listed in ``.gitignore``), never next to its source.
"""

from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arnoldi_tpu_torch"
