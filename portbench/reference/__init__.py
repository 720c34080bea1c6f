"""The plain reference that decides ``correct``.

NumPy and SciPy only: it imports neither the program (``arnoldi_tpu_torch``)
nor the JAX package.  It builds the operator again from the configuration
and judges the eigenpairs a solve returned (:mod:`.judge`).  A grid
Laplacian is a stencil on the grid (:mod:`.stencil`) whose exact spectrum
and eigenvectors are known in closed form; any other matrix is the frozen
generator's CSR matrix, judged on its stored spectrum (:mod:`.sparse`,
written by ``spectrum.py``).  :mod:`.control` computes the same answers in
float32, the control that the limits must reject, and plants the faults a
run can have.
"""
