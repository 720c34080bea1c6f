"""The plain reference that decides ``correct``.

NumPy only: it imports neither the program (``arnoldi_tpu_torch``) nor the
JAX package.  It builds the operator again from the configuration (a
stencil on the grid, :mod:`.stencil`), knows its exact spectrum and
eigenvectors in closed form, and judges the eigenpairs a solve returned
(:mod:`.judge`).  :mod:`.control` computes the same answers in float32, the
control that the limits must reject, and plants the faults a run can have.
"""
