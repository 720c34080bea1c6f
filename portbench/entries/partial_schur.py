"""``arnoldi_tpu_torch.partial_schur``: a partial Schur form ``(Q, T)``."""

KIND = "schur"


def solve(op, args, generator):
    import arnoldi_tpu_torch as port

    Q, T, hist = port.partial_schur(op, generator=generator, **args)
    return {"Q": Q, "T": T}, {"matvecs": hist.total_matvecs, "phases": hist.phases}
