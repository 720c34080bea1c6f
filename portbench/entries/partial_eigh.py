"""``arnoldi_tpu_torch.partial_eigh``: eigenvalues and eigenvectors."""

KIND = "eigh"


def solve(op, args, generator):
    import arnoldi_tpu_torch as port

    vals, V, hist = port.partial_eigh(op, generator=generator, **args)
    return ({"values": vals, "vectors": V},
            {"matvecs": hist.total_matvecs, "phases": hist.phases})
