"""``arnoldi_tpu_torch.eigsh``: eigenvalues and eigenvectors; the outer
solve's ``History`` and the inner solves' counts come from the program's
``accounting()`` block, since ``eigsh`` returns neither."""

KIND = "eigh"


def solve(op, args, generator):
    import arnoldi_tpu_torch as port
    from arnoldi_tpu_torch.solvers.spectral_transform import accounting

    with accounting() as seen:
        vals, V = port.eigsh(op, generator=generator, **args)
    hist = seen["hist"][-1] if seen["hist"] else None
    return ({"values": vals, "vectors": V},
            {"matvecs": None if hist is None else hist.total_matvecs,
             "phases": {} if hist is None else hist.phases,
             "inner_matvecs": sum(s.inner_matvecs for s in seen["stats"]),
             "inner_solves": sum(s.solves for s in seen["stats"])})
