"""``arnoldi_tpu_torch.eigsh_window``: every eigenpair inside an interval.

The traffic's ``census_seed`` fixes the KPM census' Rademacher probes
(passed in through the program's ``_probes``), so that the slicing, and
with it most of a solve's work, does not move from start to start; the
bounds' start vector and the slices' start blocks still come from each
solve's generator."""

KIND = "eigh"

_PROBES = {}


def _census(n, seed):
    """The census' ``(probes, n)`` block of +-1, drawn once per process."""
    import torch
    from arnoldi_tpu_torch.solvers.filtered import PROBES

    key = (n, seed, PROBES)
    if key not in _PROBES:
        g = torch.Generator().manual_seed(int(seed))
        Z = torch.randint(0, 2, (PROBES, n), generator=g).to(torch.float64)
        _PROBES[key] = Z.mul_(2).sub_(1).numpy()
    return _PROBES[key]


def solve(op, args, generator):
    import arnoldi_tpu_torch as port

    args = dict(args)
    probes = {"census": _census(op.shape[0], args.pop("census_seed"))}
    vals, V, hist = port.eigsh_window(op, generator=generator, _probes=probes, **args)
    return ({"values": vals, "vectors": V},
            {"matvecs": hist.total_matvecs, "phases": hist.phases})
