"""Writes the stored spectrum of a configuration that has no closed form.

    python3 portbench/reference/spectrum.py --config <name> --want LR --k 15
        [--sigma <s>] [--root <checkout>]

Builds the configuration's matrix with the benchmark's frozen generator
(float64, or complex128 for a complex one), computes its ``k`` most wanted
eigenvalues with a solver independent of the program (``sparse.pairs``:
``numpy.linalg.eig`` up to 8,000 rows, SciPy's ARPACK at tolerance 1e-13
beyond) and each one's residual ``||A v - lambda v||`` over the spectral
radius, and writes them into ``spectra/<name>.json`` under the want's
label (``LR``, ``nearest:0.01``), with the solver and its arguments.  The
radius (dense: from every eigenvalue; ARPACK: ``LM`` at tolerance 1e-3,
as it only scales the numbers) is computed once, by the file's first
want, and kept with how it was found.  A cell
whose solve returns ``k`` pairs needs ``k + 10`` stored values.  Writes
nothing, and exits 1, when a residual is over 1e-12.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--want", required=True)
    parser.add_argument("--k", type=int, required=True)
    parser.add_argument("--sigma", type=float)
    parser.add_argument("--root", type=Path, default=ROOT)
    args = parser.parse_args(argv)
    if (args.want == "nearest") != (args.sigma is not None):
        parser.error("--sigma goes with --want nearest, and only with it")

    # run as a script, this file's folder heads sys.path; the checkout's
    # root takes its place, so that the benchmark imports as a package
    if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import numpy as np

    from portbench.catalog import Catalog
    from portbench.reference.sparse import (RESIDUAL_MAX, matrix_record, operator,
                                            pairs, residuals, want_label)

    catalog = Catalog(args.root)
    config = catalog.config(args.config)
    want = {"want": args.want}
    if args.want == "nearest":
        want["sigma"] = args.sigma
    A = operator(config)
    path = catalog.bench / "spectra" / f"{args.config}.json"
    spectrum = {"config": args.config, "matrix": matrix_record(config, A)}
    if path.is_file():
        spectrum = json.loads(path.read_text())
        if spectrum["matrix"] != matrix_record(config, A):
            print(f"{path} holds the spectrum of {spectrum['matrix']}", file=sys.stderr)
            return 1
    vals, vecs, how, radius = pairs(A, want, args.k, radius="radius" not in spectrum)
    if radius is not None:
        spectrum["radius"], spectrum["radius_by"] = radius
    res = residuals(A, vals, vecs, spectrum["radius"])
    if res.max() > RESIDUAL_MAX:
        print(f"residuals over the radius up to {res.max():.3e} > {RESIDUAL_MAX}: "
              "nothing written", file=sys.stderr)
        return 1
    vals = np.asarray(vals, dtype=np.complex128)
    spectrum.setdefault("wants", {})[want_label(want)] = {
        "want": want, "k": args.k,
        "values": [[float(v.real), float(v.imag)] for v in vals],
        "residuals": [float(r) for r in res], **how}
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(spectrum, indent=1) + "\n")
    print(f"{path}: {want_label(want)}, {args.k} values, residuals up to "
          f"{res.max():.3e}, radius {spectrum['radius']!r} ({how['solver']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
