"""Plot a stress-test CSV (reference ``scripts/plot-stress-test.py``):
a 4-metric x which-mode grid of elapsed, elapsed ratio against ARPACK,
matvecs and restarts.  matplotlib and pandas are imported when it runs.

Usage::

    python -m arnoldi_tpu_torch.harness.plot_stress stress-test.csv -o stress.png
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv")
    ap.add_argument("-o", "--output", default="stress-test.png")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.read_csv(args.csv)
    df = df[df["elapsed"] >= 0]  # drop failed configs
    df["config"] = df["nev"].astype(str) + "/" + df["ncv"].astype(str)

    whichs = sorted(df["which"].unique())
    metrics = ["elapsed", "elapsed_ratio", "matvecs", "restarts"]

    ratios = []
    for _, row in df.iterrows():
        base = df[(df["method"] == "arpack") & (df["which"] == row["which"])
                  & (df["config"] == row["config"])]["elapsed"]
        ratios.append(row["elapsed"] / base.iloc[0] if len(base) else float("nan"))
    df["elapsed_ratio"] = ratios

    fig, axes = plt.subplots(
        len(metrics), len(whichs),
        figsize=(6 * len(whichs), 3.2 * len(metrics)), squeeze=False,
    )
    for j, which in enumerate(whichs):
        sub = df[df["which"] == which]
        for i, metric in enumerate(metrics):
            ax = axes[i][j]
            for method, g in sub.groupby("method"):
                ax.plot(g["config"], g[metric], marker="o", label=method)
            ax.set_title(f"{metric} ({which})")
            ax.set_xlabel("nev/ncv")
            if metric in ("elapsed", "matvecs", "restarts"):
                ax.set_yscale("log")
            ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    plt.close(fig)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
