"""Regenerate the README illustration figures from the tutorial flow.

Mirrors the role of the reference's ``illustration/`` assets
(``/root/reference/README.md`` embeds figures produced by its notebooks):
a shadow band around an observed history and the conditional
implied-volatility smiles of the matched futures. Deterministic (seeded
MRW dataset, bundled SPDaily context); runs on any backend in ~a minute:

    python -m shadowing_tpu.cli.make_figures [outdir]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from shadowing_tpu import (  # noqa: E402
    Identity,
    MRWGenerator,
    PathShadowing,
    PredictionContext,
    PriceData,
    RelativeMSE,
    SPDaily,
    Softmax,
    compute_smile,
    plot_shadow,
)
from shadowing_tpu.utils import enable_compile_cache  # noqa: E402

W, HORIZON, K, R = 126, 252, 8192, 2048


def main(outdir: Path | str = None) -> list:
    enable_compile_cache()
    outdir = Path(outdir) if outdir else Path(__file__).parents[2] / "illustration"
    outdir.mkdir(parents=True, exist_ok=True)

    # tutorial flow: MRW dataset, observed S&P context (tutorial cells 4-7)
    lnx = MRWGenerator(T=4097, H=0.5, lam=0.2, seed=3).load(R)   # (R, 1, T)
    dataset = np.diff(lnx, axis=-1).astype(np.float32)
    snp = SPDaily()
    ctx = snp.dlnx[0, 0, -W:].astype(np.float32)
    # match the context's scale to the dataset's (the tutorial normalises)
    ctx = ctx * dataset.std() / ctx.std()

    obj = PathShadowing(Identity(W), RelativeMSE(), dataset,
                        PredictionContext(horizon=HORIZON))
    distances, close_paths, _ = obj.shadow(ctx, k=K)

    fig, ax = plt.subplots(figsize=(5, 2.5), dpi=150)
    plot_shadow(ctx, distances[0], close_paths[0], eta=0.09, ax=ax)
    fig.tight_layout()
    shadow_png = outdir / "shadow.png"
    fig.savefig(shadow_png)
    plt.close(fig)

    # conditional smile of the matched futures (tutorial cells 12-16)
    ave = Softmax(distances[0], eta=0.075)
    x = PriceData(dlnx=close_paths[0, :, 0, W:], x_init=100.0).x
    smile = compute_smile(x, Ts=[7, 25, 75], Ms=np.linspace(-2, 2, 9),
                          ave=ave)
    fig, ax = plt.subplots(figsize=(4, 3), dpi=150)
    smile.plot(ax=ax, color="black", rescale=True, legend=True)
    ax.set_title("conditional smile (Hedged MC on shadow paths)", fontsize=9)
    fig.tight_layout()
    smile_png = outdir / "smile.png"
    fig.savefig(smile_png)
    plt.close(fig)

    print(f"wrote {shadow_png} and {smile_png}")
    return [shadow_png, smile_png]


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
