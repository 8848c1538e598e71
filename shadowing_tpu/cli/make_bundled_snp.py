"""One-off generator for the bundled synthetic S&P stand-in series.

Run once (``python -m shadowing_tpu.cli.make_bundled_snp``) to produce
``shadowing_tpu/data/_bundled/snp_daily.npz``. Deterministic (fixed seed).

The dynamics are the discrete path-dependent-volatility recursion of
Guyon & Lekeufack (2023) with two exponential factors on returns and on
squared returns and Student-t innovations — the same model family the
library itself implements in ``shadowing_tpu.models.pdv`` — plus a small
upward drift so long-horizon prices grow like an equity index. See
``shadowing_tpu/data/snp.py`` for why a synthetic stand-in is bundled.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

SEED = 20240101
START, END = "1990-01-02", "2024-12-20"
# Guyon–Lekeufack-style parameters (annualised): two-timescale exponential
# kernels on past returns (R1) and past squared returns (R2).
LAMS1 = (55.0, 10.0)
LAMS2 = (20.0, 3.0)
THETAS = (0.25, 0.5)
BETAS = (0.04, -0.12, 0.75)
NU = 4.5            # Student-t degrees of freedom
DRIFT = 0.07 / 252  # daily drift
X_INIT = 330.0      # price level at the first date (S&P-like for 1990)


def simulate(n_steps: int, rng: np.random.Generator) -> np.ndarray:
    lams1, lams2 = np.array(LAMS1), np.array(LAMS2)
    th1, th2 = THETAS
    b0, b1, b2 = BETAS
    dt = 1.0 / 252.0

    shocks = rng.standard_t(NU, size=n_steps)
    shocks = (shocks - shocks.mean()) / shocks.std() * np.sqrt(dt)

    r1 = np.zeros(2)
    r2 = np.full(2, 0.03)  # start near long-run variance
    dlnx = np.empty(n_steps)
    for t in range(n_steps):
        f1 = (1 - th1) * r1[0] + th1 * r1[1]
        f2 = (1 - th2) * r2[0] + th2 * r2[1]
        sigma = np.clip(b0 + b1 * f1 + b2 * np.sqrt(f2), 0.0, 1.5)
        ret = sigma * shocks[t]
        dlnx[t] = DRIFT + np.log1p(np.maximum(ret, -0.999999))
        r1 = np.exp(-lams1 * dt) * r1 + lams1 * ret
        r2 = np.exp(-lams2 * dt) * r2 + lams2 * ret**2
    return dlnx


def main() -> Path:
    import pandas as pd  # business-day calendar only: optional dependency

    dts = pd.bdate_range(START, END)
    # drop New-Year / mid-year holidays approximately: keep plain bdays
    rng = np.random.default_rng(SEED)
    dlnx = simulate(len(dts), rng)
    out = Path(__file__).parents[1] / "data" / "_bundled" / "snp_daily.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    days = dts.values.astype("datetime64[D]").astype(np.int64)
    np.savez_compressed(out, dlnx=dlnx, days=days, x_init=X_INIT)
    ann_vol = dlnx.std() * np.sqrt(252)
    print(f"wrote {out}: T={len(dlnx)}, ann.vol={ann_vol:.3f}, "
          f"min={dlnx.min():.3f}, max={dlnx.max():.3f}")
    return out


if __name__ == "__main__":
    main()
