"""Ingest a real daily price CSV into the bundled-dataset format.

The build environment has no network access, so the package ships a
synthetic S&P stand-in (see ``shadowing_tpu/data/snp.py``). A user with the
real series (any ``date,close`` CSV — e.g. an S&P 500 daily export) turns
it into the exact workflow of the reference
(``/root/reference/scripts/snp_generation.py:32``: ``SPDaily(start=...,
end=...)`` feeding ``generate``) in one command:

    python -m shadowing_tpu.cli.ingest_prices prices.csv snp_daily.npz
    python -m shadowing_tpu.cli.snp_generation --data snp_daily.npz ...

or point the class at it directly: ``SPDaily(path="snp_daily.npz")``.

Output schema (``data/snp.py``): ``{'dlnx': (T,) float64 log-returns,
'days': (T,) int64 days-since-epoch of each RETURN date (the first price
date anchors ``x_init`` and is dropped), 'x_init': float first price}``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def ingest_csv(
    csv_path: Path | str,
    out_path: Path | str,
    date_col: str = "date",
    close_col: str = "close",
    dayfirst: bool = False,
) -> Path:
    """Convert a ``date,close`` CSV into the ``snp_daily.npz`` schema.

    Rows are sorted by date; duplicate dates and non-positive or missing
    closes are rejected (a silent drop would shift every return).
    """
    import pandas as pd  # CSV parsing only: an optional dependency

    df = pd.read_csv(csv_path)
    cols = {c.lower().strip(): c for c in df.columns}
    try:
        date_c, close_c = cols[date_col.lower()], cols[close_col.lower()]
    except KeyError as e:
        raise ValueError(
            f"column {e.args[0]!r} not in CSV (has: {list(df.columns)})"
        ) from None
    dts = pd.to_datetime(df[date_c], dayfirst=dayfirst)
    close = pd.to_numeric(df[close_c], errors="coerce")
    if close.isna().any():
        bad = df[date_c][close.isna()].iloc[0]
        raise ValueError(f"non-numeric/missing close (first at {bad!r})")
    order = np.argsort(dts.values, kind="stable")
    dts = pd.DatetimeIndex(dts.values[order])
    x = close.to_numpy(np.float64)[order]
    if dts.duplicated().any():
        raise ValueError(
            f"duplicate dates (first: {dts[dts.duplicated()][0].date()})"
        )
    if (x <= 0).any():
        raise ValueError("non-positive close prices cannot be log-priced")
    if len(x) < 2:
        raise ValueError("need at least two prices to form a return")

    dlnx = np.diff(np.log(x))
    days = dts[1:].values.astype("datetime64[D]").astype(np.int64)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, dlnx=dlnx, days=days, x_init=float(x[0]))
    return out_path


def get_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("csv", type=Path, help="input CSV with date,close columns")
    p.add_argument("out", type=Path, help="output .npz (snp_daily schema)")
    p.add_argument("--date-col", default="date")
    p.add_argument("--close-col", default="close")
    p.add_argument("--dayfirst", action="store_true",
                   help="parse dates day-first (e.g. 31-12-2014)")
    return p.parse_args()


def main():
    args = get_args()
    out = ingest_csv(args.csv, args.out, date_col=args.date_col,
                     close_col=args.close_col, dayfirst=args.dayfirst)
    d = np.load(out)
    first = np.datetime64(int(d["days"][0]), "D")
    last = np.datetime64(int(d["days"][-1]), "D")
    print(f"wrote {out}: {len(d['dlnx'])} daily returns, "
          f"{first} .. {last}, x_init={float(d['x_init']):g}")


if __name__ == "__main__":
    main()
