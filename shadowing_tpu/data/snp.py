"""Bundled daily S&P-like price dataset.

Replacement for the ``scatspectra.SPDaily`` surface used by the
reference (``/root/reference/scripts/snp_generation.py:32``,
``tutorial.ipynb`` cell 5, ``README.md:35-37``): a packaged daily price
series with ``.dlnx`` of shape ``(1, 1, T)`` and ``.dts`` (the return dates
as a ``datetime64[D]`` array), with optional ``start``/``end`` date
filtering in day-first format (e.g. ``'03-01-2000'`` .. ``'31-12-2014'``).

IMPORTANT — data provenance: this build environment has no network access and
the upstream package's bundled S&P 500 csv is unavailable, so the series
shipped here is a *synthetic stand-in*: a seeded path-dependent-volatility
simulation (Guyon–Lekeufack dynamics, Student-t shocks) over NYSE-like
business days 1990–2024, generated once by
``shadowing_tpu/cli/make_bundled_snp.py`` and committed. It reproduces the
qualitative features the library exercises (volatility clustering, leverage,
heavy tails, realistic annualised vol) but is NOT market data. Replace
``shadowing_tpu/data/_bundled/snp_daily.npz`` with a real series for
production use; the file format is ``{'dlnx': (T,) float64,
'days': (T,) int64 days-since-epoch of each return date, 'x_init': float}``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from shadowing_tpu.data.price_data import PriceData

BUNDLE_PATH = Path(__file__).parent / "_bundled" / "snp_daily.npz"


def _parse_dayfirst(s: str) -> np.datetime64:
    """``'DD-MM-YYYY'`` (``-``, ``/`` or ``.`` separated) or ISO
    ``'YYYY-MM-DD'`` -> ``datetime64[D]``."""
    parts = re.split(r"[-/.]", s.strip())
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        raise ValueError(f"unrecognised date {s!r}: expected DD-MM-YYYY")
    if len(parts[0]) == 4:
        y, m, d = parts
    else:
        d, m, y = parts
    return np.datetime64(f"{int(y):04d}-{int(m):02d}-{int(d):02d}", "D")


class SPDaily(PriceData):
    """Daily S&P-like price data bundled with the package.

    :param start: optional first date, day-first string (e.g. ``'03-01-2000'``)
    :param end: optional last date (inclusive), day-first string
    """

    def __init__(self, start: str | None = None, end: str | None = None,
                 path: Path | str | None = None):
        bundle = np.load(Path(path) if path is not None else BUNDLE_PATH)
        dlnx = bundle["dlnx"]
        days = bundle["days"]
        x_init = float(bundle["x_init"])
        dts = days.astype("datetime64[D]")

        mask = np.ones(len(dts), dtype=bool)
        if start is not None:
            mask &= dts >= _parse_dayfirst(start)
        if end is not None:
            mask &= dts <= _parse_dayfirst(end)
        if not mask.any():
            raise ValueError(f"no data in range [{start}, {end}]")

        super().__init__(dlnx=dlnx[None, None, mask], x_init=x_init,
                         dts=dts[mask])
