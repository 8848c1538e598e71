"""Price-series container with lossless representation conversions.

Replacement for the ``scatspectra.PriceData`` surface consumed by
the reference (see call sites at ``/root/reference/shadowing/PDV/PDV.py:8,
202-204,307-309`` and ``tutorial.ipynb`` cells 2/14/16): a series can be
specified as prices ``x``, log-prices ``lnx``, price increments ``dx`` or
log-returns ``dlnx``, and every other representation is derived from it.

Conventions
-----------
* Increments (``dx``/``dlnx``) have one fewer time sample than levels
  (``x``/``lnx``).
* When a series is built from increments, ``x_init`` anchors the first price,
  so ``x[..., 0] == x_init`` and ``x.shape[-1] == dlnx.shape[-1] + 1``
  (the Hedged-MC call sites rely on a known ``S_0``).
* When built from levels with an ``x_init``, the series is rescaled so the
  first price equals ``x_init`` (shape preserved).

All computations are plain numpy (this is host-side bookkeeping, not a hot
path); arrays convert to JAX lazily at the compute boundary.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class PriceData:
    """Holds one batch of price trajectories in all four representations."""

    x: Optional[np.ndarray] = None
    lnx: Optional[np.ndarray] = None
    dx: Optional[np.ndarray] = None
    dlnx: Optional[np.ndarray] = None
    x_init: Optional[float] = None
    dts: Optional[np.ndarray] = field(default=None, repr=False)  # datetimes

    def __post_init__(self):
        given = {
            name: v
            for name, v in (
                ("x", self.x),
                ("lnx", self.lnx),
                ("dx", self.dx),
                ("dlnx", self.dlnx),
            )
            if v is not None
        }
        if len(given) != 1:
            raise ValueError(
                f"exactly one of x/lnx/dx/dlnx must be provided, got {list(given)}"
            )
        name, v = next(iter(given.items()))
        v = np.asarray(v, dtype=np.float64)

        if name == "x":
            x = self._rescale_levels(v, multiplicative=True)
        elif name == "lnx":
            lnx = v
            if self.x_init is not None:
                lnx = lnx - lnx[..., :1] + np.log(self.x_init)
            x = np.exp(lnx)
        elif name == "dlnx":
            x0 = 1.0 if self.x_init is None else float(self.x_init)
            lnx = np.concatenate(
                [np.zeros(v.shape[:-1] + (1,)), np.cumsum(v, axis=-1)], axis=-1
            ) + np.log(x0)
            x = np.exp(lnx)
        else:  # dx
            x0 = 1.0 if self.x_init is None else float(self.x_init)
            x = np.concatenate(
                [np.zeros(v.shape[:-1] + (1,)), np.cumsum(v, axis=-1)], axis=-1
            ) + x0

        if np.any(x <= 0):
            raise ValueError("prices must be strictly positive")

        self.x = x
        self.lnx = np.log(x)
        self.dx = np.diff(x, axis=-1)
        self.dlnx = np.diff(self.lnx, axis=-1)

    def _rescale_levels(self, x: np.ndarray, multiplicative: bool) -> np.ndarray:
        if self.x_init is None:
            return x
        if multiplicative:
            return x / x[..., :1] * float(self.x_init)
        return x - x[..., :1] + float(self.x_init)

    @property
    def T(self) -> int:
        """Number of price samples (levels)."""
        return self.x.shape[-1]

    def __len__(self) -> int:
        return self.x.shape[0] if self.x.ndim > 1 else 1
