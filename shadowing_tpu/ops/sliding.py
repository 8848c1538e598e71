"""Sliding-window correlation as a segment x Toeplitz matmul.

The shadow engine's hot op is a 1-d cross-correlation of long trajectories
with short filters (the combined context filters and the embedding bank),
recast as one dense matmul:

* chop each trajectory into segments of ``L + w - 1`` samples overlapping by
  ``w - 1`` (every segment covers ``L`` window starts);
* multiply by a banded Toeplitz matrix ``G[s, l] = filt[s - l]``
  (zero outside ``0 <= s - l < w``), one column per in-segment offset.

Per output element this does ``(L + w - 1)`` MACs instead of ``w`` (2x
overhead at ``L = 128``, ``w = 126``) in exchange for one large matmul
instead of a single-channel convolution; whether XLA's convolution
(cuDNN) does better on the GPU is queued for measurement (ROADMAP A4).
Cost: the segment gather materialises ``(R, n_blocks, L + w - 1)`` —
callers chunk the R axis to budget.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from shadowing_tpu.ops import precision as _precision

_L = 128  # output block: window starts per segment


def _toeplitz(filt: jax.Array, L: int) -> jax.Array:
    """Banded Toeplitz operator of a filter bank.

    :param filt: ``(F, C, w)`` filters
    :param L: outputs per segment
    :return: ``(C, S, L, F)`` with ``S = L + w - 1`` and
        ``out[c, s, l, f] = filt[f, c, s - l]`` inside the band
    """
    F, C, w = filt.shape
    S = L + w - 1
    ii = jnp.arange(S)[:, None]
    jj = jnp.arange(L)[None, :]
    off = ii - jj                                    # (S, L)
    band = (off >= 0) & (off < w)
    taps = jnp.where(band, off, 0)
    g = filt[:, :, taps]                             # (F, C, S, L)
    g = jnp.where(band[None, None], g, 0.0)
    return jnp.moveaxis(g, 0, -1)                    # (C, S, L, F)


@partial(jax.jit, static_argnames=("n_out", "L", "precision"))
def sliding_dot(
    y: jax.Array,        # (R, C, T)
    filt: jax.Array,     # (F, C, w)
    n_out: int,
    L: int = _L,
    precision=_precision.SELECT,
) -> jax.Array:          # (R, F, n_out)
    """All sliding-window correlations ``out[r, f, t] = sum_{c,tau}
    y[r, c, t + tau] * filt[f, c, tau]`` for ``t < n_out``."""
    R, C, T = y.shape
    F, Cf, w = filt.shape
    if Cf != C:
        raise ValueError(f"channel mismatch: data C={C}, filter C={Cf}")
    if n_out > T - w + 1:
        raise ValueError(f"n_out={n_out} exceeds valid starts {T - w + 1}")

    nblk = -(-n_out // L)
    S = L + w - 1
    t_pad = nblk * L + w - 1
    if t_pad > T:
        y = jnp.pad(y, ((0, 0), (0, 0), (0, t_pad - T)))

    starts = jnp.arange(nblk) * L
    idx = starts[:, None] + jnp.arange(S)[None, :]   # (nblk, S)
    seg = y[:, :, idx]                               # (R, C, nblk, S)
    G = _toeplitz(filt, L)                           # (C, S, L, F)
    out = jnp.einsum("rcns,cslf->rfnl", seg, G, precision=precision,
                     preferred_element_type=jnp.float32)
    return out.reshape(R, F, nblk * L)[:, :, :n_out]
