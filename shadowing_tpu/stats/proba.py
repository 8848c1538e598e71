"""Discrete averaging measures over shadowing paths.

Replacement for the ``scatspectra`` ``DiscreteProba`` /
``Uniform`` / ``Softmax`` surface used by the reference
(``/root/reference/shadowing/path_shadowing/path_shadowing.py:9,220-252``,
``plot_utils.py:74-76,131-133``): weighted mean / standard deviation over the
k-closest-paths axis, with ``Softmax`` assigning each path a Gaussian-kernel
weight of its distance, ``w_i ∝ exp(-d_i² / (2 η²))`` with bandwidth ``eta``
("the width of a Gaussian", reference ``plot_utils.py:65``).

Implemented with ``jax.numpy`` so the same code runs inside jitted
prediction pipelines and on host arrays.
"""
from __future__ import annotations

import jax.numpy as jnp

from shadowing_tpu.array_types import Array


class DiscreteProba:
    """A (possibly data-dependent) discrete measure over one array axis."""

    def weights_like(self, x: Array, axis: int) -> Array:
        """Normalised weights broadcastable against ``x``, summing to 1 over ``axis``."""
        raise NotImplementedError

    def avg(self, x: Array, axis: int) -> Array:
        w = self.weights_like(x, axis)
        return (w * x).sum(axis=axis)

    def std(self, x: Array, axis: int) -> Array:
        w = self.weights_like(x, axis)
        m = (w * x).sum(axis=axis, keepdims=True)
        var = (w * (x - m) ** 2).sum(axis=axis)
        return jnp.sqrt(jnp.maximum(var, 0.0))


class Uniform(DiscreteProba):
    """Plain average over the paths axis."""

    def weights_like(self, x: Array, axis: int) -> Array:
        x = jnp.asarray(x)
        return jnp.ones_like(x) / x.shape[axis]


class Softmax(DiscreteProba):
    """Gaussian-kernel weights of path distances with bandwidth ``eta``."""

    def __init__(self, distances: Array, eta: float):
        if eta is None or eta <= 0:
            raise ValueError("Softmax averaging requires a bandwidth eta > 0")
        self.distances = jnp.asarray(distances)
        self.eta = float(eta)

    def weights_like(self, x: Array, axis: int) -> Array:
        x = jnp.asarray(x)
        z = -0.5 * (self.distances / self.eta) ** 2
        # align to x: drop trailing singleton axes beyond x's rank, then
        # append trailing singletons — so (B, k, 1) distances pair with a
        # (B, k) statistic instead of mis-broadcasting over the paths axis
        while z.ndim > x.ndim and z.shape[-1] == 1:
            z = z[..., 0]
        while z.ndim < x.ndim:
            z = z[..., None]
        ax = axis % x.ndim
        if z.shape[ax] != x.shape[ax]:
            raise ValueError(
                f"Softmax distances of shape {self.distances.shape} do not "
                f"align with values of shape {x.shape} over axis {axis}"
            )
        z = z - z.max(axis=axis, keepdims=True)  # stabilised over the paths axis
        w = jnp.exp(z)
        return w / w.sum(axis=axis, keepdims=True)
