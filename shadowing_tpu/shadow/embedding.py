"""Linear path embeddings as convolution kernel banks.

Rebuilds the reference's embeddings
(``/root/reference/shadowing/path_shadowing/path_embedding.py:117-172``)
as convolution kernels: an embedding is a ``(d, C, w)`` kernel bank;
embedding every sliding window of a ``(B, C, T)`` series is one
``lax.conv_general_dilated`` (cross-correlation, VALID). The kernel is plain
numpy (host state); it is shipped to device once by the engine.

Key members:

* :class:`PathEmbedding` — generic kernel bank, ``embed()`` applies it;
* :class:`Identity` — windows embed to themselves (``is_identity`` lets the
  engine skip the d-channel convolution entirely: window norms reduce to one
  sliding sum of ``y**2``);
* :class:`Foveal` — multiscale power-law suffix averages: dim
  ``⌊log(max_context)/log(alpha)⌋`` channels, channel ``i`` averaging the
  last ``⌊alpha**(i+1)⌋`` steps with weight ``n**(-beta)``
  (``path_embedding.py:161-171`` semantics).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.array_types import Array, as_jax_f32, dim_bct
from shadowing_tpu.ops import precision

_DN = ("NCH", "OIH", "NCH")  # conv dimension numbers for (B, C, T) layout


def conv_embed(x: Array, kernel: Array) -> jax.Array:
    """Embed every sliding window of ``x``: ``(B, C, T) -> (B, T', d)``.

    ``out[b, t, i] = sum_{c, tau} x[b, c, t + tau] * kernel[i, c, tau]``
    (cross-correlation, matching torch ``F.conv1d`` semantics used at
    reference ``path_embedding.py:130``).
    """
    x = as_jax_f32(dim_bct(x))
    kernel = as_jax_f32(kernel)
    out = jax.lax.conv_general_dilated(
        x, kernel, window_strides=(1,), padding="VALID", dimension_numbers=_DN,
        preferred_element_type=jnp.float32,
        # full f32: the GPU's default TF32 would skew context embeddings
        # by ~1e-3 relative
        precision=precision.EXACT,
    )  # (B, d, T')
    return jnp.swapaxes(out, 1, 2)


class PathEmbedding:
    """A linear embedding of path windows, represented by a kernel bank."""

    #: engines may skip the embedding convolution when windows embed to
    #: themselves (set by :class:`Identity`)
    is_identity: bool = False

    def __init__(self, kernel: Array):
        kernel = np.asarray(kernel, dtype=np.float32)
        if kernel.ndim != 3:
            raise ValueError(f"kernel must be (d, C, w), got {kernel.shape}")
        self.kernel = kernel

    @property
    def dim(self) -> int:
        return self.kernel.shape[0]

    @property
    def width(self) -> int:
        return self.kernel.shape[-1]

    def __call__(self, x: Array) -> jax.Array:
        return self.embed(x)

    def embed(self, x: Array) -> jax.Array:
        """Embed all windows: ``(B, C, T) -> (B, T', d)``."""
        return conv_embed(x, self.kernel)

    def embed_context(self, x: Array) -> jax.Array:
        """Embed a context whose length equals the kernel width: ``(B, d)``.

        Mirrors ``embedding(x)[:, 0, :]`` at reference
        ``path_shadowing.py:138`` — one d-vector per context.
        """
        x = dim_bct(x)
        if x.shape[-1] != self.width:
            raise ValueError(
                f"context length {x.shape[-1]} != embedding width {self.width}"
            )
        return self.embed(x)[:, 0, :]


class Identity(PathEmbedding):
    """Windows embed to themselves (kernel = identity matrix per channel)."""

    is_identity = True

    def __init__(self, dimension: int):
        super().__init__(np.eye(dimension, dtype=np.float32)[:, None, :])


class Foveal(PathEmbedding):
    """Multiscale foveal embedding: high resolution near the present.

    Channel ``i`` (``i = 0..dim-1``) sums the last ``n_i = int(alpha**(i+1))``
    samples of the window with constant weight ``n_i**(-beta)`` — geometric
    lookbacks, power-law resolution decay away from the fovea (the present).
    """

    def __init__(self, alpha: float, beta: float, max_context: int):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.max_context = int(max_context)
        dim = int(np.floor(np.log(max_context) / np.log(alpha)))

        kernel = np.zeros((dim, 1, max_context), dtype=np.float32)
        lengths = [int(alpha ** n) for n in range(1, dim + 1)]
        for i, n in enumerate(lengths):
            kernel[i, 0, max_context - n :] = float(n) ** (-beta)
        super().__init__(kernel)
        self.lengths = lengths
