"""Path distances in embedding space.

Rebuilds the reference's ``PathDistance`` / ``RelativeMSE``
(``/root/reference/shadowing/path_shadowing/path_distance.py:8-65``) with one
addition: distances that decompose over the inner product expose a
*quadratic expansion* so the engine can score every dataset window with one
matrix contraction plus a cached, context-independent window-norm array —
instead of materialising a ``(B, R, T', d)`` broadcast difference:

``‖x - y‖² = ‖x‖² - 2⟨x, y⟩ + ‖y‖²``

Selection only needs a per-context *monotone* score (``‖y‖² - 2⟨x, y⟩``);
exact distances are recomputed directly on the k winners afterwards, so
reported values carry no expansion round-off.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from shadowing_tpu.array_types import Array, as_jax_f32
from shadowing_tpu.ops.topk import merge_min


class PathDistance:
    """Base distance. Subclasses implement ``forward`` (direct evaluation)
    and may implement the quadratic expansion hooks."""

    #: True if ``score`` / ``finalize`` implement the quadratic expansion
    supports_expansion: bool = False
    #: True if the selection score is exactly ``y_norm2 - 2 * cross`` (the
    #: form hard-wired into the factored pass-1, ``ops/factored.py``)
    factored_score_form: bool = False

    def __call__(self, x: Array, y: Array) -> jax.Array:
        return self.forward(x, y)

    def forward(self, x: Array, y: Array) -> jax.Array:
        """Direct distance over the trailing embedding axis (broadcasting)."""
        raise NotImplementedError

    def forward_host(self, x, y):
        """``forward`` in host numpy at the inputs' dtype — float64 inputs
        stay float64 (JAX would silently downcast without x64), used by the
        engine's ``exact_dtype="float64"`` winner rescore."""
        raise NotImplementedError

    # --- quadratic expansion hooks -------------------------------------
    def score(self, x_norm2: jax.Array, cross: jax.Array, y_norm2: jax.Array
              ) -> jax.Array:
        """Monotone-in-distance selection score (per fixed context)."""
        raise NotImplementedError

    def finalize(self, x_norm2: jax.Array, score: jax.Array) -> jax.Array:
        """Distance value from a selection score (same monotone transform)."""
        raise NotImplementedError

    # --- standalone streaming top-k (API parity with the reference) ----
    def forward_topk(
        self,
        x: Array,
        y: Array,
        k: int,
        n_splits: int = 1,
    ) -> Tuple[jax.Array, jax.Array]:
        """k smallest distances between each ``x`` row and all ``y`` entries.

        :param x: ``(B1, ..., d)`` contexts (broadcast dims collapse to B1)
        :param y: ``(B2, s1, ..., d)`` candidates
        :param n_splits: stream over chunks of ``y``'s first axis (memory knob)
        :return: ``(B1, k)`` distances and ``(B1, k, y.ndim - 1)`` indices

        Chunk-size invariance is exact (the reference's ``testing.ipynb``
        cell-1 property): per-candidate scores do not depend on chunking and
        merges are exact k-selections.
        """
        x = as_jax_f32(x)
        y = as_jax_f32(y)
        B1 = x.shape[0]
        B2 = y.shape[0]
        inner_shape = y.shape[1:-1]
        inner = 1
        for s in inner_shape:
            inner *= s

        chunk = -(-B2 // n_splits)
        dists = jnp.full((B1, k), jnp.inf, jnp.float32)
        idces = jnp.full((B1, k), jnp.iinfo(jnp.int32).max, jnp.int32)

        x_u = x.reshape((B1,) + (1,) * (y.ndim - 1) + (x.shape[-1],))
        for start in range(0, B2, chunk):
            y_c = y[start : start + chunk]
            d_c = self.forward(x_u, y_c[None]).reshape(B1, -1)
            n_c = d_c.shape[1]
            kk = min(k, n_c)
            neg, flat = jax.lax.top_k(-d_c, kk)
            flat = flat + start * inner
            if kk < k:
                pad_v = jnp.full((B1, k - kk), jnp.inf, jnp.float32)
                pad_i = jnp.full((B1, k - kk), jnp.iinfo(jnp.int32).max, jnp.int32)
                neg = jnp.concatenate([neg, -pad_v], axis=1)
                flat = jnp.concatenate([flat, pad_i], axis=1)
            dists, idces = merge_min(dists, idces, -neg, flat.astype(jnp.int32), k)

        # unravel flat indices to (B2, s1, ...) coordinates
        coords = []
        rem = idces
        for dim_size in (B2,) + inner_shape:
            stride = 1
            for s in ((B2,) + inner_shape)[len(coords) + 1 :]:
                stride *= s
            coords.append((rem // stride) % dim_size)
        return dists, jnp.stack(coords, axis=-1).astype(jnp.int32)


class RelativeMSE(PathDistance):
    """``‖x - y‖ / ‖x‖`` over the embedding axis (reference
    ``path_distance.py:62-65``)."""

    supports_expansion = True
    factored_score_form = True

    def forward(self, x: Array, y: Array) -> jax.Array:
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        diff = jnp.linalg.norm(x - y, axis=-1)
        return diff / jnp.linalg.norm(x, axis=-1)

    def forward_host(self, x, y):
        import numpy as np

        diff = np.linalg.norm(np.asarray(x) - np.asarray(y), axis=-1)
        return diff / np.linalg.norm(np.asarray(x), axis=-1)

    def score(self, x_norm2, cross, y_norm2):
        return y_norm2 - 2.0 * cross

    def finalize(self, x_norm2, score):
        return jnp.sqrt(jnp.maximum(x_norm2 + score, 0.0) / x_norm2)


class MSE(PathDistance):
    """Plain Euclidean distance ``‖x - y‖`` (extension beyond the reference)."""

    supports_expansion = True
    factored_score_form = True

    def forward(self, x: Array, y: Array) -> jax.Array:
        return jnp.linalg.norm(jnp.asarray(x) - jnp.asarray(y), axis=-1)

    def forward_host(self, x, y):
        import numpy as np

        return np.linalg.norm(np.asarray(x) - np.asarray(y), axis=-1)

    def score(self, x_norm2, cross, y_norm2):
        return y_norm2 - 2.0 * cross

    def finalize(self, x_norm2, score):
        return jnp.sqrt(jnp.maximum(x_norm2 + score, 0.0))


class CosineDistance(PathDistance):
    """``1 - cos(x, y)`` (extension beyond the reference).

    Tie-order boundary: reported distances are exact (to f32; use
    ``shadow(exact_dtype="float64")`` for tighter values), but among
    candidates whose distances coincide within f32 RESOLUTION the
    returned subset/order may differ across ``n_splits``/mesh/method.
    Two regimes hit this: (a) exact ties (a 1-d embedding degenerates
    cosine to a sign test, tying pervasively); (b) near-parallel windows
    in low-d embeddings, whose distances cluster within ~1e-7 of 0 —
    below the quantum of the ``1 - cos`` subtraction (~6e-8), where no
    f32 ranking is better-defined than another. RelativeMSE/MSE don't
    exhibit this on generic data because their distances spread orders
    of magnitude wider than f32 rounding. Found by randomized testing
    (tests/test_fuzz.py), which forgives index order exactly within
    this resolution window."""

    supports_expansion = True

    def forward(self, x: Array, y: Array) -> jax.Array:
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        num = (x * y).sum(axis=-1)
        den = jnp.linalg.norm(x, axis=-1) * jnp.linalg.norm(y, axis=-1)
        return 1.0 - num / jnp.maximum(den, 1e-30)

    def forward_host(self, x, y):
        import numpy as np

        x = np.asarray(x)
        y = np.asarray(y)
        num = (x * y).sum(axis=-1)
        den = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
        return 1.0 - num / np.maximum(den, 1e-30)

    def score(self, x_norm2, cross, y_norm2):
        return -cross / jnp.sqrt(jnp.maximum(y_norm2, 1e-30))

    def finalize(self, x_norm2, score):
        return 1.0 + score / jnp.sqrt(jnp.maximum(x_norm2, 1e-30))
