"""Context managers: what is matched (in-context) vs predicted (out-context).

Rebuilds the reference's context objects
(``/root/reference/shadowing/path_shadowing/path_embedding.py:13-114``) with
two changes:

* each context exposes a ``conv_plan`` that tells the engine how to apply an
  embedding kernel to long dataset trajectories *without* wasting matmul
  work on padded zeros: for a prediction context the reference convolves with a
  kernel padded by ``horizon`` trailing zeros (``path_embedding.py:48-51``);
  here the engine convolves with the unpadded kernel and simply restricts the
  valid start positions — identical math, ``horizon/w`` fewer FLOPs;
* the reference's ``ImputationContext.slect_out_context`` typo (broken
  out-context selection, ``path_embedding.py:70``) is fixed, not replicated.

All selection helpers are pure and work on numpy or JAX arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from shadowing_tpu.array_types import Array


class ContextManager:
    """Splits a series into the matched part and the predicted part."""

    def select_in_context(self, x: Array) -> Array:
        raise NotImplementedError

    def select_out_context(self, x: Array) -> Array:
        raise NotImplementedError

    def get_out_times(self) -> int:
        """Extra *time* samples to extract beyond the matched window."""
        raise NotImplementedError

    def out_channels(self) -> int:
        """Extra *channels* the dataset has beyond the matched channels."""
        return 0

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        """Return ``(conv_kernel, n_valid_positions)`` for a ``(d, C, w)``
        kernel applied to dataset trajectories of length ``T``.

        ``n_valid_positions`` restricts window starts so the extracted path
        (matched window + out-context) never crosses a trajectory boundary.
        """
        raise NotImplementedError


class PredictionContext(ContextManager):
    """Match the past, predict the next ``horizon`` steps."""

    def __init__(self, horizon: int | None = None):
        self.horizon = horizon

    def select_in_context(self, x: Array) -> Array:
        if not self.horizon:
            return x
        return x[..., : -self.horizon]

    def select_out_context(self, x: Array) -> Array:
        if not self.horizon:
            return x
        return x[..., -self.horizon :]

    def get_out_times(self) -> int:
        return self.horizon or 0

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        w = kernel.shape[-1]
        n_out = T - w - (self.horizon or 0) + 1
        if n_out <= 0:
            raise ValueError(
                f"trajectories of length {T} are too short for window {w} "
                f"+ horizon {self.horizon}"
            )
        return kernel, n_out


class ImputationContext(ContextManager):
    """Match the flanks ``(l, ·, r)`` of a window, predict the middle gap."""

    def __init__(self, portion: Tuple[int, int, int] | None = None):
        self.portion = portion

    def select_in_context(self, x: Array) -> Array:
        if self.portion is None:
            return x
        l, _, r = self.portion
        xp = np
        if not isinstance(x, np.ndarray):
            import jax.numpy as xp  # noqa: F811
        return xp.concatenate([x[..., :l], x[..., -r:]], axis=-1)

    def select_out_context(self, x: Array) -> Array:
        if self.portion is None:
            return x
        l, _, r = self.portion
        return x[..., l:-r]

    def get_out_times(self) -> int:
        return self.portion[1] if self.portion else 0

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        if self.portion is None:
            return kernel, T - kernel.shape[-1] + 1
        l, gap, r = self.portion
        if kernel.shape[-1] != l + r:
            raise ValueError(
                f"kernel width {kernel.shape[-1]} must equal l+r={l + r}"
            )
        gapped = np.concatenate(
            [
                kernel[..., :l],
                np.zeros(kernel.shape[:-1] + (gap,), kernel.dtype),
                kernel[..., l:],
            ],
            axis=-1,
        )
        n_out = T - (l + gap + r) + 1
        if n_out <= 0:
            raise ValueError(f"trajectories of length {T} too short for {self.portion}")
        return gapped, n_out


class CrossChannelContext(ContextManager):
    """Match the first channels, predict the last ``out_context_channels``."""

    def __init__(self, out_context_channels: int):
        self.out_context_channels = out_context_channels

    def select_in_context(self, x: Array) -> Array:
        in_ch = x.shape[-2] - self.out_context_channels
        return x[..., :in_ch, :]

    def select_out_context(self, x: Array) -> Array:
        return x[..., -self.out_context_channels :, :]

    def get_out_times(self) -> int:
        return 0

    def out_channels(self) -> int:
        return self.out_context_channels

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        padded = np.concatenate(
            [
                kernel,
                np.zeros(
                    kernel.shape[:-2]
                    + (self.out_context_channels, kernel.shape[-1]),
                    kernel.dtype,
                ),
            ],
            axis=-2,
        )
        return padded, T - kernel.shape[-1] + 1
