"""Plotting helpers for shadowing results.

Host-side matplotlib ports of the reference's visualisations
(``/root/reference/shadowing/plot_utils.py``): the k closest paths overlaid
on the observed history (``plot_closest``, ref ``:8-47``), the ±1σ shadow
band under the Gaussian-weighted measure (``plot_shadow``, ref ``:50-99``),
the predicted volatility cones (``plot_volatility``, ref ``:102-164`` —
minus its stray debug print), plus a ``plot_dashboard`` diagnostic for
scattering-spectra statistics (the ``scatspectra`` surface imported by the
reference tutorial).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from shadowing_tpu.array_types import as_numpy
from shadowing_tpu.stats.proba import Softmax


def _style_axis(ax, w_past: int, horizon: int, ylim: float):
    from matplotlib.ticker import PercentFormatter

    ax.grid(False)
    ax.set_xlim(-2 - w_past, horizon + 2)
    ax.set_ylim(-ylim, ylim)
    ax.axhline(0.0, color="black", linewidth=0.5)
    ax.axvline(0.0, color="black", linestyle="dashed", linewidth=1.5)
    ax.tick_params(axis="x", labelsize=14)
    ax.tick_params(axis="y", labelsize=10)
    ax.locator_params(axis="x", nbins=6)
    ax.yaxis.set_major_formatter(PercentFormatter(1, decimals=0))


def _title_date(ax, date, color):
    if date is not None:
        day = str(np.datetime64(date, "D")).replace("-", "/")
        ax.set_title(day, fontsize=16, color=color)


def plot_closest(
    dlnx_current: np.ndarray,
    close_paths: np.ndarray,
    num_trajectories: int = 20,
    color_decay: float = 1.2,
    date=None,
    color: str = "blue",
    ax=None,
):
    """Overlay the closest generated paths on the observed history.

    :param dlnx_current: 1-d observed log-returns (the "present")
    :param close_paths: ``(k, 1, T)`` closest paths (past + future)
    """
    import matplotlib.pyplot as plt

    dlnx_current = as_numpy(dlnx_current)
    close_paths = as_numpy(close_paths)
    w_past = dlnx_current.shape[-1]
    horizon = close_paths.shape[-1] - w_past

    if ax is None:
        _, ax = plt.subplots(figsize=(4, 2))
    ax.plot(np.arange(-w_past + 1, 1), dlnx_current, color=color,
            label="present")
    for i in range(min(close_paths.shape[0], num_trajectories)):
        ax.plot(
            np.arange(-w_past + 1, horizon + 1),
            close_paths[i, 0, :],
            alpha=0.5 / color_decay**i,
            color="black",
            label="generated" if i == 0 else None,
        )
    _style_axis(ax, w_past, horizon, float(np.abs(dlnx_current).max()) * 1.1)
    ax.legend(loc="lower right", fontsize=8)
    _title_date(ax, date, color)
    return ax


def plot_shadow(
    dlnx_current: np.ndarray,
    distances: np.ndarray,
    close_paths: np.ndarray,
    eta: float,
    date=None,
    color: str = "blue",
    ax=None,
):
    """±1σ band of the Gaussian(softmax)-weighted closest paths."""
    import matplotlib.pyplot as plt

    dlnx_current = as_numpy(dlnx_current)
    close_paths = as_numpy(close_paths)
    distances = as_numpy(distances)
    w_past = dlnx_current.shape[-1]
    horizon = close_paths.shape[-1] - w_past

    proba = Softmax(distances, eta=eta)
    mean = as_numpy(proba.avg(close_paths, axis=0))[0, :]
    std = as_numpy(proba.std(close_paths, axis=0))[0, :]

    if ax is None:
        _, ax = plt.subplots(figsize=(4, 2))
    ax.plot(np.arange(-w_past + 1, 1), dlnx_current, color=color,
            label="present")
    ax.fill_between(
        np.arange(-w_past + 1, horizon + 1),
        mean - std,
        mean + std,
        color="gray",
        alpha=0.5,
        label="shadow",
    )
    _style_axis(ax, w_past, horizon, float(np.abs(dlnx_current).max()) * 1.1)
    ax.set_xlabel("day", fontsize=14)
    ax.legend(loc="lower right", fontsize=8)
    _title_date(ax, date, color)
    return ax


def plot_volatility(
    dlnx_current: np.ndarray,
    vol_predictions: np.ndarray,
    Ts: Sequence[int],
    distances: Optional[np.ndarray] = None,
    close_paths: Optional[np.ndarray] = None,
    eta: Optional[float] = None,
    date=None,
    color: str = "blue",
    color_vol: str = "black",
    ax=None,
):
    """Predicted volatility cones (±σ/√252 per day) at several maturities,
    optionally with the past shadow band."""
    import matplotlib.pyplot as plt

    dlnx_current = as_numpy(dlnx_current)
    vol_predictions = np.atleast_2d(as_numpy(vol_predictions))
    if vol_predictions.shape[0] != len(Ts):
        vol_predictions = vol_predictions.reshape(len(Ts), -1)
    w_past = dlnx_current.shape[-1]
    horizon = (
        close_paths.shape[-1] - w_past if close_paths is not None else max(Ts)
    )

    if ax is None:
        _, ax = plt.subplots(figsize=(4, 2))
    ax.plot(np.arange(-w_past + 1, 1), dlnx_current, color=color,
            label="present")

    if distances is not None and close_paths is not None:
        proba = Softmax(as_numpy(distances), eta=eta)
        mean = as_numpy(proba.avg(close_paths, axis=0))[0, :]
        std = as_numpy(proba.std(close_paths, axis=0))[0, :]
        ax.fill_between(
            np.arange(-w_past + 1, 1),
            (mean - std)[:w_past],
            (mean + std)[:w_past],
            color="gray",
            alpha=0.5,
            label="shadow",
        )

    std_pred = vol_predictions / np.sqrt(252)
    for i, T in enumerate(Ts):
        band = np.full(int(T) + 1, std_pred[i].ravel()[0])
        ax.fill_between(
            np.arange(int(T) + 1),
            -band,
            band,
            color=color_vol,
            alpha=0.1,
            label="vol prediction" if i == 0 else None,
        )
    _style_axis(ax, w_past, horizon, float(np.abs(dlnx_current).max()) * 1.1)
    ax.legend(loc="lower right", fontsize=8)
    _title_date(ax, date, color)
    return ax


def plot_dashboard(stats, axes=None):
    """Diagnostic dashboard for scattering-spectra statistics.

    :param stats: a :class:`shadowing_tpu.models.scattering.ScatteringStats`
        (or anything with ``.mean_spectrum()``, ``.sparsity()``,
        ``.phase_envelope()``, ``.envelope_correlation()``)
    """
    import matplotlib.pyplot as plt

    if axes is None:
        _, axes = plt.subplots(1, 4, figsize=(14, 2.8))
    js = np.arange(stats.J)

    axes[0].plot(js, np.log2(np.maximum(stats.mean_spectrum(), 1e-30)), "o-")
    axes[0].set_title(r"$\log_2 \Phi_2$ (power)")
    axes[0].set_xlabel("scale $j$")

    axes[1].plot(js, stats.sparsity(), "o-")
    axes[1].set_title(r"$s_j$ (sparsity)")
    axes[1].set_xlabel("scale $j$")

    pe = stats.phase_envelope()
    im = axes[2].imshow(np.abs(pe), origin="lower", cmap="viridis")
    axes[2].set_title(r"$|\Phi_3|$ (phase-env.)")
    plt.colorbar(im, ax=axes[2], fraction=0.046)

    ec = stats.envelope_correlation()
    im = axes[3].imshow(np.abs(ec), origin="lower", cmap="viridis")
    axes[3].set_title(r"$|\Phi_4|$ (env. corr.)")
    plt.colorbar(im, ax=axes[3], fraction=0.046)
    return axes
