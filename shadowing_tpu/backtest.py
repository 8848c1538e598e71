"""Rolling volatility-prediction backtest.

Production workflow from the Path Shadowing Monte Carlo paper
(arXiv:2308.01486, the reference's headline application): on every trading
date, shadow the trailing ``w`` days of the observed series against a
generated dataset, predict the realized variance of the next ``Ts`` days,
and score the predictions against what actually happened — optionally
against the Guyon–Lekeufack autoregressive linear benchmark
(:class:`shadowing_tpu.models.pdv.AutoregressiveLinearPredictor`).

Design: all dates are just the context batch axis — one search
scores every (date x trajectory x window) triple; dates stream in chunks
through ``predict`` to bound memory. ~10k dates x 32k trajectories x 4k
windows is a single-chip workload; shard the dataset axis over a mesh
(:mod:`shadowing_tpu.parallel`) to go bigger.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from shadowing_tpu.array_types import Array, dim_bct
from shadowing_tpu.data.price_data import PriceData
from shadowing_tpu.data.windows import windows
from shadowing_tpu.shadow.engine import PathShadowing
from shadowing_tpu.stats.realized import realized_variance


@dataclass
class BacktestResult:
    """Per-date volatility predictions and their realized outcomes.

    When the backtest was run with a benchmark, ``benchmark_predicted``
    carries the Guyon–Lekeufack autoregressive linear model's predictions on
    the SAME dates/maturities, and every score method accepts
    ``which="benchmark"`` — the paper's PSMC-vs-PDV headline table
    (reference ``README.md:136-138``) is ``result.summary()``.
    """

    Ts: np.ndarray                # maturities (days)
    dates: Optional[np.ndarray]   # (n_dates,) or None
    predicted: np.ndarray         # (n_dates, len(Ts)) annualised variance
    predicted_std: np.ndarray     # (n_dates, len(Ts))
    realized: np.ndarray          # (n_dates, len(Ts)) annualised variance
    benchmark_predicted: Optional[np.ndarray] = None  # (n_dates, len(Ts))

    def _pred(self, which: str) -> np.ndarray:
        if which == "psmc":
            return self.predicted
        if which == "benchmark":
            if self.benchmark_predicted is None:
                raise ValueError(
                    "no benchmark was run — pass benchmark='ar-linear' to "
                    "rolling_backtest"
                )
            return self.benchmark_predicted
        raise ValueError(f"which must be 'psmc' or 'benchmark', got {which!r}")

    def rmse(self, which: str = "psmc") -> np.ndarray:
        """Root mean squared error per maturity, in vol units."""
        p = self._pred(which)
        return np.sqrt(((np.sqrt(p) - np.sqrt(self.realized)) ** 2).mean(0))

    def correlation(self, which: str = "psmc") -> np.ndarray:
        """Pearson correlation of predicted vs realized vol per maturity."""
        pred = self._pred(which)
        out = []
        for i in range(len(self.Ts)):
            p = np.sqrt(pred[:, i])
            r = np.sqrt(self.realized[:, i])
            out.append(np.corrcoef(p, r)[0, 1])
        return np.asarray(out)

    def summary(self) -> str:
        if self.benchmark_predicted is None:
            lines = ["maturity  rmse(vol)  corr"]
            for T, e, c in zip(self.Ts, self.rmse(), self.correlation()):
                lines.append(f"{int(T):8d}  {e:9.4f}  {c:4.2f}")
            return "\n".join(lines)
        lines = ["          ---- PSMC ----   -- AR linear --",
                 "maturity  rmse(vol)  corr  rmse(vol)  corr"]
        rows = zip(self.Ts, self.rmse(), self.correlation(),
                   self.rmse("benchmark"), self.correlation("benchmark"))
        for T, e, c, eb, cb in rows:
            lines.append(f"{int(T):8d}  {e:9.4f}  {c:4.2f}  {eb:9.4f}  {cb:4.2f}")
        return "\n".join(lines)


def rolling_backtest(
    engine: PathShadowing,
    series: PriceData | Array,
    w: int,
    Ts: Sequence[int],
    k: int = 1024,
    stride: int = 1,
    eta: float = 0.1,
    proba_name: str = "softmax",
    n_context_splits: Optional[int] = None,
    n_dataset_splits: Optional[int] = None,
    method: str = "auto",
    dates: Optional[np.ndarray] = None,
    benchmark: Optional[str | dict] = None,
    benchmark_train: Optional[PriceData | Array] = None,
) -> BacktestResult:
    """Backtest PSMC volatility prediction over a historical series.

    :param engine: a :class:`PathShadowing` built on a generated dataset with
        a ``PredictionContext(horizon >= max(Ts))``
    :param series: observed log-returns (``PriceData`` or array)
    :param w: context length in days (must equal the embedding width)
    :param Ts: prediction maturities in days
    :param stride: step between prediction dates
    :param dates: optional datetimes aligned to the series' returns
    :param benchmark: score the Guyon–Lekeufack autoregressive linear model
        (:class:`~shadowing_tpu.models.pdv.AutoregressiveLinearPredictor`,
        reference ``PDV.py:41-164``) on the same dates — the paper's
        comparison table. ``"ar-linear"`` uses the published power-law
        kernels; a dict is forwarded as constructor kwargs (e.g.
        ``{"ktype": "exp"}``). One predictor is least-squares fitted per
        maturity.
    :param benchmark_train: series the benchmark is fitted on. Default: the
        backtest series itself — in-sample, exactly how the paper scores the
        Guyon–Lekeufack fit; pass disjoint history for an out-of-sample fit.
    """
    Ts = np.asarray(list(Ts), dtype=np.int64)
    horizon = engine.context.get_out_times()
    if horizon < Ts.max():
        raise ValueError(
            f"engine horizon {horizon} shorter than max maturity {Ts.max()}"
        )
    dlnx = series.dlnx if isinstance(series, PriceData) else np.asarray(series)
    dlnx = dim_bct(dlnx)[0, 0]  # single-channel series

    # every (context, future) pair fully inside the series
    n_total = dlnx.shape[-1]
    ctx_win = windows(dlnx, w=w + int(Ts.max()), s=stride)
    contexts = ctx_win[:, :w]
    futures = ctx_win[:, w:]
    if dates is not None:
        dates = np.asarray(dates)[w - 1 : n_total - int(Ts.max()) : stride]

    if n_context_splits is None:
        n_context_splits = max(1, contexts.shape[0] // 64)
    to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=Ts, vol=False)
    predicted, predicted_std = engine.predict(
        contexts,
        k=k,
        to_predict=to_predict,
        eta=eta,
        proba_name=proba_name,
        n_dataset_splits=n_dataset_splits,
        n_context_splits=n_context_splits,
        method=method,
    )
    realized = np.asarray(realized_variance(futures, Ts=Ts, vol=False))

    bench = None
    if benchmark is not None:
        bench = _ar_benchmark_predictions(
            benchmark, benchmark_train, dlnx, contexts, Ts, w
        )

    return BacktestResult(
        Ts=Ts,
        dates=dates,
        predicted=np.asarray(predicted),
        predicted_std=np.asarray(predicted_std),
        realized=realized,
        benchmark_predicted=bench,
    )


def _ar_benchmark_predictions(
    benchmark: str | dict,
    train_series: Optional[PriceData | Array],
    dlnx: np.ndarray,
    contexts: np.ndarray,
    Ts: np.ndarray,
    w: int,
) -> np.ndarray:
    """Fit one AR-linear predictor per maturity and predict on every backtest
    context (w trailing log-returns). Returns annualised VARIANCE, matching
    ``BacktestResult.predicted`` units (the predictor itself outputs
    annualised vol, reference ``PDV.py:105-164``)."""
    from shadowing_tpu.models.pdv import AutoregressiveLinearPredictor

    if isinstance(benchmark, str):
        if benchmark != "ar-linear":
            raise ValueError(f"unknown benchmark {benchmark!r}")
        kwargs: dict = {"ktype": "power-law"}
    else:
        kwargs = dict(benchmark)
        kwargs.setdefault("ktype", "power-law")

    if train_series is None:
        train = dlnx
    elif isinstance(train_series, PriceData):
        train = dim_bct(train_series.dlnx)[0, 0]
    else:
        train = dim_bct(np.asarray(train_series))[0, 0]
    # the predictor trains on PRICE windows (its separate() takes logs)
    prices = np.asarray(PriceData(dlnx=train).x)

    s = kwargs.pop("s", 1)
    # the published kernel constants (lam, delta) are per-YEAR rates
    dt = kwargs.pop("dt", 1.0 / 252.0)
    ctx2d = contexts[:, 0] if contexts.ndim == 3 else contexts
    cols = []
    for T in Ts:
        ar = AutoregressiveLinearPredictor(T=int(T), w=w, s=s, dt=dt, **kwargs)
        ar.train(prices)
        cols.append(np.asarray(ar.predict(ctx2d)) ** 2)
    return np.stack(cols, axis=-1)
