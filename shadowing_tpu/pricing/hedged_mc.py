"""Hedged Monte Carlo option pricing (Potters, Bouchaud, Sestovic 2001).

Replacement for the ``scatspectra.compute_smile`` surface used by
the reference (``/root/reference/tutorial.ipynb`` cells 12-16,
``testing.ipynb`` cell 7, ``README.md:102-125``): price options on a set of
(shadowing) price paths by backward induction with quadratic hedging, then
express prices as an implied-volatility smile over a rescaled-log-moneyness
grid, optionally under a distance-weighted path measure (``Softmax``).

Algorithm (arXiv:cond-mat/0008147): work on discounted prices
``S~_t = e^{-r t dt} S_t`` and, for each maturity, regress backwards

    C~_t(S_t), phi_t(S_t)  =  argmin E_w[ (C~_{t+1}(S_{t+1}) - C~_t(S_t)
                                           - phi_t(S_t) (S~_{t+1} - S~_t))^2 ]

with both functions expanded on a piecewise-linear hat basis over
quantile-spaced knots of S_t. All strikes of a maturity share the design
matrix, so each backward step is a single (2m x 2m) weighted normal-equation
solve against an (N x n_strikes) target block — one batched product per
step, scanned over time under jit. The products run at full float32
(``precision.EXACT``): at the GPU's default TF32 the Gram of N ~ 10^4 paths
carries ~5e-4 relative error into the solve.

Strike grid: the reference plots smiles against "rescaled log-moneyness"
``M`` on ``linspace(-2, 2, 9)``; strikes are
``K = S0 exp(M sigma_T sqrt(tau))`` with ``sigma_T`` the (weighted) RMS
realized volatility of the paths to maturity ``T`` — inferred from the Path
Shadowing Monte Carlo paper (arXiv:2308.01486), which rescales moneyness by
the typical vol-of-horizon; validated in tests by the Black-Scholes limit
(GBM paths -> flat smile at the true vol for all M).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.array_types import Array
from shadowing_tpu.ops import precision
from shadowing_tpu.pricing.black_scholes import bs_implied_vol
from shadowing_tpu.stats.proba import DiscreteProba
from shadowing_tpu.stats.realized import ANNUALIZATION

_RIDGE = 1e-9


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.matmul(a, b, precision=precision.EXACT)


def _hat_basis(s: jax.Array, knots: jax.Array) -> jax.Array:
    """Piecewise-linear hat functions with constant extrapolation tails
    (evaluation points are clipped to the knot range, so the regression is
    flat beyond the outermost knots).

    :param s: (N,) evaluation points
    :param knots: (m,) increasing knot positions
    :return: (N, m) basis values (rows sum to 1 inside the knot range)
    """
    m = knots.shape[0]
    s = jnp.clip(s, knots[0], knots[-1])  # constant extrapolation
    idx = jnp.clip(jnp.searchsorted(knots, s, side="right") - 1, 0, m - 2)
    left = knots[idx]
    right = knots[idx + 1]
    frac = (s - left) / jnp.maximum(right - left, 1e-12)
    b = jnp.zeros((s.shape[0], m), s.dtype)
    rows = jnp.arange(s.shape[0])
    b = b.at[rows, idx].set(1.0 - frac)
    b = b.at[rows, idx + 1].add(frac)
    return b


@partial(jax.jit, static_argnames=("n_basis", "knots"))
def _hmc_prices(
    paths: jax.Array,     # (N, T+1) raw prices, common S0
    weights: jax.Array,   # (N,) path measure, sums to 1
    strikes: jax.Array,   # (nK,)
    discount: jax.Array,  # e^{-r dt}
    n_basis: int,
    knots: str = "auto",  # "auto" | "empirical" | "moment" (tests force a
    #                       branch to check the two grids price alike)
) -> jax.Array:           # (nK,) option prices at t=0
    N, T1 = paths.shape
    T = T1 - 1
    disc_t = discount ** jnp.arange(T1)          # (T+1,)
    s_tilde = paths * disc_t[None, :]            # discounted prices

    # terminal condition: discounted call payoffs
    payoff = jnp.maximum(paths[:, -1][:, None] - strikes[None, :], 0.0)
    c_next = payoff * disc_t[-1]                 # (N, nK)

    # Per-step regression knots WITHOUT per-step sorts: ``jnp.quantile``
    # inside the scan body is a length-N sort per backward step (it
    # dominated the smile at k ~ 16384 x 75 steps). Replace the empirical quantiles by their
    # lognormal-moment approximation: knots_t = exp(mu_t + sig_t * g) with
    # (mu, sig) the per-step log-price moments (ONE fused pass over the
    # (N, T) block, outside the scan) and ``g`` the standard-normal
    # quantiles of the same grid. The grid's 0/1 endpoints are clipped at
    # 1/(2N) — the expected extreme of N draws — so the outer knots track
    # the sample min/max the way the empirical quantiles did (a fixed wide
    # clip left 12 knots spread over +-4.3 sigma for a 32-path problem,
    # starving the bulk of basis resolution). The knots only define the
    # hat REGRESSION basis — any increasing grid covering the mass is
    # unbiased — and GBM paths (the Black-Scholes parity tests) make the
    # approximation exact in distribution.
    # Small path sets keep the exact empirical quantiles (vectorized over
    # all steps in ONE call, still outside the scan): with N ~ tens of
    # paths the moment grid can leave hat cells EMPTY (singular Gram ->
    # NaN prices), while the occupancy-balanced quantiles cannot. The
    # total sort work at small N is negligible; at scale the moment form
    # is sort-free and distribution-exact for lognormal steps.
    use_empirical = N < 2048 if knots == "auto" else knots == "empirical"
    if use_empirical:
        q = jnp.linspace(0.0, 1.0, n_basis)
        knots_all = jnp.quantile(paths[:, 1:T], q, axis=0).T    # (T-1, m)
    else:
        ln_s = jnp.log(jnp.maximum(paths[:, 1:T], 1e-30))       # (N, T-1)
        mu_t = ln_s.mean(axis=0)
        sig_t = jnp.maximum(ln_s.std(axis=0), 1e-7)
        eps = max(1.0 / (2 * N), 1e-6)
        g = jax.scipy.special.ndtri(
            jnp.clip(jnp.linspace(0.0, 1.0, n_basis), eps, 1.0 - eps)
        )
        knots_all = jnp.exp(mu_t[:, None] + sig_t[:, None] * g[None])
    w_sqrt = jnp.sqrt(weights)[:, None]

    def backward(c_next, xs):
        t, knots = xs
        s_t = paths[:, t]
        ds = s_tilde[:, t + 1] - s_tilde[:, t]
        # enforce strictly increasing knots (ties when sig_t ~ 0 near t=0)
        knots = knots + jnp.arange(n_basis) * 1e-6 * (knots[-1] - knots[0] + 1.0)
        B = _hat_basis(s_t, knots)                            # (N, m)
        A = jnp.concatenate([B, B * ds[:, None]], axis=1)     # (N, 2m)
        Aw = A * w_sqrt
        Yw = c_next * w_sqrt
        gram = _mm(Aw.T, Aw) + _RIDGE * jnp.eye(2 * n_basis)
        rhs = _mm(Aw.T, Yw)                                   # (2m, nK)
        coef = jnp.linalg.solve(gram, rhs)
        c_t = _mm(B, coef[:n_basis])                          # (N, nK)
        return c_t, None

    # scan t = T-1 .. 1 (the t=0 step is degenerate: all S_0 equal)
    ts = jnp.arange(T - 1, 0, -1)
    c1, _ = jax.lax.scan(backward, c_next, (ts, knots_all[ts - 1]))

    # final step: C_0 scalar and scalar hedge phi_0
    ds0 = s_tilde[:, 1] - s_tilde[:, 0]
    A0 = jnp.stack([jnp.ones(N), ds0], axis=1)                # (N, 2)
    A0w = A0 * w_sqrt
    gram0 = _mm(A0w.T, A0w) + _RIDGE * jnp.eye(2)
    rhs0 = _mm(A0w.T, c1 * w_sqrt)
    coef0 = jnp.linalg.solve(gram0, rhs0)                     # (2, nK)
    return coef0[0]


def _smile_core(xj, weights, Ms, s0, r, Ts, n_basis):
    """Strikes / HMC prices / implied vols for every maturity, one graph."""
    dt = 1.0 / ANNUALIZATION
    discount = jnp.exp(jnp.asarray(-r * dt))
    dlnx = jnp.diff(jnp.log(xj), axis=1)
    strikes_all, prices_all, vols_all, sig_all = [], [], [], []
    for T in Ts:  # unrolled into the single jitted graph
        tau = T * dt
        rv = (dlnx[:, :T] ** 2).sum(axis=1) / tau
        sigma_T = jnp.sqrt((weights * rv).sum())
        strikes = s0 * jnp.exp(Ms * sigma_T * jnp.sqrt(tau))
        prices = _hmc_prices(xj[:, : T + 1], weights, strikes, discount,
                             n_basis=n_basis)
        vols = bs_implied_vol(prices, s0, strikes, tau, r)
        strikes_all.append(strikes)
        prices_all.append(prices)
        vols_all.append(vols)
        sig_all.append(sigma_T)
    return (jnp.stack(strikes_all), jnp.stack(prices_all),
            jnp.stack(vols_all), jnp.stack(sig_all))


_smile_all = jax.jit(_smile_core, static_argnames=("Ts", "n_basis"))


@partial(jax.jit, static_argnames=("Ts", "n_basis"))
def _smile_batch(xj, weights, Ms, s0, r, Ts, n_basis):
    """All contexts' smiles in ONE dispatch: vmap over (paths, weights, s0).

    A B-context conditional smile costs one compiled graph + one host fetch
    instead of B of each.
    """
    return jax.vmap(
        lambda x, w, s: _smile_core(x, w, Ms, s, r, Ts, n_basis)
    )(xj, weights, s0)


@dataclass
class Smile:
    """Implied-volatility smile over maturities x rescaled log-moneyness."""

    Ts: np.ndarray                 # maturities, trading days
    Ms: np.ndarray                 # rescaled log-moneyness grid
    strikes: np.ndarray            # (nT, nM)
    prices: np.ndarray             # (nT, nM) option prices
    vols: np.ndarray               # (nT, nM) implied vols, annualised
    sigma_ref: np.ndarray          # (nT,) vol used to rescale moneyness
    spot: float
    r: float = 0.0

    def plot(self, ax=None, color=None, rescale: bool = True,
             legend: bool = False):
        """Plot one implied-vol line per maturity.

        :param rescale: x-axis is the rescaled log-moneyness ``M`` if True,
            raw log-moneyness ``ln(K/S0)`` otherwise
        """
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(4, 3))
        n = len(self.Ts)
        for i, T in enumerate(self.Ts):
            x = self.Ms if rescale else np.log(self.strikes[i] / self.spot)
            alpha = 1.0 - 0.6 * i / max(n - 1, 1)
            # NaN vols (unsolvable MC prices) render as honest line gaps
            ax.plot(x, self.vols[i], marker="o", ms=3, color=color,
                    alpha=alpha, label=rf"$T={int(T)}$")
        ax.set_xlabel(r"$\mathcal{M}$" if rescale else r"$\ln(K/S_0)$")
        ax.set_ylabel(r"implied vol")
        if legend:
            ax.legend(fontsize=8)
        return ax


def compute_smile(
    x: Array,
    Ts: Sequence[int],
    Ms: Sequence[float],
    r: float = 0.0,
    ave: Optional[DiscreteProba] = None,
    n_basis: int = 12,
) -> Smile:
    """Hedged-Monte-Carlo smile on a set of price paths.

    :param x: ``(N, T+1)`` price paths with a common first price ``S0``
        (e.g. ``PriceData(dlnx=futures, x_init=100.).x``)
    :param Ts: option maturities in trading days (``max(Ts) <= T``)
    :param Ms: rescaled log-moneyness grid
    :param r: annualised interest rate
    :param ave: optional path measure (e.g. ``Softmax`` of shadowing
        distances); ``None`` = uniform
    :param n_basis: hat-basis size for the per-step price/hedge regressions
    """
    xj = jnp.asarray(x, dtype=jnp.float32)  # stays on device if already there
    if xj.ndim != 2:
        raise ValueError(f"paths must be (N, T+1), got {xj.shape}")
    first = np.asarray(xj[:, 0])             # tiny host fetch for validation
    s0 = float(first[0])
    if not np.allclose(first, s0, rtol=1e-5):
        raise ValueError("all paths must share the same initial price S0")
    Ts = np.asarray(list(Ts), dtype=np.int64)
    Ms = np.asarray(list(Ms), dtype=np.float64)
    if Ts.max() > xj.shape[1] - 1:
        raise ValueError(
            f"max maturity {Ts.max()} exceeds path length {xj.shape[1] - 1}"
        )

    N = xj.shape[0]
    if ave is None:
        w = jnp.full((N,), 1.0 / N)
    else:
        w = ave.weights_like(jnp.zeros((N,)), axis=0)
        w = w / w.sum()

    # one jitted graph for every maturity: a single device dispatch and a
    # single host fetch
    out = _smile_all(
        xj, w, jnp.asarray(Ms, jnp.float32), float(s0), float(r),
        Ts=tuple(int(t) for t in Ts), n_basis=n_basis,
    )
    # one batched transfer instead of one per array
    strikes, prices, vols, sig = jax.device_get(out)
    return Smile(
        Ts=Ts,
        Ms=Ms,
        strikes=np.asarray(strikes, np.float64),
        prices=np.asarray(prices),
        vols=np.asarray(vols),
        sigma_ref=np.asarray(sig),
        spot=s0,
        r=float(r),
    )


def compute_smile_batch(
    x: Array,
    Ts: Sequence[int],
    Ms: Sequence[float],
    r: float = 0.0,
    weights: Optional[Array] = None,
    n_basis: int = 12,
    validate: bool = True,
) -> list:
    """Hedged-MC smiles for a *batch* of path sets — ONE device dispatch.

    The per-context pricing is a ``vmap`` over (paths, weights, spot), so a
    B-context conditional smile costs the same number of dispatches as one
    (the engine's ``conditional_smile`` routes through here).

    :param x: ``(B, N, T+1)`` price paths; within each batch row all paths
        share the row's initial price
    :param weights: optional ``(B, N)`` path measures (rows need not be
        normalised); ``None`` = uniform
    :param validate: fetch the first prices once to check the common-S0
        contract (engine-internal callers construct it exactly and skip)
    :return: list of B :class:`Smile`
    """
    xj = jnp.asarray(x, dtype=jnp.float32)
    if xj.ndim != 3:
        raise ValueError(f"paths must be (B, N, T+1), got {xj.shape}")
    B, N, _ = xj.shape
    Ts = np.asarray(list(Ts), dtype=np.int64)
    Ms_np = np.asarray(list(Ms), dtype=np.float64)
    if Ts.max() > xj.shape[2] - 1:
        raise ValueError(
            f"max maturity {Ts.max()} exceeds path length {xj.shape[2] - 1}"
        )
    if weights is None:
        w = jnp.full((B, N), 1.0 / N)
    else:
        w = jnp.asarray(weights, jnp.float32)
        if w.shape != (B, N):
            raise ValueError(f"weights must be (B, N)={B, N}, got {w.shape}")
        w = w / w.sum(axis=1, keepdims=True)
    s0 = xj[:, 0, 0]
    if validate:
        first = np.asarray(xj[:, :, 0])          # one host fetch for all B
        if not np.allclose(first, first[:, :1], rtol=1e-5):
            raise ValueError(
                "all paths of a batch row must share that row's initial price"
            )

    out = _smile_batch(
        xj, w, jnp.asarray(Ms_np, jnp.float32), s0, float(r),
        Ts=tuple(int(t) for t in Ts), n_basis=n_basis,
    )
    # one batched transfer instead of five
    strikes, prices, vols, sig, s0_host = jax.device_get((*out, s0))
    strikes = strikes.astype(np.float64)
    return [
        Smile(Ts=Ts, Ms=Ms_np, strikes=strikes[b], prices=prices[b],
              vols=vols[b], sigma_ref=sig[b], spot=float(s0_host[b]),
              r=float(r))
        for b in range(B)
    ]
