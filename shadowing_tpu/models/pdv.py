"""Path-Dependent Volatility (PDV) models, Guyon & Lekeufack (2023).

Rebuild of the reference's PDV module
(``/root/reference/shadowing/PDV/PDV.py``): the continuous Euler-stepped
model (reference ``PDV.py:167-268``), the discrete daily-grid variant
(``PDV.py:271-383``), the autoregressive linear volatility benchmark
(``PDV.py:41-164``), the published parameter defaults (``PDV.py:31-38``) and
the past-to-factors bridge used to run PDV as a conditional generator
(``PDV.py:386-430``).

Design differences from the reference:

* time stepping is ``lax.scan`` (compiled once, no Python loop), batched
  over simulation paths — the reference steps a Python ``for`` loop over
  ``n_steps`` with numpy;
* the linear benchmark solves least squares in closed form
  (``jnp.linalg.lstsq``) instead of sklearn;
* Student-t calibration to a return sample is a JAX maximum-likelihood fit
  (Adam on the t log-density) instead of ``scipy.stats.t.fit`` — scipy is
  used as a cross-check in the tests only;
* ``compute_factor`` accepts 1-d or 2-d histories (the reference's indexing
  assumed a specific shape and the 4-term unpacking only worked with
  ``extra_term=True``).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Literal, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.array_types import Array
from shadowing_tpu.data.price_data import PriceData
from shadowing_tpu.data.windows import windows
from shadowing_tpu.stats.realized import ANNUALIZATION, get_RV

SIGMA_CLIP = (0.0, 1.5)       # reference PDV.py:228,333
RETURN_FLOOR = -0.999999      # reference PDV.py:379


def kernel_pl(taus: Array, delta: float, alpha: float) -> Array:
    """Power-law kernel with lag offset ``delta`` (reference ``PDV.py:11-13``)."""
    return (jnp.asarray(taus) + delta) ** (-alpha)


def kernel_exp(taus: Array, lam: float) -> Array:
    """Exponential kernel (reference ``PDV.py:16-18``)."""
    taus = jnp.asarray(taus)
    return lam * jnp.exp(-lam * taus)


# published Guyon-Lekeufack defaults (reference PDV.py:31-38)
DEFAULT1 = {
    "power-law": {"delta": 0.044, "alpha": 2.82},
    "exp": {"lam0": 64.5, "lam1": 3.83, "theta": 0.67},
}
DEFAULT2 = {
    "power-law": {"delta": 0.025, "alpha": 1.86},
    "exp": {"lam0": 37.6, "lam1": 1.2, "theta": 0.2},
}


# --------------------------------------------------------------------------
# Student-t marginal calibration (replaces scipy.stats.t.fit)
# --------------------------------------------------------------------------

def _t_logpdf(x, df, loc, scale):
    z = (x - loc) / scale
    return (
        jax.scipy.special.gammaln((df + 1) / 2)
        - jax.scipy.special.gammaln(df / 2)
        - 0.5 * jnp.log(df * jnp.pi)
        - jnp.log(scale)
        - (df + 1) / 2 * jnp.log1p(z**2 / df)
    )


@partial(jax.jit, static_argnames=("steps",))
def _fit_t_mle(x: jax.Array, steps: int = 400) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Maximum-likelihood (df, loc, scale) of a Student-t via Adam on
    unconstrained parameters (log-df, loc, log-scale)."""
    mu0 = x.mean()
    s0 = x.std()
    params = jnp.array([jnp.log(4.0), mu0, jnp.log(s0 * 0.8)])

    def nll(p):
        df = jnp.exp(p[0]) + 0.5
        scale = jnp.exp(p[2])
        return -_t_logpdf(x, df, p[1], scale).mean()

    lr = 0.05
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(carry, i):
        p, m, v = carry
        g = jax.grad(nll)(p)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g**2
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        p = p - lr * mh / (jnp.sqrt(vh) + eps)
        return (p, m, v), None

    (p, _, _), _ = jax.lax.scan(
        step, (params, jnp.zeros(3), jnp.zeros(3)), jnp.arange(steps)
    )
    return jnp.exp(p[0]) + 0.5, p[1], jnp.exp(p[2])


def _sample_t(key, df, loc, scale, size) -> jax.Array:
    return loc + scale * jax.random.t(key, df, size)


# --------------------------------------------------------------------------
# shared PDV machinery
# --------------------------------------------------------------------------

class _PDVBase:
    """Shared parameterisation: two-timescale exponential factors R1 (on
    returns) and R2 (on squared returns), convex-mixed, driving

        sigma = beta0 + beta1 * r1 + beta2 * sqrt(r2) [+ beta3 * relu(r1)^2]

    clipped to ``SIGMA_CLIP`` (reference ``PDV.py:221-228``)."""

    def __init__(
        self,
        lams1: List[float],
        lams2: List[float],
        thetas: List[float],
        betas: List[float],
        snp: Optional[PriceData] = None,
        nu: Optional[float] = None,
    ):
        self.lams1 = np.asarray(lams1, dtype=np.float64)
        self.lams2 = np.asarray(lams2, dtype=np.float64)
        self.thetas = np.asarray(thetas, dtype=np.float64)
        self.betas = np.asarray(betas, dtype=np.float64)
        self.snp = snp
        self.nu = nu
        self.fit_params: Optional[tuple] = None
        self._t_params: Optional[tuple] = None  # (df, loc, scale)
        if snp is not None:
            self.calibrate_log_returns(snp)
        if nu is not None:
            # reference order (PDV.py:192-195): an explicit nu overrides the
            # snp-calibrated distribution
            self.define_dlnx_dist(nu)

    def define_dlnx_dist(self, nu: float) -> None:
        self._t_params = (float(nu), 0.0, 1.0)

    def calibrate_log_returns(self, snp: PriceData) -> None:
        """Fit a Student-t to the marginal of the provided log-returns."""
        data = jnp.asarray(np.ravel(snp.dlnx), jnp.float32)
        df, loc, scale = _fit_t_mle(data)
        self.fit_params = (float(df), float(loc), float(scale))
        self._t_params = self.fit_params

    def gen_dw(self, s: float, size: Tuple[int, ...], key: jax.Array
               ) -> jax.Array:
        """Standardised innovations scaled by ``s`` (reference
        ``PDV.py:206-215,311-320``: per-path mean-zero, unit-std)."""
        if self._t_params is not None:
            df, loc, scale = self._t_params
            dw = _sample_t(key, df, loc, scale, size)
        else:
            dw = jax.random.normal(key, size)
        dw = dw - dw.mean(-1, keepdims=True)
        dw = dw / dw.std(-1, keepdims=True)
        return dw * s

    def mixing(self, theta: float, x0: jax.Array, x1: jax.Array) -> jax.Array:
        return (1 - theta) * x0 + theta * x1

    def sigma_of(self, R1: jax.Array, R2: jax.Array) -> jax.Array:
        """Volatility from factor pairs; R1, R2 have trailing dim 2."""
        r1 = self.mixing(self.thetas[0], R1[..., 0], R1[..., 1])
        r2 = self.mixing(self.thetas[1], R2[..., 0], R2[..., 1])
        sig = (
            self.betas[0]
            + self.betas[1] * r1
            + self.betas[2] * jnp.sqrt(jnp.maximum(r2, 0.0))
        )
        if len(self.betas) > 3:
            sig = sig + self.betas[3] * (0.5 * jnp.abs(r1) + 0.5 * r1) ** 2
        return jnp.clip(sig, *SIGMA_CLIP)

    def sigma(self, R1: Array, R2: Array) -> np.ndarray:
        """Numpy-friendly alias: factors with trailing dim 2 — ``(2,)`` for a
        single state, ``(S, 2)`` for a batch."""
        return np.asarray(self.sigma_of(jnp.asarray(R1), jnp.asarray(R2)))


class PDVModel(_PDVBase):
    """Continuous-time PDV model, Euler stepping (reference ``PDV.py:167-268``).

    Factor dynamics: ``dR1 = (sigma dW - R1 dt) lam1``,
    ``dR2 = (sigma^2 - R2) dt lam2``.
    """

    def gen(
        self,
        T: float,
        dt: float,
        S0: float,
        R10: Array,
        R20: Array,
        S: int = 1,
        key: Optional[jax.Array] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Simulate ``S`` paths of (sigma_t, S_t) over ``int(T/dt)`` steps.

        Returns arrays of shape ``(n_steps,)`` when ``S == 1`` (reference
        behavior) else ``(S, n_steps)``.
        """
        n_steps = int(T / dt)
        key = key if key is not None else jax.random.PRNGKey(0)
        dW = self.gen_dw(float(np.sqrt(dt)), (S, n_steps - 1), key)

        lams1 = jnp.asarray(self.lams1)
        lams2 = jnp.asarray(self.lams2)
        R1 = jnp.broadcast_to(jnp.asarray(R10, jnp.float32), (S, 2))
        R2 = jnp.broadcast_to(jnp.asarray(R20, jnp.float32), (S, 2))

        def step(carry, dwt):
            R1, R2, S_prev = carry
            sig = self.sigma_of(R1, R2)
            S_next = S_prev * (1 + sig * dwt)
            dR1 = (sig[:, None] * dwt[:, None] - R1 * dt) * lams1[None]
            dR2 = (sig[:, None] ** 2 - R2) * dt * lams2[None]
            return (R1 + dR1, R2 + dR2, S_next), (sig, S_next)

        sig0 = self.sigma_of(R1, R2)
        s_init = jnp.full((S,), float(S0))
        (_, _, _), (sigs, prices) = jax.lax.scan(
            step, (R1, R2, s_init), dW.T
        )
        sigma = jnp.concatenate([sig0[None], sigs], axis=0).T  # (S, n)
        path = jnp.concatenate([s_init[None], prices], axis=0).T
        sigma_np, path_np = np.asarray(sigma), np.asarray(path)
        if S == 1:
            return sigma_np[0], path_np[0]
        return sigma_np, path_np


class PDVModelDiscrete(_PDVBase):
    """Daily-grid PDV variant (reference ``PDV.py:271-383``).

    Exponential-decay factor updates driven by the *realized* return
    ``r_t = max(sigma_t dW_t, RETURN_FLOOR)``:
    ``R1' = exp(-lam/252) R1 + lam r_t``,
    ``R2' = exp(-lam/252) R2 + lam r_t^2``.
    """

    def gen(
        self,
        T: float,
        dt: float,
        S0: float,
        S: int,
        R10: Array,
        R20: Array,
        key: Optional[jax.Array] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if abs(dt - 1 / ANNUALIZATION) > 1e-6:
            raise ValueError("dt must be one trading day (1/252) in the "
                             "discrete model")
        n_steps = int(T / dt)
        key = key if key is not None else jax.random.PRNGKey(0)
        dW = self.gen_dw(float(np.sqrt(dt)), (S, n_steps), key)

        decay1 = jnp.exp(-jnp.asarray(self.lams1) / ANNUALIZATION)
        decay2 = jnp.exp(-jnp.asarray(self.lams2) / ANNUALIZATION)
        lams1 = jnp.asarray(self.lams1)
        lams2 = jnp.asarray(self.lams2)

        R1 = jnp.broadcast_to(jnp.asarray(R10, jnp.float32), (S, 2))
        R2 = jnp.broadcast_to(jnp.asarray(R20, jnp.float32), (S, 2))

        def step(carry, dwt):
            R1, R2, S_prev = carry
            sig = self.sigma_of(R1, R2)
            rt = jnp.maximum(sig * dwt, RETURN_FLOOR)
            S_next = S_prev * (1 + rt)
            R1n = decay1[None] * R1 + lams1[None] * rt[:, None]
            R2n = decay2[None] * R2 + lams2[None] * rt[:, None] ** 2
            return (R1n, R2n, S_next), (sig, S_next)

        sig0 = self.sigma_of(R1, R2)
        s_init = jnp.full((S,), float(S0))
        # the reference's first column keeps S0 and sigma(R10, R20); shocks
        # dW[:, 0] are drawn but never applied (PDV.py:375 starts at t=1)
        (_, _, _), (sigs, prices) = jax.lax.scan(
            step, (R1, R2, s_init), dW[:, 1:].T
        )
        sigma = jnp.concatenate([sig0[None], sigs], axis=0).T
        path = jnp.concatenate([s_init[None], prices], axis=0).T
        return np.asarray(sigma), np.asarray(path)


# --------------------------------------------------------------------------
# autoregressive linear volatility benchmark
# --------------------------------------------------------------------------

class AutoregressiveLinearPredictor:
    """Linear regression of future realized vol on kernel-weighted past
    returns and squared returns (reference ``PDV.py:41-164``)."""

    def __init__(
        self,
        T: int,
        w: int,
        s: int,
        dt: float,
        ktype: Literal["exp", "power-law"],
        k1_dict: Optional[Dict] = None,
        k2_dict: Optional[Dict] = None,
        extra_term: bool = False,
    ):
        self.T = T
        self.w = w
        self.s = s
        self.dt = dt
        k1_dict = k1_dict if k1_dict is not None else DEFAULT1[ktype]
        k2_dict = k2_dict if k2_dict is not None else DEFAULT2[ktype]
        if ktype == "power-law":
            self.k1 = self.init_pl_kernel(w=w, dt=dt, **k1_dict)
            self.k2 = self.init_pl_kernel(w=w, dt=dt, **k2_dict)
        else:
            self.k1 = self.init_exp_kernel_2_factors(w=w, dt=dt, **k1_dict)
            self.k2 = self.init_exp_kernel_2_factors(w=w, dt=dt, **k2_dict)
        self.extra_term = extra_term
        self.coef_: Optional[np.ndarray] = None

    @staticmethod
    def init_exp_kernel_2_factors(w, dt, lam0, lam1, theta) -> np.ndarray:
        """Convex mix of two exponential kernels, each normalised to unit
        mass per unit time (reference ``PDV.py:74-91``)."""
        taus = np.arange(w)[::-1] * dt
        k0 = np.asarray(kernel_exp(taus, lam=lam0))
        k1 = np.asarray(kernel_exp(taus, lam=lam1))
        k0 = k0 / k0.sum() / dt
        k1 = k1 / k1.sum() / dt
        return (1 - theta) * k0 + theta * k1

    @staticmethod
    def init_pl_kernel(w, dt, delta, alpha) -> np.ndarray:
        taus = np.arange(w)[::-1] * dt
        kern = np.asarray(kernel_pl(taus, delta=delta, alpha=alpha))
        return kern * ANNUALIZATION / kern.sum()

    def separate(self, x: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Training pairs from one price series: every stride-``s`` span of
        ``w + 1 + T`` prices yields a (past, future) pair sharing exactly one
        price sample, so the past log-returns and the future realized vol
        are built from disjoint increments (the contract of reference
        ``PDV.py:105-116``).

        :return: (past sample indices, future sample indices,
            past log-returns ``(n, w)``, future realized vols ``(n,)``)
        """
        assert x.ndim == 1
        span = self.w + 1 + self.T
        prices = windows(x, w=span, s=self.s)            # (n, span)
        sample_idx = windows(np.arange(x.size), w=span, s=self.s)
        past = prices[:, : self.w + 1]                   # shares prices[w]
        future = prices[:, self.w :]
        return (
            sample_idx[:, : self.w],
            sample_idx[:, self.w :],
            np.diff(np.log(past)),
            np.asarray(get_RV(future)),
        )

    @staticmethod
    def embedding(dlnx, k1, k2, extra_term: bool = False) -> np.ndarray:
        """Guyon–Lekeufack feature map of a window of log-returns: constant,
        trend factor ``R1 = <k1, r>``, volatility factor
        ``R2 = sqrt(<k2, r^2>)`` — plus ``relu(R1)^2`` when ``extra_term``
        (the published model's optional convexity term; reference
        ``PDV.py:118-140``)."""
        r = np.atleast_2d(np.asarray(dlnx))
        k1 = np.asarray(k1)
        k2 = np.asarray(k2)
        assert r.shape[-1] == k1.size == k2.size
        R1 = r @ k1
        R2 = np.sqrt((r * r) @ k2)
        cols = [np.ones_like(R1), R1, R2]
        if extra_term:
            cols.append(np.square(np.maximum(R1, 0.0)))
        return np.stack(cols, axis=-1)

    def train(self, x: np.ndarray) -> None:
        """Least-squares fit (no intercept — the feature map carries the
        constant column)."""
        _, _, dlnx, y = self.separate(x)
        X = self.embedding(dlnx, self.k1, self.k2, self.extra_term)
        sol, *_ = jnp.linalg.lstsq(jnp.asarray(X), jnp.asarray(y))
        self.coef_ = np.asarray(sol)

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self.coef_ is None:
            raise RuntimeError("call train() first")
        X = self.embedding(x, self.k1, self.k2, self.extra_term)
        return X @ self.coef_


# --------------------------------------------------------------------------
# PDV as a conditional generator
# --------------------------------------------------------------------------

def compute_factor(
    x_past: np.ndarray,
    pdv_model: _PDVBase,
    w: int,
    dt: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Initial factors (R10, R20) implied by an observed past price path
    (reference ``PDV.py:386-412``, made shape-robust)."""
    x_past = np.asarray(x_past)
    dlnx = np.diff(np.log(x_past), axis=-1)

    taus = np.arange(w)[::-1][1:] * dt
    kerns = []
    for lam in (*pdv_model.lams1, *pdv_model.lams2):
        k = np.asarray(kernel_exp(taus, lam=lam))
        kerns.append(k / k.sum() / dt)
    k10, k11, k20, k21 = kerns

    if dlnx.shape[-1] != taus.size:
        dlnx = dlnx[..., -taus.size :]

    e0 = AutoregressiveLinearPredictor.embedding(dlnx, k10, k20)
    e1 = AutoregressiveLinearPredictor.embedding(dlnx, k11, k21)
    R10 = np.array([e0[0, 1], e1[0, 1]])
    R20 = np.array([e0[0, 2], e1[0, 2]]) ** 2.0
    return R10, R20


def future_pdv_model(
    x_past: np.ndarray,
    pdv_model: _PDVBase,
    w: int,
    S0: float,
    S: int,
    T: float,
    dt: float,
    key: Optional[jax.Array] = None,
) -> np.ndarray:
    """Conditional PDV futures given an observed past (reference
    ``PDV.py:415-430``)."""
    R10, R20 = compute_factor(x_past, pdv_model, w, dt)
    _, x_gen = pdv_model.gen(T=T, dt=dt, S0=S0, S=S, R10=R10, R20=R20, key=key)
    return x_gen
