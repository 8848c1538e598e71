"""Multifractal Random Walk (MRW) path generator.

Replacement for the ``scatspectra.MRWGenerator`` surface used by
the reference tutorial (``/root/reference/tutorial.ipynb`` cell 4:
``MRWGenerator(T=4097, H=0.5, lam=0.2, cache_path).load(R) -> (R, 1, T)``
log-prices, disk-cached under a parameter-encoded directory name).

Model (Bacry–Muzy–Delour): log-price increments

    dX_k = eps_k * exp(omega_k),

where ``eps`` is (fractional) Gaussian noise with Hurst ``H`` and scale
``sigma``, and ``omega`` is a Gaussian log-correlated field with covariance
``Cov(omega_i, omega_j) = lam^2 * ln(L / (|i-j| + 1))`` for ``|i-j| < L``
and mean ``-Var(omega)`` so that ``E[exp(2*omega)] = 1`` (increment variance
is then ``sigma^2`` at the finest scale).

Sampling is all-FFT (circulant embedding / Davies–Harte), jit-compiled and
batched over realizations — a dense pipeline with no sequential
loops. Generation is deterministic per (seed, parameters).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial


def _circulant_sqrt_spectrum(cov_row: np.ndarray) -> np.ndarray:
    """Eigenvalue sqrt of the circulant embedding of a stationary covariance.

    ``cov_row`` holds c(0), c(1), ..., c(n-1); the embedding has size 2n-2.
    Slightly negative eigenvalues from truncation are clipped to zero (the
    standard Davies–Harte fallback; the resulting bias is O(clip mass)).
    """
    row = np.concatenate([cov_row, cov_row[-2:0:-1]])  # size 2n-2
    eig = np.fft.fft(row).real                          # full spectrum
    eig = np.maximum(eig, 0.0)
    return np.sqrt(eig)


def _fgn_cov(n: int, H: float, sigma: float) -> np.ndarray:
    """Autocovariance of fractional Gaussian noise with Hurst ``H``."""
    k = np.arange(n, dtype=np.float64)
    return (
        0.5
        * sigma**2
        * (np.abs(k + 1) ** (2 * H) - 2 * np.abs(k) ** (2 * H)
           + np.abs(k - 1) ** (2 * H))
    )


def _omega_cov(n: int, lam: float, L: int) -> np.ndarray:
    """Log-correlated covariance ``lam^2 ln(L / (tau + 1))``, cut at L."""
    tau = np.arange(n, dtype=np.float64)
    c = lam**2 * np.log(np.maximum(L / (tau + 1.0), 1.0))
    return c


@partial(jax.jit, static_argnames=("n", "batch"))
def _sample_stationary(key: jax.Array, sqrt_eig: jax.Array, n: int, batch: int
                       ) -> jax.Array:
    """Sample ``batch`` stationary Gaussian series of length ``n`` whose
    covariance embeds in the circulant with eigenvalue sqrt ``sqrt_eig``.

    With ``xi_k`` i.i.d. complex normals (unit-variance real and imaginary
    parts), ``x = Re(ifft(sqrt(eig) * xi)) * sqrt(M)`` has exactly the
    embedded covariance: Cov(x_i, x_j) = (1/M) sum_k eig_k cos(2π(i-j)k/M).
    """
    m = sqrt_eig.shape[0]  # full embedding size M = 2n-2
    kr, ki = jax.random.split(key)
    zr = jax.random.normal(kr, (batch, m))
    zi = jax.random.normal(ki, (batch, m))
    z = (zr + 1j * zi) * sqrt_eig[None, :]
    x = jnp.fft.ifft(z, axis=-1).real * jnp.sqrt(jnp.float32(m))
    return x[:, :n]


@partial(jax.jit, static_argnames=("n", "batch"))
def _mrw_lnx(key: jax.Array, sq_eps: jax.Array, sq_om: jax.Array,
             mean_om: jax.Array, n: int, batch: int) -> jax.Array:
    k1, k2 = jax.random.split(key)
    eps = _sample_stationary(k1, sq_eps, n, batch)
    om = _sample_stationary(k2, sq_om, n, batch) + mean_om
    dx = eps * jnp.exp(om)
    lnx = jnp.concatenate(
        [jnp.zeros((batch, 1)), jnp.cumsum(dx, axis=-1)], axis=-1
    )
    return lnx


class MRWGenerator:
    """Generate (and disk-cache) multifractal random walk log-prices.

    :param T: number of log-price samples per trajectory (T-1 increments)
    :param H: Hurst exponent of the Gaussian component
    :param lam: intermittency ``lambda`` of the log-correlated field
    :param cache_path: directory for the on-disk cache (``None`` = no cache)
    :param L: correlation length of the volatility field (default ``T-1``)
    :param sigma: scale of the finest-resolution increments
    :param seed: PRNG seed (generation is deterministic per seed/params)
    """

    def __init__(
        self,
        T: int,
        H: float = 0.5,
        lam: float = 0.2,
        cache_path: Optional[Path | str] = None,
        L: Optional[int] = None,
        sigma: float = 0.0126,  # ~20% annualized at daily resolution
        seed: int = 0,
    ):
        self.T = int(T)
        self.H = float(H)
        self.lam = float(lam)
        self.L = int(L) if L is not None else self.T - 1
        self.sigma = float(sigma)
        self.seed = int(seed)
        self.cache_path = Path(cache_path) if cache_path is not None else None

        n = self.T - 1
        self._sq_eps = jnp.asarray(
            _circulant_sqrt_spectrum(_fgn_cov(n, self.H, self.sigma)),
            jnp.float32,
        )
        om_cov = _omega_cov(n, self.lam, self.L)
        self._sq_om = jnp.asarray(_circulant_sqrt_spectrum(om_cov), jnp.float32)
        # E[exp(2 omega)] = 1  =>  mean = -Var(omega)
        self._mean_om = jnp.float32(-om_cov[0])

    @property
    def cache_dir(self) -> Optional[Path]:
        if self.cache_path is None:
            return None
        tag = (
            f"MRW_T{self.T}_H{self.H:g}_la{self.lam:g}_L{self.L}"
            f"_sig{self.sigma:g}_seed{self.seed}"
        ).replace(".", "_")
        return self.cache_path / tag

    def generate(self, R: int, batch: int = 2048) -> np.ndarray:
        """Generate ``R`` trajectories of log-prices, shape ``(R, 1, T)``."""
        key = jax.random.PRNGKey(self.seed)
        out = []
        n = self.T - 1
        done = 0
        while done < R:
            b = min(batch, R - done)
            key, sub = jax.random.split(key)
            lnx = _mrw_lnx(sub, self._sq_eps, self._sq_om, self._mean_om,
                           n=n, batch=batch)[:b]
            out.append(np.asarray(lnx, dtype=np.float32))
            done += b
        return np.concatenate(out)[:, None, :]

    def load(self, R: int) -> np.ndarray:
        """Load ``R`` trajectories from cache, generating if needed."""
        cdir = self.cache_dir
        if cdir is None:
            return self.generate(R)
        cdir.mkdir(parents=True, exist_ok=True)
        fpath = cdir / "trajectories.npy"
        if fpath.exists():
            cached = np.load(fpath, mmap_mode="r")
            if cached.shape[0] >= R:
                return np.asarray(cached[:R])
        data = self.generate(R)
        np.save(fpath, data)
        return data
