"""Wavelet scattering-spectra statistics (arXiv:2204.10177).

The statistic vector Phi(x) summarising a time series x through its wavelet
transform W_j x and second-level transforms of the envelopes |W_j x|:

* ``mean``                 <x>
* ``variance``             Var(x)
* ``power``     Phi_2(j) = <|W_j x|^2> / Var(x)                     (J real)
* ``sparsity``  s(j)     = <|W_j x|>^2 / <|W_j x|^2>                (J real)
* ``flatness``  f(j)     = log <|W_j x|^4> / <|W_j x|^2>^2          (J real)
* ``phase-env`` Phi_3(a,b) = <W_b(|W_a x|) conj(W_b x)> / (sig_a sig_b)
                for a < b                              (J(J-1)/2 complex)
* ``env-corr``  Phi_4(a,b,c) = <W_c(|W_a x|) conj(W_c(|W_b x|))>
                / (sig_a sig_b), for a <= b < c        (~J^3/6 complex)

with ``sig_j = sqrt(<|W_j x|^2>)``. Phi_3 captures sign/phase-envelope
alignment (leverage, skewness); Phi_4 captures cross-scale envelope
dependence (volatility clustering, multifractality); the flatness pins the
per-scale tail weight (without it, synthesis matches vol clustering but
under-reproduces extreme-day kurtosis — observed on S&P-like targets).
Gaussian white noise has Phi_3 = Phi_4 = 0, sparsity pi/4 and flatness
log 2 — properties the tests pin down.

Everything is computed by batched FFTs under jit; the flattened vector is
what the synthesis optimiser matches.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.models.scattering.wavelets import FilterBank
from shadowing_tpu.ops import precision


def _index_pairs(J: int) -> Tuple[np.ndarray, np.ndarray]:
    a, b = np.triu_indices(J, k=1)
    return a.astype(np.int32), b.astype(np.int32)


def _index_triples(J: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    trip = [
        (a, b, c)
        for c in range(J)
        for a in range(c)
        for b in range(a, c)
    ]
    arr = np.asarray(trip, dtype=np.int32).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def n_stats(J: int) -> int:
    n_pairs = J * (J - 1) // 2
    n_trip = len(_index_triples(J)[0])
    return 2 + 3 * J + 2 * n_pairs + 2 * n_trip


@lru_cache(maxsize=None)
def _pair_perm(J: int) -> np.ndarray:
    """Permutation from b-grouped phi3 blocks to canonical triu order."""
    mine = [(a, b) for b in range(1, J) for a in range(b)]
    canon = list(zip(*_index_pairs(J)))
    return np.asarray([mine.index(p) for p in canon], np.int32)


@lru_cache(maxsize=None)
def _trip_perm(J: int) -> np.ndarray:
    """Permutation from b-grouped phi4 blocks to canonical triple order."""
    mine = [
        (a, b, c)
        for b in range(J - 1)
        for a in range(b + 1)
        for c in range(b + 1, J)
    ]
    canon = list(zip(*_index_triples(J)))
    return np.asarray([mine.index(t) for t in canon], np.int32)


@partial(jax.jit, static_argnames=("J", "bands"))
def _scattering_stats_flat(
    x: jax.Array,          # (B, T) real series (log-returns)
    psi_hat: jax.Array,    # (J, T)
    J: int,
    bands: tuple | None = None,  # per-scale support bins (FilterBank.band_hi)
) -> jax.Array:            # (B, n_stats) float32
    B, T = x.shape
    half_ = T // 2 + 1
    mean = x.mean(axis=-1)
    xc = x - mean[:, None]
    var = (xc**2).mean(axis=-1)

    # wavelet transforms through XLA's FFT (cuFFT on the GPU; an
    # H100 timed it 1.45x faster than a matmul DFT at the generation shape,
    # PERF.md). Only the non-negative half spectrum of x is needed below.
    xf = jnp.fft.fft(xc, axis=-1)                       # (B, T) complex
    xf_h = xf[..., :half_]
    xr, xi = jnp.real(xf_h), jnp.imag(xf_h)
    w = jnp.fft.ifft(xf[:, None, :] * psi_hat[None], axis=-1)
    env = jnp.abs(w)                                    # (B, J, T)

    p2 = (env**2).mean(axis=-1)                         # (B, J)
    sig = jnp.sqrt(jnp.maximum(p2, 1e-30))
    power = p2 / jnp.maximum(var[:, None], 1e-30)
    sparsity = env.mean(axis=-1) ** 2 / jnp.maximum(p2, 1e-30)
    p4 = (env**4).mean(axis=-1)
    flatness = jnp.log(jnp.maximum(p4, 1e-60)) - 2.0 * jnp.log(
        jnp.maximum(p2, 1e-30)
    )

    # Phi_3 / Phi_4 never need the second-level transforms in the *time*
    # domain: by Parseval, for any pair of spectra F, G,
    #   mean_t( ifft(F) conj(ifft(G)) ) = (1/T^2) sum_w F(w) conj(G(w)),
    # and both statistics pair spectra that share the SAME outer wavelet:
    #   Phi_3(a,b)   = <W_b(e_a) conj(W_b x)>   -> sum_w ef_a conj(xf) |psi_b|^2
    #   Phi_4(a,b,c) = <W_c(e_a) conj(W_c(e_b))>-> sum_w ef_a conj(ef_b) |psi_c|^2
    # with e_j the centred envelopes. So the whole W_c(e_a) ifft pass, the
    # one-hot pair expansion, and the (B, n_pairs, T) intermediates vanish;
    # what remains is one weighted contraction per statistic. The
    # wavelets are analytic (psi_hat = 0 for w < 0, tested), so the sums run
    # over the non-negative half-spectrum only.
    envc = env - env.mean(axis=-1, keepdims=True)
    half = half_
    S = (jnp.abs(psi_hat) ** 2)[:, :half]               # (J, half) real
    ef_h = jnp.fft.fft(envc, axis=-1)[..., :half]
    er, ei = jnp.real(ef_h), jnp.imag(ef_h)
    inv_T2 = 1.0 / (jnp.float32(T) * T)

    # Phi_3 / Phi_4 spectral contractions, band-limited and in real planes.
    # Two structural facts make these cheap:
    #   * the weighting filter |psi_b|^2 (resp. |psi_c|^2, c > b) occupies
    #     only ~T/2**b low bins (``bands``, static from the FilterBank), so
    #     each b-group contracts a dyadically shrinking slice — total work
    #     ~2 full-spectrum passes instead of ~J (measured: the full-width
    #     pair form cost ~J full-spectrum passes);
    #   * the complex products are spelled out on real/imag planes.
    # The truncation is exact to ~1e-12 relative (|psi| < 1e-6 peak beyond
    # the band edge, squared in the weights). The contractions run at full
    # float32 (precision.EXACT): the GPU's default TF32 would put ~5e-4
    # relative error on statistics the synthesis matches to 1e-2.
    if bands is None:
        bands = (half,) * J

    ia, ib = _index_pairs(J)
    p3r, p3i = [], []
    for b in range(1, J):
        hi = bands[b]
        era, eia = er[:, :b, :hi], ei[:, :b, :hi]
        xrh, xih = xr[:, None, :hi], xi[:, None, :hi]
        Sb = S[b, :hi]
        # z = ef_a * conj(xf)
        p3r.append(jnp.einsum("bat,t->ba", era * xrh + eia * xih, Sb,
                              precision=precision.EXACT))
        p3i.append(jnp.einsum("bat,t->ba", eia * xrh - era * xih, Sb,
                              precision=precision.EXACT))
    if p3r:
        perm3 = jnp.asarray(_pair_perm(J))
        p3r = jnp.concatenate(p3r, axis=1)[:, perm3] * inv_T2
        p3i = jnp.concatenate(p3i, axis=1)[:, perm3] * inv_T2
    else:
        p3r = p3i = jnp.zeros((B, 0), jnp.float32)
    norm3 = sig[:, ia] * sig[:, ib]
    phi3_r, phi3_i = p3r / norm3, p3i / norm3

    ta, tb, tc = _index_triples(J)
    p4r, p4i = [], []
    for b in range(J - 1):
        hi = bands[b + 1]  # widest correlating scale is c = b + 1
        era, eia = er[:, : b + 1, :hi], ei[:, : b + 1, :hi]
        erb, eib = er[:, b, :hi][:, None], ei[:, b, :hi][:, None]
        Sc = S[b + 1 :, :hi]                             # (J-1-b, hi)
        # C = ef_a * conj(ef_b)
        Cr = era * erb + eia * eib
        Ci = eia * erb - era * eib
        p4r.append(jnp.einsum("bat,ct->bac", Cr, Sc,
                              precision=precision.EXACT).reshape(B, -1))
        p4i.append(jnp.einsum("bat,ct->bac", Ci, Sc,
                              precision=precision.EXACT).reshape(B, -1))
    if p4r:
        perm4 = jnp.asarray(_trip_perm(J))
        p4r = jnp.concatenate(p4r, axis=1)[:, perm4] * inv_T2
        p4i = jnp.concatenate(p4i, axis=1)[:, perm4] * inv_T2
    else:
        p4r = p4i = jnp.zeros((B, 0), jnp.float32)
    norm4 = sig[:, ta] * sig[:, tb]
    phi4_r, phi4_i = p4r / norm4, p4i / norm4

    # mean as a t-statistic (O(1), comparable to the other stats)
    norm_mean = mean * jnp.sqrt(jnp.float32(T)) / jnp.sqrt(jnp.maximum(var, 1e-30))

    return jnp.concatenate(
        [
            norm_mean[:, None],
            jnp.log(jnp.maximum(var[:, None], 1e-30)),
            jnp.log(jnp.maximum(power, 1e-30)),
            sparsity,
            flatness,
            phi3_r,
            phi3_i,
            phi4_r,
            phi4_i,
        ],
        axis=-1,
    ).astype(jnp.float32)


@dataclass
class ScatteringStats:
    """Named view over the flat statistic vector (averaged over a batch)."""

    J: int
    flat: np.ndarray  # (n_stats,)

    def _slices(self):
        J = self.J
        n_pairs = J * (J - 1) // 2
        n_trip = len(_index_triples(J)[0])
        ofs = {}
        i = 0
        for name, n in (
            ("mean", 1), ("logvar", 1), ("logpower", J), ("sparsity", J),
            ("flatness", J),
            ("phi3_re", n_pairs), ("phi3_im", n_pairs),
            ("phi4_re", n_trip), ("phi4_im", n_trip),
        ):
            ofs[name] = slice(i, i + n)
            i += n
        return ofs

    def _get(self, name):
        return self.flat[self._slices()[name]]

    #: series length used for the mean's t-statistic normalisation; set by
    #: analyze() so .mean can invert it (None -> return the t-statistic)
    T: int | None = None

    @property
    def mean(self) -> float:
        t_stat = float(self._get("mean")[0])
        if self.T is None:
            return t_stat
        return t_stat * np.sqrt(self.variance / self.T)

    @property
    def variance(self) -> float:
        return float(np.exp(self._get("logvar")[0]))

    def mean_spectrum(self) -> np.ndarray:
        """Per-scale power Phi_2(j), unit-variance normalised."""
        return np.exp(self._get("logpower"))

    def sparsity(self) -> np.ndarray:
        return np.asarray(self._get("sparsity"))

    def flatness(self) -> np.ndarray:
        """Per-scale envelope flatness ``<|W|^4> / <|W|^2>^2`` (2 for a
        Gaussian envelope; larger = heavier tails)."""
        return np.exp(self._get("flatness"))

    def phase_envelope(self) -> np.ndarray:
        """Phi_3 as a (J, J) complex matrix (a rows, b cols; a < b)."""
        J = self.J
        out = np.zeros((J, J), dtype=np.complex128)
        ia, ib = _index_pairs(J)
        out[ia, ib] = self._get("phi3_re") + 1j * self._get("phi3_im")
        return out

    def envelope_correlation(self) -> np.ndarray:
        """Phi_4 marginalised over the correlating scale c: (J, J) complex
        matrix over (a, b)."""
        J = self.J
        out = np.zeros((J, J), dtype=np.complex128)
        cnt = np.zeros((J, J))
        ta, tb, tc = _index_triples(J)
        vals = self._get("phi4_re") + 1j * self._get("phi4_im")
        np.add.at(out, (ta, tb), vals)
        np.add.at(cnt, (ta, tb), 1.0)
        with np.errstate(invalid="ignore"):
            out = np.where(cnt > 0, out / np.maximum(cnt, 1), 0.0)
        return out


def scattering_stats(
    x: jax.Array, bank: FilterBank, average: bool = True
) -> jax.Array:
    """Flat statistic vector of ``x`` (``(B, T)`` or ``(T,)``).

    :param average: average the per-sample vectors over the batch
    """
    x = jnp.atleast_2d(jnp.asarray(x, jnp.float32))
    flat = _scattering_stats_flat(x, jnp.asarray(bank.psi_hat), J=bank.J,
                                  bands=bank.band_hi or None)
    return flat.mean(axis=0) if average else flat
