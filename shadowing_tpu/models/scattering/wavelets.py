"""Analytic dyadic wavelet filter bank, defined in the Fourier domain.

Foundation of the scattering-spectra model (arXiv:2204.10177) behind the
reference's dataset generation (``/root/reference/scripts/
snp_generation.py:39-50``). Filters are built once on host (numpy) and
applied by FFT inside jit — a dense pipeline (no strided convolution
loops).

The mother wavelet is an *analytic* Morlet: a Gaussian bump centred at
``xi = 3*pi/4`` with a correction term cancelling the DC response, truncated
to positive frequencies (strict analyticity makes the modulus ``|W_j x|`` a
true envelope). Scale ``j`` dilates by ``2**j``; a Gaussian low-pass closes
the Littlewood-Paley sum.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

XI = 3.0 * np.pi / 4.0
#: bandwidth chosen so adjacent dyadic filters cross near half power
SIGMA0 = 0.6 * XI


@dataclass(frozen=True)
class FilterBank:
    """Fourier-domain filters for series of length ``T``.

    psi_hat: ``(J, T)`` analytic band-pass filters (float32, real-valued
        transfer functions on the fft frequency grid)
    phi_hat: ``(T,)`` low-pass at scale ``2**J``
    band_hi: per-scale upper support bin (exclusive): ``|psi_hat[j]|`` is
        below ``1e-6`` of its peak for all bins ``>= band_hi[j]``. Static
        (hashable) — the scattering statistics truncate their spectral
        contractions here, which is what makes the cross-scale Phi_3/Phi_4
        terms cheap (coarse scales occupy ~T/2**j bins; contracting the
        full axis for every scale is ~J x wasted traffic). Rounded up to a
        multiple of 128 bins.
    """

    J: int
    T: int
    psi_hat: np.ndarray
    phi_hat: np.ndarray
    band_hi: tuple = ()


def _morlet_hat(omega: np.ndarray, xi: float, sigma: float) -> np.ndarray:
    """Analytic Morlet transfer function on the given frequency grid."""
    main = np.exp(-((omega - xi) ** 2) / (2 * sigma**2))
    # cancel the DC response, keep analyticity (positive frequencies only)
    corr = np.exp(-(xi**2) / (2 * sigma**2)) * np.exp(
        -(omega**2) / (2 * sigma**2)
    )
    h = (main - corr) * (omega > 0)
    return h


def build_filter_bank(T: int, J: int) -> FilterBank:
    """Dyadic analytic filters psi_j (j = 0..J-1; centre ``xi / 2**j``) and
    the closing low-pass phi_J, Littlewood-Paley normalised so that

        max_omega [ |phi(w)|^2 + 1/2 * sum_j |psi_j(w)|^2 ] = 1.
    """
    if 2**J > T:
        raise ValueError(f"J={J} too deep for T={T} (need 2**J <= T)")
    omega = 2 * np.pi * np.fft.fftfreq(T)  # in (-pi, pi]

    psi = np.stack(
        [_morlet_hat(omega * 2**j, XI, SIGMA0) for j in range(J)]
    )
    sigma_lp = XI / 2**J
    phi = np.exp(-(omega**2) / (2 * sigma_lp**2))

    # Littlewood-Paley renormalisation (on positive frequencies; the factor
    # 1/2 accounts for the analytic filters covering only half the axis)
    lp = np.abs(phi) ** 2 + 0.5 * (np.abs(psi) ** 2).sum(0)
    norm = np.sqrt(lp.max())
    psi = psi / norm
    phi = phi / norm

    psi = psi.astype(np.float32)
    half = T // 2 + 1
    band_hi = []
    for j in range(J):
        nz = np.flatnonzero(np.abs(psi[j, :half]) > 1e-6 * np.abs(psi[j]).max())
        hi = int(nz[-1]) + 1 if nz.size else 1
        band_hi.append(min(half, -(-hi // 128) * 128))
    return FilterBank(
        J=J,
        T=T,
        psi_hat=psi,
        phi_hat=phi.astype(np.float32),
        band_hi=tuple(band_hi),
    )
