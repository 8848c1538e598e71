"""Scattering spectra: filter bank, statistics, synthesis convergence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shadowing_tpu import analyze, generate
from shadowing_tpu.models.scattering.moments import (
    ScatteringStats,
    n_stats,
    scattering_stats,
)
from shadowing_tpu.models.scattering.synthesis import synthesize_batch
from shadowing_tpu.models.scattering.wavelets import build_filter_bank


class TestFilterBank:
    def test_littlewood_paley(self):
        bank = build_filter_bank(T=1024, J=6)
        omega = 2 * np.pi * np.fft.fftfreq(1024)
        lp = np.abs(bank.phi_hat) ** 2 + 0.5 * (np.abs(bank.psi_hat) ** 2).sum(0)
        assert lp.max() <= 1.0 + 1e-6
        # frame lower bound on the covered band (away from Nyquist)
        pos = (omega > 2 * np.pi / 2**6) & (omega < 2.5)
        assert lp[pos].min() > 0.35

    def test_analytic_and_zero_mean(self):
        bank = build_filter_bank(T=512, J=5)
        omega = 2 * np.pi * np.fft.fftfreq(512)
        assert np.abs(bank.psi_hat[:, omega < 0]).max() == 0.0
        assert np.abs(bank.psi_hat[:, 0]).max() == 0.0  # no DC

    def test_dyadic_centres(self):
        bank = build_filter_bank(T=2048, J=6)
        omega = 2 * np.pi * np.fft.fftfreq(2048)
        centres = [omega[np.argmax(bank.psi_hat[j])] for j in range(6)]
        ratios = np.array(centres[:-1]) / np.array(centres[1:])
        np.testing.assert_allclose(ratios, 2.0, rtol=0.05)

    def test_too_deep_raises(self):
        with pytest.raises(ValueError):
            build_filter_bank(T=128, J=9)


class TestStats:
    def test_vector_length(self):
        bank = build_filter_bank(T=512, J=5)
        x = np.random.default_rng(0).normal(size=(3, 512)).astype(np.float32)
        s = scattering_stats(jnp.asarray(x), bank, average=False)
        assert s.shape == (3, n_stats(5))

    def test_gaussian_white_noise_baselines(self, rng):
        """White noise: phi3 ~ 0, phi4 ~ 0, sparsity ~ pi/4 (complex
        Gaussian envelope), mean t-stat ~ 0, logvar ~ 0 (standardised)."""
        x = rng.normal(size=(64, 2048))
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        bank = build_filter_bank(2048, 6)
        flat = np.asarray(scattering_stats(jnp.asarray(x, jnp.float32), bank))
        st = ScatteringStats(J=6, flat=flat)
        assert abs(st.mean) < 0.2  # t-stat scale
        assert abs(np.log(st.variance)) < 0.05
        np.testing.assert_allclose(st.sparsity(), np.pi / 4, atol=0.05)
        assert np.abs(st.phase_envelope()).max() < 0.1
        assert np.abs(st.envelope_correlation()).max() < 0.1

    def test_heavy_tails_lower_sparsity(self, rng):
        gauss = rng.normal(size=(32, 2048))
        heavy = rng.standard_t(3, size=(32, 2048))
        bank = build_filter_bank(2048, 5)
        s_g = ScatteringStats(5, np.asarray(
            scattering_stats(jnp.asarray(gauss, jnp.float32), bank)))
        s_h = ScatteringStats(5, np.asarray(
            scattering_stats(jnp.asarray(heavy, jnp.float32), bank)))
        # intermittent signals are sparser: lower <|W|>^2/<|W|^2>
        assert (s_h.sparsity() < s_g.sparsity() - 0.03).all()

    def test_phi3_phi4_match_time_domain_oracle(self, rng):
        """The frequency-domain (Parseval) forms must equal the defining
        time-domain correlations <W_b(|W_a x|) conj(W_b x)> and
        <W_c(|W_a x|) conj(W_c(|W_b x|))>, computed brute-force in f64."""
        from shadowing_tpu.models.scattering.moments import (
            ScatteringStats,
            _index_pairs,
            _index_triples,
        )

        T, J = 256, 4
        bank = build_filter_bank(T, J)
        x = rng.standard_t(5, size=(2, T)).astype(np.float32)
        flat = np.asarray(
            scattering_stats(jnp.asarray(x), bank, average=False)
        )

        psi = np.asarray(bank.psi_hat)
        xc = (x - x.mean(-1, keepdims=True)).astype(np.float64)
        xf = np.fft.fft(xc, axis=-1)
        w = np.fft.ifft(xf[:, None] * psi[None], axis=-1)      # (B, J, T)
        env = np.abs(w)
        sig = np.sqrt((env**2).mean(-1))
        envc = env - env.mean(-1, keepdims=True)
        ef = np.fft.fft(envc, axis=-1)
        # W_b(e_a) for all (a, b), brute force in the time domain
        we = np.fft.ifft(ef[:, :, None, :] * psi[None, None], axis=-1)

        st = ScatteringStats(J, flat[0])
        sl = st._slices()
        ia, ib = _index_pairs(J)
        phi3 = (we[:, ia, ib] * np.conj(w[:, ib])).mean(-1)
        phi3 /= sig[:, ia] * sig[:, ib]
        np.testing.assert_allclose(flat[:, sl["phi3_re"]], phi3.real,
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(flat[:, sl["phi3_im"]], phi3.imag,
                                   rtol=2e-4, atol=1e-6)

        ta, tb, tc = _index_triples(J)
        phi4 = (we[:, ta, tc] * np.conj(we[:, tb, tc])).mean(-1)
        phi4 /= sig[:, ta] * sig[:, tb]
        np.testing.assert_allclose(flat[:, sl["phi4_re"]], phi4.real,
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(flat[:, sl["phi4_im"]], phi4.imag,
                                   rtol=2e-4, atol=1e-6)

    def test_leverage_breaks_phi3_symmetry(self):
        """A series with sign-vol correlation (leverage) must produce a
        clearly larger |phi3| than its sign-symmetric surrogate."""
        rng = np.random.default_rng(3)
        n, T = 32, 2048
        eps = rng.normal(size=(n, T))
        vol = np.ones((n, T))
        for t in range(1, T):  # vol responds to negative past returns
            vol[:, t] = 0.9 * vol[:, t - 1] + 0.4 * np.maximum(
                -eps[:, t - 1], 0
            ) + 0.1
        lev = eps * vol
        sym = rng.choice([-1, 1], size=(n, T)) * np.abs(lev)
        bank = build_filter_bank(T, 5)
        p3_lev = np.abs(ScatteringStats(5, np.asarray(scattering_stats(
            jnp.asarray((lev - lev.mean()) / lev.std(), jnp.float32), bank
        ))).phase_envelope()).max()
        p3_sym = np.abs(ScatteringStats(5, np.asarray(scattering_stats(
            jnp.asarray((sym - sym.mean()) / sym.std(), jnp.float32), bank
        ))).phase_envelope()).max()
        assert p3_lev > 2 * p3_sym


class TestAnalyze:
    def test_restores_raw_mean_and_variance(self, rng):
        dlnx = rng.normal(0.0004, 0.012, size=4096)
        st = analyze(dlnx, J=6)
        assert st.variance == pytest.approx(dlnx.var(), rel=1e-3)
        assert st.mean == pytest.approx(dlnx.mean(), rel=1e-2)


class TestSynthesis:
    def test_converges_to_gaussian_target(self, rng):
        """Synthesising towards white-noise statistics must reach small
        mismatch quickly (the easiest target: identity-like)."""
        T, J = 512, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(64, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)
        z, rms = synthesize_batch(
            jax.random.PRNGKey(0), target, bank, batch=8,
            max_iterations=300, tol=0.03, segment=100,
        )
        assert z.shape == (8, T)
        assert np.median(rms) < 0.05

    def test_standardized_target_gives_standardized_output(self, rng):
        """With a z-scored target the in-loss projection is active: the
        returned seeds must be exactly per-seed standardized (mean/logvar
        matched by construction, not by gradient descent), and the rms
        must describe that standardized series."""
        from shadowing_tpu.models.scattering.moments import (
            _scattering_stats_flat,
        )
        from shadowing_tpu.models.scattering.synthesis import (
            should_standardize,
        )

        T, J = 512, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(64, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)
        assert should_standardize(target)
        z, rms = synthesize_batch(
            jax.random.PRNGKey(1), target, bank, batch=8,
            max_iterations=200, tol=0.03, segment=100,
        )
        np.testing.assert_allclose(z.mean(-1), 0.0, atol=1e-6)
        np.testing.assert_allclose(z.std(-1), 1.0, atol=1e-5)
        s = _scattering_stats_flat(jnp.asarray(z), jnp.asarray(bank.psi_hat),
                                   J=J)
        rms_check = np.sqrt(
            np.asarray(((s - target[None]) ** 2).mean(-1)))
        np.testing.assert_allclose(rms_check, rms, rtol=2e-2, atol=2e-4)
        # a non-standardized target must NOT trigger the projection
        assert not should_standardize(target.at[0].set(0.5))

    def test_compact_segment_matches_full(self, rng):
        """Gather->step->scatter on an active subset must match stepping the
        subset directly (to round-off: XLA reduction tiling may differ
        between batch shapes) and leave retired rows untouched bit-for-bit
        — duplicate (cycled) pad indices included."""
        from shadowing_tpu.models.scattering.synthesis import (
            _optimize_segment,
            _optimize_segment_compact,
        )

        T, J = 256, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(16, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)
        psi = jnp.asarray(bank.psi_hat)
        z0 = jnp.asarray(rng.normal(size=(8, T)), jnp.float32)
        m0 = jnp.zeros_like(z0)
        v0 = jnp.zeros_like(z0)
        active = np.array([1, 4, 6])
        idx = np.resize(active, 4)  # pad by cycling: [1, 4, 6, 1]
        i0 = jnp.asarray(10.0)

        zc, mc, vc, lc = _optimize_segment_compact(
            z0, m0, v0, jnp.asarray(idx, jnp.int32), i0, target, psi,
            J=J, n_steps=5,
        )
        zf, mf, vf, lf = _optimize_segment(
            z0[jnp.asarray(active)], m0[: 3], v0[: 3], i0, target, psi,
            J=J, n_steps=5,
        )
        np.testing.assert_allclose(np.asarray(zc)[active], np.asarray(zf),
                                   atol=5e-6, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(lc)[:3], np.asarray(lf),
                                   rtol=1e-4, atol=1e-8)
        frozen = np.setdiff1d(np.arange(8), active)
        np.testing.assert_array_equal(
            np.asarray(zc)[frozen], np.asarray(z0)[frozen]
        )
        np.testing.assert_array_equal(
            np.asarray(mc)[frozen], np.asarray(m0)[frozen]
        )

    def test_resume_reproduces_uninterrupted_run(self, rng, tmp_path):
        """An interrupted + resumed synthesis must return bit-identical
        series to the uninterrupted run — including the compaction
        schedule (retired seeds stay retired across the restart)."""
        T, J = 256, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(32, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)
        kw = dict(target=target, bank=bank, batch=8, tol=0.002, segment=40,
                  max_iterations=200)

        z_ref, rms_ref = synthesize_batch(jax.random.PRNGKey(5), **kw)

        # interrupt at the first submission AFTER a checkpoint was written
        # (the first flush point — policy-agnostic: the schedule decides
        # where flushes land), then resume from it
        ck = tmp_path / "state.ckpt.npz"

        class Stop(Exception):
            pass

        import shadowing_tpu.models.scattering.synthesis as syn
        orig_full = syn._optimize_segment
        orig_comp = syn._optimize_segment_compact
        orig_drain = syn._optimize_drain

        def make_wrapped(orig):
            def wrapped(*a, **k2):
                if ck.exists():
                    raise Stop()
                return orig(*a, **k2)
            return wrapped

        syn._optimize_segment = make_wrapped(orig_full)
        syn._optimize_segment_compact = make_wrapped(orig_comp)
        syn._optimize_drain = make_wrapped(orig_drain)
        try:
            with pytest.raises(Stop):
                synthesize_batch(jax.random.PRNGKey(5), **kw,
                                 checkpoint_path=ck,
                                 checkpoint_min_interval_s=0.0)
        finally:
            syn._optimize_segment = orig_full
            syn._optimize_segment_compact = orig_comp
            syn._optimize_drain = orig_drain
        assert ck.exists()
        z_res, rms_res = synthesize_batch(jax.random.PRNGKey(5), **kw,
                                          checkpoint_path=ck,
                                          checkpoint_min_interval_s=0.0)
        np.testing.assert_array_equal(z_res, z_ref)
        np.testing.assert_array_equal(rms_res, rms_ref)

    def test_bucket_sizes(self):
        from shadowing_tpu.models.scattering.synthesis import (
            _bucket,
            _bucket_sizes,
        )

        sizes = _bucket_sizes(256)
        assert sizes == [256, 128, 64, 32, 16, 8]
        assert _bucket(256, sizes) == 256
        assert _bucket(129, sizes) == 256
        assert _bucket(33, sizes) == 64
        assert _bucket(9, sizes) == 16
        assert _bucket(1, sizes) == 8
        assert _bucket_sizes(1) == [1]
        # mesh quantum: every bucket stays a device multiple
        assert _bucket_sizes(24, quantum=8) == [24, 16, 8]

    def test_generate_end_to_end_heavy_tail(self, rng):
        """Full generate() on a heavy-tailed, vol-clustered input: outputs
        must inherit scale, fat tails and clustering direction."""
        from scipy.stats import kurtosis

        # GARCH-ish input
        T_obs = 1500
        eps = rng.standard_t(5, size=T_obs)
        vol = np.ones(T_obs) * 0.01
        for t in range(1, T_obs):
            vol[t] = np.sqrt(
                0.02 * 0.01**2 + 0.9 * vol[t - 1] ** 2
                + 0.08 * (vol[t - 1] * eps[t - 1]) ** 2
            )
        dlnx = vol * eps + 2e-4

        out = generate(
            dlnx, R=8, J=5, T=512, tol_optim=0.05, max_iterations=300,
            seed=1, batch=8,
        )
        assert out.shape == (8, 1, 512)
        # scale restored
        assert out.std() == pytest.approx(dlnx.std(), rel=0.25)
        # heavy tails inherited (Gaussian would be ~0)
        assert kurtosis(out.ravel()) > 1.0

    def test_generate_partial_last_shard(self, rng):
        """R not a multiple of batch: the last shard is truncated into the
        preallocated output, and the kept rows are identical to the
        untruncated run (shard seeds are fold_in(seed, i) — row content
        cannot depend on R)."""
        dlnx = rng.normal(0, 0.01, size=1024)
        kw = dict(J=4, T=256, max_iterations=40, seed=5, batch=4)
        a = generate(dlnx, R=6, **kw)
        b = generate(dlnx, R=8, **kw)
        assert a.shape == (6, 1, 256) and b.shape == (8, 1, 256)
        np.testing.assert_array_equal(a, b[:6])

    def test_generate_cache_roundtrip(self, rng, tmp_path):
        dlnx = rng.normal(0, 0.01, size=1024)
        a = generate(dlnx, R=4, J=4, T=256, max_iterations=60, seed=2,
                     batch=4, cache_path=tmp_path)
        b = generate(dlnx, R=4, J=4, T=256, max_iterations=60, seed=2,
                     batch=4, cache_path=tmp_path)
        np.testing.assert_array_equal(a, b)
        shards = list(tmp_path.glob("scatgen_*/shard*.npy"))
        assert len(shards) == 1


class TestFlatness:
    def test_gaussian_flatness_is_two(self, rng):
        x = rng.normal(size=(64, 2048))
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        bank = build_filter_bank(2048, 5)
        st = ScatteringStats(5, np.asarray(
            scattering_stats(jnp.asarray(x, jnp.float32), bank)))
        np.testing.assert_allclose(st.flatness(), 2.0, atol=0.25)

    def test_synthesis_matches_target_flatness(self, rng):
        """Heavy-tailed target: generated series must reproduce the
        per-scale envelope flatness (the tail-weight statistic)."""
        t4 = rng.standard_t(4, size=4000) * 0.01
        out = generate(t4, R=8, J=5, T=1024, tol_optim=0.04,
                       max_iterations=500, seed=3, batch=8)
        from shadowing_tpu import analyze

        f_obs = analyze(t4, J=5).flatness()
        f_gen = analyze(out.ravel(), J=5).flatness()
        # within 30% per scale (log-scale stat, tol 0.04 optimisation)
        np.testing.assert_allclose(f_gen, f_obs, rtol=0.35)
        # and clearly super-Gaussian
        assert (f_gen > 2.3).any()


def _stats_oracle(x, psi_hat, J):
    """The statistic vector from its definitions, in float64 NumPy and in
    the time domain (no Parseval shortcut, no band truncation): the
    independent reference for ``_scattering_stats_flat``."""
    from shadowing_tpu.models.scattering.moments import (
        _index_pairs,
        _index_triples,
    )

    x = np.asarray(x, np.float64)
    T = x.shape[-1]
    psi = np.asarray(psi_hat, np.float64)
    mean = x.mean(-1)
    xc = x - mean[:, None]
    var = (xc**2).mean(-1)
    W = np.fft.ifft(np.fft.fft(xc)[:, None, :] * psi[None], axis=-1)
    env = np.abs(W)                                       # (B, J, T)
    p2 = (env**2).mean(-1)
    sig = np.sqrt(p2)
    envc = env - env.mean(-1, keepdims=True)
    # Wenv[:, a, c] = W_c(centred envelope a)
    Wenv = np.fft.ifft(np.fft.fft(envc)[:, :, None, :] * psi[None, None],
                       axis=-1)
    ia, ib = _index_pairs(J)
    phi3 = (Wenv[:, ia, ib] * np.conj(W[:, ib])).mean(-1) / (
        sig[:, ia] * sig[:, ib])
    ta, tb, tc = _index_triples(J)
    phi4 = (Wenv[:, ta, tc] * np.conj(Wenv[:, tb, tc])).mean(-1) / (
        sig[:, ta] * sig[:, tb])
    return np.concatenate([
        (mean * np.sqrt(T) / np.sqrt(var))[:, None],
        np.log(var)[:, None],
        np.log(p2 / var[:, None]),
        env.mean(-1) ** 2 / p2,
        np.log((env**4).mean(-1)) - 2 * np.log(p2),
        phi3.real, phi3.imag, phi4.real, phi4.imag,
    ], axis=-1)


def _fat_tailed(rng, B, T):
    """Volatility-clustered series, so Phi_3 / Phi_4 are not all ~0."""
    vol = np.exp(np.cumsum(rng.normal(0, 0.05, size=(B, T)), axis=-1))
    return (rng.standard_t(4, size=(B, T)) * vol).astype(np.float32)


class TestStatsOracle:
    """scattering_stats through XLA's FFT against the float64 oracle."""

    @pytest.mark.parametrize("J,T", [(3, 128), (5, 512), (6, 1000),
                                     (9, 4096)])
    def test_stats_match_float64_oracle(self, rng, J, T):
        bank = build_filter_bank(T, J)
        x = _fat_tailed(rng, 3, T)
        got = np.asarray(scattering_stats(jnp.asarray(x), bank,
                                          average=False))
        want = _stats_oracle(x, bank.psi_hat, J)
        assert got.shape == want.shape == (3, n_stats(J))
        # float32 FFTs: ~1e-6 relative on the spectra; the small Phi_3 /
        # Phi_4 entries carry that as an absolute error
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)

    @pytest.mark.parametrize("J,T", [(3, 128), (4, 256), (6, 512)])
    def test_gradient_matches_oracle_difference(self, rng, J, T):
        """Directional derivative of a random linear functional of the
        statistics: jax.grad (float32) against a central difference of the
        float64 oracle."""
        bank = build_filter_bank(T, J)
        x = _fat_tailed(rng, 2, T)
        c = rng.normal(size=(2, n_stats(J)))
        v = rng.normal(size=x.shape)
        f = lambda z: (jnp.asarray(c, jnp.float32) * scattering_stats(
            z, bank, average=False)).sum()
        g = np.asarray(jax.grad(f)(jnp.asarray(x)), np.float64)
        h = 1e-4
        num = ((c * _stats_oracle(x + h * v, bank.psi_hat, J)).sum()
               - (c * _stats_oracle(x - h * v, bank.psi_hat, J)).sum()) / (
                   2 * h)
        np.testing.assert_allclose((g * v).sum(), num, rtol=2e-3)


class TestColouredInit:
    def test_colour_filter_matches_target_power(self, rng):
        """Coloured seeds start with per-scale wavelet powers ~= target."""
        from shadowing_tpu.models.scattering.moments import (
            _scattering_stats_flat,
        )
        from shadowing_tpu.models.scattering.synthesis import _coloured_noise

        T, J = 2048, 6
        bank = build_filter_bank(T, J)
        # a strongly non-flat target: an AR(1)-like red spectrum
        x = rng.normal(size=(64, T)).astype(np.float32)
        for t in range(1, T):
            x[:, t] += 0.82 * x[:, t - 1]
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        psi = jnp.asarray(bank.psi_hat)
        target = _scattering_stats_flat(jnp.asarray(x), psi, J=J).mean(0)

        z = _coloured_noise(jax.random.PRNGKey(0), 64, T, target, psi, J)
        z = np.asarray(z)
        assert np.isfinite(z).all()
        np.testing.assert_allclose(z.std(-1), 1.0, atol=1e-5)  # unit scale
        got = _scattering_stats_flat(jnp.asarray(z), psi, J=J).mean(0)
        # logpower slice [2 : 2+J]: matched to ~15% in log space, vs an
        # order-of-magnitude mismatch for white seeds
        lp_t = np.asarray(target[2:2 + J])
        lp_g = np.asarray(got[2:2 + J])
        white = _scattering_stats_flat(
            jax.random.normal(jax.random.PRNGKey(1), (64, T), jnp.float32),
            psi, J=J).mean(0)
        lp_w = np.asarray(white[2:2 + J])
        assert np.abs(lp_g - lp_t).max() < 0.2
        assert np.abs(lp_g - lp_t).max() < 0.25 * np.abs(lp_w - lp_t).max()

    def test_coloured_init_converges_faster(self, rng):
        """Same tol, same budget: coloured init must not be worse than
        white (and typically converges in fewer steps)."""
        from shadowing_tpu.models.scattering.synthesis import synthesize_batch

        T, J = 512, 4
        bank = build_filter_bank(T, J)
        x = rng.normal(size=(64, T)).astype(np.float32)
        for t in range(1, T):
            x[:, t] += 0.7 * x[:, t - 1]
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(x), bank)
        wl_c, wl_w = {}, {}
        _, rms_c = synthesize_batch(
            jax.random.PRNGKey(2), target, bank, batch=8, tol=0.03,
            segment=50, max_iterations=400, work_log=wl_c, init="coloured")
        _, rms_w = synthesize_batch(
            jax.random.PRNGKey(2), target, bank, batch=8, tol=0.03,
            segment=50, max_iterations=400, work_log=wl_w, init="white")
        assert (rms_c < 0.05).mean() >= (rms_w < 0.05).mean()
        assert wl_c["seed_steps"] <= wl_w["seed_steps"]

    def test_auto_init_never_worse_at_start(self, rng):
        """The auto init picks per seed over {coloured} U {envelope
        candidates} by initial loss, so its starting mismatch can never
        exceed the plain coloured start — for ANY target."""
        from shadowing_tpu.models.scattering.moments import (
            _scattering_stats_flat,
        )
        from shadowing_tpu.models.scattering.synthesis import (
            _auto_seeds,
            _coloured_noise,
        )

        T, J, B = 1024, 5, 16
        bank = build_filter_bank(T, J)
        psi = jnp.asarray(bank.psi_hat)
        targets = {}
        g = rng.normal(size=(32, T)).astype(np.float32)  # Gaussian target
        targets["gaussian"] = _scattering_stats_flat(
            jnp.asarray(g), psi, J=J).mean(0)
        h = g * np.exp(rng.normal(size=(32, T)) * 0.5).astype(np.float32)
        h = (h - h.mean(-1, keepdims=True)) / h.std(-1, keepdims=True)
        targets["heavy"] = _scattering_stats_flat(
            jnp.asarray(h), psi, J=J).mean(0)

        def per_seed_loss(z, target):
            s = _scattering_stats_flat(jnp.asarray(z), psi, J=J)
            return np.asarray(((s - target[None]) ** 2).mean(-1))

        # the auto init draws its coloured base from the FIRST split of the
        # key (the second drives the envelopes) — compare against that same
        # draw, not a fresh one
        k_base = jax.random.split(jax.random.PRNGKey(5))[0]
        for name, target in targets.items():
            za = _auto_seeds(jax.random.PRNGKey(5), B, T, target, psi, J=J)
            zc = _coloured_noise(k_base, B, T, target, psi, J=J)
            la = per_seed_loss(za, target)
            lc = per_seed_loss(zc, target)
            # small slack: the argmin runs on the fused in-jit loss values,
            # the check recomputes them in a separate call (float32 ulp)
            assert (la <= lc * (1 + 1e-4) + 1e-7).all(), name
            np.testing.assert_allclose(
                np.asarray(za).std(-1), 1.0, atol=1e-4)

    def test_auto_init_helps_intermittent_target(self, rng):
        """For a volatility-clustered (MRW-like) target the envelope
        candidates must actually win for most seeds and cut the initial
        mismatch by a clear margin."""
        from shadowing_tpu.models.scattering.moments import (
            _scattering_stats_flat,
        )
        from shadowing_tpu.models.mrw import MRWGenerator
        from shadowing_tpu.models.scattering.synthesis import (
            _auto_seeds,
            _coloured_noise,
        )

        T, J, B = 1024, 5, 16
        bank = build_filter_bank(T, J)
        psi = jnp.asarray(bank.psi_hat)
        x = np.diff(MRWGenerator(T + 1, lam=0.3, seed=4).generate(
            32, batch=32)[:, 0, :]).astype(np.float32)
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        target = _scattering_stats_flat(jnp.asarray(x), psi, J=J).mean(0)

        def mean_loss(z):
            s = _scattering_stats_flat(jnp.asarray(z), psi, J=J)
            return float(((s - target[None]) ** 2).mean())

        za = _auto_seeds(jax.random.PRNGKey(6), B, T, target, psi, J=J)
        zc = _coloured_noise(jax.random.PRNGKey(6), B, T, target, psi, J=J)
        assert mean_loss(za) < 0.7 * mean_loss(zc)

    def test_bad_init_raises(self, rng):
        from shadowing_tpu.models.scattering.synthesis import synthesize_batch

        bank = build_filter_bank(256, 4)
        target = scattering_stats(
            jnp.asarray(rng.normal(size=(4, 256)), jnp.float32), bank)
        with pytest.raises(ValueError, match="init"):
            synthesize_batch(jax.random.PRNGKey(0), target, bank, batch=4,
                             max_iterations=10, init="pink")


class TestWarmupExecutables:
    def test_warmup_covers_every_run_executable(self, rng, monkeypatch):
        """bench.py pre-warms via warmup_executables — its enumeration must
        cover EVERY (rows, n_steps, path) executable a real run dispatches
        (a missed shape lands its compile inside the measurement). Budget
        exhaustion remainders are documented as non-enumerable; using a
        tolerance the runs converge under keeps them out of this run."""
        from shadowing_tpu.models.scattering import synthesis as syn

        T, J = 256, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(64, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)

        keys = []
        orig_c, orig_f = syn._optimize_segment_compact, syn._optimize_segment
        orig_d = syn._optimize_drain

        def wrap_c(*a, **k):
            keys.append((a[3].shape[0], k["n_steps"], True))
            return orig_c(*a, **k)

        def wrap_f(*a, **k):
            keys.append((a[0].shape[0], k["n_steps"], False))
            return orig_f(*a, **k)

        def wrap_d(*a, **k):
            keys.append(("drain", a[3].shape[0], k["sub_steps"]))
            return orig_d(*a, **k)

        monkeypatch.setattr(syn, "_optimize_segment_compact", wrap_c)
        monkeypatch.setattr(syn, "_optimize_segment", wrap_f)
        monkeypatch.setattr(syn, "_optimize_drain", wrap_d)

        batch, seg, max_iter = 16, 40, 2000
        for compact in (True, False):
            keys.clear()
            syn.warmup_executables(target, bank, batch, segment=seg,
                                   max_iterations=max_iter, compact=compact)
            warmed = set(keys)
            keys.clear()
            # the REAL coverage invariant: a run after warm-up must not
            # trace (= compile) anything new. Python-level key recording
            # misses jit-key subtleties (a weak-typed i0 scalar keyed a
            # DIFFERENT executable than the run's strong-typed one and
            # put compiles inside timed runs — caught by exactly this
            # assertion)
            n_tr = (orig_c._cache_size(), orig_f._cache_size(),
                    orig_d._cache_size(),
                    syn._standardize_jit._cache_size(),
                    syn._standardize_rows._cache_size())
            _, rms = syn.synthesize_batch(
                jax.random.PRNGKey(3), target, bank, batch=batch,
                max_iterations=max_iter, tol=0.05, segment=seg,
                compact=compact,
            )
            assert (rms < 0.05).all(), "pick an easier tol for this test"
            assert (orig_c._cache_size(), orig_f._cache_size(),
                    orig_d._cache_size(),
                    syn._standardize_jit._cache_size(),
                    syn._standardize_rows._cache_size()) == n_tr, \
                "synthesize_batch traced executables the warm-up missed"
            dispatched = set(keys) - {(batch, 0, False)}  # final-eval probe
            missing = dispatched - warmed
            assert not missing, f"run dispatched unwarmed executables {missing}"

    def test_overlap_fetch_bit_identity(self, rng):
        """The overlapped snapshot+splice output fetch is BIT-identical to
        the single end-of-run fetch: standardization is per-row and compact
        active sets shrink monotonically, so rows retired before the
        snapshot are final when it is taken and the splice only replaces
        rows the drain kept writing."""
        from shadowing_tpu.models.scattering import synthesis as syn

        T, J = 256, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(64, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)

        # tight tol + short segments: convergence spreads across segments so
        # the active set passes through <= batch/4 (probed under the
        # bridge-pipelined schedule: looser configs converge wholesale
        # inside the first segment and never drain)
        kwargs = dict(target=target, bank=bank, batch=32,
                      max_iterations=2000, tol=0.005, segment=5)
        wl = {}
        out_a, rms_a = syn.synthesize_batch(
            jax.random.PRNGKey(3), work_log=wl, **kwargs)
        assert wl["overlap_fetch"], ("config never drained below batch/4 — "
                                     "the overlap path was not exercised")
        assert wl["t_finalize_s"] >= 0
        # per-iteration observability: one submit wall per loop iteration,
        # one harvest wall per pipelined harvest
        assert len(wl["t_submits"]) >= wl["n_harvests"] >= 1
        assert len(wl["t_harvests"]) <= wl["n_harvests"]
        assert all(t >= 0 for t in wl["t_submits"] + wl["t_harvests"])
        out_b, rms_b = syn.synthesize_batch(
            jax.random.PRNGKey(3), overlap_fetch=False, **kwargs)
        np.testing.assert_array_equal(out_a, out_b)
        np.testing.assert_array_equal(rms_a, rms_b)
        assert out_a.flags.writeable

    def test_budget_exhausted_drain_invariants(self, rng):
        """Regression for two round-5 review repros: (a) a budget-remainder
        segment after a budget-exhausted drain must invalidate the
        drain-overlapped refetch (the stale splice returned pre-remainder
        values for the drained rows); (b) a row re-entered by a harvest
        must not be dropped by the drain-entry harvest (a run exited with
        budget left and a row at rms >= tol, never re-stepped). Invariants
        per config: overlap and non-overlap outputs are bit-identical, and
        the run either converges every row or spends the whole budget."""
        from shadowing_tpu.models.scattering import synthesis as syn

        T, J = 256, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(64, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)
        # both configs reproduced the stale splice on the unfixed code
        # (outputs differed by ~1e-2 at the drained rows)
        for seed, max_iter, tol in [(0, 459, 1.5e-4), (0, 430, 2e-4)]:
            kwargs = dict(target=target, bank=bank, batch=32,
                          max_iterations=max_iter, tol=tol, segment=5)
            wl = {}
            out_a, rms_a = syn.synthesize_batch(
                jax.random.PRNGKey(seed), work_log=wl, **kwargs)
            out_b, rms_b = syn.synthesize_batch(
                jax.random.PRNGKey(seed), overlap_fetch=False, **kwargs)
            np.testing.assert_array_equal(out_a, out_b)
            np.testing.assert_array_equal(rms_a, rms_b)
            assert (rms_a < tol).all() or wl["steps"] == max_iter, (
                f"run exited at step {wl['steps']}/{max_iter} with "
                f"{int((rms_a >= tol).sum())} unconverged rows")

    def test_in_program_chunking_matches_plain(self, rng):
        """The lax.map row-chunked segment (the >128-row executables'
        internal form) steps each seed identically to the plain scan —
        per-seed math is independent, so chunking is exact up to XLA
        tiling round-off."""
        from shadowing_tpu.models.scattering.synthesis import (
            _optimize_segment,
        )

        T, J = 256, 4
        bank = build_filter_bank(T, J)
        zt = rng.normal(size=(64, T)).astype(np.float32)
        zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
        target = scattering_stats(jnp.asarray(zt), bank)
        psi = jnp.asarray(bank.psi_hat)
        z0 = jnp.asarray(rng.normal(size=(24, T)), jnp.float32)
        zeros = jnp.zeros_like(z0)
        kw = dict(target=target, psi_hat=psi, J=J, n_steps=10, lr=0.03,
                  bands=bank.band_hi or None, standardize=True)
        plain = _optimize_segment(z0, zeros, zeros, jnp.asarray(0.0),
                                  chunk=0, **kw)
        chunked = _optimize_segment(z0, zeros, zeros, jnp.asarray(0.0),
                                    chunk=8, **kw)
        for a, b in zip(plain, chunked):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-6)
        # indivisible batches keep the plain form (still correct)
        odd = _optimize_segment(z0[:23], zeros[:23], zeros[:23],
                                jnp.asarray(0.0), chunk=8, **kw)
        np.testing.assert_allclose(np.asarray(odd[0]),
                                   np.asarray(plain[0][:23]),
                                   rtol=2e-4, atol=2e-6)
