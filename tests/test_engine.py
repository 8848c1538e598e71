"""Shadow engine: fused vs direct vs an independent numpy oracle.

The oracle implements the mathematical definition of the search from first
principles (explicit per-window dot products in float64) — it is the
specification, not a port.
"""
import numpy as np
import pytest

from shadowing_tpu import (
    CrossChannelContext,
    Foveal,
    Identity,
    ImputationContext,
    PathShadowing,
    PredictionContext,
    RelativeMSE,
    Softmax,
    realized_variance,
)


def oracle_search(x_context, dataset, kernel, n_out, k, return_full=False):
    """k smallest RelativeMSE distances, float64, brute force.

    x_context: (B, C, w); dataset: (R, C, T); kernel: (d, C, w).
    Returns distances (B, k), flat indices (B, k) with flat = r * n_out + t.
    """
    x_context = x_context.astype(np.float64)
    dataset = dataset.astype(np.float64)
    kernel = kernel.astype(np.float64)
    B = x_context.shape[0]
    R, C, T = dataset.shape
    w = kernel.shape[-1]

    xe = np.einsum("bcw,dcw->bd", x_context, kernel)
    E = np.stack(
        [np.einsum("rct,dct->rd", dataset[:, :, t : t + w], kernel)
         for t in range(n_out)],
        axis=1,
    )  # (R, n_out, d)
    diff = xe[:, None, None, :] - E[None]
    dist = np.linalg.norm(diff, axis=-1) / np.linalg.norm(xe, axis=-1)[:, None, None]
    flat = dist.reshape(B, -1)
    idx = np.argsort(flat, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(flat, idx, axis=1)
    if return_full:
        return top, idx, flat
    return top, idx


@pytest.fixture()
def small_problem(rng):
    dataset = rng.normal(0, 0.02, size=(32, 1, 256)).astype(np.float32)
    x_context = rng.normal(0, 0.02, size=(4, 1, 24)).astype(np.float32)
    return dataset, x_context


class TestShadowCore:
    @pytest.mark.parametrize("method", ["fused", "direct"])
    def test_matches_oracle(self, small_problem, method):
        dataset, x_context = small_problem
        horizon = 16
        emb = Identity(24)
        obj = PathShadowing(emb, RelativeMSE(), dataset,
                            PredictionContext(horizon=horizon))
        k = 50
        d, paths, idces = obj.shadow(x_context, k=k, n_splits=1, method=method)

        n_out = 256 - 24 - horizon + 1
        ed, ei, full = oracle_search(
            x_context, dataset, emb.kernel, n_out, k, return_full=True
        )
        flat = idces[..., 0].astype(np.int64) * n_out + idces[..., 1]
        # distances must match the float64 oracle rank-for-rank
        np.testing.assert_allclose(d, ed, rtol=2e-5)
        # each returned index must hold the oracle distance of its rank —
        # exact index equality is only ambiguous at float64 near-ties, which
        # no f32 computation can resolve
        oracle_at_returned = np.take_along_axis(full, flat, axis=1)
        np.testing.assert_allclose(oracle_at_returned, ed, rtol=2e-5)
        # and the vast majority of indices agree outright
        assert (flat == ei).mean() > 0.8
        assert paths.shape == (4, k, 1, 24 + horizon)

    def test_foveal_fused_equals_direct(self, rng):
        dataset = rng.normal(0, 0.02, size=(64, 1, 512)).astype(np.float32)
        x_context = rng.normal(0, 0.02, size=(2, 1, 126)).astype(np.float32)
        emb = Foveal(alpha=1.15, beta=0.9, max_context=126)
        ctx = PredictionContext(horizon=64)
        k = 32
        obj_f = PathShadowing(emb, RelativeMSE(), dataset, ctx)
        obj_d = PathShadowing(emb, RelativeMSE(), dataset, ctx)
        df, pf, i_f = obj_f.shadow(x_context, k=k, method="fused")
        dd, pd_, i_d = obj_d.shadow(x_context, k=k, method="direct")
        np.testing.assert_array_equal(i_f, i_d)
        np.testing.assert_allclose(df, dd, rtol=1e-6)
        np.testing.assert_allclose(pf, pd_, rtol=1e-6)

    def test_split_invariance(self, small_problem):
        """Reference testing.ipynb cell-1 property at engine level: any
        n_splits gives identical results."""
        dataset, x_context = small_problem
        emb = Identity(24)
        obj = PathShadowing(emb, RelativeMSE(), dataset,
                            PredictionContext(horizon=8))
        d1, p1, i1 = obj.shadow(x_context, k=20, n_splits=1)
        d4, p4, i4 = obj.shadow(x_context, k=20, n_splits=4)
        d5, p5, i5 = obj.shadow(x_context, k=20, n_splits=5)  # uneven chunks
        np.testing.assert_array_equal(i1, i4)
        np.testing.assert_array_equal(i1, i5)
        np.testing.assert_array_equal(d1, d4)
        np.testing.assert_array_equal(d1, d5)

    def test_tie_order_canonical_across_methods(self, rng):
        """Distinct windows CAN tie bit-exactly in f32 distance (duplicated
        trajectories here; observed in the wild at a 32768x4096 search).
        Every method must break ties identically — canonical (distance,
        flat id) order — so fused / factored / direct return bit-identical
        indices, not just distances."""
        dataset = rng.normal(0, 0.02, size=(32, 1, 256)).astype(np.float32)
        dataset[17] = dataset[3]   # every window of traj 3 ties with traj 17
        dataset[29] = dataset[3]
        x_context = dataset[[3], :, 40:64]
        emb = Identity(24)
        obj = PathShadowing(emb, RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        k = 60  # deep enough to contain many tied triples
        d_f, _, i_f = obj.shadow(x_context, k=k, method="fused")
        d_d, _, i_d = obj.shadow(x_context, k=k, method="direct")
        d_p, _, i_p = obj.shadow(x_context, k=k, method="factored")
        np.testing.assert_array_equal(d_f, d_d)
        np.testing.assert_array_equal(i_f, i_d)
        np.testing.assert_array_equal(d_f, d_p)
        np.testing.assert_array_equal(i_f, i_p)
        # the duplicated trajectories really did produce in-k ties
        n_out = 256 - 24 - 16 + 1
        flat = i_f[0, :, 0].astype(np.int64) * n_out + i_f[0, :, 1]
        dup = d_f[0][1:] == d_f[0][:-1]
        assert dup.any()
        # and tied runs are ordered by ascending flat id
        assert (np.diff(flat)[dup] > 0).all()

    def test_roundtrip_distances(self, small_problem):
        """Reference testing.ipynb cell-2 property: re-embedding the returned
        paths' in-context part reproduces the returned distances."""
        dataset, x_context = small_problem
        horizon = 16
        emb = Identity(24)
        dist = RelativeMSE()
        obj = PathShadowing(emb, dist, dataset, PredictionContext(horizon))
        d, paths, _ = obj.shadow(x_context, k=64)

        past = obj.context.select_in_context(paths)  # (B, k, C, w)
        e = np.einsum("bkcw,dcw->bkd", past.astype(np.float64),
                      emb.kernel.astype(np.float64))
        xe = np.einsum("bcw,dcw->bd", x_context.astype(np.float64),
                       emb.kernel.astype(np.float64))
        dd = np.linalg.norm(xe[:, None] - e, axis=-1) / np.linalg.norm(
            xe, axis=-1, keepdims=True
        )
        np.testing.assert_allclose(d, dd, rtol=2e-5)

    def test_paths_are_dataset_slices(self, small_problem):
        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        _, paths, idces = obj.shadow(x_context, k=8)
        for b in range(x_context.shape[0]):
            for j in range(8):
                r, t = idces[b, j]
                np.testing.assert_array_equal(
                    paths[b, j], dataset[r, :, t : t + 40]
                )

    def test_horizon_respects_boundaries(self, small_problem):
        dataset, x_context = small_problem
        horizon = 100
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon))
        _, _, idces = obj.shadow(x_context, k=16)
        assert (idces[..., 1] + 24 + horizon <= 256).all()


class TestContexts:
    def test_imputation(self, rng):
        dataset = rng.normal(0, 1, size=(16, 1, 128)).astype(np.float32)
        ctx = ImputationContext((8, 6, 8))
        x_context = rng.normal(0, 1, size=(2, 1, 16)).astype(np.float32)
        obj = PathShadowing(Identity(16), RelativeMSE(), dataset, ctx)
        d, paths, idces = obj.shadow(x_context, k=8)
        assert paths.shape == (2, 8, 1, 22)
        # in-context = flanks: distances recompute from the flanks
        past = ctx.select_in_context(paths)
        assert past.shape == (2, 8, 1, 16)
        dd = np.linalg.norm(
            x_context[:, None] - past, axis=(-2, -1)
        ) / np.linalg.norm(x_context, axis=(-2, -1))[:, None]
        np.testing.assert_allclose(d, dd, rtol=2e-5)
        # out-context = the middle gap, a contiguous dataset slice
        out = ctx.select_out_context(paths)
        assert out.shape == (2, 8, 1, 6)
        r, t = idces[0, 0]
        np.testing.assert_array_equal(out[0, 0, 0], dataset[r, 0, t + 8 : t + 14])

    def test_cross_channel(self, rng):
        dataset = rng.normal(0, 1, size=(16, 2, 64)).astype(np.float32)
        ctx = CrossChannelContext(out_context_channels=1)
        x_context = rng.normal(0, 1, size=(1, 1, 12)).astype(np.float32)
        kernel = np.eye(12, dtype=np.float32)[:, None, :]  # embed channel 0
        from shadowing_tpu import PathEmbedding

        obj = PathShadowing(PathEmbedding(kernel), RelativeMSE(), dataset, ctx)
        d, paths, _ = obj.shadow(x_context, k=4)
        assert paths.shape == (1, 4, 2, 12)
        # distance must only involve channel 0
        past = ctx.select_in_context(paths)  # (1, 4, 1, 12)
        dd = np.linalg.norm(
            x_context[:, None] - past, axis=(-2, -1)
        ) / np.linalg.norm(x_context, axis=(-2, -1))[:, None]
        np.testing.assert_allclose(d, dd, rtol=2e-5)


class TestPredict:
    def test_predict_matches_manual_softmax(self, small_problem):
        dataset, x_context = small_problem
        horizon = 16
        Ts = [4, 8, 16]
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon))
        to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=Ts, vol=False)
        k, eta = 32, 0.5
        pred, pred_std = obj.predict(x_context, k=k, to_predict=to_predict,
                                     eta=eta)
        assert pred.shape == (4, len(Ts))

        d, paths, _ = obj.shadow(x_context, k=k)
        fut = paths[:, :, 0, -horizon:]
        rv = np.stack([(fut[..., :T] ** 2).mean(-1) * 252 for T in Ts], -1)
        wgt = np.exp(-0.5 * (d / eta) ** 2)
        wgt = wgt / wgt.sum(1, keepdims=True)
        manual = (wgt[..., None] * rv).sum(1)
        np.testing.assert_allclose(pred, manual, rtol=1e-4)
        manual_std = np.sqrt(
            np.maximum((wgt[..., None] * rv**2).sum(1) - manual**2, 0)
        )
        np.testing.assert_allclose(pred_std, manual_std, rtol=1e-3, atol=1e-8)

    def test_context_splits_consistent(self, small_problem):
        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(8))
        f = lambda x: realized_variance(x[:, :, 0, :], Ts=[4], vol=True)
        p1, s1 = obj.predict(x_context, k=16, to_predict=f, eta=0.3)
        p2, s2 = obj.predict(x_context, k=16, to_predict=f, eta=0.3,
                             n_context_splits=4)
        np.testing.assert_allclose(p1, p2, rtol=1e-6)
        np.testing.assert_allclose(s1, s2, rtol=1e-6)


class TestConditionalSmile:
    def test_smiles_per_context(self, small_problem):
        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        smiles = obj.conditional_smile(
            x_context[:2], k=32, Ts=[4, 8], Ms=[-1.0, 0.0, 1.0], eta=0.5
        )
        assert len(smiles) == 2
        for s in smiles:
            assert s.vols.shape == (2, 3)
            # ATM must always price; extreme strikes may legitimately have
            # no-arb-violating MC prices (reported as NaN, not railed)
            assert np.isfinite(s.vols[:, 1]).all()
            finite = s.vols[np.isfinite(s.vols)]
            assert (finite > 0).all()


class TestPredictAndSmile:
    def test_matches_separate_calls(self, small_problem):
        """The fused predict+smile pipeline must reproduce predict() and
        conditional_smile() exactly (same search, same aggregates)."""
        from shadowing_tpu.stats.realized import realized_variance

        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        f = lambda p: realized_variance(p[:, :, 0, :], Ts=[4, 8], vol=False)
        Ts, Ms = [4, 8], [-1.0, 0.0, 1.0]

        avg, std, smiles = obj.predict_and_smile(
            x_context[:2], k=32, to_predict=f, Ts=Ts, Ms=Ms,
            eta=0.3, eta_smile=0.5,
        )
        a_ref, s_ref = obj.predict(x_context[:2], k=32, to_predict=f, eta=0.3)
        np.testing.assert_allclose(avg, a_ref, rtol=1e-6)
        np.testing.assert_allclose(std, s_ref, rtol=1e-6)
        sm_ref = obj.conditional_smile(x_context[:2], k=32, Ts=Ts, Ms=Ms,
                                       eta=0.5)
        assert len(smiles) == 2
        for s, sr in zip(smiles, sm_ref):
            np.testing.assert_allclose(s.prices, sr.prices, rtol=1e-6)
            np.testing.assert_array_equal(np.isfinite(s.vols),
                                          np.isfinite(sr.vols))


class TestCertificationFallback:
    def test_shadow_redo_path(self, small_problem, monkeypatch):
        """Deferred certification in shadow(): force every tournament to
        fail; the redo closure must still return the exact answer."""
        from shadowing_tpu.shadow import engine as eng

        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        d_ref, p_ref, i_ref = obj.shadow(x_context, k=32)

        orig = eng._fused_search

        def forced(*a, **kw):
            kw["cap"] = 1
            return orig(*a, **kw)

        monkeypatch.setattr(eng, "_fused_search", forced)
        obj2 = PathShadowing(Identity(24), RelativeMSE(), dataset,
                             PredictionContext(horizon=16))
        d, p, i = obj2.shadow(x_context, k=32, method="fused")
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(d, d_ref, rtol=1e-6)

    def test_predict_redo_path(self, small_problem, monkeypatch):
        from shadowing_tpu.shadow import engine as eng
        from shadowing_tpu.stats.realized import realized_variance

        dataset, x_context = small_problem
        f = lambda p: realized_variance(p[:, :, 0, :], Ts=[4, 8], vol=False)
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        a_ref, s_ref = obj.predict(x_context, k=16, to_predict=f, eta=0.3,
                                   method="fused")

        orig = eng._fused_search

        def forced(*a, **kw):
            kw["cap"] = 1
            return orig(*a, **kw)

        monkeypatch.setattr(eng, "_fused_search", forced)
        obj2 = PathShadowing(Identity(24), RelativeMSE(), dataset,
                             PredictionContext(horizon=16))
        a, s = obj2.predict(x_context, k=16, to_predict=f, eta=0.3,
                            method="fused")
        np.testing.assert_allclose(a, a_ref, rtol=1e-6)
        np.testing.assert_allclose(s, s_ref, rtol=1e-5)

    def test_tiny_cap_falls_back_to_exact(self, small_problem):
        """Force the tournament certification to fail (cap of 1 block): the
        engine must detect it and still return the exact answer."""
        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        d_ref, p_ref, i_ref = obj.shadow(x_context, k=32)
        d, p, i = obj.shadow_device(x_context, k=32, method="fused",
                                    tournament_cap=1)
        np.testing.assert_array_equal(np.asarray(i), i_ref)
        np.testing.assert_allclose(np.asarray(d), d_ref, rtol=1e-6)


class TestImputationSelectionParity:
    def test_fused_equals_direct_with_gapped_identity(self, rng):
        """Regression (code review): the diagonal window-norm fast path must
        account for the imputation gap's zero taps — fused and direct
        selection were returning different neighbors."""
        dataset = rng.normal(0, 1, size=(48, 1, 200)).astype(np.float32)
        ctx = ImputationContext((8, 6, 8))
        x_context = rng.normal(0, 1, size=(3, 1, 16)).astype(np.float32)
        obj_f = PathShadowing(Identity(16), RelativeMSE(), dataset, ctx)
        obj_d = PathShadowing(Identity(16), RelativeMSE(), dataset, ctx)
        df, _, i_f = obj_f.shadow(x_context, k=12, method="fused")
        dd, _, i_d = obj_d.shadow(x_context, k=12, method="direct")
        np.testing.assert_array_equal(i_f, i_d)
        np.testing.assert_allclose(df, dd, rtol=1e-6)


class TestF64Rescore:
    def test_distances_match_f64_oracle(self, small_problem):
        """BASELINE parity row: exact_dtype='float64' winner distances match
        the float64 brute-force oracle to <= 1e-6 relative (in fact ~1e-15:
        the rescore performs the oracle computation on the winners)."""
        dataset, x_context = small_problem
        horizon = 16
        emb = Identity(24)
        obj = PathShadowing(emb, RelativeMSE(), dataset,
                            PredictionContext(horizon=horizon))
        k = 50
        d, paths, idces = obj.shadow(x_context, k=k, exact_dtype="float64")
        assert d.dtype == np.float64
        assert (np.diff(d, axis=1) >= 0).all()

        n_out = 256 - 24 - horizon + 1
        ed, ei, full = oracle_search(
            x_context, dataset, emb.kernel, n_out, k, return_full=True
        )
        flat = idces[..., 0].astype(np.int64) * n_out + idces[..., 1]
        # value at every returned index == the oracle's value there, f64-exact
        np.testing.assert_allclose(
            np.take_along_axis(full, flat, axis=1), d, rtol=1e-12
        )
        # rank-for-rank parity vs the oracle at the target precision
        np.testing.assert_allclose(d, ed, rtol=1e-6)
        # paths must follow the f64 sort order
        w = 24
        for b in (0, 3):
            r, t0 = idces[b, 0]
            np.testing.assert_array_equal(
                paths[b, 0], dataset[r, :, t0 : t0 + w + horizon]
            )

    def test_bad_exact_dtype(self, small_problem):
        dataset, x_context = small_problem
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=16))
        with pytest.raises(ValueError, match="exact_dtype"):
            obj.shadow(x_context, k=4, exact_dtype="bf16")


class TestPredictPadding:
    def test_remainder_contexts_pad_and_mask(self, rng):
        """B not divisible by the context chunk: results equal the unchunked
        call and only ONE program shape is traced (pad-and-mask)."""
        dataset = rng.normal(0, 0.02, size=(32, 1, 256)).astype(np.float32)
        ctx = rng.normal(0, 0.02, size=(7, 1, 24)).astype(np.float32)
        obj = PathShadowing(Identity(24), RelativeMSE(), dataset,
                            PredictionContext(horizon=8))
        to_pred = lambda x: realized_variance(x[:, :, 0, :], Ts=[2, 4],
                                              vol=False)
        a1, s1 = obj.predict(ctx, k=8, to_predict=to_pred, eta=0.1,
                             n_context_splits=1)
        a3, s3 = obj.predict(ctx, k=8, to_predict=to_pred, eta=0.1,
                             n_context_splits=3)  # chunk=3: 3+3+pad(2)
        assert a3.shape == (7, 2)
        np.testing.assert_allclose(a3, a1, rtol=1e-6)
        np.testing.assert_allclose(s3, s1, rtol=1e-5, atol=1e-8)


class TestNTrajectoriesSingleDevice:
    """Explicit n_trajectories below the stored row count must exclude the
    excess rows on every single-device method (not only on the mesh)."""

    def test_excess_rows_never_win(self, rng):
        dataset = rng.normal(0, 0.02, size=(64, 1, 128)).astype(np.float32)
        # contexts copied verbatim from EXCLUDED rows: they would win with
        # distance ~0 if the row mask leaked
        ctx = dataset[50:52, :, 10:26].copy()
        obj = PathShadowing(Identity(16), RelativeMSE(), dataset,
                            PredictionContext(horizon=8), n_trajectories=40)
        ref = PathShadowing(Identity(16), RelativeMSE(), dataset[:40],
                            PredictionContext(horizon=8))
        for method in ("fused", "direct"):
            d, p, i = obj.shadow(ctx, k=8, method=method)
            assert (i[..., 0] < 40).all()
            d0, p0, i0 = ref.shadow(ctx, k=8, method=method)
            np.testing.assert_array_equal(i, i0)
            np.testing.assert_array_equal(d, d0)
            np.testing.assert_array_equal(p, p0)


class TestShadowShardedRows:
    """Int32-overflow escape hatch: several row-slice engines searched as
    one dataset."""

    def test_matches_single_engine(self, rng):
        from shadowing_tpu.shadow.engine import shadow_sharded_rows

        dataset = rng.normal(0, 0.02, size=(60, 1, 128)).astype(np.float32)
        ctx = rng.normal(0, 0.02, size=(2, 1, 16)).astype(np.float32)
        mk = lambda ds: PathShadowing(Identity(16), RelativeMSE(), ds,
                                      PredictionContext(horizon=8))
        d0, p0, i0 = mk(dataset).shadow(ctx, k=20)
        d, p, i = shadow_sharded_rows(
            [mk(dataset[:25]), mk(dataset[25:40]), mk(dataset[40:])],
            ctx, k=20,
        )
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(p, p0)

    def test_overflow_error_names_a_working_helper(self, rng, monkeypatch):
        """At the (mocked) int32 boundary the engine's error points at
        shadow_sharded_rows, and following that advice works."""
        import shadowing_tpu.shadow.engine as eng_mod

        dataset = rng.normal(0, 0.02, size=(60, 1, 128)).astype(np.float32)
        ctx = rng.normal(0, 0.02, size=(1, 1, 16)).astype(np.float32)
        mk = lambda ds: PathShadowing(Identity(16), RelativeMSE(), ds,
                                      PredictionContext(horizon=8))
        n_out = mk(dataset)._plan()[1]
        # 60 rows overflow the mocked limit; 30-row slices do not
        monkeypatch.setattr(eng_mod, "_INT32_LIMIT", 40 * n_out)
        with pytest.raises(ValueError, match="shadow_sharded_rows"):
            mk(dataset).shadow(ctx, k=4)
        d, p, i = eng_mod.shadow_sharded_rows(
            [mk(dataset[:30]), mk(dataset[30:])], ctx, k=4
        )
        monkeypatch.setattr(eng_mod, "_INT32_LIMIT",
                            np.iinfo(np.int32).max)
        d0, p0, i0 = mk(dataset).shadow(ctx, k=4)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(d, d0)


class TestRowsWindowSlice:
    """Direct unit tests of the extraction kernel: both strategies
    (one-hot shift for w_extract <= 128, whole-row gather beyond) must be
    bit-exact against numpy slicing, including odd T (block padding), the
    last addressable start, and block-boundary-crossing windows."""

    @pytest.mark.parametrize("C,T,we", [
        (1, 256, 40),     # aligned T, one-hot strategy
        (1, 250, 40),     # T % 128 != 0 -> padded block view
        (2, 300, 128),    # multi-channel, widest one-hot window
        (1, 500, 200),    # wide window -> row-gather strategy
    ])
    def test_bit_exact(self, rng, C, T, we):
        from shadowing_tpu.shadow.engine import _rows_window_slice

        R = 12
        y = rng.normal(size=(R, C, T)).astype(np.float32)
        n_start = T - we + 1
        # include the extreme starts and boundary-crossers explicitly
        t0 = np.concatenate([
            np.array([0, n_start - 1, max(0, 128 - we + 1), 127]),
            rng.integers(0, n_start, size=29),
        ]).astype(np.int32)
        t0 = np.clip(t0, 0, n_start - 1)
        traj = rng.integers(0, R, size=t0.shape[0]).astype(np.int32)
        import jax.numpy as jnp

        got = np.asarray(_rows_window_slice(
            jnp.asarray(y), jnp.asarray(traj), jnp.asarray(t0), we))
        want = np.stack([y[r, :, s:s + we] for r, s in zip(traj, t0)])
        np.testing.assert_array_equal(got, want)


class TestLastMetrics:
    """Every public entry point records sync-free structured metrics
    (entry, wall, resolved route/splits, redo count) in ``last_metrics``."""

    def test_shadow_and_predict_record(self, rng):
        dataset = rng.normal(0, 0.02, size=(32, 1, 200)).astype(np.float32)
        ctx = dataset[:3, :, 40:60]
        obj = PathShadowing(Identity(20), RelativeMSE(), dataset,
                            PredictionContext(horizon=10))
        assert obj.last_metrics == {}
        obj.shadow(ctx, k=8)
        m = obj.last_metrics
        assert m["entry"] == "shadow"
        assert m["B"] == 3 and m["k"] == 8
        assert m["method"] in ("factored", "fused", "direct")
        assert m["n_splits"] >= 1 and m["wall_s"] > 0
        assert m["redo_contexts"] == 0 and m["mesh"] is None

        obj.predict(ctx, k=8, to_predict=lambda p: realized_variance(p, [10]),
                    eta=0.3, n_context_splits=3)
        m = obj.last_metrics
        assert m["entry"] == "predict"
        assert m["B"] == 3 and m["n_context_chunks"] == 3


class TestChannelMismatch:
    def test_eager_error_names_the_shapes(self, rng):
        """A single-channel embedding against a multi-channel dataset must
        raise an eager, named ValueError — not a conv feature-dimension
        error from inside jit (found by fuzzing)."""
        dataset = rng.normal(0, 0.02, size=(16, 2, 128)).astype(np.float32)
        obj = PathShadowing(Identity(12), RelativeMSE(), dataset,
                            PredictionContext(horizon=8))
        ctx = rng.normal(0, 0.02, size=(1, 2, 12)).astype(np.float32)
        with pytest.raises(ValueError, match="channel"):
            obj.shadow(ctx, k=4)
