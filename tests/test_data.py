"""Data layer: PriceData conversions, windows, datasets, bundled SPDaily."""
import numpy as np
import pytest

from shadowing_tpu import (
    PriceData,
    SPDaily,
    TimeSeriesDataset,
    batch_npy_files,
    windows,
)


class TestPriceData:
    def test_from_dlnx_anchors_first_price(self, rng):
        dlnx = rng.normal(0, 0.02, size=(4, 100))
        pd_ = PriceData(dlnx=dlnx, x_init=100.0)
        assert pd_.x.shape == (4, 101)
        np.testing.assert_allclose(pd_.x[:, 0], 100.0)
        np.testing.assert_allclose(pd_.dlnx, dlnx, rtol=1e-9)

    def test_lnx_rescaled(self, rng):
        lnx = np.cumsum(rng.normal(0, 0.02, size=(3, 50)), axis=-1) + 5.0
        pd_ = PriceData(lnx=lnx, x_init=100.0)
        np.testing.assert_allclose(pd_.x[:, 0], 100.0)
        np.testing.assert_allclose(np.diff(lnx, axis=-1), pd_.dlnx, rtol=1e-9)

    def test_representations_consistent(self, rng):
        x = np.exp(np.cumsum(rng.normal(0, 0.01, size=80))) * 50
        pd_ = PriceData(x=x)
        np.testing.assert_allclose(pd_.dx, np.diff(x), rtol=1e-9)
        np.testing.assert_allclose(pd_.lnx, np.log(x), rtol=1e-9)
        np.testing.assert_allclose(np.exp(pd_.lnx), pd_.x, rtol=1e-9)

    def test_exactly_one_representation(self):
        with pytest.raises(ValueError):
            PriceData(x=np.ones(5), dlnx=np.zeros(4))
        with pytest.raises(ValueError):
            PriceData()


class TestWindows:
    def test_shape_and_content(self, rng):
        x = rng.normal(size=(2, 3, 50))
        w = windows(x, w=10, s=5)
        assert w.shape == (2, 3, 9, 10)
        np.testing.assert_array_equal(w[..., 0, :], x[..., 0:10])
        np.testing.assert_array_equal(w[..., 1, :], x[..., 5:15])

    def test_offset(self):
        x = np.arange(20)
        w = windows(x, w=4, s=4, offset=2)
        np.testing.assert_array_equal(w[0], [2, 3, 4, 5])

    def test_jax_matches_numpy(self, rng):
        import jax.numpy as jnp

        x = rng.normal(size=(2, 31))
        a = windows(x, w=7, s=3)
        b = np.asarray(windows(jnp.asarray(x), w=7, s=3))
        np.testing.assert_allclose(a, b, rtol=1e-6)


class TestDataset:
    def test_shard_roundtrip(self, tmp_path, rng):
        parts = [rng.normal(size=(8, 1, 32)).astype(np.float32) for _ in range(3)]
        for i, p in enumerate(parts):
            np.save(tmp_path / f"shard{i}.npy", p)
        ds = TimeSeriesDataset(tmp_path, R=20).load()
        assert ds.shape == (20, 1, 32)
        np.testing.assert_array_equal(ds[:8], parts[0])

    def test_2d_shards_get_channel_axis(self, tmp_path, rng):
        np.save(tmp_path / "a.npy", rng.normal(size=(4, 16)).astype(np.float32))
        ds = TimeSeriesDataset(tmp_path).load()
        assert ds.shape == (4, 1, 16)

    def test_batching(self, tmp_path, rng):
        src = tmp_path / "src"
        src.mkdir()
        for i in range(5):
            np.save(src / f"t{i:03d}.npy", rng.normal(size=(1, 1, 8)))
        out = batch_npy_files(src, 2, tmp_path / "dst")
        assert [p.name for p in out] == ["batch0001.npy", "batch0002.npy", "batch0003.npy"]
        assert np.load(out[0]).shape == (2, 1, 8)
        assert np.load(out[2]).shape == (1, 1, 8)


class TestSPDaily:
    def test_loads_and_filters(self):
        snp = SPDaily()
        assert snp.dlnx.shape[0] == 1 and snp.dlnx.shape[1] == 1
        assert snp.dlnx.shape[-1] > 5000
        assert len(snp.dts) == snp.dlnx.shape[-1]

        sub = SPDaily(start="03-01-2000", end="31-12-2014")
        assert sub.dts.dtype == np.dtype("datetime64[D]")
        assert sub.dts[0].astype("datetime64[Y]") == np.datetime64("2000")
        assert sub.dts[-1].astype("datetime64[Y]") == np.datetime64("2014")
        # day-first parsing: 03-01-2000 is January 3rd
        assert sub.dts[0].astype("datetime64[M]") == np.datetime64("2000-01")

    def test_realistic_scale(self):
        snp = SPDaily()
        ann_vol = snp.dlnx.std() * np.sqrt(252)
        assert 0.1 < ann_vol < 0.4


class TestIngestPrices:
    """CSV -> snp_daily.npz -> SPDaily(path=...) -> generate: the turnkey
    real-data seam (a user with the actual S&P csv reproduces the reference
    workflow, snp_generation.py:32 semantics, in one command)."""

    def _write_csv(self, tmp_path, rng, n=300, start="1999-12-20"):
        import pandas as pd

        dts = pd.bdate_range(start, periods=n)
        x = 1300.0 * np.exp(np.cumsum(rng.normal(0.0002, 0.01, size=n)))
        csv = tmp_path / "prices.csv"
        pd.DataFrame({"Date": dts.strftime("%Y-%m-%d"), "Close": x}).to_csv(
            csv, index=False
        )
        return csv, dts, x

    def test_roundtrip_and_date_conventions(self, tmp_path, rng):
        from shadowing_tpu.cli.ingest_prices import ingest_csv

        csv, dts, x = self._write_csv(tmp_path, rng)
        out = ingest_csv(csv, tmp_path / "snp.npz")  # case-insensitive cols

        snp = SPDaily(path=out)
        # returns anchor at the first price; dates are the RETURN dates
        np.testing.assert_allclose(
            np.ravel(snp.dlnx), np.diff(np.log(x)), rtol=1e-9, atol=1e-12
        )
        np.testing.assert_allclose(np.ravel(snp.x)[0], x[0], rtol=1e-9)
        assert (snp.dts == dts[1:]).all()

        # the reference's exact day-first filtering convention
        sub = SPDaily(start="03-01-2000", end="31-12-2014", path=out)
        assert sub.dts[0] >= np.datetime64("2000-01-03")
        assert (np.ravel(sub.dlnx) == np.ravel(snp.dlnx)[-len(sub.dts):]).all()

    def test_feeds_generate_target_estimation(self, tmp_path, rng):
        from shadowing_tpu import generate
        from shadowing_tpu.cli.ingest_prices import ingest_csv

        csv, _, _ = self._write_csv(tmp_path, rng, n=260)
        out = ingest_csv(csv, tmp_path / "snp.npz")
        snp = SPDaily(start="03-01-2000", path=out)
        paths = generate(snp, R=2, J=4, T=256, max_iterations=8,
                         tol_optim=0.5)
        assert paths.shape == (2, 1, 256)
        assert np.isfinite(paths).all()
        # output rescaled to the observed series' mean/std scale
        assert 0.3 < paths.std() / np.ravel(snp.dlnx).std() < 3.0

    def test_rejects_bad_input(self, tmp_path, rng):
        import pandas as pd

        from shadowing_tpu.cli.ingest_prices import ingest_csv

        csv, dts, x = self._write_csv(tmp_path, rng, n=10)
        with pytest.raises(ValueError, match="not in CSV"):
            ingest_csv(csv, tmp_path / "o.npz", close_col="px")

        dup = pd.read_csv(csv)
        pd.concat([dup, dup.iloc[[3]]]).to_csv(tmp_path / "dup.csv",
                                               index=False)
        with pytest.raises(ValueError, match="duplicate dates"):
            ingest_csv(tmp_path / "dup.csv", tmp_path / "o.npz")

        bad = pd.read_csv(csv)
        bad.loc[4, "Close"] = -3.0
        bad.to_csv(tmp_path / "neg.csv", index=False)
        with pytest.raises(ValueError, match="non-positive"):
            ingest_csv(tmp_path / "neg.csv", tmp_path / "o.npz")

    def test_unsorted_csv_is_sorted(self, tmp_path, rng):
        import pandas as pd

        from shadowing_tpu.cli.ingest_prices import ingest_csv

        csv, dts, x = self._write_csv(tmp_path, rng, n=50)
        df = pd.read_csv(csv).sample(frac=1.0, random_state=0)
        df.to_csv(tmp_path / "shuf.csv", index=False)
        a = np.load(ingest_csv(csv, tmp_path / "a.npz"))
        b = np.load(ingest_csv(tmp_path / "shuf.csv", tmp_path / "b.npz"))
        np.testing.assert_array_equal(a["dlnx"], b["dlnx"])
        np.testing.assert_array_equal(a["days"], b["days"])
