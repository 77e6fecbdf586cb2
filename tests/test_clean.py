"""clean package tests: noise masks vs brute-force oracles."""

import numpy as np
import pytest

import echopype_tpu as ep
from echopype_tpu.utils.compute import _lin2log, _log2lin
from echopype_tpu.xrlite import DataArray, Dataset


def make_sv(n_ch=1, n_ping=40, n_r=60, seed=0, dr=1.0, base=-80.0):
    rng = np.random.default_rng(seed)
    sv = rng.normal(base, 3, (n_ch, n_ping, n_r)).astype("f8")
    depth = np.broadcast_to(np.arange(n_r) * dr, (n_ch, n_ping, n_r)).copy()
    ds = Dataset(
        {
            "Sv": (("channel", "ping_time", "range_sample"), sv),
            "echo_range": (("channel", "ping_time", "range_sample"), depth.copy()),
            "depth": (("channel", "ping_time", "range_sample"), depth),
            "sound_absorption": (("channel",), np.full(n_ch, 0.001)),
            "frequency_nominal": (("channel",), 38000.0 * (1 + np.arange(n_ch))),
        },
        coords={
            "channel": np.array([f"ch{i}" for i in range(n_ch)], dtype=object),
            "ping_time": np.datetime64("2020-01-01", "ns")
            + np.arange(n_ping) * np.timedelta64(1, "s"),
            "range_sample": np.arange(n_r),
        },
    )
    return ds


def brute_force_pool(sv, depth, depth_bin, W, exclude_above):
    """Direct re-statement of the reference pool_Sv loop (utils.py:29-106)."""
    C, P, R = sv.shape
    out = np.full((C, P, R), np.nan)
    for c in range(C):
        d_min, d_max = np.nanmin(depth[c]), np.nanmax(depth[c])
        for r in range(R):
            for p in range(P):
                d = depth[c, p, r]
                if (
                    (d - depth_bin >= d_min)
                    and (d + depth_bin <= d_max)
                    and (d - depth_bin >= exclude_above)
                    and (p - W >= 0)
                    and (p + W <= P)
                ):
                    wm = (
                        (depth[c] >= d - depth_bin)
                        & (depth[c] <= d + depth_bin)
                        & (np.abs(np.arange(P))[:, None] >= 0)
                    )
                    pw = (np.abs(np.arange(P) - p) <= W)[:, None]
                    vals = np.where(wm & pw, _log2lin(sv[c]), np.nan)
                    out[c, p, r] = _lin2log(np.nanmean(vals))
    return out


class TestTransient:
    def test_pool_matches_bruteforce(self):
        ds = make_sv(n_ping=15, n_r=20)
        from echopype_tpu.clean.utils import pool_Sv_nanmean

        sv = ds["Sv"].values
        depth = ds["depth"].values
        pooled = pool_Sv_nanmean(sv, depth, depth_bin=3.0, num_side_pings=4, exclude_above=0.0)
        expected = brute_force_pool(sv, depth, 3.0, 4, 0.0)
        # the pooling runs on device in float32; the oracle is float64
        np.testing.assert_allclose(pooled, expected, atol=1e-4)
        np.testing.assert_array_equal(np.isnan(pooled), np.isnan(expected))

    def test_mask_detects_spike(self):
        ds = make_sv(n_ping=40, n_r=60)
        # inject a transient noise spike on ping 20 over all depths
        ds.data_vars["Sv"].values[0, 20, :] += 30.0
        mask = ep.clean.mask_transient_noise(
            ds,
            depth_bin="5m",
            num_side_pings=5,
            exclude_above="0.0m",
            transient_noise_threshold="12.0dB",
        )
        inner = mask.values[0, :, 10:50]
        assert inner[20].any()
        assert not inner[[5, 10, 30]].any()

    def test_median_path(self):
        ds = make_sv(n_ping=30, n_r=40)
        ds.data_vars["Sv"].values[0, 15, :] += 30.0
        mask = ep.clean.mask_transient_noise(
            ds, func="nanmedian", depth_bin="5m", num_side_pings=5, exclude_above="0.0m"
        )
        assert mask.values[0, 15, 10:30].any()

    def test_bad_func(self):
        ds = make_sv()
        with pytest.raises(ValueError):
            ep.clean.mask_transient_noise(ds, func="nanmax")


class TestImpulse:
    def test_detects_single_ping_spike(self):
        ds = make_sv(n_ping=30, n_r=40)
        ds.data_vars["Sv"].values[0, 12, :] += 25.0
        mask = ep.clean.mask_impulse_noise(
            ds, depth_bin="2m", num_side_pings=2, impulse_noise_threshold="10.0dB"
        )
        assert mask.values[0, 12].any()
        assert not mask.values[0, 20].any()

    def test_echopy_kernel_exact(self):
        from echopype_tpu.clean.utils import echopy_impulse_noise_mask

        sv = np.full((7, 4), -80.0)
        sv[3] = -50.0  # spike ping
        mask = echopy_impulse_noise_mask(sv, num_side_pings=1, threshold=10.0)
        assert mask[3].all()
        assert not mask[[0, 1, 5]].any()
        # edges have inf comparisons -> only flagged if the one-sided diff passes
        assert not mask[6].any()


class TestAttenuated:
    def test_detects_attenuated_ping(self):
        ds = make_sv(n_ping=40, n_r=60, base=-70.0)
        # scattering layer at 20-40 m; ping 20 strongly attenuated there
        ds.data_vars["Sv"].values[:, :, 20:40] = -55.0
        ds.data_vars["Sv"].values[0, 20, 20:40] = -75.0
        # NOTE: the criterion is (ping_median - block_median) < threshold
        # (echopy convention), so a *negative* threshold isolates attenuation.
        mask = ep.clean.mask_attenuated_signal(
            ds,
            upper_limit_sl="20.0m",
            lower_limit_sl="40.0m",
            num_side_pings=5,
            attenuation_signal_threshold="-8.0dB",
        )
        assert mask.values[0, 20].all()
        assert not mask.values[0, 10].any()

    def test_outside_range_empty(self):
        ds = make_sv(n_r=30)
        mask = ep.clean.mask_attenuated_signal(
            ds, upper_limit_sl="400.0m", lower_limit_sl="500.0m"
        )
        assert not mask.values.any()

    def test_invalid_limits(self):
        ds = make_sv()
        with pytest.raises(ValueError):
            ep.clean.mask_attenuated_signal(ds, upper_limit_sl="50.0m", lower_limit_sl="40.0m")


class TestBackgroundNoise:
    def test_noise_floor_recovered(self):
        """Uniform noise-only data: corrected Sv all NaN, noise ~= input."""
        n_ping, n_r = 40, 100
        ds = make_sv(n_ping=n_ping, n_r=n_r)
        # synthetic: pure TVG-shaped noise floor
        er = ds["echo_range"].values
        noise_db = -125.0
        sv_noise = noise_db + 20 * np.log10(np.maximum(er, 1)) + 2 * 0.001 * er
        ds.data_vars["Sv"].values[:] = sv_noise
        out = ep.clean.remove_background_noise(ds, ping_num=10, range_sample_num=10)
        assert "Sv_noise" in out and "Sv_corrected" in out
        # noise estimate should track the synthetic noise floor closely
        np.testing.assert_allclose(
            out["Sv_noise"].values[0, 5], sv_noise[0, 5], atol=1.0
        )
        # noise-only data -> everything below SNR threshold
        assert np.isnan(out["Sv_corrected"].values).mean() > 0.95

    def test_signal_preserved(self):
        n_ping, n_r = 40, 100
        ds = make_sv(n_ping=n_ping, n_r=n_r, base=-90.0)
        # strong scatterer at 30-40 m on all pings
        ds.data_vars["Sv"].values[:, :, 30:40] = -50.0
        out = ep.clean.remove_background_noise(ds, ping_num=10, range_sample_num=10)
        corrected = out["Sv_corrected"].values
        assert np.isfinite(corrected[0, :, 32:38]).all()
        np.testing.assert_allclose(corrected[0, :, 32:38], -50.0, atol=0.5)

    def test_noise_max_cap(self):
        ds = make_sv(n_ping=20, n_r=50, base=-60.0)
        est_capped = ep.clean.estimate_background_noise(
            ds, ping_num=5, range_sample_num=5, background_noise_max="-125.0dB"
        )
        er = ds["echo_range"].values
        tvg = 20 * np.log10(np.maximum(er, 1)) + 2 * 0.001 * er
        assert np.all(est_capped.values - tvg <= -125.0 + 1e-9)

    def test_processing_level(self):
        ds = make_sv()
        ds.attrs["processing_level"] = "Level 2A"
        out = ep.clean.remove_background_noise(ds, ping_num=10, range_sample_num=10)
        # no lat/lon on the output -> stamp withheld; the inherited input
        # attr rides along unchanged (reference gating leaves it stale too)
        assert out.attrs["processing_level"] == "Level 2A"
        n_ping = ds.sizes["ping_time"]
        ds["latitude"] = (("ping_time",), 45.0 + np.arange(n_ping) * 1e-4)
        ds["longitude"] = (("ping_time",), -125.0 + np.arange(n_ping) * 1e-4)
        out = ep.clean.remove_background_noise(ds, ping_num=10, range_sample_num=10)
        assert out.attrs["processing_level"] == "Level 2B"


class TestDetectTransient:
    def _deep_ds(self):
        # 1200 m deep echogram with quiet deep water
        ds = make_sv(n_ping=80, n_r=120, dr=10.0, base=-85.0)
        return ds

    def test_fielding_flags_transient(self):
        ds = self._deep_ds()
        ds.data_vars["Sv"].values[0, 40, :] += 20.0  # loud transient ping
        mask = ep.clean.detect_transient(
            ds, method="fielding", params={"r0": 900, "r1": 1000, "n": 10, "roff": 20}
        )
        assert mask.name == "fielding_mask_valid"
        # True = VALID; the transient ping should have False somewhere
        assert (~mask.values[0, 40]).any()
        assert mask.values[0, 10].all()

    def test_matecho_flags_transient(self):
        ds = self._deep_ds()
        ds.data_vars["Sv"].values[0, 40, :] += 25.0
        mask = ep.clean.detect_transient(
            ds,
            method="matecho",
            params={"start_depth": 220, "window_meter": 450, "window_ping": 20, "delta_db": 12},
        )
        assert mask.name == "matecho_mask_valid"
        assert (~mask.values[0, :, 0])[40]
        assert mask.values[0, 10].all()

    def test_unknown_method(self):
        ds = self._deep_ds()
        with pytest.raises(ValueError):
            ep.clean.detect_transient(ds, method="ryan")


class TestGridFastPath:
    """Band-matmul fast path (ping-invariant grid) vs the gather kernel."""

    def test_pool_grid_matches_gather(self):
        ds = make_sv(n_ch=2, n_ping=25, n_r=30)
        from echopype_tpu.clean.utils import uniform_grid
        from echopype_tpu.ops.windows import (
            pool_sv_nanmean_device,
            pool_sv_nanmean_grid_device,
        )

        sv = ds["Sv"].values.astype("f4")
        depth = ds["depth"].values.astype("f4")
        grid = uniform_grid(depth)
        assert grid is not None
        a = np.asarray(pool_sv_nanmean_grid_device(sv, grid.astype("f4"), 3.0, 4, 2.0))
        b = np.asarray(pool_sv_nanmean_device(sv, depth, 3.0, 4, 2.0))
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))

    def test_pool_grid_with_nan_suffix(self):
        ds = make_sv(n_ch=1, n_ping=20, n_r=24)
        sv = ds["Sv"].values.astype("f4")
        depth = ds["depth"].values.astype("f4")
        sv[:, :, -4:] = np.nan
        depth[:, :, -4:] = np.nan
        from echopype_tpu.ops.windows import (
            pool_sv_nanmean_device,
            pool_sv_nanmean_grid_device,
        )

        a = np.asarray(pool_sv_nanmean_grid_device(sv, depth[:, 0], 3.0, 3, 0.0))
        b = np.asarray(pool_sv_nanmean_device(sv, depth, 3.0, 3, 0.0))
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))

    def test_ping_varying_depth_falls_back(self):
        from echopype_tpu.clean.utils import uniform_grid

        depth = np.broadcast_to(np.arange(10.0), (1, 5, 10)).copy()
        depth[0, 3] += 0.5  # heave: one ping's grid shifted
        assert uniform_grid(depth) is None
        ds = make_sv(n_ping=5, n_r=10)
        ds.data_vars["depth"].values[0, 3] += 0.5
        mask = ep.clean.mask_transient_noise(ds, depth_bin="2m", num_side_pings=1,
                                             exclude_above="0.0m")
        assert mask.values.shape == (1, 5, 10)

    def test_impulse_grid_matches_host_kernel(self):
        ds = make_sv(n_ch=2, n_ping=30, n_r=41)  # odd R exercises bit-pad
        ds.data_vars["Sv"].values[0, 12, :] += 25.0
        from echopype_tpu.clean import utils as cu
        from echopype_tpu.ops.windows import impulse_mask_grid_device

        sv = ds["Sv"].values
        depth = ds["depth"].values
        down, up, _ = cu.downsample_upsample_along_depth(sv, depth, 2.0)
        host = np.stack([cu.echopy_impulse_noise_mask(up[c], 2, 10.0) for c in range(2)])

        grid = cu.uniform_grid(depth)
        d_min, d_max = np.nanmin(depth), np.nanmax(depth)
        edges = np.arange(d_min, d_max + 2.0, 2.0)
        n_b = max(len(edges) - 1, 1)
        idx = np.clip(np.digitize(grid, edges) - 1, 0, n_b - 1).astype("i4")
        dev = np.asarray(impulse_mask_grid_device(sv.astype("f4"), idx, int(n_b), 2, 10.0))
        np.testing.assert_array_equal(dev, host)

    def test_pack_mask_roundtrip(self):
        from echopype_tpu.ops.windows import pack_mask_device

        rng = np.random.default_rng(3)
        m = rng.random((2, 5, 21)) > 0.5  # non-multiple-of-8 last dim
        packed = np.asarray(pack_mask_device(m))
        un = np.unpackbits(packed, axis=-1, count=21).astype(bool)
        np.testing.assert_array_equal(un, m)

    def test_downsample_grid_matches_gather(self):
        ds = make_sv(n_ch=2, n_ping=15, n_r=30)
        from echopype_tpu.clean import utils as cu

        sv = ds["Sv"].values
        depth = ds["depth"].values
        down_g, up_g, _ = cu.downsample_upsample_along_depth(sv, depth, 3.0)
        # force the gather path by making depth trivially non-uniform
        depth2 = depth.copy()
        depth2[0, 0, 0] += 1e-6
        down_h, up_h, _ = cu.downsample_upsample_along_depth(sv, depth2, 3.0)
        np.testing.assert_allclose(down_g, down_h, atol=1e-4)
        np.testing.assert_allclose(up_g, up_h, atol=1e-4)

    def test_attenuated_grid_matches_host_kernel(self):
        ds = make_sv(n_ch=2, n_ping=40, n_r=60, base=-70.0)
        ds.data_vars["Sv"].values[:, :, 20:40] = -55.0
        ds.data_vars["Sv"].values[0, 20, 20:40] = -75.0
        ds.data_vars["Sv"].values[1, 7, 25:35] = np.nan
        from echopype_tpu.clean import utils as cu
        from echopype_tpu.ops.windows import attenuated_ping_mask_grid_device

        sv = ds["Sv"].values
        depth = ds["depth"].values
        host = np.stack(
            [
                cu.echopy_attenuated_signal_mask(sv[c], depth[c], 20.0, 40.0, 5, -8.0)
                for c in range(2)
            ]
        )
        grid = cu.uniform_grid(depth)
        up_idx = np.nanargmin(np.abs(grid - 20.0), axis=1).astype("i4")
        lw_idx = np.nanargmin(np.abs(grid - 40.0), axis=1).astype("i4")
        widths = np.maximum(lw_idx - up_idx, 0).astype("i4")
        dev = np.asarray(
            attenuated_ping_mask_grid_device(
                sv.astype("f4"), up_idx, widths, int(widths.max()), 5, -8.0, chunk=16
            )
        )
        np.testing.assert_array_equal(dev[:, :, None] & np.ones_like(host), host)


class TestBlockedWindowPrimitives:
    """Round-4 blocked banded pooling: primitives vs brute force at odd
    shapes (R not a tile multiple, tiny windows, halo fallback)."""

    def test_ping_window_sum_matches_brute(self, rng):
        import jax.numpy as jnp

        from echopype_tpu.ops.windows import _window_sum_ping_blocked

        for P, W in ((37, 3), (130, 0), (257, 25), (5, 9)):
            x = rng.normal(size=(2, 4, P)).astype("f4")
            got = np.asarray(_window_sum_ping_blocked(jnp.asarray(x), W))
            want = np.empty_like(x)
            for p in range(P):
                lo, hi = max(p - W, 0), min(p + W, P - 1) + 1
                want[..., p] = x[..., lo:hi].sum(axis=-1)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_blocked_range_band_matches_dense(self, rng):
        """Blocked range-window sums == dense band matmul for uniform and
        per-channel grids, including R not a multiple of the tile."""
        import jax.numpy as jnp

        from echopype_tpu.ops.windows import _pool_windows_grid, grid_window_halo

        for R, step in ((200, 0.5), (130, 0.19)):
            C, P = 2, 17
            sv = rng.normal(-70, 5, size=(C, P, R)).astype("f4")
            sv[1, :, R - 7:] = np.nan  # NaN suffix
            grid = np.stack([np.arange(R) * step, np.arange(R) * (step * 1.5)]).astype("f4")
            bin_m = 4.0
            halo = grid_window_halo(grid, bin_m)
            sw_b, nw_b = _pool_windows_grid(
                jnp.asarray(sv), jnp.asarray(grid), bin_m, 2, range_halo=halo
            )
            sw_d, nw_d = _pool_windows_grid(
                jnp.asarray(sv), jnp.asarray(grid), bin_m, 2, range_halo=0
            )
            np.testing.assert_allclose(np.asarray(sw_b), np.asarray(sw_d), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(np.asarray(nw_b), np.asarray(nw_d), rtol=0, atol=0)


class TestGridWindowHalo:
    """Round-4 review regressions: the halo must be the EXACT index extent
    (duplicate plateaus widen windows), dense fallback for unsorted grids,
    power-of-two bucketing for bounded jit specialization."""

    def test_plateau_grid_exact(self):
        import jax.numpy as jnp

        from echopype_tpu.ops.windows import _pool_windows_grid, grid_window_halo

        g = np.concatenate([np.arange(0, 60, 0.5), np.full(20, 59.5),
                            np.arange(60, 85, 0.5)]).astype("f4")[None]
        R = g.shape[1]
        rng = np.random.default_rng(0)
        sv = rng.normal(-70, 5, size=(1, 9, R)).astype("f4")
        halo = grid_window_halo(g, 2.0)
        assert halo >= 21  # plateau spans 20 duplicates + step windows
        sw_b, nw_b = _pool_windows_grid(jnp.asarray(sv), jnp.asarray(g), 2.0, 2,
                                        range_halo=halo)
        sw_d, nw_d = _pool_windows_grid(jnp.asarray(sv), jnp.asarray(g), 2.0, 2,
                                        range_halo=0)
        np.testing.assert_allclose(np.asarray(nw_b), np.asarray(nw_d), rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(sw_b), np.asarray(sw_d), rtol=1e-5, atol=1e-6)

    def test_unsorted_grid_dense_fallback(self):
        from echopype_tpu.ops.windows import grid_window_halo

        g = np.array([0.0, 1.0, 0.5, 2.0])
        assert grid_window_halo(g, 1.0) == 0

    def test_power_of_two_bucketing(self):
        from echopype_tpu.ops.windows import grid_window_halo

        h1 = grid_window_halo(np.arange(100) * 0.50, 5.0)
        h2 = grid_window_halo(np.arange(100) * 0.52, 5.0)
        assert h1 == h2  # nearby spacings share one jit specialization
        assert h1 & (h1 - 1) == 0  # power of two

    def test_interior_nan_grid_halo_counts_raw_samples(self):
        # A grid with interior NaN holes: window members sit further apart in
        # RAW sample indices than in the NaN-compacted array — the halo must
        # cover raw distances or the banded path silently drops members.
        import jax.numpy as jnp

        from echopype_tpu.ops.windows import _pool_windows_grid, grid_window_halo

        row = np.full(200, np.nan, dtype="f8")
        row[::3] = np.arange(0, 200, 3) * (0.2 / 3)
        halo = grid_window_halo(row[None, :], 0.45)
        assert halo >= 6  # +-2 finite neighbors = +-6 raw samples
        rng = np.random.default_rng(0)
        sv = rng.normal(-70, 5, size=(1, 8, 200)).astype("f4")
        g = jnp.asarray(row[None, :].astype("f4"))
        s_h, c_h = _pool_windows_grid(jnp.asarray(sv), g, 0.45, 2, range_halo=halo)
        s_d, c_d = _pool_windows_grid(jnp.asarray(sv), g, 0.45, 2, range_halo=0)
        np.testing.assert_array_equal(np.asarray(c_h), np.asarray(c_d))
        np.testing.assert_allclose(np.asarray(s_h), np.asarray(s_d), rtol=1e-5, atol=1e-5)


class TestReopenPolicy:
    def test_user_callable_called_once_by_default(self, rng):
        from echopype_tpu.parallel import run_survey_mvbs
        from echopype_tpu.xrlite import Dataset

        calls = {"n": 0}

        def make_ds():
            calls["n"] += 1
            ds = Dataset(
                coords={
                    "channel": np.asarray(["c1"], dtype=object),
                    "ping_time": np.arange(8).astype("datetime64[s]").astype("datetime64[ns]"),
                    "range_sample": np.arange(10),
                }
            )
            ds["Sv"] = (("channel", "ping_time", "range_sample"),
                        rng.normal(-70, 5, (1, 8, 10)).astype("f4"))
            ds["echo_range"] = (("channel", "ping_time", "range_sample"),
                                np.broadcast_to(np.arange(10, dtype="f4") * 0.5, (1, 8, 10)).copy())
            return ds

        run_survey_mvbs([make_ds], range_bin_m=2.0, ping_time_bin="4s", chunk_pings=4)
        assert calls["n"] == 1  # callables are not silently invoked twice
