"""EK80 calibration tests: matched filter vs scipy oracle, CW/BB Sv formulas."""

import numpy as np
import pytest
from scipy import signal

import echopype_tpu as ep
from echopype_tpu.calibrate import ek80_complex as ekc

from synth_ek80 import CH_BB, CH_CW, CH_PW, write_ek80_raw


@pytest.fixture(scope="module")
def ek80_ed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ek80cal")
    path = tmp / "E80-D20210201-T000000.raw"
    truth = write_ek80_raw(path, n_pings=5, n_samples=128)
    ed = ep.open_raw(path, sonar_model="EK80")
    return ed, truth


class TestChirp:
    def test_tapered_chirp_properties(self):
        y, t = ekc.tapered_chirp(
            fs=1500000, transmit_duration_nominal=1.024e-3, slope=0.0078125,
            transmit_frequency_start=50000.0, transmit_frequency_stop=90000.0,
        )
        assert len(y) == int(np.floor(1.024e-3 * np.float32(1500000)))
        assert np.max(np.abs(y)) == 1.0  # normalized
        # taper: endpoints small, middle untapered
        assert abs(y[0]) < 0.05
        assert np.max(np.abs(y[len(y) // 2 - 50 : len(y) // 2 + 50])) > 0.9

    def test_filter_decimate(self):
        y, _ = ekc.tapered_chirp(1500000, 1.024e-3, 0.0078125, 50000.0, 90000.0)
        coeff = {
            "wbt_fil": np.full(4, 0.25, dtype="c8"),
            "pc_fil": np.full(2, 0.5, dtype="c8"),
            "wbt_decifac": 6,
            "pc_decifac": 1,
        }
        y2, t2 = ekc.filter_decimate_chirp(coeff, y, 1500000.0)
        # length: conv(len 1536+3) decimated by 6 -> ~257, then conv +1
        assert 250 < len(y2) < 262
        np.testing.assert_allclose(t2[1] - t2[0], 6 / 1500000.0)


class TestMatchedFilter:
    def test_matched_filter_matches_scipy(self):
        """Matched filter == time-domain convolve + truncation."""
        rng = np.random.default_rng(0)
        P, R, B, L = 3, 200, 4, 37
        bs = rng.normal(size=(P, R, B)) + 1j * rng.normal(size=(P, R, B))
        bs[0, 190:, :] = np.nan  # NaN tail
        replica = rng.normal(size=L) + 1j * rng.normal(size=L)

        from echopype_tpu.ops.matched_filter import pulse_compress_channel

        out = pulse_compress_channel(bs.astype("complex128"), replica)

        rep_flip = np.flipud(np.conj(replica))
        for p in range(P):
            for b in range(B):
                x = np.nan_to_num(bs[p, :, b])
                expected = signal.convolve(x, rep_flip, mode="full")[L - 1 :][:R]
                got = out[p, :, b]
                mask = ~np.isnan(got.real)
                np.testing.assert_allclose(got[mask], expected[mask], rtol=1e-4, atol=1e-6)
        # NaN positions restored
        assert np.isnan(out[0, 195, 0].real)

    def test_delay_peak(self):
        """A delayed replica in the data produces the matched-filter peak at the delay."""
        y, _ = ekc.tapered_chirp(1500000, 256e-6, 0.0078125, 50000.0, 90000.0)
        coeff = {
            "wbt_fil": np.full(4, 0.25, dtype="c8"),
            "pc_fil": np.full(2, 0.5, dtype="c8"),
            "wbt_decifac": 6,
            "pc_decifac": 1,
        }
        rep, _ = ekc.filter_decimate_chirp(coeff, y, 1500000.0)
        R = 400
        delay = 150
        bs = np.zeros((1, R, 1), dtype="complex128")
        bs[0, delay : delay + len(rep), 0] = rep
        from echopype_tpu.ops.matched_filter import pulse_compress_channel

        out = np.abs(pulse_compress_channel(bs, rep))[0, :, 0]
        # the reference truncation [L-1:] places the correlation peak exactly
        # at the sample where the echo starts
        assert abs(int(np.argmax(out)) - delay) <= 1


class TestTauEffective:
    def test_cw_tau(self):
        """CW: square-ish pulse -> tau_eff ~ energy / (peak * fs)."""
        ytx = {"ch1": np.ones(100, dtype="c8")}
        fs = {"ch1": 10000.0}
        from echopype_tpu.xrlite import DataArray

        tau = ekc.get_tau_effective(
            ytx, fs, "CW", DataArray(np.array(["ch1"], dtype=object), ("channel",)), None
        )
        np.testing.assert_allclose(tau.values, [100 / 10000.0])


class TestComputeSvEK80:
    def test_bb_complex_runs(self, ek80_ed):
        ed, truth = ek80_ed
        ds = ep.calibrate.compute_Sv(ed, waveform_mode="BB", encode_mode="complex")
        assert "Sv" in ds
        sv = ds["Sv"].values
        assert sv.shape[0] == 1  # one BB channel
        assert np.isfinite(sv).any()
        assert "tau_effective" in ds
        # BB gain interpolated at fc=70 kHz from cal curve [26..28] at 45..90kHz
        gain = ds["gain_correction"].values
        expected_gain = np.interp(70000.0, np.linspace(45000, 90000, 10),
                                  np.linspace(26.0, 28.0, 10))
        np.testing.assert_allclose(gain, expected_gain, atol=1e-6)

    def test_cw_complex_oracle(self, ek80_ed):
        """CW complex Sv matches a direct float64 oracle."""
        ed, truth = ek80_ed
        ds = ep.calibrate.compute_Sv(ed, waveform_mode="CW", encode_mode="complex")
        sv = ds["Sv"].values  # [1, P, R]

        bs = np.stack(truth["complex"][CH_CW])  # [P, R, 4]
        c = 1480.0
        z_er, z_et = 5400.0, 75.0
        n_beam = 4
        mean_sig = bs.mean(axis=-1)
        prx = (
            n_beam * np.abs(mean_sig) ** 2 / (2 * np.sqrt(2)) ** 2
            * (np.abs(z_er + z_et) / z_er) ** 2 / z_et
        )
        dr = 32e-6 * c / 2
        r = np.arange(bs.shape[1]) * dr
        # Ex80 TVG shift: c * tau / 4
        r_tvg = r - c * 1.024e-3 / 4
        r_tvg = np.where(r_tvg > 0, r_tvg, np.nan)
        freq = 120000.0
        wavelength = c / freq
        alpha = float(ds["sound_absorption"].values[0])
        gain = 26.0  # pulse_duration=1024us -> idx2 of [24,25,26]
        tau_eff = float(ds["tau_effective"].values[0, 0])
        sa = -0.2
        expected = (
            10 * np.log10(prx)
            + 20 * np.log10(r_tvg)[None, :]
            + 2 * alpha * r_tvg[None, :]
            - 10 * np.log10(wavelength**2 * 150.0 * c / (32 * np.pi**2))
            - 2 * gain
            - 10 * np.log10(tau_eff)
            - (-20.7)
            - 2 * sa
        )
        np.testing.assert_allclose(sv[0], expected, atol=1e-4, rtol=0)

    def test_cw_power_path(self, ek80_ed):
        """EK80 CW power channels calibrate through the power path."""
        ed, truth = ek80_ed
        ds = ep.calibrate.compute_Sv(ed, waveform_mode="CW", encode_mode="power")
        assert ds["Sv"].values.shape[0] == 1  # the GPT power channel
        assert np.isfinite(ds["Sv"].values[:, :, 5:]).all()

    def test_ts_bb(self, ek80_ed):
        ed, truth = ek80_ed
        ds = ep.calibrate.compute_TS(ed, waveform_mode="BB", encode_mode="complex")
        assert "TS" in ds

    def test_invalid_combo(self, ek80_ed):
        ed, truth = ek80_ed
        with pytest.raises(ValueError):
            ep.calibrate.compute_Sv(ed, waveform_mode="BB", encode_mode="power")
        with pytest.raises(ValueError):
            ep.calibrate.compute_Sv(ed)  # modes required for EK80


class TestSplitbeamBB:
    def test_pulse_compressed_splitbeam(self, ek80_ed):
        ed, truth = ek80_ed
        ds = ep.calibrate.compute_Sv(ed, waveform_mode="BB", encode_mode="complex")
        import echopype_tpu as _ep

        out = _ep.consolidate.add_splitbeam_angle(
            ds, ed, waveform_mode="BB", encode_mode="complex",
            pulse_compression=True, to_disk=False,
        )
        assert "angle_alongship" in out and "angle_athwartship" in out
        th = out["angle_alongship"].values
        assert th.shape == ds["Sv"].values.shape
        assert np.isfinite(th).any()

    def test_splitbeam_no_pc(self, ek80_ed):
        ed, truth = ek80_ed
        ds = ep.calibrate.compute_Sv(ed, waveform_mode="BB", encode_mode="complex")
        import echopype_tpu as _ep

        out = _ep.consolidate.add_splitbeam_angle(
            ds, ed, waveform_mode="BB", encode_mode="complex", to_disk=False
        )
        assert np.isfinite(out["angle_athwartship"].values).any()


class TestPowerModeWbtTau:
    def test_wbt_power_channel_uses_replica_tau(self, tmp_path):
        """EK80 power mode: WBT channels get tau_effective from the transmit
        replica (GPT channels keep nominal) - calibrate_ek.py:112-151."""
        import numpy as _np
        from synth_ek80 import (
            config_xml, environment_xml, make_fil1, make_raw3, make_xml0,
            parameter_xml,
        )

        rng = _np.random.default_rng(11)
        t0 = _np.datetime64("2021-02-01T00:00:00", "ns")
        ch_wbt = "WBT 500100-15 ES120-7C"
        ch_gpt = "GPT 500101-15 ES38B"
        channels = [
            {"id": ch_wbt, "tcvr_type": "WBT", "frequency": 120000.0,
             "pulse_durations": [256e-6, 512e-6, 1024e-6],
             "sample_intervals": [8e-6, 16e-6, 32e-6],
             "gains": [24.0, 25.0, 26.0], "sas": [0.0, -0.1, -0.2],
             "impedance": 5400, "fs": 1500000, "cal_freqs": None},
            {"id": ch_gpt, "tcvr_type": "GPT", "frequency": 38000.0,
             "pulse_durations": [256e-6, 512e-6, 1024e-6],
             "sample_intervals": [64e-6, 128e-6, 256e-6],
             "gains": [22.0, 23.0, 24.0], "sas": [0.0, -0.1, -0.2],
             "impedance": 5400, "fs": 500000, "cal_freqs": None},
        ]
        chunks = [make_xml0(t0, config_xml(channels)), make_xml0(t0, environment_xml())]
        for ch in channels:
            chunks.append(make_fil1(t0, ch["id"], 1, _np.full(4, 0.25, dtype="c8"), 6))
            chunks.append(make_fil1(t0, ch["id"], 2, _np.full(2, 0.5, dtype="c8"), 1))
        for p in range(3):
            ts = t0 + _np.timedelta64(p + 1, "s")
            for ch in channels:
                chunks.append(make_xml0(ts, parameter_xml(
                    ch["id"], 0, frequency=ch["frequency"],
                    pulse_duration=1.024e-3, sample_interval=64e-6,
                    transmit_power=500.0)))
                pw = rng.integers(-20000, 0, 48).astype("<i2")
                chunks.append(make_raw3(ts, ch["id"], power_idx=pw))
        path = tmp_path / "PW-D20210201-T000000.raw"
        path.write_bytes(b"".join(chunks))

        ed = ep.open_raw(path, sonar_model="EK80")
        sv = ep.calibrate.compute_Sv(ed, waveform_mode="CW", encode_mode="power")
        tau = sv["tau_effective"].values
        chans = list(sv.coords["channel"].values)
        nominal = 1.024e-3
        tau_gpt = tau[chans.index(ch_gpt), 0]
        tau_wbt = tau[chans.index(ch_wbt), 0]
        np.testing.assert_allclose(tau_gpt, nominal, rtol=1e-9)
        # replica tau differs from nominal (Hann taper + filters shorten it)
        assert tau_wbt != nominal and 0 < tau_wbt < nominal


class TestMxuConvFallback:
    def test_mxu_conv_matches_f64_host(self):
        """The f32 Toeplitz path (the only device path since round 4 —
        the complex64 FFT branch was removed for its eps*spectrum leakage)
        matches the exact f64 host convolution."""
        import numpy as _np

        import echopype_tpu.ops.matched_filter as mf

        rng = _np.random.default_rng(2)
        P, R, B, L = 4, 120, 2, 25
        bs = (rng.normal(0, 1e-3, (P, R, B)) + 1j * rng.normal(0, 1e-3, (P, R, B))).astype("c8")
        bs[1, 100:, :] = _np.nan  # ragged
        rep = (rng.normal(size=L) + 1j * rng.normal(size=L)).astype("c8")
        out_f64 = mf.pulse_compress_channel(bs, rep)
        out_mxu = mf.pulse_compress_channel(bs, rep, precision="float32")
        _np.testing.assert_allclose(out_mxu.real, out_f64.real, rtol=1e-4, atol=1e-9)
        _np.testing.assert_allclose(out_mxu.imag, out_f64.imag, rtol=1e-4, atol=1e-9)
        assert _np.isnan(out_mxu.real[1, 100:]).all()

    @pytest.mark.parametrize(
        "P,R,L",
        [
            (3, 300, 500),   # replica longer than the block size T (multi-shift halo)
            (2, 100, 257),   # replica longer than the signal
            (5, 1000, 3),    # tiny replica
            (2, 129, 41),    # out_len not a multiple of the block size
            (1, 8192, 500),  # the production BB shape, one lane
        ],
    )
    def test_mxu_conv_shape_edges(self, P, R, L):
        """The blocked Toeplitz matmul across halo/edge shape regimes vs the
        f64 time-domain convolution truncated at [L-1:]."""
        import numpy as _np

        from echopype_tpu.ops.matched_filter import _toeplitz_conv_real

        rng = _np.random.default_rng(L)
        x = (rng.normal(size=(P, R)) + 1j * rng.normal(size=(P, R)))
        h = (rng.normal(size=L) + 1j * rng.normal(size=L))
        expected = _np.stack([_np.convolve(x[p], h)[L - 1 : L - 1 + R] for p in range(P)])
        re, im = _toeplitz_conv_real(
            _np.ascontiguousarray(x.real, "f4"), _np.ascontiguousarray(x.imag, "f4"),
            _np.ascontiguousarray(h.real, "f4"), _np.ascontiguousarray(h.imag, "f4"),
            L - 1, R,
        )
        got = _np.asarray(re).astype("f8") + 1j * _np.asarray(im)
        scale = _np.abs(expected).max()
        assert _np.abs(got - expected).max() / scale < 2e-6


class TestThreeSectorComplex:
    def test_cw_complex_three_sectors(self, tmp_path):
        """3-sector transducers (beam_type 17/49/65) calibrate through the
        same complex path; prx averages over however many sectors exist."""
        import numpy as _np
        from synth_ek80 import (
            config_xml, environment_xml, make_fil1, make_raw3, make_xml0,
            parameter_xml,
        )

        ch = "WBT 600100-15 ES333-3S"
        channels = [{"id": ch, "tcvr_type": "WBT", "frequency": 333000.0,
                     "pulse_durations": [256e-6, 512e-6, 1024e-6],
                     "sample_intervals": [8e-6, 16e-6, 32e-6],
                     "gains": [24.0, 25.0, 26.0], "sas": [0.0, -0.1, -0.2],
                     "impedance": 5400, "fs": 1500000, "cal_freqs": None,
                     "beam_type": 17}]
        t0 = _np.datetime64("2021-02-01T00:00:00", "ns")
        chunks = [make_xml0(t0, config_xml(channels)), make_xml0(t0, environment_xml())]
        chunks.append(make_fil1(t0, ch, 1, _np.full(4, 0.25, dtype="c8"), 6))
        chunks.append(make_fil1(t0, ch, 2, _np.full(2, 0.5, dtype="c8"), 1))
        rng = _np.random.default_rng(21)
        for p in range(4):
            ts = t0 + _np.timedelta64(p + 1, "s")
            chunks.append(make_xml0(ts, parameter_xml(
                ch, 0, frequency=333000.0, sample_interval=32e-6)))
            cs = (rng.normal(0, 1e-3, (48, 3)) + 1j * rng.normal(0, 1e-3, (48, 3))).astype("c8")
            chunks.append(make_raw3(ts, ch, complex_samples=cs))
        path = tmp_path / "S3-D20210201-T000000.raw"
        path.write_bytes(b"".join(chunks))

        ed = ep.open_raw(path, sonar_model="EK80")
        bg = ed["Sonar/Beam_group1"]
        assert bg.sizes["beam"] == 3
        sv = ep.calibrate.compute_Sv(ed, waveform_mode="CW", encode_mode="complex")
        assert np.isfinite(sv["Sv"].values).any()
        assert sv["Sv"].values.shape == (1, 4, 48)
        # split-beam angles from the 3-sector layout
        ang = ep.consolidate.add_splitbeam_angle(sv, ed, waveform_mode="CW",
                                                 encode_mode="complex")
        assert np.isfinite(ang["angle_alongship"].values).any()


class TestConvPrecisionKnob:
    def test_set_conv_precision(self):
        """The device-conv speed/accuracy knob accepts names and Precision values
        and the conv path still matches the FFT path at any setting on CPU."""
        import jax
        import numpy as np

        from echopype_tpu.ops import matched_filter as mf

        rng = np.random.default_rng(3)
        bs = (rng.normal(size=(4, 64, 1)) + 1j * rng.normal(size=(4, 64, 1))).astype("c16")
        rep = (rng.normal(size=12) + 1j * rng.normal(size=12)).astype("c16")
        want = mf.pulse_compress_channel(bs, rep)

        orig = mf._CONV_PRECISION
        try:
            mf.set_conv_precision("HIGH")
            assert mf._CONV_PRECISION == jax.lax.Precision.HIGH
            mf.set_conv_precision(jax.lax.Precision.HIGHEST)
            assert mf._CONV_PRECISION == jax.lax.Precision.HIGHEST
            # force the conv fallback and compare against the FFT result
            mf._FFT_OK = False
            got = mf.pulse_compress_channel(bs, rep)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        finally:
            mf._FFT_OK = None
            mf.set_conv_precision(orig)
