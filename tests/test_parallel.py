"""Multi-chip shard-equivalence tests on the virtual 8-device CPU mesh.

The reference's contract analog: 1-chip and N-chip runs must produce the
same bins (SURVEY.md §4 tier 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from echopype_tpu.ops import binning
from echopype_tpu.parallel import make_mesh, sharded_sv_mvbs_step


def make_inputs(C=2, Pn=64, R=128, seed=0):
    rng = np.random.default_rng(seed)
    power = rng.normal(-80, 10, (C, Pn, R)).astype("f4")
    dr = np.full((C, Pn), 0.19, dtype="f4")
    tvg_shift = 2 * dr
    absorption = np.full((C, Pn), 0.01, dtype="f4")
    offset = rng.normal(-30, 2, (C, Pn)).astype("f4")
    n_x, n_r = 8, 5
    x_idx = (np.arange(Pn) // (Pn // n_x)).astype("i4")
    r_edges = np.arange(0, 30.0, 5.0, dtype="f4")  # 5 bins
    return power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r


class TestShardedPipeline:
    def test_8dev_matches_single_device(self):
        assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()

        mesh1 = make_mesh(n_devices=1, channel_axis=1)
        mesh8 = make_mesh(n_devices=8, channel_axis=2)

        fn1 = sharded_sv_mvbs_step(mesh1, n_x, n_r)
        fn8 = sharded_sv_mvbs_step(mesh8, n_x, n_r)

        sv1, mvbs1 = fn1(power, dr, tvg, ab, off, x_idx, r_edges)
        sv8, mvbs8 = fn8(power, dr, tvg, ab, off, x_idx, r_edges)

        np.testing.assert_allclose(np.asarray(sv8), np.asarray(sv1), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(mvbs8), np.asarray(mvbs1), rtol=1e-5, atol=1e-5)

    def test_sharded_matches_ops_binning(self):
        """The fused sharded step equals the standalone kernels."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()
        mesh = make_mesh(n_devices=4, channel_axis=1)
        fn = sharded_sv_mvbs_step(mesh, n_x, n_r)
        sv, mvbs = fn(power, dr, tvg, ab, off, x_idx, r_edges)

        # reference path: standalone calibration + binning kernels
        from echopype_tpu.ops.calibration import ek_power_cal

        sv_ref, er_ref = ek_power_cal(power, dr, tvg, ab, off, "Sv")
        x_bounds = binning.x_bounds_np(x_idx, np.arange(n_x + 1))
        mvbs_ref = np.asarray(
            binning.binned_mean_linear(
                sv_ref.astype("f4"), er_ref.astype("f4"), np.asarray(r_edges, "f4"), x_bounds
            )
        )
        np.testing.assert_allclose(np.asarray(sv), sv_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(mvbs), mvbs_ref, rtol=1e-4, atol=1e-4)

    def test_mxu_core_matches_cumsum_core(self):
        """The banded-matmul binning equals the cumsum+gather binning."""
        from echopype_tpu.parallel.pipeline import sv_mvbs_core, sv_mvbs_core_mxu

        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(C=3, Pn=48, R=96)
        sv1, s1, c1 = sv_mvbs_core(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r)
        sv2, s2, c2 = sv_mvbs_core_mxu(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r)
        np.testing.assert_allclose(np.asarray(sv2), np.asarray(sv1), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(c2), np.asarray(c1), rtol=0, atol=0.5)

    def test_sharded_mxu_matches_cumsum(self):
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()
        mesh = make_mesh(n_devices=4, channel_axis=1)
        f_mxu = sharded_sv_mvbs_step(mesh, n_x, n_r, uniform_dr=True)
        f_cum = sharded_sv_mvbs_step(mesh, n_x, n_r, uniform_dr=False)
        _, m1 = f_mxu(power, dr, tvg, ab, off, x_idx, r_edges)
        _, m2 = f_cum(power, dr, tvg, ab, off, x_idx, r_edges)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-5, atol=1e-5)

    def test_ex60_core_matches_mxu(self):
        """Integer-shift fast path equals the general core for tvg = 2*dr."""
        from echopype_tpu.parallel.pipeline import sv_mvbs_core_ex60, sv_mvbs_core_mxu

        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(C=2, Pn=40, R=96)
        sv1, s1, c1 = sv_mvbs_core_mxu(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r)
        sv2, s2, c2 = sv_mvbs_core_ex60(power, dr, ab, off, x_idx, r_edges, n_x, n_r)
        np.testing.assert_allclose(np.asarray(sv2), np.asarray(sv1), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-3, atol=1e-6)

    def test_3d_mesh_matches_single_device(self):
        """(ping, channel, range) sharding produces identical MVBS bins."""
        from echopype_tpu.parallel.pipeline import sharded_sv_mvbs_step_3d

        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()
        mesh1 = make_mesh(n_devices=1, channel_axis=1)
        mesh8 = make_mesh(n_devices=8, channel_axis=2, range_axis=2)
        assert mesh8.axis_names == ("ping", "channel", "range")
        fn1 = sharded_sv_mvbs_step(mesh1, n_x, n_r)
        fn8 = sharded_sv_mvbs_step_3d(mesh8, n_x, n_r)
        sv1, m1 = fn1(power, dr, tvg, ab, off, x_idx, r_edges)
        sv8, m8 = fn8(power, dr, tvg, ab, off, x_idx, r_edges)
        np.testing.assert_allclose(np.asarray(sv8), np.asarray(sv1), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(m8), np.asarray(m1), rtol=1e-4, atol=1e-4)

    def test_mesh_shapes(self):
        mesh = make_mesh(n_devices=8, channel_axis=2)
        assert mesh.devices.shape == (4, 2)
        assert mesh.axis_names == ("ping", "channel")
        with pytest.raises(ValueError):
            make_mesh(n_devices=8, channel_axis=3)


class TestMvbsOnlyStep:
    def test_with_sv_false_matches(self):
        """MVBS-only step (no Sv materialization) matches the full step."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()
        mesh = make_mesh(n_devices=8, channel_axis=2)
        full = sharded_sv_mvbs_step(mesh, n_x, n_r)
        lean = sharded_sv_mvbs_step(mesh, n_x, n_r, with_sv=False)
        _, mvbs_full = full(power, dr, tvg, ab, off, x_idx, r_edges)
        mvbs_lean = lean(power, dr, tvg, ab, off, x_idx, r_edges)
        np.testing.assert_allclose(
            np.asarray(mvbs_lean), np.asarray(mvbs_full), rtol=1e-6, atol=1e-6
        )


class TestClosedCountsCore:
    def test_matches_general_core_with_ragged_pings(self):
        """Closed-form counts == matmul counts for suffix-NaN ragged pings."""
        from echopype_tpu.parallel.pipeline import (
            sv_mvbs_core_mxu,
            sv_mvbs_core_mxu_closed,
        )

        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()
        rng = np.random.default_rng(7)
        C, Pn, R = power.shape
        valid_len = rng.integers(R // 3, R + 1, (C, Pn)).astype("i4")
        for c in range(C):
            for p in range(Pn):
                power[c, p, valid_len[c, p]:] = np.nan
        _, s_ref, c_ref = sv_mvbs_core_mxu(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r)
        s, c = sv_mvbs_core_mxu_closed(power, dr, tvg, ab, off, valid_len,
                                       x_idx, r_edges, n_x, n_r)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(c_ref))
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), rtol=1e-6)


class TestShardedClosedStep:
    def test_8dev_matches_single_device(self):
        from echopype_tpu.parallel import make_mesh, sharded_mvbs_step_closed

        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs()
        C, Pn, R = power.shape
        valid_len = np.full((C, Pn), R, dtype="i4")
        mesh1 = make_mesh(n_devices=1, channel_axis=1)
        mesh8 = make_mesh(n_devices=8, channel_axis=2)
        m1 = sharded_mvbs_step_closed(mesh1, n_x, n_r)(
            power, dr, tvg, ab, off, valid_len, x_idx, r_edges)
        m8 = sharded_mvbs_step_closed(mesh8, n_x, n_r)(
            power, dr, tvg, ab, off, valid_len, x_idx, r_edges)
        np.testing.assert_allclose(np.asarray(m8), np.asarray(m1), rtol=1e-6, atol=1e-6)
        # and equals the full sharded step's MVBS
        full = sharded_sv_mvbs_step(mesh8, n_x, n_r)
        _, mvbs_full = full(power, dr, tvg, ab, off, x_idx, r_edges)
        np.testing.assert_allclose(np.asarray(m8), np.asarray(mvbs_full), rtol=1e-5, atol=1e-5)


class TestUniformFastPath:
    def test_uniform_matches_general(self):
        """The hoisted-spreading fast path equals the general window kernel
        for per-channel-uniform dr/shift (same counts, ~1e-6 sums)."""
        from echopype_tpu.parallel.pipeline import (
            sv_mvbs_window_partials,
            sv_mvbs_window_partials_uniform,
        )

        rng = np.random.default_rng(4)
        C, P, R = 3, 256, 300
        n_x, n_r = 7, 9
        power = rng.integers(-12000, -2000, (C, P, R), dtype=np.int16)
        dr = np.repeat(rng.uniform(0.1, 0.3, (C, 1)).astype("f4"), P, axis=1)
        shift = 2 * dr
        ab = np.full((C, P), 0.01, "f4")
        off = rng.normal(-30, 2, (C, P)).astype("f4")
        vl = rng.integers(R // 2, R + 1, (C, P)).astype("i4")
        x_rel = np.sort(rng.integers(0, n_x, P)).astype("i4")
        r_edges = np.linspace(0, 0.3 * R, n_r + 1).astype("f4")
        s_g, c_g = sv_mvbs_window_partials(
            power, dr, shift, ab, off, vl, x_rel, r_edges, n_x, n_r
        )
        s_u, c_u = sv_mvbs_window_partials_uniform(
            power, dr, shift, ab, off, vl, x_rel, r_edges, n_x, n_r
        )
        np.testing.assert_array_equal(np.asarray(c_u), np.asarray(c_g))
        np.testing.assert_allclose(
            np.asarray(s_u), np.asarray(s_g), rtol=3e-6, atol=1e-12
        )


class TestRefineK0:
    def test_smallest_k_strictly_past_shift(self):
        """_refine_k0 must return the smallest k >= 0 with k*dr > shift on the
        f32 sample grid, even when floor(shift/dr) is off by one ULP (a backend
        that lowers x/y as x*reciprocal(y); CPU division is exact, so we perturb
        the quotient by hand to model both failure directions)."""
        import jax.numpy as jnp
        from echopype_tpu.parallel.pipeline import _refine_k0

        rng = np.random.default_rng(11)
        dr = np.concatenate([
            rng.uniform(0.05, 0.5, 200).astype("f4"),
            np.full(56, 0.19, "f4"),
        ])
        # include exact multiples k*dr (the knife edge) and generic shifts
        k_true = rng.integers(0, 50, dr.size)
        shift = np.where(
            rng.random(dr.size) < 0.5,
            (k_true * dr.astype("f8")).astype("f4"),      # exactly on the grid
            (k_true * dr.astype("f8") + rng.uniform(0, 1, dr.size) * dr).astype("f4"),
        )
        quot = (shift.astype("f8") / dr.astype("f8")).astype("f4")
        # model reciprocal-lowered division: the QUOTIENT is off by a few ULP
        # before floor (a whole-step perturbation of the floored result cannot
        # occur on hardware and is beyond the one-step refinement)
        for ulps in (-4, 0, 4):
            qp = np.nextafter(quot, np.float32(np.sign(ulps) * np.inf), dtype="f4") if ulps else quot
            for _ in range(abs(ulps) - 1):
                qp = np.nextafter(qp, np.float32(np.sign(ulps) * np.inf), dtype="f4")
            q = np.floor(qp) + 1.0
            got = np.asarray(_refine_k0(jnp.asarray(q), jnp.asarray(dr), jnp.asarray(shift)))
            assert np.all(got * dr > shift), "k0*dr must strictly exceed shift"
            prev_ok = (got - 1.0) * dr <= shift
            assert np.all(prev_ok | (got == 0.0)), "k0 must be minimal"
            assert np.all(got >= 0.0)


class TestBlockedBandedSegmentSum:
    """Exact-f32 blocked segment sum (ops/binning.py, an alternative to the
    plain banded dot selected by block_g): the decomposition must stay
    exact."""

    def test_integer_exact_property(self):
        from echopype_tpu.ops.binning import (
            blocked_banded_segment_sum, choose_block_g)

        rng = np.random.default_rng(1)
        ran = 0
        for trial in range(60):
            C = int(rng.integers(1, 4)); P = int(rng.integers(1, 7))
            N = int(rng.integers(20, 300)); n_r = int(rng.integers(1, 10))
            vals = rng.integers(0, 64, (C, P, N)).astype("f4")  # exact in f32
            b = np.sort(rng.integers(0, N + 1, (C, n_r + 1)), axis=1).astype("f8")
            if trial % 4 == 0:
                b[:, 0] = 0.0
                b[:, -1] = N  # aligned ends + clipped tails
            G = choose_block_g(b, N)
            if G == 0:
                continue
            ran += 1
            got = np.asarray(blocked_banded_segment_sum(
                jnp.asarray(vals), jnp.asarray(b.astype("f4")), n_r, G))
            want = np.zeros((C, P, n_r))
            for c in range(C):
                for bb in range(n_r):
                    want[c, :, bb] = vals[
                        c, :, int(b[c, bb]):int(b[c, bb + 1])].sum(axis=-1)
            np.testing.assert_array_equal(got, want)
        assert ran >= 15  # the guard must admit a healthy fraction

    def test_choose_block_g_guard(self):
        from echopype_tpu.ops.binning import choose_block_g

        # spacing 80 -> largest power of two <= 80 is 64
        b = np.arange(0, 400, 80, dtype="f8")[None]
        assert choose_block_g(b, 400) == 64
        # a 3-sample bin forbids any G >= 8
        assert choose_block_g(np.array([[0.0, 3.0, 300.0]]), 300) == 0
        # duplicate bounds (empty bins) don't count as spacing
        assert choose_block_g(np.array([[0.0, 64.0, 64.0, 300.0]]), 300) == 64

    def test_blocked_uniform_kernel_matches_plain(self):
        """sv_mvbs_window_partials_uniform(block_g=...) == plain path."""
        from echopype_tpu.parallel.pipeline import sv_mvbs_window_partials_uniform

        rng = np.random.default_rng(5)
        C, Pn, R, n_r, W = 3, 48, 260, 6, 4
        power = rng.integers(-12000, -2000, (C, Pn, R)).astype(np.int16)
        dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)).astype("f4"), (1, Pn))
        tvg = 2 * dr
        ab = np.full((C, Pn), 0.01, "f4")
        off = rng.normal(-30, 2, (C, Pn)).astype("f4")
        vl = rng.integers(R - 10, R + 1, (C, Pn)).astype("i4")
        x_rel = np.sort(rng.integers(0, W, Pn)).astype("i4")
        r_edges = np.linspace(0, 0.25 * R, n_r + 1).astype("f4")
        args = [jnp.asarray(a) for a in
                (power, dr, tvg, ab, off, vl, x_rel, r_edges)]
        s0, c0 = sv_mvbs_window_partials_uniform(*args, W, n_r)
        s1, c1 = sv_mvbs_window_partials_uniform(*args, W, n_r, block_g=8)
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s0),
                                   rtol=3e-6, atol=1e-30)


class TestUniformKernelVariants:
    """Transposed (ping-minor) twin of the uniform survey kernel, kept with
    a parity pin."""

    def _inputs(self):
        rng = np.random.default_rng(3)
        C, Pn, R, n_r, W = 2, 256, 300, 7, 4
        power = rng.integers(-12000, -2000, (C, Pn, R)).astype(np.int16)
        dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)).astype("f4"), (1, Pn))
        tvg = 2 * dr
        ab = np.full((C, Pn), 0.01, "f4")
        off = rng.normal(-30, 2, (C, Pn)).astype("f4")
        vl = (np.full((C, Pn), R) - rng.integers(0, 5, (C, Pn))).astype("i4")
        x_rel = np.sort(rng.integers(0, W, Pn)).astype("i4")
        r_edges = np.linspace(0, 0.25 * R, n_r + 1).astype("f4")
        return power, dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r

    def test_transposed_kernel_parity(self):
        from echopype_tpu.parallel.pipeline import (
            sv_mvbs_window_partials_uniform, sv_mvbs_window_partials_uniform_t)

        power, dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r = self._inputs()
        args = [jnp.asarray(a) for a in (power, dr, tvg, ab, off, vl, x_rel, r_edges)]
        s0, c0 = sv_mvbs_window_partials_uniform(*args, W, n_r)
        pT = jnp.asarray(np.ascontiguousarray(power.transpose(0, 2, 1)))
        st, ct = sv_mvbs_window_partials_uniform_t(pT, *args[1:], W, n_r)
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(ct))
        np.testing.assert_allclose(np.asarray(st), np.asarray(s0),
                                   rtol=2e-6, atol=1e-30)


class TestHostClosedCounts:
    """Round-5: the survey streamers compute window-bin counts closed-form
    on HOST (pipeline.closed_bounds_k0_np + closed_window_counts_np) so the
    device kernel returns sums only.  The host counts must equal the device
    kernel's own closed-form counts EXACTLY (integers from the identical
    f32-refined bounds) on random shapes, ragged valid lengths, and
    bin-edge-straddling grids."""

    def test_host_counts_equal_device_counts(self):
        from echopype_tpu.parallel.pipeline import (
            closed_bounds_k0_np,
            closed_window_counts_np,
            sv_mvbs_window_partials_uniform,
        )

        rng = np.random.default_rng(1234)
        for trial in range(8):
            C = int(rng.integers(1, 5))
            P = int(rng.integers(4, 40))
            R = int(rng.integers(10, 200))
            n_x = int(rng.integers(1, 6))
            n_r = int(rng.integers(2, 30))
            dr0 = rng.uniform(0.05, 0.4, C).astype("f4")
            dr = np.broadcast_to(dr0[:, None], (C, P)).astype("f4")
            shift = (dr * rng.integers(0, 4)).astype("f4")
            power = rng.normal(-80, 10, (C, P, R)).astype("f4")
            # ragged: random per-ping valid lengths incl. zero-length pings
            valid_len = rng.integers(0, R + 1, (C, P)).astype("i4")
            if trial % 2 == 0:
                valid_len[:] = R  # the constant fast path
            x_rel = np.sort(rng.integers(0, n_x + 1, P)).astype("i4")  # incl. parked
            r_edges = (
                np.arange(n_r + 1) * float(rng.uniform(1.0, 8.0))
            ).astype("f4")
            ab = np.full((C, P), 0.01, dtype="f4")
            off = np.full((C, P), -30.0, dtype="f4")
            _, dev_counts = sv_mvbs_window_partials_uniform(
                power, dr, shift, ab, off, valid_len, x_rel, r_edges, n_x, n_r
            )
            bounds, k0 = closed_bounds_k0_np(dr0, shift[:, 0], r_edges, R)
            host_counts = closed_window_counts_np(bounds, k0, valid_len, x_rel, n_x)
            np.testing.assert_array_equal(
                host_counts,
                np.asarray(dev_counts, dtype="f8"),
                err_msg=f"trial {trial} C={C} P={P} R={R} n_r={n_r}",
            )
