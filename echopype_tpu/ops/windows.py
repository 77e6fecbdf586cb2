"""Device kernels for rolling-window noise statistics (clean/*).

SURVEY.md §2.4 plans the reference's pooled-Sv comparisons
(echopype/clean/utils.py:29-181) as windowed device kernels.  The mean
pooling here is the separable two-pass scheme on XLA: per-ping depth-window
sums via cumsum + vmapped binary search bands, then ping-window sums via a
second cumsum — O(N) work, no scatter, jit end to end.  Median windows stay
host-side (sliding nanmedian needs per-window sorts that XLA handles poorly).

NaN depths are assumed to be suffix padding (the ragged-ping norm, same as
the binning kernels).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pool_sv_nanmean_device",
    "pool_sv_nanmean_grid_device",
    "pool_sv_nanmean_grid_idx_device",
    "pool_sv_nanmean_host_exact",
    "grid_window_members",
    "transient_mask_grid_device",
    "transient_mask_grid_idx_device",
    "transient_mask_grid_idx_packed",
    "downsample_upsample_depth_device",
    "downsample_upsample_grid_device",
    "impulse_mask_grid_device",
    "pack_mask_device",
    "transient_mask_grid_packed",
    "impulse_mask_grid_packed",
    "attenuated_ping_mask_grid_device",
]


def _win_tol(center, depth_bin):
    """Inclusive window-boundary tolerance for f32 depth comparisons.

    The reference evaluates ``|d_j - d_i| <= depth_bin`` in float64; on
    synthetic/round-number grids members land EXACTLY on the boundary, where
    f32 rounding of ``d +- depth_bin`` flips membership by one ulp.  A
    4-ulp-scaled inclusive margin makes the f32 kernels agree with the f64
    truth whenever samples are either exactly on the boundary or separated
    from it by more than ~4e-6 relative (any physical grid)."""
    return 4.0 * jnp.float32(np.finfo(np.float32).eps) * (jnp.abs(center) + depth_bin)


def _cumsum_band_diff(values, lo, hi, axis):
    """Sum of values[lo:hi) windows via zero-prepended cumsum gathers."""
    cs = jnp.cumsum(values, axis=axis)
    pad = [(0, 0)] * values.ndim
    pad[axis] = (1, 0)
    cs = jnp.pad(cs, pad)
    return jnp.take_along_axis(cs, hi, axis=axis) - jnp.take_along_axis(cs, lo, axis=axis)


@partial(jax.jit, static_argnames=("num_side_pings",))
def pool_sv_nanmean_device(sv, depth, depth_bin, num_side_pings: int, exclude_above):
    """Windowed nanmean pooling of Sv in the linear domain (device).

    sv, depth: [C, P, R] (depth monotone along R, NaN suffix allowed).
    Matches clean/utils.pool_Sv_nanmean's validity rules: output is NaN where
    the depth window leaves [d_min, d_max] or exclude_above, or the ping
    window leaves [0, P).
    """
    C, P, R = sv.shape
    lin = jnp.power(10.0, sv / 10.0)
    lin_f = jnp.where(jnp.isnan(sv), 0.0, lin)
    cnt = (~jnp.isnan(sv)).astype(jnp.float32)

    d_search = jnp.where(jnp.isnan(depth), jnp.inf, depth)
    W = int(num_side_pings)

    # The reference selects window members by the CENTER ping's depth
    # (clean/utils.py:88-91: ``current_depth - bin <= chan_depth <= ...``
    # against every ping in the window), so with ping-varying depth each
    # contributing ping's band must be searched against the center row's
    # depths — a separable own-row band silently shifts the window edges by
    # the inter-ping grid offset.  Scan over the (2W+1) ping shifts; each
    # step is one vmapped searchsorted + cumsum band on the shifted rows.
    lin_p = jnp.pad(lin_f, ((0, 0), (W, W), (0, 0)))
    cnt_p = jnp.pad(cnt, ((0, 0), (W, W), (0, 0)))
    d_p = jnp.pad(d_search, ((0, 0), (W, W), (0, 0)), constant_values=jnp.inf)
    tol = _win_tol(d_search, depth_bin)
    lo_q = d_search - depth_bin - tol
    hi_q = d_search + depth_bin + tol

    def step(carry, delta):
        sw, nw = carry
        lin_s = jax.lax.dynamic_slice_in_dim(lin_p, delta, P, axis=1)
        cnt_s = jax.lax.dynamic_slice_in_dim(cnt_p, delta, P, axis=1)
        d_s = jax.lax.dynamic_slice_in_dim(d_p, delta, P, axis=1)

        def row_band(d_row, lo_row, hi_row):
            lo = jnp.searchsorted(d_row, lo_row, side="left")
            hi = jnp.searchsorted(d_row, hi_row, side="right")
            return lo.astype(jnp.int32), hi.astype(jnp.int32)

        lo, hi = jax.vmap(jax.vmap(row_band))(d_s, lo_q, hi_q)
        sw = sw + _cumsum_band_diff(lin_s, lo, hi, axis=2)
        nw = nw + _cumsum_band_diff(cnt_s, lo, hi, axis=2)
        return (sw, nw), None

    zeros = jnp.zeros((C, P, R), dtype=jnp.float32)
    (sw, nw), _ = jax.lax.scan(step, (zeros, zeros), jnp.arange(2 * W + 1))

    pooled = jnp.where(nw > 0, 10.0 * jnp.log10(sw / jnp.maximum(nw, 1.0)), jnp.nan)

    # GLOBAL min/max — the reference's bounds span all channels
    # (clean/utils.py:52-53: ds_Sv[range_var].min() with no dim argument)
    d_min = jnp.nanmin(depth)
    d_max = jnp.nanmax(depth)
    vtol = _win_tol(depth, depth_bin)
    p_idx = jnp.arange(P)
    valid = (
        (depth - depth_bin >= d_min - vtol)
        & (depth + depth_bin <= d_max + vtol)
        & (depth - depth_bin >= exclude_above - vtol)
        & (p_idx[None, :, None] - num_side_pings >= 0)
        & (p_idx[None, :, None] + num_side_pings <= P)
    )
    return jnp.where(valid, pooled, jnp.nan)


def grid_window_members(grid, depth_bin, exclude_above):
    """Host-side f64-EXACT window membership for a ping-invariant grid.

    The reference decides membership and validity with float64 comparisons
    (clean/utils.py:79-91); on round-number grids members land exactly on
    ``d +- depth_bin``, where any f32 evaluation flips by one ulp.  Since a
    monotone grid's window is a contiguous index run, membership can be
    resolved here ONCE in f64 and shipped to the device as integer bounds —
    exact parity on the matmul path.

    Returns ``(lo, hi, v_r, halo)``:
      lo/hi  i32 [C, R]  member index run [lo, hi) per center (0,0 at NaN
             centers; runs may span interior-NaN positions, which the
             kernels zero out separately)
      v_r    bool [C, R] the reference's f64 validity (global min/max
             across channels, exclude_above)
      halo   power-of-two max run extent (jit-specialization bucketing)
    or ``None`` when any finite row is non-monotone (callers fall back to
    the f32 value-band kernel, which is order-free).
    """
    g2 = np.atleast_2d(np.asarray(grid, dtype="f8"))
    C, R = g2.shape
    lo = np.zeros((C, R), dtype="i4")
    hi = np.zeros((C, R), dtype="i4")
    extent = 0
    for c in range(C):
        row = g2[c]
        raw = np.nonzero(np.isfinite(row))[0]
        fin = row[raw]
        if fin.size and (np.diff(fin) < 0).any():
            return None
        if not fin.size:
            continue
        l_f = np.searchsorted(fin, fin - float(depth_bin), side="left")
        h_f = np.searchsorted(fin, fin + float(depth_bin), side="right")
        lo[c, raw] = raw[l_f]
        hi[c, raw] = raw[h_f - 1] + 1
        extent = max(
            extent,
            int((raw[h_f - 1] - raw).max()),
            int((raw - raw[l_f]).max()),
        )
    halo = int(2 ** np.ceil(np.log2(extent + 1))) if extent else 0
    d_min = np.nanmin(g2) if np.isfinite(g2).any() else np.nan
    d_max = np.nanmax(g2) if np.isfinite(g2).any() else np.nan
    with np.errstate(invalid="ignore"):
        v_r = (
            (g2 - float(depth_bin) >= d_min)
            & (g2 + float(depth_bin) <= d_max)
            & (g2 - float(depth_bin) >= float(exclude_above))
        )
    return lo, hi, v_r, halo


def pool_sv_nanmean_host_exact(sv, depth, depth_bin, num_side_pings: int, exclude_above):
    """Reference-exact pooled nanmean for PING-VARYING depth (host, f64).

    The reference windows every ping in the block by the CENTER ping's
    depth in float64 (clean/utils.py:88-91); with per-ping grids the member
    set is not expressible as shared index bounds, and f32 device
    comparisons flip the reference's own f64 rounding at window edges
    (e.g. 3.2 - 2.0 > 1.2 in f64).  This path trades device speed for
    bit-exact membership; ping-invariant grids (the instrument norm) take
    the matmul index-bounds path instead.
    """
    sv = np.asarray(sv, dtype="f8")
    depth = np.asarray(depth, dtype="f8")
    C, P, R = sv.shape
    W = int(num_side_pings)
    lin = np.where(np.isnan(sv), 0.0, 10.0 ** (sv / 10.0))
    cnt = (~np.isnan(sv)).astype("f8")
    lin_cs = np.concatenate([np.zeros((C, P, 1)), np.cumsum(lin, axis=2)], axis=2)
    cnt_cs = np.concatenate([np.zeros((C, P, 1)), np.cumsum(cnt, axis=2)], axis=2)
    out = np.full((C, P, R), np.nan)
    d_min = np.nanmin(depth)
    d_max = np.nanmax(depth)
    bin_f = float(depth_bin)
    for c in range(C):
        rows_sorted = [
            bool(np.all(np.diff(depth[c, p][np.isfinite(depth[c, p])]) >= 0))
            for p in range(P)
        ]
        for p in range(W, P):
            if p + W > P:  # reference validity: window must fit [0, P]
                continue
            d0 = depth[c, p]
            lo_q = d0 - bin_f
            hi_q = d0 + bin_f
            with np.errstate(invalid="ignore"):
                valid = (lo_q >= d_min) & (d0 + bin_f <= d_max) & (lo_q >= float(exclude_above))
            sw = np.zeros(R)
            nw = np.zeros(R)
            for pp in range(max(0, p - W), min(P, p + W + 1)):
                drow = depth[c, pp]
                if rows_sorted[pp] and not np.isnan(drow).any():
                    l = np.searchsorted(drow, lo_q, side="left")
                    h = np.searchsorted(drow, hi_q, side="right")
                    sw += lin_cs[c, pp][h] - lin_cs[c, pp][l]
                    nw += cnt_cs[c, pp][h] - cnt_cs[c, pp][l]
                else:
                    with np.errstate(invalid="ignore"):
                        m = (drow[None, :] >= lo_q[:, None]) & (drow[None, :] <= hi_q[:, None])
                    sw += m @ lin[c, pp]
                    nw += m @ cnt[c, pp]
            with np.errstate(divide="ignore", invalid="ignore"):
                pooled = np.where(nw > 0, 10.0 * np.log10(sw / np.maximum(nw, 1.0)), np.nan)
            out[c, p] = np.where(valid, pooled, np.nan)
    return out


def _expand_tiles(x, H: int, T: int, pad_value=0.0):
    """[..., N] -> [..., nT, T+2H] overlapping tiles with an H halo per side.

    Built with reshape + shifted-concat (no gather), the same halo trick as
    the blocked-Toeplitz matched filter (ops/matched_filter._toeplitz_conv_real):
    tile n covers padded positions [n*T, n*T + T + 2H), i.e. source
    positions [n*T - H, n*T + T + H) with ``pad_value`` outside the array.
    """
    N = x.shape[-1]
    nT = -(-N // T)
    K = T + 2 * H
    n_shift = -(-K // T)
    lead = x.ndim - 1
    xp = jnp.pad(
        x, [(0, 0)] * lead + [(H, (nT + n_shift) * T - N - H)],
        constant_values=pad_value,
    )
    xb = xp.reshape(*x.shape[:-1], nT + n_shift, T)
    parts = [xb[..., s : s + nT, :] for s in range(n_shift)]
    return jnp.concatenate(parts, axis=-1)[..., :K]


def _window_sum_ping_blocked(x, W: int, tile: int = 128):
    """Sliding window sums over the ping axis: sum over |p' - p| <= W.

    x: f32 [C, M, P] (ping LAST).  Blocked Toeplitz band matmul — each
    T-ping tile contracts against one static [T+2W, T] 0/1 band instead of
    a dense [P, P] matrix, cutting MACs by ~P/(T+2W); edge clipping rides
    the zero halo padding.
    """
    P = x.shape[-1]
    T = min(tile, max(1, P))
    K = T + 2 * W
    xb = _expand_tiles(x, W, T)  # [C, M, nT, K]
    k = jnp.arange(K)[:, None]
    t = jnp.arange(T)[None, :]
    band = ((k >= t) & (k <= t + 2 * W)).astype(jnp.float32)  # [K, T]
    out = jnp.einsum(
        "cmnk,kt->cmnt", xb, band,
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
    )
    nT = xb.shape[-2]
    return out.reshape(*x.shape[:-1], nT * T)[..., :P]


def _pool_windows_grid(sv, grid, depth_bin, num_side_pings: int, range_halo: int = 0,
                       tile: int = 128):
    """Depth- and ping-window sums for a ping-invariant depth grid — two
    BLOCKED banded matmuls (a 0/1 band matrix instead of gathers; tiling
    the band cuts the dense [R,R]/[P,P] MAC waste by ~R/(T+2H) and
    ~P/(T+2W)).

    sv: f32 [C, P, R]; grid: f32 [C, R].  Returns (sw, nw) each [C, P, R]:
    linear-domain window sums and valid-sample counts over
    {r': grid[r'] in [grid[r]-depth_bin, grid[r]+depth_bin]} x {|p'-p| <= W}.

    range_halo: static max samples any depth window extends past its center
    (host-computed, e.g. ceil(depth_bin / min grid step) + 1).  0 selects
    the dense range band (correct for any halo, more MACs).
    """
    C, P, R = sv.shape
    lin = jnp.power(10.0, sv / 10.0)
    lin_f = jnp.where(jnp.isnan(sv), 0.0, lin)
    cnt = (~jnp.isnan(sv)).astype(jnp.float32)

    stacked = jnp.concatenate([lin_f, cnt], axis=1)  # [C, 2P, R]
    d = grid
    if range_halo and range_halo * 2 < R:
        H = int(range_halo)
        T = min(tile, R)
        xb = _expand_tiles(stacked, H, T)  # [C, 2P, nT, K]
        # pad value +inf never satisfies the window membership
        gb = _expand_tiles(d, H, T, pad_value=jnp.inf)  # [C, nT, K]
        nT = gb.shape[-2]
        gc = jnp.pad(
            d, ((0, 0), (0, nT * T - R)), constant_values=jnp.inf
        ).reshape(C, nT, T)
        btol = _win_tol(gc[..., None, :], depth_bin)
        band = (
            (gb[..., :, None] >= gc[..., None, :] - depth_bin - btol)
            & (gb[..., :, None] <= gc[..., None, :] + depth_bin + btol)
        ).astype(jnp.float32)  # [C, nT, K, T]
        s_n = jnp.einsum(
            "cpnk,cnkt->cpnt", xb, band,
            precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
        )
        s_n = s_n.reshape(C, 2 * P, nT * T)[..., :R]
    else:
        # dense band matrix over the range axis: Wd[c, r_src, r_dst]
        dtol = _win_tol(d[:, None, :], depth_bin)
        wd = (
            (d[:, :, None] >= d[:, None, :] - depth_bin - dtol)
            & (d[:, :, None] <= d[:, None, :] + depth_bin + dtol)
        ).astype(jnp.float32)
        dn = (((2,), (1,)), ((0,), (0,)))
        s_n = jax.lax.dot_general(
            stacked, wd, dn, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # [C, 2P, R]

    # blocked Toeplitz band over the ping axis (ping moved last)
    stacked2 = jnp.concatenate([s_n[:, :P], s_n[:, P:]], axis=2)  # [C, P, 2R]
    out = _window_sum_ping_blocked(
        jnp.moveaxis(stacked2, 1, 2), num_side_pings, tile=tile
    )  # [C, 2R, P]
    out = jnp.moveaxis(out, 2, 1)
    return out[..., :R], out[..., R:]


def _pool_windows_grid_idx(sv, gmask, lo, hi, num_side_pings: int, range_halo: int = 0,
                           tile: int = 128):
    """_pool_windows_grid with HOST-computed integer member bounds.

    Membership is the f64-exact contiguous run [lo, hi) per center
    (grid_window_members), built on device from integer iota comparisons —
    no float boundary arithmetic at all.  ``gmask`` (f32 [C, R], 0 at
    NaN-grid positions) zeroes contributions from interior-NaN positions
    that fall inside a run, matching the reference's NaN comparisons.
    """
    C, P, R = sv.shape
    lin = jnp.power(10.0, sv / 10.0)
    lin_f = jnp.where(jnp.isnan(sv), 0.0, lin) * gmask[:, None, :]
    cnt = (~jnp.isnan(sv)).astype(jnp.float32) * gmask[:, None, :]

    stacked = jnp.concatenate([lin_f, cnt], axis=1)  # [C, 2P, R]
    if range_halo and range_halo * 2 < R:
        H = int(range_halo)
        T = min(tile, R)
        xb = _expand_tiles(stacked, H, T)  # [C, 2P, nT, K]
        K = T + 2 * H
        nT = xb.shape[-2]
        # center bounds per tile: pad with an empty run (lo=hi=0)
        lo_t = jnp.pad(lo, ((0, 0), (0, nT * T - R))).reshape(C, nT, T)
        hi_t = jnp.pad(hi, ((0, 0), (0, nT * T - R))).reshape(C, nT, T)
        # member global index for tile n, halo slot k: n*T - H + k
        kg = (
            jnp.arange(nT, dtype=jnp.int32)[:, None] * T
            - H
            + jnp.arange(K, dtype=jnp.int32)[None, :]
        )  # [nT, K]
        band = (
            (kg[None, :, :, None] >= lo_t[:, :, None, :])
            & (kg[None, :, :, None] < hi_t[:, :, None, :])
        ).astype(jnp.float32)  # [C, nT, K, T]
        s_n = jnp.einsum(
            "cpnk,cnkt->cpnt", xb, band,
            precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
        )
        s_n = s_n.reshape(C, 2 * P, nT * T)[..., :R]
    else:
        r_src = jnp.arange(R, dtype=jnp.int32)
        wd = (
            (r_src[None, :, None] >= lo[:, None, :])
            & (r_src[None, :, None] < hi[:, None, :])
        ).astype(jnp.float32)  # [C, R_src, R_dst]
        dn = (((2,), (1,)), ((0,), (0,)))
        s_n = jax.lax.dot_general(
            stacked, wd, dn, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )

    stacked2 = jnp.concatenate([s_n[:, :P], s_n[:, P:]], axis=2)  # [C, P, 2R]
    out = _window_sum_ping_blocked(
        jnp.moveaxis(stacked2, 1, 2), num_side_pings, tile=tile
    )
    out = jnp.moveaxis(out, 2, 1)
    return out[..., :R], out[..., R:]


@partial(jax.jit, static_argnames=("num_side_pings", "range_halo"))
def pool_sv_nanmean_grid_idx_device(sv, gmask, lo, hi, v_r, num_side_pings: int,
                                    range_halo: int = 0):
    """Matmul pooled nanmean with host-exact membership/validity
    (grid_window_members) — the production grid path."""
    C, P, R = sv.shape
    sw, nw = _pool_windows_grid_idx(sv, gmask, lo, hi, num_side_pings, range_halo)
    pooled = jnp.where(nw > 0, 10.0 * jnp.log10(sw / jnp.maximum(nw, 1.0)), jnp.nan)
    p_idx = jnp.arange(P)
    v_p = (p_idx - num_side_pings >= 0) & (p_idx + num_side_pings <= P)
    valid = v_r[:, None, :] & v_p[None, :, None]
    return jnp.where(valid, pooled, jnp.nan)


@partial(jax.jit, static_argnames=("num_side_pings", "range_halo"))
def transient_mask_grid_idx_device(sv, gmask, lo, hi, v_r, num_side_pings: int,
                                   threshold, range_halo: int = 0):
    """Fused transient mask on the host-exact index-bounds path."""
    pooled = pool_sv_nanmean_grid_idx_device(
        sv, gmask, lo, hi, v_r, num_side_pings, range_halo
    )
    return (sv - pooled) > threshold


@partial(jax.jit, static_argnames=("num_side_pings", "range_halo"))
def transient_mask_grid_idx_packed(sv, gmask, lo, hi, v_r, num_side_pings: int,
                                   threshold, range_halo: int = 0):
    """transient_mask_grid_idx_device with bit-packed readback."""
    return pack_mask_device(
        transient_mask_grid_idx_device(
            sv, gmask, lo, hi, v_r, num_side_pings, threshold, range_halo
        )
    )


def _pool_validity_grid(grid, depth_bin, num_side_pings: int, exclude_above, P: int):
    """pool_Sv validity rules on a ping-invariant grid -> bool [C, P, R].

    min/max are GLOBAL across channels (reference clean/utils.py:52-53)."""
    d_min = jnp.nanmin(grid)
    d_max = jnp.nanmax(grid)
    gtol = _win_tol(grid, depth_bin)
    v_r = (
        (grid - depth_bin >= d_min - gtol)
        & (grid + depth_bin <= d_max + gtol)
        & (grid - depth_bin >= exclude_above - gtol)
    )  # [C, R]
    p_idx = jnp.arange(P)
    v_p = (p_idx - num_side_pings >= 0) & (p_idx + num_side_pings <= P)  # [P]
    return v_r[:, None, :] & v_p[None, :, None]


@partial(jax.jit, static_argnames=("num_side_pings", "range_halo"))
def pool_sv_nanmean_grid_device(sv, grid, depth_bin, num_side_pings: int, exclude_above,
                                range_halo: int = 0):
    """Windowed nanmean pooling for a ping-invariant depth grid (matmul path).

    Same contract as :func:`pool_sv_nanmean_device` with
    depth = broadcast(grid[:, None, :]).  ``range_halo`` (static,
    host-computed window extent in samples) selects the blocked range band.
    """
    C, P, R = sv.shape
    sw, nw = _pool_windows_grid(sv, grid, depth_bin, num_side_pings, range_halo)
    pooled = jnp.where(nw > 0, 10.0 * jnp.log10(sw / jnp.maximum(nw, 1.0)), jnp.nan)
    valid = _pool_validity_grid(grid, depth_bin, num_side_pings, exclude_above, P)
    return jnp.where(valid, pooled, jnp.nan)


@partial(jax.jit, static_argnames=("num_side_pings", "range_halo"))
def transient_mask_grid_device(sv, grid, depth_bin, num_side_pings: int, exclude_above,
                               threshold, range_halo: int = 0):
    """Fused transient-noise mask: pooled nanmean + dB compare, bool out.

    Returning the bool mask keeps the readback at 1 byte/sample and the dB
    compare on device (clean/api.py:30-168 parity: NaN pooled -> False).
    """
    pooled = pool_sv_nanmean_grid_device(
        sv, grid, depth_bin, num_side_pings, exclude_above, range_halo
    )
    return (sv - pooled) > threshold


@partial(jax.jit, static_argnames=("n_bins",))
def downsample_upsample_grid_device(sv, bin_idx_grid, n_bins: int):
    """Depth-bin linear mean + per-sample broadcast-back, ping-invariant grid.

    bin_idx_grid: i32 [C, R].  Both directions are one membership-matrix
    matmul: down-sums = lin @ M, up-sums = (lin @ M) @ M^T — no gathers.
    Returns (down [C, P, n_bins] dB, up [C, P, R] dB).
    """
    C, P, R = sv.shape
    lin = jnp.power(10.0, sv / 10.0)
    lin_f = jnp.where(jnp.isnan(sv), 0.0, lin)
    cnt = (~jnp.isnan(sv)).astype(jnp.float32)

    m = (bin_idx_grid[:, :, None] == jnp.arange(n_bins)[None, None, :]).astype(jnp.float32)

    stacked = jnp.concatenate([lin_f, cnt], axis=1)  # [C, 2P, R]
    dn = (((2,), (1,)), ((0,), (0,)))
    s_n = jax.lax.dot_general(
        stacked, m, dn, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [C, 2P, B]
    sums, counts = s_n[:, :P], s_n[:, P:]
    down = jnp.where(counts > 0, 10.0 * jnp.log10(sums / jnp.maximum(counts, 1.0)), jnp.nan)

    # broadcast back: each sample picks up its own bin's sums/counts
    dn_t = (((2,), (2,)), ((0,), (0,)))
    up_sn = jax.lax.dot_general(
        s_n, m, dn_t, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [C, 2P, R]
    up_s, up_n = up_sn[:, :P], up_sn[:, P:]
    up = jnp.where(up_n > 0, 10.0 * jnp.log10(up_s / jnp.maximum(up_n, 1.0)), jnp.nan)
    return down, up


@partial(jax.jit, static_argnames=("n_bins", "num_side_pings"))
def impulse_mask_grid_device(sv, bin_idx_grid, n_bins: int, num_side_pings: int, threshold):
    """Fused impulse-noise mask: down/up-sample + two-sided ping compare.

    Mirrors clean/utils.echopy_impulse_noise_mask on the upsampled Sv:
    lags outside the array and NaN diffs count as +inf (mask=True side).
    Requires P > num_side_pings (caller guards).
    """
    C, P, R = sv.shape
    _, up = downsample_upsample_grid_device(sv, bin_idx_grid, n_bins)
    m = num_side_pings
    inf_pad = jnp.full((C, m, R), jnp.inf, dtype=up.dtype)
    fwd = jnp.concatenate([up[:, : P - m] - up[:, m:], inf_pad], axis=1)
    bwd = jnp.concatenate([inf_pad, up[:, m:] - up[:, : P - m]], axis=1)
    fwd = jnp.where(jnp.isnan(fwd), jnp.inf, fwd)
    bwd = jnp.where(jnp.isnan(bwd), jnp.inf, bwd)
    return (fwd > threshold) & (bwd > threshold)


def pack_mask_device(m):
    """bool [..., R] -> bit-packed uint8 [..., ceil(R/8)] (np.packbits order).

    Packing masks on device cuts the device-to-host readback 8x.  Unpack on
    host with np.unpackbits(packed, axis=-1, count=R).
    """
    R = m.shape[-1]
    pad = (-R) % 8
    if pad:
        m = jnp.pad(m, [(0, 0)] * (m.ndim - 1) + [(0, pad)])
    mb = m.reshape(*m.shape[:-1], -1, 8).astype(jnp.uint8)
    w = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.uint8)
    return jnp.sum(mb * w, axis=-1).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("num_side_pings", "range_halo"))
def transient_mask_grid_packed(sv, grid, depth_bin, num_side_pings: int, exclude_above,
                               threshold, range_halo: int = 0):
    """transient_mask_grid_device with bit-packed readback."""
    return pack_mask_device(
        transient_mask_grid_device(
            sv, grid, depth_bin, num_side_pings, exclude_above, threshold, range_halo
        )
    )


@partial(jax.jit, static_argnames=("n_bins", "num_side_pings"))
def impulse_mask_grid_packed(sv, bin_idx_grid, n_bins: int, num_side_pings: int, threshold):
    """impulse_mask_grid_device with bit-packed readback."""
    return pack_mask_device(
        impulse_mask_grid_device(sv, bin_idx_grid, n_bins, num_side_pings, threshold)
    )


@partial(jax.jit, static_argnames=("s_max", "num_side_pings", "chunk"))
def attenuated_ping_mask_grid_device(
    sv, start_idx, widths, s_max: int, num_side_pings: int, threshold, chunk: int = 256
):
    """Per-ping attenuated-signal flags on a ping-invariant grid (device).

    The scattering layer is a contiguous range-index band on a monotone grid,
    so slab extraction is a per-channel dynamic_slice (no gather); block
    medians use 2W shifted slab copies, processed in ping chunks so the
    window tensor stays a few hundred MB, with one sort-based nanmedian per
    chunk.  Mirrors clean/utils.echopy_attenuated_signal_mask: block pings
    are p-W..p+W-1, flag when (ping_median - block_median) dB < threshold,
    pings whose window leaves [0, P) or whose slab is all-NaN stay False.

    sv: f4 [C, P, R]; start_idx: i32 [C] slab starts; widths: i32 [C] slab
    lengths (<= s_max).  Returns bool [C, P].
    """
    C, P, R = sv.shape
    W = int(num_side_pings)
    lin = jnp.power(10.0, sv / 10.0)

    linp = jnp.pad(lin, ((0, 0), (0, 0), (0, s_max)), constant_values=jnp.nan)
    slab = jax.vmap(
        lambda x, s: jax.lax.dynamic_slice(x, (0, s), (P, s_max))
    )(linp, start_idx)  # [C, P, s_max]
    colmask = jnp.arange(s_max)[None, :] < widths[:, None]
    slab = jnp.where(colmask[:, None, :], slab, jnp.nan)

    ping_med = 10.0 * jnp.log10(jnp.nanmedian(slab, axis=-1))  # [C, P]

    # block windows over pings, chunked
    n_chunks = -(-P // chunk)
    P_pad = n_chunks * chunk
    slab_p = jnp.pad(
        slab, ((0, 0), (W, W + P_pad - P), (0, 0)), constant_values=jnp.nan
    )

    def one_chunk(c0):
        win = jnp.stack(
            [
                jax.lax.dynamic_slice(slab_p, (0, c0 + o, 0), (C, chunk, s_max))
                for o in range(2 * W)
            ],
            axis=2,
        )  # [C, chunk, 2W, s_max]
        return jnp.nanmedian(win.reshape(C, chunk, 2 * W * s_max), axis=-1)

    block_med_lin = jax.lax.map(
        one_chunk, jnp.arange(0, P_pad, chunk)
    )  # [n_chunks, C, chunk]
    block_med = 10.0 * jnp.log10(
        jnp.moveaxis(block_med_lin, 0, 1).reshape(C, P_pad)[:, :P]
    )

    p_idx = jnp.arange(P)
    valid = (p_idx - W >= 0) & (p_idx + W <= P - 1)
    return ((ping_med - block_med) < threshold) & valid[None, :]


@partial(jax.jit, static_argnames=("n_bins",))
def downsample_upsample_depth_device(sv, bin_idx, n_bins: int):
    """Depth-bin linear mean then broadcast back per sample (device).

    bin_idx: i32 [C, P, R] nondecreasing along R (depth bins are contiguous
    runs — scatter-free: per-bin boundary positions come from one vmapped
    searchsorted, sums from cumsum band diffs).
    Returns (down [C, P, n_bins] dB, up [C, P, R] dB).
    """
    lin = jnp.power(10.0, sv / 10.0)
    lin_f = jnp.where(jnp.isnan(sv), 0.0, lin)
    cnt = (~jnp.isnan(sv)).astype(jnp.float32)

    def row_bounds(idx_row):
        return jnp.searchsorted(
            idx_row, jnp.arange(n_bins + 1, dtype=idx_row.dtype), side="left"
        ).astype(jnp.int32)

    xb = jax.vmap(jax.vmap(row_bounds))(bin_idx)  # [C, P, n_bins+1]
    lo, hi = xb[:, :, :-1], xb[:, :, 1:]
    sums = _cumsum_band_diff(lin_f, lo, hi, axis=2)
    counts = _cumsum_band_diff(cnt, lo, hi, axis=2)
    down = jnp.where(counts > 0, 10.0 * jnp.log10(sums / jnp.maximum(counts, 1.0)), jnp.nan)
    up = jnp.take_along_axis(down, bin_idx, axis=2)
    return down, up


def grid_window_halo(grid, depth_bin) -> int:
    """Static range-window extent in samples for a ping-invariant grid
    (host-side; feeds the blocked band path of the pooling kernels).

    Exact per-position extent via searchsorted — duplicate values
    (plateaus) widen the window beyond depth_bin/step, which a step-based
    estimate misses.  Returns 0 (the exact dense fallback) when any
    channel's finite prefix is not nondecreasing.  The result is rounded up
    to the next power of two so heterogeneous surveys (files differing only
    in sample spacing) hit a bounded set of jit specializations instead of
    one compile per distinct spacing."""
    import numpy as _np

    g2 = _np.atleast_2d(_np.asarray(grid, dtype="f8"))
    extent = 0
    for row in g2:
        raw_idx = _np.nonzero(_np.isfinite(row))[0]
        finite = row[raw_idx]
        if finite.size < 2:
            continue
        if (_np.diff(finite) < 0).any():
            return 0  # not monotone: only the dense band is correct
        # mirror the kernels' inclusive f32 boundary tolerance so the halo
        # always covers every sample the banded membership test can admit
        tol = 4.0 * _np.finfo(_np.float32).eps * (_np.abs(finite) + float(depth_bin))
        hi = _np.searchsorted(finite, finite + float(depth_bin) + tol, side="right")
        lo = _np.searchsorted(finite, finite - float(depth_bin) - tol, side="left")
        # extents in RAW sample indices: interior NaN holes make raw
        # distances exceed compacted ones, and the pooling kernels band
        # over raw positions (an underestimated halo silently drops
        # in-window members)
        extent = max(
            extent,
            int((raw_idx[hi - 1] - raw_idx).max()),
            int((raw_idx - raw_idx[lo]).max()),
        )
    if extent == 0:
        return 0
    return int(2 ** _np.ceil(_np.log2(extent + 1)))
