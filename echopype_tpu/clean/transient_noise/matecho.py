"""Matecho-style deep-spike (transient) column detector.

Capability parity: echopype/clean/transient_noise/transient_matecho.py
(from Matecho's DeepSpikeDetection.m, Perrot et al. 2018): flag whole pings
whose deep-window linear-mean Sv exceeds a local percentile + delta_db.
Returned mask: True = VALID (keep).

Vectorized rework (round 3): the default path is a vectorized windowed
kernel — sliding-min bottom via a C minimum filter, per-ping deep means via
row-prefix sums, and the local percentile via tiled histogram CDFs (no
per-ping Python loop; scales to 1e6+ pings).  The histogram quantizes the
percentile to <= (data range)/n_bins (~0.03 dB at the 4096-bin default),
which only matters for pings within that margin of the +delta_db threshold;
``exact=True`` selects the reference-faithful per-ping percentile.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import ndimage as ndi

from ...utils.compute import _lin2log, _log2lin
from ...xrlite import DataArray

__all__ = ["transient_noise_matecho"]


def _sliding_min(x: np.ndarray, window_ping: int) -> np.ndarray:
    """min over the reference's [j - w//2, j + w//2) window per position."""
    size = max(1, 2 * (window_ping // 2))
    return ndi.minimum_filter1d(x, size=size, origin=0, mode="nearest")


def _matecho_fast(
    sv, r, bottom_depth, start_depth, window_meter, window_ping,
    percentile, delta_db, min_window, n_bins=4096, tile=4096,
):
    """Vectorized bad-ping detection; sv [range, ping], r ascending."""
    m_all, n_ping = sv.shape
    band = (r >= start_depth) & (r <= start_depth + window_meter)
    pings_bad = np.zeros(n_ping, dtype=bool)
    if not band.any() or n_ping == 0:
        return pings_bad
    A = sv[band]  # [m, n]
    r_band = r[band]
    m = A.shape[0]
    dr = r[1] - r[0] if len(r) > 1 else 1.0

    local_bottom = _sliding_min(bottom_depth, window_ping)
    # rows with r < local_bottom form a prefix of the (ascending) band
    k_j = np.searchsorted(r_band, local_bottom, side="left").astype(np.int64)
    H = dr * k_j
    eligible = (k_j > 0) & (H >= min_window)
    if not eligible.any():
        return pings_bad

    # per-ping deep mean at each cutoff: row-prefix sums of linear Sv
    with np.errstate(invalid="ignore", divide="ignore"):
        lin = _log2lin(A)
    finite = np.isfinite(lin)
    lin0 = np.where(finite, lin, 0.0)
    psum = np.concatenate([np.zeros((1, n_ping)), np.cumsum(lin0, axis=0)])
    pcnt = np.concatenate(
        [np.zeros((1, n_ping)), np.cumsum(finite, axis=0)]
    )
    cols = np.arange(n_ping)
    sums_j = psum[k_j, cols]
    cnts_j = pcnt[k_j, cols]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_db = _lin2log(sums_j / np.where(cnts_j > 0, cnts_j, np.nan))

    # Two-level histogram CDF of the window samples, tiled over pings:
    # a coarse pass (B1 bins) locates each query's percentile bin, a fine
    # pass (B2 bins inside the located coarse bin) refines it — effective
    # resolution B1*B2 = n_bins at ~B1-wide cumsum cost.
    finite_A = finite & ~np.isnan(A)
    vals = A[finite_A]
    if vals.size == 0:
        return pings_bad
    vmin, vmax = float(vals.min()), float(vals.max())
    span = max(vmax - vmin, 1e-12)
    B1 = max(16, int(np.sqrt(n_bins)))
    B2 = max(1, n_bins // B1)
    inv_w1 = B1 / span
    ibc_all = np.clip(((A - vmin) * inv_w1), 0, B1 - 1)
    ibc_all = np.where(finite_A, ibc_all, B1).astype(np.int64)  # NaN -> B1

    half = window_ping // 2
    q = percentile / 100.0

    def _window_cdf(ib, n_b, j0, j1, width_cols):
        """Windowed per-query CDF over n_b bins from per-column histograms."""
        col_ids = np.broadcast_to(np.arange(width_cols)[None, :], ib.shape)
        hist = np.bincount(
            (col_ids * (n_b + 1) + ib).ravel(),
            minlength=width_cols * (n_b + 1),
        ).reshape(width_cols, n_b + 1)[:, :n_b]
        pref = np.concatenate([np.zeros((1, n_b)), np.cumsum(hist, axis=0)])
        return np.cumsum(pref[j1] - pref[j0], axis=1)

    for lo in range(0, n_ping, tile):
        hi = min(lo + tile, n_ping)
        jq = np.arange(lo, hi)
        el = eligible[jq] & np.isfinite(mean_db[jq])
        if not el.any():
            continue
        c0 = max(0, lo - half)
        c1 = min(n_ping, hi + half)
        width = c1 - c0
        # unique row cutoffs among this tile's queries (bottom varies slowly)
        for k in np.unique(k_j[jq][el]):
            sel = el & (k_j[jq] == k)
            ibc = ibc_all[:k, c0:c1]
            j0 = np.maximum(0, jq[sel] - half) - c0
            j1 = np.minimum(n_ping, jq[sel] + half) - c0
            cdf = _window_cdf(ibc, B1, j0, j1, width)
            N = cdf[:, -1]
            ok = N > 0
            h = (np.maximum(N, 1) - 1) * q
            klo = np.floor(h)
            pos = np.minimum((cdf <= klo[:, None]).sum(axis=1), B1 - 1)
            rows_q = np.arange(len(pos))
            cdf_prev = np.where(pos > 0, cdf[rows_q, np.maximum(pos - 1, 0)], 0.0)
            pctl = np.empty(len(pos))
            # refine each coarse bin present among the queries
            Asub = A[:k, c0:c1]
            for b in np.unique(pos):
                qsel = pos == b
                b_lo = vmin + b * (span / B1)
                inv_w2 = B2 * inv_w1  # B2 bins across one coarse bin
                in_b = ibc == b
                ibf = np.clip(((Asub - b_lo) * inv_w2), 0, B2 - 1)
                ibf = np.where(in_b, ibf, B2).astype(np.int64)
                cdf_f = _window_cdf(ibf, B2, j0[qsel], j1[qsel], width)
                rank = (klo[qsel] - cdf_prev[qsel])[:, None]
                posf = np.minimum((cdf_f <= rank).sum(axis=1), B2 - 1)
                rf = np.arange(len(posf))
                prev_f = np.where(posf > 0, cdf_f[rf, np.maximum(posf - 1, 0)], 0.0)
                cnt_f = np.maximum(cdf_f[rf, posf] - prev_f, 1.0)
                frac = np.clip((rank[:, 0] - prev_f + 0.5) / cnt_f, 0.0, 1.0)
                pctl[qsel] = b_lo + (posf + frac) * (span / B1 / B2)
            flag = ok & (mean_db[jq[sel]] > pctl + delta_db)
            pings_bad[jq[sel]] = flag
    return pings_bad


def _matecho_exact(
    sv, r, bottom_depth, start_depth, window_meter, window_ping,
    percentile, delta_db, min_window,
):
    """Reference-faithful per-ping percentile (exact, O(n_ping) loop)."""
    n_ping = sv.shape[1]
    depth_mask = (r >= start_depth) & (r <= start_depth + window_meter)
    pings_bad = np.zeros(n_ping, dtype=bool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        for j in range(n_ping):
            j0 = max(0, j - window_ping // 2)
            j1 = min(n_ping, j + window_ping // 2)
            local_bottom = np.min(bottom_depth[j0:j1])
            refined = depth_mask & (r < local_bottom)
            if not refined.any():
                continue
            H = (r[1] - r[0]) * refined.sum()
            if H < min_window:
                continue
            sv_window = sv[refined, j0:j1]
            flat = sv_window[~np.isnan(sv_window)]
            if flat.size == 0:
                continue
            pctl = np.percentile(flat, percentile)
            ping_mean_db = _lin2log(np.nanmean(_log2lin(sv[refined, j])))
            if ping_mean_db > pctl + delta_db:
                pings_bad[j] = True
    return pings_bad


def _matecho_core(
    sv_rp,
    r,
    bottom_depth=None,
    start_depth=220,
    window_meter=450,
    window_ping=100,
    percentile=25,
    delta_db=12,
    extend_ping=0,
    min_window=20,
    exact=False,
    n_bins=4096,
):
    """sv_rp: [range, ping]; returns bad column mask [range, ping]."""
    sv = np.asarray(sv_rp, dtype="f8")
    r = np.asarray(r, dtype="f8")
    n_ping = sv.shape[1]
    if bottom_depth is None:
        bottom_depth = np.full(n_ping, r[-1], dtype="f8")
    else:
        bottom_depth = np.asarray(bottom_depth, dtype="f8").copy()
        bottom_depth[np.isnan(bottom_depth)] = r[-1]

    core = _matecho_exact if exact else _matecho_fast
    kw = {} if exact else {"n_bins": n_bins}
    pings_bad = core(
        sv, r, bottom_depth, start_depth, window_meter, window_ping,
        percentile, delta_db, min_window, **kw,
    )

    if extend_ping > 0 and pings_bad.any():
        pings_bad = ndi.binary_dilation(
            pings_bad, structure=np.ones(2 * extend_ping + 1, dtype=bool)
        )
    mask_bad = np.zeros_like(sv, dtype=bool)
    mask_bad[:, pings_bad] = True
    return mask_bad


def transient_noise_matecho(
    ds,
    var_name: str = "Sv",
    range_var: str = "depth",
    time_var: str = "ping_time",
    bottom_var=None,
    start_depth: float = 220,
    window_meter: float = 450,
    window_ping: int = 100,
    percentile: float = 25,
    delta_db: float = 12,
    extend_ping: int = 0,
    min_window: float = 20,
    exact: bool = False,
    n_bins: int = 4096,
) -> DataArray:
    """Per-channel Matecho detector; True = VALID (keep).

    exact=False (default): vectorized windowed-percentile kernel (histogram
    CDF, quantization <= data-range/n_bins dB).  exact=True: the
    reference-faithful per-ping np.percentile loop.
    """
    sv_da = ds[var_name]
    if time_var not in sv_da.dims:
        raise ValueError(f"{time_var!r} must be a dim of {var_name!r}.")
    sv = np.asarray(sv_da.values, dtype="f8")
    rvals = np.asarray(ds[range_var].values, dtype="f8")
    if rvals.ndim == 3:
        rvals = rvals[:, 0, :]
    elif rvals.ndim == 1:
        rvals = np.broadcast_to(rvals, (sv.shape[0], len(rvals)))
    bottom = None
    if bottom_var is not None and bottom_var in ds:
        bottom = np.asarray(ds[bottom_var].values, dtype="f8")

    bad = np.stack(
        [
            _matecho_core(
                sv[c].T,
                rvals[c],
                bottom_depth=bottom[c] if (bottom is not None and bottom.ndim == 2) else bottom,
                start_depth=start_depth,
                window_meter=window_meter,
                window_ping=window_ping,
                percentile=percentile,
                delta_db=delta_db,
                extend_ping=extend_ping,
                min_window=min_window,
                exact=exact,
                n_bins=n_bins,
            ).T
            for c in range(sv.shape[0])
        ]
    )
    out = DataArray(
        ~bad,
        sv_da.dims,
        attrs={"meaning": "True = VALID (False = transient noise)"},
        name="matecho_mask_valid",
    )
    out.coords = dict(sv_da.coords)
    return out
