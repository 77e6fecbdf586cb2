"""Host-side helpers for commongrid: bin parsing, edges, position reduction.

Capability parity: echopype/commongrid/utils.py.
"""

from __future__ import annotations

import re

import numpy as np

from ..ops.binning import bin_index_np, binned_mean_1d
from ..utils.geodesy import pairwise_distance_nmi
from ..xrlite import DataArray, Dataset

POSITION_VARIABLES = ("latitude", "longitude")

X_BIN_MAP = {
    "range_bin": {
        "name": "Range bin",
        "unit": "m",
        "ex": "10m",
        "unit_label": "meters",
        "pattern": r"([\d+]*[.,]{0,1}[\d+]*)(\s+)?(m)",
    },
    "dist_bin": {
        "name": "Distance bin",
        "unit": "nmi",
        "ex": "0.5nmi",
        "unit_label": "nautical miles",
        "pattern": r"([\d+]*[.,]{0,1}[\d+]*)(\s+)?(nmi)",
    },
}

__all__ = [
    "POSITION_VARIABLES",
    "_parse_x_bin",
    "_setup_and_validate",
    "ping_time_bin_edges",
    "get_distance_from_latlon",
    "get_reduced_positions",
    "parse_time_bin_to_value_unit",
]


def _parse_x_bin(x_bin: str, x_label="range_bin") -> float:
    """Parse '10m' / '0.5nmi' strings (commongrid/utils.py:305)."""
    info = X_BIN_MAP.get(x_label)
    if info is None:
        raise KeyError(f"x_label must be one of {list(X_BIN_MAP)}")
    if not isinstance(x_bin, str):
        raise TypeError("'x_bin' must be a string")
    m = re.match(info["pattern"], x_bin.strip().lower())
    if m is None:
        raise ValueError(
            f"{info['name']} must be in {info['unit_label']} (e.g., '{info['ex']}')."
        )
    return float(m.group(1))


def _setup_and_validate(ds_Sv: Dataset, range_var: str, range_bin: str, closed: str):
    if range_var not in ("echo_range", "depth"):
        raise ValueError("range_var must be one of 'echo_range' or 'depth'.")
    if range_var not in ds_Sv:
        raise ValueError(f"range_var '{range_var}' does not exist in the input dataset.")
    if closed not in ("left", "right"):
        raise ValueError(f"{closed} is not a valid option. Options are 'left' or 'right'.")
    range_bin_val = _parse_x_bin(range_bin, "range_bin")
    return ds_Sv, range_bin_val


_TIMEDELTA_UNIT_NS = {
    "d": 86_400 * 10**9, "day": 86_400 * 10**9, "days": 86_400 * 10**9,
    "h": 3_600 * 10**9, "hr": 3_600 * 10**9, "hour": 3_600 * 10**9,
    "hours": 3_600 * 10**9,
    "m": 60 * 10**9, "min": 60 * 10**9, "minute": 60 * 10**9,
    "minutes": 60 * 10**9,
    "s": 10**9, "sec": 10**9, "second": 10**9, "seconds": 10**9,
    "ms": 10**6, "milli": 10**6, "millis": 10**6, "millisecond": 10**6,
    "milliseconds": 10**6,
    "us": 10**3, "micro": 10**3, "micros": 10**3, "microsecond": 10**3,
    "microseconds": 10**3,
    "ns": 1, "nano": 1, "nanos": 1, "nanosecond": 1, "nanoseconds": 1,
}
_TIMEDELTA_TERM = re.compile(r"\s*(\d+(?:\.\d*)?|\.\d+)\s*([a-zA-Z]+)")


def _timedelta_ns(ping_time_bin: str) -> int:
    """'20s' / '0.5min' / '1h30min' -> integer nanoseconds (pd.Timedelta's
    string form, without pandas).  Units are case-insensitive, as pandas
    accepts the deprecated upper-case 'S'/'H'/'D' spellings."""
    if not isinstance(ping_time_bin, str):
        raise TypeError("ping_time_bin must be a string such as '20s'")
    text = ping_time_bin.strip()
    total, pos = 0, 0
    for m in _TIMEDELTA_TERM.finditer(text):
        if m.start() != pos:
            break
        unit = _TIMEDELTA_UNIT_NS.get(m.group(2).lower())
        if unit is None:
            raise ValueError(f"invalid time unit in ping_time_bin {ping_time_bin!r}")
        num = m.group(1)
        whole, _, frac = num.partition(".")
        ns = int(whole or 0) * unit
        if frac:
            ns += int(frac) * unit // 10 ** len(frac)
        total += ns
        pos = m.end()
    if pos == 0 or text[pos:].strip():
        raise ValueError(f"could not parse ping_time_bin {ping_time_bin!r}")
    if total <= 0:
        raise ValueError(f"ping_time_bin must be positive, got {ping_time_bin!r}")
    return total


def ping_time_bin_edges(ping_time: np.ndarray, ping_time_bin: str) -> np.ndarray:
    """Bin edges matching pandas resample semantics (commongrid/api.py:117-124).

    pandas' ``Series.resample(freq)`` with its defaults (closed='left',
    origin='start_day') floors the first ping onto the grid of ``freq``
    steps from midnight of its day and makes one bin per step through the
    bin holding the last ping; the final right edge is appended.
    """
    t = np.asarray(ping_time, dtype="datetime64[ns]")
    t = t[~np.isnat(t)].astype("i8")
    if t.size == 0:
        raise ValueError("ping_time holds no valid timestamps")
    step = _timedelta_ns(ping_time_bin)
    first, last = int(t.min()), int(t.max())
    day = 86_400 * 10**9
    origin = first - first % day
    start = first - (first - origin) % step
    n_bins = (last - start) // step + 1
    edges = start + np.arange(n_bins + 1, dtype="i8") * step
    return edges.astype("datetime64[ns]")


def parse_time_bin_to_value_unit(ping_time_bin: str):
    """'20s' -> (20, 'second'), for cell_methods attrs.

    The reference's algorithm (commongrid/utils.py:654-698) without pandas:
    pd.Timedelta's resolution_string picks the most granular unit with a
    nonzero component, the value is the integer count of that unit
    ('0.5min' -> (30, 'second')), and the unit labels come from its
    timedelta_units map (singular; note its us/ns entries deliberately map
    to millisecond).
    """
    ns = _timedelta_ns(ping_time_bin)
    # (unit ns, value divisor ns, label) from coarsest to finest resolution
    for unit_ns, div_ns, label in (
        (86_400 * 10**9, 86_400 * 10**9, "day"),
        (3_600 * 10**9, 3_600 * 10**9, "hour"),
        (60 * 10**9, 60 * 10**9, "minute"),
        (10**9, 10**9, "second"),
        (10**6, 10**6, "millisecond"),
        (10**3, 10**6, "millisecond"),
        (1, 10**6, "millisecond"),
    ):
        if ns % unit_ns == 0:
            return ns // div_ns, label
    raise AssertionError("unreachable: every ns count divides by 1")


def get_distance_from_latlon(ds_Sv: Dataset) -> np.ndarray:
    """Cumulative along-track distance [nmi] per ping (utils.py:210-231).

    Consecutive-segment geodesic distances -> cumulative sum -> ffill/bfill,
    replicating the reference's pandas shift(-1)/cumsum/ffill/bfill exactly.
    """
    lat = np.asarray(ds_Sv["latitude"].values, dtype="f8")
    lon = np.asarray(ds_Sv["longitude"].values, dtype="f8")
    good = ~(np.isnan(lat) | np.isnan(lon))
    if not good.any():
        raise ValueError("All lat/lon entries are NaN!")
    seg = pairwise_distance_nmi(lat, lon)  # seg[i] = dist(p_i, p_{i+1}); NaN-poisoned
    # reference drops rows with NaN current/next position before cumsum
    valid_seg = ~np.isnan(seg)
    dist = np.full(len(lat), np.nan)
    dist[valid_seg] = np.cumsum(seg[valid_seg])
    # ffill then bfill
    dist = _ffill_bfill(dist)
    return dist


def _ffill_bfill(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    mask = np.isnan(x)
    idx = np.where(~mask, np.arange(len(x)), 0)
    np.maximum.accumulate(idx, out=idx)
    x = x[idx]
    # bfill remaining leading NaNs
    mask = np.isnan(x)
    if mask.any() and (~mask).any():
        first_valid = np.argmax(~mask)
        x[:first_valid] = x[first_valid]
    return x


def get_reduced_positions(ds_Sv, ds_X, x_dim, x_idx, n_x):
    """Mean lat/lon per x bin attached to the output (utils.py:453-501).

    Host float64 bincount: positions need ~1e-6 deg accuracy (the output's
    geospatial attrs round to 1e-5), which f32 device reduction can't hold.
    """
    if all(v in ds_Sv for v in POSITION_VARIABLES):
        x_idx = np.asarray(x_idx)
        for var in POSITION_VARIABLES:
            v = np.asarray(ds_Sv[var].values, dtype="f8")
            ok = (x_idx >= 0) & np.isfinite(v)
            sums = np.bincount(x_idx[ok], weights=v[ok], minlength=n_x)
            cnts = np.bincount(x_idx[ok], minlength=n_x)
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = sums / np.where(cnts > 0, cnts, np.nan)
            ds_X[var] = ((x_dim,), vals, dict(ds_Sv[var].attrs))
    return ds_X


def ping_time_bin_parsing_and_conversion(ping_time_bin: str):
    """Reference-named alias of parse_time_bin_to_value_unit
    (reference: commongrid/utils.py:654-698)."""
    return parse_time_bin_to_value_unit(ping_time_bin)


def assign_actual_range(ds_MVBS: Dataset) -> Dataset:
    """Attach the Sv 'actual_range' attribute post-computation
    (reference: commongrid/utils.py:631-651)."""
    sv = np.asarray(ds_MVBS["Sv"].values, dtype="f8")
    actual_range = [
        round(float(np.nanmin(sv)), 2),
        round(float(np.nanmax(sv)), 2),
    ]
    return ds_MVBS.assign_attrs({"actual_range": actual_range})


def _binned_mean_to_db(sums, counts, nan_counts, fill_value):
    """Linear bin sums/counts -> dB, with flox's fill semantics.

    flox applies ``fill_value`` to bins with nothing aggregated, in the
    LINEAR domain, before the dB conversion (reference:
    commongrid/utils.py:76-92): a non-positive fill therefore comes out NaN
    in dB, NaN-poisoned bins (skipna=False) are never filled, and
    ``fill_value=None`` means NaN (flox's default).

    A bin whose members are ALL NaN-valued (at valid range coords,
    skipna=False) has counts==0 but WAS aggregated — flox leaves it NaN;
    only bins with nothing aggregated at all (counts==0 AND nan_counts==0)
    take the fill (round-5 soak campaign 7, skipna=False + whole-ping NaN).
    """
    from ..utils.compute import _lin2log

    with np.errstate(invalid="ignore", divide="ignore"):
        good = (counts > 0) & (nan_counts == 0)
        linear = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
        if fill_value is not None and not np.isnan(fill_value):
            linear = np.where((counts == 0) & (nan_counts == 0), fill_value, linear)
        return _lin2log(linear)


def _interval_edges(interval):
    """(edges, closed) from a pandas IntervalIndex or a 1-D edge array.

    An IntervalIndex carries its own closed side; plain edge arrays default
    to the reference's 'left'.
    """
    try:
        import pandas as pd

        if isinstance(interval, pd.IntervalIndex):
            closed = interval.closed if interval.closed in ("left", "right") else "left"
            return np.append(np.asarray(interval.left), interval.right[-1]), closed
    except ImportError:
        pass
    return np.asarray(interval), "left"


def compute_raw_MVBS(
    ds_Sv: Dataset,
    range_interval,
    ping_interval,
    range_var: str = "echo_range",
    method="map-reduce",
    reindex=False,
    skipna=True,
    fill_value=np.nan,
    **kwargs,
):
    """Raw (unformatted) MVBS on caller-provided bins, in dB.

    Reference-named intermediate entry point (reference:
    commongrid/utils.py:17-94): output dims are ``(dim0, {x}_bins,
    {range_var}_bins)`` with bin *left edges* as the binned coords (we use
    plain edge values where the reference carries pandas Interval objects).
    Accepts pandas IntervalIndexes or 1-D edge arrays.
    """
    from ..ops import binning

    range_edges, closed_r = _interval_edges(range_interval)
    range_edges = range_edges.astype("f8")
    ping_edges_raw, closed_p = _interval_edges(ping_interval)
    ping_edges = np.asarray(ping_edges_raw, dtype="datetime64[ns]")
    ping_time = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]")
    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    er = np.asarray(ds_Sv[range_var].values, dtype="f8")
    if er.shape != sv.shape:
        er = np.broadcast_to(er, sv.shape)
    x_bounds = binning.x_bounds_np(ping_time.astype("i8"), ping_edges.astype("i8"), closed_p)
    sums, counts, nan_w = binning.windowed_partials_np(
        sv.astype("f4"), er, range_edges, x_bounds,
        skipna=bool(skipna), closed=closed_r,
    )
    mvbs = _binned_mean_to_db(sums, counts, nan_w, fill_value)
    dim0 = ds_Sv["Sv"].dims[0]
    out = Dataset(
        coords={
            dim0: ds_Sv.coords[dim0],
            "ping_time_bins": ping_edges[:-1],
            f"{range_var}_bins": range_edges[:-1],
        }
    )
    out["Sv"] = ((dim0, "ping_time_bins", f"{range_var}_bins"), mvbs)
    return out


def compute_raw_NASC(
    ds_Sv: Dataset,
    range_interval,
    dist_interval,
    method="map-reduce",
    skipna=True,
    **kwargs,
):
    """Raw (unformatted) NASC on caller-provided bins.

    Reference-named intermediate entry point (reference:
    commongrid/utils.py:97-207).  ``ds_Sv`` must carry a ``distance_nmi``
    coordinate along the ping dim (the api-level compute_NASC derives it from
    lat/lon); output holds ``sv`` (= NASC), and the per-distance-bin mean
    ``ping_time``.
    """
    from ..ops import binning

    depth_edges, closed_r = _interval_edges(range_interval)
    depth_edges = depth_edges.astype("f8")
    dist_edges, closed_x = _interval_edges(dist_interval)
    dist_edges = dist_edges.astype("f8")
    dist = np.asarray(ds_Sv["distance_nmi"].values, dtype="f8")
    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    depth = np.asarray(ds_Sv["depth"].values, dtype="f8")
    if depth.shape != sv.shape:
        depth = np.broadcast_to(depth, sv.shape)
    n_x, n_r = len(dist_edges) - 1, len(depth_edges) - 1
    x_bounds = binning.x_bounds_np(dist, dist_edges, closed_x)
    x_idx = binning.bin_index_np(dist, dist_edges, closed_x)
    sums, counts, nan_w = binning.windowed_partials_np(
        sv.astype("f4"), depth, depth_edges, x_bounds,
        skipna=bool(skipna), closed=closed_r,
    )
    with np.errstate(invalid="ignore", divide="ignore"):
        good = (counts > 0) & (nan_w == 0)
        sv_mean = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
    ddepth = np.diff(depth, axis=2).astype("f4")
    h_num = binning.windowed_sum_raw_np(
        ddepth, depth[:, :, :-1], depth_edges, x_bounds,
        closed=closed_r,
    )
    denom = np.bincount(x_idx[x_idx >= 0], minlength=n_x).astype("f8")
    with np.errstate(invalid="ignore", divide="ignore"):
        h_mean = h_num / np.where(denom > 0, denom, np.nan)[None, :, None]
    nasc = sv_mean * h_mean * 4 * np.pi * 1852**2
    pt_ns = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8")
    in_bin = x_idx >= 0
    pt_rel = (pt_ns - pt_ns[0]).astype("f8")
    pt_sums = np.bincount(x_idx[in_bin], weights=pt_rel[in_bin], minlength=n_x)
    pt_cnts = np.bincount(x_idx[in_bin], minlength=n_x)
    with np.errstate(invalid="ignore", divide="ignore"):
        pt_mean = pt_ns[0] + pt_sums / np.where(pt_cnts > 0, pt_cnts, np.nan)
    pt_out = np.where(
        pt_cnts > 0, pt_mean, float(np.datetime64("NaT", "ns").astype("i8"))
    ).astype("i8").astype("datetime64[ns]")
    dim0 = ds_Sv["Sv"].dims[0]
    out = Dataset(
        coords={
            dim0: ds_Sv.coords[dim0],
            "distance_nmi_bins": dist_edges[:-1],
            "depth_bins": depth_edges[:-1],
        }
    )
    out["sv"] = ((dim0, "distance_nmi_bins", "depth_bins"), nasc)
    out["ping_time"] = (("distance_nmi_bins",), pt_out)
    return out
