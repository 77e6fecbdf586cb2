"""Weill et al. (1993) MOVIES-B shoal contiguity detector.

Capability parity: echopype/mask/shoal_detection/shoal_weill.py:6 (echopy):
threshold, fill short vertical/horizontal gaps (not touching boundaries),
drop features below minimum extent.

Vectorized rework (round 3): every stage is a vectorized whole-image pass —
run-length gap filling via cumsum run ids + bincount, component extents via
labeled reductions — no per-ping or per-label Python loops (the r2
implementation was O(n_label * n_pixels)).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

from ...xrlite import DataArray

__all__ = ["shoal_weill", "fill_gaps_along_axis", "component_extent_filter"]


def fill_gaps_along_axis(mask: np.ndarray, max_gap: int, axis: int) -> np.ndarray:
    """Fill False runs of length <= max_gap not touching either boundary.

    Vectorized over every 1-D lane along ``axis`` at once: run ids from a
    cumsum over change points, run lengths from one bincount, boundary runs
    from the first/last rows.  O(n_pixels) total.
    """
    if max_gap <= 0:
        return mask
    m = np.moveaxis(mask, axis, 0)
    shape = m.shape
    flat = m.reshape(shape[0], -1)
    n = shape[0]
    if n == 0 or flat.shape[1] == 0:
        return mask
    notm = ~flat
    change = np.empty(flat.shape, dtype=np.int64)
    change[0] = 1
    change[1:] = flat[1:] != flat[:-1]
    rid = np.cumsum(change, axis=0)  # per-lane run ids starting at 1
    per_lane = rid[-1]
    offs = np.concatenate([[0], np.cumsum(per_lane)[:-1]])
    gid = rid + offs[None, :] - 1  # global run ids starting at 0
    total = int(per_lane.sum())
    sizes = np.bincount(gid[notm], minlength=total)
    boundary = np.zeros(total, dtype=bool)
    boundary[gid[0][notm[0]]] = True
    boundary[gid[-1][notm[-1]]] = True
    fill_run = (sizes <= max_gap) & ~boundary
    out_flat = flat | (notm & fill_run[gid])
    return np.moveaxis(out_flat.reshape(shape), 0, axis)


def component_extent_filter(
    mask: np.ndarray,
    labeled: np.ndarray,
    min_v: float,
    min_h: float,
    idim: np.ndarray = None,
    jdim: np.ndarray = None,
) -> np.ndarray:
    """Zero out components whose bounding-box extent is below (min_v, min_h).

    Extents come from labeled min/max reductions (one C pass each); physical
    edges ``idim``/``jdim`` (length n+1) convert index extents to units, as
    in the Echoview-style detector.  Index units when edges are None.
    """
    lab_max = int(labeled.max())
    if lab_max == 0:
        return mask
    index = np.arange(1, lab_max + 1)
    rows = np.broadcast_to(
        np.arange(mask.shape[0])[:, None], mask.shape
    )
    cols = np.broadcast_to(np.arange(mask.shape[1])[None, :], mask.shape)
    i0 = ndi.minimum(rows, labels=labeled, index=index).astype(int)
    i1 = ndi.maximum(rows, labels=labeled, index=index).astype(int)
    j0 = ndi.minimum(cols, labels=labeled, index=index).astype(int)
    j1 = ndi.maximum(cols, labels=labeled, index=index).astype(int)
    if idim is None:
        vlen = (i1 - i0 + 1).astype("f8")
    else:
        vlen = idim[i1 + 1] - idim[i0]
    if jdim is None:
        hlen = (j1 - j0 + 1).astype("f8")
    else:
        hlen = jdim[j1 + 1] - jdim[j0]
    bad = (vlen < min_v) | (hlen < min_h)
    lut = np.concatenate([[False], bad])  # label 0 = background, never bad
    return mask & ~lut[labeled]


def shoal_weill(
    ds,
    var_name: str = "Sv",
    channel: str = None,
    thr: float = -70.0,
    maxvgap: int = 5,
    maxhgap: int = 0,
    minvlen: int = 0,
    minhlen: int = 0,
) -> DataArray:
    if var_name not in ds:
        raise ValueError(f"Variable '{var_name}' not found in dataset")
    var = ds[var_name]
    if "channel" in var.dims:
        if channel is None:
            raise ValueError("Please specify 'channel' for multi-channel data.")
        var = var.sel(channel=channel)
    if not {"ping_time", "range_sample"} <= set(var.dims):
        raise ValueError(f"'{var_name}' must have dims ping_time and range_sample")

    sv = np.asarray(var.transpose("range_sample", "ping_time").values, dtype="f8")
    mask = sv > thr

    mask = fill_gaps_along_axis(mask, maxvgap, axis=0)
    mask = fill_gaps_along_axis(mask, maxhgap, axis=1)

    if minvlen > 0 or minhlen > 0:
        features = ndi.label(mask)[0]
        mask = component_extent_filter(mask, features, minvlen, minhlen)

    out = DataArray(
        mask.T.astype(bool),
        ("ping_time", "range_sample"),
        coords={
            "ping_time": ds.coords["ping_time"],
            "range_sample": ds.coords["range_sample"],
        },
        attrs={
            "description": f"Weill-style threshold+gap-fill mask on '{var_name}'",
            "threshold_dB": float(thr),
            "maxvgap": int(maxvgap),
            "maxhgap": int(maxhgap),
            "minvlen": int(minvlen),
            "minhlen": int(minhlen),
            **({"channel": str(channel)} if channel is not None else {}),
        },
        name="shoal_mask_weill",
    )
    return out
