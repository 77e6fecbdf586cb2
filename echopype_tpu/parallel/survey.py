"""Survey runner: stream converted stores through the device pipeline.

The domain's scale-out story (SURVEY.md §2.6): a survey is a sequence of
converted stores; each store's power block streams to the device in
ping-chunks, runs the fused calibration+binning step, and partial bin
sums+counts accumulate into survey-global MVBS bins.  Zarr stores are the
spill/checkpoint tier; HBM holds only the active chunk.  On a mesh, chunks
shard over the ping axis and partials combine with a psum (sharded step);
accumulation across chunks is associative so the stream order is free.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops import binning
from ..utils.compute import _lin2log
from ..utils.log import _init_logger
from ..utils.profiling import StageTimer
from ..xrlite import Dataset

logger = _init_logger(__name__)

__all__ = ["run_survey_mvbs", "run_survey_mvbs_from_raw", "run_survey_nasc"]


class _PartialAccumulator:
    """Host-side accumulator over window partials with one chunk of lag.

    jax dispatch is asynchronous: by deferring each chunk's device readback
    until the NEXT chunk has been dispatched, the device computes chunk k+1
    while the host blocks on chunk k's result (and decodes chunk k+2's
    input) — the double-buffering the chunk-serial loop lacked.
    """

    def __init__(self, n_ch, n_x, n_r, window, timer):
        self.sums = np.zeros((n_ch, n_x, n_r), dtype="f8")
        self.counts = np.zeros_like(self.sums)
        self.window = window
        self.n_x = n_x
        self.timer = timer
        self._pending = None

    def push(self, s, c, x_base, ch=None):
        prev, self._pending = self._pending, (s, c, x_base, ch)
        if prev is not None:
            self._drain(prev)

    def _drain(self, item):
        s, c, x_base, ch = item
        with self.timer.stage("accumulate"):
            # s/c may be device arrays or lists of per-channel device arrays;
            # read back in the on-device dtype (f4) and upcast DURING the
            # in-place add — the explicit f8 conversion materialized a
            # full-size temporary per chunk on the single shared core
            s = np.asarray([np.asarray(p) for p in s]) if isinstance(s, list) else np.asarray(s)
            c = np.asarray([np.asarray(p) for p in c]) if isinstance(c, list) else np.asarray(c)
            w_eff = min(self.window, self.n_x - x_base)
            if ch is not None:
                # single-channel partial (per-epoch fused streaming)
                self.sums[ch, x_base : x_base + w_eff] += s[:w_eff]
                self.counts[ch, x_base : x_base + w_eff] += c[:w_eff]
            else:
                self.sums[:, x_base : x_base + w_eff] += s[:, :w_eff]
                self.counts[:, x_base : x_base + w_eff] += c[:, :w_eff]

    def finish(self):
        if self._pending is not None:
            self._drain(self._pending)
            self._pending = None
        return self.sums, self.counts


def _mesh_layout(mesh, chunk_pings: int, n_channels: int):
    """Validate mesh axes against the workload; round chunk size up to the
    ping-shard count.  Returns (ping_shards, rounded_chunk_pings)."""
    if "ping" not in mesh.axis_names or "channel" not in mesh.axis_names:
        raise ValueError("survey mesh needs 'ping' and 'channel' axes (make_mesh)")
    if "range" in mesh.axis_names and mesh.shape["range"] != 1:
        raise ValueError("survey streaming shards ping/channel only; use range_axis=1")
    ch_shards = mesh.shape["channel"]
    if n_channels % ch_shards != 0:
        raise ValueError(
            f"{n_channels} channels not divisible by mesh channel axis {ch_shards}"
        )
    ping_shards = mesh.shape["ping"]
    return ping_shards, -(-chunk_pings // ping_shards) * ping_shards


def _global_ping_bins(pt_i8, ping_edges_i8, n_x):
    """Clip ping timestamps into global ping-bin ids.

    The window kernels (ops.binning.banded_x_reduce) locate bin boundaries by
    searching the id vector, which requires non-decreasing ids — so reversed
    timestamps must be repaired before streaming, the same ascending-time
    contract the reference enforces at combine (echodata/combine.py:458).
    """
    pt_i8 = np.asarray(pt_i8, dtype="i8")
    if pt_i8.size > 1 and np.any(np.diff(pt_i8) < 0):
        raise ValueError(
            "ping_time must be non-decreasing for survey streaming; repair "
            "reversed timestamps first (qc.coerce_increasing_time)"
        )
    return np.clip(
        np.searchsorted(ping_edges_i8, pt_i8, side="right") - 1, 0, n_x - 1
    ).astype("i4")


class _ScanUnavailable(Exception):
    """Extent scan could not cover this survey; use the eager two-pass path."""


def _resolve_freq_diff(freq_diff, chans, freq_nominal=None):
    """Resolve a frequency-differencing criterion to (ia, ib, op, diff_dB).

    Accepts the reference's equation strings ('"chA" - "chB" > 3dB' /
    '38kHz - 18kHz >= 10dB', mask/freq_diff.py) or a dict with
    chanA/chanB (or freqA/freqB), operator, diff.
    """
    if freq_diff is None:
        return None
    from ..mask.freq_diff import _parse_freq_diff_eq

    if isinstance(freq_diff, str):
        if '"' in freq_diff:
            freqAB, chanAB, op, diff = _parse_freq_diff_eq(chanABEq=freq_diff)
        else:
            freqAB, chanAB, op, diff = _parse_freq_diff_eq(freqABEq=freq_diff)
    elif isinstance(freq_diff, dict):
        chanAB = (
            [freq_diff["chanA"], freq_diff["chanB"]] if "chanA" in freq_diff else None
        )
        freqAB = (
            [freq_diff["freqA"], freq_diff["freqB"]] if "freqA" in freq_diff else None
        )
        op = freq_diff.get("operator", ">")
        diff = float(freq_diff["diff"])
    else:
        raise TypeError("freq_diff must be an equation string or a dict")

    chan_list = [str(c) for c in chans]
    if chanAB is not None:
        missing = [c for c in chanAB if c not in chan_list]
        if missing:
            raise ValueError(f"freq_diff channels not in survey: {missing}")
        ia, ib = chan_list.index(chanAB[0]), chan_list.index(chanAB[1])
    else:
        if freq_nominal is None:
            raise ValueError("frequency-based freq_diff needs frequency_nominal")
        fn = np.asarray(freq_nominal, dtype="f8")
        hitsA = np.nonzero(fn == freqAB[0])[0]
        hitsB = np.nonzero(fn == freqAB[1])[0]
        if len(hitsA) != 1 or len(hitsB) != 1:
            raise ValueError(
                f"freq_diff frequencies {freqAB} must match exactly one channel each"
            )
        ia, ib = int(hitsA[0]), int(hitsB[0])
    return ia, ib, op, float(diff)


class _PowerChunkStreamer:
    """Per-file chunk driver shared by the eager and prefetching power-mode
    survey paths: int16 conversion in reusable double buffers (single-core
    host: no temporaries; two int16 buffers alternate so the one a dispatched
    chunk may still be reading asynchronously is never overwritten, matching
    the accumulator's one-chunk lag), ping padding, and the fused
    window-partials dispatch."""

    def __init__(self, n_ch, chunk_pings, R_max, window, n_r, range_edges,
                 ship_i16, acc, timer):
        self.chunk_pings = chunk_pings
        self.window = window
        self.n_r = n_r
        self.r_edges_f4 = np.asarray(range_edges, dtype="f4")
        self.ship_i16 = ship_i16
        self.acc = acc
        self.timer = timer
        self.chunk_no = 0
        if ship_i16:
            from ..convert.simrad.decode import INDEX2POWER

            self.inv_scale = np.float32(1.0) / np.float32(INDEX2POWER)
            self.buf_f = np.empty((n_ch, chunk_pings, R_max), dtype="f4")
            self.bufs_i = [
                np.empty((n_ch, chunk_pings, R_max), dtype="<i2") for _ in range(2)
            ]

    def stream_file(self, chunk_partials, power, dr, shift, alpha, offset, r0,
                    x_idx_all, host_counts=None):
        """host_counts: optional (bounds, k0) from pipeline.closed_bounds_k0_np
        — counts then resolve closed-form on HOST per chunk and the kernel
        returns sums only, halving the [C, window, n_r] device-to-host
        readback."""
        import jax.numpy as jnp

        timer, acc, chunk_pings, window = (
            self.timer, self.acc, self.chunk_pings, self.window
        )
        n_ping = power.shape[1]
        # ragged pings pad with a NaN suffix, so finite-count == valid length
        valid_len = (~np.isnan(power)).sum(axis=2).astype("i4")
        for lo in range(0, n_ping, chunk_pings):
            hi = min(lo + chunk_pings, n_ping)
            pad = chunk_pings - (hi - lo)
            sl = slice(lo, hi)
            x_base = int(x_idx_all[lo])

            def _pad2(a, fill=0.0):
                a = np.asarray(a[:, sl], dtype="f4")
                return np.pad(a, ((0, 0), (0, pad)), constant_values=fill) if pad else a

            with timer.stage("device_mvbs"):
                if self.ship_i16:
                    from .. import native

                    R_f = power.shape[2]
                    bi = self.bufs_i[self.chunk_no % 2][:, :, :R_f]
                    self.chunk_no += 1
                    # one-pass C++ conversion (rint + NaN->0 + i16 store);
                    # numpy 4-pass chain is the fallback, bit-identical
                    done = isinstance(power, np.ndarray) and all(
                        native.f32_to_i16_scaled(
                            np.asarray(power[c, sl]), bi[c, : hi - lo],
                            float(self.inv_scale),
                        )
                        for c in range(power.shape[0])
                    )
                    if not done:
                        bf = self.buf_f[:, : hi - lo, :R_f]
                        np.multiply(power[:, sl], self.inv_scale, out=bf)
                        np.rint(bf, out=bf)
                        np.nan_to_num(bf, copy=False)  # NaN -> 0 (masked by valid_len)
                        bi[:, : hi - lo] = bf
                    if pad:
                        bi[:, hi - lo :] = 0  # padded pings excluded via valid_len == 0
                    p_chunk = bi
                else:
                    p_chunk = np.asarray(power[:, sl], dtype="f4")
                    if pad:  # NaN power contributes nothing to any bin
                        p_chunk = np.pad(p_chunk, ((0, 0), (0, pad), (0, 0)),
                                         constant_values=np.nan)
                x_rel = x_idx_all[sl] - x_base
                if pad:  # padded pings park past the bin window
                    x_rel = np.pad(x_rel, (0, pad), constant_values=window)
                vl_chunk = valid_len[:, sl]
                if pad:  # padded pings contribute no samples
                    vl_chunk = np.pad(vl_chunk, ((0, 0), (0, pad)))
                kargs = (
                    p_chunk, _pad2(dr, 1.0), _pad2(shift), _pad2(alpha), _pad2(offset),
                    jnp.asarray(vl_chunk), jnp.asarray(x_rel.astype("i4")),
                    jnp.asarray(self.r_edges_f4), _pad2(r0),
                )
                if host_counts is None:
                    s, c = chunk_partials(*kargs)
                else:
                    from .pipeline import closed_window_counts_np

                    s = chunk_partials(*kargs)
                    c = closed_window_counts_np(
                        host_counts[0], host_counts[1], vl_chunk, x_rel, window
                    )
            acc.push(s, c, x_base)


_NOISE_MASKS = ("impulse", "transient", "attenuated")


def _apply_noise_masks(ds, sv_all, noise_masks, timer):
    """NaN out samples flagged by the requested clean masks, per file.

    Runs the clean subsystem's device kernels on the full file (the streamer
    already materializes each file's Sv), so the streamed cleaned MVBS/NASC is
    bin-exact with the reference composition clean.mask_* -> apply_mask ->
    compute_X applied file-by-file (reference: clean/api.py:30-359,
    mask/api.py:467-675) — without ever writing a masked full-resolution Sv.
    Masks combine with OR: a sample flagged by any detector joins no bin.
    """
    from .. import clean as _clean

    fns = {
        "impulse": _clean.mask_impulse_noise,
        "transient": _clean.mask_transient_noise,
        "attenuated": _clean.mask_attenuated_signal,
    }
    flagged = None
    with timer.stage("noise_masks"):
        for kind, params in noise_masks.items():
            if kind not in fns:
                raise ValueError(
                    f"unknown noise mask {kind!r}; options: {_NOISE_MASKS}"
                )
            m = np.asarray(fns[kind](ds, **dict(params or {})).values, dtype=bool)
            flagged = m if flagged is None else (flagged | m)
    if flagged is not None:
        sv_all = np.where(flagged, np.nan, sv_all)
    return sv_all


def _fd_mask_jit(fd):
    """jit'd cross-channel frequency-differencing mask: NaN out samples
    failing the criterion on every channel (apply_mask semantics)."""
    import jax
    import jax.numpy as jnp

    from .pipeline import _CMP

    ia, ib, opr, diff = fd

    @jax.jit
    def _masked(sv):
        keep = _CMP[opr](sv[ia] - sv[ib], jnp.float32(diff))
        return jnp.where(keep[None], sv, jnp.nan)

    return _masked


def _fd_masked_step(step, fd, masked=None):
    """Wrap a binning step so the fd mask applies on device before bins.

    Pass an already-built ``masked`` fn to share one jit cache entry when
    the caller also applies the mask elsewhere (e.g. the grid fast path)."""
    if masked is None:
        masked = _fd_mask_jit(fd)
    return lambda sv, er, re, xr: step(masked(sv), er, re, xr)


def _uniform_grid_row(arr):
    """Ping-invariant [C, P, R] range operand -> ([C, R] row, ok).

    ok is False when some ping has a NaN hole where the row is finite
    (per-ping holes the row cannot represent) — callers keep the full
    per-ping path then."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        row = np.nanmax(arr, axis=1)  # [C, R]
    ok = not np.any(np.isnan(arr) & ~np.isnan(row)[:, None, :])
    return row, ok


def _resolve_bin_m(range_bin, range_bin_m, name="range_bin") -> float:
    """Reference-style bin strings ('20m') are the primary survey-runner
    spelling, like compute_MVBS (commongrid/api.py); bare floats-in-meters
    and the legacy ``range_bin_m=`` kwarg stay as deprecated aliases."""
    if range_bin_m is not None:
        return float(range_bin_m)
    if isinstance(range_bin, str):
        from ..commongrid.utils import _parse_x_bin

        return _parse_x_bin(range_bin, name)
    return float(range_bin)


def run_survey_mvbs(
    sv_sources,
    range_bin="20m",
    ping_time_bin: str = "20s",
    range_var: str = "echo_range",
    chunk_pings: int = 5000,
    timer: StageTimer = None,
    mesh=None,
    freq_diff=None,
    noise_masks=None,
    reopen=None,
    range_bin_m: float = None,
):
    """Stream Sv stores/datasets into survey-global MVBS bins.

    range_bin : reference-style bin string ('20m', like compute_MVBS) or a
        bare float in meters; ``range_bin_m=`` is the deprecated alias.
    sv_sources : iterable of Dataset, store paths, or zero-argument callables
        returning a Dataset (calibrated Sv datasets, chronologically
        ordered).  Callables let a caller stream per-file Sv lazily (the
        raw->MVBS streamer's internal two-pass noise-mask path).
    reopen : re-acquire each source in the binning pass instead of keeping
        every dataset from the extent scan — O(one file) host memory at the
        cost of a second open/decode.  Default (None) resolves to True only
        when every source is a PATH (paths re-open cheaply and
        side-effect-free); in-memory Datasets and user callables keep the
        keep-open behavior unless reopen=True is passed explicitly (a
        callable would otherwise be invoked twice).
    mesh : optional jax.sharding.Mesh with (ping, channel) axes — each chunk
        shards over the mesh and partial bin sums combine with one psum
        (SURVEY.md §2.6 scale-out; bit-equal to the single-device stream).
    freq_diff : optional frequency-differencing criterion ('"chA" - "chB" >
        3dB', '120kHz - 38kHz > 6dB', or a dict); the mask fuses into the
        device binning pass (apply_mask semantics: masked samples join no
        bin on any channel) so masked MVBS costs no extra HBM traffic.
    noise_masks : optional dict of clean-subsystem masks to fuse into the
        stream, e.g. ``{"impulse": dict(depth_bin="5m", num_side_pings=2),
        "transient": {...}, "attenuated": {...}}`` — each value is the
        keyword dict for the matching ``clean.mask_*`` function.  Flagged
        samples join no bin; result is bin-exact with running the clean
        masks + apply_mask + compute_MVBS per file.
    Returns an MVBS Dataset on the union (ping_time-bin, range-bin) grid.
    """
    from ..commongrid.utils import ping_time_bin_edges
    from ..utils.io import open_source

    timer = timer or StageTimer()
    range_bin_m = _resolve_bin_m(range_bin, range_bin_m)

    # sources normalize to zero-arg providers so the scan can drop each
    # dataset after measuring it (reopen=True) or keep it (default)
    sv_sources = list(sv_sources)
    if reopen is None:
        # only paths auto-reopen: re-opening is cheap and side-effect-free;
        # a user callable must not be silently invoked twice
        reopen = all(isinstance(s, (str, Path)) for s in sv_sources) and bool(sv_sources)
    providers = [
        src if callable(src) else (lambda s=src: open_source(s, "dataset"))
        for src in sv_sources
    ]
    if not providers:
        raise ValueError("no Sv sources provided")

    # pass 1: global extents + per-file metadata (ping times, uniformity)
    datasets = [None] * len(providers)
    ping_times_all, uniform_flags = [], []
    chans = None
    freq_nom = None
    with timer.stage("scan_extents"):
        t_min = t_max = None
        r_max = 0.0
        for i, provider in enumerate(providers):
            ds = provider()
            pt = np.asarray(ds.coords["ping_time"].values, dtype="datetime64[ns]")
            ping_times_all.append(pt)
            t_min = pt.min() if t_min is None else min(t_min, pt.min())
            t_max = pt.max() if t_max is None else max(t_max, pt.max())
            r_max = max(r_max, float(np.nanmax(np.asarray(ds[range_var].values, dtype="f8"))))
            uniform_flags.append(binning.er_is_uniform(np.asarray(ds[range_var].values)))
            if chans is None:
                chans = list(ds.coords["channel"].values)
                freq_nom = ds.get("frequency_nominal")
            elif list(ds.coords["channel"].values) != chans:
                raise ValueError("all Sv sources must share the same channels")
            if not reopen:
                datasets[i] = ds

    ping_edges = ping_time_bin_edges(
        np.array([t_min, t_max], dtype="datetime64[ns]"), ping_time_bin
    )
    range_edges = np.arange(0, r_max + range_bin_m, range_bin_m)
    n_x, n_r = len(ping_edges) - 1, len(range_edges) - 1

    if mesh is not None:
        _, chunk_pings = _mesh_layout(mesh, chunk_pings, len(chans))

    # per-dataset global ping-bin ids + the widest bin window any chunk spans
    # (static so every chunk runs the same jitted window kernel)
    edges_i8 = ping_edges.astype("datetime64[ns]").astype("i8")
    x_ids = []
    window = 1
    for pt in ping_times_all:
        x = _global_ping_bins(pt.astype("i8"), edges_i8, n_x)
        x_ids.append(x)
        for lo in range(0, len(x), chunk_pings):
            hi = min(lo + chunk_pings, len(x))
            window = max(window, int(x[hi - 1] - x[lo]) + 1)

    # cancellation-free range reduction whenever every file's range grid is
    # ping-invariant (binning.er_is_uniform; quiet bins lose everything to
    # f32 prefix cancellation otherwise)
    uniform = all(uniform_flags)
    if mesh is not None:
        from .pipeline import sharded_binned_partials, sharded_binned_partials_grid

        step = sharded_binned_partials(mesh, window, uniform_er=uniform)
        _grid_fn = sharded_binned_partials_grid(mesh, window)
    else:
        step = lambda sv, er, re, xr: binning.binned_window_partials(  # noqa: E731
            sv, er, re, xr, window, uniform_er=uniform
        )
        _grid_fn = lambda sv, row, re, xr: binning.binned_window_partials_grid(  # noqa: E731
            sv, row, re, xr, window
        )

    fd = _resolve_freq_diff(freq_diff, chans, freq_nom)
    masked = _fd_mask_jit(fd) if fd is not None else None
    if fd is not None:
        step = _fd_masked_step(step, fd, masked=masked)

    def grid_step(sv, row, re, xr):
        # uniform-grid fast path: one [C, R] range row per file instead of a
        # [C, P, R] er operand per chunk (ops/binning.py grid variants;
        # sharded twin on the mesh)
        if masked is not None:
            sv = masked(sv)
        return _grid_fn(sv, row, re, xr)

    acc = _PartialAccumulator(len(chans), n_x, n_r, window, timer)
    # membership resolves on host in f64 and ships as idx+0.5 vs integer
    # edges (binning.exact_bin_encode_np), so the in-kernel f32 comparisons
    # are exact on every path — the streamers previously kept the raw-f32
    # one-ulp edge behavior the host entries were fixed for (round-4 advice)
    enc_edges = np.arange(n_r + 1, dtype="f4")
    for i, x_idx_all in enumerate(x_ids):
        ds = datasets[i]
        if ds is None:  # reopen=True: pass-2 re-acquire, one file in memory
            with timer.stage("reopen"):
                ds = providers[i]()
        sv_all = np.asarray(ds["Sv"].values, dtype="f4")
        if noise_masks:
            sv_all = _apply_noise_masks(ds, sv_all, noise_masks, timer)
        er_all = np.asarray(ds[range_var].values, dtype="f8")
        if er_all.shape != sv_all.shape:
            er_all = np.broadcast_to(er_all, sv_all.shape)
        use_grid = uniform
        if use_grid:
            er_row, use_grid = _uniform_grid_row(er_all)
            if use_grid:
                er_row = binning.exact_bin_encode_np(er_row, range_edges)[0]
        n_ping = sv_all.shape[1]
        for lo in range(0, n_ping, chunk_pings):
            hi = min(lo + chunk_pings, n_ping)
            pad = chunk_pings - (hi - lo)
            x_base = int(x_idx_all[lo])
            with timer.stage("device_binning"):
                sv_chunk = sv_all[:, lo:hi]
                x_rel = x_idx_all[lo:hi] - x_base
                if pad:
                    # padded pings: NaN data parked past the bin window
                    sv_chunk = np.pad(
                        sv_chunk, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan
                    )
                    x_rel = np.pad(x_rel, (0, pad), constant_values=window)
                if use_grid:
                    s, c, _ = grid_step(sv_chunk, er_row, enc_edges, x_rel.astype("i4"))
                else:
                    er_chunk = binning.exact_bin_encode_np(
                        er_all[:, lo:hi], range_edges
                    )[0]
                    if pad:
                        er_chunk = np.pad(
                            er_chunk, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan
                        )
                    s, c, _ = step(sv_chunk, er_chunk, enc_edges, x_rel.astype("i4"))
            acc.push(s, c, x_base)
    sums, counts = acc.finish()

    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            mvbs = np.where(counts > 0, _lin2log(sums / np.maximum(counts, 1)), np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "ping_time": ping_edges[:-1],
                range_var: range_edges[:-1],
            }
        )
        out["Sv"] = (("channel", "ping_time", range_var), mvbs)
        out.attrs["stage_timing"] = str(timer.report(log=False))
    return out


def run_survey_nasc(
    sv_sources,
    range_bin: str = "10m",
    dist_bin: str = "0.5nmi",
    chunk_pings: int = 5000,
    timer: StageTimer = None,
    mesh=None,
    skipna: bool = True,
    closed: str = "left",
    noise_masks=None,
):
    """Stream Sv stores/datasets into survey-global NASC (distance × depth).

    The multi-file, optionally multi-chip NASC path: cumulative along-track
    distance continues across files (inter-file geodesic gap included), each
    ping chunk reduces on device via the chunk-invariant window kernels, and
    with ``mesh`` the partials combine with one psum over the ping axis.
    Physics contract: commongrid.compute_NASC (reference
    commongrid/api.py:270-416, utils.py:97-207) — bin-exact with it on a
    single concatenated dataset.

    sv_sources : iterable of Dataset or store paths, chronologically ordered,
        each holding Sv + depth + latitude/longitude (consolidate.add_depth /
        add_location outputs).
    noise_masks : optional dict of clean-subsystem masks fused into the
        stream (see run_survey_mvbs); flagged samples join no bin.
    """
    from ..commongrid.utils import _parse_x_bin, get_distance_from_latlon
    from ..utils.geodesy import pairwise_distance_nmi
    from ..utils.io import open_source
    from ..utils.prov import echopype_prov_attrs

    timer = timer or StageTimer()
    range_bin_m = _parse_x_bin(range_bin, "range_bin")
    dist_bin_nmi = _parse_x_bin(dist_bin, "dist_bin")

    # pass 1: per-file cumulative distance (global, gap-linked), depth extent
    datasets, dists, depth_all = [], [], []
    offset = 0.0
    prev_fix = None
    depth_max = 0.0
    with timer.stage("scan_extents"):
        for src in sv_sources:
            ds = open_source(src, "dataset")
            if "depth" not in ds:
                raise ValueError(
                    "Input Sv dataset must contain 'depth' (use consolidate.add_depth)"
                )
            datasets.append(ds)
            d = get_distance_from_latlon(ds)
            lat = np.asarray(ds["latitude"].values, dtype="f8")
            lon = np.asarray(ds["longitude"].values, dtype="f8")
            good = np.nonzero(~(np.isnan(lat) | np.isnan(lon)))[0]
            if prev_fix is not None and len(good):
                gap = pairwise_distance_nmi(
                    np.array([prev_fix[0], lat[good[0]]]),
                    np.array([prev_fix[1], lon[good[0]]]),
                )[0]
                if np.isfinite(gap):
                    offset += float(gap)
            dists.append(d + offset)
            offset = float(dists[-1][-1])
            if len(good):
                prev_fix = (lat[good[-1]], lon[good[-1]])
            depth = np.asarray(ds["depth"].values, dtype="f8")
            depth_all.append(depth)
            depth_max = max(depth_max, float(np.nanmax(depth)))
        if not datasets:
            raise ValueError("no Sv sources provided")

    chans = list(datasets[0].coords["channel"].values)
    for ds in datasets[1:]:
        if list(ds.coords["channel"].values) != chans:
            raise ValueError("all Sv sources must share the same channels")
    if mesh is not None:
        _, chunk_pings = _mesh_layout(mesh, chunk_pings, len(chans))

    dist_max = max(float(np.nanmax(d)) for d in dists)
    dist_edges = np.arange(0, dist_max + dist_bin_nmi, dist_bin_nmi)
    depth_edges = np.arange(0, depth_max + range_bin_m, range_bin_m)
    n_x, n_r = len(dist_edges) - 1, len(depth_edges) - 1

    # distance-bin ids per file (cumulative distance is nondecreasing)
    x_ids = []
    window = 1
    for d in dists:
        side = "right" if closed == "left" else "left"
        x = np.clip(np.searchsorted(dist_edges, d, side=side) - 1, 0, n_x - 1).astype("i4")
        x_ids.append(x)
        for lo in range(0, len(x), chunk_pings):
            hi = min(lo + chunk_pings, len(x))
            window = max(window, int(x[hi - 1] - x[lo]) + 1)

    uniform = all(binning.er_is_uniform(d) for d in depth_all)
    if mesh is not None:
        from .pipeline import (
            sharded_binned_partials,
            sharded_binned_partials_grid,
            sharded_binned_row_sum,
            sharded_binned_sum_raw,
        )

        step_sv = sharded_binned_partials(
            mesh, window, skipna=bool(skipna), closed=closed, uniform_er=uniform
        )
        step_h = sharded_binned_sum_raw(mesh, window, closed=closed, uniform_er=uniform)
        grid_sv_fn = sharded_binned_partials_grid(
            mesh, window, skipna=bool(skipna), closed=closed
        )
        grid_h_fn = sharded_binned_row_sum(mesh, window, closed=closed)
    else:
        step_sv = lambda sv, er, re, xr: binning.binned_window_partials(  # noqa: E731
            sv, er, re, xr, window, skipna=bool(skipna), closed=closed,
            uniform_er=uniform,
        )
        step_h = lambda v, er, re, xr: binning.binned_window_sum_raw(  # noqa: E731
            v, er, re, xr, window, closed=closed, uniform_er=uniform
        )
        grid_sv_fn = lambda sv, row, re, xr: binning.binned_window_partials_grid(  # noqa: E731
            sv, row, re, xr, window, skipna=bool(skipna), closed=closed
        )
        grid_h_fn = lambda v, row, re, xr: binning.binned_window_row_sum(  # noqa: E731
            v, row, re, xr, window, closed=closed
        )

    C = len(chans)
    sums = np.zeros((C, n_x, n_r), dtype="f8")
    counts = np.zeros_like(sums)
    nan_counts = np.zeros_like(sums)
    h_num = np.zeros_like(sums)
    denom = np.zeros(n_x, dtype="f8")
    # t0-relative ns so f8 sums stay exact (absolute ns-epoch overflows f8 ulp)
    t0_ns = int(
        np.asarray(datasets[0].coords["ping_time"].values[0], dtype="datetime64[ns]").astype("i8")
    )
    pt_sum = np.zeros(n_x, dtype="f8")
    pt_cnt = np.zeros(n_x, dtype="f8")
    have_pos = all("latitude" in ds and "longitude" in ds for ds in datasets)
    pos_sum = np.zeros((2, n_x), dtype="f8")
    pos_cnt = np.zeros((2, n_x), dtype="f8")

    # membership (depth vs depth_edges) resolves on host in f64 and ships
    # encoded (idx+0.5 vs integer edges, binning.exact_bin_encode_np) so the
    # in-kernel f32 comparisons are edge-exact; ddep stays PHYSICAL depth
    # differences (it is the height integrand, not a membership operand)
    enc_d_edges = np.arange(n_r + 1, dtype="f4")
    for ds, depth, x_idx_all in zip(datasets, depth_all, x_ids):
        sv_all = np.asarray(ds["Sv"].values, dtype="f4")
        if noise_masks:
            sv_all = _apply_noise_masks(ds, sv_all, noise_masks, timer)
        from ..commongrid.api import _conform_range, _orient_range_axis

        depth_b = np.broadcast_to(
            _conform_range(depth, ds, "depth", sv_all.shape), sv_all.shape
        )
        sv_all, depth_b = _orient_range_axis(sv_all, depth_b)
        # uniform grids (the instrument norm): ship ONE [C, R] depth row per
        # file instead of [C, P, R] depth + ddep + dep_lower per chunk — 4x
        # less transfer/HBM traffic, and the height sums collapse to a row
        # matmul times per-bin ping counts (ops/binning.py grid variants;
        # sharded twins in parallel/pipeline.py for the mesh path)
        use_grid = uniform
        if use_grid:
            depth_row, use_grid = _uniform_grid_row(depth_b)
            if use_grid:
                ddep_row = np.diff(depth_row, axis=1).astype("f4")
                dep_lower_row = binning.exact_bin_encode_np(
                    depth_row[:, :-1], depth_edges, closed
                )[0]
                depth_row = binning.exact_bin_encode_np(
                    depth_row, depth_edges, closed
                )[0]
        pt_i8 = np.asarray(
            ds.coords["ping_time"].values, dtype="datetime64[ns]"
        ).astype("i8")
        n_ping = sv_all.shape[1]
        for lo in range(0, n_ping, chunk_pings):
            hi = min(lo + chunk_pings, n_ping)
            pad = chunk_pings - (hi - lo)
            x_base = int(x_idx_all[lo])
            with timer.stage("device_binning"):
                sv_chunk = sv_all[:, lo:hi]
                x_rel = x_idx_all[lo:hi] - x_base
                if pad:
                    sv_chunk = np.pad(
                        sv_chunk, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan
                    )
                    x_rel = np.pad(x_rel, (0, pad), constant_values=window)
                if not use_grid:
                    dep_phys = depth_b[:, lo:hi]
                    ddep = np.diff(dep_phys, axis=2).astype("f4")
                    dep_chunk = binning.exact_bin_encode_np(
                        dep_phys, depth_edges, closed
                    )[0]
                    dep_lower = dep_chunk[:, :, :-1]
                    if pad:
                        dep_chunk = np.pad(
                            dep_chunk, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan
                        )
                        ddep = np.pad(
                            ddep, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan
                        )
                        dep_lower = np.pad(
                            dep_lower, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan
                        )
                x_rel = x_rel.astype("i4")
                if use_grid:
                    s, c, nc = grid_sv_fn(sv_chunk, depth_row, enc_d_edges, x_rel)
                    h = grid_h_fn(ddep_row, dep_lower_row, enc_d_edges, x_rel)
                else:
                    s, c, nc = step_sv(sv_chunk, dep_chunk, enc_d_edges, x_rel)
                    h = step_h(ddep, dep_lower, enc_d_edges, x_rel)
            with timer.stage("accumulate"):
                w_eff = min(window, n_x - x_base)
                sums[:, x_base : x_base + w_eff] += np.asarray(s, dtype="f8")[:, :w_eff]
                counts[:, x_base : x_base + w_eff] += np.asarray(c, dtype="f8")[:, :w_eff]
                nan_counts[:, x_base : x_base + w_eff] += np.asarray(nc, dtype="f8")[
                    :, :w_eff
                ]
                h_num[:, x_base : x_base + w_eff] += np.asarray(h, dtype="f8")[:, :w_eff]
                bc = np.bincount(x_idx_all[lo:hi], minlength=n_x).astype("f8")
                denom += bc
                pt_sum += np.bincount(
                    x_idx_all[lo:hi],
                    weights=(pt_i8[lo:hi] - t0_ns).astype("f8"),
                    minlength=n_x,
                )
                pt_cnt += bc
                if have_pos:
                    for k, var in enumerate(("latitude", "longitude")):
                        v = np.asarray(ds[var].values, dtype="f8")[lo:hi]
                        ok = np.isfinite(v)
                        pos_sum[k] += np.bincount(
                            x_idx_all[lo:hi][ok], weights=v[ok], minlength=n_x
                        )
                        pos_cnt[k] += np.bincount(x_idx_all[lo:hi][ok], minlength=n_x)

    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            good = (counts > 0) & (nan_counts == 0)
            sv_mean = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
            h_mean = h_num / np.where(denom > 0, denom, np.nan)[None, :, None]
            nasc = sv_mean * h_mean * 4 * np.pi * 1852**2
            pt_mean = t0_ns + pt_sum / np.where(pt_cnt > 0, pt_cnt, np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "distance": dist_edges[:-1],
                "depth": depth_edges[:-1],
            }
        )
        out["NASC"] = (
            ("channel", "distance", "depth"),
            nasc,
            {
                "long_name": "Nautical Areal Scattering Coefficient (NASC, m2 nmi-2)",
                "units": "m2 nmi-2",
            },
        )
        pt_out = np.where(np.isfinite(pt_mean), pt_mean, np.datetime64("NaT", "ns").astype("i8"))
        out["ping_time"] = (
            ("distance",),
            pt_out.astype("i8").astype("datetime64[ns]"),
            {"long_name": "Mean ping time in distance bin"},
        )
        if have_pos:
            with np.errstate(invalid="ignore", divide="ignore"):
                for k, var in enumerate(("latitude", "longitude")):
                    out[var] = (
                        ("distance",),
                        pos_sum[k] / np.where(pos_cnt[k] > 0, pos_cnt[k], np.nan),
                    )
        out.coords["distance"].attrs = {"long_name": "Cumulative distance", "units": "nmi"}
        out.coords["depth"].attrs = {"long_name": "Cell depth", "units": "m"}
        prov = echopype_prov_attrs("processing")
        prov["processing_function"] = "parallel.run_survey_nasc"
        out.attrs.update(prov)
        out.attrs["stage_timing"] = str(timer.report(log=False))
    return out


def _slice_echodata_pings(ed, beam_path, sl):
    """Shallow EchoData whose beam group is ping-sliced (chunked calibration)."""
    from ..echodata.echodata import EchoData

    tree = dict(ed._tree)
    tree[beam_path] = tree[beam_path].isel(ping_time=sl)
    return EchoData(tree=tree, source_file=ed.source_file, sonar_model=ed.sonar_model)


def _make_power_cal(ed, sonar_model, env_params, cal_params):
    """Power-mode calibrator for one converted file (shared by the serial
    ingest path and the multi-process decode pool)."""
    from ..calibrate.azfp import CalibrateAZFP
    from ..calibrate.ek import CalibrateEK60
    from ..calibrate.ek80 import CalibrateEK80

    if sonar_model in ("EK60", "ES70"):
        return CalibrateEK60(ed, env_params, cal_params)
    if sonar_model in ("EK80", "ES80", "EA640"):
        return CalibrateEK80(
            ed, env_params, cal_params, waveform_mode="CW", encode_mode="power"
        )
    if sonar_model in ("AZFP", "AZFP6"):
        return CalibrateAZFP(ed, env_params, cal_params)
    raise ValueError(f"unsupported power-mode sonar model {sonar_model!r}")


def _sanitize_power_cal_inputs(power, *params):
    """Make fused-kernel inputs NaN-safe with compute_Sv's exact semantics.

    The composed path's Sv is NaN wherever ANY per-ping cal param (dr /
    tvg_shift / alpha / offset / r0) is NaN — missing pings (a channel
    absent at some union ping_times), and whole channels when the
    reference's own cal-param chain yields NaN (e.g. a channel whose FIRST
    ping is missing resolves an all-NaN gain offset; our compute_Sv matches
    that reference behavior to 3e-14 dB).  The fused kernels cannot carry
    the NaNs: per-channel bin bounds derive from ``dr[:, 0]`` and
    closed-form counts from ``k0(dr, shift)``, so a NaN row poisons whole
    chunks (NaN bounds -> empty membership) or whole window bins (NaN
    counts through the banded matmul) — found by the `survey` soak mode.

    Exclusion instead mirrors the composition exactly: every (channel,
    ping) with a NaN param gets its POWER row forced to NaN (float path:
    NaN Sv joins no bin; int path: valid_len == 0 -> zero closed-form
    counts) and the param NaNs are then replaced by any finite per-channel
    value (1.0 when a channel has none) purely to keep bounds/k0 finite —
    the filled pings contribute nothing.
    """
    power = np.asarray(power)
    params = [np.asarray(a) for a in params]
    bad = None
    for a in params:
        nan = np.isnan(a)
        if nan.any():
            bad = nan if bad is None else (bad | nan)
    if bad is None:
        return (power, *params)
    # rows where power is present but a param is NaN -> exclude like the
    # composed path (power-all-NaN rows are already excluded)
    with np.errstate(invalid="ignore"):
        present = ~np.isnan(power).all(axis=-1)
    kill = bad & present
    if kill.any():
        power = power.astype("f4", copy=True) if power.dtype.kind != "f" else power.copy()
        power[kill] = np.nan
    out = []
    for a in params:
        nan = np.isnan(a)
        if nan.any():
            a = a.copy()
            for c in range(a.shape[0]):
                if nan[c].any():
                    finite = a[c][~nan[c]]
                    a[c][nan[c]] = finite[0] if finite.size else 1.0
        out.append(a)
    return (power, *out)


def _pin_worker_to_cpu():
    """Decode-pool initializer: keep the worker's JAX on the CPU platform.

    A worker that initialized an accelerator backend would reserve most of
    the card's memory beside the parent process; pinning the platform
    before any JAX use keeps the card to the parent alone.
    """
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def _pool_decode_one(args):
    """Worker-process body: decode + resolve one raw file to kernel inputs.

    Files are independent (SURVEY.md §2.6 file-level parallelism), so ingest
    scales across cores with a process pool — each worker runs the full
    open_raw + host param resolution and returns the dense kernel inputs.
    Workers run on the CPU platform (_pin_worker_to_cpu).
    """
    path, sonar_model, use_swap, xml_path, env_params, cal_params = args
    from ..convert.api import open_raw

    ed = open_raw(path, sonar_model=sonar_model, use_swap=use_swap, xml_path=xml_path)
    cal = _make_power_cal(ed, sonar_model, env_params, cal_params)
    vals = cal._power_cal_inputs("Sv")
    if sonar_model in ("AZFP", "AZFP6"):
        power, dr, shift, alpha, offset, r0 = vals
    else:
        power, dr, shift, alpha, offset, _ = vals
        r0 = np.zeros_like(dr)
    power, dr, shift, alpha, offset, r0 = _sanitize_power_cal_inputs(
        power, dr, shift, alpha, offset, r0
    )
    return {
        "inputs": (power, dr, shift, alpha, offset, r0),
        "ping_time": np.asarray(
            cal.beam.coords["ping_time"].values, dtype="datetime64[ns]"
        ),
        "channels": [str(c) for c in cal.beam.coords["channel"].values],
        "frequency_nominal": np.asarray(
            cal.beam["frequency_nominal"].values, dtype="f8"
        ),
    }


def run_survey_mvbs_from_raw(
    raw_files,
    sonar_model: str = "EK60",
    range_bin="20m",
    ping_time_bin: str = "20s",
    chunk_pings: int = 5000,
    env_params=None,
    cal_params=None,
    use_swap="auto",
    xml_path=None,
    timer: StageTimer = None,
    mesh=None,
    waveform_mode=None,
    encode_mode=None,
    device_fused: bool = False,
    prefetch: bool = True,
    freq_diff=None,
    workers: int = 0,
    noise_masks=None,
    range_bin_m: float = None,
):
    """Stream RAW instrument files straight into survey-global MVBS bins.

    range_bin : reference-style bin string ('20m', like compute_MVBS) or a
        bare float in meters; ``range_bin_m=`` is the deprecated alias.

    The fast path: per file, calibration parameters resolve on
    host (user dict > vendor tables > defaults, as in compute_Sv) and each
    ping-chunk runs the fused closed-counts kernel with the full-resolution
    Sv never materialized, int16 power scaled in-kernel, and the ping axis
    reduced by a chunk-invariant banded matmul
    (pipeline.sv_mvbs_window_partials).
    EK60/ES70, EK80/ES80/EA640 power mode, and AZFP (affine echo_range via
    the r0 intercept).

    mesh : optional jax.sharding.Mesh with (ping, channel) axes — each chunk
        shards over the mesh and the closed-counts partials combine with one
        psum before host accumulation.
    waveform_mode / encode_mode : pass ("BB"|"FM"|"CW", "complex") for EK80
        complex/broadband channels — pulse compression then runs on device
        inside the chunk loop and the chunked Sv feeds the same window
        binning (reference behavior contract: ek80_complex.py:316-369).
    device_fused : complex channels only — run pulse compression, received
        power, Sv, and binning as ONE device program per chunk
        (ops/bb_pipeline.py): complex samples go up once as split f32 and
        only bin partials come back.  Float32 end to end (~1e-3 dB of the
        float64 chunked path).  Multi-``filter_time`` files stream as one
        device program per (channel, filter epoch), partitioned exactly like
        the chunked path (calibrate/api.epoch_slice_dicts).
    prefetch : EK60/ES70 local files — replace the two-pass eager ingest
        (decode every file, then stream) with a single decode pass: a
        header-only extent scan fixes the global bin grids up front, then a
        background thread decodes file N+1 while file N's chunks occupy the
        host->device transfers.  O(one file) memory instead of O(survey) and
        ingest overlaps transfer waits; bins are identical to the eager
        path.  Falls back to eager automatically on remote paths, corrupt
        framing, or other sonar models.
    freq_diff : optional frequency-differencing criterion ('"chA" - "chB" >
        3dB', '120kHz - 38kHz > 6dB', or a dict).  The mask fuses INTO the
        Sv+binning device kernel (pipeline.sv_mvbs_window_partials_freqdiff
        for power mode; bb_chunk_sv + masked binning for complex/BB, incl.
        device_fused) — a masked-MVBS survey never materializes
        full-resolution Sv.  Power mode uses the eager ingest path;
        multi-filter_time complex files calibrate full-file so every
        channel is sample-aligned before the mask.
    workers : decode raw files in N worker PROCESSES (spawn pool), one file
        per task (files are independent — SURVEY.md §2.6 file-level
        parallelism).  Host decode is the serial bottleneck once the device
        pipeline saturates; N cores decode N files concurrently.  0 = the
        in-process path (decode-ahead thread when prefetch=True).
    noise_masks : optional dict of clean-subsystem masks, e.g.
        ``{"impulse": dict(depth_bin="5m"), "transient": {...}}``.  The
        windowed detectors need full-FILE Sv context, so the stream runs
        two-pass internally: each file calibrates to a full Sv dataset (any
        mode), the masks NaN flagged samples, and the chunked binning
        consumes it with O(one file) host memory (reopen).  Bin-exact with
        clean.mask_* -> apply_mask -> compute_MVBS per file.

    Returns an MVBS Dataset on the global (ping_time-bin, range-bin) grid.
    """
    import jax
    import jax.numpy as jnp

    from ..calibrate.azfp import CalibrateAZFP
    from ..calibrate.ek import CalibrateEK60
    from ..calibrate.ek80 import CalibrateEK80
    from ..commongrid.utils import ping_time_bin_edges
    from ..convert.api import open_raw

    range_bin_m = _resolve_bin_m(range_bin, range_bin_m)
    if noise_masks is not None:
        # the clean windowed detectors need full-FILE Sv context, which the
        # chunked streamers never materialize.  Stream two-pass internally:
        # each file calibrates to a full Sv dataset (any mode — power,
        # complex CW, BB, multi-filter_time), the clean masks + binning
        # consume it, and reopen=True keeps host memory at O(one file) by
        # re-decoding in the binning pass (reference composes these freely
        # over dask: clean/api.py:30-511 -> mask/api.py:467 -> commongrid).
        from ..calibrate.api import compute_Sv

        def _provider(f):
            def _open():
                ed = open_raw(f, sonar_model=sonar_model, use_swap=use_swap,
                              xml_path=xml_path)
                kw = dict(env_params=env_params, cal_params=cal_params)
                if waveform_mode or encode_mode:
                    kw.update(waveform_mode=waveform_mode, encode_mode=encode_mode)
                return compute_Sv(ed, **kw)
            return _open

        return run_survey_mvbs(
            [_provider(f) for f in raw_files],
            range_bin_m=range_bin_m, ping_time_bin=ping_time_bin,
            chunk_pings=chunk_pings, timer=timer, mesh=mesh,
            freq_diff=freq_diff, noise_masks=noise_masks, reopen=True,
        )
    if encode_mode == "complex" or waveform_mode in ("BB", "FM"):
        return _run_survey_mvbs_complex(
            raw_files, sonar_model, waveform_mode, encode_mode, range_bin_m,
            ping_time_bin, chunk_pings, env_params, cal_params, use_swap,
            xml_path, timer, mesh, device_fused, freq_diff=freq_diff,
        )

    if sonar_model in ("EK60", "ES70"):
        def _make_cal(ed):
            return CalibrateEK60(ed, env_params, cal_params)
    elif sonar_model in ("EK80", "ES80", "EA640"):
        def _make_cal(ed):
            return CalibrateEK80(ed, env_params, cal_params,
                                 waveform_mode="CW", encode_mode="power")
    elif sonar_model in ("AZFP", "AZFP6"):
        def _make_cal(ed):
            return CalibrateAZFP(ed, env_params, cal_params)
    else:
        raise ValueError(
            "run_survey_mvbs_from_raw supports EK60/ES70/EK80/ES80/EA640/"
            "AZFP/AZFP6 power mode; calibrate other data to Sv stores and "
            "use run_survey_mvbs"
        )
    timer = timer or StageTimer()
    raw_files = list(raw_files)

    if prefetch and freq_diff is None and not workers and sonar_model in ("EK60", "ES70"):
        try:
            return _run_survey_mvbs_streamed(
                raw_files, sonar_model, range_bin_m, ping_time_bin,
                chunk_pings, env_params, use_swap, xml_path, timer, mesh,
                _make_cal,
            )
        except _ScanUnavailable as e:
            logger.warning(
                f"extent scan unavailable ({e}); using eager two-pass ingest"
            )

    # pass 1: ingest + param resolution (host; optionally a process pool)
    if not raw_files:
        raise ValueError("no raw files provided")
    inputs, ping_times, chans = [], [], None
    freq_nominal = None
    if workers and len(raw_files) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with timer.stage("ingest"):
            ctx = mp.get_context("spawn")
            work = [
                (f, sonar_model, use_swap, xml_path, env_params, cal_params)
                for f in raw_files
            ]
            with ProcessPoolExecutor(
                max_workers=min(workers, len(raw_files)), mp_context=ctx,
                initializer=_pin_worker_to_cpu,
            ) as ex:
                results = list(ex.map(_pool_decode_one, work))
        for res in results:
            inputs.append(res["inputs"])
            ping_times.append(res["ping_time"])
            if chans is None:
                chans = res["channels"]
                freq_nominal = res["frequency_nominal"]
            elif res["channels"] != chans:
                raise ValueError("all raw files must share the same channels")
    else:
        cals = []
        with timer.stage("ingest"):
            for f in raw_files:
                ed = open_raw(f, sonar_model=sonar_model, use_swap=use_swap,
                              xml_path=xml_path)
                try:
                    cal = _make_cal(ed)
                except Exception as e:  # noqa: BLE001 - actionable guidance
                    raise ValueError(
                        f"{f}: could not set up power-mode calibration "
                        f"({e!r}). Complex/broadband-only files need the "
                        "store-based path: compute_Sv(...) then run_survey_mvbs."
                    ) from e
                cals.append(cal)
                ping_times.append(
                    np.asarray(cal.beam.coords["ping_time"].values, dtype="datetime64[ns]")
                )
        chans = list(cals[0].beam.coords["channel"].values)
        freq_nominal = np.asarray(cals[0].beam["frequency_nominal"].values, dtype="f8")
        for cal in cals[1:]:
            if list(cal.beam.coords["channel"].values) != chans:
                raise ValueError("all raw files must share the same channels")
        for cal in cals:
            vals = cal._power_cal_inputs("Sv")
            if sonar_model in ("AZFP", "AZFP6"):
                power, dr, shift, alpha, offset, r0 = vals
            else:
                power, dr, shift, alpha, offset, _ = vals
                r0 = np.zeros_like(dr)
            power, dr, shift, alpha, offset, r0 = _sanitize_power_cal_inputs(
                power, dr, shift, alpha, offset, r0
            )
            inputs.append((power, dr, shift, alpha, offset, r0))

    # global bin grids
    t_min = min(pt.min() for pt in ping_times)
    t_max = max(pt.max() for pt in ping_times)
    ping_edges = ping_time_bin_edges(
        np.array([t_min, t_max], dtype="datetime64[ns]"), ping_time_bin
    )
    r_max = 0.0
    for power, dr, shift, alpha, offset, r0 in inputs:
        # last SAMPLE is at r0 + (R-1)*dr — *R overcounted a sample and
        # could add a trailing empty bin vs compute_MVBS's grid (round-5
        # survey soak, bin-edge-straddling seed)
        r_max = max(
            r_max,
            float(np.nanmax(r0)) + float(np.nanmax(dr)) * (power.shape[2] - 1),
        )
    range_edges = np.arange(0, r_max + range_bin_m, range_bin_m)
    n_x, n_r = len(ping_edges) - 1, len(range_edges) - 1

    if mesh is not None:
        _, chunk_pings = _mesh_layout(mesh, chunk_pings, len(chans))

    # global ping-bin ids per file + widest bin window any chunk spans (the
    # static window keeps every chunk on one jitted kernel, and the windowed
    # matmul reduction makes partials chunking- and mesh-invariant)
    ping_edges_i8 = ping_edges.astype("datetime64[ns]").astype("i8")
    x_ids = []
    window = 1
    for pt in ping_times:
        x = _global_ping_bins(pt.astype("i8"), ping_edges_i8, n_x)
        x_ids.append(x)
        for lo in range(0, len(x), chunk_pings):
            hi = min(lo + chunk_pings, len(x))
            window = max(window, int(x[hi - 1] - x[lo]) + 1)

    # per-channel-uniform dr/shift (and no range intercept) unlocks the
    # hoisted-spreading fast path: one log10 row per channel instead of one
    # per element (~1.25x, the op is transcendental-bound)
    uniform = all(
        np.all(d == d[:, :1]) and np.all(sh == sh[:, :1]) and not np.any(r0_)
        for (_, d, sh, _, _, r0_) in inputs
    )

    fd = _resolve_freq_diff(freq_diff, chans, freq_nominal)
    if fd is not None:
        ia, ib, opr, diff = fd
        if mesh is not None:
            from .pipeline import sharded_mvbs_partials_freqdiff

            _fd_step = sharded_mvbs_partials_freqdiff(mesh, window, n_r, ia, ib, opr)

            def _chunk_partials(power, dr, shift, alpha, offset, valid_len,
                                x_rel, r_edges, r0):
                return _fd_step(power, dr, shift, alpha, offset, valid_len,
                                x_rel, r_edges, r0, np.float32(diff))
        else:
            from .pipeline import sv_mvbs_window_partials_freqdiff

            @jax.jit
            def _chunk_partials(power, dr, shift, alpha, offset, valid_len,
                                x_rel, r_edges, r0):
                return sv_mvbs_window_partials_freqdiff(
                    power, dr, shift, alpha, offset, valid_len, x_rel,
                    r_edges, window, n_r, ia, ib, opr, jnp.float32(diff),
                    r0=r0,
                )
    elif mesh is not None:
        from .pipeline import sharded_mvbs_partials_closed

        _chunk_partials = sharded_mvbs_partials_closed(mesh, window, n_r,
                                                       uniform=uniform)
    elif uniform:
        from .pipeline import sv_mvbs_window_partials_uniform

        @jax.jit
        def _chunk_partials(power, dr, shift, alpha, offset, valid_len, x_rel, r_edges, r0):
            # counts resolve closed-form on host (closed_bounds_k0_np below):
            # sums-only readback
            return sv_mvbs_window_partials_uniform(
                power, dr, shift, alpha, offset, valid_len, x_rel, r_edges,
                window, n_r, with_counts=False,
            )
    else:
        from .pipeline import sv_mvbs_window_partials

        @jax.jit
        def _chunk_partials(power, dr, shift, alpha, offset, valid_len, x_rel, r_edges, r0):
            # closed-form-counts windowed core: two matmuls, no Sv, no ok-mask
            return sv_mvbs_window_partials(
                power, dr, shift, alpha, offset, valid_len, x_rel, r_edges,
                window, n_r, r0=r0,
            )

    acc = _PartialAccumulator(len(chans), n_x, n_r, window, timer)
    # EK power is int16 * INDEX2POWER: recover the exact indices and ship
    # int16 to the device (scaling happens in-kernel) — half the
    # host-to-device bytes, bit-identical bins.
    ship_i16 = sonar_model in ("EK60", "ES70", "EK80", "ES80", "EA640")
    R_max = max(p.shape[2] for p, *_ in inputs)
    streamer = _PowerChunkStreamer(len(chans), chunk_pings, R_max, window, n_r,
                                   range_edges, ship_i16, acc, timer)
    host_counts_on = uniform and fd is None and mesh is None
    if host_counts_on:
        from .pipeline import closed_bounds_k0_np
    for (power, dr, shift, alpha, offset, r0), x_idx_all in zip(inputs, x_ids):
        hc = (
            closed_bounds_k0_np(dr[:, 0], shift[:, 0], range_edges, power.shape[2])
            if host_counts_on else None
        )
        streamer.stream_file(
            _chunk_partials, power, dr, shift, alpha, offset, r0, x_idx_all,
            host_counts=hc,
        )
    sums, counts = acc.finish()

    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            mvbs = np.where(counts > 0, _lin2log(sums / np.maximum(counts, 1)), np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "ping_time": ping_edges[:-1],
                "echo_range": range_edges[:-1],
            }
        )
        out["Sv"] = (("channel", "ping_time", "echo_range"), mvbs)
        out.attrs["stage_timing"] = str(timer.report(log=False))
    return out


def _run_survey_mvbs_streamed(
    raw_files, sonar_model, range_bin_m, ping_time_bin, chunk_pings,
    env_params, use_swap, xml_path, timer, mesh, make_cal,
):
    """Single-pass power-mode survey streamer with a decode-ahead thread.

    Pass 0 is a header-only extent scan (framing.scan_ek_extent, ~100 bytes
    read per datagram): the unique RAW0 timestamps ARE the decoded beam
    ping_time union, so the global ping bins are exact, and the instrument's
    recorded sample counts/intervals/sound velocities bound the range grid —
    kernels run on the bound, and the exact survey grid (a prefix of it,
    since bins are aligned multiples of range_bin_m from 0) is trimmed at
    finalize.  Each file then decodes on a background thread while the
    previous file's chunks occupy the GIL-releasing host->device transfers,
    so ingest CPU rides the transfer waits and at most two files are ever
    resident: O(file) memory instead of O(survey).

    Raises _ScanUnavailable (caller falls back to the eager two-pass path,
    which computes identical bins — asserted by tests) when any file is
    remote, corrupt, or has no RAW0 data.  The "ingest" stage total is
    measured on the worker thread and overlaps other stages, so stage sums
    may exceed wall time.
    """
    import jax
    from concurrent.futures import ThreadPoolExecutor

    from ..commongrid.utils import ping_time_bin_edges
    from ..convert.api import open_raw
    from ..convert.simrad.framing import CorruptDatagramError, scan_ek_extent
    from ..utils.io import is_remote_path

    if not raw_files:
        raise ValueError("no raw files provided")
    if any(is_remote_path(f) for f in raw_files):
        raise _ScanUnavailable("remote raw files")
    with timer.stage("scan"):
        try:
            scans = [scan_ek_extent(f) for f in raw_files]
        except (CorruptDatagramError, OSError) as e:
            raise _ScanUnavailable(str(e)) from e
    if any(len(s.times) == 0 for s in scans):
        raise _ScanUnavailable("file with no RAW0 datagrams")

    t_min = min(s.times[0] for s in scans)
    t_max = max(s.times[-1] for s in scans)
    ping_edges = ping_time_bin_edges(
        np.array([t_min, t_max], dtype="datetime64[ns]"), ping_time_bin
    )
    n_x = len(ping_edges) - 1

    # range-grid bound covering any resolved sound speed (user/env/measured)
    c_bound = max(1700.0, *(s.max_sound_velocity for s in scans))
    if env_params and isinstance(env_params.get("sound_speed"), (int, float)):
        c_bound = max(c_bound, float(env_params["sound_speed"]))
    r_bound = (
        max(s.max_count for s in scans)
        * max(s.max_interval for s in scans)
        * c_bound
        / 2.0
    )
    range_edges = np.arange(0, r_bound + range_bin_m, range_bin_m)
    n_r = len(range_edges) - 1

    if mesh is not None:
        _, chunk_pings = _mesh_layout(mesh, chunk_pings, scans[0].n_channels)

    # per-file global ping-bin ids + widest bin window any chunk spans
    ping_edges_i8 = ping_edges.astype("datetime64[ns]").astype("i8")
    x_ids = []
    window = 1
    for s in scans:
        x = _global_ping_bins(s.times.astype("i8"), ping_edges_i8, n_x)
        x_ids.append(x)
        for lo in range(0, len(x), chunk_pings):
            hi = min(lo + chunk_pings, len(x))
            window = max(window, int(x[hi - 1] - x[lo]) + 1)

    # kernel per uniformity (hoisted-spreading fast path when dr/shift are
    # per-channel constants), built lazily; window/n_r are static across files
    kernels = {}

    def get_kernel(uniform):
        if uniform not in kernels:
            if mesh is not None:
                from .pipeline import sharded_mvbs_partials_closed

                kernels[uniform] = sharded_mvbs_partials_closed(
                    mesh, window, n_r, uniform=uniform
                )
            elif uniform:
                from .pipeline import sv_mvbs_window_partials_uniform

                @jax.jit
                def _k(power, dr, shift, alpha, offset, valid_len, x_rel, r_edges, r0):
                    # counts resolve closed-form on host: sums-only readback
                    return sv_mvbs_window_partials_uniform(
                        power, dr, shift, alpha, offset, valid_len, x_rel,
                        r_edges, window, n_r, with_counts=False,
                    )

                kernels[uniform] = _k
            else:
                from .pipeline import sv_mvbs_window_partials

                @jax.jit
                def _k(power, dr, shift, alpha, offset, valid_len, x_rel, r_edges, r0):
                    return sv_mvbs_window_partials(
                        power, dr, shift, alpha, offset, valid_len, x_rel,
                        r_edges, window, n_r, r0=r0,
                    )

                kernels[uniform] = _k
        return kernels[uniform]

    def load(f):
        with timer.stage("ingest"):
            ed = open_raw(f, sonar_model=sonar_model, use_swap=use_swap,
                          xml_path=xml_path)
            try:
                cal = make_cal(ed)
            except Exception as e:  # noqa: BLE001 - surface actionable guidance
                raise ValueError(
                    f"{f}: could not set up power-mode calibration ({e!r})."
                ) from e
            pt = np.asarray(
                cal.beam.coords["ping_time"].values, dtype="datetime64[ns]"
            )
            chans = list(cal.beam.coords["channel"].values)
            power, dr, shift, alpha, offset, _ = cal._power_cal_inputs("Sv")
            power, dr, shift, alpha, offset = _sanitize_power_cal_inputs(
                power, dr, shift, alpha, offset
            )
            return power, dr, shift, alpha, offset, pt, chans

    def warm(f):
        # queue kernel readahead of file f so the decode thread's read is
        # warm: POSIX_FADV_WILLNEED costs no host CPU (no Python memcpy)
        # and is a no-op when the file is already cached
        import os as _os

        try:
            fd = _os.open(str(f), _os.O_RDONLY)
            try:
                _os.posix_fadvise(fd, 0, 0, _os.POSIX_FADV_WILLNEED)
            finally:
                _os.close(fd)
        except (OSError, AttributeError):
            pass

    acc = streamer = chans0 = None
    r_max_true = 0.0
    with ThreadPoolExecutor(max_workers=1) as ex, \
            ThreadPoolExecutor(max_workers=1) as warm_ex:
        fut = ex.submit(load, raw_files[0])
        if len(raw_files) > 1:
            warm_ex.submit(warm, raw_files[1])
        for i in range(len(raw_files)):
            power, dr, shift, alpha, offset, pt, chans = fut.result()
            if i + 1 < len(raw_files):
                fut = ex.submit(load, raw_files[i + 1])
            if i + 2 < len(raw_files):
                warm_ex.submit(warm, raw_files[i + 2])
            if not np.array_equal(pt, scans[i].times):
                raise RuntimeError(
                    f"{raw_files[i]}: decoded ping_time disagrees with the "
                    "extent scan; rerun with prefetch=False"
                )
            if chans0 is None:
                chans0 = chans
                acc = _PartialAccumulator(len(chans), n_x, n_r, window, timer)
                streamer = _PowerChunkStreamer(
                    len(chans), chunk_pings, max(s.max_count for s in scans),
                    window, n_r, range_edges, True, acc, timer,
                )
            elif chans != chans0:
                raise ValueError("all raw files must share the same channels")
            # last SAMPLE is at (R-1)*dr — dr*R overcounted one sample and
            # could add a trailing empty bin vs compute_MVBS's grid (found
            # by the round-5 survey soak at a bin-edge-straddling seed)
            r_max_true = max(
                r_max_true, float(np.nanmax(dr)) * (power.shape[2] - 1)
            )
            if r_max_true > range_edges[-1]:
                raise RuntimeError(
                    f"{raw_files[i]}: resolved echo range {r_max_true:.1f} m "
                    f"exceeds the scanned bound {range_edges[-1]:.1f} m; "
                    "rerun with prefetch=False"
                )
            uniform = bool(
                np.all(dr == dr[:, :1]) and np.all(shift == shift[:, :1])
            )
            hc = None
            if uniform and mesh is None:
                from .pipeline import closed_bounds_k0_np

                hc = closed_bounds_k0_np(
                    dr[:, 0], shift[:, 0], range_edges, power.shape[2]
                )
            streamer.stream_file(
                get_kernel(uniform), power, dr, shift, alpha, offset,
                np.zeros_like(dr), x_ids[i], host_counts=hc,
            )
    sums, counts = acc.finish()

    with timer.stage("finalize"):
        # exact survey grid = prefix of the scanned bound grid
        n_r_true = min(
            n_r,
            max(1, len(np.arange(0, r_max_true + range_bin_m, range_bin_m)) - 1),
        )
        sums, counts = sums[:, :, :n_r_true], counts[:, :, :n_r_true]
        with np.errstate(invalid="ignore", divide="ignore"):
            mvbs = np.where(counts > 0, _lin2log(sums / np.maximum(counts, 1)), np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans0, dtype=object),
                "ping_time": ping_edges[:-1],
                "echo_range": range_edges[: n_r_true + 1][:-1],
            }
        )
        out["Sv"] = (("channel", "ping_time", "echo_range"), mvbs)
        out.attrs["stage_timing"] = str(timer.report(log=False))
    return out


def _run_survey_mvbs_complex(
    raw_files, sonar_model, waveform_mode, encode_mode, range_bin_m,
    ping_time_bin, chunk_pings, env_params, cal_params, use_swap, xml_path,
    timer, mesh, device_fused=False, freq_diff=None,
):
    """EK80 complex/broadband raw->MVBS streaming.

    Per chunk of pings: the beam group is ping-sliced, compute_Sv runs the
    full complex calibration (pulse compression on device for BB), and the
    resulting Sv block feeds the chunk-invariant window binning — the same
    accumulate path as the Sv-store streamer.  Handles interior NaNs via the
    general kernel (pulse-compressed data can have prx<=0 holes).

    freq_diff : the differencing mask fuses into the device binning pass
        like the power path (apply_mask semantics, reference
        mask/api.py:467-675): every channel's chunk Sv is present before
        bins form, masked samples join no bin on any channel.  Multi-
        filter_time files stream per-channel work units, so those files
        calibrate full-file first (all channels aligned) and feed the same
        masked binning.
    """
    from ..calibrate.api import compute_Sv
    from ..commongrid.utils import ping_time_bin_edges
    from ..convert.api import open_raw
    from ..echodata.simrad import retrieve_correct_beam_group
    from ..ops import binning

    timer = timer or StageTimer()
    # survey streaming is the throughput path: the per-chunk compute_Sv
    # calls use the f32 device kernels (the chunked compute_Sv API defaults
    # to the exact f64 path; budget table in docs/PERFORMANCE.md)
    sv_kw = dict(
        env_params=env_params, cal_params=cal_params,
        waveform_mode=waveform_mode, encode_mode=encode_mode,
        precision="float32",
    )

    eds, beam_paths, ping_times = [], [], []
    with timer.stage("ingest"):
        for f in raw_files:
            ed = open_raw(f, sonar_model=sonar_model, use_swap=use_swap, xml_path=xml_path)
            bp = retrieve_correct_beam_group(ed, waveform_mode, encode_mode)
            eds.append(ed)
            beam_paths.append(bp)
            ping_times.append(
                np.asarray(ed[bp].coords["ping_time"].values, dtype="datetime64[ns]")
            )
    if not eds:
        raise ValueError("no raw files provided")
    chans = list(eds[0][beam_paths[0]].coords["channel"].values)
    for ed, bp in zip(eds[1:], beam_paths[1:]):
        if list(ed[bp].coords["channel"].values) != chans:
            raise ValueError("all raw files must share the same channels")
    if mesh is not None:
        _, chunk_pings = _mesh_layout(mesh, chunk_pings, len(chans))

    t_min = min(pt.min() for pt in ping_times)
    t_max = max(pt.max() for pt in ping_times)
    ping_edges = ping_time_bin_edges(
        np.array([t_min, t_max], dtype="datetime64[ns]"), ping_time_bin
    )
    n_x = len(ping_edges) - 1

    fd = None
    if freq_diff is not None:
        freq_nom = eds[0][beam_paths[0]].get("frequency_nominal")
        fd = _resolve_freq_diff(freq_diff, chans, freq_nom)

    if device_fused and mesh is None:
        # the fused path resolves calibrators per file anyway — the range
        # grid comes from their dr scalars, skipping the one-ping compute_Sv
        # probe (which costs a full unfused-path compile)
        multi_epoch = any(
            "filter_time" in ed["Vendor_specific"].sizes
            and ed["Vendor_specific"].sizes["filter_time"] > 1
            for ed in eds
        )
        if fd is None or not multi_epoch:
            return _run_complex_fused(
                eds, beam_paths, chans, ping_edges, range_bin_m, ping_times,
                chunk_pings, sv_kw, timer, fd=fd,
            )
        # fused + freq_diff + multi-epoch: per-channel epoch work units
        # cannot see the other channel's Sv; the chunked path below handles
        # it (full-file calibration keeps the channels sample-aligned)
        logger.warning(
            "device_fused freq_diff with multi-filter_time files uses the "
            "chunked compute_Sv path"
        )
    elif device_fused:
        logger.warning(
            "device_fused complex streaming has no mesh path yet; "
            "using the chunked compute_Sv path"
        )

    # global range extent: calibrate one probe ping per file, scale its
    # echo_range by the worst-case sample_interval ratio across the file
    r_max = 0.0
    with timer.stage("range_probe"):
        for ed, bp in zip(eds, beam_paths):
            probe = compute_Sv(_slice_echodata_pings(ed, bp, slice(0, 1)), **sv_kw)
            er1 = np.asarray(probe["echo_range"].values, dtype="f8")  # [C,1,R]
            si = np.asarray(ed[bp]["sample_interval"].values, dtype="f8")
            ratio = np.nanmax(
                np.nanmax(si, axis=-1) / np.maximum(si[..., 0], 1e-30)
            ) if si.ndim else 1.0
            r_max = max(r_max, float(np.nanmax(er1[:, 0, -1]) * max(ratio, 1.0)))
    range_edges = np.arange(0, r_max + range_bin_m, range_bin_m)
    n_r = len(range_edges) - 1

    ping_edges_i8 = ping_edges.astype("datetime64[ns]").astype("i8")

    # Plan the stream before sizing the window.  Multi-filter_time files
    # partition into (channel, epoch) work units FIRST — resolving epochs per
    # ping-chunk would silently apply the wrong filter set to chunks that do
    # not contain their epoch's filter timestamp (the reference partitions
    # globally, calibrate/api.py:96-197).
    from ..calibrate.api import epoch_slice_dicts

    x_ids, epoch_plans = [], []
    window = 1
    for ed, bp, pt in zip(eds, beam_paths, ping_times):
        vend = ed["Vendor_specific"]
        if (
            "filter_time" in vend.sizes and vend.sizes["filter_time"] > 1
            and fd is None
        ):
            plan = []
            for sd in epoch_slice_dicts(ed[bp], vend):
                start = np.datetime64(sd["beam_group_start_time"], "ns")
                end = sd["beam_group_end_time"]
                keep = pt >= start
                if end is not None:
                    keep &= pt <= np.datetime64(end, "ns")
                idxs = np.nonzero(keep)[0]
                if len(idxs) == 0:
                    continue
                x = _global_ping_bins(pt[idxs].astype("i8"), ping_edges_i8, n_x)
                plan.append((sd, idxs, x))
                for lo in range(0, len(idxs), chunk_pings):
                    hi = min(lo + chunk_pings, len(idxs))
                    window = max(window, int(x[hi - 1] - x[lo]) + 1)
            epoch_plans.append(plan)
            x_ids.append(None)
        else:
            x = _global_ping_bins(pt.astype("i8"), ping_edges_i8, n_x)
            x_ids.append(x)
            epoch_plans.append(None)
            for lo in range(0, len(x), chunk_pings):
                hi = min(lo + chunk_pings, len(x))
                window = max(window, int(x[hi - 1] - x[lo]) + 1)

    # complex-channel echo_range is affine r = k*dr: ping-invariant whenever
    # the per-file sample interval is (the norm) -> cancellation-free matmul
    uniform = all(
        bool(np.all(si == si[..., :1]))
        for si in (
            np.asarray(ed[bp]["sample_interval"].values, dtype="f8")
            for ed, bp in zip(eds, beam_paths)
        )
    )
    if mesh is not None:
        from .pipeline import sharded_binned_partials

        step = sharded_binned_partials(mesh, window, uniform_er=uniform)
    else:
        step = lambda sv, er, re, xr: binning.binned_window_partials(  # noqa: E731
            sv, er, re, xr, window, uniform_er=uniform
        )

    if fd is not None:
        step = _fd_masked_step(step, fd)

    acc = _PartialAccumulator(len(chans), n_x, n_r, window, timer)
    ch_pos = {str(c): i for i, c in enumerate(chans)}
    enc_edges = np.arange(n_r + 1, dtype="f4")

    def _bin_chunk(sv_chunk, er_chunk, x_rel, pad):
        # er_chunk arrives as PHYSICAL echo_range (f8); membership resolves
        # on host in f64 and ships encoded so the f32 kernel is edge-exact
        er_chunk = binning.exact_bin_encode_np(er_chunk, range_edges)[0]
        if pad:
            sv_chunk = np.pad(sv_chunk, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan)
            er_chunk = np.pad(er_chunk, ((0, 0), (0, pad), (0, 0)), constant_values=np.nan)
            x_rel = np.pad(x_rel, (0, pad), constant_values=window)
        return step(sv_chunk, er_chunk, enc_edges, x_rel.astype("i4"))

    for ed, bp, x_idx_all, plan in zip(eds, beam_paths, x_ids, epoch_plans):
        if plan is not None:
            _stream_complex_epochs(
                ed, plan, sv_kw, chunk_pings, window, acc, ch_pos, _bin_chunk, timer
            )
            continue
        vend = ed["Vendor_specific"]
        full_file = (
            fd is not None
            and "filter_time" in vend.sizes and vend.sizes["filter_time"] > 1
        )
        if full_file:
            # multi-epoch + freq_diff: the api-level epoch merge keeps all
            # channels sample-aligned, which the cross-channel mask needs
            with timer.stage("chunk_calibrate"):
                ds_full = compute_Sv(ed, **sv_kw)
                sv_full = np.asarray(ds_full["Sv"].values, dtype="f4")
                er_full = np.asarray(ds_full["echo_range"].values, dtype="f8")
                if er_full.shape != sv_full.shape:
                    er_full = np.broadcast_to(er_full, sv_full.shape)
        n_ping = len(x_idx_all)
        for lo in range(0, n_ping, chunk_pings):
            hi = min(lo + chunk_pings, n_ping)
            pad = chunk_pings - (hi - lo)
            x_base = int(x_idx_all[lo])
            with timer.stage("chunk_calibrate"):
                if full_file:
                    sv_chunk = sv_full[:, lo:hi]
                    er_chunk = er_full[:, lo:hi]
                else:
                    ds = compute_Sv(_slice_echodata_pings(ed, bp, slice(lo, hi)), **sv_kw)
                    sv_chunk = np.asarray(ds["Sv"].values, dtype="f4")
                    er_chunk = np.asarray(ds["echo_range"].values, dtype="f8")
                    if er_chunk.shape != sv_chunk.shape:
                        er_chunk = np.broadcast_to(er_chunk, sv_chunk.shape)
            with timer.stage("device_binning"):
                x_rel = x_idx_all[lo:hi] - x_base
                s, c, _ = _bin_chunk(sv_chunk, er_chunk, x_rel, pad)
            acc.push(s, c, x_base)
    sums, counts = acc.finish()

    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            mvbs = np.where(counts > 0, _lin2log(sums / np.maximum(counts, 1)), np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "ping_time": ping_edges[:-1],
                "echo_range": range_edges[:-1],
            }
        )
        out["Sv"] = (("channel", "ping_time", "echo_range"), mvbs)
        out.attrs["stage_timing"] = str(timer.report(log=False))
    return out


def _stream_complex_epochs(
    ed, plan, sv_kw, chunk_pings, window, acc, ch_pos, bin_chunk, timer
):
    """Chunk-stream one multi-filter_time file per (channel, epoch) work unit.

    Each chunk calibrates through CalibrateEK80's slice_dict path (one
    channel, one filter set, chunk ping range) so the filter epoch is always
    the one governing those pings, regardless of chunk boundaries.
    """
    from ..calibrate.ek80 import CalibrateEK80

    for sd, idxs, x_idx_all in plan:
        ci = ch_pos[sd["channel"]]
        beam = ed[_bp_of(ed, sv_kw)]
        pt_all = np.asarray(beam.coords["ping_time"].values, dtype="datetime64[ns]")
        for lo in range(0, len(idxs), chunk_pings):
            hi = min(lo + chunk_pings, len(idxs))
            pad = chunk_pings - (hi - lo)
            x_base = int(x_idx_all[lo])
            sd2 = dict(
                sd,
                beam_group_start_time=pt_all[idxs[lo]],
                beam_group_end_time=pt_all[idxs[hi - 1]],
            )
            with timer.stage("chunk_calibrate"):
                cal = CalibrateEK80(
                    ed,
                    sv_kw["env_params"],
                    sv_kw["cal_params"],
                    waveform_mode=sv_kw["waveform_mode"],
                    encode_mode=sv_kw["encode_mode"],
                    precision=sv_kw.get("precision", "float32"),
                    slice_dict=sd2,
                )
                ds = cal.compute_Sv()
                sv_chunk = np.asarray(ds["Sv"].values, dtype="f4")
                er_chunk = np.asarray(ds["echo_range"].values, dtype="f8")
                if er_chunk.shape != sv_chunk.shape:
                    er_chunk = np.broadcast_to(er_chunk, sv_chunk.shape)
            with timer.stage("device_binning"):
                x_rel = x_idx_all[lo:hi] - x_base
                s, c, _ = bin_chunk(sv_chunk, er_chunk, x_rel, pad)
            acc.push(s[0], c[0], x_base, ch=ci)


def _bp_of(ed, sv_kw):
    from ..echodata.simrad import retrieve_correct_beam_group

    return retrieve_correct_beam_group(ed, sv_kw["waveform_mode"], sv_kw["encode_mode"])


def _run_complex_fused(
    eds, beam_paths, chans, ping_edges, range_bin_m, ping_times,
    chunk_pings, sv_kw, timer, fd=None,
):
    """Fused complex-channel streaming: one device program per (channel,
    chunk) does pulse compression, received power, Sv, and window binning
    (ops/bb_pipeline.bb_chunk_window_partials).  Float32 end to end.

    fd : resolved frequency-differencing tuple (ia, ib, op, diff) — each
        channel's chunk runs the complex->Sv device program WITHOUT binning
        (bb_chunk_sv), the stacked on-device Sv block is masked
        cross-channel, and one masked binning pass produces the partials.
        Sv stays on device; only bin partials come back.  Caller guarantees
        single-filter_time files (epoch work units split channels).
    """
    from ..calibrate.ek80 import CalibrateEK80
    from ..calibrate.ek80_complex import get_norm_fac
    from ..ops.bb_pipeline import bb_chunk_sv, bb_chunk_window_partials

    waveform_mode = sv_kw["waveform_mode"]
    do_pc = waveform_mode in ("BB", "FM")
    n_x = len(ping_edges) - 1

    # Resolve calibration per file — or per (channel, filter epoch) for
    # multi-filter_time files, using the same epoch partition as the chunked
    # path (calibrate/api.epoch_slice_dicts; reference calibrate/api.py:
    # 96-197).  Each work item owns one jit-ready parameter set: one replica
    # per channel, so epoch boundaries become separate device programs.
    from ..calibrate.api import epoch_slice_dicts

    cals, scals, r_max = [], [], 0.0
    with timer.stage("param_resolution"):
        for ed, bp in zip(eds, beam_paths):
            vend = ed["Vendor_specific"]
            if "filter_time" in vend.sizes and vend.sizes["filter_time"] > 1:
                slice_dicts = epoch_slice_dicts(ed[bp], vend)
            else:
                slice_dicts = [{}]
            for sd in slice_dicts:
                cal = CalibrateEK80(
                    ed, sv_kw["env_params"], sv_kw["cal_params"],
                    waveform_mode=waveform_mode, encode_mode=sv_kw["encode_mode"],
                    slice_dict=sd,
                )
                if cal.beam.sizes["ping_time"] == 0:
                    continue
                scal = cal._complex_sv_scalars()
                cals.append(cal)
                scals.append(scal)
                R = cal.beam.sizes["range_sample"]
                # last sample sits at (R-1)*dr (same off-by-one as the power
                # paths — the extra trailing empty bin the dryrun used to
                # tolerate came from here)
                r_max = max(r_max, float(np.nanmax(scal["dr"])) * (R - 1))
    range_edges = np.arange(0, r_max + range_bin_m, range_bin_m)
    n_r = len(range_edges) - 1
    r_edges_f4 = range_edges.astype("f4")

    ping_edges_i8 = ping_edges.astype("datetime64[ns]").astype("i8")
    x_ids = []
    window = 1
    for cal in cals:
        pt = np.asarray(cal.beam.coords["ping_time"].values, dtype="datetime64[ns]")
        x = _global_ping_bins(pt.astype("i8"), ping_edges_i8, n_x)
        x_ids.append(x)
        for lo in range(0, len(x), chunk_pings):
            hi = min(lo + chunk_pings, len(x))
            window = max(window, int(x[hi - 1] - x[lo]) + 1)

    acc = _PartialAccumulator(len(chans), n_x, n_r, window, timer)
    ch_pos = {str(c): i for i, c in enumerate(chans)}
    fd_mask = _fd_mask_jit(fd) if fd is not None else None

    for cal, scal, x_idx_all in zip(cals, scals, x_ids):
        with timer.stage("param_resolution"):
            beam = cal.beam
            n_ch = beam.sizes["channel"]
            n_ping = beam.sizes["ping_time"]
            n_beam = beam.sizes.get("beam", 1)
            # per-ping impedance coefficient of prx (calibrate_ek.py:456-505)
            z_er = cal._to_cp(scal["z_er"], n_ch, n_ping)
            z_et = cal._to_cp(scal["z_et"], n_ch, n_ping)
            z_coef = (
                n_beam / 8.0 * (np.abs(z_er + z_et) / z_er) ** 2 / z_et
            ).astype("f4")
            norm = get_norm_fac(scal["tx"])
            ch_ids = [str(c) for c in beam.coords["channel"].values]
            inv_norm = {
                c: np.float32(1.0 / float(norm.sel(channel=c).values)) for c in ch_ids
            }
            reps = {
                c: np.flipud(np.conj(np.asarray(scal["tx"][c]))) for c in ch_ids
            }
            bs_r_all = np.asarray(beam["backscatter_r"].values, dtype="f4")
            bs_i_all = np.asarray(beam["backscatter_i"].values, dtype="f4")
            if bs_r_all.ndim == 3:  # no beam dim -> single sector
                bs_r_all = bs_r_all[..., None]
                bs_i_all = bs_i_all[..., None]
            valid_len = (~np.isnan(bs_r_all[..., 0])).sum(axis=2).astype("i4")
            dr = scal["dr"].astype("f4")
            shift = scal["shift"].astype("f4")
            alpha = scal["alpha"].astype("f4")
            offset = scal["offset"].astype("f4")
            # first sample with r_tvg > 0, decided in float64 (matches the
            # float64 chunked path at the knife-edge sample)
            k0 = np.maximum(
                np.floor(scal["shift"] / np.maximum(scal["dr"], 1e-30)) + 1, 0
            ).astype("i4")

        for lo in range(0, n_ping, chunk_pings):
            hi = min(lo + chunk_pings, n_ping)
            pad = chunk_pings - (hi - lo)
            sl = slice(lo, hi)
            x_base = int(x_idx_all[lo])
            x_rel = x_idx_all[sl] - x_base
            if pad:
                x_rel = np.pad(x_rel, (0, pad), constant_values=window)

            def _p1(a, fill=0.0):
                a = a[:, sl]
                return np.pad(a, ((0, 0), (0, pad)), constant_values=fill) if pad else a

            with timer.stage("device_fused"):
                uniform_er = bool(np.all(dr == dr[:, :1]))
                if fd is not None:
                    # fused freq_diff: per-channel complex->Sv programs, one
                    # stacked cross-channel mask + binning pass, all device
                    import jax.numpy as jnp

                    from ..ops.binning import binned_window_partials

                    sv_by_global, er_by_global = {}, {}
                    for ci, cid in enumerate(ch_ids):
                        br = bs_r_all[ci, sl]
                        bi = bs_i_all[ci, sl]
                        if pad:
                            br = np.pad(br, ((0, pad), (0, 0), (0, 0)),
                                        constant_values=np.nan)
                            bi = np.pad(bi, ((0, pad), (0, 0), (0, 0)),
                                        constant_values=np.nan)
                        rep = reps[cid]
                        sv_c, er_c = bb_chunk_sv(
                            br, bi,
                            np.ascontiguousarray(rep.real, dtype="f4"),
                            np.ascontiguousarray(rep.imag, dtype="f4"),
                            inv_norm[cid] if do_pc else np.float32(1.0),
                            _p1(z_coef, 1.0)[ci],
                            _p1(dr, 1.0)[ci], _p1(shift)[ci], _p1(alpha)[ci],
                            _p1(offset)[ci],
                            _p1(k0.astype("f4"))[ci].astype("i4"),
                            _p1(valid_len.astype("f4"))[ci].astype("i4"),
                            do_pc,
                        )
                        sv_by_global[ch_pos[cid]] = sv_c
                        er_by_global[ch_pos[cid]] = er_c
                    sv_stack = jnp.stack([sv_by_global[i] for i in range(len(chans))])
                    er_stack = jnp.stack([er_by_global[i] for i in range(len(chans))])
                    sv_stack = fd_mask(sv_stack)
                    s, c, _ = binned_window_partials(
                        sv_stack, er_stack, r_edges_f4, x_rel.astype("i4"),
                        window, uniform_er=uniform_er,
                    )
                    acc.push(s, c, x_base)
                    continue
                for ci, cid in enumerate(ch_ids):
                    br = bs_r_all[ci, sl]
                    bi = bs_i_all[ci, sl]
                    if pad:
                        br = np.pad(br, ((0, pad), (0, 0), (0, 0)),
                                    constant_values=np.nan)
                        bi = np.pad(bi, ((0, pad), (0, 0), (0, 0)),
                                    constant_values=np.nan)
                    rep = reps[cid]
                    s, c = bb_chunk_window_partials(
                        br, bi,
                        np.ascontiguousarray(rep.real, dtype="f4"),
                        np.ascontiguousarray(rep.imag, dtype="f4"),
                        inv_norm[cid] if do_pc else np.float32(1.0),
                        _p1(z_coef, 1.0)[ci],
                        _p1(dr, 1.0)[ci], _p1(shift)[ci], _p1(alpha)[ci],
                        _p1(offset)[ci],
                        _p1(k0.astype("f4"))[ci].astype("i4"),
                        _p1(valid_len.astype("f4"))[ci].astype("i4"),
                        x_rel.astype("i4"), r_edges_f4, window, do_pc,
                        uniform_er=bool(np.all(dr == dr[:, :1])),
                    )
                    # push device arrays per channel (epoch work items cover a
                    # channel subset); the accumulator reads each back one
                    # push later so the device keeps computing while the host
                    # drains
                    acc.push(s, c, x_base, ch=ch_pos[cid])
    sums, counts = acc.finish()

    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            mvbs = np.where(counts > 0, _lin2log(sums / np.maximum(counts, 1)), np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "ping_time": ping_edges[:-1],
                "echo_range": range_edges[:-1],
            }
        )
        out["Sv"] = (("channel", "ping_time", "echo_range"), mvbs)
        out.attrs["stage_timing"] = str(timer.report(log=False))
    return out
