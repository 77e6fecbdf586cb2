"""Smoke test of the survey path on one GPU: raw -> Sv -> MVBS / NASC.

Drives the public entry points once at the widths of a multi-frequency ship
survey and of an EK80 broadband file, with data synthesized from ``--seed``
by the test writers (tests/synth_ek60.py, tests/synth_ek80.py), and checks
every device result against a plain float64 numpy reference kept here.

    python chip_smoke.py                # one GPU, phases device .. parity
    python chip_smoke.py --chips 4      # the four-GPU mesh phase alone

Phases:

1. device      JAX devices, the card's name and power limit (nvidia-smi, read
               by a child process started before JAX touches the card), the
               C++ ingest scanner, the Zarr codec.  Exits non-zero unless the
               platform is ``gpu``: there is no CPU fallback.
2. ek60_survey 4 files x 5 channels (18/38/70/120/200 kHz) x 5,000 pings x
               4,000 samples with NMEA: open_raw -> compute_Sv -> add_depth /
               add_location -> compute_MVBS per file; run_survey_mvbs_from_raw
               (prefetch stream, and a workers=2 decode pool) and
               run_survey_nasc over the survey; MVBS / NASC stores written to
               Zarr and reopened.
3. ek80_bb     1 file x 2 FM channels x 4 sectors x 2,000 pings x 4,096
               samples: broadband compute_Sv, the fused survey stream against
               the chunked one, and the matched filter at Precision.HIGH.
4. parity      fused vs composed survey kernels (plain, frequency-difference
               mask, impulse-noise mask), NASC chunking invariance, and the
               closed-form host bin counts against the device's counts at the
               ek60_survey shape.
5. mesh        (--chips 4 only) the survey streams (raw -> MVBS, Sv -> MVBS,
               BB raw -> MVBS, NASC) on a 4-device ``ping`` mesh, each
               against its single-device run, and each device's peak memory.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.  A failed phase prints its traceback
and the script exits 1 after the remaining phases ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# budgets, dB unless named otherwise
SV_DB = 3e-5  # EK60 float32 Sv vs float64 where finite
MVBS_DB = 3e-5  # float32 device binning vs float64 reference
NASC_REL = 1e-5  # run_survey_nasc vs float64 reference, relative
# EK80 BB float32 Sv vs float64, per band of depth below each ping's peak
# (dB below, budget dB).  The float32 accumulation of the matched filter
# grows with the depth below the loudest echo of the ping; each limit is
# about 3x the largest reading over 4 seeds and 200 to 2,000 pings on the
# H100, and 8x or more below what Precision.HIGH reads in the same band.
BB_SV_BANDS = ((30.0, 5.3e-4), (50.0, 2e-3), (70.0, 1e-2), (np.inf, 0.15))
BB_FUSED_DB = 5e-3  # device_fused BB stream vs the chunked stream
FUSED_DB = 3e-5  # fused raw -> MVBS vs composed float32 chain
MASKED_DB = 5e-5  # fused masked legs vs composed masked chain
NASC_CHUNK_DB = 1e-4  # NASC under two chunkings (float32 reassociation)
# sharded vs single-device MVBS: the sharded programs add each bin's float32
# partial sums in another order (per-device partials, then a psum); both runs
# are also held to MVBS_DB against float64
MESH_MVBS_DB = 5e-6
MESH_BB_DB = 1e-4  # sharded vs single-device BB MVBS
MESH_NASC_REL = 1e-5  # sharded vs single-device NASC

EK60_CHANNELS = tuple(
    f"GPT {f:3d} kHz 00907203{i:04x} {i + 1}-1 ES{f}-7C"
    for i, f in enumerate((18, 38, 70, 120, 200))
)
EK60_FREQS = (18000.0, 38000.0, 70000.0, 120000.0, 200000.0)
T0 = np.datetime64("2023-07-14T21:40:00", "ns")
# 10 kn northward at 1 Hz pings: 5.144 m per ping
DLAT_PER_PING = 5.144 / 111_120.0


class PhaseError(AssertionError):
    """A device result outside its budget."""


def log(msg: str) -> None:
    print(msg, flush=True)


def _tests_path() -> None:
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


# --------------------------------------------------------------- comparisons
def _finite_pair(tag, got, want):
    got = np.asarray(got, dtype="f8")
    want = np.asarray(want, dtype="f8")
    if got.shape != want.shape:
        raise PhaseError(f"{tag}: shape {got.shape} vs reference {want.shape}")
    ng, nw = np.isnan(got), np.isnan(want)
    if not np.array_equal(ng, nw):
        raise PhaseError(f"{tag}: NaN masks differ on {int(np.sum(ng != nw))} cells")
    if ng.all():
        raise PhaseError(f"{tag}: every cell is NaN")
    return got, want, ~ng


def check_db(tag, got, want, budget, where=None):
    """Max |got - want| in dB over finite cells (and ``where``); NaN masks
    must be identical.  Raises PhaseError beyond ``budget``."""
    got, want, fin = _finite_pair(tag, got, want)
    sel = fin if where is None else fin & where
    d = float(np.max(np.abs(got[sel] - want[sel]))) if sel.any() else 0.0
    ok = d <= budget
    log(f"  {tag:44s} max|d| = {d:.3e} dB   budget {budget:g}   "
        f"{'ok' if ok else 'FAIL'}   NaN masks identical")
    if not ok:
        raise PhaseError(f"{tag}: {d:.3e} dB > {budget:g}")
    return d


def check_rel(tag, got, want, budget):
    """Max relative difference over finite nonzero cells; NaN masks equal."""
    got, want, fin = _finite_pair(tag, got, want)
    sel = fin & (want != 0)
    d = float(np.max(np.abs(got[sel] - want[sel]) / np.abs(want[sel])))
    ok = d <= budget
    log(f"  {tag:44s} max rel = {d:.3e}      budget {budget:g}   "
        f"{'ok' if ok else 'FAIL'}   NaN masks identical")
    if not ok:
        raise PhaseError(f"{tag}: relative {d:.3e} > {budget:g}")
    return d


# ------------------------------------------------------ float64 references
def lin(sv_db):
    return np.power(10.0, np.asarray(sv_db, dtype="f8") / 10.0)


def edges_from_left(left, step):
    """Bin edges from an output's left-edge coordinate and the bin width."""
    left = np.asarray(left)
    return np.append(left, left[-1] + step)


def range_binned_sums(sv_db, rng, r_edges, ping_block=500, linear=True):
    """float64 per-ping range-bin sums of linear Sv and sample counts.

    sv_db, rng: [C, P, R]; bins are left-closed on ``rng``.  A sample joins
    its bin when both its value and its range are finite.  ``linear=False``
    sums the values as given instead of 10^(Sv/10).  Returns (sums, counts),
    each [C, P, n_r].
    """
    C, P, _ = sv_db.shape
    n_r = len(r_edges) - 1
    sums = np.zeros((C, P, n_r))
    counts = np.zeros((C, P, n_r))
    for lo in range(0, P, ping_block):
        hi = min(lo + ping_block, P)
        r = np.asarray(rng[:, lo:hi], dtype="f8")
        s = np.asarray(sv_db[:, lo:hi], dtype="f8")
        idx = np.searchsorted(r_edges, r, side="right") - 1
        ok = (idx >= 0) & (idx < n_r) & np.isfinite(r) & np.isfinite(s)
        p_ids = np.broadcast_to(np.arange(hi - lo)[None, :, None], r.shape)
        for c in range(C):
            key = p_ids[c][ok[c]] * n_r + idx[c][ok[c]]
            vals = s[c][ok[c]]
            sums[c, lo:hi] = np.bincount(
                key, weights=lin(vals) if linear else vals, minlength=(hi - lo) * n_r
            ).reshape(hi - lo, n_r)
            counts[c, lo:hi] = np.bincount(
                key, minlength=(hi - lo) * n_r
            ).reshape(hi - lo, n_r)
    return sums, counts


def ping_binned(per_ping, x_idx, n_x):
    """Sum [C, P, K] per-ping rows into [C, n_x, K] bins (x_idx < 0: none)."""
    C, _, K = per_ping.shape
    out = np.zeros((C, n_x, K))
    keep = x_idx >= 0
    np.add.at(out, (slice(None), x_idx[keep]), per_ping[:, keep])
    return out


def left_closed_ids(values, edges):
    n = len(edges) - 1
    idx = np.searchsorted(edges, values, side="right") - 1
    return np.where((idx >= 0) & (idx < n), idx, -1)


def mean_db(sums, counts):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(counts > 0, 10.0 * np.log10(sums / np.maximum(counts, 1)), np.nan)


def mvbs_reference(sv_db, rng, ping_time, ping_edges, r_edges):
    """float64 MVBS of one Sv block on the given edges (left-closed).

    Callers pass float64 Sv with the float32 product's own range coordinate:
    the reference checks the device's sums, and a sample within a float32
    rounding of a bin edge would otherwise change bins between the two.
    """
    s, n = range_binned_sums(sv_db, rng, r_edges)
    x = left_closed_ids(np.asarray(ping_time, "datetime64[ns]").astype("i8"),
                        np.asarray(ping_edges, "datetime64[ns]").astype("i8"))
    n_x = len(ping_edges) - 1
    return mean_db(ping_binned(s, x, n_x), ping_binned(n, x, n_x))


def survey_mvbs_reference(sv64_list, rng_list, pt_list, ping_edges, r_edges):
    """float64 MVBS of a multi-file survey on the given edges (left-closed):
    per-file range-binned sums added into one grid before the mean."""
    n_x, n_r = len(ping_edges) - 1, len(r_edges) - 1
    C = sv64_list[0].shape[0]
    sums, counts = np.zeros((C, n_x, n_r)), np.zeros((C, n_x, n_r))
    p_edges = np.asarray(ping_edges, "datetime64[ns]").astype("i8")
    for sv64, rng, pt in zip(sv64_list, rng_list, pt_list):
        s, n = range_binned_sums(sv64, rng, r_edges)
        x = left_closed_ids(np.asarray(pt, "datetime64[ns]").astype("i8"), p_edges)
        sums += ping_binned(s, x, n_x)
        counts += ping_binned(n, x, n_x)
    return mean_db(sums, counts)


def check_grid(tag, left, step, lo, hi):
    """The output's left edges are a uniform grid of ``step`` whose bins
    cover [lo, hi] and start on the bin holding ``lo``."""
    left = np.asarray(left)
    if left.size == 0 or np.any(np.diff(left) != step):
        raise PhaseError(f"{tag}: left edges are not a uniform {step} grid")
    if not (left[0] <= lo < left[0] + step and left[-1] <= hi < left[-1] + step):
        raise PhaseError(f"{tag}: grid {left[0]}..{left[-1]} does not cover {lo}..{hi}")


# ------------------------------------------------------------------ phase 1
def start_nvidia_smi():
    """Start the nvidia-smi query before JAX touches the card."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    except OSError:
        return None


def finish_nvidia_smi(proc) -> str:
    if proc is None:
        return "nvidia-smi not found"
    try:
        out, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return "nvidia-smi timed out"
    return out.strip() or f"nvidia-smi failed: {err.strip()}"


def phase_device(smi_proc, require_gpu=True):
    """Report the devices; returns (platform, kind, count)."""
    import jax

    from echopype_tpu import native
    from echopype_tpu.utils.coding import zarr_compressor_meta

    devs = jax.devices()
    d0 = devs[0]
    log(f"jax {jax.__version__}  devices: {devs}")
    log(f"platform: {d0.platform}  device_kind: {d0.device_kind}  count: {len(devs)}")
    for line in finish_nvidia_smi(smi_proc).splitlines():
        log(f"card (name, power.limit): {line}")
    lib = native.load_native()
    log("native ingest scanner: "
        + (f"loaded ({native.library_path().name})" if lib is not None
           else "NOT loaded (Python scanner fallback)"))
    comp = zarr_compressor_meta(np.float32)
    log("zarr codec for float arrays: "
        + ("system libblosc (" + comp["cname"] + ")" if comp["id"] == "blosc"
           else f"{comp['id']} fallback (no libblosc)"))
    if require_gpu and d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found platform {d0.platform!r}")
    return d0.platform, d0.device_kind, len(devs)


# ------------------------------------------------------------------ phase 2
def write_ek60_survey(workdir, seed, n_files, n_pings, n_samples):
    """Synthesize the survey files; consecutive files continue the track."""
    _tests_path()
    from synth_ek60 import write_ek60_raw

    files = []
    gap_s = 30
    for k in range(n_files):
        path = Path(workdir) / f"SURVEY-D20230714-T{k:06d}.raw"
        first_ping = k * (n_pings + gap_s)
        write_ek60_raw(
            path, n_pings=n_pings, n_samples=n_samples, channels=EK60_CHANNELS,
            frequencies=EK60_FREQS, seed=seed + k, with_angle=True,
            t0=T0 + np.timedelta64(first_ping, "s"),
            nmea_track=(47.0 + DLAT_PER_PING * first_ping, -125.5, DLAT_PER_PING),
        )
        files.append(str(path))
    return files


def nasc_reference(sv64_list, depth_list, lat_list, lon_list, dist_edges, depth_edges):
    """float64 NASC over a multi-file survey (commongrid.compute_NASC physics).

    Per-ping along-track distance uses the package's host geodesy, continued
    across files by the inter-file gap, as run_survey_nasc documents; bins,
    sums, heights and the NASC formula are computed here.  Membership is by
    the product's depth coordinate (``depth_list``).
    """
    from echopype_tpu.utils.geodesy import pairwise_distance_nmi

    n_x, n_r = len(dist_edges) - 1, len(depth_edges) - 1
    C = sv64_list[0].shape[0]
    sums = np.zeros((C, n_x, n_r))
    counts = np.zeros((C, n_x, n_r))
    h_num = np.zeros((C, n_x, n_r))
    n_ping = np.zeros(n_x)
    offset, prev_fix = 0.0, None
    for sv64, depth, lat, lon in zip(sv64_list, depth_list, lat_list, lon_list):
        seg = pairwise_distance_nmi(lat, lon)  # seg[i] = |p_i p_i+1|
        d = np.full(len(lat), np.nan)
        ok = ~np.isnan(seg)
        d[ok] = np.cumsum(seg[ok])
        d = _ffill_bfill(d)
        if prev_fix is not None:
            offset += float(pairwise_distance_nmi(
                np.array([prev_fix[0], lat[0]]), np.array([prev_fix[1], lon[0]]))[0])
        d = d + offset
        offset, prev_fix = float(d[-1]), (lat[-1], lon[-1])
        x = np.clip(np.searchsorted(dist_edges, d, side="right") - 1, 0, n_x - 1)
        s, n = range_binned_sums(sv64, depth, depth_edges)
        sums += ping_binned(s, x, n_x)
        counts += ping_binned(n, x, n_x)
        # height integrand: each sample's depth step, binned by its upper
        # (shallower) edge
        depth = np.asarray(depth, "f8")
        h, _ = range_binned_sums(np.diff(depth, axis=2), depth[:, :, :-1], depth_edges,
                                 linear=False)
        h_num += ping_binned(h, x, n_x)
        n_ping += np.bincount(x, minlength=n_x)
    with np.errstate(invalid="ignore", divide="ignore"):
        sv_mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
        h_mean = h_num / np.where(n_ping > 0, n_ping, np.nan)[None, :, None]
    return sv_mean * h_mean * 4 * np.pi * 1852.0**2


def _ffill_bfill(x):
    x = x.copy()
    idx = np.where(~np.isnan(x), np.arange(len(x)), 0)
    np.maximum.accumulate(idx, out=idx)
    x = x[idx]
    bad = np.isnan(x)
    if bad.any() and (~bad).any():
        x[: np.argmax(~bad)] = x[np.argmax(~bad)]
    return x


def phase_ek60_survey(workdir, seed, n_files=4, n_pings=5000, n_samples=4000,
                      workers=2):
    """Returns the survey's raw files and the per-file float32 Sv datasets."""
    import echopype_tpu as ep
    from echopype_tpu import storage
    from echopype_tpu.parallel import run_survey_mvbs_from_raw, run_survey_nasc

    t = time.perf_counter()
    files = write_ek60_survey(workdir, seed, n_files, n_pings, n_samples)
    mb = sum(Path(f).stat().st_size for f in files) / 2**20
    log(f"  synthesized {n_files} files x 5 ch x {n_pings} pings x {n_samples} "
        f"samples: {mb:.0f} MiB of .raw in {time.perf_counter() - t:.1f} s")

    step_r, step_t = 20.0, np.timedelta64(20, "s")
    sv32_list, sv64_vals, rng32 = [], [], []
    for k, f in enumerate(files):
        ed = ep.open_raw(f, sonar_model="EK60")
        sv32 = ep.calibrate.compute_Sv(ed)
        sv64 = ep.calibrate.compute_Sv(ed, precision="float64")
        check_db(f"file {k} Sv float32 vs float64", sv32["Sv"].values,
                 sv64["Sv"].values, SV_DB)
        er_d = np.nanmax(np.abs(np.asarray(sv32["echo_range"].values, "f8")
                                - sv64["echo_range"].values))
        log(f"  file {k} echo_range float32 vs float64: max|d| = {er_d:.3e} m")
        sv32 = ep.consolidate.add_depth(sv32)
        sv32 = ep.consolidate.add_location(sv32, ed)
        mvbs = ep.commongrid.compute_MVBS(sv32, range_bin="20m", ping_time_bin="20s")
        pt = np.asarray(sv32.coords["ping_time"].values, "datetime64[ns]")
        er32 = np.asarray(sv32["echo_range"].values, "f8")
        check_grid(f"file {k} MVBS ping grid", mvbs.coords["ping_time"].values,
                   step_t, pt.min(), pt.max())
        want = mvbs_reference(
            sv64["Sv"].values, er32, pt,
            edges_from_left(mvbs.coords["ping_time"].values, step_t),
            edges_from_left(np.asarray(mvbs.coords["echo_range"].values, "f8"), step_r),
        )
        check_db(f"file {k} compute_MVBS vs float64", mvbs["Sv"].values, want, MVBS_DB)
        sv32_list.append(sv32)
        sv64_vals.append(np.asarray(sv64["Sv"].values, "f8"))
        rng32.append(er32)
        del ed, sv64

    # survey-wide float64 reference MVBS on the stream's own grid
    t = time.perf_counter()
    survey = run_survey_mvbs_from_raw(files, sonar_model="EK60", range_bin="20m",
                                      ping_time_bin="20s")
    log(f"  run_survey_mvbs_from_raw (prefetch stream): {time.perf_counter() - t:.1f} s, "
        f"MVBS {survey['Sv'].values.shape}")
    pts = [np.asarray(s.coords["ping_time"].values, "datetime64[ns]") for s in sv32_list]
    t_all = np.concatenate(pts)
    check_grid("survey MVBS ping grid", survey.coords["ping_time"].values, step_t,
               t_all.min(), t_all.max())
    r_left = np.asarray(survey.coords["echo_range"].values, "f8")
    r_max = max(float(np.nanmax(r)) for r in rng32)
    check_grid("survey MVBS range grid", r_left, step_r, 0.0, r_max)
    want_survey = survey_mvbs_reference(
        sv64_vals, rng32, pts, edges_from_left(survey.coords["ping_time"].values, step_t),
        edges_from_left(r_left, step_r))
    check_db("survey stream MVBS vs float64", survey["Sv"].values, want_survey, MVBS_DB)

    if workers:
        t = time.perf_counter()
        pooled = run_survey_mvbs_from_raw(files, sonar_model="EK60", range_bin="20m",
                                          ping_time_bin="20s", workers=workers)
        log(f"  run_survey_mvbs_from_raw (workers={workers}): "
            f"{time.perf_counter() - t:.1f} s")
        check_db(f"survey workers={workers} MVBS vs float64", pooled["Sv"].values,
                 want_survey, MVBS_DB)

    t = time.perf_counter()
    nasc = run_survey_nasc(sv32_list, range_bin="10m", dist_bin="0.5nmi")
    log(f"  run_survey_nasc: {time.perf_counter() - t:.1f} s, "
        f"NASC {nasc['NASC'].values.shape}")
    d_left = np.asarray(nasc.coords["distance"].values, "f8")
    z_left = np.asarray(nasc.coords["depth"].values, "f8")
    want_nasc = nasc_reference(
        sv64_vals,
        [np.asarray(s["depth"].values, "f8") for s in sv32_list],
        [np.asarray(s["latitude"].values, "f8") for s in sv32_list],
        [np.asarray(s["longitude"].values, "f8") for s in sv32_list],
        edges_from_left(d_left, 0.5), edges_from_left(z_left, 10.0),
    )
    check_rel("survey NASC vs float64", nasc["NASC"].values, want_nasc, NASC_REL)

    for name, ds, var in (("mvbs", survey, "Sv"), ("nasc", nasc, "NASC")):
        path = Path(workdir) / f"survey_{name}.zarr"
        ds.to_zarr(str(path))
        back = storage.open_dataset(str(path))
        if not np.array_equal(np.asarray(back[var].values), np.asarray(ds[var].values),
                              equal_nan=True):
            raise PhaseError(f"{name} store: reopened {var} differs from what was written")
        log(f"  {name} Zarr store written and reopened equal ({path.name})")
    return files, sv32_list


# ------------------------------------------------------------------ phase 3
def phase_ek80_bb(workdir, seed, n_pings=2000, n_samples=4096):
    import echopype_tpu as ep
    from echopype_tpu.ops import matched_filter
    from echopype_tpu.parallel import run_survey_mvbs_from_raw

    _tests_path()
    from synth_ek80 import write_ek80_raw

    path = Path(workdir) / "BB-D20230715-T000000.raw"
    t = time.perf_counter()
    write_ek80_raw(path, n_pings=n_pings, n_samples=n_samples, n_sectors=4, seed=seed,
                   with_power_channel=False, with_cw_complex=False, extra_fm_channel=True)
    log(f"  synthesized 1 file x 2 FM ch x 4 sectors x {n_pings} pings x {n_samples} "
        f"samples: {path.stat().st_size / 2**20:.0f} MiB in {time.perf_counter() - t:.1f} s")
    ed = ep.open_raw(str(path), sonar_model="EK80")
    bb = dict(waveform_mode="BB", encode_mode="complex")
    t = time.perf_counter()
    sv32 = ep.calibrate.compute_Sv(ed, **bb)
    log(f"  compute_Sv BB float32 (device matched filter): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    sv64 = ep.calibrate.compute_Sv(ed, precision="float64", **bb)
    log(f"  compute_Sv BB float64 (host): {time.perf_counter() - t:.1f} s")
    a = np.asarray(sv32["Sv"].values, "f8")
    b = np.asarray(sv64["Sv"].values, "f8")
    check_bb_bands("BB Sv float32 vs float64", a, b)
    # echo integration of the same Sv: float32 vs float64, 2 m x 20 s bins
    er32 = np.asarray(sv32["echo_range"].values, "f8")
    mvbs = ep.commongrid.compute_MVBS(sv32, range_bin="2m", ping_time_bin="20s")
    want = mvbs_reference(
        b, er32, np.asarray(sv32.coords["ping_time"].values, "datetime64[ns]"),
        edges_from_left(mvbs.coords["ping_time"].values, np.timedelta64(20, "s")),
        edges_from_left(np.asarray(mvbs.coords["echo_range"].values, "f8"), 2.0),
    )
    check_db("BB compute_MVBS vs float64", mvbs["Sv"].values, want, MVBS_DB)

    kw = dict(sonar_model="EK80", range_bin="2m", ping_time_bin="20s", **bb)
    t = time.perf_counter()
    chunked = run_survey_mvbs_from_raw([str(path)], **kw)
    log(f"  run_survey_mvbs_from_raw BB chunked: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fused = run_survey_mvbs_from_raw([str(path)], device_fused=True, **kw)
    log(f"  run_survey_mvbs_from_raw BB device_fused: {time.perf_counter() - t:.1f} s")
    # the fused path sizes its range grid from dr*R and can carry one extra
    # trailing bin; compare the common grid
    nr = min(fused["Sv"].values.shape[2], chunked["Sv"].values.shape[2]) - 1
    check_db("BB device_fused vs chunked stream", fused["Sv"].values[:, :, :nr],
             chunked["Sv"].values[:, :, :nr], BB_FUSED_DB)

    prev = matched_filter._CONV_PRECISION
    try:
        matched_filter.set_conv_precision("HIGH")
        high = np.asarray(ep.calibrate.compute_Sv(ed, **bb)["Sv"].values, "f8")
    finally:
        matched_filter.set_conv_precision(prev)
    d = np.abs(high - b)
    below = below_ping_peak(b)
    log("  BB Sv at Precision.HIGH vs float64 (reported only): " + "; ".join(
        f"{band_label(lim)} {float(np.nanmax(np.where(below <= lim, d, np.nan))):.3e} dB"
        for lim, _ in BB_SV_BANDS))
    return str(path)


def below_ping_peak(sv_db):
    """dB below the loudest finite sample of the same ping and channel."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN pings
        return np.nanmax(sv_db, axis=-1, keepdims=True) - sv_db


def band_label(lim):
    return "all samples" if np.isinf(lim) else f"<= {lim:g} dB below ping peak"


def check_bb_bands(tag, got, want):
    """Hold ``got`` to ``want`` (float64) band by band of BB_SV_BANDS."""
    below = below_ping_peak(want)
    for lim, budget in BB_SV_BANDS:
        check_db(f"{tag} ({band_label(lim)})", got, want, budget,
                 where=None if np.isinf(lim) else below <= lim)


# ------------------------------------------------------------------ phase 4
def phase_parity(workdir, seed, survey_file, chunk=None):
    """Fused-vs-composed legs plus the closed-form counts check."""
    import jax
    import jax.numpy as jnp

    import echopype_tpu as ep
    from echopype_tpu.calibrate.ek import CalibrateEK60
    from echopype_tpu.commongrid.utils import ping_time_bin_edges
    from echopype_tpu.parallel import run_survey_mvbs, run_survey_mvbs_from_raw
    from echopype_tpu.parallel.pipeline import (
        closed_bounds_k0_np,
        closed_window_counts_np,
        sv_mvbs_window_partials_uniform,
    )
    from echopype_tpu.parallel.survey import run_survey_nasc

    _tests_path()
    from synth_ek60 import write_ek60_raw

    files = []
    for k in range(2):
        raw = Path(workdir) / f"CP{k}-D20200101-T000000.raw"
        kw = {"ragged": True} if k == 0 else {"skip_pings": {1: {1, 6, 12}}}
        write_ek60_raw(raw, n_pings=36, n_samples=400, seed=seed + 11 + k,
                       t0=np.datetime64("2020-01-01T00:00:00", "ns")
                       + np.timedelta64(k * 41, "s"), **kw)
        files.append(str(raw))
    kw = dict(range_bin="7.3m", ping_time_bin="10s", chunk_pings=9)
    eds = [ep.open_raw(f, sonar_model="EK60") for f in files]
    sv32 = [ep.calibrate.compute_Sv(ed) for ed in eds]
    want = run_survey_mvbs(sv32, **kw)
    for tag, extra in (("fused mvbs (eager)", dict(prefetch=False)),
                       ("fused mvbs (prefetch)", dict(prefetch=True))):
        got = run_survey_mvbs_from_raw(files, sonar_model="EK60", **extra, **kw)
        check_db(f"{tag} vs composed", got["Sv"].values, want["Sv"].values, FUSED_DB)

    chans = [str(c) for c in sv32[0].coords["channel"].values]
    eq = f'"{chans[0]}" - "{chans[1]}" >= 2.5dB'
    got = run_survey_mvbs_from_raw(files, sonar_model="EK60", freq_diff=eq, **kw)
    masked = [ep.mask.apply_mask(d, ep.mask.frequency_differencing(d, chanABEq=eq))
              for d in sv32]
    check_db("fused freq_diff mvbs vs composed", got["Sv"].values,
             run_survey_mvbs(masked, **kw)["Sv"].values, MASKED_DB)

    spec = dict(depth_bin="4.0m", num_side_pings=2, impulse_noise_threshold="9.0dB",
                range_var="echo_range")
    got = run_survey_mvbs_from_raw(files, sonar_model="EK60",
                                   noise_masks={"impulse": spec}, **kw)
    cleaned = []
    for d in sv32:
        flagged = np.asarray(ep.clean.mask_impulse_noise(d, **spec).values, dtype=bool)
        c = d.copy()
        c["Sv"] = (d["Sv"].dims, np.where(flagged, np.nan, np.asarray(d["Sv"].values)))
        cleaned.append(c)
    check_db("fused impulse-mask mvbs vs composed", got["Sv"].values,
             run_survey_mvbs(cleaned, **kw)["Sv"].values, MASKED_DB)

    nasc_in = [ep.consolidate.add_location(ep.consolidate.add_depth(d), ed)
               for d, ed in zip(sv32, eds)]
    nkw = dict(range_bin="4.1m", dist_bin="0.03nmi")
    a = run_survey_nasc(nasc_in, chunk_pings=11, **nkw)["NASC"].values
    b = run_survey_nasc(nasc_in, chunk_pings=7, **nkw)["NASC"].values
    with np.errstate(divide="ignore", invalid="ignore"):
        a_db = np.where(a > 0, 10 * np.log10(a), np.where(a == 0, -np.inf, np.nan))
        b_db = np.where(b > 0, 10 * np.log10(b), np.where(b == 0, -np.inf, np.nan))
    zero = np.isinf(a_db) & np.isinf(b_db)
    check_db("NASC chunk 11 vs chunk 7", np.where(zero, 0.0, a_db),
             np.where(zero, 0.0, b_db), NASC_CHUNK_DB)

    # closed-form host counts vs the device's own, at the survey's shape
    cal = CalibrateEK60(ep.open_raw(survey_file, sonar_model="EK60"), None, None)
    power, dr, shift, alpha, offset, _ = cal._power_cal_inputs("Sv")
    C, P, R = power.shape
    P = min(P, chunk or P)
    pt = np.asarray(cal.beam.coords["ping_time"].values, "datetime64[ns]")[:P]
    p_edges = ping_time_bin_edges(pt, "20s").astype("i8")
    x_rel = (np.searchsorted(p_edges, pt.astype("i8"), side="right") - 1).astype("i4")
    W = int(x_rel.max()) + 1
    r_edges = np.arange(0, float(np.nanmax(dr)) * (R - 1) + 20.0, 20.0)
    bounds, k0 = closed_bounds_k0_np(dr[:, 0], shift[:, 0], r_edges, R)
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0) / np.float32(10.0 * np.log10(2.0) / 256.0)
    p_i16 = np.rint(np.nan_to_num(power[:, :P] * scale)).astype("<i2")
    fn = jax.jit(sv_mvbs_window_partials_uniform, static_argnums=(8, 9))
    for tag, vl in (("full", np.full((C, P), R, "i4")),
                    ("ragged", rng.integers(R // 3, R + 1, (C, P)).astype("i4"))):
        args = [jnp.asarray(np.asarray(v[:, :P], "f4")) for v in (dr, shift, alpha, offset)]
        _, dev_counts = fn(jnp.asarray(p_i16), *args, jnp.asarray(vl), jnp.asarray(x_rel),
                           jnp.asarray(r_edges.astype("f4")), W, len(r_edges) - 1)
        host = closed_window_counts_np(bounds, k0, vl, x_rel, W)
        dev = np.asarray(dev_counts, "f8")
        n_bad = int(np.sum(host != dev))
        log(f"  closed-form host counts vs device counts ({tag} valid lengths, "
            f"[{C}, {P}, {R}] -> [{C}, {W}, {len(r_edges) - 1}]): "
            f"{'equal' if n_bad == 0 else f'{n_bad} cells differ'}")
        if n_bad:
            raise PhaseError(f"host counts differ from device counts on {n_bad} cells")


# ------------------------------------------------------------------ phase 5
def phase_mesh(workdir, seed, n_devices=4, n_files=2, n_pings=5000, n_samples=4000,
               bb_pings=2000, bb_samples=4096):
    """Sharded survey streams on an n-device ping mesh vs one device."""
    import jax

    import echopype_tpu as ep
    from echopype_tpu.parallel import (
        make_mesh,
        run_survey_mvbs,
        run_survey_mvbs_from_raw,
        run_survey_nasc,
    )

    _tests_path()
    from synth_ek80 import write_ek80_raw

    mesh = make_mesh(n_devices=n_devices)
    log(f"  mesh {dict(mesh.shape)} over {[str(d) for d in mesh.devices.ravel()]}")
    files = write_ek60_survey(workdir, seed, n_files, n_pings, n_samples)
    # float32 Sv per file (the Sv -> MVBS and NASC legs), and float64 Sv on
    # the float32 range coordinate: the reference for both MVBS streams
    svs, sv64_vals, rng32, pts = [], [], [], []
    for f in files:
        ed = ep.open_raw(f, sonar_model="EK60")
        sv32 = ep.calibrate.compute_Sv(ed)
        sv64_vals.append(np.asarray(
            ep.calibrate.compute_Sv(ed, precision="float64")["Sv"].values, "f8"))
        rng32.append(np.asarray(sv32["echo_range"].values, "f8"))
        pts.append(np.asarray(sv32.coords["ping_time"].values, "datetime64[ns]"))
        svs.append(ep.consolidate.add_location(ep.consolidate.add_depth(sv32), ed))

    def mvbs_leg(tag, single, sharded):
        """Each run against float64, then the sharded run against the single
        one: the two differ only by the order of their float32 additions."""
        want = survey_mvbs_reference(
            sv64_vals, rng32, pts,
            edges_from_left(single.coords["ping_time"].values, np.timedelta64(20, "s")),
            edges_from_left(np.asarray(single.coords["echo_range"].values, "f8"), 20.0))
        check_db(f"{tag} single device vs float64", single["Sv"].values, want, MVBS_DB)
        check_db(f"{tag} sharded vs float64", sharded["Sv"].values, want, MVBS_DB)
        check_db(f"{tag} sharded vs single device", sharded["Sv"].values,
                 single["Sv"].values, MESH_MVBS_DB)

    kw = dict(sonar_model="EK60", range_bin="20m", ping_time_bin="20s")
    mvbs_leg("mesh raw->MVBS", run_survey_mvbs_from_raw(files, **kw),
             run_survey_mvbs_from_raw(files, mesh=mesh, **kw))
    mkw = dict(range_bin="20m", ping_time_bin="20s")
    mvbs_leg("mesh Sv->MVBS", run_survey_mvbs(svs, **mkw),
             run_survey_mvbs(svs, mesh=mesh, **mkw))

    bb_path = Path(workdir) / "MESHBB-D20230715-T000000.raw"
    write_ek80_raw(bb_path, n_pings=bb_pings, n_samples=bb_samples, n_sectors=4, seed=seed,
                   with_power_channel=False, with_cw_complex=False, extra_fm_channel=True)
    bkw = dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex",
               range_bin="2m", ping_time_bin="20s", chunk_pings=512)
    single = run_survey_mvbs_from_raw([str(bb_path)], **bkw)
    sharded = run_survey_mvbs_from_raw([str(bb_path)], mesh=mesh, **bkw)
    check_db("mesh BB MVBS vs single device", sharded["Sv"].values,
             single["Sv"].values, MESH_BB_DB)

    nkw = dict(range_bin="10m", dist_bin="0.5nmi")
    single = run_survey_nasc(svs, **nkw)
    sharded = run_survey_nasc(svs, mesh=mesh, **nkw)
    check_rel("mesh NASC vs single device", sharded["NASC"].values,
              single["NASC"].values, MESH_NASC_REL)
    for d in jax.devices()[:n_devices]:
        stats = d.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        log(f"  {d}: peak_bytes_in_use = "
            + (f"{peak} ({peak / 2**20:.1f} MiB)" if peak is not None else "not reported"))


# ---------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4 runs the four-device mesh phase alone")
    ap.add_argument("--pings", type=int, default=5000,
                    help="pings per EK60 survey file (cut pings, never widths)")
    ap.add_argument("--bb-pings", type=int, default=2000, help="pings in the EK80 BB file")
    args = ap.parse_args(argv)

    smi = start_nvidia_smi()  # before JAX touches the card
    from echopype_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache(ROOT)}")
    log("== phase device")
    platform, kind, count = phase_device(smi)
    if args.chips > count:
        raise SystemExit(f"chip_smoke: --chips {args.chips} but JAX sees {count} devices")
    if args.pings != 5000 or args.bb_pings != 2000:
        log(f"cut: EK60 pings per file 5000 -> {args.pings}; "
            f"EK80 BB pings 2000 -> {args.bb_pings} (widths unchanged)")

    failed = []

    def run(name, fn, *a, **kw):
        log(f"== phase {name}")
        t = time.perf_counter()
        try:
            out = fn(*a, **kw)
            log(f"   phase {name} passed in {time.perf_counter() - t:.1f} s")
            return out
        except Exception:  # noqa: BLE001 - report every phase, then exit 1
            traceback.print_exc()
            log(f"   phase {name} FAILED after {time.perf_counter() - t:.1f} s")
            failed.append(name)
            return None

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.chips == 4:
            run("mesh", phase_mesh, work, args.seed, n_devices=4, n_pings=args.pings,
                bb_pings=args.bb_pings)
            count = 4
        else:
            out = run("ek60_survey", phase_ek60_survey, work, args.seed,
                      n_pings=args.pings)
            run("ek80_bb", phase_ek80_bb, work, args.seed, n_pings=args.bb_pings)
            survey_file = out[0][0] if out else write_ek60_survey(
                work, args.seed, 1, args.pings, 4000)[0]
            run("parity", phase_parity, work, args.seed, survey_file)
    if failed:
        log(f"chip_smoke FAILED phases: {failed}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": platform, "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
