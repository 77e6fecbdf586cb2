"""Benchmark: EK60 Sv calibration + MVBS echo-integration kernel on one GPU.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"device": {...}, "card": "..."}.

The workload mirrors the reference's headline pipeline (SURVEY.md §6 /
BASELINE.md): raw int16 power [channels, pings, range] -> Sv (sonar
equation) -> MVBS (20m x 20s linear-domain bin sums), run as the survey
streamer's device program for uniform-dr files
(``pipeline.sv_mvbs_window_partials_uniform``, counts closed-form on the
host).  Each timed call ends in ``block_until_ready``.  vs_baseline divides
by a single-threaded numpy implementation of the identical math measured in
the same run.  It fails without a GPU: a CPU run measures nothing this
benchmark reports.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

INDEX2POWER = 10.0 * np.log10(2.0) / 256.0


def _inputs(C, Pn, R, n_x, n_r, seed=0, power_dtype="f4"):
    rng = np.random.default_rng(seed)
    power_idx = rng.integers(-12000, -2000, (C, Pn, R), dtype=np.int16)
    if power_dtype == "i2":
        # the streamer ships RAW int16 indices; the kernel scales in-kernel
        power = power_idx
    else:
        power = (power_idx.astype("f4") * np.float32(INDEX2POWER)).astype("f4")
    dr = np.full((C, Pn), 0.19, dtype="f4")
    tvg = 2 * dr
    ab = np.full((C, Pn), 0.01, dtype="f4")
    off = rng.normal(-30.0, 2.0, (C, Pn)).astype("f4")
    x_idx = np.minimum(np.arange(Pn) // max(1, Pn // n_x), n_x - 1).astype("i4")
    r_edges = np.linspace(0.0, 0.19 * R, n_r + 1).astype("f4")
    return power, dr, tvg, ab, off, x_idx, r_edges


def numpy_pipeline(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r):
    """Single-threaded numpy reference implementation (identical math)."""
    C, Pn, R = power.shape
    r = np.arange(R, dtype="f4")[None, None, :] * dr[:, :, None]
    r_tvg = r - tvg[:, :, None]
    pos = r_tvg > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        sv = np.where(
            pos,
            power + 20 * np.log10(np.where(pos, r_tvg, 1)) + 2 * ab[:, :, None] * r_tvg + off[:, :, None],
            np.nan,
        )
        er = np.where(np.isnan(power), np.nan, r)
        r_idx = np.digitize(er, r_edges) - 1
        ok = (r_idx >= 0) & (r_idx < n_r) & ~np.isnan(sv)
        seg = np.where(ok, x_idx[None, :, None] * n_r + r_idx, n_x * n_r)
        lin = np.where(ok, 10 ** (sv / 10), 0)
        mvbs = np.zeros((C, n_x * n_r))
        for c in range(C):
            sums = np.bincount(seg[c].ravel(), weights=lin[c].ravel(), minlength=n_x * n_r + 1)
            counts = np.bincount(seg[c].ravel(), weights=ok[c].ravel().astype("f8"), minlength=n_x * n_r + 1)
            mvbs[c] = np.where(counts[:-1] > 0, sums[:-1] / np.maximum(counts[:-1], 1), np.nan)
    return sv, 10 * np.log10(mvbs.reshape(C, n_x, n_r))


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main():
    card = _card()  # before JAX touches the card
    import jax
    import jax.numpy as jnp

    from echopype_tpu.parallel.pipeline import (
        closed_bounds_k0_np,
        closed_window_counts_np,
        sv_mvbs_window_partials_uniform,
    )
    from echopype_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(Path(__file__).resolve().parent)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found platform {dev.platform!r}", file=sys.stderr)
        return 2

    # 5 channels (EK60 survey), 4000 samples, one 20,000-ping chunk
    C, R, Pn = 5, 4000, 20_000
    n_x, n_r = Pn // 80, 50  # ~20 s bins at 4 Hz pings, 20 m bins
    power, dr, tvg, ab, off, x_idx, r_edges = _inputs(C, Pn, R, n_x, n_r, power_dtype="i2")
    valid_len = np.full((C, Pn), R, dtype="i4")
    bounds_h, k0_h = closed_bounds_k0_np(dr[:, 0], tvg[:, 0], r_edges, R)
    counts_host = closed_window_counts_np(bounds_h, k0_h, valid_len, x_idx, n_x).astype("f4")

    @jax.jit
    def step(power, dr, tvg, ab, off, vl, x_idx, r_edges, counts_h):
        sums = sv_mvbs_window_partials_uniform(
            power, dr, tvg, ab, off, vl, x_idx, r_edges, n_x, n_r, with_counts=False,
        )
        mean = sums / jnp.where(counts_h > 0, counts_h, 1.0)
        return jnp.where(counts_h > 0, 10.0 * jnp.log10(mean), jnp.nan)

    args = [jax.device_put(a, dev) for a in
            (power, dr, tvg, ab, off, valid_len, x_idx, r_edges, counts_host)]
    t0 = time.perf_counter()
    step(*args).block_until_ready()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        step(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    Pb = 2_000
    bargs = _inputs(C, Pb, R, Pb // 80, n_r)
    base = []
    for _ in range(3):
        t0 = time.perf_counter()
        numpy_pipeline(*bargs, Pb // 80, n_r)
        base.append(time.perf_counter() - t0)
    base_rate = Pb / statistics.median(base)

    print(json.dumps({
        "metric": "EK60 raw->MVBS device program throughput (5ch x 4000 samples)",
        "value": round(Pn / dt, 1),
        "unit": "pings/sec/device",
        "vs_baseline": round(Pn / dt / base_rate, 2),
        "step_ms_median": round(dt * 1e3, 4),
        "step_ms_min": round(min(times) * 1e3, 4),
        "compile_s": round(compile_s, 2),
        "baseline_pings_per_sec": round(base_rate, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
