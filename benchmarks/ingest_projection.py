"""Ingest throughput: per-stage single-core rates + N-core projection.

The architecture is ingest-parallel (one file per worker process,
run_survey_mvbs_from_raw(workers=N)).  This script measures the single-core
rate of each pipeline stage on a synthetic EK60 survey and projects
end-to-end GB/s for an N-core host from the pipeline equation:

    rate(N) = 1 / max(decode_time/N, transfer_time, device_time)   per byte

(decode parallelizes over files; H2D transfer and the device stream are
single-resource).  Run: python benchmarks/ingest_projection.py [n_files]
"""

import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tests"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import echopype_tpu as ep  # noqa: E402
from echopype_tpu.calibrate.ek import CalibrateEK60  # noqa: E402
from echopype_tpu.utils.profiling import StageTimer  # noqa: E402
from synth_ek60 import write_ek60_raw  # noqa: E402


def main():
    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    tmp = pathlib.Path(tempfile.mkdtemp())
    files = []
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    for i in range(n_files):
        f = tmp / f"P{i}-D20200101-T000000.raw"
        write_ek60_raw(
            f, n_pings=600, n_samples=2000, t0=t0 + np.timedelta64(i * 600, "s"), seed=i
        )
        files.append(f)
    total_bytes = sum(f.stat().st_size for f in files)

    # stage 1: decode + convert (open_raw), single core
    t = time.time()
    eds = [ep.open_raw(f, sonar_model="EK60") for f in files]
    t_decode = time.time() - t

    # stage 2: host param resolution + input assembly
    t = time.time()
    cals = [CalibrateEK60(ed) for ed in eds]
    inputs = [cal._power_cal_inputs("Sv") for cal in cals]
    t_params = time.time() - t

    # stage 3: device stream (H2D + fused kernel), via the streamer's timer
    timer = StageTimer()
    from echopype_tpu.parallel import run_survey_mvbs_from_raw

    t = time.time()
    run_survey_mvbs_from_raw(
        files, sonar_model="EK60", range_bin_m=20.0, ping_time_bin="20s",
        chunk_pings=256, prefetch=False, timer=timer,
    )
    t_total = time.time() - t
    rep = timer.report(log=False)
    t_device = rep.get("device_mvbs", {}).get("total_s", 0.0)
    t_ingest = rep.get("ingest", {}).get("total_s", 0.0)

    mb = total_bytes / 2**20
    print(f"survey: {n_files} files, {mb:.1f} MiB raw")
    print(f"decode+convert (1 core): {t_decode:.2f} s  ({mb / t_decode:.1f} MiB/s)")
    print(f"param resolution:        {t_params:.2f} s  ({mb / max(t_params, 1e-9):.0f} MiB/s)")
    print(f"streamer end-to-end:     {t_total:.2f} s  ({mb / t_total:.1f} MiB/s)")
    print(f"  of which ingest:       {t_ingest:.2f} s, device+H2D: {t_device:.2f} s")

    d_rate = mb / t_decode            # MiB/s per core, parallel over files
    dev_rate = mb / max(t_device, 1e-9)  # MiB/s, single device stream
    print("\nprojection (decode over N cores; device stream single-resource):")
    print("| cores | decode MiB/s | bottleneck | projected end-to-end MiB/s |")
    print("|---|---|---|---|")
    for n in (1, 2, 4, 8, 16, 32):
        dec = d_rate * n
        eff = min(dec, dev_rate)
        bott = "decode" if dec < dev_rate else "device/H2D"
        print(f"| {n} | {dec:.0f} | {bott} | {eff:.0f} |")
    print(
        "\nNOTE: the device column is the end-to-end stream rate of this "
        "machine's device path (transfer + kernel), not kernel compute alone."
    )


if __name__ == "__main__":
    main()
