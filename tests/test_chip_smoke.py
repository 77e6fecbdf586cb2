"""chip_smoke.py on the CPU: each phase at a tiny size against its float64
reference, the reference helpers against brute force, and the refusal to
run (or print a result) anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    work = tmp_path_factory.mktemp("smoke")
    files, svs = cs.phase_ek60_survey(work, 3, n_files=2, n_pings=60, n_samples=200,
                                      workers=2)
    return work, files, svs


def test_phase_ek60_survey_tiny(survey):
    work, files, svs = survey
    assert len(files) == 2 and len(svs) == 2
    assert (work / "survey_mvbs.zarr").exists() and (work / "survey_nasc.zarr").exists()
    # consecutive files continue one northward track
    lat = np.concatenate([np.asarray(s["latitude"].values) for s in svs])
    assert np.all(np.diff(lat[np.isfinite(lat)]) >= 0)


def test_phase_ek80_bb_tiny(tmp_path):
    cs.phase_ek80_bb(tmp_path, 1, n_pings=24, n_samples=256)


def test_phase_parity_tiny(survey, tmp_path):
    cs.phase_parity(tmp_path, 2, survey[1][0])


def test_phase_mesh_tiny(tmp_path):
    # the suite's virtual CPU mesh has 8 devices; the phase takes the first 4
    cs.phase_mesh(tmp_path, 4, n_devices=4, n_files=2, n_pings=80, n_samples=160,
                  bb_pings=16, bb_samples=256)


def test_mvbs_reference_matches_brute_force():
    rng = np.random.default_rng(0)
    C, P, R = 2, 7, 11
    sv = rng.normal(-60, 6, (C, P, R))
    sv[0, 2, 5] = np.nan
    er = np.broadcast_to(np.arange(R) * 0.7, (C, P, R)).copy()
    er[1, :, -2:] = np.nan
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    pt = t0 + (np.arange(P) * 3).astype("timedelta64[s]")
    p_edges = t0 + (np.arange(0, 25, 10)).astype("timedelta64[s]")
    r_edges = np.arange(0, 8.0, 2.5)
    got = cs.mvbs_reference(sv, er, pt, p_edges, r_edges)
    want = np.full((C, len(p_edges) - 1, len(r_edges) - 1), np.nan)
    for c in range(C):
        for i in range(len(p_edges) - 1):
            for j in range(len(r_edges) - 1):
                vals = [10 ** (sv[c, p, k] / 10) for p in range(P) for k in range(R)
                        if p_edges[i] <= pt[p] < p_edges[i + 1]
                        and r_edges[j] <= er[c, p, k] < r_edges[j + 1]
                        and np.isfinite(sv[c, p, k])]
                if vals:
                    want[c, i, j] = 10 * np.log10(np.mean(vals))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "got, want, budget, message",
    [
        ([0.0, np.nan], [0.0, 1.0], 1.0, "NaN masks differ"),
        ([1.0, 2.0], [1.0, 2.1], 0.05, "dB >"),
        ([np.nan], [np.nan], 1.0, "every cell is NaN"),
        ([1.0, 2.0], [1.0, 2.0, 3.0], 1.0, "shape"),
    ],
)
def test_check_db_rejects(got, want, budget, message):
    with pytest.raises(cs.PhaseError, match=message):
        cs.check_db("t", np.array(got), np.array(want), budget)


@pytest.mark.parametrize("band", range(len(cs.BB_SV_BANDS)))
@pytest.mark.parametrize("factor, fails", [(0.5, False), (2.0, True)])
def test_check_bb_bands_gates_every_band(band, factor, fails):
    # one ping whose samples sit 0, 20, 40, 60 and 90 dB below its peak; a
    # second ping is all NaN
    want = np.array([[[-20.0, -40.0, -60.0, -80.0, -110.0], [np.nan] * 5]])
    # the sample that falls in this band and in no tighter one
    k = {0: 1, 1: 2, 2: 3, 3: 4}[band]
    got = want.copy()
    got[0, 0, k] += factor * cs.BB_SV_BANDS[band][1]
    if fails:
        with pytest.raises(cs.PhaseError, match="dB >"):
            cs.check_bb_bands("t", got, want)
    else:
        cs.check_bb_bands("t", got, want)


def test_below_ping_peak():
    sv = np.array([[[-30.0, np.nan, -50.0], [np.nan, np.nan, np.nan]],
                   [[-10.0, -70.0, -40.0], [-60.0, -55.0, np.nan]]])
    got = cs.below_ping_peak(sv)
    want = np.array([[[0.0, np.nan, 20.0], [np.nan, np.nan, np.nan]],
                     [[0.0, 60.0, 30.0], [5.0, 0.0, np.nan]]])
    np.testing.assert_array_equal(got, want)


def test_check_rel_budget():
    assert cs.check_rel("t", np.array([1.0, 2.0 + 1e-6]), np.array([1.0, 2.0]), 1e-6) > 0
    with pytest.raises(cs.PhaseError):
        cs.check_rel("t", np.array([1.0, 2.1]), np.array([1.0, 2.0]), 1e-6)


def test_main_refuses_cpu(capsys):
    import jax

    cache = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(SystemExit) as exc:
            cs.main(["--pings", "10"])
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert "platform: cpu" in out
    assert '"ok"' not in out


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

