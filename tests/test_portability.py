"""What the package needs from the machine it runs on: no pandas/h5py/fsspec/
psutil on the survey path, a CPU-pinned decode pool, a fixed compile-cache
directory, a native library built from the source beside it, and a GPU for
the benchmark."""

import hashlib
import logging
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

_BLOCK = textwrap.dedent(
    """
    import sys
    BLOCKED = {"pandas", "h5py", "fsspec", "psutil"}

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, _Block())
    """
)

_DRIVES = {
    "compute_MVBS": """
        import numpy as np
        import echopype_tpu as ep
        from synth_ek60 import write_ek60_raw
        write_ek60_raw("a.raw", n_pings=30, n_samples=80)
        sv = ep.calibrate.compute_Sv(ep.open_raw("a.raw", sonar_model="EK60"))
        mvbs = ep.commongrid.compute_MVBS(sv, range_bin="5m", ping_time_bin="10s")
        assert np.isfinite(mvbs["Sv"].values).any()
        assert "pandas" not in sys.modules
        print("OK", mvbs["Sv"].values.shape)
    """,
    "run_survey_mvbs_from_raw": """
        import numpy as np
        from echopype_tpu.parallel import run_survey_mvbs_from_raw
        from synth_ek60 import write_ek60_raw
        write_ek60_raw("a.raw", n_pings=30, n_samples=80)
        write_ek60_raw("b.raw", n_pings=30, n_samples=80, seed=1,
                       t0=np.datetime64("2020-01-01T00:01:00", "ns"))
        out = run_survey_mvbs_from_raw(["a.raw", "b.raw"], range_bin="5m",
                                       ping_time_bin="10s")
        assert np.isfinite(out["Sv"].values).any()
        assert "pandas" not in sys.modules
        print("OK", out["Sv"].values.shape)
    """,
}


@pytest.mark.parametrize("drive", sorted(_DRIVES))
def test_survey_path_without_optional_packages(drive, tmp_path):
    paths = f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
    code = _BLOCK + paths + textwrap.dedent(_DRIVES[drive])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout


def _worker_platform():
    import jax

    return os.environ.get("JAX_PLATFORMS"), jax.config.jax_platforms, jax.devices()[0].platform


def test_decode_pool_workers_pinned_to_cpu(monkeypatch):
    from echopype_tpu.parallel.survey import _pin_worker_to_cpu

    # a spawned worker inherits the parent's environment at start: without
    # the initializer it would take JAX's default platform
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn"),
                             initializer=_pin_worker_to_cpu) as ex:
        env_value, config_value, platform = ex.submit(_worker_platform).result(timeout=240)
    assert env_value == "cpu"
    assert config_value == "cpu"
    assert platform == "cpu"


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    import jax

    from echopype_tpu.utils.compile_cache import enable_compile_cache

    chosen = tmp_path / "from_env"
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(chosen))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache(tmp_path / "checkout")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    want = chosen if env_set else (tmp_path / "checkout").resolve() / ".jax_cache"
    assert got == str(want)


def test_native_library_keyed_on_source_hash():
    from echopype_tpu import native

    digest = hashlib.sha256(
        (ROOT / "echopype_tpu" / "native" / "src" / "ingest.cpp").read_bytes()
    ).hexdigest()[:16]
    assert native.library_path().name == f"_ingest_{digest}.so"
    if native.load_native() is not None:
        assert native.library_path().exists()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_native_scanner_failure_warns_and_falls_back(monkeypatch):
    from echopype_tpu import native
    from echopype_tpu.convert.simrad import framing

    buf = b"".join(
        len(b).to_bytes(4, "little") + b + len(b).to_bytes(4, "little")
        for b in (b"CON0" + bytes(16), b"RAW0" + bytes(24))
    )
    want = framing.scan_datagrams(buf, use_native=False)

    def broken(*a, **k):
        raise RuntimeError("library went away")

    monkeypatch.setattr(native, "scan_datagrams_native", broken)
    records = _Records()
    framing.logger.addHandler(records)  # the package's loggers do not propagate
    try:
        got = framing.scan_datagrams(buf, use_native=True)
    finally:
        framing.logger.removeHandler(records)
    assert any("native datagram scanner failed" in m for m in records.messages)
    np.testing.assert_array_equal(got.body_offset, want.body_offset)
    np.testing.assert_array_equal(got.dgram_type, want.dgram_type)


def test_bench_refuses_cpu():
    sys.path.insert(0, str(ROOT))
    import bench

    assert bench.main() != 0
