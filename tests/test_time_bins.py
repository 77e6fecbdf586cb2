"""Ping-time bin edges and bin-string parsing without pandas.

The expected values are what pandas 3.0 gives for the reference's
``Series.resample(freq).first().index`` plus one trailing edge, and for
``pd.Timedelta(freq).resolution_string``; they are hard-coded so the tests
run where pandas is not installed.
"""

import numpy as np
import pytest

from echopype_tpu.commongrid.utils import (
    _timedelta_ns,
    parse_time_bin_to_value_unit,
    ping_time_bin_edges,
)

# (first ping, bin, span of the pings in ns, pandas' first edge, edge count);
# pings sit at first, first + span // 3 + 123 ns and first + span + 17 ns
RESAMPLE_CASES = [
    ("2020-01-01T00:00:00", "20s", 7200000000000, "2020-01-01T00:00:00", 362),
    ("2020-01-01T00:00:00", "1min", 7200000000000, "2020-01-01T00:00:00", 122),
    ("2020-01-01T00:00:00", "0.5min", 3600000000000, "2020-01-01T00:00:00", 122),
    ("2020-01-01T00:00:00", "2h", 86400000000000, "2020-01-01T00:00:00", 14),
    ("2020-01-01T00:00:00", "250ms", 3000000000, "2020-01-01T00:00:00", 14),
    ("2020-01-01T00:00:00", "1D", 200000000000000, "2020-01-01T00:00:00", 4),
    ("2020-01-01T00:00:07.25", "20s", 7200000000000, "2020-01-01T00:00:00", 362),
    ("2020-01-01T00:00:07.25", "1min", 7200000000000, "2020-01-01T00:00:00", 122),
    ("2020-01-01T00:00:07.25", "0.5min", 3600000000000, "2020-01-01T00:00:00", 122),
    ("2020-01-01T00:00:07.25", "2h", 86400000000000, "2020-01-01T00:00:00", 14),
    ("2020-01-01T00:00:07.25", "250ms", 3000000000, "2020-01-01T00:00:07.250", 14),
    ("2020-01-01T00:00:07.25", "1D", 200000000000000, "2020-01-01T00:00:00", 4),
    ("2019-12-31T23:59:41.5", "20s", 7200000000000, "2019-12-31T23:59:40", 362),
    ("2019-12-31T23:59:41.5", "1min", 7200000000000, "2019-12-31T23:59:00", 122),
    ("2019-12-31T23:59:41.5", "0.5min", 3600000000000, "2019-12-31T23:59:30", 122),
    ("2019-12-31T23:59:41.5", "2h", 86400000000000, "2019-12-31T22:00:00", 14),
    ("2019-12-31T23:59:41.5", "250ms", 3000000000, "2019-12-31T23:59:41.500", 14),
    ("2019-12-31T23:59:41.5", "1D", 200000000000000, "2019-12-31T00:00:00", 5),
    ("2021-06-30T13:47:13.123456789", "20s", 7200000000000, "2021-06-30T13:47:00", 362),
    ("2021-06-30T13:47:13.123456789", "1min", 7200000000000, "2021-06-30T13:47:00", 122),
    ("2021-06-30T13:47:13.123456789", "0.5min", 3600000000000, "2021-06-30T13:47:00", 122),
    ("2021-06-30T13:47:13.123456789", "2h", 86400000000000, "2021-06-30T12:00:00", 14),
    ("2021-06-30T13:47:13.123456789", "250ms", 3000000000, "2021-06-30T13:47:13", 14),
    ("2021-06-30T13:47:13.123456789", "1D", 200000000000000, "2021-06-30T00:00:00", 4),
]


@pytest.mark.parametrize("start, freq, span, first_edge, n_edges", RESAMPLE_CASES)
def test_ping_time_bin_edges_match_pandas_resample(start, freq, span, first_edge, n_edges):
    t0 = np.datetime64(start, "ns")
    pings = t0 + np.array([0, span // 3 + 123, span + 17], dtype="timedelta64[ns]")
    edges = ping_time_bin_edges(pings[::-1], freq)  # order does not matter
    step = np.timedelta64(_timedelta_ns(freq), "ns")
    want = np.datetime64(first_edge, "ns") + np.arange(n_edges) * step
    assert edges.dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(edges, want)
    # every ping falls in a left-closed bin, the last one in the last bin
    assert edges[0] <= pings.min() < edges[1]
    assert edges[-2] <= pings.max() < edges[-1]


def test_ping_time_bin_edges_skip_nat():
    pt = np.array(["2020-01-01T00:00:05", "NaT", "2020-01-01T00:00:45"], dtype="datetime64[ns]")
    np.testing.assert_array_equal(
        ping_time_bin_edges(pt, "20s"),
        np.array(["2020-01-01T00:00:00", "2020-01-01T00:00:20", "2020-01-01T00:00:40",
                  "2020-01-01T00:01:00"], dtype="datetime64[ns]"),
    )


# (bin string, pd.Timedelta(...).value, parse_time_bin_to_value_unit result)
PARSE_CASES = [
    ("20s", 20_000_000_000, (20, "second")),
    ("1min", 60_000_000_000, (1, "minute")),
    ("0.5min", 30_000_000_000, (30, "second")),
    ("2h", 7_200_000_000_000, (2, "hour")),
    ("250ms", 250_000_000, (250, "millisecond")),
    ("1D", 86_400_000_000_000, (1, "day")),
    ("1h30min", 5_400_000_000_000, (90, "minute")),
    ("2.5h", 9_000_000_000_000, (150, "minute")),
    ("90s", 90_000_000_000, (90, "second")),
    ("10S", 10_000_000_000, (10, "second")),
    ("250us", 250_000, (0, "millisecond")),
    ("1500ns", 1_500, (0, "millisecond")),
]


@pytest.mark.parametrize("text, ns, value_unit", PARSE_CASES)
def test_parse_time_bin_matches_pandas(text, ns, value_unit):
    assert _timedelta_ns(text) == ns
    assert parse_time_bin_to_value_unit(text) == value_unit


@pytest.mark.parametrize("bad", ["", "20", "s", "20 parsecs", "-5s", "0s", "20s junk"])
def test_bad_time_bin_strings_raise(bad):
    with pytest.raises(ValueError):
        ping_time_bin_edges(np.array(["2020-01-01"], dtype="datetime64[ns]"), bad)
