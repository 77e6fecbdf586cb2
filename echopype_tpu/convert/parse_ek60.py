"""EK60 .raw parser: columnar decode into padded per-channel arrays.

Capability parity: echopype/convert/parse_ek60.py + the RAW0/CON0/NME paths of
parse_base.py:360-686.  Columnar redesign: no per-datagram Python loop —
one framing scan builds a columnar index; RAW0 headers decode in one
structured gather; sample payloads land directly in NaN-padded
``[ping, range_sample]`` float32 arrays (power already scaled by INDEX2POWER,
parse_base.py:302).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.log import _init_logger
from .simrad import framing
from .simrad import decode as dec
from ..utils.io import read_source_bytes

logger = _init_logger(__name__)

__all__ = ["ParseEK60"]

HEADER_SCALARS = [
    "transducer_depth",
    "transmit_power",
    "pulse_length",
    "bandwidth",
    "sample_interval",
    "sound_velocity",
    "absorption_coefficient",
    "heave",
    "roll",
    "pitch",
    "temperature",
    "heading",
]
HEADER_INTS = ["mode", "transmit_mode", "offset", "count"]


class ParseEK60:
    """Parse one EK60/ES70 .raw file into columnar per-channel data."""

    sonar_model = "EK60"

    def __init__(self, file, bot_file="", idx_file="", storage_options=None, sonar_model="EK60", **kw):
        self.source_file = str(file)
        self.bot_file = str(bot_file) if bot_file else ""
        self.idx_file = str(idx_file) if idx_file else ""
        self.storage_options = storage_options
        self.sonar_model = sonar_model
        self.config_datagram = None
        self.ping_time = {}  # ch -> datetime64[ns][n_ping]
        self.ping_data_dict = {}  # field -> ch -> ndarray
        self.nmea = {"string": np.empty(0, object), "timestamp": np.empty(0, "datetime64[ns]")}
        self.bot = {"depth": [], "timestamp": []}
        self.idx = {}

    # ---------------------------------------------------------------- parsing
    def parse_raw(self):
        buf = read_source_bytes(self.source_file, self.storage_options)
        index = framing.scan_datagrams(buf)

        con_rows = index.select("CON0")
        if len(con_rows) == 0:
            raise ValueError(f"{self.source_file}: no CON0 configuration datagram found")
        self.config_datagram = dec.decode_con0(index, int(con_rows[0]))

        raw_rows = index.select("RAW0")
        hdr, ts = dec.decode_raw0_headers(index, raw_rows)

        # group rows by transceiver channel number, preserving file order
        self.ping_data_dict = {k: {} for k in HEADER_SCALARS + HEADER_INTS + ["power", "angle"]}
        channels = np.unique(hdr["channel"]) if len(hdr) else []
        for ch in channels:
            ch = int(ch)
            sel = np.nonzero(hdr["channel"] == ch)[0]
            ch_hdr = hdr[sel]
            self.ping_time[ch] = ts[sel]
            for f in HEADER_SCALARS:
                self.ping_data_dict[f][ch] = ch_hdr[f].astype("f8")
            for f in HEADER_INTS:
                self.ping_data_dict[f][ch] = ch_hdr[f].astype("i8")
            samples = dec.decode_raw0_samples(index, raw_rows[sel], ch_hdr)
            self.ping_data_dict["power"][ch] = (
                samples["power"] if samples["power"] is not None else np.zeros((len(sel), 0), "f4")
            )
            self.ping_data_dict["angle"][ch] = samples["angle"]

        nme_rows = index.select("NME0")
        self.nmea["string"], self.nmea["timestamp"] = dec.decode_nmea(index, nme_rows)

        if self.bot_file:
            self._parse_bot()
        if self.idx_file:
            self._parse_idx()
        return self

    def _parse_idx(self):
        try:
            buf = read_source_bytes(self.idx_file, self.storage_options)
            index = framing.scan_datagrams(buf)
            self.idx = dec.decode_idx(index, index.select("IDX0"))
        except Exception as e:  # noqa: BLE001 - sidecar is best-effort, like reference
            logger.warning("Failed to parse IDX file %s: %r", self.idx_file, e)

    def _parse_bot(self):
        try:
            buf = read_source_bytes(self.bot_file, self.storage_options)
            index = framing.scan_datagrams(buf)
            self.bot.update(dec.decode_bot(index, index.select("BOT0")))
        except Exception as e:  # noqa: BLE001 - sidecar is best-effort, like reference
            logger.warning("Failed to parse BOT file %s: %r", self.bot_file, e)

    def rectangularize_data(self, *a, **kw):
        """Columnar decode already produces rectangular padded arrays."""
        return self
