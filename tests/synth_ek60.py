"""Synthetic EK60 .raw file writer for tests.

Writes byte-exact Simrad framing (int32 size | body | int32 size) with CON0,
RAW0, and NME0 datagrams, so the parser is tested against the real binary
format without needing instrument files (which require network downloads).
"""

import struct

import numpy as np

NT_UNIX_DELTA_S = 11644473600


def dt64_to_nt(ts: np.datetime64):
    ns = int(ts.astype("datetime64[ns]").astype("i8"))
    ticks = (ns + NT_UNIX_DELTA_S * 1_000_000_000) // 100
    return int(ticks & 0xFFFFFFFF), int(ticks >> 32)


def frame(body: bytes) -> bytes:
    return struct.pack("<l", len(body)) + body + struct.pack("<l", len(body))


def make_con0(timestamp, transceivers, sounder_name="ER60", survey="TestSurvey", version="2.4.3"):
    low, high = dt64_to_nt(timestamp)
    body = struct.pack(
        "<4sLL128s128s128s30s98sl",
        b"CON0",
        low,
        high,
        survey.encode(),
        b"transect",
        sounder_name.encode(),
        version.encode(),
        b"",
        len(transceivers),
    )
    for tx in transceivers:
        body += struct.pack(
            "<128sl" + "f" * 15 + "5f8s5f8s5f8s16s28s",
            tx["channel_id"].encode(),
            tx.get("beam_type", 1),
            tx["frequency"],
            tx.get("gain", 25.0),
            tx.get("equivalent_beam_angle", -20.7),
            tx.get("beamwidth_alongship", 7.0),
            tx.get("beamwidth_athwartship", 7.0),
            tx.get("angle_sensitivity_alongship", 21.9),
            tx.get("angle_sensitivity_athwartship", 21.9),
            tx.get("angle_offset_alongship", 0.0),
            tx.get("angle_offset_athwartship", 0.0),
            tx.get("pos_x", 0.0),
            tx.get("pos_y", 0.0),
            tx.get("pos_z", 0.0),
            tx.get("dir_x", 0.0),
            tx.get("dir_y", 0.0),
            tx.get("dir_z", 0.0),
            *tx.get("pulse_length_table", [256e-6, 512e-6, 1024e-6, 2048e-6, 4096e-6]),
            b"",
            *tx.get("gain_table", [22.0, 23.0, 24.0, 25.0, 26.0]),
            b"",
            *tx.get("sa_correction_table", [0.0, -0.1, -0.2, -0.3, -0.4]),
            b"",
            tx.get("gpt_software_version", "070413").encode(),
            b"",
        )
    return frame(body)


def make_raw0(
    timestamp,
    channel,
    power_idx=None,
    angle=None,
    mode=None,
    transducer_depth=9.15,
    frequency=38000.0,
    transmit_power=2000.0,
    pulse_length=1024e-6,
    bandwidth=2425.0,
    sample_interval=256e-6,
    sound_velocity=1480.0,
    absorption_coefficient=0.0098,
    heave=0.0,
    roll_=0.0,
    pitch=0.0,
    temperature=8.0,
    heading=0.0,
    transmit_mode=0,
    offset=0,
):
    """power_idx: int16 raw power indices; angle: int8 [n,2] (athwart, along)."""
    if mode is None:
        mode = (1 if power_idx is not None else 0) | (2 if angle is not None else 0)
    count = len(power_idx) if power_idx is not None else (len(angle) if angle is not None else 0)
    low, high = dt64_to_nt(timestamp)
    body = struct.pack(
        "<4sLLhh13fh6sll",
        b"RAW0",
        low,
        high,
        channel,
        mode,
        transducer_depth,
        frequency,
        transmit_power,
        pulse_length,
        bandwidth,
        sample_interval,
        sound_velocity,
        absorption_coefficient,
        heave,
        roll_,
        pitch,
        temperature,
        heading,
        transmit_mode,
        b"",
        offset,
        count,
    )
    if power_idx is not None and mode & 1:
        body += np.asarray(power_idx, dtype="<i2").tobytes()
    if angle is not None and mode & 2:
        body += np.asarray(angle, dtype="i1").tobytes()
    return frame(body)


def make_nme0(timestamp, sentence: str):
    low, high = dt64_to_nt(timestamp)
    body = struct.pack("<4sLL", b"NME0", low, high) + sentence.encode()
    return frame(body)


def write_ek60_raw(
    path,
    n_pings=10,
    n_samples=50,
    channels=("GPT  18 kHz 009072034d45 1-1 ES18-11", "GPT  38 kHz 009072033fa2 2-1 ES38B"),
    frequencies=(18000.0, 38000.0),
    t0=np.datetime64("2020-01-01T00:00:00", "ns"),
    seed=0,
    with_angle=True,
    with_nmea=True,
    ragged=False,
    skip_pings=None,
    per_channel_samples=None,
    jitter_config=False,
    jitter_raw0=False,
    nmea_types=None,
    nmea_track=None,
):
    """Write a synthetic multi-channel EK60 file; returns ground-truth dict.

    skip_pings : optional {channel_index(1-based): set of ping numbers} —
        those channels emit no RAW0 for those pings (disjoint ping sets, the
        union-grid missing-row case).
    per_channel_samples : optional per-channel sample counts (unequal range
        lengths across channels).
    jitter_config : randomize the per-transceiver CON0 installation fields
        (beam widths, angle offsets/sensitivities, mount position/direction,
        EBA, pulse/gain/sa tables) so cross-channel mixups are detectable.
    jitter_raw0 : randomize the per-datagram RAW0 environment/motion fields
        (sound_velocity, absorption, temperature, transducer_depth,
        heave/roll/pitch/heading) per channel per ping.
    nmea_types : optional list of sentence types (subset of GGA/GLL/RMC) to
        randomize the NMEA stream over (default: fixed GGA).
    nmea_track : optional (lat0, lon0, dlat_per_ping) in degrees — GGA fixes
        along a straight northward track, lat = lat0 + dlat_per_ping * p at
        ping p (a vessel underway; the default fixes are not a track).
    """
    rng = np.random.default_rng(seed)
    txs = [
        {"channel_id": cid, "frequency": f, "gain": 25.0 + i}
        for i, (cid, f) in enumerate(zip(channels, frequencies))
    ]
    if jitter_config:
        for tx in txs:
            tx["equivalent_beam_angle"] = round(float(rng.uniform(-21.5, -19.5)), 2)
            tx["beamwidth_alongship"] = round(float(rng.uniform(5.5, 11.0)), 2)
            tx["beamwidth_athwartship"] = round(float(rng.uniform(5.5, 11.0)), 2)
            tx["angle_sensitivity_alongship"] = round(float(rng.uniform(15.0, 28.0)), 2)
            tx["angle_sensitivity_athwartship"] = round(float(rng.uniform(15.0, 28.0)), 2)
            tx["angle_offset_alongship"] = round(float(rng.uniform(-0.5, 0.5)), 3)
            tx["angle_offset_athwartship"] = round(float(rng.uniform(-0.5, 0.5)), 3)
            tx["pos_x"] = round(float(rng.uniform(-2.0, 2.0)), 3)
            tx["pos_y"] = round(float(rng.uniform(-2.0, 2.0)), 3)
            tx["pos_z"] = round(float(rng.uniform(0.0, 6.0)), 3)
            tx["dir_x"] = round(float(rng.uniform(-1.0, 1.0)), 3)
            tx["dir_y"] = round(float(rng.uniform(-1.0, 1.0)), 3)
            tx["dir_z"] = round(float(rng.uniform(-1.0, 1.0)), 3)
            tx["pulse_length_table"] = sorted(
                round(float(v), 6) for v in rng.uniform(64e-6, 8192e-6, 5))
            tx["gain_table"] = [round(float(v), 2)
                                for v in rng.uniform(20.0, 28.0, 5)]
            tx["sa_correction_table"] = [round(float(v), 3)
                                         for v in rng.uniform(-0.5, 0.0, 5)]
    chunks = [make_con0(t0, txs)]
    truth = {
        "power_idx": {},
        "angle": {},
        "ping_time": {},
        "channels": list(channels),
        "frequencies": list(frequencies),
    }
    for i, cid in enumerate(channels, start=1):
        truth["power_idx"][i] = []
        truth["angle"][i] = []
        truth["ping_time"][i] = []
    for p in range(n_pings):
        ts = t0 + np.timedelta64(p + 1, "s")
        for i, (cid, f) in enumerate(zip(channels, frequencies), start=1):
            if skip_pings and p in skip_pings.get(i, ()):
                continue
            base_ns = per_channel_samples[i - 1] if per_channel_samples else n_samples
            # ragged shortening clamps at 1 sample (tiny base counts drove
            # the count negative — round-5 soak, n_samples=9)
            ns = base_ns if not ragged else max(base_ns - (p % 3) * 5, 1)
            pw = rng.integers(-20000, 0, ns).astype("<i2")
            ang = rng.integers(-50, 50, (ns, 2)).astype("i1") if with_angle else None
            raw0_kw = {}
            if jitter_raw0:
                raw0_kw = dict(
                    sound_velocity=round(float(rng.uniform(1440, 1540)), 1),
                    absorption_coefficient=round(float(rng.uniform(0.001, 0.05)), 5),
                    temperature=round(float(rng.uniform(-1, 25)), 2),
                    transducer_depth=round(float(rng.uniform(0, 12)), 2),
                    heave=round(float(rng.normal(0, 0.5)), 3),
                    roll_=round(float(rng.normal(0, 2.0)), 3),
                    pitch=round(float(rng.normal(0, 2.0)), 3),
                    heading=round(float(rng.uniform(0, 360)), 2),
                )
            chunks.append(
                make_raw0(
                    ts,
                    i,
                    power_idx=pw,
                    angle=ang,
                    frequency=f,
                    pulse_length=1024e-6,
                    transmit_power=2000.0 - i * 100,
                    **raw0_kw,
                )
            )
            truth["power_idx"][i].append(pw)
            truth["angle"][i].append(ang)
            truth["ping_time"][i].append(ts)
        if with_nmea and p % 2 == 0:
            if nmea_types:
                typ = str(nmea_types[int(rng.integers(0, len(nmea_types)))])
                lat_s = (f"{int(rng.integers(0, 80)):02d}"
                         f"{rng.uniform(0, 59.9999):07.4f}")
                lon_s = (f"{int(rng.integers(0, 170)):03d}"
                         f"{rng.uniform(0, 59.9999):07.4f}")
                ns_h = "S" if rng.random() < 0.5 else "N"
                ew_h = "W" if rng.random() < 0.5 else "E"
                if typ == "GGA":
                    sent = (f"$GPGGA,120000,{lat_s},{ns_h},{lon_s},{ew_h},"
                            f"1,08,0.9,5.0,M,,M,,")
                elif typ == "GLL":
                    sent = f"$GPGLL,{lat_s},{ns_h},{lon_s},{ew_h},120000,A"
                else:  # RMC
                    sent = (f"$GPRMC,120000,A,{lat_s},{ns_h},{lon_s},{ew_h},"
                            f"022.4,084.4,230394,003.1,W")
            elif nmea_track is not None:
                lat = nmea_track[0] + nmea_track[2] * p
                lon = nmea_track[1]
                lat_s = f"{int(abs(lat)):02d}{(abs(lat) % 1) * 60:07.4f}"
                lon_s = f"{int(abs(lon)):03d}{(abs(lon) % 1) * 60:07.4f}"
                sent = (f"$GPGGA,120000,{lat_s},{'N' if lat >= 0 else 'S'},"
                        f"{lon_s},{'E' if lon >= 0 else 'W'},1,08,0.9,5.0,M,,M,,")
            else:
                sent = f"$GPGGA,120000,{30:02d}{p:02d}.5000,N,{122:03d}{p:02d}.2500,W,1,08,0.9,5.0,M,,M,,"
            chunks.append(make_nme0(ts, sent))
    data = b"".join(chunks)
    with open(path, "wb") as f:
        f.write(data)
    return truth
