"""EK80 transmit-replica construction and pulse compression.

Capability parity: echopype/calibrate/ek80_complex.py:12-391 — Hann-tapered
LFM/CW chirp (CRIMAC/Andersen implementation, with the pyEcholab
drop_last_hanning_zero variant), WBT+PC filtering/decimation of the replica,
vendor filter lookup, effective pulse length from replica autocorrelation
energy, and the matched-filter pulse compression (FFT kernel on device,
ops/matched_filter.py).
"""

from __future__ import annotations

import numpy as np
from scipy import signal

from ..ops.matched_filter import pulse_compress_channel
from ..xrlite import DataArray

WIDE_BAND_TRANS = "WBT"
PULSE_COMPRESS = "PC"
FILTER_IMAG = "coeffs_imag"
FILTER_REAL = "coeffs_real"
DECIMATION = "deci_fac"

__all__ = [
    "tapered_chirp",
    "filter_decimate_chirp",
    "get_vend_filter_EK80",
    "get_filter_coeff",
    "get_tau_effective",
    "get_transmit_signal",
    "compress_pulse",
    "get_norm_fac",
]


def tapered_chirp(
    fs,
    transmit_duration_nominal,
    slope,
    transmit_frequency_start,
    transmit_frequency_stop,
    drop_last_hanning_zero=False,
):
    """Hann-tapered linear chirp replica (Andersen/CRIMAC formulation)."""
    tau = float(np.atleast_1d(transmit_duration_nominal)[0])
    f0 = float(np.atleast_1d(transmit_frequency_start)[0])
    f1 = float(np.atleast_1d(transmit_frequency_stop)[0])
    sl = float(np.atleast_1d(slope)[0])
    fs = float(np.atleast_1d(fs)[0])

    nsamples = int(np.floor(tau * np.float32(fs)))
    t = np.linspace(0, nsamples - 1, num=nsamples) * 1 / fs
    a = np.pi * (f1 - f0) / tau
    b = 2 * np.pi * f0
    y = np.cos(a * t * t + b * t)
    L = int(np.round(tau * fs * sl * 2.0))  # Hann window length
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(0, L, 1) / (L - 1)))
    N = len(y)
    w1 = w[: int(len(w) / 2)]
    w2 = w[int(len(w) / 2) : -1] if drop_last_hanning_zero else w[int(len(w) / 2) :]
    y[: len(w1)] = y[: len(w1)] * w1
    y[N - len(w2) :] = y[N - len(w2) :] * w2
    return y / np.max(y), t


def filter_decimate_chirp(coeff_ch: dict, y_ch: np.ndarray, fs: float):
    """Apply WBT then PC filters with decimation to the replica."""
    ytx_wbt = signal.convolve(y_ch, coeff_ch["wbt_fil"])
    ytx_wbt_deci = ytx_wbt[:: int(coeff_ch["wbt_decifac"])]
    ytx_pc = signal.convolve(ytx_wbt_deci, coeff_ch["pc_fil"])
    ytx_pc_deci = ytx_pc[:: int(coeff_ch["pc_decifac"])]
    ytx_pc_deci_time = (
        np.arange(ytx_pc_deci.size) / fs * coeff_ch["wbt_decifac"] * coeff_ch["pc_decifac"]
    )
    return ytx_pc_deci, ytx_pc_deci_time


def get_vend_filter_EK80(vend, channel_id: str, filter_name: str, param_type: str):
    """Fetch filter coefficients / decimation from the Vendor group."""
    var_imag = f"{filter_name}_{FILTER_IMAG}"
    var_real = f"{filter_name}_{FILTER_REAL}"
    var_df = f"{filter_name}_{DECIMATION}"
    if not all(v in vend for v in (var_imag, var_real, var_df)):
        return None
    sel = vend.sel(channel=channel_id)
    if param_type == "coeff":
        re = np.asarray(sel[var_real].values, dtype="f8").ravel()
        im = np.asarray(sel[var_imag].values, dtype="f8").ravel()
        v = re + 1j * im
        return v[~np.isnan(re)]
    val = np.asarray(sel[var_df].values).ravel()
    return val[0] if val.size else None


def get_filter_coeff(vend) -> dict:
    """WBT/PC coefficients + decimation per channel (first filter_time)."""
    if "filter_time" in vend.sizes:
        vend = vend.isel(filter_time=0)
    coeff = {}
    for ch_id in vend.coords["channel"].values:
        ch_id = str(ch_id)
        coeff[ch_id] = {
            "wbt_fil": get_vend_filter_EK80(vend, ch_id, "WBT", "coeff"),
            "pc_fil": get_vend_filter_EK80(vend, ch_id, "PC", "coeff"),
            "wbt_decifac": get_vend_filter_EK80(vend, ch_id, "WBT", "decimation"),
            "pc_decifac": get_vend_filter_EK80(vend, ch_id, "PC", "decimation"),
        }
    return coeff


def get_tau_effective(ytx_dict, fs_deci_dict, waveform_mode, channel, ping_time):
    """Effective pulse length from transmit-signal energy
    (ek80_complex.py:162-208)."""
    tau_eff = {}
    for ch, ytx in ytx_dict.items():
        if waveform_mode == "BB":
            ytxa = signal.convolve(ytx, np.flip(np.conj(ytx))) / np.linalg.norm(ytx) ** 2
            ptxa = np.abs(ytxa) ** 2
        else:
            ptxa = np.abs(ytx) ** 2
        tau_eff[ch] = ptxa.sum() / (ptxa.max() * float(np.atleast_1d(fs_deci_dict[ch])[0]))
    ch_vals = channel.values if isinstance(channel, DataArray) else np.asarray(channel)
    vals = np.array([tau_eff[str(c)] for c in ch_vals])
    return DataArray(vals, ("channel",), coords={"channel": ch_vals})


def get_transmit_signal(beam, coeff, waveform_mode, fs, drop_last_hanning_zero=False):
    """Reconstruct the filtered+decimated transmit replica per channel."""
    if waveform_mode == "BB" and np.all(np.asarray(beam["transmit_type"].values) == "CW"):
        raise TypeError("File does not contain BB mode complex samples!")
    y_all, y_time_all = {}, {}
    tx_param_names = [
        "transmit_duration_nominal",
        "slope",
        "transmit_frequency_start",
        "transmit_frequency_stop",
    ]
    for ch in beam.coords["channel"].values:
        ch = str(ch)
        fs_chan = (
            float(fs.sel(channel=ch).values) if isinstance(fs, DataArray) else float(fs)
        )
        tx_params = {}
        for p in tx_param_names:
            if waveform_mode == "CW" and p in (
                "transmit_frequency_start",
                "transmit_frequency_stop",
            ):
                vals = np.unique(beam["frequency_nominal"].sel(channel=ch).values)
            else:
                vals = np.unique(np.asarray(beam[p].sel(channel=ch).values, dtype="f8"))
                vals = vals[~np.isnan(vals)]
            if vals.size != 1:
                raise TypeError(f"File contains changing {p}!")
            tx_params[p] = vals
        tx_params["fs"] = fs_chan
        tx_params["drop_last_hanning_zero"] = drop_last_hanning_zero
        y_ch, _ = tapered_chirp(**tx_params)
        y_ch, y_tmp_time = filter_decimate_chirp(coeff_ch=coeff[ch], y_ch=y_ch, fs=fs_chan)
        y_all[ch] = y_ch
        y_time_all[ch] = y_tmp_time
    return y_all, y_time_all


def compress_pulse(backscatter: DataArray, chirp: dict, precision: str = "float64") -> DataArray:
    """Matched-filter pulse compression over [channel, ping, range, beam].

    precision="float64" is the exact host path (the compute_Sv opt-in);
    "float32" (the compute_Sv default) runs the device Toeplitz kernel
    (budget in docs/PERFORMANCE.md).
    """
    ch_vals = [str(c) for c in backscatter.coords["channel"].values]
    bs = np.asarray(backscatter.values)
    out = np.empty_like(bs, dtype="complex128")
    for ci, ch in enumerate(ch_vals):
        out[ci] = pulse_compress_channel(bs[ci], chirp[ch], precision=precision)
    pc = DataArray(out, backscatter.dims, name="pulse_compressed_output")
    pc.coords = dict(backscatter.coords)
    return pc


def get_norm_fac(chirp: dict) -> DataArray:
    """Replica energy normalization factor per channel."""
    chans = list(chirp)
    vals = np.array([np.linalg.norm(chirp[ch]) ** 2 for ch in chans])
    return DataArray(vals, ("channel",), coords={"channel": np.asarray(chans, dtype=object)})
