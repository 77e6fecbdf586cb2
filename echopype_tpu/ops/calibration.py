"""Fused EK power-mode calibration kernel.

Implements the Simrad sonar equation (behavioral contract:
echopype/calibrate/calibrate_ek.py:79-206)::

    Sv = P + 20 log10(r_tvg) + 2 a r_tvg - CSv - 2 sa_corr
    TS = P + 40 log10(r_tvg) + 2 a r_tvg - CSp

with r_tvg the TVG-corrected range (range.py:160-201) and
CSv = 10log10(Pt) + 2G + psi + 10log10(lambda^2 tau c / (32 pi^2)).

Design: the per-(channel,ping) scalar algebra (CSv, TVG shift,
absorption) is folded on the host in float64 into three small [C,P] arrays;
the device kernel is ONE fused elementwise pass over the [C,P,R] power block
that reconstructs range from iota (never materializing a range cube in HBM),
so the op reads power once and writes Sv and echo_range once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ek_power_cal", "ek_power_cal_jit"]


@partial(jax.jit, static_argnames=("spreading_factor",))
def ek_power_cal_jit(power, dr, tvg_shift, absorption, offset, spreading_factor: int = 20):
    """Fused Sv/TS calibration over a padded [C, P, R] power block.

    Parameters
    ----------
    power : f32 [C, P, R]
        Raw power in dB (NaN-padded).
    dr : f32 [C, P]
        Per-sample range step = sample_interval * sound_speed / 2 [m].
    tvg_shift : f32 [C, P]
        TVG range correction subtracted from range [m].
    absorption : f32 [C, P]
        Absorption coefficient [dB/m].
    offset : f32 [C, P]
        Precomputed -(CSv + 2*sa_corr) (Sv) or -CSp (TS), in dB.
    spreading_factor : {20, 40}
        20 for Sv (one-way spreading^2), 40 for TS.

    Returns
    -------
    out : f32 [C, P, R]  calibrated Sv or TS (NaN where power NaN or r_tvg <= 0)
    echo_range : f32 [C, P, R]  range in meters (NaN where power NaN)
    """
    C, P, R = power.shape
    rs = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    r = rs * dr[:, :, None]
    r_tvg = r - tvg_shift[:, :, None]
    pos = r_tvg > 0
    safe_r = jnp.where(pos, r_tvg, 1.0)
    spreading = spreading_factor * jnp.log10(safe_r)
    out = power + spreading + 2.0 * absorption[:, :, None] * r_tvg + offset[:, :, None]
    out = jnp.where(pos, out, jnp.nan)
    echo_range = jnp.where(jnp.isnan(power), jnp.nan, r)
    return out, echo_range


def ek_power_cal(
    power, dr, tvg_shift, absorption, offset, cal_type: str = "Sv", precision: str = "float32"
):
    """Host wrapper: numpy in/out.

    precision="float32" runs the fused device kernel; "float64" (the chunked
    compute_Sv default) evaluates the identical expression in host float64 —
    parity with the reference's f64-on-CPU numbers to <=1e-10 dB.
    """
    spreading = 20 if cal_type == "Sv" else 40
    if precision == "float64":
        power = np.asarray(power, dtype="f8")
        dr = np.asarray(dr, dtype="f8")[:, :, None]
        tvg_shift = np.asarray(tvg_shift, dtype="f8")[:, :, None]
        absorption = np.asarray(absorption, dtype="f8")[:, :, None]
        offset = np.asarray(offset, dtype="f8")[:, :, None]
        r = np.arange(power.shape[2], dtype="f8")[None, None, :] * dr
        r_tvg = r - tvg_shift
        with np.errstate(invalid="ignore", divide="ignore"):
            r_tvg = np.where(r_tvg > 0, r_tvg, np.nan)
            out = power + spreading * np.log10(r_tvg) + 2.0 * absorption * r_tvg + offset
        echo_range = np.where(np.isnan(power), np.nan, r)
        return out, echo_range
    out, echo_range = ek_power_cal_jit(
        jnp.asarray(power, dtype=jnp.float32),
        jnp.asarray(np.asarray(dr, dtype="f4")),
        jnp.asarray(np.asarray(tvg_shift, dtype="f4")),
        jnp.asarray(np.asarray(absorption, dtype="f4")),
        jnp.asarray(np.asarray(offset, dtype="f4")),
        spreading_factor=spreading,
    )
    return np.asarray(out), np.asarray(echo_range)
