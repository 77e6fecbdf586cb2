"""Fused EK80 complex-channel survey kernel: pulse compression -> prx -> Sv
-> window binning in ONE device program.

The unfused chunk path (compute_Sv per chunk) round-trips the full-resolution
pulse-compression output to the host as float64 pairs and ships the computed
Sv back to the device for binning — three [P, R(, B)]-sized transfers per
chunk plus single-core host math.  Here the complex samples go up once as
split f32 and only the [window, n_r] bin partials come back.

Physics contract: calibrate/ek80.py _cal_complex_samples (reference
calibrate_ek.py:456-659) — Karatsuba matched filter (ops/matched_filter),
prx from the beam-sector mean with impedance scaling, Sv from the TVG'd
affine range.  Sample validity is the contiguous [0, valid_len) run.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .binning import binned_window_partials

__all__ = ["bb_chunk_window_partials", "bb_chunk_sv"]


def _bb_chunk_sv_impl(
    bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
    valid_len, do_pc, precision, block_t=0,
):
    """Shared complex->Sv body: pulse compression, prx, TVG'd Sv; returns
    (sv, er) f32 [P, R]."""
    P, R, B = bs_r.shape
    xr = jnp.where(jnp.isnan(bs_r), 0.0, bs_r)
    xi = jnp.where(jnp.isnan(bs_i), 0.0, bs_i)

    if do_pc:
        from .matched_filter import _toeplitz_conv_real

        lanes_r = jnp.moveaxis(xr, 2, 1).reshape(P * B, R)
        lanes_i = jnp.moveaxis(xi, 2, 1).reshape(P * B, R)
        L = hr.shape[0]
        re, im = _toeplitz_conv_real(lanes_r, lanes_i, hr, hi, L - 1, R,
                                precision=precision, block_t=block_t)
        xr = jnp.moveaxis(re.reshape(P, B, R), 1, 2) * inv_norm
        xi = jnp.moveaxis(im.reshape(P, B, R), 1, 2) * inv_norm

    mean_r = jnp.mean(xr, axis=2)  # beam-sector mean [P, R]
    mean_i = jnp.mean(xi, axis=2)
    prx = (mean_r * mean_r + mean_i * mean_i) * z_coef[:, None]

    k = jax.lax.broadcasted_iota(jnp.float32, (1, R), 1)
    r = k * dr[:, None]
    r_tvg = r - shift[:, None]
    in_run = k < valid_len[:, None].astype(jnp.float32)
    past_tvg = k >= k0[:, None].astype(jnp.float32)
    good = past_tvg & (prx > 0) & in_run
    r_tvg_safe = jnp.maximum(r_tvg, jnp.float32(1e-20))
    sv = jnp.where(
        good,
        10.0 * jnp.log10(jnp.where(prx > 0, prx, 1.0))
        + 20.0 * jnp.log10(r_tvg_safe)
        + 2.0 * alpha[:, None] * r_tvg
        + offset[:, None],
        jnp.nan,
    )
    er = jnp.where(in_run, r, jnp.nan)  # NaN range -> sample lands in no bin
    return sv, er


@partial(jax.jit, static_argnames=("do_pc", "precision"))
def bb_chunk_sv(
    bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
    valid_len, do_pc: bool, precision=None,
):
    """One channel chunk complex->Sv on device WITHOUT binning — for fused
    cross-channel masking (frequency differencing needs every channel's Sv
    at the same samples before bins form; reference mask/api.py:467-675)."""
    return _bb_chunk_sv_impl(
        bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
        valid_len, do_pc, precision,
    )


@partial(jax.jit, static_argnames=("n_x_window", "do_pc", "precision", "uniform_er",
                                   "block_t"))
def bb_chunk_window_partials(
    bs_r, bs_i,          # f4 [P, R, B] one channel's chunk (suffix NaN-padded)
    hr, hi,              # f4 [L] flipped-conjugated transmit replica
    inv_norm,            # f4 scalar: 1 / replica norm factor (BB only)
    z_coef,              # f4 [P]: n_beam/8 * (|z_er+z_et|/z_er)^2 / z_et
    dr, shift, alpha, offset,  # f4 [P] per-ping scalars of the Sv equation
    k0,                  # i4 [P]: first sample with r_tvg > 0, decided in
                         # float64 on host so the boundary sample matches the
                         # float64 chunked path exactly
    valid_len,           # i4 [P]
    x_rel,               # i4 [P] window-relative ping-bin ids (sorted)
    r_edges,             # f4 [n_r+1]
    n_x_window: int,
    do_pc: bool,
    precision=None,
    uniform_er: bool = False,  # ping-invariant dr: cancellation-free binning
    block_t: int = 0,          # matched-filter Toeplitz block override
):
    """Returns (sums, counts) f32 [n_x_window, n_r] for one channel chunk."""
    sv, er = _bb_chunk_sv_impl(
        bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
        valid_len, do_pc, precision, block_t=block_t,
    )
    sums, counts, _ = binned_window_partials(
        sv[None], er[None], r_edges, x_rel, n_x_window, uniform_er=uniform_er
    )
    return sums[0], counts[0]
