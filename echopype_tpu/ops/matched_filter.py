"""Matched filter (pulse compression) for EK80 broadband data.

Behavioral contract: echopype/calibrate/ek80_complex.py:285-369 — per-channel
time-domain ``signal.convolve(bs, flip(conj(replica)), mode="full")`` truncated
at ``[replica.size-1:]``, with NaNs zero-filled before and restored after.

The correlation runs as a blocked-Toeplitz MATMUL over split real/imag f32
lanes at Precision.HIGHEST, which holds the f64 matched filter more closely
than a complex64 FFT product (no eps*spectrum leakage into faint outputs).
One dispatch per channel (replica lengths differ per channel); ping x beam
lanes batch in one matmul.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pulse_compress_channel", "compress_pulse_batched", "set_conv_precision"]

# Precision of the matched-filter matmul.  HIGHEST (the default) holds
# <=1e-4 dB of the f64 matched filter; a lower setting lets the device use
# reduced-precision multiplies (TF32 on NVIDIA GPUs), and DEFAULT may be far
# outside the Sv error budget.
_CONV_PRECISION = jax.lax.Precision.HIGHEST


def set_conv_precision(precision) -> None:
    """Set the matched-filter conv precision ("HIGHEST" or "HIGH").

    HIGH trades accuracy for speed: the multiplies may run in a reduced
    precision (TF32 on NVIDIA GPUs).
    """
    global _CONV_PRECISION
    if isinstance(precision, str):
        precision = getattr(jax.lax.Precision, precision.upper())
    _CONV_PRECISION = precision


@partial(jax.jit, static_argnames=("out_start", "out_len", "precision", "block_t"))
def _toeplitz_conv_real(xr, xi, hr, hi, out_start: int, out_len: int, precision=None,
                   block_t: int = 0):
    """Linear complex convolution as one real matmul over split real/imag
    f32 inputs and outputs.

    Design: blocked Toeplitz MATMUL, not lax.conv.  Outputs are tiled into
    blocks of T samples; each block is an [lanes*nblk, T+L-1] slab of the
    (zero-extended) input times a banded [T+L-1, T] Toeplitz matrix of the
    flipped replica.  The overlap halo is built with reshape+shifted-concat
    (no gather), and the complex product is ONE real matmul against the
    block matrix [[Hr, Hi], [-Hi, Hr]] over concatenated [xr, xi] lanes —
    exact 4-mult MACs (no Karatsuba cancellation), re/im produced directly
    with no combine step.  The blocking computes (T+L-1)/L times the MACs of
    a direct convolution, and only the requested output window (the
    reference's [L-1:] truncation; behavioral contract
    echopype/calibrate/ek80_complex.py:285-369).  block_t overrides the
    block size T (default ~L/2, a multiple of 128).
    """
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    L = int(hr.shape[0])
    W = xr.shape[-1]
    lanes = xr.shape[0]
    hr_f, hi_f = hr[::-1], hi[::-1]
    # T ~ L/2, rounded to a multiple of 128, floor 128
    T = block_t or (max(128, 128 * int(round(L / 256.0))) if L > 192 else 128)
    K = T + L - 1
    nblk = -(-out_len // T)
    n_shift = -(-K // T)
    # correlation form: y[n] = sum_k x[n + k - pad_left] * h_flip[k]
    pad_left = L - 1 - out_start
    if pad_left < 0:  # window starts past the head: drop unused input instead
        xr, xi = xr[:, -pad_left:], xi[:, -pad_left:]
        W = W + pad_left
        pad_left = 0
    total = nblk * T + L - 1

    def expand(x):
        xp = jnp.pad(x, ((0, 0), (pad_left, max(0, total - pad_left - W))))[:, :total]
        xp2 = jnp.pad(xp, ((0, 0), (0, (nblk + n_shift) * T - total)))
        xb = xp2.reshape(lanes, nblk + n_shift, T)
        parts = [xb[:, s : s + nblk, :] for s in range(n_shift)]
        return jnp.concatenate(parts, axis=-1)[:, :, :K]

    def toep(hf):
        tp = jnp.arange(K)[:, None] - jnp.arange(T)[None, :]
        return jnp.where((tp >= 0) & (tp < L), hf[jnp.clip(tp, 0, L - 1)], 0.0)

    # ONE real matmul [lanes*nblk, 2K] x [2K, 2T]: the block matrix
    # [[Hr, Hi], [-Hi, Hr]] yields re = xr*hr - xi*hi and im = xr*hi + xi*hr
    # directly — same MACs as a shared-X 4-mult einsum but half the
    # intermediate output writes and no combine step
    X = jnp.concatenate([expand(xr), expand(xi)], axis=-1)  # [lanes, nblk, 2K]
    Hr, Hi = toep(hr_f), toep(hi_f)
    Hc = jnp.concatenate(
        [jnp.concatenate([Hr, Hi], axis=-1), jnp.concatenate([-Hi, Hr], axis=-1)],
        axis=0,
    )  # [2K, 2T]
    Y = jnp.einsum("lbk,kt->lbt", X, Hc, precision=precision)
    re = Y[:, :, :T].reshape(lanes, nblk * T)[:, :out_len]
    im = Y[:, :, T:].reshape(lanes, nblk * T)[:, :out_len]
    return re, im


def _host_conv_f64(lanes: np.ndarray, rep: np.ndarray) -> np.ndarray:
    """Exact float64 direct convolution, truncated to [L-1 : L-1+R].

    Vectorized sliding-window dot product: y[n] = sum_j x[n+j] * rep[::-1][j]
    with x zero-extended on the right.  Matches scipy.signal.convolve's
    direct method bit-for-bit in structure — in particular, samples whose
    only contributions multiply exact-zero replica coefficients (the Hann
    taper's zero endpoint, ek80_complex.py:12-52) come out exactly 0, which
    the reference's prx>0 masking turns into NaN (calibrate_ek.py:581).
    """
    L = len(rep)
    R = lanes.shape[-1]
    rep_rev = rep[::-1].astype("complex128")
    out = np.empty((lanes.shape[0], R), dtype="complex128")
    pad = np.zeros((lanes.shape[0], L - 1), dtype="complex128") if L > 1 else None
    x = np.concatenate([lanes.astype("complex128"), pad], axis=-1) if L > 1 else lanes.astype(
        "complex128"
    )
    win = np.lib.stride_tricks.sliding_window_view(x, L, axis=-1)  # [lanes, R, L]
    # block over lanes to bound the matmul workspace
    step = max(1, int(2**24 // max(1, R * L)))
    for i in range(0, lanes.shape[0], step):
        out[i : i + step] = win[i : i + step] @ rep_rev
    return out


def pulse_compress_channel(
    bs: np.ndarray, replica: np.ndarray, precision: str = "float64"
) -> np.ndarray:
    """Pulse-compress one channel's complex samples.

    bs: complex [ping, range, beam] (NaN-padded); replica: complex [L]
    (the raw transmit replica — conjugate-flip happens here).
    Returns complex [ping, range, beam] matching the reference truncation.

    precision="float64" (the compute_Sv exact-parity opt-in) runs the host
    path; "float32" (the compute_Sv default) uses the device Toeplitz
    kernel (error budget in docs/PERFORMANCE.md).
    """
    rep = np.flipud(np.conj(np.asarray(replica)))
    L = len(rep)
    P, R, B = bs.shape
    nan_mask = np.isnan(bs.real) | np.isnan(bs.imag)
    clean = np.where(nan_mask, 0.0 + 0.0j, bs)
    # Structural zeros: the last z outputs touch only the replica's exact-zero
    # leading taps (Hann taper endpoint) — direct f64 convolution yields exact
    # 0 there (-> prx>0 masks them NaN downstream, calibrate_ek.py:581), but
    # FFT/matmul rounding would leave ~1e-24 residues that inflate bin counts.
    # Zero them explicitly so every precision path shares the contract.
    z = 0
    rep_orig = np.asarray(replica)
    while z < L and rep_orig[z] == 0:
        z += 1
    # batch (ping, beam) lanes; convolve along range
    lanes = clean.transpose(0, 2, 1).reshape(P * B, R)
    if precision == "float64":
        out = _host_conv_f64(lanes, rep)
    else:
        # the split-real blocked-Toeplitz matmul: at Precision.HIGHEST it
        # holds <=1e-4 dB of the f64 matched filter on cancellation-prone
        # tail samples, where a complex64 FFT product carries
        # ~eps*spectrum-magnitude absolute error into faint outputs
        # (2.9e-3 dB max on the CPU error-budget workload)
        re, im = _toeplitz_conv_real(
            jnp.asarray(np.ascontiguousarray(lanes.real, dtype="f4")),
            jnp.asarray(np.ascontiguousarray(lanes.imag, dtype="f4")),
            jnp.asarray(np.ascontiguousarray(rep.real, dtype="f4")),
            jnp.asarray(np.ascontiguousarray(rep.imag, dtype="f4")),
            L - 1,
            R,
            precision=_CONV_PRECISION,
        )
        out = np.asarray(re).astype("f8") + 1j * np.asarray(im).astype("f8")
    out = np.asarray(out)
    if z and precision != "float64" and R >= z:
        if not out.flags.writeable:  # jax arrays map in read-only
            out = out.copy()
        out[..., R - z :] = 0.0
    out = out.reshape(P, B, R).transpose(0, 2, 1)
    return np.where(nan_mask, np.nan + 1j * np.nan, out)


def compress_pulse_batched(bs_by_channel, replicas):
    """Pulse-compress a dict/list of per-channel [P,R,B] arrays."""
    return {ch: pulse_compress_channel(bs_by_channel[ch], replicas[ch]) for ch in bs_by_channel}
