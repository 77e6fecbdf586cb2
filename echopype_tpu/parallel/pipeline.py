"""Sharded survey pipeline: calibration + binned echo-integration over a mesh.

This is the multi-chip "training step" of the domain (SURVEY.md §2.6): the
[C, P, R] power block shards over a (ping, channel) mesh; calibration is
embarrassingly parallel; MVBS bin aggregation produces per-shard partial
sums+counts and a single ``psum`` over the mesh — the one collective this
workload needs (the reference gets the same structure from flox map-reduce +
dask, commongrid/utils.py:614-627).

Scatter-free: both grouping axes are monotone, so bins are contiguous runs
reduced by banded matmuls (see ops/binning.py — the production window
kernels; the cumsum+boundary-gather variants are kept for reference).
Inside the fused kernel echo_range is r*dr, so range-bin boundaries are
CLOSED FORM (ceil(edge/dr)) — no search at all.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

__all__ = ["sv_mvbs_core", "sharded_sv_mvbs_step", "sharded_mvbs_step_closed", "survey_pipeline_step"]

# Data x 0/1-membership dot precision: shared policy, defined once in
# ops/binning.py (see the note there).
from ..ops.binning import _DOT_PRECISION  # noqa: E402


def _prefix_gather_diff(values, bounds, axis):
    cs = jnp.cumsum(values, axis=axis)
    pad = [(0, 0)] * values.ndim
    pad[axis] = (1, 0)
    cs = jnp.pad(cs, pad)
    g = jnp.take_along_axis(cs, bounds, axis=axis)
    return jnp.diff(g, axis=axis)


def sv_mvbs_core(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r):
    """Single-shard fused pipeline: power -> Sv -> linear bin partials.

    x_idx: sorted int32 [P] ping-bin index per local ping (-1 = outside).
    r_edges: f32 [n_r + 1] range-bin edges (left-closed).
    Returns (Sv [C,P,R], partial sums [C,n_x,n_r], partial counts).
    """
    C, Pn, R = power.shape
    rs = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    r = rs * dr[:, :, None]
    r_tvg = r - tvg_shift[:, :, None]
    pos = r_tvg > 0
    sv = jnp.where(
        pos,
        power
        + 20.0 * jnp.log10(jnp.where(pos, r_tvg, 1.0))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None],
        jnp.nan,
    )

    # linear-domain sums over contiguous range bins: closed-form boundaries
    # {r : r*dr < edge} has ceil(edge/dr) elements (left-closed bins)
    bounds_f = jnp.ceil(r_edges[None, None, :] / dr[:, :, None])
    rb = jnp.clip(bounds_f, 0, R).astype(jnp.int32)  # [C, P, n_r+1]

    ok = ~jnp.isnan(sv)
    lin = jnp.where(ok, jnp.power(10.0, sv / 10.0), 0.0)
    s1 = _prefix_gather_diff(lin, rb, axis=2)  # [C, P, n_r]
    n1 = _prefix_gather_diff(ok.astype(jnp.float32), rb, axis=2)

    # ping-bin boundaries from the sorted local x_idx (binary search, tiny)
    xb = jnp.searchsorted(x_idx, jnp.arange(n_x + 1, dtype=x_idx.dtype), side="left")
    xb = jnp.broadcast_to(xb.astype(jnp.int32)[None, :, None], (C, n_x + 1, n_r))
    sums = _prefix_gather_diff(s1, xb, axis=1)  # [C, n_x, n_r]
    counts = _prefix_gather_diff(n1, xb, axis=1)
    return sv, sums, counts


def sv_mvbs_core_mxu(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r):
    """Matmul variant of the fused pipeline for per-channel-constant dr.

    The range-bin reduction is a batched matmul with a per-channel banded 0/1
    matrix: sums[c,p,b] = lin[c,p,:] @ M[c,:,b].  That removes the [C,P,R]
    cumsum intermediate, leaving the reads of power and the write of Sv.
    dr is taken from ping 0 of each channel.
    """
    C, Pn, R = power.shape
    rs = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    r = rs * dr[:, :, None]
    r_tvg = r - tvg_shift[:, :, None]
    pos = r_tvg > 0
    sv = jnp.where(
        pos,
        power
        + 20.0 * jnp.log10(jnp.where(pos, r_tvg, 1.0))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None],
        jnp.nan,
    )

    # banded range-bin matrix per channel from closed-form boundaries
    dr0 = dr[:, 0]  # [C]
    bounds = jnp.clip(jnp.ceil(r_edges[None, :] / dr0[:, None]), 0, R)  # [C, n_r+1]
    r_ids = jax.lax.broadcasted_iota(jnp.float32, (1, R, 1), 1)
    M = (
        (r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])
    ).astype(jnp.float32)  # [C, R, n_r]

    ok = ~jnp.isnan(sv)
    lin = jnp.where(ok, jnp.power(10.0, sv / 10.0), 0.0)
    dn = (((2,), (1,)), ((0,), (0,)))  # contract R, batch C
    s1 = jax.lax.dot_general(lin, M, dn, preferred_element_type=jnp.float32,
                             precision=_DOT_PRECISION)
    n1 = jax.lax.dot_general(ok.astype(jnp.float32), M, dn,
                             preferred_element_type=jnp.float32)

    xb = jnp.searchsorted(x_idx, jnp.arange(n_x + 1, dtype=x_idx.dtype), side="left")
    xb = jnp.broadcast_to(xb.astype(jnp.int32)[None, :, None], (C, n_x + 1, n_r))
    sums = _prefix_gather_diff(s1, xb, axis=1)
    counts = _prefix_gather_diff(n1, xb, axis=1)
    return sv, sums, counts


def sv_mvbs_core_ex60(power, dr, absorption, offset, x_idx, r_edges, n_x, n_r,
                      shift_samples: int = 2):
    """Fastest path for Ex60-style hardware: integer-sample TVG shift.

    With r_tvg = (k - n) * dr the spreading term factors as
    20log10(k - n) [precomputed R row] + 20log10(dr) [C,P scalars], so Sv
    needs NO per-element transcendental and the linear domain needs exactly
    one exp per element — about half the transcendental work of the general
    core.
    """
    C, Pn, R = power.shape
    k = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    k_shift = k - jnp.float32(shift_samples)
    valid_k = k_shift > 0
    spread_row = 20.0 * jnp.log10(jnp.where(valid_k, k_shift, 1.0))  # [1,1,R]
    spread_cp = 20.0 * jnp.log10(dr)  # [C,P]
    sv = jnp.where(
        valid_k,
        power
        + spread_row
        + (spread_cp + offset)[:, :, None]
        + (2.0 * absorption * dr)[:, :, None] * k_shift,
        jnp.nan,
    )

    dr0 = dr[:, 0]
    bounds = jnp.clip(jnp.ceil(r_edges[None, :] / dr0[:, None]), 0, R)
    r_ids = jax.lax.broadcasted_iota(jnp.float32, (1, R, 1), 1)
    M = ((r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])).astype(jnp.float32)

    ok = ~jnp.isnan(sv)
    # 10^(x/10) = exp(x * ln(10)/10): the single transcendental per element
    lin = jnp.where(ok, jnp.exp(sv * jnp.float32(0.23025850929940458)), 0.0)
    dn = (((2,), (1,)), ((0,), (0,)))
    s1 = jax.lax.dot_general(lin, M, dn, preferred_element_type=jnp.float32,
                             precision=_DOT_PRECISION)
    n1 = jax.lax.dot_general(ok.astype(jnp.float32), M, dn,
                             preferred_element_type=jnp.float32)

    xb = jnp.searchsorted(x_idx, jnp.arange(n_x + 1, dtype=x_idx.dtype), side="left")
    xb = jnp.broadcast_to(xb.astype(jnp.int32)[None, :, None], (C, n_x + 1, n_r))
    sums = _prefix_gather_diff(s1, xb, axis=1)
    counts = _prefix_gather_diff(n1, xb, axis=1)
    return sv, sums, counts


def _refine_bounds(bounds, dr0, edges):
    """Correct division-derived bin bounds against the actual f32 sample grid.

    bounds[b] must be the smallest q with q*dr >= edge (left-closed bins on
    r = k*dr).  XLA may lower x/y as x*reciprocal(y), which can be off by
    one ULP at exactly-integral edge/dr ratios — enough to shift a bin
    boundary by one sample and disagree with the sums' own k*dr grid.  Two
    exact multiplications pin the boundary to the grid.
    """
    q = bounds
    # if (q-1)*dr still reaches the edge, the division overshot
    q = jnp.where((q - 1.0) * dr0[:, None] >= edges, q - 1.0, q)
    # if q*dr does not reach the edge, it undershot
    q = jnp.where(q * dr0[:, None] < edges, q + 1.0, q)
    return q


def _refine_k0(k0, dr, shift):
    """Pin k0 (smallest k with k*dr > shift) to the f32 sample grid — same
    division knife-edge as _refine_bounds, strict inequality."""
    k0 = jnp.where((k0 - 1.0) * dr > shift, k0 - 1.0, k0)
    k0 = jnp.where(k0 * dr <= shift, k0 + 1.0, k0)
    return jnp.maximum(k0, 0.0)


def _closed_s1_n1(power, dr, tvg_shift, absorption, offset, valid_len, r_edges, n_r, r0):
    """Shared closed-counts body: per-ping range-binned sums + exact counts.

    Returns (s1, n1) each [C, P, n_r]: linear-Sv sums via one banded
    matmul with closed-form bin bounds, counts via clipped bound differences.

    ``power`` may be float dB (NaN-padded) or RAW int16 indices — integer
    input is scaled by INDEX2POWER in-kernel and masked by ``valid_len``,
    halving host->device transfer bytes with bit-identical results.
    """
    C, Pn, R = power.shape
    rs = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    int_power = jnp.issubdtype(power.dtype, jnp.integer)
    if int_power:
        index2power = jnp.float32(10.0 * jnp.log10(jnp.float32(2.0)) / 256.0)
        power = power.astype(jnp.float32) * index2power
    if r0 is None:
        # EK case: fold the absent intercept at trace time (no extra add)
        r_tvg = rs * dr[:, :, None] - tvg_shift[:, :, None]
    else:
        r_tvg = rs * dr[:, :, None] + (r0 - tvg_shift)[:, :, None]
    pos = r_tvg > 0
    sv = jnp.where(
        pos,
        power
        + 20.0 * jnp.log10(jnp.where(pos, r_tvg, 1.0))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None],
        jnp.nan,
    )
    lin = jnp.where(jnp.isnan(sv), 0.0, jnp.power(10.0, sv / 10.0))
    if int_power:
        # integer input has no NaN padding: mask the invalid sample tail
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
        lin = jnp.where(lane < valid_len[:, :, None], lin, 0.0)
    dr0 = dr[:, 0]
    # bin bounds on echo_range: count of k with r0 + k*dr < edge
    edge_off = r_edges[None, :] if r0 is None else r_edges[None, :] - r0[:, 0][:, None]
    bounds = jnp.clip(
        _refine_bounds(jnp.ceil(edge_off / dr0[:, None]), dr0, edge_off), 0, R
    )
    r_ids = jax.lax.broadcasted_iota(jnp.float32, (1, R, 1), 1)
    M = ((r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])).astype(jnp.float32)
    dn = (((2,), (1,)), ((0,), (0,)))
    s1 = jax.lax.dot_general(lin, M, dn, preferred_element_type=jnp.float32,
                             precision=_DOT_PRECISION)

    # first sample with r_tvg > 0: k > (tvg_shift - r0)/dr
    shift_eff = tvg_shift if r0 is None else tvg_shift - r0
    k0 = _refine_k0(jnp.floor(shift_eff / dr) + 1.0, dr, shift_eff)  # [C,P]
    L = valid_len.astype(jnp.float32)
    clipped = jnp.clip(bounds[:, None, :], k0[:, :, None], L[:, :, None])
    n1 = jnp.diff(clipped, axis=2)  # [C,P,n_r] exact per-bin counts
    return s1, n1


def sv_mvbs_core_mxu_closed(
    power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges, n_x, n_r,
    r0=None,
):
    """MVBS-only core with closed-form counts: ONE matmul total.

    echo_range is affine in the sample index, r = r0 + k*dr (r0 defaults to 0,
    the EK case; AZFP has r0 = cL/2f + ... from the lockout index), and the
    TVG range is r - tvg_shift.  Valid samples per ping form a contiguous run
    [k0, valid_len) where k0 is the first sample with r_tvg > 0, so the
    per-bin count is the overlap of that run with each bin's sample bounds —
    no counts matmul and no ok-mask materialization.  Requires NaNs to appear
    only as suffix padding beyond ``valid_len`` (the ragged-ping norm); data
    with interior NaN masking must use sv_mvbs_core_mxu.

    Bit-identical bins to the two-matmul MVBS-only path.  The survey
    streamers use :func:`sv_mvbs_window_partials` instead.

    Precision note: the ping-axis reduction is cumsum+gather+diff in f32, so
    a quiet bin following loud pings inside the same block loses relative
    precision (and counts can saturate past 2^24 samples/block).  Chunked
    streaming should prefer :func:`sv_mvbs_window_partials`, which reduces
    the ping axis with an independent-accumulation matmul per bin.
    """
    C = power.shape[0]
    s1, n1 = _closed_s1_n1(
        power, dr, tvg_shift, absorption, offset, valid_len, r_edges, n_r, r0
    )
    xb = jnp.searchsorted(x_idx, jnp.arange(n_x + 1, dtype=x_idx.dtype), side="left")
    xb = jnp.broadcast_to(xb.astype(jnp.int32)[None, :, None], (C, n_x + 1, n_r))
    return _prefix_gather_diff(s1, xb, axis=1), _prefix_gather_diff(n1, xb, axis=1)


def sv_mvbs_window_partials(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window, n_r, r0=None,
):
    """Closed-counts partials on a local ping-bin window — chunk-invariant.

    Same physics as sv_mvbs_core_mxu_closed but the ping-axis reduction is a
    second banded matmul over the (small) window of bins this chunk spans,
    so each bin accumulates independently.  x_rel carries window-relative bin
    ids (host subtracts the chunk's first bin id).  Returns (sums, counts)
    [C, n_x_window, n_r]; the host adds them at the window offset.
    """
    from ..ops.binning import banded_x_reduce

    s1, n1 = _closed_s1_n1(
        power, dr, tvg_shift, absorption, offset, valid_len, r_edges, n_r, r0
    )
    both = banded_x_reduce(jnp.concatenate([s1, n1], axis=2), x_rel, n_x_window)
    return both[:, :, :n_r], both[:, :, n_r:]


_CMP = {
    ">": jnp.greater,
    "<": jnp.less,
    ">=": jnp.greater_equal,
    "<=": jnp.less_equal,
    "==": jnp.equal,
}


@partial(jax.jit, static_argnames=("n_x_window", "n_r", "ia", "ib", "op"))
def sv_mvbs_window_partials_freqdiff(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, ia: int, ib: int, op: str, diff_db, r0=None,
):
    """Masked-MVBS window partials: frequency differencing fused into the
    Sv pass.

    Per sample the mask is ``Sv[ia] - Sv[ib] <op> diff_db`` (the reference's
    frequency_differencing, mask/api.py:467-675, applied across channels as
    in apply_mask); masked-out samples join no bin.  Sv lives only in
    registers — a masked-MVBS survey never materializes full-resolution Sv.
    Counts are data-dependent, so both sums and counts reduce by the banded
    range matmul (vs the closed-form-count fast path).
    """
    from ..ops.binning import banded_x_reduce

    C, Pn, R = power.shape
    rs = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    if jnp.issubdtype(power.dtype, jnp.integer):
        index2power = jnp.float32(10.0 * jnp.log10(jnp.float32(2.0)) / 256.0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
        power = jnp.where(
            lane < valid_len[:, :, None],
            power.astype(jnp.float32) * index2power,
            jnp.nan,
        )
    if r0 is None:
        r_tvg = rs * dr[:, :, None] - tvg_shift[:, :, None]
    else:
        r_tvg = rs * dr[:, :, None] + (r0 - tvg_shift)[:, :, None]
    pos = r_tvg > 0
    sv = jnp.where(
        pos,
        power
        + 20.0 * jnp.log10(jnp.where(pos, r_tvg, 1.0))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None],
        jnp.nan,
    )
    keep = _CMP[op](sv[ia] - sv[ib], diff_db)  # [P, R]; NaN diff -> False
    ok = (~jnp.isnan(sv)) & keep[None]
    lin = jnp.where(ok, jnp.power(10.0, sv / 10.0), 0.0)

    dr0 = dr[:, 0]
    edge_off = r_edges[None, :] if r0 is None else r_edges[None, :] - r0[:, 0][:, None]
    bounds = jnp.clip(
        _refine_bounds(jnp.ceil(edge_off / dr0[:, None]), dr0, edge_off), 0, R
    )
    r_ids = jax.lax.broadcasted_iota(jnp.float32, (1, R, 1), 1)
    M = ((r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])).astype(
        jnp.float32
    )
    dn = (((2,), (1,)), ((0,), (0,)))
    s1 = jax.lax.dot_general(lin, M, dn, preferred_element_type=jnp.float32,
                             precision=_DOT_PRECISION)
    n1 = jax.lax.dot_general(
        ok.astype(jnp.float32), M, dn, preferred_element_type=jnp.float32
    )
    both = banded_x_reduce(jnp.concatenate([s1, n1], axis=2), x_rel, n_x_window)
    return both[:, :, :n_r], both[:, :, n_r:]


def sharded_mvbs_partials_freqdiff(mesh: Mesh, window: int, n_r: int, ia, ib, op):
    """Multi-chip masked-MVBS partials: ping-sharded (channels whole per
    device — the mask reads two channels pointwise)."""
    if mesh.shape.get("channel", 1) != 1:
        raise ValueError(
            "freq_diff-masked survey streaming needs channel mesh axis 1 "
            "(the mask compares two channels per sample)"
        )

    def step(power, dr, shift, alpha, offset, valid_len, x_rel, r_edges, r0, diff_db):
        s, c = sv_mvbs_window_partials_freqdiff(
            power, dr, shift, alpha, offset, valid_len, x_rel, r_edges,
            window, n_r, ia, ib, op, diff_db, r0=r0,
        )
        return jax.lax.psum(s, axis_name="ping"), jax.lax.psum(c, axis_name="ping")

    spec_cpr = P(None, "ping", None)
    spec_cp = P(None, "ping")
    out = P(None, None, None)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            spec_cpr, spec_cp, spec_cp, spec_cp, spec_cp, spec_cp,
            P("ping"), P(None), spec_cp, P(),
        ),
        out_specs=(out, out),
    )
    return jax.jit(mapped)


def sharded_sv_mvbs_step(
    mesh: Mesh, n_x: int, n_r: int, uniform_dr: bool = True, with_sv: bool = True
):
    """Build the jitted multi-chip step for the given mesh and bin counts.

    Returns fn(power, dr, tvg_shift, absorption, offset, x_idx, r_edges)
    -> (Sv sharded [C,P,R], MVBS [C,n_x,n_r] channel-sharded),
    or MVBS alone when with_sv=False.

    uniform_dr=True selects the banded-matmul binning path; it requires each channel's sample interval to be ping-invariant
    (the instrument norm).  Pass False for ping-varying sample intervals.

    with_sv=False skips materializing the full-resolution Sv array, which
    saves the step's largest device-memory write.
    """
    core = sv_mvbs_core_mxu if uniform_dr else sv_mvbs_core

    def step(power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        sv, sums, counts = core(
            power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r
        )
        # the one collective: global bin sums over the ping axis;
        # channels stay sharded (each chip owns its channel block's bins)
        sums = jax.lax.psum(sums, axis_name="ping")
        counts = jax.lax.psum(counts, axis_name="ping")
        mean = sums / jnp.where(counts > 0, counts, 1.0)
        mvbs = jnp.where(counts > 0, 10.0 * jnp.log10(mean), jnp.nan)
        if not with_sv:
            return mvbs  # sv becomes dead code; XLA drops the HBM write
        return sv, mvbs

    spec_cpr = P("channel", "ping", None)
    spec_cp = P("channel", "ping")
    spec_p = P("ping")
    mvbs_spec = P("channel", None, None)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_cpr, spec_cp, spec_cp, spec_cp, spec_cp, spec_p, P(None)),
        out_specs=(spec_cpr, mvbs_spec) if with_sv else mvbs_spec,
    )
    return jax.jit(mapped)


def sharded_sv_mvbs_step_3d(mesh: Mesh, n_x: int, n_r: int):
    """Fully sharded step over a (ping, channel, range) mesh.

    Range sharding (the sequence-parallel analog): each chip holds a
    contiguous range segment; the global sample index is reconstructed from
    the range-axis position, the per-segment bin partials are computed with
    the local slice of the banded bin matrix, and bin sums combine with a
    psum over BOTH the ping and range axes.
    """

    def step(power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        C, Pn, R_local = power.shape
        r_pos = jax.lax.axis_index("range")
        r0_global = r_pos * R_local

        rs = (
            jax.lax.broadcasted_iota(jnp.float32, (1, 1, R_local), 2)
            + r0_global.astype(jnp.float32)
        )
        r = rs * dr[:, :, None]
        r_tvg = r - tvg_shift[:, :, None]
        pos = r_tvg > 0
        sv = jnp.where(
            pos,
            power
            + 20.0 * jnp.log10(jnp.where(pos, r_tvg, 1.0))
            + 2.0 * absorption[:, :, None] * r_tvg
            + offset[:, :, None],
            jnp.nan,
        )

        dr0 = dr[:, 0]
        R_total = R_local * jax.lax.axis_size("range")
        bounds = jnp.clip(jnp.ceil(r_edges[None, :] / dr0[:, None]), 0, R_total)
        r_ids = (
            jax.lax.broadcasted_iota(jnp.float32, (1, R_local, 1), 1)
            + r0_global.astype(jnp.float32)
        )
        M = ((r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])).astype(
            jnp.float32
        )

        ok = ~jnp.isnan(sv)
        lin = jnp.where(ok, jnp.power(10.0, sv / 10.0), 0.0)
        dn = (((2,), (1,)), ((0,), (0,)))
        s1 = jax.lax.dot_general(lin, M, dn, preferred_element_type=jnp.float32,
                             precision=_DOT_PRECISION)
        n1 = jax.lax.dot_general(ok.astype(jnp.float32), M, dn,
                             preferred_element_type=jnp.float32)

        xb = jnp.searchsorted(x_idx, jnp.arange(n_x + 1, dtype=x_idx.dtype), side="left")
        xb = jnp.broadcast_to(xb.astype(jnp.int32)[None, :, None], (C, n_x + 1, n_r))
        sums = _prefix_gather_diff(s1, xb, axis=1)
        counts = _prefix_gather_diff(n1, xb, axis=1)

        sums = jax.lax.psum(jax.lax.psum(sums, "ping"), "range")
        counts = jax.lax.psum(jax.lax.psum(counts, "ping"), "range")
        mean = sums / jnp.where(counts > 0, counts, 1.0)
        mvbs = jnp.where(counts > 0, 10.0 * jnp.log10(mean), jnp.nan)
        return sv, mvbs

    spec_cpr = P("channel", "ping", "range")
    spec_cp = P("channel", "ping")
    spec_p = P("ping")
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_cpr, spec_cp, spec_cp, spec_cp, spec_cp, spec_p, P(None)),
        out_specs=(spec_cpr, P("channel", None, None)),
    )
    return jax.jit(mapped)


def sharded_mvbs_step_closed(mesh: Mesh, n_x: int, n_r: int):
    """Multi-chip MVBS-only step on the closed-form-counts core.

    fn(power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges)
    -> MVBS [C, n_x, n_r] channel-sharded.  Fastest survey path: one matmul
    per shard, partial bin sums psum over the ping axis.
    """

    def step(power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges):
        sums, counts = sv_mvbs_core_mxu_closed(
            power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges, n_x, n_r
        )
        sums = jax.lax.psum(sums, axis_name="ping")
        counts = jax.lax.psum(counts, axis_name="ping")
        mean = sums / jnp.where(counts > 0, counts, 1.0)
        return jnp.where(counts > 0, 10.0 * jnp.log10(mean), jnp.nan)

    spec_cpr = P("channel", "ping", None)
    spec_cp = P("channel", "ping")
    spec_p = P("ping")
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_cpr, spec_cp, spec_cp, spec_cp, spec_cp, spec_cp, spec_p, P(None)),
        out_specs=P("channel", None, None),
    )
    return jax.jit(mapped)


def closed_bounds_k0_np(dr0, sh0, r_edges, R):
    """Host f32 replication of the closed-counts bin bounds and k0.

    Bit-identical to the device refinement (_refine_bounds/_refine_k0): the
    refinement corrects the division start point against exact f32
    multiplications, and IEEE f32 multiply/compare agree between numpy and
    the device, so the resulting integer boundaries are the device's own.
    Enables host-side closed-form counts (closed_window_counts_np) so the
    uniform survey streamers read back SUMS only: the counts half of the
    [C, window, n_r] device-to-host readback never leaves the device."""
    dr0 = np.asarray(dr0, dtype="f4")
    sh0 = np.asarray(sh0, dtype="f4")
    edges = np.asarray(r_edges, dtype="f4")[None, :]
    q = np.ceil(edges / dr0[:, None]).astype("f4")
    q = np.where(((q - np.float32(1.0)) * dr0[:, None]) >= edges, q - 1.0, q).astype("f4")
    q = np.where((q * dr0[:, None]) < edges, q + 1.0, q).astype("f4")
    bounds = np.clip(q, np.float32(0.0), np.float32(R))
    k0 = (np.floor(sh0 / dr0) + np.float32(1.0)).astype("f4")
    k0 = np.where(((k0 - np.float32(1.0)) * dr0) > sh0, k0 - 1.0, k0).astype("f4")
    k0 = np.where((k0 * dr0) <= sh0, k0 + 1.0, k0).astype("f4")
    k0 = np.maximum(k0, np.float32(0.0))
    return bounds, k0


def closed_window_counts_np(bounds, k0, valid_len, x_rel, n_x_window):
    """Exact closed-form per-window-bin counts on host: f8 [C, W, n_r].

    Mirrors the device count math (diff of clip(bounds, k0, valid_len)
    reduced over window bins) without materializing [C, P, n_r]: per channel
    a histogram of valid lengths per window bin gives
    S(v) = sum_p min(v, L_p) = v * #{L >= v} + sum_{L < v} L in O(W * R),
    and counts = diff(S at the clamped bounds)."""
    valid_len = np.asarray(valid_len)
    C, P = valid_len.shape
    n_r = bounds.shape[1] - 1
    bl = np.maximum(bounds, k0[:, None])  # [C, n_r+1], integral floats
    ids = np.asarray(x_rel, dtype="i8")
    inb = (ids >= 0) & (ids < n_x_window)
    idc = ids[inb]
    counts = np.zeros((C, n_x_window, n_r), dtype="f8")
    if idc.size == 0:
        return counts
    R = int(valid_len.max(initial=0))
    nv = R + 2
    v_ids = np.arange(nv, dtype="f8")
    nb = None
    for c in range(C):
        Lc_all = valid_len[c, inb]
        u = np.unique(Lc_all)
        if u.size == 1:
            # constant valid length (the instrument norm): counts factor as
            # per-ping bin sizes x pings-per-window-bin — O(n_r + P), no
            # [W, R] histogram at all
            per_ping = np.diff(np.minimum(bl[c], float(u[0])))  # [n_r]
            if nb is None:
                nb = np.bincount(idc, minlength=n_x_window).astype("f8")
            counts[c] = nb[:, None] * per_ping[None, :]
            continue
        Lc = np.clip(Lc_all.astype("i8"), 0, nv - 1)
        H = np.zeros((n_x_window, nv), dtype="f8")
        np.add.at(H, (idc, Lc), 1.0)
        cnt_ge = np.cumsum(H[:, ::-1], axis=1)[:, ::-1]  # #{L >= v}
        sum_lt = np.concatenate(
            [np.zeros((n_x_window, 1)), np.cumsum(H * v_ids, axis=1)[:, :-1]],
            axis=1,
        )  # sum_{L < v} L
        b = np.clip(bl[c].astype("i8"), 0, nv - 1)  # [n_r+1]
        S = b.astype("f8") * cnt_ge[:, b] + sum_lt[:, b]
        counts[c] = np.diff(S, axis=1)
    return counts


def sv_mvbs_window_partials_uniform(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, block_g: int = 0, with_counts: bool = True,
):
    """Window partials fast path for per-channel-uniform dr and tvg_shift.

    With dr and the TVG shift constant over pings (the overwhelmingly common
    instrument configuration), the spreading term 20*log10(k*dr - shift) is
    ONE [C, R] row instead of a per-element log10, halving the
    transcendentals per element.
    Same contract as sv_mvbs_window_partials with r0 = 0; callers must check
    uniformity (the survey runner does).

    block_g > 0 (static; from ops.binning.choose_block_g on the host's f64
    bin bounds) replaces the range-bin matmul with the exact-f32 blocked
    segment sum, ~1/block_g of the dot's multiply-adds at full data
    precision.  The survey runners leave it at 0.
    """
    from ..ops.binning import banded_x_reduce, blocked_banded_segment_sum

    C, Pn, R = power.shape
    dr0, sh0 = dr[:, 0], tvg_shift[:, 0]
    k_row = jax.lax.broadcasted_iota(jnp.float32, (1, R), 1)
    r_tvg_row = k_row * dr0[:, None] - sh0[:, None]  # [C, R]
    sprd_row = 20.0 * jnp.log10(jnp.maximum(r_tvg_row, jnp.float32(1e-20)))
    if jnp.issubdtype(power.dtype, jnp.integer):
        index2power = jnp.float32(10.0 * jnp.log10(jnp.float32(2.0)) / 256.0)
        power = power.astype(jnp.float32) * index2power
    # lin = 10^(Sv/10) with one exp per element (ln10/10 folded)
    lin = jnp.exp(
        (
            power
            + sprd_row[:, None, :]
            + 2.0 * absorption[:, :, None] * r_tvg_row[:, None, :]
            + offset[:, :, None]
        )
        * jnp.float32(0.23025850929940458)
    )
    k0 = _refine_k0(jnp.floor(sh0 / dr0) + 1.0, dr0, sh0)  # [C]
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    lin = jnp.where(
        (lane >= k0[:, None, None]) & (lane < valid_len[:, :, None].astype(jnp.float32)),
        lin,
        0.0,
    )
    edges = r_edges[None, :]
    bounds = jnp.clip(_refine_bounds(jnp.ceil(edges / dr0[:, None]), dr0, edges), 0, R)
    if block_g:
        s1 = blocked_banded_segment_sum(lin, bounds, n_r, block_g)
    else:
        r_ids = jax.lax.broadcasted_iota(jnp.float32, (1, R, 1), 1)
        M = ((r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])).astype(jnp.float32)
        dn = (((2,), (1,)), ((0,), (0,)))
        s1 = jax.lax.dot_general(lin, M, dn, preferred_element_type=jnp.float32,
                                 precision=_DOT_PRECISION)
    if not with_counts:
        # counts resolve closed-form on HOST (closed_window_counts_np from
        # closed_bounds_k0_np's identical bounds/k0): halves both the window
        # matmul and the device-to-host readback
        return banded_x_reduce(s1, x_rel, n_x_window)
    L = valid_len.astype(jnp.float32)
    clipped = jnp.clip(bounds[:, None, :], k0[:, None, None], L[:, :, None])
    n1 = jnp.diff(clipped, axis=2)
    both = banded_x_reduce(jnp.concatenate([s1, n1], axis=2), x_rel, n_x_window)
    return both[:, :, :n_r], both[:, :, n_r:]


def sv_mvbs_window_partials_uniform_t(
    powerT, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int,
):
    """Ping-minor (transposed) twin of the uniform kernel.

    powerT: [C, R, P] — the PING axis on the minor dimension.  In the
    standard layout the range-bin dot has only N = n_r (~50) output columns;
    here the data operand is the dot's wide rhs instead.  Not wired into the
    streamers (the host would have to ship chunks transposed); kept as the
    layout alternative to measure against the standard one, pinned by a
    parity test.

    Same math and contract as sv_mvbs_window_partials_uniform (r0 = 0,
    per-channel-constant dr/shift); returns (sums, counts)
    [C, n_x_window, n_r].
    """
    C, R, Pn = powerT.shape
    dr0, sh0 = dr[:, 0], tvg_shift[:, 0]
    k_col = jax.lax.broadcasted_iota(jnp.float32, (1, R, 1), 1)
    r_tvg_col = k_col * dr0[:, None, None] - sh0[:, None, None]  # [C, R, 1]
    sprd_col = 20.0 * jnp.log10(jnp.maximum(r_tvg_col, jnp.float32(1e-20)))
    if jnp.issubdtype(powerT.dtype, jnp.integer):
        index2power = jnp.float32(10.0 * jnp.log10(jnp.float32(2.0)) / 256.0)
        powerT = powerT.astype(jnp.float32) * index2power
    lin = jnp.exp(
        (
            powerT
            + sprd_col
            + 2.0 * absorption[:, None, :] * r_tvg_col
            + offset[:, None, :]
        )
        * jnp.float32(0.23025850929940458)
    )
    k0 = _refine_k0(jnp.floor(sh0 / dr0) + 1.0, dr0, sh0)  # [C]
    lin = jnp.where(
        (k_col >= k0[:, None, None])
        & (k_col < valid_len[:, None, :].astype(jnp.float32)),
        lin,
        0.0,
    )
    edges = r_edges[None, :]
    bounds = jnp.clip(_refine_bounds(jnp.ceil(edges / dr0[:, None]), dr0, edges), 0, R)
    r_ids = jax.lax.broadcasted_iota(jnp.float32, (1, 1, R), 2)
    Mt = (
        (r_ids >= bounds[:, :-1, None]) & (r_ids < bounds[:, 1:, None])
    ).astype(jnp.float32)  # [C, n_r, R]
    dn = (((2,), (1,)), ((0,), (0,)))
    s1t = jax.lax.dot_general(Mt, lin, dn, preferred_element_type=jnp.float32,
                              precision=_DOT_PRECISION)  # [C, n_r, P]
    L = valid_len.astype(jnp.float32)
    clipped = jnp.clip(bounds[:, :, None], k0[:, None, None], L[:, None, :])
    n1t = jnp.diff(clipped, axis=1)  # [C, n_r, P]
    # ping-window reduction on the transposed layout: one dot over P
    xb = jnp.searchsorted(
        x_rel, jnp.arange(n_x_window + 1, dtype=x_rel.dtype), side="left"
    ).astype(jnp.float32)
    p_ids = jax.lax.broadcasted_iota(jnp.float32, (Pn, 1), 0)
    Mx = ((p_ids >= xb[None, :-1]) & (p_ids < xb[None, 1:])).astype(jnp.float32)
    both = jnp.concatenate([s1t, n1t], axis=1)  # [C, 2*n_r, P]
    out = jax.lax.dot_general(
        both, Mx, (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=_DOT_PRECISION,
    )  # [C, 2*n_r, W]
    out = jnp.moveaxis(out, 2, 1)  # [C, W, 2*n_r]
    return out[:, :, :n_r], out[:, :, n_r:]


def sharded_mvbs_partials_closed(mesh: Mesh, n_x_window: int, n_r: int,
                                 uniform: bool = False):
    """Multi-chip *partials* step for the survey streamer (closed counts).

    fn(power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    r0) -> (sums, counts) [C, n_x_window, n_r], psum'd over the ping axis and
    channel-sharded.  x_rel carries window-relative bin ids (sorted), so each
    ping shard reduces onto the same chunk-local window and the psum makes
    the result identical to the single-device window partials — host
    accumulation at the window offset is then chunking- and mesh-invariant.
    uniform=True selects the hoisted-spreading fast path (per-channel
    constant dr/shift, r0 = 0; the caller checks).
    """

    def step(power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges, r0):
        if uniform:
            sums, counts = sv_mvbs_window_partials_uniform(
                power, dr, tvg_shift, absorption, offset, valid_len, x_rel,
                r_edges, n_x_window, n_r,
            )
        else:
            sums, counts = sv_mvbs_window_partials(
                power, dr, tvg_shift, absorption, offset, valid_len, x_rel,
                r_edges, n_x_window, n_r, r0=r0,
            )
        return (
            jax.lax.psum(sums, axis_name="ping"),
            jax.lax.psum(counts, axis_name="ping"),
        )

    spec_cpr = P("channel", "ping", None)
    spec_cp = P("channel", "ping")
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            spec_cpr, spec_cp, spec_cp, spec_cp, spec_cp, spec_cp, P("ping"),
            P(None), spec_cp,
        ),
        out_specs=(P("channel", None, None), P("channel", None, None)),
    )
    return jax.jit(mapped)


def sharded_binned_partials(
    mesh: Mesh, n_x_window: int, skipna: bool = True, closed: str = "left",
    uniform_er: bool = False,
):
    """Multi-chip partial bin sums over already-calibrated Sv blocks.

    fn(sv_db, er, r_edges, x_rel) -> (sums, counts, nan_counts)
    [C, n_x_window, n_r], psum'd over the ping axis and channel-sharded.
    x_rel carries window-relative ping-bin ids.  Handles interior-NaN Sv
    (masked data), unlike the closed-counts core.  Pass
    uniform_er=er_is_uniform(...) to take the cancellation-free range matmul.
    """
    from ..ops import binning

    def step(sv_db, er, r_edges, x_rel):
        sums, counts, nan_counts = binning.binned_window_partials(
            sv_db, er, r_edges, x_rel, n_x_window, skipna=skipna, closed=closed,
            uniform_er=uniform_er,
        )
        return (
            jax.lax.psum(sums, axis_name="ping"),
            jax.lax.psum(counts, axis_name="ping"),
            jax.lax.psum(nan_counts, axis_name="ping"),
        )

    spec_cpr = P("channel", "ping", None)
    out = P("channel", None, None)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_cpr, spec_cpr, P(None), P("ping")),
        out_specs=(out, out, out),
    )
    return jax.jit(mapped)


def sharded_binned_sum_raw(
    mesh: Mesh, n_x_window: int, closed: str = "left", uniform_er: bool = False
):
    """Multi-chip NaN-skipping raw window sums (NASC height numerator).

    fn(values, er, r_edges, x_rel) -> [C, n_x_window, n_r], psum'd over the
    ping axis; same layout contract as sharded_binned_partials.
    """
    from ..ops import binning

    def step(values, er, r_edges, x_rel):
        s = binning.binned_window_sum_raw(
            values, er, r_edges, x_rel, n_x_window, closed=closed,
            uniform_er=uniform_er,
        )
        return jax.lax.psum(s, axis_name="ping")

    spec_cpr = P("channel", "ping", None)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_cpr, spec_cpr, P(None), P("ping")),
        out_specs=P("channel", None, None),
    )
    return jax.jit(mapped)


def sharded_binned_partials_grid(
    mesh: Mesh, n_x_window: int, skipna: bool = True, closed: str = "left"
):
    """Multi-chip partial bin sums with a ping-invariant [C, R] range row.

    fn(sv_db, er_row, r_edges, x_rel) — the uniform-grid fast path
    (ops/binning.binned_window_partials_grid): the range row is channel-
    sharded and replicated across ping shards, so no [C, P, R] er block
    ever moves to the mesh.
    """
    from ..ops import binning

    def step(sv_db, er_row, r_edges, x_rel):
        sums, counts, nan_counts = binning.binned_window_partials_grid(
            sv_db, er_row, r_edges, x_rel, n_x_window, skipna=skipna, closed=closed
        )
        return (
            jax.lax.psum(sums, axis_name="ping"),
            jax.lax.psum(counts, axis_name="ping"),
            jax.lax.psum(nan_counts, axis_name="ping"),
        )

    out = P("channel", None, None)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P("channel", "ping", None), P("channel", None), P(None), P("ping")),
        out_specs=(out, out, out),
    )
    return jax.jit(mapped)


def sharded_binned_row_sum(mesh: Mesh, n_x_window: int, closed: str = "left"):
    """Multi-chip ping-invariant raw bin sums (NASC height numerator).

    fn(values_row, er_row, r_edges, x_rel) -> [C, n_x_window, n_r]: each
    ping shard scales the shared [C, n_r] row by its own per-bin ping
    counts (from its x_rel slice); one psum over the ping axis makes the
    global counts — exactly the factorized form of the full-resolution sum.
    """
    from ..ops import binning

    def step(values_row, er_row, r_edges, x_rel):
        s = binning.binned_window_row_sum(
            values_row, er_row, r_edges, x_rel, n_x_window, closed=closed
        )
        return jax.lax.psum(s, axis_name="ping")

    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P("channel", None), P("channel", None), P(None), P("ping")),
        out_specs=P("channel", None, None),
    )
    return jax.jit(mapped)


def survey_pipeline_step(mesh: Mesh, n_x: int, n_r: int, with_sv: bool = True):
    """One full survey-processing step on the given mesh (2- or 3-axis)."""
    if "range" in mesh.axis_names:
        return sharded_sv_mvbs_step_3d(mesh, n_x, n_r)
    return sharded_sv_mvbs_step(mesh, n_x, n_r, with_sv=with_sv)
