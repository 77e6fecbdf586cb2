"""Device kernels for binned echo-integration (MVBS/NASC).

Replaces the reference's flox map-reduce groupby
(echopype/commongrid/utils.py:504-628) without scatter: both grouping axes
are monotone — ping_time is sorted and echo_range/depth is monotone along
range_sample — so every bin is a *contiguous* run.  Contiguous-segment sums
are exact prefix sums:

    cumsum along the axis  ->  gather at bin-boundary positions  ->  diff

Range-bin boundaries come from a vmapped binary search per (channel, ping)
row; ping-bin boundaries are positions into the sorted ping axis.  Bin
membership matches pandas IntervalIndex semantics (closed left/right).

The partial sums+counts factor across shards: summing them over a mesh
(psum) then normalizing reproduces the global mean exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Precision of every data x 0/1-membership dot (parallel/pipeline.py imports
# it).  A DEFAULT float32 dot may run in reduced precision on an accelerator
# (TF32, a 10-bit mantissa, on NVIDIA GPUs), which quantizes the bin sums far
# beyond the <=1e-5 dB contract; HIGHEST keeps them at full float32.  The
# 0/1 operand is exact either way.
_DOT_PRECISION = jax.lax.Precision.HIGHEST

__all__ = [
    "er_is_uniform",
    "choose_block_g",
    "blocked_banded_segment_sum",
    "bin_index_np",
    "x_bounds_np",
    "row_bin_bounds",
    "binned_sum_partials",
    "banded_x_reduce",
    "binned_window_partials",
    "binned_window_partials_grid",
    "binned_window_row_sum",
    "binned_window_sum_raw",
    "windowed_partials_np",
    "windowed_sum_raw_np",
    "binned_mean_linear",
    "binned_sum_raw",
    "binned_mean_1d",
]


# ------------------------------------------------------------------ host side
def bin_index_np(values: np.ndarray, edges: np.ndarray, closed: str = "left") -> np.ndarray:
    """Bin index per element, -1 outside all bins (host; pandas-Interval exact)."""
    right = closed == "right"
    idx = np.digitize(values, edges, right=right) - 1
    n_bins = len(edges) - 1
    invalid = (idx < 0) | (idx >= n_bins)
    if values.dtype.kind == "f":
        invalid |= np.isnan(values)
    return np.where(invalid, -1, idx).astype("i4")


def x_bounds_np(sorted_values: np.ndarray, edges: np.ndarray, closed: str = "left") -> np.ndarray:
    """Boundary positions [n_bins+1] of each bin in a sorted 1-D value array.

    Elements of bin b live at positions [bounds[b], bounds[b+1]).
    closed='left':  [lo, hi)  -> side='left' search of each edge.
    closed='right': (lo, hi]  -> side='right' search of each edge.
    """
    side = "left" if closed == "left" else "right"
    return np.searchsorted(sorted_values, edges, side=side).astype("i4")


def choose_block_g(bounds: np.ndarray, n_valid: int, g_max: int = 64) -> int:
    """Pick a static block size for :func:`blocked_banded_segment_sum`.

    Valid G: no block of G samples may contain two distinct bin boundaries
    (equivalently min over channels of min consecutive-bound spacing >= G;
    boundary values clipped outside [0, n_valid] collapse and don't count).
    Returns the largest power of two <= min spacing (capped at g_max), or 0
    when none >= 8 exists — callers fall back to the plain banded matmul.
    Host-side: ``bounds`` are the f64-exact per-channel bin bounds the
    kernels reproduce on device (``_refine_bounds`` pins them to the grid).
    """
    b = np.clip(np.asarray(bounds, dtype="f8"), 0, n_valid)
    d = np.diff(b, axis=-1)
    d = d[d > 0]
    if d.size == 0 or d.min() < 8:  # sub-8 spacing: 1 << log2(<1) would raise
        return 0
    g = 1 << int(np.floor(np.log2(d.min())))
    return min(g, g_max)


def blocked_banded_segment_sum(vals, bounds, n_r: int, G: int):
    """Exact-f32 contiguous-segment sums with ~1/G of the banded-matmul MACs.

    vals   : f32 [C, P, N] (already masked: out-of-segment samples are 0)
    bounds : f32 [C, n_r+1] integral segment boundaries in [0, N]
    G      : static block size from :func:`choose_block_g` — no G-sample
             block may contain two distinct boundaries.

    Equivalent to ``dot(vals, M)`` with the 0/1 banded membership M, but the
    range axis first reduces in exact f32 elementwise over static G-blocks
    (plus a sibling *left-partial* reduce at each block's single interior
    boundary), so the dot only reassembles [C,P,N/G] block sums through two
    0/1 matrices: full-block membership, and the left/right-part selectors
    of the two edge blocks.

    An alternative to the plain banded dot, selected by ``block_g`` in
    :func:`parallel.pipeline.sv_mvbs_window_partials_uniform` and off by
    default: it pays only where the [C,P,B,G] reshape and its minor-axis
    reduces fuse into the elementwise producer; otherwise the 1/G saving in
    multiply-adds costs extra passes over memory.

    Decomposition per bin b = [lo, hi):
      left  part: [lo, min(hi, ceil_G(lo)))   — inside block floor(lo/G)
      full blocks: [ceil_G(lo), floor_G(hi))
      right part: [max(ceil_G(lo), floor_G(hi)), hi)
    With <=1 boundary per block, the left part of bin b is block jL's
    RIGHT-partial at its single cut (= lo), and the right part is block jR's
    LEFT-partial at its cut (= hi):
      s1 = sB @ (Mfull + SelL) + sL @ (SelR - SelL)
    where sL[c,p,j] sums vals below block j's cut (cut = block end when the
    block has no boundary, making sL = sB there; those blocks never appear
    in SelL/SelR).
    """
    C, P, N = vals.shape
    B = -(-N // G)
    pad = B * G - N
    if pad:
        vals = jnp.pad(vals, ((0, 0), (0, 0), (0, pad)))
    vb = vals.reshape(C, P, B, G)

    lo = bounds[:, :-1]  # [C, n_r]
    hi = bounds[:, 1:]
    blk_start = jax.lax.broadcasted_iota(jnp.float32, (1, B, 1), 1) * G

    # the single interior boundary per block -> per-block cut (else block end)
    # boundary e is interior to block floor(e/G) iff e mod G != 0
    eG = jnp.float32(G)
    b_all = bounds  # [C, n_r+1]
    interior = jnp.mod(b_all, eG) != 0
    e_blk = jnp.floor(b_all / eG)  # [C, n_r+1]
    j_ids = jax.lax.broadcasted_iota(jnp.float32, (1, B, 1), 1)  # [1,B,1]
    has_e = (j_ids == e_blk[:, None, :]) & interior[:, None, :]  # [C,B,n_e]
    cut = jnp.max(jnp.where(has_e, b_all[:, None, :], 0.0), axis=2)  # [C,B]
    cut = jnp.where(jnp.any(has_e, axis=2), cut, (jnp.arange(B) + 1.0) * eG)

    gpos = (
        jax.lax.broadcasted_iota(jnp.float32, (1, 1, B, G), 2) * G
        + jax.lax.broadcasted_iota(jnp.float32, (1, 1, B, G), 3)
    )
    mL = gpos < cut[:, None, :, None]
    sB = vb.sum(-1)  # [C,P,B] exact f32 block sums
    sL = jnp.where(mL, vb, 0.0).sum(-1)  # sibling reduce, same producer pass

    ceil_lo = jnp.ceil(lo / eG) * eG
    floor_hi = jnp.floor(hi / eG) * eG
    Mfull = (blk_start >= ceil_lo[:, None, :]) & (blk_start + G <= floor_hi[:, None, :])
    jL = jnp.floor(lo / eG)
    jR = jnp.floor(hi / eG)
    nonempty = (hi > lo)[:, None, :]  # empty bins select nothing
    SelL = (j_ids == jL[:, None, :]) & (jnp.mod(lo, eG) != 0)[:, None, :] & nonempty
    SelR = (j_ids == jR[:, None, :]) & (jnp.mod(hi, eG) != 0)[:, None, :] & nonempty
    M1 = Mfull.astype(jnp.float32) + SelL.astype(jnp.float32)
    M2 = SelR.astype(jnp.float32) - SelL.astype(jnp.float32)

    dn = (((2,), (1,)), ((0,), (0,)))
    return (
        jax.lax.dot_general(sB, M1, dn, preferred_element_type=jnp.float32,
                            precision=_DOT_PRECISION)
        + jax.lax.dot_general(sL, M2, dn, preferred_element_type=jnp.float32,
                              precision=_DOT_PRECISION)
    )


# ---------------------------------------------------------------- device side
def row_bin_bounds(er, edges, closed: str = "left"):
    """Per-row bin-boundary positions via vmapped binary search.

    er: [C, P, R] monotone-increasing along R.  NaNs are mapped to +inf, so
    they are excluded ONLY when they form a suffix of the row (the ragged-
    padding layout) or fill whole rows; an interior NaN breaks the row's
    monotonicity and the binary search with it.  The device streamers
    satisfy this by construction (trailing pad / sanitized whole-ping NaN);
    the public host entries digitize elementwise instead
    (exact_bin_encode_np).  Returns int32 [C, P, n_edges].
    """
    side = "left" if closed == "left" else "right"
    er_clean = jnp.where(jnp.isnan(er), jnp.inf, er)

    def one_row(row):
        return jnp.searchsorted(row, edges, side=side)

    return jax.vmap(jax.vmap(one_row))(er_clean).astype(jnp.int32)


def _prefix_gather_diff(values, bounds, axis):
    """Sum of contiguous runs: cumsum with zero prepend, gather, diff.

    values: [..., N, ...]; bounds positions in [0, N]."""
    cs = jnp.cumsum(values, axis=axis)
    pad = [(0, 0)] * values.ndim
    pad[axis] = (1, 0)
    cs = jnp.pad(cs, pad)
    g = jnp.take_along_axis(cs, bounds, axis=axis)
    return jnp.diff(g, axis=axis)


@partial(jax.jit, static_argnames=("skipna", "closed"))
def binned_sum_partials(sv_db, er, r_edges, x_bounds, skipna: bool = True, closed: str = "left"):
    """Linear-domain partial sums per (channel, x_bin, range_bin) — scatter-free.

    sv_db    : f32 [C, P, R]
    er       : f32 [C, P, R] monotone along R (range variable values)
    r_edges  : f32 [n_r + 1] range-bin edges
    x_bounds : i32 [n_x + 1] ping positions of x-bin boundaries (sorted axis)

    Returns (sums, counts, nan_counts) each f32 [C, n_x, n_r].  With
    skipna=False a bin containing any NaN Sv (at a valid range coord) must be
    NaN — nan_counts carries that across shards.
    """
    C, P, R = sv_db.shape
    lin = jnp.power(10.0, sv_db / 10.0)
    isnan_sv = jnp.isnan(sv_db)
    ok = ~isnan_sv

    rb = row_bin_bounds(er, r_edges, closed)  # [C, P, n_r+1]

    s1 = _prefix_gather_diff(jnp.where(ok, lin, 0.0), rb, axis=2)  # [C,P,n_r]
    n1 = _prefix_gather_diff(ok.astype(jnp.float32), rb, axis=2)
    if skipna:
        nan1 = jnp.zeros_like(n1)
    else:
        nan1 = _prefix_gather_diff(isnan_sv.astype(jnp.float32), rb, axis=2)

    xb = jnp.broadcast_to(x_bounds[None, :, None], (C, x_bounds.shape[0], s1.shape[2]))
    sums = _prefix_gather_diff(s1, xb, axis=1)  # [C, n_x, n_r]
    counts = _prefix_gather_diff(n1, xb, axis=1)
    nan_counts = _prefix_gather_diff(nan1, xb, axis=1)
    return sums, counts, nan_counts


def banded_x_reduce(blocks, x_rel, n_x_window: int):
    """Reduce the ping axis of [C, P, K] blocks onto a local bin window.

    x_rel: sorted i32 [P] window-relative bin ids (ids >= n_x_window fall
    past the last boundary and are ignored — park padded pings there).  Each
    output bin is an independent dot accumulation over its own pings, unlike
    the prefix-sum reduction whose f32 cumsum cancels catastrophically for a
    quiet bin following loud pings (and whose counts saturate past 2^24).
    Bin MEMBERSHIP and counts are therefore invariant to how a stream was
    chunked or sharded; value sums are chunk-invariant to f32 reassociation
    (a bin straddling a chunk boundary sums two f32 partials, ~4e-5 dB
    between chunkings on ~10^3-sample bins), with the host combining
    partials in f64.
    Returns [C, n_x_window, K].
    """
    P = blocks.shape[1]
    xb = jnp.searchsorted(
        x_rel, jnp.arange(n_x_window + 1, dtype=x_rel.dtype), side="left"
    ).astype(jnp.float32)
    p_ids = jax.lax.broadcasted_iota(jnp.float32, (P, 1), 0)
    Mx = ((p_ids >= xb[None, :-1]) & (p_ids < xb[None, 1:])).astype(jnp.float32)
    dn = (((1,), (0,)), ((), ()))
    out = jax.lax.dot_general(blocks, Mx, dn, preferred_element_type=jnp.float32,
                              precision=_DOT_PRECISION)
    return jnp.moveaxis(out, 2, 1)


def er_is_uniform(er) -> bool:
    """True when every ping of each channel shares one finite range grid.

    The uniform case (ping-invariant sample interval — the instrument norm)
    unlocks the cancellation-free banded-matmul range reduction; the
    per-ping cumsum reduction loses quiet bins that follow loud samples
    (f32 prefix cancellation, see banded_x_reduce's docstring).
    """
    er = np.asarray(er)
    if er.ndim < 3:
        return True
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        ref = np.nanmax(er, axis=1)  # [C, R]
    return bool(np.all(np.isnan(er) | (er == ref[:, None, :])))


def _uniform_bin_matmul(vals3, er_grid, r_edges, closed: str):
    """[C, P, R] -> [C, P, n_r] bin sums via a per-channel banded matmul.

    Membership is computed directly against the channel's range grid
    (er_grid [C, R], NaN -> no bin): exact and cancellation-free — each bin
    accumulates only its own samples.
    """
    eg = jnp.where(jnp.isnan(er_grid), jnp.inf, er_grid)[:, :, None]  # [C,R,1]
    if closed == "right":
        M = (eg > r_edges[None, None, :-1]) & (eg <= r_edges[None, None, 1:])
    else:
        M = (eg >= r_edges[None, None, :-1]) & (eg < r_edges[None, None, 1:])
    M = M.astype(jnp.float32)
    dn = (((2,), (1,)), ((0,), (0,)))
    return jax.lax.dot_general(vals3, M, dn, preferred_element_type=jnp.float32,
                               precision=_DOT_PRECISION)


@partial(jax.jit, static_argnames=("n_x_window", "skipna", "closed", "uniform_er"))
def binned_window_partials(
    sv_db, er, r_edges, x_rel, n_x_window: int, skipna: bool = True,
    closed: str = "left", uniform_er: bool = False,
):
    """Chunk-invariant partial bin sums on a local ping-bin window.

    Like :func:`binned_sum_partials` but the ping axis reduces via
    :func:`banded_x_reduce` with window-relative bin ids, so partials from
    different chunkings/shardings of the same stream accumulate identically.
    Returns (sums, counts, nan_counts) each f32 [C, n_x_window, n_r].

    uniform_er=True (use :func:`er_is_uniform` to decide) replaces the
    range-axis prefix-sum reduction with a per-channel banded matmul:
    cancellation-free, so quiet bins next to loud samples keep full f32
    precision (the prefix-diff form can lose them entirely — found by the
    fused freq-diff masked-MVBS differential, round 3).
    """
    lin = jnp.power(10.0, sv_db / 10.0)
    isnan_sv = jnp.isnan(sv_db)
    ok = ~isnan_sv
    if uniform_er:
        er_grid = jnp.nanmax(er, axis=1)  # [C, R]; all-NaN cols stay NaN
        okv = ok & ~jnp.isnan(er)
        s1 = _uniform_bin_matmul(jnp.where(okv, lin, 0.0), er_grid, r_edges, closed)
        n1 = _uniform_bin_matmul(okv.astype(jnp.float32), er_grid, r_edges, closed)
        if skipna:
            nan1 = jnp.zeros_like(n1)
        else:
            nan1 = _uniform_bin_matmul(
                (isnan_sv & ~jnp.isnan(er)).astype(jnp.float32), er_grid, r_edges, closed
            )
    else:
        rb = row_bin_bounds(er, r_edges, closed)  # [C, P, n_r+1]
        s1 = _prefix_gather_diff(jnp.where(ok, lin, 0.0), rb, axis=2)  # [C,P,n_r]
        n1 = _prefix_gather_diff(ok.astype(jnp.float32), rb, axis=2)
        if skipna:
            nan1 = jnp.zeros_like(n1)
        else:
            nan1 = _prefix_gather_diff(isnan_sv.astype(jnp.float32), rb, axis=2)
    n_r = s1.shape[2]
    stacked = banded_x_reduce(jnp.concatenate([s1, n1, nan1], axis=2), x_rel, n_x_window)
    return stacked[:, :, :n_r], stacked[:, :, n_r : 2 * n_r], stacked[:, :, 2 * n_r :]


@partial(jax.jit, static_argnames=("n_x_window", "skipna", "closed"))
def binned_window_partials_grid(
    sv_db, er_grid, r_edges, x_rel, n_x_window: int, skipna: bool = True,
    closed: str = "left",
):
    """Uniform-grid variant of :func:`binned_window_partials`.

    er_grid: f32 [C, R] — the ping-invariant range grid (NaN = no bin).
    Saves the [C, P, R] range-array HBM read AND its host->device transfer:
    the round-4 NASC/MVBS streamers were shipping er (and for NASC also
    ddep/dep_lower) at full [C, P, R] resolution per chunk when a [C, R]
    row determines all of it.  Membership and results are identical to
    binned_window_partials(..., uniform_er=True) on a broadcast er whose
    NaN pattern is ping-invariant; Sv-NaN handling is unchanged (the mask
    comes from sv itself).
    """
    lin = jnp.power(10.0, sv_db / 10.0)
    isnan_sv = jnp.isnan(sv_db)
    ok = ~isnan_sv & ~jnp.isnan(er_grid)[:, None, :]
    s1 = _uniform_bin_matmul(jnp.where(ok, lin, 0.0), er_grid, r_edges, closed)
    n1 = _uniform_bin_matmul(ok.astype(jnp.float32), er_grid, r_edges, closed)
    if skipna:
        nan1 = jnp.zeros_like(n1)
    else:
        nan1 = _uniform_bin_matmul(
            (isnan_sv & ~jnp.isnan(er_grid)[:, None, :]).astype(jnp.float32),
            er_grid, r_edges, closed,
        )
    n_r = s1.shape[2]
    stacked = banded_x_reduce(jnp.concatenate([s1, n1, nan1], axis=2), x_rel, n_x_window)
    return stacked[:, :, :n_r], stacked[:, :, n_r : 2 * n_r], stacked[:, :, 2 * n_r :]


@partial(jax.jit, static_argnames=("n_x_window", "closed"))
def binned_window_row_sum(values_row, er_row, r_edges, x_rel, n_x_window: int,
                          closed: str = "left"):
    """Ping-invariant raw bin sums x per-bin ping counts.

    values_row / er_row: f32 [C, R] one row shared by every ping (the NASC
    height integrand ddep on a uniform depth grid).  The per-ping sum is
    the same [C, n_r] row, so the window reduction collapses to that row
    times the number of pings in each window bin (from x_rel; padded pings
    parked at id >= n_x_window drop out) — O(C*R*n_r) instead of
    O(C*P*R*n_r), and no [C, P, R] operand at all.
    """
    ok = ~jnp.isnan(values_row) & ~jnp.isnan(er_row)
    s_row = _uniform_bin_matmul(
        jnp.where(ok, values_row, 0.0)[:, None, :], er_row, r_edges, closed
    )[:, 0, :]  # [C, n_r]
    ids = jnp.arange(n_x_window, dtype=x_rel.dtype)
    ping_counts = jnp.sum(
        (x_rel[None, :] == ids[:, None]).astype(jnp.float32), axis=1
    )  # [n_x_window]
    return s_row[:, None, :] * ping_counts[None, :, None]


@partial(jax.jit, static_argnames=("n_x_window", "closed", "uniform_er"))
def binned_window_sum_raw(
    values, er, r_edges, x_rel, n_x_window: int, closed: str = "left",
    uniform_er: bool = False,
):
    """NaN-skipping raw sums on a local ping-bin window (matmul reduction)."""
    ok = ~jnp.isnan(values)
    if uniform_er:
        er_grid = jnp.nanmax(er, axis=1)
        okv = ok & ~jnp.isnan(er)
        s1 = _uniform_bin_matmul(jnp.where(okv, values, 0.0), er_grid, r_edges, closed)
    else:
        rb = row_bin_bounds(er, r_edges, closed)
        s1 = _prefix_gather_diff(jnp.where(ok, values, 0.0), rb, axis=2)
    return banded_x_reduce(s1, x_rel, n_x_window)


def _window_ids(x_bounds, P: int) -> np.ndarray:
    """Sorted-ping bin ids from boundary positions: out-of-range prefix pings
    map to -1 and suffix pings to n_x — outside any window bin either way."""
    return (np.searchsorted(np.asarray(x_bounds), np.arange(P), side="right") - 1).astype(
        "i8"
    )


def _windowed_accumulate(
    kernel, shape_cpn, n_x: int, x_bounds, chunk_pings: int, n_out: int
):
    """Drive a window kernel over ping chunks, accumulating f8 globals.

    kernel(lo, hi, x_rel, window) -> tuple of n_out [C, window, n_r] partials;
    shape_cpn = (C, P, n_r) of the global output layout.
    """
    C, P, n_r = shape_cpn
    ids = _window_ids(x_bounds, P)
    outs = [np.zeros((C, n_x, n_r), dtype="f8") for _ in range(n_out)]
    for lo in range(0, P, chunk_pings):
        hi = min(lo + chunk_pings, P)
        ids_c = ids[lo:hi]
        real = ids_c[(ids_c >= 0) & (ids_c < n_x)]
        if real.size == 0:
            continue
        x_base = int(real[0])
        window = int(real[-1]) - x_base + 1
        parts = kernel(lo, hi, (ids_c - x_base).astype("i4"), window)
        for o, p in zip(outs, parts):
            o[:, x_base : x_base + window] += np.asarray(p, dtype="f8")
    return outs


def exact_bin_encode_np(er, r_edges, closed="left"):
    """Resolve bin membership on host in f64 and re-encode for f32 kernels.

    The kernels consume ``er`` solely to resolve bin membership; binning the
    values on host in float64 (elementwise — the reference's flox digitize
    semantics) and shipping ``idx + 0.5`` against integer edges makes the
    in-kernel f32 comparisons exact on ANY grid: a sample within one f32 ulp
    of a bin edge can otherwise land on the wrong side of the reference's
    f64 digitize.  NaN and out-of-bin samples encode as NaN (no bin).

    Returns (er_enc f4, edges_enc f4, idx i8, ok bool) — idx/ok are the raw
    elementwise membership for exact host-side accumulation.
    """
    er64 = np.asarray(er, dtype="f8")
    edges64 = np.asarray(r_edges, dtype="f8")
    n_r = len(edges64) - 1
    side = "right" if closed == "left" else "left"
    idx = np.searchsorted(edges64, er64, side=side) - 1
    ok = (idx >= 0) & (idx < n_r) & ~np.isnan(er64)
    er_enc = np.where(ok, idx + 0.5, np.nan).astype("f4")
    return er_enc, np.arange(n_r + 1, dtype="f4"), idx, ok


def _x_index_from_bounds_np(x_bounds, P):
    """Per-ping x-bin index from boundary positions; -1 = outside all bins."""
    b = np.clip(np.asarray(x_bounds, dtype="i8"), 0, P)
    xi = np.searchsorted(b, np.arange(P), side="right") - 1
    xi[(xi < 0) | (xi >= len(b) - 1)] = -1
    return xi


def _host_exact_partials_np(
    sv, ridx, ok_r, n_r, x_bounds, skipna, lin_domain, chunk_pings=8192
):
    """Exact f64 host bincount accumulation for ping-varying range grids.

    The in-kernel prefix-gather reduction loses quiet bins to f32 prefix
    cancellation when the range grid varies per ping (the cancellation-free
    banded-matmul path only exists for ping-invariant grids — see
    banded_x_reduce); the public host entries take this exact path instead,
    matching the reference's f64 flox accumulation.  Found by the round-4
    mvbs soak's wobbled-grid fuzz (1.8e-3 dB on quiet bins).

    Accumulates over ping chunks so the f8 temporaries (cast Sv, 10**(sv/10),
    labels, masks) stay bounded on large surveys.
    """
    sv = np.asarray(sv)
    C, P, R = sv.shape
    n_x = len(x_bounds) - 1
    xi = _x_index_from_bounds_np(x_bounds, P)
    sums = np.zeros((C, n_x, n_r), dtype="f8")
    counts = np.zeros_like(sums)
    nans = np.zeros_like(sums)
    for lo in range(0, P, chunk_pings):
        hi = min(lo + chunk_pings, P)
        svc = np.asarray(sv[:, lo:hi], dtype="f8")
        okr_c = ok_r[:, lo:hi]
        valid = okr_c & (xi[lo:hi] >= 0)[None, :, None]
        lab = xi[None, lo:hi, None] * n_r + np.where(okr_c, ridx[:, lo:hi], 0)
        vals = np.power(10.0, svc / 10.0) if lin_domain else svc
        nan_sv = np.isnan(svc)
        okv = valid & ~nan_sv
        for c in range(C):
            sel = okv[c]
            lc = lab[c][sel]
            sums[c] += np.bincount(
                lc, weights=vals[c][sel], minlength=n_x * n_r
            ).reshape(n_x, n_r)
            counts[c] += np.bincount(lc, minlength=n_x * n_r).reshape(n_x, n_r)
            if not skipna:
                ln = lab[c][valid[c] & nan_sv[c]]
                nans[c] += np.bincount(ln, minlength=n_x * n_r).reshape(n_x, n_r)
    return sums, counts, nans


def windowed_partials_np(
    sv, er, r_edges, x_bounds, skipna=True, closed="left", chunk_pings=8192
):
    """(sums, counts, nan_counts) f8 via the chunk-windowed matmul reduction.

    Same membership as binned_sum_partials/x_bounds but each bin accumulates
    independently in a dot — no prefix-sum cancellation for a quiet bin
    after loud pings (see banded_x_reduce), bounded mask size via chunking.
    The range axis likewise takes the cancellation-free matmul path whenever
    the range grid is ping-invariant (er_is_uniform); a ping-varying grid
    falls back to the exact f64 host accumulation (_host_exact_partials_np).
    Pass ``er`` and ``r_edges`` at full (f64) precision: membership resolves
    on host via :func:`exact_bin_encode_np` before anything is cast for the
    device.
    """
    er, r_edges, ridx, ok_r = exact_bin_encode_np(er, r_edges, closed)
    uniform = er_is_uniform(er)
    if not uniform:
        return _host_exact_partials_np(
            sv, ridx, ok_r, len(r_edges) - 1, x_bounds, skipna, lin_domain=True,
            chunk_pings=chunk_pings,
        )

    def kernel(lo, hi, x_rel, window):
        return binned_window_partials(
            sv[:, lo:hi], er[:, lo:hi], r_edges, x_rel, window,
            skipna=skipna, closed=closed, uniform_er=uniform,
        )

    return _windowed_accumulate(
        kernel,
        (sv.shape[0], sv.shape[1], len(r_edges) - 1),
        len(x_bounds) - 1,
        x_bounds,
        chunk_pings,
        3,
    )


def windowed_sum_raw_np(values, er, r_edges, x_bounds, closed="left", chunk_pings=8192):
    """NaN-skipping raw bin sums (f8) via the chunk-windowed matmul reduction.

    Membership resolves on host in f64 (exact_bin_encode_np) — pass ``er``
    and ``r_edges`` at full precision; ping-varying grids take the exact
    f64 host accumulation."""
    er, r_edges, ridx, ok_r = exact_bin_encode_np(er, r_edges, closed)
    uniform = er_is_uniform(er)
    if not uniform:
        return _host_exact_partials_np(
            values, ridx, ok_r, len(r_edges) - 1, x_bounds, skipna=True,
            lin_domain=False, chunk_pings=chunk_pings,
        )[0]

    def kernel(lo, hi, x_rel, window):
        return (
            binned_window_sum_raw(
                values[:, lo:hi], er[:, lo:hi], r_edges, x_rel, window,
                closed=closed, uniform_er=uniform,
            ),
        )

    return _windowed_accumulate(
        kernel,
        (values.shape[0], values.shape[1], len(r_edges) - 1),
        len(x_bounds) - 1,
        x_bounds,
        chunk_pings,
        1,
    )[0]


@partial(jax.jit, static_argnames=("skipna", "closed"))
def binned_mean_linear(sv_db, er, r_edges, x_bounds, skipna: bool = True, closed: str = "left"):
    """Mean of linear Sv per bin, back in dB: f32 [C, n_x, n_r] (NaN = empty)."""
    sums, counts, nan_counts = binned_sum_partials(sv_db, er, r_edges, x_bounds, skipna, closed)
    mean = sums / jnp.where(counts > 0, counts, 1.0)
    good = (counts > 0) & (nan_counts == 0)
    return jnp.where(good, 10.0 * jnp.log10(mean), jnp.nan)


@partial(jax.jit, static_argnames=("closed",))
def binned_sum_raw(values, er, r_edges, x_bounds, closed: str = "left"):
    """NaN-skipping raw sum per (channel, x_bin, range_bin) — scatter-free."""
    ok = ~jnp.isnan(values)
    rb = row_bin_bounds(er, r_edges, closed)
    s1 = _prefix_gather_diff(jnp.where(ok, values, 0.0), rb, axis=2)
    C = values.shape[0]
    xb = jnp.broadcast_to(x_bounds[None, :, None], (C, x_bounds.shape[0], s1.shape[2]))
    return _prefix_gather_diff(s1, xb, axis=1)


@partial(jax.jit, static_argnames=("n_x",))
def binned_mean_1d(values, x_idx, n_x: int):
    """NaN-mean of a [P] array per x bin (lat/lon reduction; tiny, scatter ok)."""
    ok = (x_idx >= 0) & ~jnp.isnan(values)
    seg = jnp.where(x_idx >= 0, x_idx, n_x)
    sums = jax.ops.segment_sum(jnp.where(ok, values, 0.0), seg, num_segments=n_x + 1)
    counts = jax.ops.segment_sum(ok.astype(jnp.float32), seg, num_segments=n_x + 1)
    mean = sums[:-1] / jnp.where(counts[:-1] > 0, counts[:-1], 1.0)
    return jnp.where(counts[:-1] > 0, mean, jnp.nan)
