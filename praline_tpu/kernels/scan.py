"""Batched anti-diagonal wavefront DP as a jitted ``lax.scan`` (SURVEY.md §9 P2).

This replaces the reference's per-cell interpreted loop (SURVEY.md C10) with
a vectorized formulation: all cells of an anti-diagonal update in one
vector operation, a batch of B independent pairwise problems rides the
leading axis, and the scan streams precomputed skewed scores (kernels.scores)
diagonal by diagonal.  The same code path runs on CPU (tests) and GPU; the
scores-only Pallas kernel (kernels.lane_dp) computes the identical
recurrence one problem per GPU lane.

Semantics are bit-identical to praline_tpu.oracle.align (the parity
contract): same state machine, same tie-breaks, same f32 arithmetic.

Layout: diagonal vectors are indexed by i (rows consumed of x), lane i holds
cell (i, d - i).  Per problem true lengths (lx, ly) <= bucket shape (Lx, Ly);
padded cells compute garbage that can never contaminate valid cells (the DP
only propagates forward) and terminals are extracted at the true lengths.

Traceback bits per interior cell (uint8):
  bits 0-4: M predecessor code (0 = M, 1..k = Ix level, k+1..2k = Iy level,
            31 = none — local fresh start),
  bit 5:    level-k Ix choice (1 = stay at level k / extend, 0 = enter from
            level k-1, or from M when k == 1),
  bit 6:    same for Iy,
  bit 7:    local mode only — "this M cell's value <= 0" (the stop-at-zero
            rule's only value-dependent decision, so local traceback
            replays on device without cell values).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.float32(-1.0e30)  # np scalar: no device init at import
PTR_NONE = 31


def _gap_prefix(gap_series: tuple[int, ...], length: int) -> np.ndarray:
    k = len(gap_series)
    g = np.asarray(gap_series, dtype=np.float32)
    idx = np.minimum(np.arange(1, length + 1), k) - 1
    cum = np.zeros(length + 1, dtype=np.float32)
    if length:
        cum[1:] = np.cumsum(g[idx], dtype=np.float32)
    return cum


def _priority_select(m, ixs, iys, lm, lixs, liys, codes_x=None, codes_y=None):
    """Best state per cell with M > Ix(levels asc) > Iy(levels asc) on ties.

    Returns (value, length, code) arrays; code as in the traceback-bit doc.
    ``codes_x``/``codes_y`` override the per-level state codes — the
    COLLAPSED k=2 path carries one max-of-levels state per side and passes
    the level-resolving code ``1 + stay`` (see the collapse note in
    ``_wavefront``).
    """
    k = len(ixs)
    if codes_x is None:
        codes_x = [1 + l for l in range(k)]
    if codes_y is None:
        codes_y = [1 + k + l for l in range(k)]
    val, ln, code = m, lm, jnp.zeros_like(m, dtype=jnp.int32)
    for l in range(k):
        better = ixs[l] > val
        val = jnp.where(better, ixs[l], val)
        ln = jnp.where(better, lixs[l], ln)
        code = jnp.where(better, codes_x[l], code)
    for l in range(k):
        better = iys[l] > val
        val = jnp.where(better, iys[l], val)
        ln = jnp.where(better, liys[l], ln)
        code = jnp.where(better, codes_y[l], code)
    return val, ln, code


@functools.partial(
    jax.jit, static_argnames=("gap_series", "mode", "traceback")
)
def wavefront_dp(
    hs: jax.Array,  # f32[D, B, Lp] skewed scores (kernels.scores layout)
    lx: jax.Array,  # int32[B] true x lengths (>= 1)
    ly: jax.Array,  # int32[B] true y lengths (>= 1)
    gap_series: tuple[int, ...] = (11, 1),
    mode: str = "global",
    traceback: bool = False,
):
    """Run the batched DP.  Returns a dict with per-problem terminals:

    ``score`` f32[B]; ``length`` f32[B] (emitted path columns, semiglobal
    INCLUDING free leading gaps but EXCLUDING the trailing append — add
    ``(lx - ti) + (ly - tj)`` on the host); ``ti``/``tj`` int32[B] terminal
    cell; ``tcode`` int32[B] terminal state code (as traceback-bit codes);
    and, when ``traceback``, ``tb`` uint8[D-2, B, Lp] direction bits.
    """
    D, B, Lp = hs.shape
    return _wavefront(hs, None, D, B, Lp, lx, ly, gap_series, mode, traceback)


@functools.partial(
    jax.jit, static_argnames=("gap_series", "mode", "traceback")
)
def wavefront_dp_streamed(
    cx: jax.Array,  # f32[B, Lx, A] integer-valued counts
    inv_x: jax.Array,  # f32[B, Lx]
    cy: jax.Array,  # f32[B, Ly, A]
    inv_y: jax.Array,  # f32[B, Ly]
    s: jax.Array,  # f32[A, A]
    lx: jax.Array,
    ly: jax.Array,
    gap_series: tuple[int, ...] = (11, 1),
    mode: str = "global",
    traceback: bool = False,
):
    """Wavefront DP with STREAMED score production: each scan step computes
    its own diagonal's scores from device-resident profiles, so the skewed
    O(D * B * Lp) ``hs`` tensor never exists — peak memory is O(B * L * A).
    This lifts the materialized producer's device-memory ceiling: any Lx,
    any Ly (SURVEY.md §6
    long-context row; the routing lives in kernels.batch).

    Bit-identical to ``skewed_pair_scores`` + ``wavefront_dp``: the per-cell
    integer dot H_int = (cx @ S) . cy is exact in f32 under any summation
    order (oracle/score.py contract), and the (H_int * inv_x) * inv_y
    multiply order is pinned identically here.
    """
    hrow_fn, B, Lp, D = _streamed_hrow(cx, inv_x, cy, inv_y, s)
    return _wavefront(None, hrow_fn, D, B, Lp, lx, ly, gap_series, mode, traceback)


def _streamed_hrow(cx, inv_x, cy, inv_y, s):
    """Shared streamed-producer setup: returns ``(hrow_fn, B, Lp, D)`` where
    ``hrow_fn(d)`` computes diagonal d's score row from device-resident
    profiles (used by the streamed, checkpointed and ring paths)."""
    from .scores import HIGHEST

    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    Lp = Lx + 1
    D = Lx + Ly + 1

    # Lane i of diagonal d scores cells (i, d-i): needs t[i-1] . cy[d-i-1].
    t = jnp.einsum("bxa,ac->bxc", cx, s, precision=HIGHEST)
    t_pad = jnp.pad(t, ((0, 0), (1, 0), (0, 0)))  # lane 0 -> zero row
    invx_pad = jnp.pad(inv_x, ((0, 0), (1, 0)), constant_values=1.0)
    # Reversed-y buffers padded so the window for diagonal d is the length-Lp
    # slice starting at (Ly - d) + Lx: lane i reads cy[d-1-i] (zeros / 1.0
    # outside the valid range, making out-of-range cells exactly 0.0, as in
    # the materialized producer's validity mask).
    cyr_pad = jnp.pad(cy[:, ::-1, :], ((0, 0), (Lx, Lx), (0, 0)))
    invy_pad = jnp.pad(
        inv_y[:, ::-1], ((0, 0), (Lx, Lx)), constant_values=1.0
    )

    def hrow_fn(d):
        start = Lx + Ly - d
        w_y = jax.lax.dynamic_slice_in_dim(cyr_pad, start, Lp, axis=1)
        w_iv = jax.lax.dynamic_slice_in_dim(invy_pad, start, Lp, axis=1)
        h_int = jnp.einsum("bia,bia->bi", t_pad, w_y, precision=HIGHEST)
        # Rounding of this multiply chain is pinned by the nested-scan
        # chunk materialization in _wavefront (see comment there).
        return (h_int * invx_pad) * w_iv

    return hrow_fn, B, Lp, D


@functools.partial(
    jax.jit, static_argnames=("gap_series", "mode", "interval")
)
def wavefront_dp_checkpointed(
    cx: jax.Array,
    inv_x: jax.Array,
    cy: jax.Array,
    inv_y: jax.Array,
    s: jax.Array,
    lx: jax.Array,
    ly: jax.Array,
    gap_series: tuple[int, ...] = (11, 1),
    mode: str = "global",
    interval: int | None = None,
):
    """Giant-problem traceback in O(L^1.5) memory — the device-resident
    alternative to Hirschberg divide-and-conquer (SURVEY.md §6 long-context
    row, §9 hard part 2).

    Classic Hirschberg recursion is host-driven with dynamic shapes —
    hostile to XLA.  Instead: the streamed forward pass snapshots its scan
    carry every R diagonals (checkpoints, O(D/R * Lp) floats), then a
    backward pass walks the move tape block by block, re-deriving each
    R-diagonal block's direction bits from its checkpoint with the SAME
    step closure — so the bits, and therefore the path, are bit-identical
    to the full-tb path by construction, while only one block's bits
    (O(R * Lp)) ever exist.  R defaults to ~8*sqrt(D), balancing the two
    terms; the whole thing runs in ONE jit dispatch.

    Returns the terminal dict plus ``moves``/``nmoves`` (the
    ``kernels.replay`` move-tape contract; decode with
    ``replay.moves_to_result``).  All modes (local's stop rule rides bit 7
    of the re-derived direction bytes).
    """
    if mode not in ("global", "semiglobal", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    hrow_fn, B, Lp, D = _streamed_hrow(cx, inv_x, cy, inv_y, s)
    if interval is None:
        interval = default_ckpt_interval(D)
    return _wavefront(
        None, hrow_fn, D, B, Lp, lx, ly, gap_series, mode, True,
        ckpt_interval=int(interval),
    )


def default_ckpt_interval(D: int) -> int:
    """Default checkpoint block size ~8*sqrt(D), rounded up to 64: balances
    the O(D/R) carry snapshots against the O(R) per-block bit buffer.  The
    batch driver sizes its dispatch memory cap with the SAME function."""
    return max(64, -(-int(8 * np.sqrt(D)) // 64) * 64)


def _wavefront(hs, hrow_fn, D, B, Lp, lx, ly, gap_series, mode, traceback,
               ring_axis=None, ring_n=1, lane_base=None, ring_interval=1,
               ckpt_interval=None, hband_fn=None):
    """Shared DP body.  ``ring_axis`` activates the multi-device ring form
    (SURVEY.md §3.2 ring row): the lane (x) axis is sharded over a mesh
    axis, each diagonal step passes its boundary lane to the right
    neighbour with ``ppermute``, and terminal reductions finish with
    pmax/pmin collectives.  ``Lp`` is then the LOCAL lane count and
    ``lane_base`` the device's first global lane; results are bit-equal to
    the single-device scan (parity-tested in tests/dist).

    ``ring_interval`` = K > 1 activates the SUPERSTEPPED ring: devices run
    K diagonal steps per collective, pipelined K diagonals apart (device p
    processes diagonal chunk c during superstep s = c + p), and each
    superstep exchanges all K boundary-lane stacks in ONE ``ppermute`` —
    per-diagonal ring latency, the cost that makes the per-step ring slower
    than batched dispatch, is amortized K-fold.  Terminal candidates are
    then tracked per device (each device only scores cells it owns) and
    merged once at the end with a lexicographic pmax reduce that reproduces
    the sequential tie-break order exactly.  Requires ``hrow_fn``."""
    k = len(gap_series)
    if k > 15:
        raise ValueError("gap series deeper than 15 levels not supported")
    g = [jnp.float32(x) for x in gap_series]
    # ---- k=2 state collapse (the default/hot gap series) ----
    # G=[g1,g2] is classic affine: the two Ix levels satisfy
    # Ix1(i,j) = M(i-1,j) - g1 and Ix2(i,j) = max(Ix1, Ix2)(i-1,j) - g2, so
    # NIX := max(Ix1, Ix2) (level 1 preferred on ties) obeys the 3-state
    # Gotoh recurrence NIX(i,j) = max(M(i-1,j) - g1, NIX(i-1,j) - g2) —
    # ONE carried row per side instead of two, and the chosen level is
    # 1 + stay where stay = (NIX(i-1,j) - g2 > M(i-1,j) - g1).  Outputs are
    # bit-for-bit those of the per-level form, INCLUDING the traceback
    # contract: the emitted bit-5 stay at cell (i,j) equals
    # [Ix2(i-1,j) > Ix1(i-1,j)], which is exactly the previous diagonal's
    # collapsed stay, shifted — carried in psx/psy rows (the x side shifts
    # one lane, the y side doesn't).  ~35% fewer VPU ops per cell in the
    # hot scores mode (VERDICT r2 item 1).
    collapsed = k == 2
    kc = 1 if collapsed else k
    track_stay = collapsed and traceback
    local = mode == "local"
    semi = mode == "semiglobal"
    if mode not in ("global", "semiglobal", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    superstep = ring_axis is not None and ring_interval > 1
    if superstep and hrow_fn is None:
        raise ValueError("superstepped ring requires a streamed score producer")
    if superstep and D >= (1 << 24):
        # The deferred terminal merge reduces (i, j) through f32 pmax,
        # exact only below 2^24.
        raise ValueError("superstepped ring terminal merge supports "
                         "Lx + Ly < 2^24; use ring_interval=1 beyond")
    if ckpt_interval is not None and hrow_fn is None:
        raise ValueError("checkpointed traceback requires a streamed producer")
    if ckpt_interval is not None and ring_axis is not None and (
        ring_interval <= 1 or not traceback
    ):
        raise ValueError("ring checkpointed traceback requires the "
                         "superstepped exchange (interval > 1) and "
                         "traceback=True")
    # Deferred terminal reduction: per-device candidates, one final merge.
    defer = superstep

    # Padding: streamed/superstep chunking pads the diagonal range up to a
    # chunk multiple; padded-d border costs index past D (harmless but kept
    # in bounds by the clip below).
    dpad = max(64, ring_interval, ckpt_interval or 0)
    cum = jnp.asarray(_gap_prefix(gap_series, D + dpad), dtype=jnp.float32)
    lane = jnp.arange(Lp, dtype=jnp.int32)[None, :]  # (1, Lp)
    if ring_axis is not None:
        lane = lane + lane_base  # GLOBAL lane ids on this device's shard
    zeros = jnp.zeros((B, Lp), jnp.float32)
    negs = jnp.full((B, Lp), NEG, jnp.float32)

    # ---- carries at d = 1 (cells (0,1) lane 0 and (1,0) lane 1) ----
    border_m = 0.0 if local else NEG
    m1 = jnp.where((lane == 0) | (lane == 1), jnp.float32(border_m), negs)
    lm1 = zeros
    ix1 = [negs for _ in range(kc)]
    iy1 = [negs for _ in range(kc)]
    lix1 = [zeros for _ in range(kc)]
    liy1 = [zeros for _ in range(kc)]
    if not local:
        bval = jnp.float32(0.0) if semi else -cum[1]
        # (1,0) is an Ix run of length 1 (level 1); (0,1) an Iy run.
        ix1[0] = jnp.where(lane == 1, bval, negs)
        iy1[0] = jnp.where(lane == 0, bval, negs)
        lix1[0] = jnp.where(lane == 1, 1.0, zeros)
        liy1[0] = jnp.where(lane == 0, 1.0, zeros)
    # Best-state reduces: r2* = diag 0 (only cell (0,0), M = 0);
    # r1* = diag 1 (reduced from the border states initialized above).
    r2v = jnp.where(lane == 0, 0.0, negs)
    r2l = zeros
    r2c = jnp.zeros((B, Lp), jnp.int32)
    # Collapsed init: the d=1 border runs are level-1 states (stay = 0).
    r1v, r1l, r1c = _priority_select(
        m1, ix1, iy1, lm1, lix1, liy1,
        codes_x=[1] if collapsed else None,
        codes_y=[1 + k] if collapsed else None,
    )
    psx0 = psy0 = jnp.zeros((B, Lp), jnp.int32)

    # ---- terminal trackers ----
    tval = jnp.full((B,), NEG, jnp.float32)
    tlen = jnp.zeros((B,), jnp.float32)
    ti = jnp.zeros((B,), jnp.int32)
    tj = jnp.zeros((B,), jnp.int32)
    tcode = jnp.zeros((B,), jnp.int32)
    if semi:
        # diag-1 border cells are terminal candidates when a side has
        # length 1; prefer larger i: (1, 0) over (0, 1).
        pick_y = ly == 1  # candidate (0, 1), an Iy cell
        tval = jnp.where(pick_y, 0.0, tval)
        tlen = jnp.where(pick_y, 1.0, tlen)
        ti = jnp.where(pick_y, 0, ti)
        tj = jnp.where(pick_y, 1, tj)
        tcode = jnp.where(pick_y, 1 + k, tcode)
        pick_x = lx == 1  # candidate (1, 0), an Ix cell
        tval = jnp.where(pick_x, 0.0, tval)
        tlen = jnp.where(pick_x, 1.0, tlen)
        ti = jnp.where(pick_x, 1, ti)
        tj = jnp.where(pick_x, 0, tj)
        tcode = jnp.where(pick_x, 1, tcode)

    _ring_perm = [(i, i + 1) for i in range(ring_n - 1)]

    def shift_v(v):  # lane i <- lane i-1, NEG fill (single-device form)
        return jnp.concatenate([jnp.full_like(v[:, :1], NEG), v[:, :-1]], axis=1)

    def shift_z(v):  # zero fill (lengths / codes)
        return jnp.concatenate([jnp.zeros_like(v[:, :1]), v[:, :-1]], axis=1)

    def shift_all(vals_v, vals_z, vals_zi, head=None):
        """Shift every carry vector one lane right in ONE exchange.

        ``vals_v`` fill with NEG, ``vals_z``/``vals_zi`` (float/int) with
        zero.  In ring mode all boundary lanes cross to the right
        neighbour as a single stacked ``ppermute`` (int arrays ride along
        bitcast to f32) instead of one collective per vector — per-step
        ring latency is what bounds a multi-device single alignment.
        Non-receivers of the incomplete perm get zeros; the first device
        (global lane 0) overwrites with the border fill.  In superstepped
        mode the incoming boundary stack arrives as ``head`` (prefetched a
        whole chunk at a time by the outer loop) and no per-step
        collective runs at all.
        """
        if ring_axis is None:
            return (
                [shift_v(v) for v in vals_v],
                [shift_z(v) for v in vals_z],
                [shift_z(v) for v in vals_zi],
            )
        if head is None:
            tails = [v[:, -1] for v in vals_v] + [v[:, -1] for v in vals_z] + [
                jax.lax.bitcast_convert_type(v[:, -1], jnp.float32)
                for v in vals_zi
            ]
            recv = jax.lax.ppermute(jnp.stack(tails), ring_axis, _ring_perm)
        else:
            recv = head
        first = lane_base == 0
        out_v, out_z, out_zi = [], [], []
        i = 0
        for v in vals_v:
            head = jnp.where(first, NEG, recv[i])[:, None]
            out_v.append(jnp.concatenate([head, v[:, :-1]], axis=1))
            i += 1
        for v in vals_z:
            head = jnp.where(first, jnp.zeros((), v.dtype), recv[i])[:, None]
            out_z.append(jnp.concatenate([head, v[:, :-1]], axis=1))
            i += 1
        for v in vals_zi:
            bits = jax.lax.bitcast_convert_type(recv[i], v.dtype)
            head = jnp.where(first, jnp.zeros((), v.dtype), bits)[:, None]
            out_zi.append(jnp.concatenate([head, v[:, :-1]], axis=1))
            i += 1
        return out_v, out_z, out_zi

    def pick_lane(v, idx, fill):
        """v (B, Lp), idx (B,) -> (B,): value at lane idx via a masked
        reduce (one-hot max) rather than a gather.  In ring
        mode the wanted lane lives on exactly one device; a pmax over the
        ring finishes the reduce."""
        mask = lane == idx[:, None]
        got = jnp.max(jnp.where(mask, v, fill), axis=1)
        if ring_axis is not None and not defer:
            got = jax.lax.pmax(got, ring_axis)
        return got

    def take_lane(v, idx):
        return pick_lane(v, idx, NEG)

    def take_triple(bv, bl, bc, idx):
        """(value, length, code) at lane ``idx`` — in ring mode all three
        finish in ONE stacked pmax instead of three."""
        mask = lane == idx[:, None]
        v = jnp.max(jnp.where(mask, bv, NEG), axis=1)
        l = jnp.max(jnp.where(mask, bl, NEG), axis=1)
        c = jnp.max(jnp.where(mask, bc.astype(jnp.float32), -1.0), axis=1)
        if ring_axis is not None and not defer:
            st = jax.lax.pmax(jnp.stack([v, l, c]), ring_axis)
            v, l, c = st[0], st[1], st[2]
        return v, l, c.astype(jnp.int32)

    def step(carry, inp):
        d, hrow = inp[0], inp[1]
        head = inp[2] if len(inp) > 2 else None
        if track_stay:
            (
                m1, ix1, iy1, lm1, lix1, liy1,
                r1v, r1l, r1c, r2v, r2l, r2c, psx, psy,
                tval, tlen, ti, tj, tcode,
            ) = carry
        else:
            (
                m1, ix1, iy1, lm1, lix1, liy1,
                r1v, r1l, r1c, r2v, r2l, r2c,
                tval, tlen, ti, tj, tcode,
            ) = carry

        zi = [r2c] + ([psx] if track_stay else [])
        sv, sz, szi = shift_all(
            [m1, r2v] + list(ix1), [lm1, r2l] + list(lix1), zi, head
        )
        m1s, b2vs = sv[0], sv[1]
        ix1_sh = sv[2:]
        lm1s, b2ls = sz[0], sz[1]
        lix1_sh = sz[2:]
        b2cs = szi[0]
        psxs = szi[1] if track_stay else None

        # ---- gap states for diag d ----
        nix = [None] * kc
        niy = [None] * kc
        nlix = [None] * kc
        nliy = [None] * kc
        if collapsed:
            # 3-state collapse (see module-level note above): one
            # max-of-levels row per side; ``sx``/``sy`` are the chosen
            # levels minus one AND the next step's bit-5/6 stay values.
            ix1s, lix1s = ix1_sh[0], lix1_sh[0]
            open_x = m1s - g[0]
            ext_x = ix1s - g[1]
            sx = ext_x > open_x
            nix[0] = jnp.where(sx, ext_x, open_x)
            nlix[0] = jnp.where(sx, lix1s, lm1s) + 1.0
            open_y = m1 - g[0]
            ext_y = iy1[0] - g[1]
            sy = ext_y > open_y
            niy[0] = jnp.where(sy, ext_y, open_y)
            nliy[0] = jnp.where(sy, liy1[0], lm1) + 1.0
        elif k == 1:
            ix1s, lix1s = ix1_sh[0], lix1_sh[0]
            stay_x = ix1s > m1s
            nix[0] = jnp.where(stay_x, ix1s, m1s) - g[0]
            nlix[0] = jnp.where(stay_x, lix1s, lm1s) + 1.0
            stay_y = iy1[0] > m1
            niy[0] = jnp.where(stay_y, iy1[0], m1) - g[0]
            nliy[0] = jnp.where(stay_y, liy1[0], lm1) + 1.0
        else:
            ix1s = list(ix1_sh)
            lix1s = list(lix1_sh)
            nix[0] = m1s - g[0]
            nlix[0] = lm1s + 1.0
            niy[0] = m1 - g[0]
            nliy[0] = lm1 + 1.0
            for l in range(1, k - 1):
                nix[l] = ix1s[l - 1] - g[l]
                nlix[l] = lix1s[l - 1] + 1.0
                niy[l] = iy1[l - 1] - g[l]
                nliy[l] = liy1[l - 1] + 1.0
            stay_x = ix1s[k - 1] > ix1s[k - 2]
            nix[k - 1] = jnp.where(stay_x, ix1s[k - 1], ix1s[k - 2]) - g[k - 1]
            nlix[k - 1] = jnp.where(stay_x, lix1s[k - 1], lix1s[k - 2]) + 1.0
            stay_y = iy1[k - 1] > iy1[k - 2]
            niy[k - 1] = jnp.where(stay_y, iy1[k - 1], iy1[k - 2]) - g[k - 1]
            nliy[k - 1] = jnp.where(stay_y, liy1[k - 1], liy1[k - 2]) + 1.0

        # ---- M state ----
        nm = hrow + b2vs
        nlm = b2ls + 1.0
        mcode = b2cs
        if local:
            clamp = nm < 0.0
            nm = jnp.where(clamp, 0.0, nm)
            mcode = jnp.where(clamp, PTR_NONE, mcode)
            # Length restarts at ANY zero-valued M cell (clamped or exact
            # zero): the oracle traceback stops there (§8.3), so the path
            # length of the best local alignment is counted from it.
            nlm = jnp.where(nm <= 0.0, 0.0, nlm)

        # ---- borders: lane 0 = cell (0, d), lane d = cell (d, 0) ----
        at0 = lane == 0
        atd = lane == d
        nm = jnp.where(at0 | atd, jnp.float32(border_m), nm)
        nlm = jnp.where(at0 | atd, 0.0, nlm)
        d_f = d.astype(jnp.float32)
        if not collapsed:
            lvl_d = jnp.minimum(d, k)  # border run level (1-based)
        for l in range(kc):
            if local:
                # local borders carry no gap states
                nix[l] = jnp.where(at0 | atd, NEG, nix[l])
                niy[l] = jnp.where(at0 | atd, NEG, niy[l])
                nlix[l] = jnp.where(at0 | atd, 0.0, nlix[l])
                nliy[l] = jnp.where(at0 | atd, 0.0, nliy[l])
            elif collapsed:
                # steps start at d=2, so the border run level is always 2
                # (= k); the collapsed max-state just takes the border cost.
                bx = jnp.float32(0.0) if semi else -cum[d]
                nix[0] = jnp.where(atd, bx, jnp.where(at0, NEG, nix[0]))
                niy[0] = jnp.where(at0, bx, jnp.where(atd, NEG, niy[0]))
                nlix[0] = jnp.where(atd, d_f, jnp.where(at0, 0.0, nlix[0]))
                nliy[0] = jnp.where(at0, d_f, jnp.where(atd, 0.0, nliy[0]))
            else:
                bx = jnp.float32(0.0) if semi else -cum[d]
                on_lvl = lvl_d == l + 1
                # (d, 0) is an Ix border run (level min(d, k)); (0, d) an Iy run.
                nix[l] = jnp.where(
                    atd, jnp.where(on_lvl, bx, NEG), jnp.where(at0, NEG, nix[l])
                )
                niy[l] = jnp.where(
                    at0, jnp.where(on_lvl, bx, NEG), jnp.where(atd, NEG, niy[l])
                )
                nlix[l] = jnp.where(atd, d_f, jnp.where(at0, 0.0, nlix[l]))
                nliy[l] = jnp.where(at0, d_f, jnp.where(atd, 0.0, nliy[l]))

        # ---- reduce for the d+2 step and for terminals ----
        if collapsed:
            # Post-border stay: a (d,0) border cell IS a level-2 (k) run;
            # (0,d) carries no Ix at all (and symmetrically for Iy).
            if local:
                border = at0 | atd
                sx = sx & ~border
                sy = sy & ~border
            else:
                # boolean algebra rather than where(pred, True, ...)
                sx = atd | (sx & ~at0)
                sy = at0 | (sy & ~atd)
            sxi = sx.astype(jnp.int32)
            syi = sy.astype(jnp.int32)
            bv, bl, bc = _priority_select(
                nm, nix, niy, nlm, nlix, nliy,
                codes_x=[1 + sxi], codes_y=[1 + k + syi],
            )
        else:
            bv, bl, bc = _priority_select(nm, nix, niy, nlm, nlix, nliy)

        # ---- terminal tracking ----
        if mode == "global":
            pick = d == (lx + ly)
            cv, cl, cc = take_triple(bv, bl, bc, lx)
            tval = jnp.where(pick, cv, tval)
            tlen = jnp.where(pick, cl, tlen)
            tcode = jnp.where(pick, cc, tcode)
            ti = jnp.where(pick, lx, ti)
            tj = jnp.where(pick, ly, tj)
        elif semi:
            # candidate A: last-column cell (d - ly, ly), evaluated first
            # (smaller i than candidate B at the same step).
            for cand_i, cand_j, ok in (
                (d - ly, ly, (d - ly >= 0) & (d - ly <= lx)),
                (lx, d - lx, (d - lx >= 0) & (d - lx <= ly)),
            ):
                cv, cl, cc = take_triple(bv, bl, bc, cand_i)
                better = cv > tval
                tie = (cv == tval) & (
                    (cand_i > ti) | ((cand_i == ti) & (cand_j > tj))
                )
                repl = ok & (better | tie)
                tval = jnp.where(repl, cv, tval)
                tlen = jnp.where(repl, cl, tlen)
                tcode = jnp.where(repl, cc, tcode)
                ti = jnp.where(repl, cand_i, ti)
                tj = jnp.where(repl, cand_j, tj)
        else:  # local: running argmax over interior M cells
            valid = (lane >= 1) & (lane <= lx[:, None]) & (d - lane >= 1) & (
                d - lane <= ly[:, None]
            )
            mv = jnp.where(valid, nm, NEG)
            step_best = jnp.max(mv, axis=1)
            # first max = min global lane (the pinned smallest-i tie-break)
            loc_arg = jnp.argmax(mv, axis=1).astype(jnp.int32)
            if ring_axis is not None and not defer:
                loc_arg = loc_arg + lane_base
                gbest = jax.lax.pmax(step_best, ring_axis)
                big = jnp.int32(2**30)
                cand = jnp.where(step_best == gbest, loc_arg, big)
                step_arg = jax.lax.pmin(cand, ring_axis)
                step_best = gbest
            elif ring_axis is not None:
                # Deferred: keep the device-local best; the end-of-scan
                # lexicographic merge applies the same smallest-(i, j) rule.
                step_arg = loc_arg + lane_base
            else:
                step_arg = loc_arg
            step_len = take_lane(nlm, step_arg)
            cj = d - step_arg
            better = step_best > tval
            tie = (step_best == tval) & (
                (step_arg < ti) | ((step_arg == ti) & (cj < tj))
            )
            repl = better | tie
            tval = jnp.where(repl, step_best, tval)
            tlen = jnp.where(repl, step_len, tlen)
            ti = jnp.where(repl, step_arg, ti)
            tj = jnp.where(repl, cj, tj)
            # tcode stays 0: local terminals are M cells.

        new_carry = (
            nm, nix, niy, nlm, nlix, nliy,
            bv, bl, bc, r1v, r1l, r1c,
        ) + ((sxi, syi) if track_stay else ()) + (
            tval, tlen, ti, tj, tcode,
        )

        if traceback:
            bits = mcode.astype(jnp.uint8)
            if local:
                # bit 7 = "this M cell's value <= 0": the ONLY
                # value-dependent decision in the local stop-at-zero walk
                # (oracle semantics: entering an M cell worth <= 0 ends the
                # path before emitting it) — with it, local traceback
                # replays on DEVICE like global/semiglobal (kernels.replay).
                bits = bits | ((nm <= 0.0).astype(jnp.uint8) << 7)
            if collapsed:
                # bit 5 = previous diagonal's x-stay SHIFTED one lane
                # (cell (i-1, j)); bit 6 = previous diagonal's y-stay at
                # the same lane (cell (i, j-1)) — exactly the per-level
                # form's [level2 > level1] compares.
                bits = bits | (psxs.astype(jnp.uint8) << 5)
                bits = bits | (psy.astype(jnp.uint8) << 6)
            else:
                bits = bits | (stay_x.astype(jnp.uint8) << 5)
                bits = bits | (stay_y.astype(jnp.uint8) << 6)
            return new_carry, bits
        return new_carry, None

    carry = (
        m1, ix1, iy1, lm1, lix1, liy1,
        r1v, r1l, r1c, r2v, r2l, r2c,
    ) + ((psx0, psy0) if track_stay else ()) + (
        tval, tlen, ti, tj, tcode,
    )
    if superstep and ckpt_interval is None:
        # Pipelined blocked wavefront: device p runs diagonal chunk c
        # during superstep s = c + p.  Within a superstep the inner scan
        # consumes the K boundary stacks received LAST superstep (device
        # p-1 ran the same chunk then) and records its own entry-carry
        # tails, which cross in one ppermute at the end of the superstep.
        # Invalid (pipeline fill/drain) supersteps compute garbage whose
        # whole carry is discarded by a select, so state and terminals
        # stay exact.  The chunk materialization also preserves the
        # nested-scan rounding pin of the streamed producer.
        K = ring_interval
        nchunks = -(-(D - 2) // K)
        nsuper = nchunks + ring_n - 1
        p_rank = jax.lax.axis_index(ring_axis).astype(jnp.int32)
        nvec = 2 * (2 + kc) + 1 + (1 if track_stay else 0)
        heads0 = jnp.zeros((K, nvec, B), jnp.float32)

        def _tails_of(c):
            m1_, ix1_, lm1_, lix1_ = c[0], c[1], c[3], c[4]
            r2v_, r2l_, r2c_ = c[9], c[10], c[11]
            tails = (
                [m1_[:, -1], r2v_[:, -1]] + [v[:, -1] for v in ix1_]
                + [lm1_[:, -1], r2l_[:, -1]] + [v[:, -1] for v in lix1_]
                + [jax.lax.bitcast_convert_type(r2c_[:, -1], jnp.float32)]
            )
            if track_stay:  # psx crosses like every shifted x-side carry
                tails.append(
                    jax.lax.bitcast_convert_type(c[12][:, -1], jnp.float32)
                )
            return jnp.stack(tails)

        def superstep_fn(sc, s):
            c0, heads = sc
            cidx = s - p_rank
            ds = 2 + cidx * K + jnp.arange(K, dtype=jnp.int32)
            # Clip into the cum/border-cost pad range; clipped steps only
            # ever run inside discarded (invalid) or past-terminal work.
            ds = jnp.clip(ds, 2, D + dpad - 2)
            # hband_fn: whole-chunk score production in ONE matmul
            # (dist.ring) instead of K per-diagonal window dots —
            # bit-equal for every in-range diagonal (exact-integer H).
            hs_chunk = hband_fn(ds) if hband_fn is not None else jax.vmap(hrow_fn)(ds)

            def inner(ic, inp):
                tails = _tails_of(ic)
                new_ic, bits = step(ic, inp)
                return new_ic, (tails, bits)

            new_c, (tails, bits) = jax.lax.scan(
                inner, c0, (ds, hs_chunk, heads)
            )
            valid = (cidx >= 0) & (cidx < nchunks)
            merged = jax.tree.map(
                lambda a, b: jnp.where(valid, a, b), new_c, c0
            )
            new_heads = jax.lax.ppermute(tails, ring_axis, _ring_perm)
            return (merged, new_heads), bits

        (carry, _), tb = jax.lax.scan(
            superstep_fn, (carry, heads0),
            jnp.arange(nsuper, dtype=jnp.int32),
        )
        # tb stays in (superstep, step-in-chunk, B, lane) layout; the ring
        # wrapper re-skews it to (diagonal, B, lane) on the host.
    elif superstep and ckpt_interval is not None:
        # ---- checkpointed traceback ON THE RING (SURVEY.md §3.2 ring
        # row; VERDICT r2 item 6): one giant alignment gets BOTH the
        # multi-device capacity and the O(L^1.5) traceback memory bound.
        # The forward superstepped pass snapshots each device's entry
        # carry + incoming head stack every per_blk chunks; the backward
        # pass replays each R-diagonal block as a mini pipeline (the same
        # step closure and the same exchange schedule reproduce identical
        # bits), all-gathers only that block's lane-sharded bits
        # (O(R * Lp), never O(D * Lp)), and walks the move tape block by
        # block, replicated on every device. ----
        K = ring_interval
        R = -(-int(ckpt_interval) // K) * K  # block = whole supersteps
        per_blk = R // K
        nchunks = -(-(D - 2) // K)
        nblocks = -(-nchunks // per_blk)
        nsuper = nchunks + ring_n - 1
        p_rank = jax.lax.axis_index(ring_axis).astype(jnp.int32)
        nvec = 2 * (2 + kc) + 1 + (1 if track_stay else 0)
        heads0 = jnp.zeros((K, nvec, B), jnp.float32)
        bidx = jnp.arange(B, dtype=jnp.int32)

        def _tails_of(c):
            m1_, ix1_, lm1_, lix1_ = c[0], c[1], c[3], c[4]
            r2v_, r2l_, r2c_ = c[9], c[10], c[11]
            tails = (
                [m1_[:, -1], r2v_[:, -1]] + [v[:, -1] for v in ix1_]
                + [lm1_[:, -1], r2l_[:, -1]] + [v[:, -1] for v in lix1_]
                + [jax.lax.bitcast_convert_type(r2c_[:, -1], jnp.float32)]
            )
            if track_stay:
                tails.append(
                    jax.lax.bitcast_convert_type(c[12][:, -1], jnp.float32)
                )
            return jnp.stack(tails)

        def superstep_chunk(c0, heads, cidx, ok):
            """One superstep's inner scan: returns (merged, tails, bits)."""
            ds = jnp.clip(
                2 + cidx * K + jnp.arange(K, dtype=jnp.int32), 2, D + dpad - 2
            )
            hs_chunk = (
                hband_fn(ds) if hband_fn is not None else jax.vmap(hrow_fn)(ds)
            )

            def inner(ic, inp):
                tails = _tails_of(ic)
                new_ic, bits = step(ic, inp)
                return new_ic, (tails, bits)

            new_c, (tails, bits) = jax.lax.scan(inner, c0, (ds, hs_chunk, heads))
            keep = ok & (cidx >= 0) & (cidx < nchunks)
            merged = jax.tree.map(
                lambda a, b: jnp.where(keep, a, b), new_c, c0
            )
            return merged, tails, bits

        # ---- forward pass with per-block snapshots ----
        snap0 = jax.tree.map(
            lambda a: jnp.zeros((nblocks,) + a.shape, a.dtype), carry
        )
        hsnap0 = jnp.zeros((nblocks, K, nvec, B), jnp.float32)

        def fwd(sc, s):
            c0, heads, snaps, hsnaps = sc
            cidx = s - p_rank
            at_blk = (cidx >= 0) & (cidx < nchunks) & (cidx % per_blk == 0)
            blk = jnp.clip(cidx // per_blk, 0, nblocks - 1)

            def upd(buf, leaf):
                cur = jax.lax.dynamic_index_in_dim(buf, blk, 0, keepdims=False)
                new = jax.tree.map(
                    lambda a, b: jnp.where(at_blk, a, b), leaf, cur
                )
                return jax.lax.dynamic_update_index_in_dim(buf, new, blk, 0)

            snaps = jax.tree.map(upd, snaps, c0)
            hsnaps = upd(hsnaps, heads)
            merged, tails, _bits = superstep_chunk(c0, heads, cidx, True)
            new_heads = jax.lax.ppermute(tails, ring_axis, _ring_perm)
            return (merged, new_heads, snaps, hsnaps), None

        (carry, _, snaps, hsnaps), _ = jax.lax.scan(
            fwd, (carry, heads0, snap0, hsnap0),
            jnp.arange(nsuper, dtype=jnp.int32),
        )
        tval, tlen, ti, tj, tcode = carry[-5:]
        tval, tlen, ti, tj, tcode = _ring_terminal_merge(
            tval, tlen, ti, tj, tcode, local, ring_axis
        )

        # ---- backward: replay block, all-gather its bits, walk ----
        from .replay import _walk_init, _walk_step

        st0, lvl0 = _walk_init(tcode, k)
        Lp_g = Lp * ring_n  # global (padded) lane count

        def bwd(rc, b):
            entry = jax.tree.map(lambda a: a[b], snaps)
            heads_e = hsnaps[b]

            def mini(sc, r):
                c0, heads = sc
                cloc = r - p_rank
                merged, tails, bits = superstep_chunk(
                    c0, heads, b * per_blk + cloc,
                    (cloc >= 0) & (cloc < per_blk),
                )
                new_heads = jax.lax.ppermute(tails, ring_axis, _ring_perm)
                return (merged, new_heads), bits

            _, bits_steps = jax.lax.scan(
                mini, (entry, heads_e),
                jnp.arange(per_blk + ring_n - 1, dtype=jnp.int32),
            )
            # Device p produced chunk c's bits at mini superstep c + p.
            bits_loc = jnp.take(
                bits_steps,
                jnp.arange(per_blk, dtype=jnp.int32) + p_rank,
                axis=0,
            ).reshape(R, B, Lp)
            bits_full = jax.lax.all_gather(
                bits_loc, ring_axis, axis=2, tiled=True
            )

            def rstep(c, _):
                i, j, st, lvl, done = c
                d = i + j
                blk_i = (d - 2) // R
                inwin = (blk_i == b) | ((d - 2 < 0) & (b == 0))
                r = jnp.clip(d - 2 - b * R, 0, R - 1)
                cell = bits_full[
                    r, bidx, jnp.clip(i, 0, Lp_g - 1)
                ].astype(jnp.int32)
                (ni, nj, nst, nlvl, ndone), mv = _walk_step(
                    cell, i, j, st, lvl, done, k, local=local
                )
                adv = inwin & ~done
                nc = (
                    jnp.where(adv, ni, i),
                    jnp.where(adv, nj, j),
                    jnp.where(adv, nst, st),
                    jnp.where(adv, nlvl, lvl),
                    jnp.where(inwin, ndone, done),
                )
                return nc, jnp.where(adv, mv, jnp.uint8(0))

            rc, mvs = jax.lax.scan(rstep, rc, None, length=R + 1)
            return rc, mvs

        rc0 = (
            ti.astype(jnp.int32), tj.astype(jnp.int32),
            st0, lvl0, jnp.zeros((B,), bool),
        )
        _, mvs = jax.lax.scan(
            bwd, rc0, jnp.arange(nblocks - 1, -1, -1, dtype=jnp.int32)
        )
        mvs = jnp.transpose(mvs.reshape(nblocks * (R + 1), B), (1, 0))
        nz = mvs != 0
        S = mvs.shape[1]
        tgt = jnp.where(nz, jnp.cumsum(nz.astype(jnp.int32), axis=1) - 1, S)
        moves = (
            jnp.zeros((B, S + 1), jnp.uint8)
            .at[bidx[:, None], tgt]
            .set(jnp.where(nz, mvs, jnp.uint8(0)))[:, :S]
        )
        nmoves = nz.sum(axis=1).astype(jnp.int32)
        return {
            "score": tval, "length": tlen, "ti": ti, "tj": tj,
            "tcode": tcode, "moves": moves, "nmoves": nmoves,
        }
    elif ckpt_interval is not None:
        # ---- checkpointed traceback (see wavefront_dp_checkpointed) ----
        R = ckpt_interval
        nchunks = -(-(D - 2) // R)
        bidx = jnp.arange(B, dtype=jnp.int32)

        def fwd(c_carry, cidx):
            d0 = 2 + cidx * R
            ds_chunk = d0 + jnp.arange(R, dtype=jnp.int32)
            hs_chunk = jax.vmap(hrow_fn)(ds_chunk)
            new_c, _bits = jax.lax.scan(step, c_carry, (ds_chunk, hs_chunk))
            return new_c, c_carry  # checkpoint = entry carry of the block

        carry, ckpts = jax.lax.scan(
            fwd, carry, jnp.arange(nchunks, dtype=jnp.int32)
        )
        tval, tlen, ti, tj, tcode = carry[-5:]

        from .replay import _walk_init, _walk_step

        st0, lvl0 = _walk_init(tcode, k)

        def bwd(rc, b):
            # Re-derive block b's direction bits from its checkpoint (the
            # same step closure => identical bits), then run up to R+1 walk
            # moves whose current diagonal falls inside this block.
            ck = jax.tree.map(lambda a: a[b], ckpts)
            d0 = 2 + b * R
            ds_chunk = d0 + jnp.arange(R, dtype=jnp.int32)
            hs_chunk = jax.vmap(hrow_fn)(ds_chunk)
            _, bits = jax.lax.scan(step, ck, (ds_chunk, hs_chunk))

            def rstep(c, _):
                i, j, st, lvl, done = c
                d = i + j
                blk = (d - 2) // R  # floor div: border moves below d=2 -> <0
                inwin = (blk == b) | ((d - 2 < 0) & (b == 0))
                r = jnp.clip(d - 2 - b * R, 0, R - 1)
                # 3-D gather as in replay.replay_moves: flat int32 index
                # arithmetic over R*B*Lp can overflow 2**31 once budget
                # tuning widens the dispatch (ADVICE r2).
                cell = bits[
                    r, bidx, jnp.clip(i, 0, Lp - 1)
                ].astype(jnp.int32)
                (ni, nj, nst, nlvl, ndone), mv = _walk_step(
                    cell, i, j, st, lvl, done, k, local=local
                )
                adv = inwin & ~done
                nc = (
                    jnp.where(adv, ni, i),
                    jnp.where(adv, nj, j),
                    jnp.where(adv, nst, st),
                    jnp.where(adv, nlvl, lvl),
                    jnp.where(inwin, ndone, done),
                )
                return nc, jnp.where(adv, mv, jnp.uint8(0))

            rc, mvs = jax.lax.scan(rstep, rc, None, length=R + 1)
            return rc, mvs  # (R + 1, B)

        rc0 = (
            ti.astype(jnp.int32), tj.astype(jnp.int32),
            st0, lvl0, jnp.zeros((B,), bool),
        )
        _, mvs = jax.lax.scan(
            bwd, rc0, jnp.arange(nchunks - 1, -1, -1, dtype=jnp.int32)
        )
        mvs = jnp.transpose(
            mvs.reshape(nchunks * (R + 1), B), (1, 0)
        )  # (B, S) terminal->origin with block-trailing zeros interleaved
        # Compact each tape: stable scatter of nonzero moves to the front
        # (moves_to_result expects the contiguous prefix).
        nz = mvs != 0
        S = mvs.shape[1]
        tgt = jnp.where(nz, jnp.cumsum(nz.astype(jnp.int32), axis=1) - 1, S)
        moves = (
            jnp.zeros((B, S + 1), jnp.uint8)
            .at[bidx[:, None], tgt]
            .set(jnp.where(nz, mvs, jnp.uint8(0)))[:, :S]
        )
        nmoves = nz.sum(axis=1).astype(jnp.int32)
        return {
            "score": tval, "length": tlen, "ti": ti, "tj": tj,
            "tcode": tcode, "moves": moves, "nmoves": nmoves,
        }
    elif hrow_fn is None:
        ds = jnp.arange(2, D, dtype=jnp.int32)
        carry, tb = jax.lax.scan(step, carry, (ds, hs[2:]))
    else:
        # Streamed production runs as a NESTED scan: the outer step
        # produces a chunk of score rows, the inner scan consumes them as
        # xs.  The chunk buffer crosses a while-loop boundary, so XLA
        # cannot contract the producer's final multiply into the DP's add
        # (FMA) — rounding stays bit-identical to the materialized path.
        # (A plain per-step hrow_fn(d) diverges by ulps on CPU: verified
        # 2026-08-17; optimization_barrier/bitcast do NOT stop it.)
        K = min(64, max(1, D - 2))
        nchunks = -(-(D - 2) // K)
        # Padded diagonals beyond D-1 compute garbage that can never win
        # a terminal (validity masks bound d by lx+ly).
        def outer(c_carry, cidx):
            d0 = 2 + cidx * K
            ds_chunk = d0 + jnp.arange(K, dtype=jnp.int32)
            hs_chunk = jax.vmap(hrow_fn)(ds_chunk)
            return jax.lax.scan(step, c_carry, (ds_chunk, hs_chunk))

        carry, tb = jax.lax.scan(outer, carry, jnp.arange(nchunks, dtype=jnp.int32))
        if traceback:
            tb = tb.reshape(nchunks * K, *tb.shape[2:])[: D - 2]
    tval, tlen, ti, tj, tcode = carry[-5:]

    if defer:
        tval, tlen, ti, tj, tcode = _ring_terminal_merge(
            tval, tlen, ti, tj, tcode, local, ring_axis
        )
    out = {"score": tval, "length": tlen, "ti": ti, "tj": tj, "tcode": tcode}
    if traceback:
        out["tb"] = tb
    return out


def _ring_terminal_merge(tval, tlen, ti, tj, tcode, local, ring_axis):
    """Merge per-device terminal candidates across the superstepped ring.

    Each candidate cell is owned by exactly one device, so the sequential
    tie-break order — larger (i, j) wins at equal score for semiglobal,
    smaller (i, j) for local, unique terminal for global — reduces to a
    lexicographic max over (score, ±i, ±j); the winner's payload (length,
    state code) then rides one stacked pmax.  Devices whose candidates all
    lost hold NEG scores and lose every stage."""
    sgn = jnp.float32(-1.0 if local else 1.0)
    gv = jax.lax.pmax(tval, ring_axis)
    on_v = tval == gv
    ki = jnp.where(on_v, sgn * ti.astype(jnp.float32), NEG)
    gi = jax.lax.pmax(ki, ring_axis)
    on_i = on_v & (ki == gi)
    kj = jnp.where(on_i, sgn * tj.astype(jnp.float32), NEG)
    gj = jax.lax.pmax(kj, ring_axis)
    win = on_i & (kj == gj)
    pay = jnp.stack([
        jnp.where(win, tlen, NEG),
        jnp.where(win, tcode.astype(jnp.float32), NEG),
    ])
    pay = jax.lax.pmax(pay, ring_axis)
    ti = (sgn * gi).astype(jnp.int32)
    tj = (sgn * gj).astype(jnp.int32)
    return gv, pay[0], ti, tj, pay[1].astype(jnp.int32)
