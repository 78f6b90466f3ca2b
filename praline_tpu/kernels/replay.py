"""Device-side traceback replay (SURVEY.md §9 P2 "on-device argmax replay").

The wavefront kernels emit packed direction bits per interior cell; round 1
pulled the whole O(L^2) bit tensor to the host and chased pointers in Python
(kernels.traceback), recomputing the pair score matrix per problem on the
way.  Here the walk itself runs on device as a batched ``lax.scan``: each
step gathers one byte per problem and advances a (i, j, state, level) state
machine that mirrors ``praline_tpu.oracle.align._traceback`` exactly, so
only a compact move tape (1 byte per emitted alignment column) ever crosses
the host boundary — ~2 orders of magnitude less transfer than the bit
tensor, and no host-side O(L^2) rework.

Covers ALL modes: global, semiglobal, and (round 3) local — the local
stop-at-zero rule's only value-dependent decision ("is this M cell worth
<= 0?") is emitted by the fill kernels as bit 7 of the direction byte, so
the walk needs no cell values.  kernels.traceback keeps the carried-value
host walk as the giant-problem fallback and as an independent
cross-check.

Move codes (emitted terminal -> origin, like the host walk's append order):
  0 = none (walk finished), 1 = diagonal (consume x and y),
  2 = up (consume x / gap in y), 3 = left (consume y / gap in x).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import GAP
from ..oracle.align import AlignResult

PTR_NONE = 31


def _walk_init(tcode, k):
    """Initial (state, level) of the walk from the terminal state code."""
    st0 = jnp.where(tcode == 0, 0, jnp.where(tcode <= k, 1, 2)).astype(jnp.int32)
    lvl0 = jnp.where(tcode <= k, tcode, tcode - k).astype(jnp.int32)
    return st0, lvl0


def _walk_step(bits, i, j, st, lvl, done, k, local=False):
    """One move of the traceback state machine for a batch of walks.

    ``bits`` int32[B]: the direction byte at each walk's current cell.
    Mirrors ``oracle.align._traceback`` exactly (shared by the full-tensor
    walk below and the checkpointed blockwise walk in kernels.scan).
    ``local`` activates the stop-at-zero rule via the kernel-emitted bit 7
    ("this M cell's value <= 0") — the walk then needs no cell values.
    Returns ``((ni, nj, nst, nlvl, ndone), move)``."""
    mptr = bits & 31
    stay_x = ((bits >> 5) & 1) == 1
    stay_y = ((bits >> 6) & 1) == 1

    is_m = (st == 0) & ~done
    is_ix = (st == 1) & ~done
    is_iy = (st == 2) & ~done

    at_origin = (i == 0) & (j == 0)
    stop = at_origin
    if local:  # entering an M cell worth <= 0 ends the path (§8.3)
        stop = stop | (((bits >> 7) & 1) == 1)
    m_stop = is_m & stop  # stop WITHOUT emitting this cell
    m_emit = is_m & ~stop

    # --- M: consume (i-1, j-1); next state from the stored pointer ---
    m_done = m_emit & (mptr == PTR_NONE)
    m_nst = jnp.where(mptr == 0, 0, jnp.where(mptr <= k, 1, 2))
    m_nlvl = jnp.where(mptr <= k, mptr, mptr - k)

    # --- Ix: consume (i-1, gap).  Border runs (j == 0) walk to origin
    # deterministically; interior cells follow the level machine with the
    # stay bit read at (i, j) before the move (oracle _traceback). ---
    ix_border = is_ix & (j == 0)
    ix_norm = is_ix & (j > 0)
    if k == 1:
        ixn_st = jnp.where(stay_x, 1, 0)
        ixn_lvl = jnp.where(stay_x, 1, 0)
    else:
        ixn_st = jnp.where(lvl == 1, 0, 1)
        ixn_lvl = jnp.where(
            lvl == 1, 0,
            jnp.where(lvl < k, lvl - 1, jnp.where(stay_x, k, k - 1)),
        )

    iy_border = is_iy & (i == 0)
    iy_norm = is_iy & (i > 0)
    if k == 1:
        iyn_st = jnp.where(stay_y, 2, 0)
        iyn_lvl = jnp.where(stay_y, 1, 0)
    else:
        iyn_st = jnp.where(lvl == 1, 0, 2)
        iyn_lvl = jnp.where(
            lvl == 1, 0,
            jnp.where(lvl < k, lvl - 1, jnp.where(stay_y, k, k - 1)),
        )

    consume_x = m_emit | is_ix
    consume_y = m_emit | is_iy
    ni = i - consume_x.astype(i.dtype)
    nj = j - consume_y.astype(j.dtype)

    nst = jnp.where(m_emit, m_nst, st)
    nst = jnp.where(ix_norm, ixn_st, nst)
    nst = jnp.where(iy_norm, iyn_st, nst)
    nlvl = jnp.where(m_emit, m_nlvl, lvl)
    nlvl = jnp.where(ix_norm, ixn_lvl, nlvl)
    nlvl = jnp.where(iy_norm, iyn_lvl, nlvl)
    # Border runs re-level from the remaining run length.
    nlvl = jnp.where(ix_border, jnp.minimum(ni, k), nlvl)
    nlvl = jnp.where(iy_border, jnp.minimum(nj, k), nlvl)

    ndone = done | m_stop | m_done
    ndone = ndone | (ix_border & (ni == 0)) | (iy_border & (nj == 0))
    # Interior gap cell stepping into M exactly at the origin.
    ndone = ndone | ((ix_norm | iy_norm) & (nst == 0) & (ni == 0) & (nj == 0))

    move = jnp.where(
        m_emit, 1, jnp.where(is_ix, 2, jnp.where(is_iy, 3, 0))
    ).astype(jnp.uint8)
    return (ni, nj, nst, nlvl, ndone), move


@functools.partial(
    jax.jit, static_argnames=("gap_series", "mode", "steps")
)
def replay_moves(
    tb: jax.Array,  # uint8[T, B, Lp], row t = diagonal t + 2
    ti: jax.Array,  # int32[B] terminal cell row
    tj: jax.Array,  # int32[B] terminal cell column
    tcode: jax.Array,  # int32[B] terminal state code
    gap_series: tuple[int, ...] = (11, 1),
    mode: str = "global",
    steps: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Walk the direction bits for a whole batch on device.

    Returns ``(moves, n)``: ``moves`` uint8[B, steps] in terminal->origin
    emission order and ``n`` int32[B] emitted-move counts.  ``steps`` must
    bound the longest walk (``lx + ly``; defaults to ``T + 1``).
    """
    if mode not in ("global", "semiglobal", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    local = mode == "local"
    T, B, Lp = tb.shape
    k = len(gap_series)
    bidx = jnp.arange(B, dtype=jnp.int32)
    if steps is None:
        steps = T + 1

    st0, lvl0 = _walk_init(tcode, k)

    def step(carry, _):
        i, j, st, lvl, done = carry
        d = i + j
        # 3-D gather, NOT a flattened index: a wide dispatch's tb tensor can
        # exceed 2**31 elements (e.g. 2048 x 1024 x 1024 at B=1024, L=1023),
        # where both the flat int32 index arithmetic and jnp's axis-size
        # constant for negative-index wrapping overflow int32.
        bits = tb[
            jnp.clip(d - 2, 0, T - 1), bidx, jnp.clip(i, 0, Lp - 1)
        ].astype(jnp.int32)
        return _walk_step(bits, i, j, st, lvl, done, k, local=local)

    init = (
        ti.astype(jnp.int32),
        tj.astype(jnp.int32),
        st0,
        lvl0,
        jnp.zeros((B,), bool),
    )
    _, moves = jax.lax.scan(step, init, None, length=steps)
    moves = jnp.transpose(moves, (1, 0))  # (B, steps)
    n = jnp.sum((moves != 0).astype(jnp.int32), axis=1)
    return moves, n


def moves_to_result(
    moves: np.ndarray,  # uint8[steps] for ONE problem
    n: int,
    score: float,
    ti: int,
    tj: int,
    lx: int,
    ly: int,
    mode: str,
) -> AlignResult:
    """Decode one move tape into an :class:`AlignResult`.

    Mirrors the host walk's list construction: the walk body emits
    terminal->origin; reversing gives origin->terminal; semiglobal appends
    the free trailing suffix (y tail then x tail in emission order, i.e.
    after reversal the main walk comes first, then tj..ly-1, then ti..lx-1 —
    identical to oracle/align._traceback).
    """
    m = moves[:n][::-1]
    takes_x = (m == 1) | (m == 2)
    takes_y = (m == 1) | (m == 3)
    cum_x = np.cumsum(takes_x).astype(np.int32)
    cum_y = np.cumsum(takes_y).astype(np.int32)
    # Global/semiglobal walks reach the origin, so cumulative counts ARE
    # absolute columns; a local walk starts mid-matrix at
    # (ti - #x-moves, tj - #y-moves) and needs that offset.
    offx = offy = 0
    if mode == "local" and n:
        offx = ti - int(cum_x[-1])
        offy = tj - int(cum_y[-1])
    cols_x = np.where(takes_x, cum_x - 1 + offx, GAP).astype(np.int32)
    cols_y = np.where(takes_y, cum_y - 1 + offy, GAP).astype(np.int32)
    if mode == "semiglobal":
        ytail = np.arange(tj, ly, dtype=np.int32)
        xtail = np.arange(ti, lx, dtype=np.int32)
        cols_x = np.concatenate(
            [cols_x, np.full(ytail.size, GAP, np.int32), xtail]
        )
        cols_y = np.concatenate(
            [cols_y, ytail, np.full(xtail.size, GAP, np.int32)]
        )
    xs = cols_x[cols_x != GAP]
    ys = cols_y[cols_y != GAP]
    x_range = (int(xs.min()), int(xs.max()) + 1) if xs.size else (0, 0)
    y_range = (int(ys.min()), int(ys.max()) + 1) if ys.size else (0, 0)
    return AlignResult(float(score), cols_x, cols_y, x_range, y_range, mode)
