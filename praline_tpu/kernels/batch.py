"""Batched pairwise-alignment driver: bucketing, padding, dispatch, unpack.

The reference runs its O(N^2) pairwise stage as a serial Python loop
(SURVEY.md C15 [B:5 "all-pairs scheduling (serial -> ...)"]); here arbitrary
collections of profile pairs are length-bucketed, padded, and dispatched to
the batched wavefront DP (kernels.scan) so thousands of problems run
data-parallel per device.  Padding is score-neutral by
construction: padded cells can never reach a terminal extracted at the true
lengths (SURVEY.md §9 hard part 3).

Degenerate problems (an empty side) route to the oracle's closed form.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence as Seq

import numpy as np

from ..types import Profile, ScoreMatrix
from ..types.config import BACKENDS
from ..oracle.align import AlignResult, _degenerate
from ..oracle.score import (
    EXACT_DOT_LIMIT,
    check_exactness,
    column_inverses,
)
from ..util.metrics import annotate
from .replay import moves_to_result, replay_moves


@dataclasses.dataclass(frozen=True)
class PairResult:
    """Scores-only result of one batched pairwise DP."""

    score: float
    length: float
    ti: int
    tj: int


def _dispatch_core(cx, inv_x, cy, inv_y, s, lx, ly, *, gap_series, mode,
                   traceback, backend, replay):
    """Score producer + wavefront DP (+ on-device traceback replay) — the
    shared body of every batched dispatch, traced inside one jit so each
    batch costs a single executable.  Scores-only dispatches on the
    "triton" backend run the lane-per-problem kernel (kernels.lane_dp)."""
    from .scan import wavefront_dp
    from .scores import skewed_pair_scores

    if backend == "triton" and not traceback:
        from .lane_dp import lane_dp_scores

        return lane_dp_scores(cx, inv_x, cy, inv_y, s, lx, ly,
                              gap_series=gap_series, mode=mode)
    hs = skewed_pair_scores(cx, inv_x, cy, inv_y, s)
    out = wavefront_dp(
        hs, lx, ly, gap_series=gap_series, mode=mode, traceback=traceback
    )
    if replay:
        moves, nmoves = replay_moves(
            out["tb"], out["ti"], out["tj"], out["tcode"],
            gap_series=gap_series, mode=mode,
            steps=cx.shape[1] + cy.shape[1],
        )
        out = {k: v for k, v in out.items() if k != "tb"}
        out["moves"] = moves
        out["nmoves"] = nmoves
    return out


def _gather_side(stack, inv, lens, idx, *, onehot, A):
    """Expand one side of an indexed batch on device: token rows one-hot to
    count tensors (pad token A -> zero column), narrow integer counts widen
    to f32."""
    import jax
    import jax.numpy as jnp

    l = jnp.take(lens, idx)
    if onehot:
        toks = jnp.take(stack, idx, axis=0).astype(jnp.int32)
        c = jax.nn.one_hot(toks, A, dtype=jnp.float32)
        iv = jnp.ones(c.shape[:2], jnp.float32)
    else:
        c = jnp.take(stack, idx, axis=0).astype(jnp.float32)
        iv = jnp.take(inv, idx, axis=0)
    return c, iv, l


def indexed_dispatch_body(sx, ivx, lensx, sy, ivy, lensy, ix, iy, s, *,
                          gap_series, mode, traceback, backend, replay,
                          onehot_x, onehot_y, A):
    """Gather-sides + dispatch core: the traced body shared by the
    single-device indexed jit and the sharded mesh dispatch
    (dist.allpairs.sharded_indexed_dispatch)."""
    cx, d_ivx, lx = _gather_side(sx, ivx, lensx, ix, onehot=onehot_x, A=A)
    cy, d_ivy, ly = _gather_side(sy, ivy, lensy, iy, onehot=onehot_y, A=A)
    return _dispatch_core(
        cx, d_ivx, cy, d_ivy, s, lx, ly,
        gap_series=gap_series, mode=mode, traceback=traceback,
        backend=backend, replay=replay,
    )


@functools.lru_cache(maxsize=1)
def _indexed_jit():
    """Indexed dispatch: problems are (ix, iy) rows into device-resident
    profile stacks, so each distinct profile crosses the host->device link
    exactly ONCE per stage instead of once per pair — the all-pairs stage
    ships O(N) profiles + O(N^2) int32 indices instead of O(N^2) padded
    count tensors (the round-1 transfer bottleneck).  One-hot stacks ship as
    token arrays (A-times smaller) and expand on device; integer count
    stacks ship narrow (uint8/uint16) and widen on device."""
    import jax

    return jax.jit(
        indexed_dispatch_body,
        static_argnames=(
            "gap_series", "mode", "traceback", "backend", "replay",
            "onehot_x", "onehot_y", "A",
        ),
    )


@functools.lru_cache(maxsize=1)
def _indexed_multi_jit():
    """Super-dispatch: n_sub sub-batches of the indexed body run inside ONE
    jit via ``lax.scan`` — each iteration's transient hs tensor is freed
    before the next, so the memory budget stays per-sub-batch while the
    per-dispatch launch and result pull are paid once for the whole
    group.  Outputs gain a leading (n_sub,) axis."""
    import jax

    @functools.partial(
        jax.jit,
        static_argnames=(
            "gap_series", "mode", "traceback", "backend", "replay",
            "onehot_x", "onehot_y", "A",
        ),
    )
    def run(sx, ivx, lensx, sy, ivy, lensy, ix2, iy2, s, *, gap_series, mode,
            traceback, backend, replay, onehot_x, onehot_y, A):
        def body(_, xs):
            ix, iy = xs
            out = indexed_dispatch_body(
                sx, ivx, lensx, sy, ivy, lensy, ix, iy, s,
                gap_series=gap_series, mode=mode, traceback=traceback,
                backend=backend, replay=replay,
                onehot_x=onehot_x, onehot_y=onehot_y, A=A,
            )
            return 0, out

        _, outs = jax.lax.scan(body, 0, (ix2, iy2))
        return outs

    return run


# Sub-batch grid for super-dispatch groups (largest first, greedy).
SUPER_DISPATCH_GRID = (8, 4, 2)


@functools.lru_cache(maxsize=1)
def _streamed_jit():
    """Oversized dispatch: the streamed-producer scan (no hs tensor) with
    optional on-device move replay — the route for problems past the
    materialized producer's memory budget (SURVEY.md §6 long-context
    row)."""
    import jax

    @functools.partial(
        jax.jit, static_argnames=("gap_series", "mode", "traceback", "replay")
    )
    def run(cx, inv_x, cy, inv_y, s, lx, ly, *, gap_series, mode, traceback,
            replay):
        from .replay import replay_moves
        from .scan import wavefront_dp_streamed

        out = wavefront_dp_streamed(
            cx, inv_x, cy, inv_y, s, lx, ly,
            gap_series=gap_series, mode=mode, traceback=traceback,
        )
        if replay:
            moves, nmoves = replay_moves(
                out["tb"], out["ti"], out["tj"], out["tcode"],
                gap_series=gap_series, mode=mode,
                steps=cx.shape[1] + cy.shape[1],
            )
            out = {k: v for k, v in out.items() if k != "tb"}
            out["moves"] = moves
            out["nmoves"] = nmoves
        return out

    return run


# Routing budgets, as fractions of the memory the device reports
# (``bytes_limit`` of ``memory_stats()``: on a GPU, the allocator's pool):
# one problem whose score tensors pass the HS share streams its scores
# (no materialized tensor); one whose traceback bits pass the TB share
# takes the checkpointed walk; a whole dispatch's batch shrinks (snapped to
# the batch grid, so no new executable shapes) until it fits the DISPATCH
# share, which leaves the rest for profile stacks, results in flight and
# XLA's workspace.
HS_BYTES_FRACTION = 1 / 16
TB_BYTES_FRACTION = 1 / 8
DISPATCH_BYTES_FRACTION = 1 / 2
# The CPU reports no memory; these fixed sizes keep the routing that the
# CPU tests exercise (and monkeypatch) where it is.
HS_BYTES_BUDGET = 1 << 30
TB_BYTES_BUDGET = 1 << 31
DISPATCH_BYTES_BUDGET = 11 << 30


@functools.lru_cache(maxsize=1)
def device_memory_bytes() -> int | None:
    """Memory of the default device, or None on the CPU (whose routing
    keeps the fixed budgets above).  An accelerator that reports no
    memory is an error: there is nothing to size the dispatches by."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return None
    stats = dev.memory_stats() or {}
    for key in ("bytes_limit", "bytes_reservable_limit"):
        if stats.get(key):
            return int(stats[key])
    raise RuntimeError(
        f"{dev.platform} device {dev.device_kind!r} reports no memory limit"
    )


def _budget(name: str) -> int:
    """Byte budget ``name`` ("HS", "TB" or "DISPATCH"): its fraction of the
    device's memory, or the fixed CPU constant.  Reads the module globals
    at call time so tests can monkeypatch them."""
    mem = device_memory_bytes()
    if mem is None:
        return globals()[f"{name}_BYTES_BUDGET"]
    return int(globals()[f"{name}_BYTES_FRACTION"] * mem)


def per_problem_bytes(bx: int, by: int) -> tuple[int, int]:
    """(score_bytes, tb_bytes) for ONE (bucket_x, bucket_y) problem on the
    materialized XLA route: two unskewed f32 score matrices (H_int and the
    scaled H) plus one skewed f32 score tensor — XLA's own buffer
    assignment for the dispatch, per problem, on an H100 (PERF.md) — and
    the uint8 traceback-bit tensor.  The dispatcher's routing/batch-cap
    logic and the batch-grid tests share this formula (a hand-copied
    estimate in a test would silently go stale)."""
    Lp = bx + 1
    return 4 * (2 * bx * by + (bx + by + 1) * Lp), (bx + by - 1) * Lp


def lane_dp_bytes(bx: int, by: int, A: int, k: int) -> int:
    """Device bytes ONE (bx, by) problem holds on the lane-kernel route:
    gathered f32 counts and their transposed copies (T and cy), the row
    state and the score-row scratch (kernels.lane_dp)."""
    kc = 1 if k == 2 else k
    return 4 * (4 * A * (bx + by) + (6 + 2 * kc) * (by + 1))


def _grid_step(b: int) -> int:
    """Next batch-grid size: powers of four to 512, then powers of two.

    The coarse pow4 grid bounds executable-shape variants for the ragged
    small-batch tail (each new executable costs a compile); pow2 steps at
    the top end let the widest dispatches land near the memory budget,
    where dispatch-latency amortization pays.
    """
    return b * 4 if b < 512 else b * 2


def _snap_batch(cap: int, batch_pairs: int) -> int:
    """Largest grid batch (32, 128, 512, 1024, 2048, ...) <= min(cap,
    batch_pairs); below the grid floor, the exact cap."""
    if cap < 32:
        return max(1, min(cap, batch_pairs))
    b = 32
    while _grid_step(b) <= min(cap, batch_pairs):
        b = _grid_step(b)
    return min(b, batch_pairs)


def composite_dispatch_body(sxs, ivxs, lensx, sys_, ivys, lensy, ix, iy,
                            ss, *, gap_series, mode, traceback, weights,
                            steps):
    """Indexed multi-track dispatch body: per-track profile stacks live on
    device, a chunk ships two int32 index vectors, and the composite
    skewed score tensor accumulates per track with PINNED rounding — the
    per-track weighted terms stack across a ``lax.scan`` boundary (a real
    buffer across the while loop), so XLA cannot FMA-contract a term's
    multiply into the running add (the exact hazard
    kernels.scores.composite_skewed_scores documents).  Traceback replays
    on device in every mode (bit 7 carries the local stop rule).  Shared
    by the single-device jit and the sharded mesh path
    (dist.allpairs.sharded_tracks_dispatch)."""
    import jax
    import jax.numpy as jnp

    from .scan import wavefront_dp
    from .scores import skewed_pair_scores

    lx = jnp.take(lensx, ix)
    ly = jnp.take(lensy, iy)

    terms = []
    for t, w in enumerate(weights):
        cx = jnp.take(sxs[t], ix, axis=0).astype(jnp.float32)
        ivx = jnp.take(ivxs[t], ix, axis=0)
        cy = jnp.take(sys_[t], iy, axis=0).astype(jnp.float32)
        ivy = jnp.take(ivys[t], iy, axis=0)
        terms.append(jnp.float32(w) * skewed_pair_scores(cx, ivx, cy, ivy, ss[t]))
    hs = terms[0]
    if len(terms) > 1:
        # Accumulate in track order through a scan: each add rounds on
        # a materialized term, bit-identical to the per-op-dispatch
        # oracle accumulation.
        hs, _ = jax.lax.scan(
            lambda acc, term: (acc + term, None),
            terms[0], jnp.stack(terms[1:]),
        )
    out = wavefront_dp(
        hs, lx, ly, gap_series=gap_series, mode=mode, traceback=traceback
    )
    if traceback:
        moves, nmoves = replay_moves(
            out["tb"], out["ti"], out["tj"], out["tcode"],
            gap_series=gap_series, mode=mode, steps=steps,
        )
        out = {k: v for k, v in out.items() if k != "tb"}
        out["moves"] = moves
        out["nmoves"] = nmoves
    return out


@functools.lru_cache(maxsize=1)
def _composite_indexed_jit():
    import jax

    return jax.jit(
        composite_dispatch_body,
        static_argnames=("gap_series", "mode", "traceback", "weights", "steps"),
    )


@functools.lru_cache(maxsize=1)
def _composite_multi_jit():
    """Trackset super-dispatch: lax.scan of n_sub sub-batches of the
    composite body in one jit (same latency amortization as
    _indexed_multi_jit); outputs gain a leading (n_sub,) axis."""
    import jax

    @functools.partial(
        jax.jit,
        static_argnames=("gap_series", "mode", "traceback", "weights", "steps"),
    )
    def run(sxs, ivxs, lensx, sys_, ivys, lensy, ix2, iy2, ss, *, gap_series,
            mode, traceback, weights, steps):
        def body(_, xs):
            ix, iy = xs
            return 0, composite_dispatch_body(
                sxs, ivxs, lensx, sys_, ivys, lensy, ix, iy, ss,
                gap_series=gap_series, mode=mode, traceback=traceback,
                weights=weights, steps=steps,
            )

        _, outs = jax.lax.scan(body, 0, (ix2, iy2))
        return outs

    return run


def align_tracksets_batched(
    pairs,
    matrices,
    weights,
    gap_series: tuple[int, ...],
    mode: str,
    *,
    traceback: bool = False,
    bucket_sizes: tuple[int, ...] = (63, 127, 255, 511, 1023, 2047),
    batch_pairs: int = 256,
    mesh=None,
) -> list:
    """Batched MULTI-TRACK composite alignment (SURVEY.md C4, §8.1).

    ``pairs`` is a list of ``(tracks_x, tracks_y)`` where each side is a
    tuple of parallel :class:`Profile` tracks (equal lengths per side);
    column score = sum_t weights[t] * score_t — the reference's composite
    score function (e.g. amino-acid + secondary-structure tracks).

    First-class since round 3 (VERDICT r2 item 8): tracksets ride the same
    machinery as the single-track hot path — length BUCKETING with padded
    per-track device stacks uploaded once per stage, INDEXED dispatch (a
    chunk ships two int32 vectors), batch-grid padding, on-device
    traceback replay in every mode, and an async in-flight queue.  Results
    stay bit-identical to ``oracle.align_tracksets`` per pair (rounding of
    the composite accumulation is pinned; see _composite_indexed_jit).
    """
    import jax
    import jax.numpy as jnp

    T = len(matrices)
    if len(weights) != T:
        raise ValueError("matrices and weights must align")
    if T == 0:
        raise ValueError("need at least one track")

    results: list = [None] * len(pairs)
    # Register distinct tracksets by identity (one stack row per side).
    # Keyed by the FULL tuple of track identities: two tracksets sharing the
    # same first-track Profile but differing in another track (e.g. one
    # amino-acid profile paired with two different secondary-structure
    # tracks) must get distinct rows (ADVICE r3).  ``reg`` keeps a reference
    # to every registered trackset, so the ids stay valid for the call.
    reg_pos: dict[tuple[int, ...], int] = {}
    reg: list[tuple] = []

    def _reg(ts) -> int:
        key = tuple(id(p) for p in ts)
        k = reg_pos.get(key)
        if k is None:
            k = len(reg)
            reg_pos[key] = k
            reg.append(tuple(ts))
        return k

    # Same predicate as oracle.score.check_exactness, on per-profile
    # cached totals (per-pair x per-track numpy scans cost host time per
    # dispatch).
    max_s_t = [float(np.abs(np.asarray(m.scores)).max(initial=0.0))
               for m in matrices]
    tot_cache: dict[int, float] = {}

    def _tot(p) -> float:
        v = tot_cache.get(id(p))
        if v is None:
            v = float(p.counts.sum(axis=1).max(initial=0.0))
            tot_cache[id(p)] = v
        return v

    groups: dict[tuple[int, int], list[int]] = {}
    pair_reg: list[tuple[int, int] | None] = [None] * len(pairs)
    for idx, (txs, tys) in enumerate(pairs):
        if len(txs) != T or len(tys) != T:
            raise ValueError("every pair needs one profile per track")
        Lx, Ly = txs[0].length, tys[0].length
        if any(p.length != Lx for p in txs) or any(p.length != Ly for p in tys):
            raise ValueError("parallel tracks must have equal lengths per side")
        if Lx == 0 or Ly == 0:
            r = _degenerate(Lx, Ly, gap_series, mode)
            results[idx] = r if traceback else PairResult(
                r.score, float(r.length), Lx, Ly
            )
            continue
        for px, py, m, ms in zip(txs, tys, matrices, max_s_t):
            if _tot(px) * _tot(py) * ms >= EXACT_DOT_LIMIT:
                check_exactness(px, py, m)  # raises with the full message
        pair_reg[idx] = (_reg(txs), _reg(tys))
        key = (_bucket(Lx, bucket_sizes), _bucket(Ly, bucket_sizes))
        groups.setdefault(key, []).append(idx)

    ss = tuple(jnp.asarray(m.as_f32()) for m in matrices)
    w = tuple(float(x) for x in weights)

    # Per-(bucket, side-set) padded track stacks, built once per call.
    stack_cache: dict[tuple[int, tuple[int, ...]], tuple] = {}

    def _stacks(b: int, ids: tuple[int, ...]):
        st = stack_cache.get((b, ids))
        if st is None:
            rows = 32
            while rows < len(ids):
                rows *= 2
            lens = np.ones(rows, np.int32)
            per_track_c, per_track_iv = [], []
            for t in range(T):
                profs = [reg[u][t] for u in ids]
                c, iv = _pad_counts(profs, b)
                if rows > len(profs):
                    c = np.concatenate(
                        [c, np.zeros((rows - len(profs), b, c.shape[2]), c.dtype)]
                    )
                    iv = np.concatenate(
                        [iv, np.ones((rows - len(profs), b), iv.dtype)]
                    )
                per_track_c.append(jnp.asarray(c))
                per_track_iv.append(jnp.asarray(iv))
            lens[: len(ids)] = [reg[u][0].length for u in ids]
            st = (
                tuple(per_track_c), tuple(per_track_iv), jnp.asarray(lens),
                lens, {u: r for r, u in enumerate(ids)},
            )
            stack_cache[(b, ids)] = st
        return st

    in_flight: list = []

    def _unpack_tracks(chunk, lx, ly, out) -> None:
        score = np.asarray(out["score"])
        length = np.asarray(out["length"])
        ti = np.asarray(out["ti"])
        tj = np.asarray(out["tj"])
        if mode == "semiglobal":
            length = length + (lx - ti) + (ly - tj)
        if traceback:
            for b, idx in enumerate(chunk):
                results[idx] = moves_to_result(
                    np.asarray(out["moves"])[b],
                    int(np.asarray(out["nmoves"])[b]),
                    float(score[b]), int(ti[b]), int(tj[b]),
                    int(lx[b]), int(ly[b]), mode,
                )
        else:
            # tolist() once per array (round 5: per-element np-scalar
            # conversions are milliseconds per thousand pairs)
            sc = score.tolist()
            ln = np.asarray(length).tolist()
            tis = ti.tolist()
            tjs = tj.tolist()
            for b, idx in enumerate(chunk):
                results[idx] = PairResult(sc[b], ln[b], tis[b], tjs[b])

    def drain(limit: int) -> None:
        while len(in_flight) > limit:
            chunk, lx, ly, out = in_flight.pop(0)
            out = jax.device_get(out)
            if isinstance(chunk[0], list):  # super-dispatch group
                for t, (sub, slx, sly) in enumerate(zip(chunk, lx, ly)):
                    _unpack_tracks(sub, slx, sly,
                                   {k: v[t] for k, v in out.items()})
            else:
                _unpack_tracks(chunk, lx, ly, out)

    for (bx, by), idxs in sorted(groups.items()):
        ids_x = tuple(sorted({pair_reg[i][0] for i in idxs}))
        ids_y = tuple(sorted({pair_reg[i][1] for i in idxs}))
        sxs, ivxs, lensx_d, lensx, pos_x = _stacks(bx, ids_x)
        sys_, ivys, lensy_d, lensy, pos_y = _stacks(by, ids_y)
        descs = []
        for start in range(0, len(idxs), batch_pairs):
            chunk = idxs[start : start + batch_pairs]
            target = 32
            while target < len(chunk):
                target = _grid_step(target)
            target = min(target, batch_pairs, max(len(chunk), 32))
            if mesh is not None:
                n_dev = int(np.prod(mesh.devices.shape))
                target = target + (-target) % n_dev
            pad = max(0, target - len(chunk))
            ix = np.array([pos_x[pair_reg[i][0]] for i in chunk], np.int32)
            iy = np.array([pos_y[pair_reg[i][1]] for i in chunk], np.int32)
            if pad:
                ix = np.concatenate([ix, np.full(pad, ix[0], np.int32)])
                iy = np.concatenate([iy, np.full(pad, iy[0], np.int32)])
            descs.append((chunk, ix, iy, lensx[ix], lensy[iy]))

        static = dict(
            gap_series=tuple(gap_series), mode=mode,
            traceback=traceback, weights=w, steps=bx + by,
        )
        di = 0
        while di < len(descs):
            chunk, ix, iy, lx, ly = descs[di]
            n_run = 1
            if mesh is None:
                while (
                    di + n_run < len(descs)
                    and len(descs[di + n_run][1]) == len(ix)
                ):
                    n_run += 1
            n_sub = next((g for g in SUPER_DISPATCH_GRID if g <= n_run), 1)
            if n_sub > 1:
                grp = descs[di : di + n_sub]
                ix2 = np.stack([d[1] for d in grp])
                iy2 = np.stack([d[2] for d in grp])
                with annotate(f"dispatch:tracks-super{n_sub}:{bx}x{by}"):
                    out = _composite_multi_jit()(
                        sxs, ivxs, lensx_d, sys_, ivys, lensy_d,
                        jnp.asarray(ix2), jnp.asarray(iy2), ss, **static,
                    )
                in_flight.append((
                    [d[0] for d in grp], [d[3] for d in grp],
                    [d[4] for d in grp], out,
                ))
                di += n_sub
                drain(16)
                continue
            if mesh is not None:
                from ..dist.allpairs import sharded_tracks_dispatch

                if _mesh_spans_processes(mesh):
                    # Multi-host SPMD: replicated per-track stacks and the
                    # sharded index vectors assemble into global jax.Arrays
                    # host-locally, exactly like align_pairs_batched's
                    # indexed path (ADVICE r3).
                    from jax.sharding import PartitionSpec as P

                    rep, pp = P(), P("pairs")
                    gsxs = tuple(_globalize(mesh, a, rep) for a in sxs)
                    givxs = tuple(_globalize(mesh, a, rep) for a in ivxs)
                    gsys = tuple(_globalize(mesh, a, rep) for a in sys_)
                    givys = tuple(_globalize(mesh, a, rep) for a in ivys)
                    gss = tuple(_globalize(mesh, a, rep) for a in ss)
                    glx = _globalize(mesh, lensx_d, rep)
                    gly = _globalize(mesh, lensy_d, rep)
                    gix = _globalize(mesh, ix, pp)
                    giy = _globalize(mesh, iy, pp)
                else:
                    gsxs, givxs, gsys, givys, gss = sxs, ivxs, sys_, ivys, ss
                    glx, gly = lensx_d, lensy_d
                    gix, giy = jnp.asarray(ix), jnp.asarray(iy)
                with annotate(f"dispatch:tracks-sharded:{bx}x{by}x{len(chunk)}"):
                    out = sharded_tracks_dispatch(
                        mesh, gsxs, givxs, glx, gsys, givys, gly,
                        gix, giy, gss, **static,
                    )
            else:
                with annotate(f"dispatch:tracks:{bx}x{by}x{len(chunk)}"):
                    out = _composite_indexed_jit()(
                        sxs, ivxs, lensx_d, sys_, ivys, lensy_d,
                        jnp.asarray(ix), jnp.asarray(iy), ss, **static,
                    )
            in_flight.append((chunk, lx, ly, out))
            di += 1
            drain(16)
    drain(0)
    return results


def _mesh_spans_processes(mesh) -> bool:
    """True when the mesh includes devices owned by other processes — the
    jax.distributed multi-host case, where jit inputs must be GLOBAL
    jax.Arrays (host-local numpy would raise)."""
    import jax

    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def _globalize(mesh, arr, spec):
    """Build a global jax.Array over a multi-process mesh from data every
    host holds in full (SPMD hosts run identical orchestration code, so
    ``arr`` is identical everywhere): each host contributes the shards it
    owns via make_array_from_callback."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    a = np.asarray(arr)
    return jax.make_array_from_callback(
        a.shape, NamedSharding(mesh, spec), lambda idx: a[idx]
    )


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n  # oversized: exact-size "bucket of one shape"


def _pad_counts(profiles: list[Profile], L: int) -> tuple[np.ndarray, np.ndarray]:
    B = len(profiles)
    A = profiles[0].counts.shape[1]
    counts = np.zeros((B, L, A), dtype=np.float32)
    inv = np.ones((B, L), dtype=np.float32)
    for b, p in enumerate(profiles):
        counts[b, : p.length] = p.counts
        inv[b, : p.length] = column_inverses(p)
    return counts, inv


class ProfileArena:
    """Cross-call profile registry + device-resident stacks.

    The distance stage calls :func:`align_pairs_batched` once per resumable
    tile over the SAME N profiles; sharing one arena keeps each profile's
    stack row, cached exactness total and token extraction alive across
    tiles instead of rebuilding and re-uploading them per call.  A new
    registration invalidates (only) its bucket's stack.

    Lifetime: the registry is keyed by ``id(profile)``, so every registered
    Profile (and its device stack row) stays pinned for the arena's
    lifetime — that is what keeps the ids valid.  Growth is bounded by the
    workload that owns the arena (one MSA stage registers O(N) profiles);
    a long-running process reusing one arena across unrelated stages should
    call :meth:`clear` between them instead of letting it accrete.
    """

    def __init__(self, alphabet_size: int, bucket_sizes: tuple[int, ...]):
        self.A = alphabet_size
        self.bucket_sizes = tuple(bucket_sizes)
        self.pos: dict[int, int] = {}
        self.profs: list[Profile] = []
        self.tot: list[float] = []
        self.ints: list[bool] = []
        self.by_bucket: dict[int, list[int]] = {}
        self._stacks: dict[int, dict] = {}

    def clear(self) -> None:
        """Drop every registration and device stack (frees the pinned
        Profiles and their device memory for a fresh stage)."""
        self.pos.clear()
        self.profs.clear()
        self.tot.clear()
        self.ints.clear()
        self.by_bucket.clear()
        self._stacks.clear()

    def reg(self, p: Profile) -> int:
        k = self.pos.get(id(p))
        if k is None:
            k = len(self.profs)
            self.pos[id(p)] = k
            self.profs.append(p)
            self.tot.append(float(p.counts.sum(axis=1).max(initial=0.0)))
            # Integer-valued counts are a precondition for the narrow
            # integer stack dtypes (ADVICE r3).
            self.ints.append(bool(np.all(p.counts == np.rint(p.counts))))
            b = _bucket(p.length, self.bucket_sizes)
            self.by_bucket.setdefault(b, []).append(k)
            self._stacks.pop(b, None)  # new member -> rebuild that stack
        return k

    def stack(self, b: int) -> dict:
        """Device-resident stack of every registered profile in bucket b.

        One-hot profiles ship as token rows (pad token = A, which one-hot
        expands to a zero column); integer-count profiles ship in the
        narrowest integer dtype that holds them.  Row counts pad to a pow2
        grid (floor 32) so successive calls with different profile subsets
        hit the SAME executable shape — a new stack shape costs a
        compile.
        """
        import jax.numpy as jnp

        st = self._stacks.get(b)
        if st is not None:
            return st
        A = self.A
        ids = self.by_bucket[b]
        profs = [self.profs[u] for u in ids]
        rows = 32
        while rows < len(profs):
            rows *= 2
        lens = np.ones(rows, dtype=np.int32)
        lens[: len(profs)] = [p.length for p in profs]
        onehot = all(
            bool(np.all(p.counts.sum(axis=1) == 1.0)) for p in profs
        )
        ints = all(self.ints[u] for u in ids)
        if onehot:
            tok_dt = np.int8 if A < 127 else np.int32
            toks = np.full((rows, b), A, dtype=tok_dt)
            for r, p in enumerate(profs):
                toks[r, : p.length] = np.argmax(p.counts, axis=1)
            stack, inv = jnp.asarray(toks), jnp.zeros((1, 1), jnp.float32)
        else:
            cmax = max(float(p.counts.max(initial=0.0)) for p in profs)
            # Narrow integer dtypes only for integer-valued counts —
            # fractional counts would silently truncate (ADVICE r3).
            if not ints:
                dt = np.float32
            else:
                dt = np.uint8 if cmax < 256 else (np.uint16 if cmax < 65536 else np.float32)
            counts = np.zeros((rows, b, A), dtype=dt)
            invs = np.ones((rows, b), np.float32)
            for r, p in enumerate(profs):
                counts[r, : p.length] = p.counts
                invs[r, : p.length] = column_inverses(p)
            stack, inv = jnp.asarray(counts), jnp.asarray(invs)
        st = dict(
            onehot=onehot,
            stack=stack,
            inv=inv,
            lens=jnp.asarray(lens),
            host_lens=lens,
            pos={u: r for r, u in enumerate(ids)},
            ints=ints,
        )
        self._stacks[b] = st
        return st


def resolve_backend(backend: str) -> str:
    """The compute route for ``backend``.  "xla" (the materialized or
    streamed XLA scan) runs on every platform; "triton" (the lane-per-
    problem scores kernel, kernels.lane_dp) needs a GPU; "auto" takes
    "triton" on a GPU and "xla" elsewhere."""
    import jax

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    gpu = jax.default_backend() == "gpu"
    if backend == "auto":
        return "triton" if gpu else "xla"
    if backend == "triton" and not gpu:
        raise ValueError(
            f"backend 'triton' needs a GPU; JAX runs on {jax.default_backend()}"
        )
    return backend


def align_pairs_batched(
    pairs: Seq[tuple[Profile, Profile]],
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str,
    *,
    traceback: bool = False,
    bucket_sizes: tuple[int, ...] = (63, 127, 255, 511, 1023, 2047),
    batch_pairs: int = 32,
    backend: str = "auto",
    mesh=None,
    arena: ProfileArena | None = None,
) -> list[AlignResult] | list[PairResult]:
    """Align every (px, py) pair; results in input order.

    ``traceback=False`` returns :class:`PairResult` (score + path length —
    all the distance stage needs); ``traceback=True`` returns full
    :class:`AlignResult` paths bit-identical to the oracle.  ``arena``
    shares the profile registry and device stacks across calls (the
    distance stage's tiles reuse one).
    """
    import jax
    import jax.numpy as jnp

    backend = resolve_backend(backend)
    results: list = [None] * len(pairs)

    s_dev = jnp.asarray(matrix.as_f32())
    A = matrix.alphabet.size
    max_s = float(np.abs(matrix.scores).max())

    if arena is None:
        arena = ProfileArena(A, bucket_sizes)
    elif arena.bucket_sizes != tuple(bucket_sizes) or arena.A != A:
        raise ValueError("arena bucket_sizes/alphabet do not match this call")
    _reg = arena.reg
    uniq_tot = arena.tot
    _stack = arena.stack

    # Group problem indices by (bucket_x, bucket_y).
    groups: dict[tuple[int, int], list[int]] = {}
    pair_reg: list[tuple[int, int] | None] = [None] * len(pairs)
    for idx, (px, py) in enumerate(pairs):
        if px.length == 0 or py.length == 0:
            if traceback:
                results[idx] = _degenerate(px.length, py.length, gap_series, mode)
            else:
                r = _degenerate(px.length, py.length, gap_series, mode)
                results[idx] = PairResult(r.score, float(r.length), px.length, py.length)
            continue
        kx, ky = _reg(px), _reg(py)
        # Same predicate as oracle.score.check_exactness, on cached totals.
        if uniq_tot[kx] * uniq_tot[ky] * max_s >= EXACT_DOT_LIMIT:
            check_exactness(px, py, matrix)  # raises with the full message
        pair_reg[idx] = (kx, ky)
        key = (_bucket(px.length, bucket_sizes), _bucket(py.length, bucket_sizes))
        groups.setdefault(key, []).append(idx)

    # Traceback replays on device (kernels.replay) in every mode: the local
    # stop-at-zero decision ships as bit 7 of the direction byte, so only
    # move tapes come back to the host.
    # Host<->device pipelining (SURVEY.md §3.2 "PP" row): dispatches are
    # enqueued asynchronously and unpacked later, so chunk k+1's transfer
    # and compute overlap chunk k's host-side unpack.
    in_flight: list = []
    max_in_flight = 64

    def drain(limit: int) -> None:
        while len(in_flight) > limit:
            _unpack(*in_flight.pop(0))

    def _unpack(chunk, lx, ly, out) -> None:
        # One device_get for the whole tree: each separate materialization
        # waits on the device on its own.  Super-dispatch entries
        # carry a list of chunks and outputs with a leading (n_sub,) axis.
        out = jax.device_get(out)
        if isinstance(chunk[0], list):
            for t, (sub, slx, sly) in enumerate(zip(chunk, lx, ly)):
                _unpack_one(sub, slx, sly, {k: v[t] for k, v in out.items()})
        else:
            _unpack_one(chunk, lx, ly, out)

    def _unpack_one(chunk, lx, ly, out) -> None:
        score = np.asarray(out["score"])
        length = np.asarray(out["length"])
        ti = np.asarray(out["ti"])
        tj = np.asarray(out["tj"])
        if mode == "semiglobal":
            length = length + (lx - ti) + (ly - tj)
        if traceback:
            moves = np.asarray(out["moves"])  # (B, steps)
            nmoves = np.asarray(out["nmoves"])
            for b, idx in enumerate(chunk):
                results[idx] = moves_to_result(
                    moves[b], int(nmoves[b]), float(score[b]),
                    int(ti[b]), int(tj[b]), int(lx[b]), int(ly[b]), mode,
                )
        else:
            # tolist() once per array: per-element float(np_scalar)
            # conversions cost ~ms per thousand pairs on the hot unpack
            # path (measured round 5 at the 8192-pair distance tile).
            sc = score.tolist()
            ln = length.tolist()
            tis = ti.tolist()
            tjs = tj.tolist()
            for b, idx in enumerate(chunk):
                results[idx] = PairResult(sc[b], ln[b], tis[b], tjs[b])

    for (bx, by), idxs in sorted(groups.items()):
        # ---- oversized routing (VERDICT r1 item 6: router, not error) ----
        # Per-problem byte estimates decide the execution strategy:
        #  * materialized score tensors past the budget -> streamed-producer
        #    scan (no score tensor; any Lx and Ly);
        #  * traceback bits past the budget on top of that -> the
        #    checkpointed walk (O(L^1.5) memory, one dispatch) in every
        #    mode — local's stop rule rides bit 7.
        Lp_g = bx + 1
        hs_bytes, tb_bytes = per_problem_bytes(bx, by)
        stream = hs_bytes > _budget("HS")
        use_ckpt = stream and traceback and tb_bytes > _budget("TB")
        # Per-dispatch batch cap so the whole dispatch's score tensors
        # (+tb) stay inside the memory budget regardless of the configured
        # batch size; the lane kernel holds no score tensor.
        per_prob = hs_bytes + (tb_bytes if traceback else 0)
        if backend == "triton" and not traceback:
            per_prob = lane_dp_bytes(bx, by, A, len(gap_series))
        eff_batch = _snap_batch(
            _budget("DISPATCH") // max(per_prob, 1), batch_pairs
        )

        if stream:
            # Long-tail path: the streamed scan (no hs tensor; any Lx/Ly).
            # Under a mesh BOTH it and the checkpointed giant-tb walk run
            # SHARDED over the pair axis (round 3).
            # Batches bounded by the operand footprint (O(B*L*A) padded
            # count tensors) and, with traceback, by the tb-bit budget.
            operand_bytes = (3 * bx + 2 * by) * matrix.alphabet.size * 4
            sub = max(1, min(
                batch_pairs, _budget("HS") // max(operand_bytes, 1)
            ))
            if traceback and not use_ckpt:
                sub = max(1, min(sub, _budget("TB") // max(tb_bytes, 1)))
            if use_ckpt:
                # Checkpoint footprint per problem: (4k+8) carry vectors of
                # Lp floats per block plus one block's bits/scores buffers.
                # Rg comes from the kernel's own default so the estimate
                # matches the actual footprint by construction.
                from .scan import default_ckpt_interval, wavefront_dp_checkpointed

                kk = len(gap_series)
                Dg = bx + by + 1
                Rg = default_ckpt_interval(Dg)
                per_ckpt = (
                    (4 * kk + 8) * 4 * (-(-Dg // Rg)) * Lp_g
                    + 5 * Rg * Lp_g
                )
                sub = max(1, min(
                    sub, _budget("DISPATCH") // max(per_ckpt, 1)
                ))
            stream_mesh = mesh
            n_dev = (
                int(np.prod(mesh.devices.shape)) if stream_mesh is not None else 1
            )
            for s0 in range(0, len(idxs), sub):
                chunk = idxs[s0 : s0 + sub]
                pxs = [pairs[i][0] for i in chunk]
                pys = [pairs[i][1] for i in chunk]
                spad = (-len(chunk)) % n_dev  # shard-divisible batch
                if spad:
                    pxs = pxs + [pxs[0]] * spad
                    pys = pys + [pys[0]] * spad
                cx, inv_x = _pad_counts(pxs, bx)
                cy, inv_y = _pad_counts(pys, by)
                lx = np.array([p.length for p in pxs], dtype=np.int32)
                ly = np.array([p.length for p in pys], dtype=np.int32)
                if use_ckpt and stream_mesh is not None:
                    from ..dist.allpairs import sharded_ckpt_dispatch

                    operands = (cx, inv_x, cy, inv_y, np.asarray(matrix.as_f32()), lx, ly)
                    if _mesh_spans_processes(stream_mesh):
                        from jax.sharding import PartitionSpec as P

                        pp = P("pairs")
                        operands = tuple(
                            _globalize(stream_mesh, a, spec)
                            for a, spec in zip(
                                operands,
                                (P("pairs", None, None), P("pairs", None),
                                 P("pairs", None, None), P("pairs", None),
                                 P(), pp, pp),
                            )
                        )
                    with annotate(
                        f"dispatch:ckpt-sharded:{bx}x{by}x{len(chunk)}"
                    ):
                        out = sharded_ckpt_dispatch(
                            stream_mesh, *operands,
                            gap_series=tuple(gap_series), mode=mode,
                            interval=Rg,
                        )
                elif use_ckpt:
                    with annotate(f"dispatch:ckpt-tb:{bx}x{by}x{len(chunk)}"):
                        out = wavefront_dp_checkpointed(
                            jnp.asarray(cx), jnp.asarray(inv_x),
                            jnp.asarray(cy), jnp.asarray(inv_y),
                            s_dev, jnp.asarray(lx), jnp.asarray(ly),
                            gap_series=tuple(gap_series), mode=mode,
                            interval=Rg,
                        )
                elif stream_mesh is not None:
                    from ..dist.allpairs import sharded_streamed_dispatch

                    operands = (cx, inv_x, cy, inv_y, np.asarray(matrix.as_f32()), lx, ly)
                    if _mesh_spans_processes(stream_mesh):
                        from jax.sharding import PartitionSpec as P

                        pp = P("pairs")
                        operands = tuple(
                            _globalize(stream_mesh, a, spec)
                            for a, spec in zip(
                                operands,
                                (P("pairs", None, None), P("pairs", None),
                                 P("pairs", None, None), P("pairs", None),
                                 P(), pp, pp),
                            )
                        )
                    with annotate(
                        f"dispatch:streamed-sharded:{bx}x{by}x{len(chunk)}"
                    ):
                        out = sharded_streamed_dispatch(
                            stream_mesh, *operands,
                            gap_series=tuple(gap_series), mode=mode,
                            traceback=traceback, replay=traceback,
                        )
                else:
                    with annotate(f"dispatch:streamed:{bx}x{by}x{len(chunk)}"):
                        out = _streamed_jit()(
                            jnp.asarray(cx), jnp.asarray(inv_x),
                            jnp.asarray(cy), jnp.asarray(inv_y),
                            s_dev, jnp.asarray(lx), jnp.asarray(ly),
                            gap_series=tuple(gap_series), mode=mode,
                            traceback=traceback, replay=traceback,
                        )
                in_flight.append((chunk, lx, ly, out))
                drain(max_in_flight)
            continue

        indexed_descs: list[tuple] = []
        for start in range(0, len(idxs), eff_batch):
            chunk = idxs[start : start + eff_batch]
            # Pad the batch to the {32, 128, 512, 1024, ...} grid
            # (_grid_step), bounding compiled-shape variants per bucket —
            # each new executable costs a compile, which dominates
            # small-MSA wall clock when the cache is cold.  Also
            # round to a multiple of the mesh's pair axis when sharded.
            target = 32
            while target < len(chunk):
                target = _grid_step(target)
            target = min(target, eff_batch)
            if target < len(chunk):  # eff_batch below the grid
                target = len(chunk)
            if mesh is not None:
                n_dev = int(np.prod(mesh.devices.shape))
                target = target + (-target) % n_dev
            pad = max(0, target - len(chunk))

            # Indexed dispatch: profile stacks live on device; the chunk
            # ships only two int32 index vectors (pad entries repeat the
            # first problem; their output rows are discarded).  Under a
            # mesh the SAME body runs inside shard_map with the pair axis
            # sharded (dist.allpairs), device replay included.
            sx_st = _stack(bx)
            sy_st = _stack(by)
            ix = np.array([sx_st["pos"][pair_reg[i][0]] for i in chunk], np.int32)
            iy = np.array([sy_st["pos"][pair_reg[i][1]] for i in chunk], np.int32)
            if pad:
                ix = np.concatenate([ix, np.full(pad, ix[0], np.int32)])
                iy = np.concatenate([iy, np.full(pad, iy[0], np.int32)])
            lx = sx_st["host_lens"][ix]
            ly = sy_st["host_lens"][iy]
            indexed_descs.append((chunk, ix, iy, lx, ly))

        if not indexed_descs:
            continue
        sx_st = _stack(bx)
        sy_st = _stack(by)
        static = dict(
            gap_series=tuple(gap_series), mode=mode, traceback=traceback,
            backend=backend, replay=traceback,
            onehot_x=sx_st["onehot"], onehot_y=sy_st["onehot"], A=A,
        )
        stacks = (
            sx_st["stack"], sx_st["inv"], sx_st["lens"],
            sy_st["stack"], sy_st["inv"], sy_st["lens"],
        )
        # Super-dispatch: runs of same-shape chunks collapse into one
        # scan-of-n_sub jit — the per-dispatch launch and pull are paid
        # once per group; under a mesh the same scan body runs inside
        # shard_map (dist.allpairs).
        di = 0
        while di < len(indexed_descs):
            chunk, ix, iy, lx, ly = indexed_descs[di]
            n_run = 1
            while (
                di + n_run < len(indexed_descs)
                and len(indexed_descs[di + n_run][1]) == len(ix)
            ):
                n_run += 1
            n_sub = next((g for g in SUPER_DISPATCH_GRID if g <= n_run), 1)
            if n_sub > 1:
                grp = indexed_descs[di : di + n_sub]
                ix2 = np.stack([d[1] for d in grp])
                iy2 = np.stack([d[2] for d in grp])
                if mesh is not None:
                    from jax.sharding import PartitionSpec as P

                    from ..dist.allpairs import sharded_indexed_multi_dispatch

                    ops = stacks + (ix2, iy2, s_dev)
                    if _mesh_spans_processes(mesh):
                        pp = P(None, "pairs")
                        ops = tuple(
                            _globalize(mesh, a, spec)
                            for a, spec in zip(
                                ops, (P(), P(), P(), P(), P(), P(), pp, pp, P())
                            )
                        )
                    else:
                        ops = stacks + (jnp.asarray(ix2), jnp.asarray(iy2), s_dev)
                    with annotate(
                        f"dispatch:super{n_sub}-sharded:{bx}x{by}x{len(ix)}"
                    ):
                        out = sharded_indexed_multi_dispatch(
                            mesh, *ops, **static
                        )
                else:
                    with annotate(f"dispatch:super{n_sub}:{bx}x{by}x{len(ix)}"):
                        out = _indexed_multi_jit()(
                            *stacks, jnp.asarray(ix2), jnp.asarray(iy2), s_dev,
                            **static,
                        )
                in_flight.append((
                    [d[0] for d in grp], [d[3] for d in grp],
                    [d[4] for d in grp], out,
                ))
                di += n_sub
                drain(max_in_flight)
                continue
            operands = stacks + (jnp.asarray(ix), jnp.asarray(iy), s_dev)
            if mesh is not None:
                from ..dist.allpairs import sharded_indexed_dispatch

                if _mesh_spans_processes(mesh):
                    # Multi-host SPMD (SURVEY.md §5.4): every host runs this
                    # same code on the same pairs, so the replicated stacks
                    # and the sharded index vectors can be assembled into
                    # global arrays host-locally.
                    from jax.sharding import PartitionSpec as P

                    operands = tuple(
                        _globalize(mesh, a, spec)
                        for a, spec in zip(
                            operands,
                            (P(), P(), P(), P(), P(), P(),
                             P("pairs"), P("pairs"), P()),
                        )
                    )
                with annotate(f"dispatch:sharded:{bx}x{by}x{len(chunk)}"):
                    out = sharded_indexed_dispatch(mesh, *operands, **static)
            else:
                with annotate(f"dispatch:{bx}x{by}x{len(chunk)}"):
                    out = _indexed_jit()(*operands, **static)
            in_flight.append((chunk, lx, ly, out))
            di += 1
            drain(max_in_flight)
    drain(0)
    return results
