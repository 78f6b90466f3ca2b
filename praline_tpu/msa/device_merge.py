"""Device-resident progressive merge with async join dispatches (SURVEY §9 P3).

Round 1 ran the guide-tree walk as one batched DP dispatch per tree LEVEL,
pulling O(L^2) traceback bits to the host at every level and rebuilding
profiles there — wall-clock scaled with tree depth times a full host<->device
round trip (a caterpillar tree over N sequences costs N-1 sequential round
trips, the dominant term on remote runtimes).

Here profiles NEVER exist on the host during the walk: a device-resident
NODE TABLE holds (counts, gaps, length, members) for every tree node, and
each tree LEVEL runs as ONE jitted step over all of its independent joins —
exact-integer profile-profile scoring (kernels.scores), batched wavefront
DP with traceback (kernels.scan), on-device pointer replay (kernels.replay),
and path-composition of the merged profiles (the pinned semantics of
oracle.profile.compose_profiles, including the over-limit rescale in exact
integer arithmetic) — gathering its operands from and scattering its
results into the table.  Join counts pad to a pow2 grid so every level of
every run reuses a handful of executables, and the single synchronization
is one device_get of the per-level move tapes (1 byte per alignment
column) at the end: a balanced tree over N sequences costs ~2*log2(N)
dispatches instead of N-1 (round-2 change; per-join async enqueue still
paid ~20 ms of dispatch latency per join on remote runtimes).  Gap
injection into member rows is cheap vectorized numpy after the sync.

Caterpillar trees (near-equal similarities chain the joins — 400+
single-join levels for a 500-sequence family was measured here) would
still pay one round trip per join, so runs of single-join levels coalesce
into a CHAIN step: a ``lax.scan`` over CHAIN_K dependent joins with the
node tables as carry.  Unlike round 1's rejected scan-over-joins (which
stacked O(L^2) traceback bits in the outer scan and ran ~1000x slower),
the chain consumes each join's bits inside its own step via on-device
replay and emits only the 1-byte-per-column move tape.

All joins share one padded column capacity, so the whole stage reuses a
single executable; column overflow is detected from the returned counts and
retries at the next bucket, then falls back to the per-level batched path
(msa.pipeline).  All three merge modes take the walk: semiglobal's free
trailing gaps and local's lead/tail extensions append on device as
full-coverage tape moves, so composition and host assembly stay
mode-agnostic.
"""

from __future__ import annotations

import functools

import numpy as np

from ..types import Alignment, PralineConfig, Profile, ScoreMatrix, Sequence, SequenceTree
from ..oracle.merge import inject_gaps, reorder_to_input
from ..oracle.profile import COUNT_LIMIT, member_profile, rescale_counts

# Column-capacity ladder (2^n - 1 like the batch driver's buckets: diagonal
# vectors of length C_cap + 1 are powers of two).  Rungs above 8191
# (round 5, SURVEY §9 P3) run the CHECKPOINTED walk so giant-MSA merges
# keep the node-table path with O(C^1.5) traceback memory.
C_BUCKETS = (127, 255, 511, 1023, 2047, 4095, 8191, 16383, 32767)
MAX_ATTEMPTS = 3
# Joins per level-step dispatch (one executable per C_cap); the 8191 rung
# runs the STREAMED producer (no materialized hs tensor) with a narrower
# chunk so its full-bit traceback stays inside HBM; rungs above it go
# checkpointed at J=1 (per-join bit memory is O(sqrt(D) * C), but the node
# table itself is O(nodes * C * A)).
LEVEL_CHUNK_J = 32


def _level_chunk(C_cap: int) -> int:
    if C_cap <= 4095:
        return 32
    return 4 if C_cap <= 8191 else 1


def _rung_kind(C_cap: int) -> str:
    """"hs": materialized skewed tensor (fast, O(2C * J * C * 4) bytes —
    17 GB at 8191/J=32); "streamed": produce rows inside the scan, full
    traceback bits (O(2C * J * C) bytes); "ckpt": streamed forward +
    checkpointed backward walk, O(sqrt(C) * C * J) bit memory — the only
    form that fits giant columns."""
    if C_cap <= 4095:
        return "hs"
    return "streamed" if C_cap <= 8191 else "ckpt"


# Sequential joins per chain-step dispatch (caterpillar segments).
CHAIN_K = 16


def _make_join_body(C_cap: int, A: int, gap_series: tuple[int, ...],
                    inv_size: int, J: int, mode: str = "global"):
    """The core J-join table update: gather operands from the node table,
    run the batched DP + replay + profile composition, scatter results
    back.  Shared by the per-level step (J=32 parallel joins) and the
    chain step (a lax.scan of J=1 dependent joins).

    ``mode`` covers ALL three modes (VERDICT r2 item 5 + round-3
    extension): semiglobal's free trailing gaps and local's lead/tail
    extensions are appended ON DEVICE as full-coverage tape moves, so
    composition and host assembly stay mode-agnostic."""
    import jax
    import jax.numpy as jnp

    from ..kernels.replay import replay_moves
    from ..kernels.scan import (
        wavefront_dp,
        wavefront_dp_checkpointed,
        wavefront_dp_streamed,
    )
    from ..kernels.scores import skewed_pair_scores

    steps = 2 * C_cap
    kind = _rung_kind(C_cap)

    def body(counts_tab, gaps_tab, len_tab, mem_tab, li, ri, oi, s, inv_table):
        cl = jnp.take(counts_tab, li, axis=0)  # (J, C, A)
        gl = jnp.take(gaps_tab, li, axis=0)
        Cl = jnp.take(len_tab, li)
        nml = jnp.take(mem_tab, li)
        cr = jnp.take(counts_tab, ri, axis=0)
        gr = jnp.take(gaps_tab, ri, axis=0)
        Cr = jnp.take(len_tab, ri)
        nmr = jnp.take(mem_tab, ri)

        # Column inverses via exact table lookup: totals are exact f32
        # integers and the table holds host-computed correctly-rounded f32
        # reciprocals (device division need not be correctly rounded).
        totl = jnp.sum(cl, axis=2).astype(jnp.int32)
        totr = jnp.sum(cr, axis=2).astype(jnp.int32)
        invl = inv_table[jnp.clip(totl, 0, inv_size - 1)]
        invr = inv_table[jnp.clip(totr, 0, inv_size - 1)]

        if kind == "ckpt":
            # Giant rungs: checkpointed forward/backward walk — move tapes
            # come back directly (O(sqrt(D)*C) bit memory); the compacted
            # tape's nonzero prefix is <= 2*C_cap, so slicing to ``steps``
            # drops only trailing zeros.
            out = wavefront_dp_checkpointed(
                cl, invl, cr, invr, s, Cl, Cr,
                gap_series=gap_series, mode=mode,
            )
            moves = out["moves"][:, :steps]
            nmv = out["nmoves"]
        else:
            if kind == "streamed":
                out = wavefront_dp_streamed(
                    cl, invl, cr, invr, s, Cl, Cr,
                    gap_series=gap_series, mode=mode, traceback=True,
                )
            else:
                hs = skewed_pair_scores(cl, invl, cr, invr, s)
                out = wavefront_dp(
                    hs, Cl, Cr, gap_series=gap_series, mode=mode,
                    traceback=True,
                )
            moves, nmv = replay_moves(
                out["tb"], out["ti"], out["tj"], out["tcode"],
                gap_series=gap_series, mode=mode, steps=steps,
            )
        m = moves.astype(jnp.int32)  # (J, steps), terminal -> origin
        if mode == "semiglobal":
            # Full-coverage tape: prepend (in terminal->origin emission
            # order) the free trailing gaps — x tail first, then y tail —
            # exactly moves_to_result/full_coverage_path's column order.
            tx = Cl - out["ti"]
            ty = Cr - out["tj"]
            shift = tx + ty
            p0 = jnp.arange(steps, dtype=jnp.int32)[None, :]
            src = p0 - shift[:, None]
            walk = jnp.take_along_axis(m, jnp.clip(src, 0, steps - 1), axis=1)
            walk = jnp.where(src >= 0, walk, 0)
            m = jnp.where(
                p0 < tx[:, None], 2, jnp.where(p0 < shift[:, None], 3, walk)
            )
            nmv = nmv + shift
            moves = m.astype(jnp.uint8)  # host decodes the FULL tape
        elif mode == "local":
            # Full-coverage tape around the local segment: final column
            # order is [x lead, y lead, walk, x tail, y tail]
            # (oracle.merge.full_coverage_path), so the terminal->origin
            # emission is [y tail, x tail, walk, y lead, x lead].  An
            # empty walk (best score <= 0) collapses to [x tail = ALL of
            # x, y tail = ALL of y], matching the oracle's empty result.
            xcnt = jnp.sum(((m == 1) | (m == 2)).astype(jnp.int32), axis=1)
            ycnt = jnp.sum(((m == 1) | (m == 3)).astype(jnp.int32), axis=1)
            empty = nmv == 0
            ti_e = jnp.where(empty, 0, out["ti"])
            tj_e = jnp.where(empty, 0, out["tj"])
            tx = Cl - ti_e
            ty = Cr - tj_e
            x0 = ti_e - xcnt  # lead columns before the segment
            y0 = tj_e - ycnt
            shift = tx + ty
            p0 = jnp.arange(steps, dtype=jnp.int32)[None, :]
            src = p0 - shift[:, None]
            walk = jnp.take_along_axis(m, jnp.clip(src, 0, steps - 1), axis=1)
            walk = jnp.where(
                (src >= 0) & (src < nmv[:, None]), walk, 0
            )
            after = shift + nmv
            m = jnp.where(
                p0 < ty[:, None], 3,
                jnp.where(
                    p0 < shift[:, None], 2,
                    jnp.where(
                        p0 < after[:, None], walk,
                        jnp.where(
                            p0 < (after + y0)[:, None], 3,
                            jnp.where(p0 < (after + y0 + x0)[:, None], 2, 0),
                        ),
                    ),
                ),
            )
            nmv = nmv + shift + x0 + y0
            moves = m.astype(jnp.uint8)

        # Compose the merged profiles from the move tapes (the pinned
        # semantics of oracle.profile.compose_profiles).  Emission position
        # p maps to output column c = nn - 1 - p; the source column in x is
        # ti - (#x-consuming moves among emission positions <= p).
        p = jnp.arange(steps, dtype=jnp.int32)[None, :]
        valid = m > 0
        takes_x = (m == 1) | (m == 2)
        takes_y = (m == 1) | (m == 3)
        rcx = jnp.cumsum(takes_x.astype(jnp.int32), axis=1)
        rcy = jnp.cumsum(takes_y.astype(jnp.int32), axis=1)
        # Full-coverage tapes start at (Cl, Cr) — for global that IS the
        # terminal; for semiglobal the appended tails make it so.
        xi = jnp.clip(Cl[:, None] - rcx, 0, C_cap - 1)
        yi = jnp.clip(Cr[:, None] - rcy, 0, C_cap - 1)
        c = jnp.clip(nmv[:, None] - 1 - p, 0, C_cap - 1)

        wx = (takes_x & valid).astype(jnp.float32)[:, :, None]
        wy = (takes_y & valid).astype(jnp.float32)[:, :, None]
        contrib = (
            jnp.take_along_axis(cl, xi[:, :, None], axis=1) * wx
            + jnp.take_along_axis(cr, yi[:, :, None], axis=1) * wy
        )
        fl = nml[:, None].astype(jnp.float32)
        fr = nmr[:, None].astype(jnp.float32)
        gap_contrib = jnp.where(
            valid,
            jnp.where(takes_x, jnp.take_along_axis(gl, xi, axis=1), fl)
            + jnp.where(takes_y, jnp.take_along_axis(gr, yi, axis=1), fr),
            0.0,
        )
        jrow = jnp.arange(J, dtype=jnp.int32)[:, None]
        new_counts = jnp.zeros((J, C_cap, A), jnp.float32).at[jrow, c].add(contrib)
        new_gaps = jnp.zeros((J, C_cap), jnp.float32).at[jrow, c].add(gap_contrib)

        # Over-limit rescale in exact integer arithmetic:
        # (512*c + n) // (2*n) == floor(c*256/n + 0.5) for these magnitudes
        # (oracle.profile.rescale_counts states the same function in float64;
        # tests/oracle/test_profile_rescale.py pins their equality).
        totals = jnp.sum(new_counts, axis=2) + new_gaps
        over = totals > COUNT_LIMIT
        n_i = jnp.maximum(totals.astype(jnp.int32), 1)
        c_i = new_counts.astype(jnp.int32)
        q = (512 * c_i + n_i[:, :, None]) // (2 * n_i[:, :, None])
        qg = (512 * new_gaps.astype(jnp.int32) + n_i) // (2 * n_i)
        new_counts = jnp.where(over[:, :, None], q.astype(jnp.float32), new_counts)
        new_gaps = jnp.where(over, qg.astype(jnp.float32), new_gaps)

        # Scatter the merged nodes (pad joins target the trash slot).
        counts_tab = counts_tab.at[oi].set(new_counts)
        gaps_tab = gaps_tab.at[oi].set(new_gaps)
        len_tab = len_tab.at[oi].set(nmv)
        mem_tab = mem_tab.at[oi].set(nml + nmr)
        return counts_tab, gaps_tab, len_tab, mem_tab, moves, nmv

    return body


@functools.lru_cache(maxsize=64)
def _level_step_jit(C_cap: int, A: int, gap_series: tuple[int, ...],
                    inv_size: int, J: int, mode: str = "global"):
    """One tree LEVEL of J independent joins as a single dispatch."""
    import jax

    body = _make_join_body(C_cap, A, gap_series, inv_size, J, mode)

    # Donation: the node tables are rewritten every level; reusing their
    # buffers avoids an O(nodes * C_cap * A) copy per level (a no-op copy
    # fallback on backends without donation support).
    return functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))(body)


@functools.lru_cache(maxsize=64)
def _chain_step_jit(C_cap: int, A: int, gap_series: tuple[int, ...],
                    inv_size: int, K: int, mode: str = "global"):
    """K SEQUENTIAL joins in one dispatch (lax.scan over the join schedule,
    node tables as carry).

    Guide trees over near-equal similarities degenerate to caterpillars —
    one join per level — so the per-level step still pays one dispatch
    round trip per join.  Chaining K dependent joins into one executable
    divides the walk's dispatch count by K for exactly those trees."""
    import jax

    import jax.numpy as jnp

    body = _make_join_body(C_cap, A, gap_series, inv_size, 1, mode)

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
    def chain(counts_tab, gaps_tab, len_tab, mem_tab, li, ri, oi, nvalid,
              s, inv_table):
        def step(tabs, idx):
            l1, r1, o1, i1 = idx

            def real(ts):
                ct, gt, lt, mt = ts
                ct, gt, lt, mt, moves, nmv = body(
                    ct, gt, lt, mt, l1[None], r1[None], o1[None], s, inv_table
                )
                return (ct, gt, lt, mt), moves[0], nmv[0]

            def skip(ts):
                # Pad steps beyond the valid chain do NO DP work (a full
                # sequential wavefront per pad would otherwise dominate
                # short flushes).
                return ts, jnp.zeros((2 * C_cap,), jnp.uint8), jnp.int32(0)

            tabs2, moves, nmv = jax.lax.cond(i1 < nvalid, real, skip, tabs)
            return tabs2, (moves, nmv)

        tabs, (moves, nmv) = jax.lax.scan(
            step,
            (counts_tab, gaps_tab, len_tab, mem_tab),
            (li, ri, oi, jnp.arange(K, dtype=jnp.int32)),
        )
        return (*tabs, moves, nmv)

    return chain


def try_device_merge(
    sequences: list[Sequence],
    tree: SequenceTree,
    matrix: ScoreMatrix,
    config: PralineConfig,
) -> Alignment | None:
    """Run the whole merge stage device-resident; None -> caller falls back.

    Fallback conditions: exactness bound exceeded for the raw leaf
    profiles, or merged column counts overflowing every bucket attempt.
    All three merge modes take the walk since round 3 (local's partial
    path is extended to full coverage on device).
    """
    import jax
    import jax.numpy as jnp

    if config.merge_mode not in ("global", "semiglobal", "local"):
        return None
    n = len(sequences)
    if n < 2 or any(s.length == 0 for s in sequences):
        return None
    # Leaves enter the walk exactly as node_profile builds them for the
    # per-level/oracle paths: preprofile counts with the over-limit
    # rescale applied (a >COUNT_LIMIT leaf — huge homology-extended
    # preprofiles — would otherwise silently diverge from the contract).
    leaf_profs = []
    for s in sequences:
        p = member_profile(s)
        c, g = rescale_counts(p.counts, p.gaps)
        leaf_profs.append(Profile(c, g, p.alphabet))
    A = matrix.alphabet.size
    max_total = max(
        float(p.counts.sum(axis=1).max(initial=1.0)) for p in leaf_profs
    )
    # Exactness bound for count-space matmuls (oracle.score): composed
    # profiles rescale above COUNT_LIMIT, rescaled leaves stay below it —
    # bound on both.
    bound = max(max_total, COUNT_LIMIT + A)
    if bound * bound * float(np.abs(matrix.scores).max()) >= 2**24:
        return None

    max_len = max(p.length for p in leaf_profs)
    # Start the column-capacity ladder just above the longest leaf (+25%):
    # related families grow few columns, and every scan step in the walk
    # costs 2*C_cap diagonals — a too-big first rung doubles the whole
    # stage's latency.  Overflow is detected and retries the next rung.
    start = next(
        (b for b in C_BUCKETS if b >= min(int(1.25 * max_len) + 1, C_BUCKETS[-1])),
        None,
    )
    if start is None or max_len > C_BUCKETS[-1]:
        return None
    attempts = [b for b in C_BUCKETS if b >= max(start, max_len)][:MAX_ATTEMPTS]

    inv_size = int(max(1024, max_total + 2))
    inv_table = (
        np.float32(1.0)
        / np.maximum(np.arange(inv_size, dtype=np.float32), np.float32(1.0))
    ).astype(np.float32)
    s_dev = jnp.asarray(matrix.as_f32())
    inv_dev = jnp.asarray(inv_table)

    from .pipeline import _merge_levels

    levels = _merge_levels(tree)
    for C_cap in attempts:
        # Device-resident node table: slot i = node i, last slot = trash
        # (pow2-padded pad joins write there; it is never read).
        M = 2 * n
        counts_np = np.zeros((M, C_cap, A), dtype=np.float32)
        gaps_np = np.zeros((M, C_cap), dtype=np.float32)
        len_np = np.ones((M,), dtype=np.int32)
        mem_np = np.ones((M,), dtype=np.int32)
        for i, p in enumerate(leaf_profs):
            counts_np[i, : p.length] = p.counts
            gaps_np[i, : p.length] = p.gaps
            len_np[i] = p.length
        counts_tab = jnp.asarray(counts_np)
        gaps_tab = jnp.asarray(gaps_np)
        len_tab = jnp.asarray(len_np)
        mem_tab = jnp.asarray(mem_np)

        # TWO executables for the whole walk: wide levels run in fixed-size
        # chunks of LEVEL_CHUNK_J parallel joins, and runs of single-join
        # levels (caterpillar segments — the common shape when similarities
        # are near-equal) coalesce into CHAIN_K sequential joins per
        # dispatch (lax.scan, node tables as carry).  Pads hit the trash
        # slot.  Each NEW executable costs seconds of per-process
        # upload/init on remote runtimes, so fixed shapes with trivially
        # wasted pad compute beat a per-size shape grid.
        gs = tuple(config.gap_series)
        chunk_j = _level_chunk(C_cap)
        step = _level_step_jit(C_cap, A, gs, inv_size, chunk_j,
                               config.merge_mode)
        chain_step = _chain_step_jit(C_cap, A, gs, inv_size, CHAIN_K,
                                     config.merge_mode)
        tabs = [counts_tab, gaps_tab, len_tab, mem_tab]
        level_out = []

        def _idx(joins, size):
            jl = len(joins)
            li = np.empty(size, np.int32)
            ri = np.empty(size, np.int32)
            oi = np.full(size, M - 1, np.int32)  # pads -> trash
            li[:jl] = [tree.joins[k][0] for k in joins]
            ri[:jl] = [tree.joins[k][1] for k in joins]
            oi[:jl] = [n + k for k in joins]
            li[jl:] = li[0]  # pads re-merge join 0's nodes (reads only)
            ri[jl:] = ri[0]
            return jnp.asarray(li), jnp.asarray(ri), jnp.asarray(oi)

        pending: list[int] = []

        def _flush_chain():
            if not pending:
                return
            if len(pending) == 1:
                # A lone join runs in the parallel level step, whose pads
                # are data-parallel (near-zero marginal cost).
                li, ri, oi = _idx(pending, chunk_j)
                out = step(*tabs, li, ri, oi, s_dev, inv_dev)
            else:
                li, ri, oi = _idx(pending, CHAIN_K)
                out = chain_step(
                    *tabs, li, ri, oi, jnp.asarray(np.int32(len(pending))),
                    s_dev, inv_dev,
                )
            tabs[:] = out[:4]
            level_out.append((list(pending), out[4], out[5]))
            pending.clear()

        for level in levels:
            if len(level) == 1:
                pending.append(level[0])
                if len(pending) == CHAIN_K:
                    _flush_chain()
                continue
            _flush_chain()  # later levels may consume chain outputs
            for s0 in range(0, len(level), chunk_j):
                chunk = level[s0 : s0 + chunk_j]
                li, ri, oi = _idx(chunk, chunk_j)
                out = step(*tabs, li, ri, oi, s_dev, inv_dev)
                tabs[:] = out[:4]
                level_out.append((chunk, out[4], out[5]))
        _flush_chain()

        # ONE synchronization for the whole walk.
        got = jax.device_get([(mv, nv) for _, mv, nv in level_out])
        njoins = len(tree.joins)
        moves_all = np.zeros((njoins, 2 * C_cap), dtype=np.uint8)
        ncols = np.zeros(njoins, dtype=np.int64)
        for (level, _, _), (mv, nv) in zip(level_out, got):
            for r, k in enumerate(level):
                moves_all[k] = mv[r]
                ncols[k] = int(nv[r])
        if int(ncols.max(initial=0)) <= C_cap:
            return _assemble(sequences, tree, moves_all, ncols)
    return None


def _assemble(
    sequences: list[Sequence],
    tree: SequenceTree,
    moves_all: np.ndarray,
    ncols: np.ndarray,
) -> Alignment:
    """Inject gaps along the returned per-join paths (host, vectorized)."""
    from ..kernels.replay import moves_to_result
    from ..util.metrics import METRICS

    nodes: dict[int, Alignment] = {
        i: Alignment.single(seq) for i, seq in enumerate(sequences)
    }
    n = tree.num_leaves
    cells = 0.0
    for k, (l, r) in enumerate(tree.joins):
        left, right = nodes.pop(l), nodes.pop(r)
        res = moves_to_result(
            moves_all[k], int(ncols[k]), 0.0, 0, 0,
            left.num_columns, right.num_columns, "global",
        )
        cells += float(left.num_columns) * right.num_columns
        rows = inject_gaps(left.rows, right.rows, res.cols_x, res.cols_y)
        nodes[n + k] = Alignment(left.members + right.members, rows)
    METRICS.add_pairs("merge", len(tree.joins), cells)

    return reorder_to_input(nodes[tree.root], sequences)
