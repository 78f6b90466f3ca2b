"""The production MSA pipeline: host orchestration + batched device DP.

Mirrors the oracle workflow (SURVEY.md §4.1, oracle/msa.py) stage for stage,
but every pairwise DP — preprofile star alignments, the O(N^2) all-pairs
distance stage, and the progressive merges — is dispatched through the
batched wavefront kernel (kernels.batch).  Profiles, guide tree, and gap
injection are cheap host work and reuse the oracle's functions verbatim
(SURVEY.md §9 hard part 4), so pipeline output is column-identical to
``oracle_msa`` by construction: the kernels are bit-parity tested and the
rest IS the oracle code.

Batching strategy:
* preprofiles: all N*(N-1) master-slave alignments in one batched call;
* all-pairs: all N*(N-1)/2 pairs, scores+lengths only (no traceback);
* merges: guide-tree joins grouped by depth level; every join in a level is
  independent, so each level is one batched profile-profile call
  (tree-level pipelining, SURVEY.md §3.2 "PP" row).
"""

from __future__ import annotations

import numpy as np

from ..types import (
    Alignment,
    PralineConfig,
    Profile,
    ScoreMatrix,
    Sequence,
    SequenceTree,
    TRACK_ID_PREPROFILE,
)
from ..oracle.align import AlignResult
from ..oracle.merge import full_coverage_path, inject_gaps, reorder_to_input
from ..oracle.msa import oracle_msa
from ..oracle.preprofile import star_counts, project_to_master
from ..oracle.profile import compose_profiles, member_profile, node_profile
from ..oracle.tree import build_guide_tree, similarity_from_scores
from ..util.metrics import log


def _wide_batch_pairs(config: PralineConfig) -> int:
    """Dispatch width for stages with no host-side traceback cost (the
    distance stage and device-replayed preprofile stars): as wide as one
    resumable tile; the per-dispatch HBM byte budget in kernels.batch
    still caps long-bucket groups."""
    return max(
        config.batch_pairs, min(16 * config.batch_pairs, DISTANCE_TILE_PAIRS)
    )


def _batch_kwargs(config: PralineConfig, mesh=None) -> dict:
    return dict(
        bucket_sizes=tuple(config.bucket_sizes),
        batch_pairs=config.batch_pairs,
        backend="xla" if config.backend == "oracle" else config.backend,
        mesh=mesh,
    )


def batched_preprofiles(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig,
    extra_slaves: dict[int, list[Sequence]] | None = None,
    mesh=None,
) -> list[Sequence]:
    """Attach preprofile tracks, all master-slave DPs in one batched call."""
    from ..kernels import align_pairs_batched

    mode = config.preprofile_mode
    if mode == "dummy":
        return [
            s.with_profile(TRACK_ID_PREPROFILE, s.one_hot_profile()) for s in sequences
        ]
    gap_series = config.effective_preprofile_gap_series

    jobs: list[tuple[int, Sequence]] = []  # (master index, slave)
    for i, master in enumerate(sequences):
        for j, slave in enumerate(sequences):
            if j != i:
                jobs.append((i, slave))
        if extra_slaves and i in extra_slaves:
            jobs.extend((i, hit) for hit in extra_slaves[i])

    # One profile OBJECT per sequence: the batch driver dedups by identity
    # and uploads each distinct profile once for the whole stage.
    hot: dict[int, Profile] = {}

    def _hot(seq: Sequence) -> Profile:
        p = hot.get(id(seq))
        if p is None:
            p = seq.one_hot_profile()
            hot[id(seq)] = p
        return p

    pairs = [(_hot(sequences[i]), _hot(slave)) for i, slave in jobs]
    log.info("preprofiles: %d master-slave alignments (%s mode)", len(pairs), mode)
    kwargs = _batch_kwargs(config, mesh)
    # Device replay keeps traceback off the host for preprofile stars in
    # BOTH modes (local replays on device since the bit-7 stop-at-zero
    # contract), so every star stage takes the wide dispatch.
    kwargs["batch_pairs"] = _wide_batch_pairs(config)
    results: list[AlignResult] = align_pairs_batched(
        pairs, matrix, gap_series, mode, traceback=True, **kwargs
    )
    from ..util.metrics import METRICS

    METRICS.add_pairs(
        "preprofiles", len(pairs), sum(float(a.length) * b.length for a, b in pairs)
    )

    rows_per_master: dict[int, list[np.ndarray]] = {i: [] for i in range(len(sequences))}
    toks_per_master: dict[int, list[np.ndarray]] = {i: [] for i in range(len(sequences))}
    for (i, slave), res in zip(jobs, results):
        rows_per_master[i].append(project_to_master(res, sequences[i].length))
        toks_per_master[i].append(slave.tokens)
    out = []
    for i, master in enumerate(sequences):
        prof = star_counts(master, rows_per_master[i], toks_per_master[i])
        out.append(master.with_profile(TRACK_ID_PREPROFILE, prof))
    return out


# Pairs per resumable distance tile (SURVEY.md §6: the O(N^2) stage
# checkpoints tile-by-tile as it completes).  Sized to one wide dispatch:
# round-trip latency dominates the distance stage on remote runtimes.
DISTANCE_TILE_PAIRS = 8192


def batched_all_pairs(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig,
    mesh=None,
    ckpt=None,
    fault_hook=None,
) -> tuple[np.ndarray, np.ndarray]:
    """N x N (score, alignment-length) matrices via batched dispatches.

    The pair space is processed in tiles of :data:`DISTANCE_TILE_PAIRS`;
    with a checkpoint each finished tile persists immediately, so a failure
    mid-stage resumes from the last completed tile.  ``fault_hook(tile_id)``
    is the §6 fault-injection seam: tests raise from it to simulate crashes.
    """
    from ..kernels import align_pairs_batched
    from ..kernels.batch import ProfileArena

    n = len(sequences)
    profiles = [member_profile(s) for s in sequences]
    # One registry + device-stack set for the whole stage: every tile
    # references the same N profiles.
    arena = ProfileArena(matrix.alphabet.size, tuple(config.bucket_sizes))
    index = [(i, j) for i in range(n) for j in range(i + 1, n)]
    scores = np.zeros((n, n), dtype=np.float64)
    lengths = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        lengths[i, i] = max(1, sequences[i].length)

    # Tiles exist for RESUME granularity; without a checkpoint (or fault
    # seam) the whole stage runs as ONE call — the batch driver's async
    # in-flight queue then overlaps every chunk's result pull with the
    # next chunk's compute, leaving a single serial pull for the stage.
    tile_pairs = DISTANCE_TILE_PAIRS
    if ckpt is None and fault_hook is None:
        tile_pairs = max(len(index), 1)

    for t in range(0, max(1, len(index)), tile_pairs):
        tile_id = t // tile_pairs
        tile = index[t : t + tile_pairs]
        if not tile:
            break
        loaded = ckpt.load_distance_tile(tile_id) if ckpt else None
        if loaded is not None:
            tile_scores, tile_lengths = loaded
        else:
            if fault_hook is not None:
                fault_hook(tile_id)
            # Scores-only dispatches carry no traceback memory: batch up
            # to a whole tile per dispatch (round trips dominate the
            # O(N^2) hot stage on remote runtimes).
            kwargs = _batch_kwargs(config, mesh)
            kwargs["batch_pairs"] = _wide_batch_pairs(config)
            kwargs["arena"] = arena
            results = align_pairs_batched(
                [(profiles[i], profiles[j]) for i, j in tile],
                matrix,
                config.gap_series,
                config.distance_mode,
                traceback=False,
                **kwargs,
            )
            tile_scores = np.array([r.score for r in results])
            tile_lengths = np.array([r.length for r in results])
            if ckpt:
                ckpt.save_distance_tile(tile_id, tile_scores, tile_lengths)
        ii = np.fromiter((i for i, _ in tile), np.int64, len(tile))
        jj = np.fromiter((j for _, j in tile), np.int64, len(tile))
        scores[ii, jj] = scores[jj, ii] = np.asarray(tile_scores, np.float64)
        lengths[ii, jj] = lengths[jj, ii] = np.asarray(tile_lengths, np.int64)
        log.info(
            "all-pairs: %d/%d pairs done%s",
            min(t + tile_pairs, len(index)),
            len(index),
            " (from checkpoint)" if loaded is not None else "",
        )
    if ckpt:
        ckpt.save_distances(scores, lengths)
        ckpt.clear_distance_tiles()
    return scores, lengths


def _merge_levels(tree: SequenceTree) -> list[list[int]]:
    """Group join indices by depth so each level is independent."""
    n = tree.num_leaves
    depth = {i: 0 for i in range(n)}
    levels: dict[int, list[int]] = {}
    for k, (l, r) in enumerate(tree.joins):
        d = 1 + max(depth[l], depth[r])
        depth[n + k] = d
        levels.setdefault(d, []).append(k)
    return [levels[d] for d in sorted(levels)]


def batched_progressive_merge(
    sequences: list[Sequence],
    tree: SequenceTree,
    matrix: ScoreMatrix,
    config: PralineConfig,
    mesh=None,
) -> Alignment:
    """Tree walk on device: one dispatch for the whole stage when possible
    (msa.device_merge), else one batched profile-profile DP call per tree
    level."""
    from ..kernels import align_pairs_batched

    if config.backend != "oracle" and mesh is None:
        from .device_merge import try_device_merge

        merged = try_device_merge(sequences, tree, matrix, config)
        if merged is not None:
            return merged

    nodes: dict[int, Alignment] = {
        i: Alignment.single(seq) for i, seq in enumerate(sequences)
    }
    profiles: dict[int, Profile] = {
        i: node_profile(nodes[i]) for i in range(len(sequences))
    }
    n = tree.num_leaves

    levels = _merge_levels(tree)
    for li, level in enumerate(levels):
        log.info("merge: level %d/%d (%d joins)", li + 1, len(levels), len(level))
        pairs = [(profiles[tree.joins[k][0]], profiles[tree.joins[k][1]]) for k in level]
        results = align_pairs_batched(
            pairs,
            matrix,
            config.gap_series,
            config.merge_mode,
            traceback=True,
            **_batch_kwargs(config, mesh),
        )
        from ..util.metrics import METRICS

        METRICS.add_pairs(
            "merge", len(pairs), sum(float(a.length) * b.length for a, b in pairs)
        )
        for k, res in zip(level, results):
            l, r = tree.joins[k]
            left, right = nodes.pop(l), nodes.pop(r)
            pl, pr = profiles.pop(l), profiles.pop(r)
            cols_x, cols_y = full_coverage_path(
                res, left.num_columns, right.num_columns
            )
            rows = inject_gaps(left.rows, right.rows, cols_x, cols_y)
            nodes[n + k] = Alignment(left.members + right.members, rows)
            profiles[n + k] = compose_profiles(
                pl, pr, left.num_members, right.num_members, cols_x, cols_y
            )

    return reorder_to_input(nodes[tree.root], sequences)


def msa_align(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig | None = None,
    extra_slaves: dict[int, list[Sequence]] | None = None,
    mesh=None,
    fault_hook=None,
    on_tree=None,
) -> Alignment:
    """Full PRALINE-equivalent MSA (SURVEY.md C18), batched on device.

    ``config.backend``: ``"oracle"`` runs the pure NumPy reference pipeline;
    ``"auto"``/``"xla"``/``"triton"`` run the batched device pipeline.
    ``fault_hook`` is a test-only failure-injection seam for the distance
    stage (SURVEY.md §6).  ``on_tree(tree)`` is called with the
    :class:`SequenceTree` once the guide tree exists (CLI ``--tree-out``).
    """
    from ..util.checkpoint import Checkpoint, run_digest
    from ..util.metrics import METRICS, maybe_trace

    config = config or PralineConfig()
    if not sequences:
        raise ValueError("no sequences")
    if len(sequences) == 1:
        return Alignment.single(sequences[0])
    if config.backend == "oracle":
        return oracle_msa(
            sequences, matrix, config, extra_slaves=extra_slaves, on_tree=on_tree
        )

    if mesh is None and config.mesh_shape:
        from ..dist import make_pair_mesh

        mesh = make_pair_mesh(int(np.prod(config.mesh_shape)))

    ckpt = None
    if config.checkpoint_dir:
        import jax

        # Multi-process SPMD: every host reads the shared checkpoint dir,
        # only process 0 writes (identical artifacts either way).
        # extra_slaves (BLAST/homology hits) shape the cached preprofiles:
        # their content is part of the run identity (stale-resume guard).
        ckpt = Checkpoint(
            config.checkpoint_dir,
            run_digest(sequences, config, extra_slaves=extra_slaves),
            writer=jax.process_index() == 0,
        )
    METRICS.reset()
    with maybe_trace("msa_align"):
        with METRICS.timed("preprofiles"):
            seqs = ckpt.load_preprofiles(sequences) if ckpt else None
            if seqs is None:
                seqs = batched_preprofiles(
                    sequences, matrix, config, extra_slaves=extra_slaves, mesh=mesh
                )
                if ckpt and config.preprofile_mode != "dummy":
                    ckpt.save_preprofiles(seqs)

        with METRICS.timed("all_pairs"):
            loaded = ckpt.load_distances() if ckpt else None
            if loaded is None:
                scores, lengths = batched_all_pairs(
                    seqs, matrix, config, mesh=mesh, ckpt=ckpt, fault_hook=fault_hook
                )
                n = len(seqs)
                cells = sum(
                    float(seqs[i].length) * seqs[j].length
                    for i in range(n)
                    for j in range(i + 1, n)
                )
                METRICS.add_pairs("all_pairs", n * (n - 1) // 2, cells)
            else:
                scores, lengths = loaded

        with METRICS.timed("guide_tree"):
            tree = ckpt.load_tree() if ckpt else None
            if tree is None:
                sim = similarity_from_scores(scores, lengths, config.score_normalization)
                tree = build_guide_tree(sim, config.linkage)
                if ckpt:
                    ckpt.save_tree(tree)
            if on_tree is not None:
                on_tree(tree)

        with METRICS.timed("merge"):
            result = batched_progressive_merge(seqs, tree, matrix, config, mesh=mesh)
    METRICS.log_summary()
    return result
