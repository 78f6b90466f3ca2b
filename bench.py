#!/usr/bin/env python
"""Headline benchmark: profile-profile DP cells/s on one device.

    python bench.py [config] [--backend auto|xla|triton]

Prints ONE JSON line:
  {"metric": "dp_cells_per_s_chip", "value": N, "unit": "cells/s",
   "vs_baseline": N, "platform": ..., "device_kind": ..., "device_count": N,
   "backend": ...}

``vs_baseline`` is measured throughput divided by 1e6 cells/s — the upper end
of the documented estimate for the reference's interpreted per-cell Python DP
loop (BASELINE.md: the reference publishes no numbers; ~1e5-1e6 cells/s,
single CPU core).  Driver target is >= 1e9 cells/s/chip (BASELINE.json:5).

Measures the full production dispatch: exact-integer score matmuls + skew +
batched wavefront scan, scores+lengths mode (the all-pairs distance
configuration), steady state after one warmup compile.
"""

from __future__ import annotations

import json
import time

# Reference estimate: interpreted Python per-cell loop, single core.
BASELINE_CELLS_PER_S = 1.0e6


def bench(B: int = 8192, L: int = 1023, iters: int = 6, backend: str = "auto") -> dict:
    """Headline: the PRODUCTION batched driver end to end — indexed
    profile stacks, dispatch sizing and super-dispatch grouping
    (kernels.batch), score producer + DP, and the host-side unpack — on a
    ragged profile-profile distance workload.

    B matches the production distance tile (msa.pipeline.
    DISTANCE_TILE_PAIRS = 8192): one tile per call, the dispatch width the
    real O(N^2) stage gets."""
    import numpy as np

    from praline_tpu import ALPHABET_AA
    from praline_tpu.io import builtin_score_matrix
    from praline_tpu.kernels import align_pairs_batched
    from praline_tpu.kernels.batch import ProfileArena
    from praline_tpu.types import Profile

    rng = np.random.default_rng(0)
    matrix = builtin_score_matrix("blosum62")
    A = matrix.alphabet.size

    # Ragged integer-count profiles (the all-pairs preprofile workload);
    # one arena so stacks upload once, exactly like the distance stage.
    NPROF = 256
    profs = []
    for _ in range(NPROF):
        Lk = int(rng.integers(L // 2, L + 1))
        c = rng.integers(0, 2, size=(Lk, A)).astype(np.float32)
        c[:, 0] += 1.0
        profs.append(Profile(c, np.zeros(Lk, np.float32), ALPHABET_AA))
    arena = ProfileArena(A, (L,))

    # Two distinct pair sets, rotated across iterations: repeated identical
    # dispatches can be short-circuited by runtime-level result caching.
    pair_sets = []
    total_cells = {}
    for k in range(2):
        pairs = [
            (profs[(i * 7 + 3 * k) % NPROF], profs[(i * 13 + 5 + k) % NPROF])
            for i in range(B)
        ]
        total_cells[k] = float(sum(
            float(p.length) * q.length for p, q in pairs
        ))
        pair_sets.append(pairs)

    def run(pairs):
        return align_pairs_batched(
            pairs, matrix, (11, 1), "global", traceback=False,
            bucket_sizes=(L,), batch_pairs=8192, backend=backend,
            arena=arena,
        )

    run(pair_sets[0])  # warmup / compile (results are host-materialized)
    run(pair_sets[1])

    rates = []
    for it in range(iters):
        k = it % 2
        t0 = time.perf_counter()
        res = run(pair_sets[k])
        rates.append(total_cells[k] / (time.perf_counter() - t0))
    assert all(r is not None for r in res)
    value = float(np.median(rates))
    return {
        "metric": "dp_cells_per_s_chip",
        "value": value,
        "unit": "cells/s",
        "vs_baseline": value / BASELINE_CELLS_PER_S,
    }


def _random_family(n, L, seed=0):
    import numpy as np

    from praline_tpu import ALPHABET_AA
    from praline_tpu.types import Sequence

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=L)
    out = []
    for i in range(n):
        toks = base.copy()
        for _ in range(int(rng.integers(L // 20, L // 5))):
            toks[rng.integers(0, L)] = rng.integers(0, 20)
        out.append(Sequence(f"s{i}", toks.astype(np.int32), ALPHABET_AA))
    return out


def _timed(fn):
    t0 = time.perf_counter()
    result = fn()
    return result, time.perf_counter() - t0


def bench_pairwise(backend: str = "auto") -> dict:
    """BASELINE config 1: one pairwise global affine BLOSUM62 alignment
    (with traceback), batched path, wall-clock."""
    from praline_tpu import builtin_score_matrix
    from praline_tpu.kernels import align_pairs_batched

    a, b = _random_family(2, 500)
    m = builtin_score_matrix("blosum62")
    pairs = [(a.one_hot_profile(), b.one_hot_profile())]
    run = lambda: align_pairs_batched(pairs, m, (11, 1), "global",  # noqa: E731
                                      traceback=True, backend=backend)
    run()  # warmup
    (res,), dt = _timed(run)
    return {"metric": "pairwise_global_wallclock", "value": dt, "unit": "s",
            "vs_baseline": (500 * 500 / dt) / BASELINE_CELLS_PER_S}


def bench_allpairs100(backend: str = "auto") -> dict:
    """BASELINE config 2: all-vs-all distance matrix on ~100 sequences."""
    from praline_tpu import PralineConfig, builtin_score_matrix
    from praline_tpu.msa import batched_all_pairs, batched_preprofiles

    seqs = _random_family(100, 200)
    m = builtin_score_matrix("blosum62")
    cfg = PralineConfig(backend=backend)
    pp = batched_preprofiles(seqs, m, cfg)
    # Warm with a same-shape different-data family: the 4950-pair stage
    # snaps to a different batch cap than a smaller warmup would, so a
    # partial warmup leaves a compile inside the timed region.
    batched_all_pairs(batched_preprofiles(_random_family(100, 200, seed=1), m, cfg), m, cfg)
    (scores_lengths), dt = _timed(lambda: batched_all_pairs(pp, m, cfg))
    cells = sum(
        float(seqs[i].length) * seqs[j].length
        for i in range(100)
        for j in range(i + 1, 100)
    )
    return {"metric": "allpairs100_wallclock", "value": dt, "unit": "s",
            "vs_baseline": (cells / dt) / BASELINE_CELLS_PER_S}


def bench_tracks(backend: str = "auto") -> dict:
    """Multi-track composite throughput (SURVEY C4): two-track (blosum62 +
    pam250) one-hot tracksets through the production dispatcher (composites
    run the XLA route on every backend)."""
    import numpy as np

    from praline_tpu import ALPHABET_AA, builtin_score_matrix
    from praline_tpu.kernels import align_tracksets_batched
    from praline_tpu.types import Profile

    rng = np.random.default_rng(0)
    mats = [builtin_score_matrix("blosum62"), builtin_score_matrix("pam250")]
    w = (1.0, 0.5)
    L = 1023
    profs = [
        Profile.from_tokens(
            rng.integers(0, 20, size=int(rng.integers(L // 2, L + 1))).astype(np.int32),
            ALPHABET_AA,
        )
        for _ in range(64)
    ]
    sets, cells = [], []
    for k in range(2):
        pairs, c = [], 0.0
        for i in range(1024):
            px = profs[(i * 7 + 3 * k) % 64]
            py = profs[(i * 13 + 5 + k) % 64]
            c += float(px.length) * py.length
            pairs.append(((px, px), (py, py)))
        sets.append(pairs)
        cells.append(c)

    def run(pairs):
        return align_tracksets_batched(
            pairs, mats, w, (11, 1), "global", traceback=False,
            bucket_sizes=(L,),
        )

    run(sets[0])
    run(sets[1])
    rates = []
    for it in range(6):
        t0 = time.perf_counter()
        run(sets[it % 2])
        rates.append(cells[it % 2] / (time.perf_counter() - t0))
    value = float(np.median(rates))
    return {"metric": "tracks_cells_per_s", "value": value, "unit": "cells/s",
            "vs_baseline": value / BASELINE_CELLS_PER_S}


def bench_msa(preprofile: str = "dummy", backend: str = "auto") -> dict:
    """BASELINE configs 3/4: full progressive MSA (config 4 with global
    master-slave preprofiles)."""
    from praline_tpu import PralineConfig, builtin_score_matrix
    from praline_tpu.msa import msa_align

    seqs = _random_family(60, 150)
    m = builtin_score_matrix("blosum62")
    cfg = PralineConfig(preprofile_mode=preprofile, backend=backend)
    # Warm with a same-shape different-data family: hits the SAME
    # executables, so compilation stays out of the timed run.
    msa_align(_random_family(60, 150, seed=1), m, cfg)
    aln, dt = _timed(lambda: msa_align(seqs, m, cfg))
    name = "msa60_wallclock" if preprofile == "dummy" else "msa60_preprofile_wallclock"
    # throughput ratio on the dominant all-pairs DP cells (lower bound on
    # total work when preprofiles/merges also run)
    n, L = len(seqs), 150
    cells = n * (n - 1) / 2 * L * L
    return {"metric": name, "value": dt, "unit": "s",
            "vs_baseline": (cells / dt) / BASELINE_CELLS_PER_S}


def bench_modes(backend: str = "auto") -> dict:
    """BASELINE config 5: local + semiglobal with custom gap penalties."""
    from praline_tpu import builtin_score_matrix
    from praline_tpu.kernels import align_pairs_batched

    seqs = _random_family(64, 300, seed=7)
    m = builtin_score_matrix("blosum62")
    pairs = [(s.one_hot_profile(), t.one_hot_profile())
             for s, t in zip(seqs[::2], seqs[1::2])]
    runs = (("local", (13, 7, 1)), ("semiglobal", (8, 2)))
    for mode, gaps in runs:
        align_pairs_batched(pairs, m, gaps, mode, backend=backend)  # warmup
    _, dt = _timed(lambda: [
        align_pairs_batched(pairs, m, gaps, mode, backend=backend)
        for mode, gaps in runs
    ])
    cells = 2 * sum(p.length * q.length for p, q in pairs)
    return {"metric": "modes_custom_gaps_wallclock", "value": dt, "unit": "s",
            "vs_baseline": (cells / dt) / BASELINE_CELLS_PER_S}


def bench_scaling() -> dict:
    """Mesh-scaling harness (SURVEY.md §7 scaling row; VERDICT r1 item 3).

    Strong-scaling sweep of the PRODUCTION sharded dispatch (indexed
    stacks + shard_map + all_gather, dist.allpairs) over simulated CPU
    meshes {1,2,4,8}: fixed 512-pair workload, per-mesh-size steady-state
    wall clock, parallel efficiency t1/(n*tn).  The sweep re-execs itself
    onto 8 forced CPU host devices — the point is a re-runnable count of
    the real sharded code path plus the per-host streaming accounting;
    its times are XLA:CPU's, not a device's.

    The simulated devices share one host's cores, so ideal scaling is NOT
    expected here; on real hardware the collective payload per dispatch
    (replicated O(N) profile stacks amortized over a stage + O(B) int32
    indices in + O(B) scalars all-gathered out, vs O(B L^2) DP work per
    shard) is what the >=80% 1->N-host target [BASELINE.json:5] rides on
    — see the "requirement" field in the output.
    """
    import os
    import subprocess
    import sys

    if os.environ.get("PRALINE_SCALING_CHILD") != "1":
        env = dict(os.environ)
        env["PRALINE_SCALING_CHILD"] = "1"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        proc = subprocess.run(
            [sys.executable, __file__, "scaling"],
            env=env, capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"scaling child failed:\n{proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from praline_tpu import ALPHABET_AA, builtin_score_matrix
    from praline_tpu.dist import make_pair_mesh
    from praline_tpu.kernels import align_pairs_batched
    from praline_tpu.types import Profile

    rng = np.random.default_rng(0)
    B, L, NPROF = 512, 127, 64
    profs = [
        Profile.from_tokens(rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA)
        for _ in range(NPROF)
    ]
    pairs = [(profs[i % NPROF], profs[(i * 7 + 3) % NPROF]) for i in range(B)]
    m = builtin_score_matrix("blosum62")
    cells = float(sum(p.length * q.length for p, q in pairs))

    wall: dict[int, float] = {}
    for n in (1, 2, 4, 8):
        mesh = make_pair_mesh(n)
        kw = dict(bucket_sizes=(127,), batch_pairs=B, backend="xla", mesh=mesh)
        align_pairs_batched(pairs, m, (11, 1), "global", **kw)  # compile
        times = []
        for _ in range(3):
            _, dt = _timed(
                lambda: align_pairs_batched(pairs, m, (11, 1), "global", **kw)
            )
            times.append(dt)
        wall[n] = float(np.median(times))

    eff = {str(n): wall[1] / (n * wall[n]) for n in wall}
    value = eff["8"]
    return {
        "metric": "scaling_efficiency_sim8",
        "value": value,
        "unit": "fraction of ideal, t1/(8*t8), simulated 8-device CPU mesh",
        "vs_baseline": value / 0.8,  # target >=0.8 at 1->N hosts [B:5]
        "wallclock_s": {str(n): round(t, 4) for n, t in wall.items()},
        "efficiency": {k: round(v, 4) for k, v in eff.items()},
        "cells_per_round": cells,
        "streaming_bytes_per_dispatch": {
            # host->device: one-hot token stacks (amortized per stage) +
            # two index vectors; device->host: five scalar vectors.
            "profile_stacks": NPROF * L,
            "index_vectors": 2 * B * 4,
            "gathered_outputs": B * 5 * 4,
        },
        "requirement": (
            ">=80% 1->N-host efficiency requires: (a) per-shard batch >= "
            "~128 pairs so each device's dispatch stays compute-bound "
            "(collective payload is O(B) scalars vs O(B*L^2) DP work), "
            "(b) profile stacks broadcast once per stage and amortized "
            "over N-1 pair uses, (c) distance tiles merged via tiled "
            "all_gather — all three are properties of the shipped "
            "dispatch design measured here."
        ),
    }


def bench_ring() -> dict:
    """Ring-parallel single alignment (SURVEY.md §3.2 ring row): per-step
    vs superstepped boundary exchange on the simulated 8-device mesh.

    The superstep (default interval=32) ships K diagonals' boundary
    stacks per ppermute instead of one collective per diagonal; the
    reported value is the end-to-end speedup at Lx=2000 on XLA:CPU
    devices; with latency-bound collectives the amortization is the
    difference between the ring being an escape hatch and unusable.
    """
    import os
    import subprocess
    import sys

    if os.environ.get("PRALINE_RING_CHILD") != "1":
        env = dict(os.environ)
        env["PRALINE_RING_CHILD"] = "1"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        proc = subprocess.run(
            [sys.executable, __file__, "ring"],
            env=env, capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"ring child failed:\n{proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from praline_tpu import builtin_score_matrix
    from praline_tpu.dist import make_pair_mesh
    from praline_tpu.dist.ring import ring_wavefront_dp

    rng = np.random.default_rng(0)
    B, Lx, Ly, A = 1, 2000, 1500, 23
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx = (1.0 / np.maximum(cx.sum(-1), 1)).astype(np.float32)
    ivy = (1.0 / np.maximum(cy.sum(-1), 1)).astype(np.float32)
    lx = np.full(B, Lx, np.int32)
    ly = np.full(B, Ly, np.int32)
    s = np.asarray(builtin_score_matrix("blosum62").as_f32())
    mesh = make_pair_mesh(8)

    wall = {}
    score = {}
    for iv in (1, 8, 32, 128):  # interval sweep (VERDICT r2 item 6)
        r = ring_wavefront_dp(mesh, cx, ivx, cy, ivy, s, lx, ly, interval=iv)
        jax.block_until_ready(r)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = ring_wavefront_dp(mesh, cx, ivx, cy, ivy, s, lx, ly, interval=iv)
            score[iv] = float(np.asarray(r["score"])[0])
            times.append(time.perf_counter() - t0)
        wall[iv] = float(np.median(times))
    assert len(set(score.values())) == 1, "superstep changed the score"
    # Checkpointed-traceback ring: the giant-alignment memory bound.
    t0 = time.perf_counter()
    rc = ring_wavefront_dp(mesh, cx, ivx, cy, ivy, s, lx, ly, interval=32,
                           traceback=True, ckpt_interval=256)
    nmv = int(np.asarray(rc["nmoves"])[0])
    ckpt_s = time.perf_counter() - t0
    assert float(np.asarray(rc["score"])[0]) == score[32]
    assert nmv >= Lx
    best = min(wall, key=wall.get)
    speedup = wall[1] / wall[best]
    return {
        "metric": "ring_superstep_speedup_sim8",
        "value": speedup,
        "unit": f"x (per-diagonal / best superstep interval={best}, 8-device CPU mesh)",
        "vs_baseline": speedup,
        "wallclock_s": {f"interval_{iv}": round(t, 4) for iv, t in wall.items()},
        "ckpt_traceback_s": round(ckpt_s, 4),
        "ckpt_traceback_moves": nmv,
    }


CONFIGS = {
    "cells": bench,
    "pairwise": bench_pairwise,
    "allpairs100": bench_allpairs100,
    "tracks": bench_tracks,
    "msa": bench_msa,
    "preprofile": lambda backend="auto": bench_msa("global", backend=backend),
    "modes": bench_modes,
}
# Simulated-mesh configs: each re-runs itself on forced CPU devices.
SIMULATED = {"scaling": bench_scaling, "ring": bench_ring}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="praline-tpu benchmark")
    ap.add_argument("config", nargs="?", default="cells",
                    choices=sorted(CONFIGS) + sorted(SIMULATED))
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "xla", "triton"])
    args = ap.parse_args(argv)
    if args.config in SIMULATED:
        print(json.dumps(SIMULATED[args.config]()))
        return 0

    import jax

    from praline_tpu.kernels.batch import resolve_backend
    from praline_tpu.util.jax_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()
    out = CONFIGS[args.config](backend=args.backend)
    out.update(platform=dev[0].platform, device_kind=dev[0].device_kind,
               device_count=len(dev), backend=resolve_backend(args.backend))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
