#!/usr/bin/env python
"""Smoke test of the alignment engine on one NVIDIA GPU, at real sizes.

    python chip_smoke.py             # one card: kernels, routes, end to end
    python chip_smoke.py --cards 4   # four cards: the sharded routes only

Every phase compares what the device computed with an independent
reference — the native C++ twin (``praline_tpu/native/gotoh.cpp``), the
NumPy oracle, or the committed golden outputs — exactly (``==`` on float32
scores, lengths, terminals and paths).  A phase that fails raises, and the
script exits non-zero without printing a result.  Informational lines
(stage times, peak device memory) go to standard output before the last
line, which is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Inputs are generated from fixed seeds.  The script refuses to run where
JAX finds no GPU, and drives the card from this one process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "testdata"

# Problem sizes of each phase: (min, max) lengths, batch sizes, job sizes.
SIZES = dict(
    scores_L=(512, 1023), scores_B=1024, scores_bucket=1023,
    tb_L=(256, 511), tb_B=64, tb_bucket=511,
    stream_min_L=2048, ckpt_L=20000,
    tracks_L=(128, 255), tracks_B=128, tracks_bucket=255,
    job_big=(500, 250, 350), job_pp=(100, 280, 320),
)

# The golden CLI configurations (tests/e2e/test_goldens.py), as CLI flags.
GOLDEN_FLAGS = {
    "family10.default": [],
    "family10.ppglobal": ["-p", "global"],
    "family10.series3_local": ["-g", "13,7,1", "--distance-mode", "local",
                               "--linkage", "complete"],
    "family16div.default": [],
    "family16div.pam250_semi_pplocal": [
        "-m", "pam250", "--mode", "semiglobal", "--distance-mode", "global",
        "-p", "local", "-g", "10,2", "--linkage", "single"],
    "dna8.default": ["-a", "dna", "-m", "dna_simple", "-g", "8,2"],
    "family64.default": [],
    "family64.semi_series3": ["-g", "12,6,1", "--mode", "semiglobal",
                              "--distance-mode", "global"],
}


def result_line(devices) -> str:
    """The last line of a passing run."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def phases(cards: int) -> list[str]:
    """The phases a run with ``cards`` cards executes, in order."""
    if cards == 1:
        return ["kernels", "end_to_end"]
    return ["multi_card"]


def _say(msg: str) -> None:
    print(msg, flush=True)


def _timed(name: str):
    class _T:
        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            if exc[0] is None:
                _say(f"phase {name}: ok in {time.perf_counter() - self.t0:.1f}s")

    return _T()


def _count_profile(rng, L, A):
    """Integer-count profile column stack with ragged column totals, so
    the column inverses are not all 1 (the rounding the twin pins)."""
    from praline_tpu.types import Profile

    c = rng.integers(0, 2, size=(L, A)).astype(np.float32)
    c[:, 0] += 1.0
    return Profile(c, np.zeros(L, np.float32), _aa())


def _aa():
    from praline_tpu import ALPHABET_AA

    return ALPHABET_AA


def family(n, lo, hi, seed):
    """A seeded protein family: one ancestor, ~20% substitutions and
    indels per member, member lengths uniform in [lo, hi]."""
    from praline_tpu.types import Sequence

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=(lo + hi) // 2)
    out = []
    for i in range(n):
        toks = base.copy()
        sub = rng.random(toks.size) < 0.2
        toks[sub] = rng.integers(0, 20, size=int(sub.sum()))
        target = int(rng.integers(lo, hi + 1))
        while toks.size > target:
            toks = np.delete(toks, int(rng.integers(0, toks.size)))
        while toks.size < target:
            toks = np.insert(toks, int(rng.integers(0, toks.size + 1)),
                             int(rng.integers(0, 20)))
        out.append(Sequence(f"s{i}", toks.astype(np.int32), _aa()))
    return out


def _native(px, py, matrix, gaps, mode):
    from praline_tpu.native import native_align_scores
    from praline_tpu.oracle.score import pair_score_matrix

    return native_align_scores(pair_score_matrix(px, py, matrix), gaps, mode)


def _same_path(got, want, what):
    assert got.score == want.score, (what, got.score, want.score)
    assert np.array_equal(got.cols_x, want.cols_x), what
    assert np.array_equal(got.cols_y, want.cols_y), what


def phase_kernels():
    """Each device route at a real width against the native twin or the
    oracle."""
    import jax.numpy as jnp

    from praline_tpu import builtin_score_matrix
    from praline_tpu.kernels import align_pairs_batched, align_tracksets_batched
    from praline_tpu.kernels import batch as batch_mod
    from praline_tpu.kernels.replay import moves_to_result
    from praline_tpu.kernels.scan import wavefront_dp_checkpointed
    from praline_tpu.native import native_batch_scores
    from praline_tpu.oracle import align_tracksets
    from praline_tpu.oracle.score import column_inverses, pair_score_matrix
    from praline_tpu.types import Profile

    m = builtin_score_matrix("blosum62")
    A = m.alphabet.size
    rng = np.random.default_rng(0)
    z = SIZES

    (lo, hi), B, bk = z["scores_L"], z["scores_B"], z["scores_bucket"]
    with _timed(f"scores dispatch, bucket {bk}, B={B}"):
        profs = [_count_profile(rng, int(rng.integers(lo, hi + 1)), A)
                 for _ in range(256)]
        pairs = [(profs[(i * 7) % 256], profs[(i * 13 + 5) % 256])
                 for i in range(B)]
        got = align_pairs_batched(pairs, m, (11, 1), "global",
                                  bucket_sizes=(bk,), batch_pairs=B)
        route = batch_mod.resolve_backend("auto")
        if route != "xla":  # the hand-written kernel against the XLA scan
            ref = align_pairs_batched(pairs, m, (11, 1), "global",
                                      bucket_sizes=(bk,), batch_pairs=B,
                                      backend="xla")
            key = lambda r: (r.score, r.length, r.ti, r.tj)  # noqa: E731
            assert [key(r) for r in got] == [key(r) for r in ref], route
        sample = rng.choice(len(pairs), size=min(64, B), replace=False)
        scores, lengths = native_batch_scores(
            [pair_score_matrix(*pairs[i], m) for i in sample], (11, 1), "global")
        for i, sc, ln in zip(sample, scores, lengths):
            r = got[i]
            assert (r.score, r.length) == (float(sc), float(ln)), (i, r, sc, ln)
            assert (r.ti, r.tj) == (pairs[i][0].length, pairs[i][1].length)

    (lo, hi), B, bk = z["tb_L"], z["tb_B"], z["tb_bucket"]
    with _timed(f"traceback + device replay, bucket {bk}, 3 modes x 2 series"):
        tb_pairs = [(_count_profile(rng, int(rng.integers(lo, hi + 1)), A),
                     _count_profile(rng, int(rng.integers(lo, hi + 1)), A))
                    for _ in range(B)]
        for mode in ("global", "semiglobal", "local"):
            for gaps in ((11, 1), (13, 7, 1)):
                got = align_pairs_batched(tb_pairs, m, gaps, mode,
                                          traceback=True, bucket_sizes=(bk,),
                                          batch_pairs=B)
                for k, (px, py) in enumerate(tb_pairs):
                    _same_path(got[k], _native(px, py, m, gaps, mode),
                               f"tb {mode} {gaps} #{k}")

    # Smallest square problem whose materialized score tensors pass the
    # device's HS budget: it must take the streamed route.
    L = z["stream_min_L"]
    while batch_mod.per_problem_bytes(L, L)[0] <= batch_mod._budget("HS"):
        L += 512
    with _timed(f"streamed route, one {L}x{L} pair with traceback"):
        px, py = _count_profile(rng, L, A), _count_profile(rng, L - 7, A)
        (r,) = align_pairs_batched([(px, py)], m, (11, 1), "semiglobal",
                                   traceback=True)
        _same_path(r, _native(px, py, m, (11, 1), "semiglobal"), "streamed")

    L = z["ckpt_L"]
    with _timed(f"checkpointed traceback, one {L}x{L} pair"):
        px = Profile.from_tokens(rng.integers(0, 20, L).astype(np.int32), _aa())
        py = Profile.from_tokens(rng.integers(0, 20, L).astype(np.int32), _aa())
        ops = [px.counts[None], column_inverses(px)[None],
               py.counts[None], column_inverses(py)[None], m.as_f32(),
               np.array([px.length], np.int32), np.array([py.length], np.int32)]
        out = wavefront_dp_checkpointed(*map(jnp.asarray, ops),
                                        gap_series=(11, 1), mode="global")
        r = moves_to_result(
            np.asarray(out["moves"])[0], int(np.asarray(out["nmoves"])[0]),
            float(np.asarray(out["score"])[0]), int(np.asarray(out["ti"])[0]),
            int(np.asarray(out["tj"])[0]), px.length, py.length, "global")
        _same_path(r, _native(px, py, m, (11, 1), "global"), "checkpointed")

    (lo, hi), B, bk = z["tracks_L"], z["tracks_B"], z["tracks_bucket"]
    with _timed(f"two-track composite, B={B}, bucket {bk}"):
        mats = [m, builtin_score_matrix("pam250")]
        w = (1.0, 0.5)
        seqs = [Profile.from_tokens(
            rng.integers(0, 20, int(rng.integers(lo, hi + 1))).astype(np.int32),
            _aa()) for _ in range(32)]
        tpairs = [((seqs[i % 32],) * 2, (seqs[(i * 5 + 1) % 32],) * 2)
                  for i in range(B)]
        for tb in (False, True):
            got = align_tracksets_batched(tpairs, mats, w, (11, 1), "global",
                                          traceback=tb, bucket_sizes=(bk,),
                                          batch_pairs=B)
            for k in (0, B - 1):
                want = align_tracksets(*tpairs[k], mats, w, (11, 1), "global")
                if tb:
                    _same_path(got[k], want, f"tracks #{k}")
                else:
                    assert (got[k].score, got[k].length) == (
                        want.score, float(want.length)), k


def _peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0))


def _check_job(tag, seqs, cfg, m):
    """Run one MSA job; every row must be its input with gaps removed and
    sampled distance entries must equal the native twin."""
    import praline_tpu.msa.pipeline as pipeline
    from praline_tpu.native import native_batch_scores
    from praline_tpu.oracle.profile import member_profile
    from praline_tpu.oracle.score import pair_score_matrix
    from praline_tpu.types import GAP
    from praline_tpu.util.metrics import METRICS

    seen = {}
    real = pipeline.batched_all_pairs

    def spy(sequences, *a, **kw):
        seen["seqs"] = sequences
        seen["out"] = real(sequences, *a, **kw)
        return seen["out"]

    pipeline.batched_all_pairs = spy
    try:
        t0 = time.perf_counter()
        aln = pipeline.msa_align(seqs, m, cfg)
        wall = time.perf_counter() - t0
    finally:
        pipeline.batched_all_pairs = real
    for k, seq in enumerate(seqs):
        row = aln.rows[k]
        assert np.array_equal(row[row != GAP], seq.tokens), (tag, k)
    scores, lengths = seen["out"]
    rng = np.random.default_rng(1)
    ij = [tuple(sorted(rng.choice(len(seqs), 2, replace=False)))
          for _ in range(32)]
    profs = [member_profile(s) for s in seen["seqs"]]
    ns, nl = native_batch_scores(
        [pair_score_matrix(profs[i], profs[j], m) for i, j in ij],
        cfg.gap_series, cfg.distance_mode)
    for (i, j), sc, ln in zip(ij, ns, nl):
        assert scores[i, j] == sc and lengths[i, j] == ln, (tag, i, j)
    stages = {k: round(v.seconds, 3) for k, v in METRICS.stages.items()}
    _say(f"METRICS {tag}: wall {wall:.2f}s stages {json.dumps(stages)} "
         f"peak_bytes_in_use {_peak_bytes()}")
    return aln


def phase_end_to_end():
    """The CLI on every golden configuration (byte-equal outputs), then
    the N=500 default job and the N=100 global-preprofile job."""
    from praline_tpu import PralineConfig, builtin_score_matrix
    from praline_tpu.cli.main import main as cli_main

    with _timed(f"CLI on {len(GOLDEN_FLAGS)} golden configurations"), \
            tempfile.TemporaryDirectory() as tmp:
        for tag, flags in GOLDEN_FLAGS.items():
            fam = tag.split(".")[0]
            for ext in ("fasta", "aln"):
                out = Path(tmp) / f"{tag}.{ext}"
                rc = cli_main([str(TESTDATA / f"{fam}.fasta"), str(out), *flags])
                assert rc == 0, (tag, rc)
                want = (TESTDATA / f"{tag}.golden.{ext}").read_text()
                assert out.read_text() == want, f"{tag}.{ext} differs from golden"

    m = builtin_score_matrix("blosum62")
    n, lo, hi = SIZES["job_big"]
    with _timed(f"N={n} x {lo}-{hi} aa, default config"):
        _check_job(f"n{n}", family(n, lo, hi, seed=500), PralineConfig(), m)
    n, lo, hi = SIZES["job_pp"]
    with _timed(f"N={n} x {lo}-{hi} aa, -p global"):
        _check_job(f"n{n}_ppglobal", family(n, lo, hi, seed=100),
                   PralineConfig(preprofile_mode="global"), m)


def phase_multi_card():
    """The N=500 job sharded over four cards (byte-equal to one card) and
    every sharded route against its unsharded result."""
    import jax

    from praline_tpu import PralineConfig, builtin_score_matrix
    from praline_tpu.io import format_alignment_fasta
    from __graft_entry__ import dryrun_multichip

    n = len(jax.devices())
    m = builtin_score_matrix("blosum62")
    N, lo, hi = SIZES["job_big"]
    seqs = family(N, lo, hi, seed=500)
    with _timed(f"N={N} job on 1 card and on a {n}-card mesh"):
        one = _check_job(f"n{N}_1card", seqs, PralineConfig(), m)
        many = _check_job(f"n{N}_{n}cards", seqs,
                          PralineConfig(mesh_shape=(n,)), m)
        assert format_alignment_fasta(many) == format_alignment_fasta(one)
    with _timed(f"sharded routes on {n} cards"):
        dryrun_multichip(n, real_size=SIZES["job_big"][0] >= 500)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="1: kernels, routes and end-to-end jobs on one card; "
                    "4: the sharded routes on a four-card mesh")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"error: JAX found no GPU (platform {devices[0].platform})",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"error: --cards {args.cards} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    devices = devices[: args.cards]
    if args.cards == 1:
        jax.config.update("jax_default_device", devices[0])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from praline_tpu.util.jax_cache import enable_compile_cache

    _say(f"nvidia-smi: {smi}")
    _say(f"jax {jax.__version__}, device_kind {devices[0].device_kind}, "
         f"{len(devices)} device(s), compile cache {enable_compile_cache()}")
    for name in phases(args.cards):
        globals()[f"phase_{name}"]()
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
