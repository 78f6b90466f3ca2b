"""Real multi-process jax.distributed execution on localhost (SURVEY.md
§5.4): 2 processes x 2 CPU devices, pair space sharded across processes,
terminals all-gathered over the (Gloo) cross-process backend."""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels import align_pairs_batched
from praline_tpu.types import Profile

WORKER = Path(__file__).parent / "mp_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_allpairs(tmp_path):
    port = free_port()
    out = tmp_path / "rank0.npz"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(port), str(out)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    data = np.load(out)

    # Reference: the same problems through the single-process batched path.
    rng = np.random.default_rng(0)
    B, A = 8, ALPHABET_AA.size
    cx = rng.integers(0, 2, size=(B, 15, A)).astype(np.float32)
    cx[:, :, 0] += 1
    cy = rng.integers(0, 2, size=(B, 13, A)).astype(np.float32)
    cy[:, :, 0] += 1
    pairs = [
        (
            Profile(cx[b], np.zeros(15, np.float32), ALPHABET_AA),
            Profile(cy[b], np.zeros(13, np.float32), ALPHABET_AA),
        )
        for b in range(B)
    ]
    want = align_pairs_batched(pairs, builtin_score_matrix("blosum62"), (11, 1), "global")
    np.testing.assert_array_equal(data["scores"], [w.score for w in want])
    np.testing.assert_array_equal(data["lengths"], [w.length for w in want])

    # The production indexed sharded dispatch, cross-process.
    toks, ix, iy = data["toks"], data["ix"], data["iy"]
    iprofs = [
        Profile.from_tokens(toks[u].astype(np.int32), ALPHABET_AA)
        for u in range(toks.shape[0])
    ]
    ipairs = [(iprofs[a], iprofs[b]) for a, b in zip(ix, iy)]
    iwant = align_pairs_batched(
        ipairs, builtin_score_matrix("blosum62"), (11, 1), "global"
    )
    np.testing.assert_array_equal(data["iscores"], [w.score for w in iwant])
    np.testing.assert_array_equal(data["ilengths"], [w.length for w in iwant])

    # Multi-track trackset driver cross-process (ADVICE r3): compare the
    # worker's mesh-driven align_tracksets_batched against the oracle.
    from praline_tpu.oracle import align_tracksets

    B62m = builtin_score_matrix("blosum62")
    PAMm = builtin_score_matrix("pam250")
    trng = np.random.default_rng(12)
    tpairs = []
    for _ in range(6):
        Lx, Ly = int(trng.integers(4, 14)), int(trng.integers(4, 14))
        mk = lambda L: Profile.from_tokens(
            trng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )
        tpairs.append(((mk(Lx), mk(Lx)), (mk(Ly), mk(Ly))))
    twant = [
        align_tracksets(txs, tys, [B62m, PAMm], (1.0, 0.5), (11, 1), "global")
        for txs, tys in tpairs
    ]
    np.testing.assert_array_equal(data["tscores"], [w.score for w in twant])
    np.testing.assert_array_equal(
        data["tcols"], np.concatenate([w.cols_x for w in twant])
    )

    # Oversized-Ly scores cross-process vs the oracle.
    from praline_tpu.oracle import align_profiles

    crng = np.random.default_rng(5)

    def _mkp(L):
        return Profile.from_tokens(
            crng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    cpairs = [
        (_mkp(int(crng.integers(8, 15))), _mkp(int(crng.integers(30, 45))))
        for _ in range(5)
    ]
    cwant = [
        align_profiles(px, py, B62m, (11, 1), "global") for px, py in cpairs
    ]
    np.testing.assert_array_equal(data["cscores"], [w.score for w in cwant])
    np.testing.assert_array_equal(data["clengths"], [w.length for w in cwant])

    # Oversized-Ly TRACEBACK dispatch cross-process — full path equality
    # vs the oracle.
    ctwant = [
        align_profiles(px, py, B62m, (11, 1), "semiglobal")
        for px, py in cpairs
    ]
    np.testing.assert_array_equal(data["ctscores"], [w.score for w in ctwant])
    np.testing.assert_array_equal(
        data["ctcols"],
        np.concatenate(
            [w.cols_x for w in ctwant] + [w.cols_y for w in ctwant]
        ),
    )
