"""Checkpointed (Hirschberg-class linear-memory) traceback: the forward
pass snapshots its carry every R diagonals, the backward pass re-derives
each block's direction bits and walks the move tape block by block
(SURVEY.md §6 long-context row, §9 hard part 2) — bit-identical to the
full-tensor replay by construction, O(L^1.5) memory instead of O(L^2)."""

import numpy as np
import pytest

import jax.numpy as jnp

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels import align_pairs_batched
from praline_tpu.kernels import batch as batch_mod
from praline_tpu.kernels.replay import replay_moves
from praline_tpu.kernels.scan import wavefront_dp, wavefront_dp_checkpointed
from praline_tpu.kernels.scores import skewed_pair_scores
from praline_tpu.oracle import align_profiles
from praline_tpu.types import Profile

B62 = builtin_score_matrix("blosum62")


def _rand_profiles(rng, B, Lx, Ly, A=23):
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx = (1.0 / np.maximum(cx.sum(-1), 1)).astype(np.float32)
    ivy = (1.0 / np.maximum(cy.sum(-1), 1)).astype(np.float32)
    lx = rng.integers(max(1, Lx // 2), Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(max(1, Ly // 2), Ly + 1, size=B).astype(np.int32)
    return cx, ivx, cy, ivy, lx, ly


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
@pytest.mark.parametrize("gs", [(11, 1), (13, 7, 1)])
@pytest.mark.parametrize("interval", [None, 2, 7, 200])
def test_checkpointed_matches_full_replay(mode, gs, interval):
    """Terminals AND the move tape are bit-equal to the full-tb walk for
    every block size — including R=2 (minimum), odd R, and R > D."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(repr((mode, gs, interval)).encode()))
    cx, ivx, cy, ivy, lx, ly = _rand_profiles(rng, 3, 45, 33)
    s = np.asarray(B62.as_f32())
    hs = skewed_pair_scores(*map(jnp.asarray, (cx, ivx, cy, ivy, s)))
    want = wavefront_dp(hs, jnp.asarray(lx), jnp.asarray(ly),
                        gap_series=gs, mode=mode, traceback=True)
    wm, wn = replay_moves(want["tb"], want["ti"], want["tj"], want["tcode"],
                          gap_series=gs, mode=mode, steps=45 + 33)
    got = wavefront_dp_checkpointed(
        *map(jnp.asarray, (cx, ivx, cy, ivy, s, lx, ly)),
        gap_series=gs, mode=mode, interval=interval,
    )
    for key in ("score", "length", "ti", "tj", "tcode"):
        np.testing.assert_array_equal(
            np.asarray(want[key]), np.asarray(got[key]), err_msg=key
        )
    wm, wn = np.asarray(wm), np.asarray(wn)
    gm, gn = np.asarray(got["moves"]), np.asarray(got["nmoves"])
    np.testing.assert_array_equal(wn, gn)
    for b in range(wm.shape[0]):
        np.testing.assert_array_equal(wm[b][: wn[b]], gm[b][: gn[b]])
        assert not gm[b][gn[b]:].any()  # compacted: zeros strictly trail


def test_checkpointed_local_matches_full_walk():
    """Round 3: the checkpointed walk covers local mode too (the
    stop-at-zero rule rides bit 7 of the re-derived direction bytes)."""
    from praline_tpu.kernels.replay import replay_moves
    from praline_tpu.kernels.scan import wavefront_dp_streamed

    rng = np.random.default_rng(0)
    cx, ivx, cy, ivy, lx, ly = _rand_profiles(rng, 3, 33, 29)
    s = np.asarray(B62.as_f32())
    args = tuple(map(jnp.asarray, (cx, ivx, cy, ivy, s, lx, ly)))
    got = wavefront_dp_checkpointed(*args, mode="local", interval=8)
    full = wavefront_dp_streamed(*args, mode="local", traceback=True)
    moves, nmv = replay_moves(
        full["tb"], full["ti"], full["tj"], full["tcode"],
        mode="local", steps=33 + 29,
    )
    np.testing.assert_array_equal(np.asarray(got["score"]), np.asarray(full["score"]))
    np.testing.assert_array_equal(np.asarray(got["nmoves"]), np.asarray(nmv))
    gm, fm = np.asarray(got["moves"]), np.asarray(moves)
    for b in range(3):
        n = int(np.asarray(nmv)[b])
        np.testing.assert_array_equal(gm[b, :n], fm[b, :n])


def _pairs(rng, specs):
    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    return [(one(a), one(b)) for a, b in specs]


@pytest.mark.parametrize("trial", range(8))
def test_checkpointed_fuzz_vs_oracle(monkeypatch, trial):
    """Random shapes / gap series / modes through the forced checkpointed
    route must reproduce the oracle's exact path."""
    monkeypatch.setattr(batch_mod, "HS_BYTES_BUDGET", 0)  # stream everything
    monkeypatch.setattr(batch_mod, "TB_BYTES_BUDGET", 16)
    rng = np.random.default_rng(4000 + trial)
    gs = [(11, 1), (13, 7, 1), (5,), (10, 5, 3, 1)][trial % 4]
    mode = ["global", "semiglobal"][trial % 2]
    pairs = _pairs(
        rng,
        [(int(rng.integers(9, 40)), int(rng.integers(9, 40))) for _ in range(4)],
    )
    got = align_pairs_batched(
        pairs, B62, gs, mode, traceback=True, bucket_sizes=(7,),
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, gs, mode)
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_giant_traceback_routes_to_checkpointed(monkeypatch, mode):
    """Past the traceback-bit budget, global/semiglobal pairs stay ON
    DEVICE via the checkpointed walk (the native host twin is now only the
    local-mode fallback) and return oracle-identical paths."""
    monkeypatch.setattr(
        batch_mod, "HS_BYTES_BUDGET", batch_mod.per_problem_bytes(15, 15)[0]
    )
    monkeypatch.setattr(batch_mod, "TB_BYTES_BUDGET", 64)

    def no_native(*a, **kw):  # the device path must not fall back
        raise AssertionError("native fallback taken for a ckpt-eligible mode")

    import praline_tpu.native as native_mod

    monkeypatch.setattr(native_mod, "native_align_scores", no_native)
    rng = np.random.default_rng(17)
    pairs = _pairs(rng, [(25, 18), (31, 30), (25, 9)])
    got = align_pairs_batched(
        pairs, B62, (11, 1), mode, traceback=True,
        bucket_sizes=(15,),
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), mode)
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)
