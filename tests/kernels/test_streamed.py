"""Oversized execution: streamed-producer scan + routing (VERDICT r1
item 6 / ADVICE r1: the memory budget is a router, not an error).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels import align_pairs_batched
from praline_tpu.kernels import batch as batch_mod
from praline_tpu.kernels.scan import wavefront_dp, wavefront_dp_streamed
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


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("gs", [(11, 1), (13, 7, 1)])
def test_streamed_equals_materialized(mode, gs):
    rng = np.random.default_rng(0)
    cx, ivx, cy, ivy, lx, ly = _rand_profiles(rng, 4, 37, 29)
    s = np.asarray(B62.as_f32())
    hs = skewed_pair_scores(*map(jnp.asarray, (cx, ivx, cy, ivy, s)))
    a = wavefront_dp(hs, jnp.asarray(lx), jnp.asarray(ly),
                     gap_series=gs, mode=mode, traceback=True)
    b = wavefront_dp_streamed(
        *map(jnp.asarray, (cx, ivx, cy, ivy, s, lx, ly)),
        gap_series=gs, mode=mode, traceback=True,
    )
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


def _stream_past_bucket(monkeypatch, b=15):
    """Budget the materialized producer to exactly one (b, b) problem, so
    pairs longer than the bucket ceiling take the streamed route."""
    monkeypatch.setattr(
        batch_mod, "HS_BYTES_BUDGET", batch_mod.per_problem_bytes(b, b)[0]
    )


def _pairs(rng, specs):
    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    return [(one(a), one(b)) for a, b in specs]


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_lane_cap_routes_to_streamed(monkeypatch, mode):
    """Pairs past the (mocked-down) memory budget must run — bit-equal to
    the oracle — on the streamed route instead of raising."""
    _stream_past_bucket(monkeypatch)
    rng = np.random.default_rng(5)
    # 25 > the 15-bucket budget -> streamed; 12 stays on the normal path.
    pairs = _pairs(rng, [(25, 9), (25, 30), (12, 9), (40, 8)])
    got = align_pairs_batched(
        pairs, B62, (11, 1), mode, traceback=True,
        bucket_sizes=(15,),
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), mode)
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_lane_cap_routes_scores_only(monkeypatch):
    _stream_past_bucket(monkeypatch)
    rng = np.random.default_rng(6)
    pairs = _pairs(rng, [(25, 9), (33, 21)])
    got = align_pairs_batched(
        pairs, B62, (11, 1), "global", bucket_sizes=(15,)
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), "global")
        assert r.score == want.score and r.length == want.length


def test_huge_traceback_stays_on_device_local(monkeypatch):
    """Past the traceback-bit budget even LOCAL-mode pairs stay on device:
    the stop-at-zero rule rides bit 7, so the checkpointed walk covers all
    modes (round 3; global/semiglobal in test_checkpointed.py)."""
    _stream_past_bucket(monkeypatch)
    monkeypatch.setattr(batch_mod, "TB_BYTES_BUDGET", 64)
    rng = np.random.default_rng(9)
    pairs = _pairs(rng, [(25, 18)])
    got = align_pairs_batched(
        pairs, B62, (11, 1), "local", traceback=True,
        bucket_sizes=(15,),
    )
    (px, py), (r,) = pairs[0], got
    want = align_profiles(px, py, B62, (11, 1), "local")
    assert r.score == want.score
    np.testing.assert_array_equal(r.cols_x, want.cols_x)
    np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_xla_hs_budget_routes_to_streamed(monkeypatch):
    monkeypatch.setattr(batch_mod, "HS_BYTES_BUDGET", 1024)
    rng = np.random.default_rng(13)
    pairs = _pairs(rng, [(40, 35)])
    got = align_pairs_batched(
        pairs, B62, (11, 1), "global", bucket_sizes=(15,), backend="xla"
    )
    (px, py), (r,) = pairs[0], got
    want = align_profiles(px, py, B62, (11, 1), "global")
    assert r.score == want.score


@pytest.mark.gpu
def test_lx50k_parity_vs_native(gpu):
    """VERDICT r1 item 6 done-bar: bit-parity at Lx = 50k on the streamed
    route, no ValueError (too slow for XLA:CPU; runs on the GPU)."""
    from praline_tpu.native import native_align_scores
    from praline_tpu.oracle.score import pair_score_matrix

    rng = np.random.default_rng(0)
    px = Profile.from_tokens(rng.integers(0, 20, size=50_000).astype(np.int32), ALPHABET_AA)
    py = Profile.from_tokens(rng.integers(0, 20, size=300).astype(np.int32), ALPHABET_AA)
    (r,) = align_pairs_batched([(px, py)], B62, (11, 1), "global")
    want = native_align_scores(pair_score_matrix(px, py, B62), (11, 1), "global")
    assert r.score == want.score and r.length == want.length


def test_profile_arena_invalidation_across_calls():
    """A shared arena must rebuild a bucket's stack when later calls
    register new profiles into it (round-2: cross-tile arena)."""
    from praline_tpu.kernels.batch import ProfileArena

    rng = np.random.default_rng(21)
    arena = ProfileArena(ALPHABET_AA.size, (31,))
    profs = [
        Profile.from_tokens(rng.integers(0, 20, size=int(rng.integers(5, 30))).astype(np.int32), ALPHABET_AA)
        for _ in range(7)
    ]
    first = [(profs[0], profs[1]), (profs[1], profs[2])]
    got1 = align_pairs_batched(first, B62, (11, 1), "global",
                               bucket_sizes=(31,), arena=arena, backend="xla")
    # second call introduces NEW profiles into the same bucket
    second = [(profs[3], profs[4]), (profs[0], profs[5]), (profs[6], profs[2])]
    got2 = align_pairs_batched(second, B62, (11, 1), "global",
                               bucket_sizes=(31,), arena=arena, backend="xla")
    for pairs, got in ((first, got1), (second, got2)):
        for (px, py), r in zip(pairs, got):
            want = align_profiles(px, py, B62, (11, 1), "global")
            assert r.score == want.score and r.length == want.length
    with pytest.raises(ValueError):
        align_pairs_batched(first, B62, (11, 1), "global",
                            bucket_sizes=(63,), arena=arena)
