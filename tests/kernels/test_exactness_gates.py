"""Exactness admission gates (ADVICE r3): the arena's narrow integer stack
dtypes are only admitted when provably exact — integer-valued counts."""

import numpy as np

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels.batch import ProfileArena, align_pairs_batched
from praline_tpu.oracle import align_profiles
from praline_tpu.types import Profile

B62 = builtin_score_matrix("blosum62")


def _frac_prof(rng, L):
    """Profile with FRACTIONAL (half-integer) counts — exact in binary, so
    the oracle contraction stays order-independent, but not integer-valued."""
    counts = rng.integers(0, 4, size=(L, ALPHABET_AA.size)).astype(np.float32)
    counts += 0.5
    return Profile(counts, np.zeros(L, np.float32), ALPHABET_AA)


def test_arena_fractional_counts_never_narrow_to_int_dtypes():
    rng = np.random.default_rng(7)
    arena = ProfileArena(ALPHABET_AA.size, (31,))
    profs = [_frac_prof(rng, 9), _frac_prof(rng, 12)]
    for p in profs:
        arena.reg(p)
    st = arena.stack(31)
    assert st["ints"] is False
    # uint8 would silently truncate the 0.5s (ADVICE r3) — must stay f32.
    assert np.asarray(st["stack"]).dtype == np.float32


def test_fractional_count_profiles_match_oracle_through_batched_path():
    rng = np.random.default_rng(8)
    pairs = [
        (_frac_prof(rng, int(rng.integers(4, 14))), _frac_prof(rng, int(rng.integers(4, 14))))
        for _ in range(5)
    ]
    got = align_pairs_batched(pairs, B62, (11, 1), "global", traceback=True)
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), "global")
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_integer_count_profiles_still_narrow():
    rng = np.random.default_rng(9)
    arena = ProfileArena(ALPHABET_AA.size, (31,))
    counts = rng.integers(0, 4, size=(10, ALPHABET_AA.size)).astype(np.float32)
    counts[0, 0] = 3.0
    arena.reg(Profile(counts, np.zeros(10, np.float32), ALPHABET_AA))
    st = arena.stack(31)
    assert st["ints"] is True
    assert np.asarray(st["stack"]).dtype == np.uint8
