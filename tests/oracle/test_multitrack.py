"""Multi-track composite scoring (SURVEY.md C4, §8.1): the reference's
weighted per-track score combination, oracle + device parity."""

import numpy as np
import pytest

from praline_tpu import ALPHABET_AA, ALPHABET_DNA, builtin_score_matrix
from praline_tpu.kernels import align_tracksets_batched
from praline_tpu.oracle import align_profiles, align_scores, align_tracksets
from praline_tpu.oracle.score import (
    composite_pair_score_matrix,
    pair_score_matrix,
)
from praline_tpu.types import Profile

B62 = builtin_score_matrix("blosum62")
PAM = builtin_score_matrix("pam250")
DNA = builtin_score_matrix("dna_simple")


def _prof(rng, L, alphabet=ALPHABET_AA):
    hi = min(20, alphabet.size - 1)
    return Profile.from_tokens(
        rng.integers(0, hi, size=L).astype(np.int32), alphabet
    )


def test_single_track_weight_one_reduces_to_plain():
    rng = np.random.default_rng(0)
    px, py = _prof(rng, 14), _prof(rng, 11)
    h = composite_pair_score_matrix([px], [py], [B62], [1.0])
    np.testing.assert_array_equal(h, pair_score_matrix(px, py, B62))
    a = align_tracksets([px], [py], [B62], [1.0], (11, 1), "global")
    b = align_profiles(px, py, B62, (11, 1), "global")
    assert a.score == b.score and (a.cols_x == b.cols_x).all()


def test_zero_weight_track_is_inert():
    rng = np.random.default_rng(1)
    px, py = _prof(rng, 12), _prof(rng, 13)
    qx, qy = _prof(rng, 12), _prof(rng, 13)
    h1 = composite_pair_score_matrix([px], [py], [B62], [1.0])
    h2 = composite_pair_score_matrix([px, qx], [py, qy], [B62, PAM], [1.0, 0.0])
    np.testing.assert_array_equal(h1, h2)


def test_two_track_weighted_sum_matches_manual():
    rng = np.random.default_rng(2)
    px, py = _prof(rng, 9), _prof(rng, 8)
    qx, qy = _prof(rng, 9), _prof(rng, 8)
    w = (0.75, 0.5)
    h = composite_pair_score_matrix([px, qx], [py, qy], [B62, PAM], w)
    manual = np.float32(w[0]) * pair_score_matrix(px, py, B62)
    manual = manual + np.float32(w[1]) * pair_score_matrix(qx, qy, PAM)
    np.testing.assert_array_equal(h, manual)
    res = align_tracksets([px, qx], [py, qy], [B62, PAM], w, (11, 1), "global")
    ref = align_scores(manual, (11, 1), "global")
    assert res.score == ref.score and (res.cols_x == ref.cols_x).all()


def test_mixed_alphabet_tracks():
    # Tracks may use different alphabets/matrices (e.g. residues + a
    # coarse structural alphabet); only lengths must be parallel.
    rng = np.random.default_rng(3)
    px, py = _prof(rng, 10), _prof(rng, 7)
    sx, sy = _prof(rng, 10, ALPHABET_DNA), _prof(rng, 7, ALPHABET_DNA)
    h = composite_pair_score_matrix([px, sx], [py, sy], [B62, DNA], (1.0, 2.0))
    assert h.shape == (10, 7) and np.isfinite(h).all()


def test_validation_errors():
    rng = np.random.default_rng(4)
    px, py = _prof(rng, 5), _prof(rng, 6)
    with pytest.raises(ValueError):
        composite_pair_score_matrix([], [], [], [])
    with pytest.raises(ValueError):
        composite_pair_score_matrix([px], [py], [B62], [1.0, 2.0])
    with pytest.raises(ValueError):
        composite_pair_score_matrix([px, _prof(rng, 4)], [py, py], [B62, B62], [1, 1])


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("traceback", [False, True])
def test_batched_tracksets_match_oracle(mode, traceback):
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(7):
        Lx, Ly = int(rng.integers(3, 18)), int(rng.integers(3, 18))
        pairs.append(
            (
                (_prof(rng, Lx), _prof(rng, Lx)),
                (_prof(rng, Ly), _prof(rng, Ly)),
            )
        )
    mats, w = [B62, PAM], (1.0, 0.25)
    got = align_tracksets_batched(pairs, mats, w, (11, 1), mode, traceback=traceback)
    for (txs, tys), r in zip(pairs, got):
        want = align_tracksets(txs, tys, mats, w, (11, 1), mode)
        assert r.score == want.score
        if traceback:
            np.testing.assert_array_equal(r.cols_x, want.cols_x)
            np.testing.assert_array_equal(r.cols_y, want.cols_y)
        else:
            assert r.length == want.length


def test_batched_tracksets_degenerate_and_gap_series():
    rng = np.random.default_rng(6)
    empty = Profile.from_tokens(np.zeros(0, np.int32), ALPHABET_AA)
    pairs = [
        ((empty, empty), (_prof(rng, 5), _prof(rng, 5))),
        ((_prof(rng, 4), _prof(rng, 4)), (_prof(rng, 6), _prof(rng, 6))),
    ]
    got = align_tracksets_batched(
        pairs, [B62, PAM], (1.0, 1.0), (13, 7, 1), "global", traceback=True
    )
    for (txs, tys), r in zip(pairs, got):
        want = align_tracksets(txs, tys, [B62, PAM], (1.0, 1.0), (13, 7, 1), "global")
        assert r.score == want.score


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_batched_tracksets_ragged_buckets_async(mode):
    """First-class path (VERDICT r2 item 8): RAGGED tracksets share
    bucketed device stacks and indexed async dispatches — not exact-shape
    groups — and stay bit-identical to the oracle, traceback included."""
    rng = np.random.default_rng(17)
    mats, w = [B62, PAM], (1.0, 0.5)
    pairs = []
    for _ in range(37):  # crosses the 32-pair grid step
        Lx = int(rng.integers(3, 60))
        Ly = int(rng.integers(3, 60))
        pairs.append(
            ((_prof(rng, Lx), _prof(rng, Lx)), (_prof(rng, Ly), _prof(rng, Ly)))
        )
    got = align_tracksets_batched(
        pairs, mats, w, (11, 1), mode, traceback=True,
        bucket_sizes=(31, 63), batch_pairs=16,
    )
    for (txs, tys), r in zip(pairs, got):
        want = align_tracksets(txs, tys, mats, w, (11, 1), mode)
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_shared_first_track_distinct_tracksets_do_not_alias():
    """Two tracksets that SHARE the first-track Profile object but differ
    in another track must register as distinct rows — the registry keys on
    the full identity tuple, not id(ts[0]) (ADVICE r3, medium)."""
    rng = np.random.default_rng(51)
    shared_x, shared_y = _prof(rng, 12), _prof(rng, 9)
    pairs = [
        ((shared_x, _prof(rng, 12)), (shared_y, _prof(rng, 9))),
        ((shared_x, _prof(rng, 12)), (shared_y, _prof(rng, 9))),
    ]
    mats, w = [B62, PAM], (1.0, 1.0)
    got = align_tracksets_batched(pairs, mats, w, (11, 1), "global", traceback=True)
    wants = [align_tracksets(txs, tys, mats, w, (11, 1), "global") for txs, tys in pairs]
    # The two second tracks must actually disagree for this to be a test.
    assert wants[0].score != wants[1].score
    for r, want in zip(got, wants):
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_batched_tracksets_sharded_matches_plain():
    """Multi-track dispatch under a mesh (pair axis sharded) is bit-equal
    to the unsharded driver and the oracle."""
    from praline_tpu.dist import make_pair_mesh

    rng = np.random.default_rng(23)
    mats, w = [B62, PAM], (1.0, 0.25)
    pairs = []
    for _ in range(7):  # 7 pairs over 4 devices: shard padding too
        Lx, Ly = int(rng.integers(4, 30)), int(rng.integers(4, 30))
        pairs.append(
            ((_prof(rng, Lx), _prof(rng, Lx)), (_prof(rng, Ly), _prof(rng, Ly)))
        )
    mesh = make_pair_mesh(4)
    got = align_tracksets_batched(
        pairs, mats, w, (11, 1), "semiglobal", traceback=True,
        bucket_sizes=(31,), mesh=mesh,
    )
    for (txs, tys), r in zip(pairs, got):
        want = align_tracksets(txs, tys, mats, w, (11, 1), "semiglobal")
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_batched_tracksets_super_dispatch_groups():
    """Equal-shape trackset chunks collapse into one scan-of-n jit, results
    bit-equal to the oracle."""
    from praline_tpu.kernels import batch as batch_mod

    rng = np.random.default_rng(41)
    mats, w = [B62, PAM], (1.0, 0.5)
    pairs = []
    for _ in range(130):  # > 4 x 32-pair chunks at batch_pairs=32
        Lx, Ly = int(rng.integers(4, 30)), int(rng.integers(4, 30))
        pairs.append(
            ((_prof(rng, Lx), _prof(rng, Lx)), (_prof(rng, Ly), _prof(rng, Ly)))
        )
    calls = []
    real = batch_mod._composite_multi_jit

    def spy():
        fn = real()

        def wrapper(*a, **k):
            calls.append(tuple(a[6].shape))
            return fn(*a, **k)

        return wrapper

    import unittest.mock as mock
    with mock.patch.object(batch_mod, "_composite_multi_jit", spy):
        got = align_tracksets_batched(
            pairs, mats, w, (11, 1), "global", traceback=True,
            bucket_sizes=(31,), batch_pairs=32,
        )
    assert calls and calls[0][0] == 4, calls  # a scan-of-4 group ran
    for (txs, tys), r in zip(pairs, got):
        want = align_tracksets(txs, tys, mats, w, (11, 1), "global")
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("tb", [False, True])
def test_tracksets_ride_the_strip(monkeypatch, mode, tb):
    """Composite dispatches (per-track producers + the scan-boundary
    weighted accumulation + DP and device replay) are bit-identical to
    the oracle in every mode, scores and traceback; a distinctive bucket
    size guarantees a fresh trace in this test."""
    from praline_tpu.kernels import batch as batch_mod

    seen = []
    real = batch_mod.composite_dispatch_body

    def spy(*a, **k):
        seen.append(k.get("steps"))
        return real(*a, **k)

    monkeypatch.setattr(batch_mod, "composite_dispatch_body", spy)
    batch_mod._composite_indexed_jit.cache_clear()
    batch_mod._composite_multi_jit.cache_clear()
    rng = np.random.default_rng(91)
    mats, w = [B62, PAM], (1.0, 0.5)
    pairs = []
    for _ in range(16):
        Lx, Ly = int(rng.integers(20, 34)), int(rng.integers(20, 34))
        pairs.append(
            ((_prof(rng, Lx), _prof(rng, Lx)), (_prof(rng, Ly), _prof(rng, Ly)))
        )
    got = align_tracksets_batched(
        pairs, mats, w, (11, 1), mode, traceback=tb,
        bucket_sizes=(33,), batch_pairs=16,
    )
    # the spy fires at TRACE time; distinctive shapes guarantee a fresh
    # trace in this test
    assert seen, "the composite dispatch body did not run"
    for (txs, tys), r in zip(pairs, got):
        want = align_tracksets(txs, tys, mats, w, (11, 1), mode)
        assert r.score == want.score, (mode, tb)
        if tb:
            np.testing.assert_array_equal(r.cols_x, want.cols_x)
            np.testing.assert_array_equal(r.cols_y, want.cols_y)
        else:
            assert r.length == want.length
