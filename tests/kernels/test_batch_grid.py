"""Batch-grid contract for dispatch sizing (kernels.batch).

The grid steps by powers of four to 512 (bounds executable-shape count for
the ragged tail) and powers of two above (lets the widest dispatches land
near the memory budget, where dispatch-latency amortization pays).
"""

from praline_tpu.kernels.batch import (
    DISPATCH_BYTES_BUDGET,
    _grid_step,
    _snap_batch,
    per_problem_bytes,
)


def test_grid_sequence():
    seq = [32]
    while seq[-1] < 1 << 16:
        seq.append(_grid_step(seq[-1]))
    assert seq[:8] == [32, 128, 512, 1024, 2048, 4096, 8192, 16384]


def test_snap_batch_below_floor_is_exact_cap():
    assert _snap_batch(1, 100) == 1
    assert _snap_batch(31, 100) == 31
    assert _snap_batch(7, 3) == 3


def test_snap_batch_snaps_to_grid():
    assert _snap_batch(766, 4950) == 512
    # the pow2 top end is reachable (the old pow4 grid jumped 512 -> 2048)
    assert _snap_batch(1100, 4950) == 1024
    assert _snap_batch(38400, 124750) == 32768


def test_snap_batch_capped_by_pairs():
    # fewer pairs than the snapped cap: grid value <= pairs wins
    assert _snap_batch(1 << 20, 700) == 512
    assert _snap_batch(1 << 20, 1024) == 1024


def test_budget_admits_the_headline_dispatch(monkeypatch):
    # An H100's 80 GB with JAX's default 75% pool (bytes_limit as the card
    # reports it): the PRODUCTION per-problem estimate (shared helper, so
    # this cannot drift from the dispatcher) must admit a 1024-pair
    # scores dispatch at L=1023 on the XLA route, and the whole 8192-pair
    # headline tile on the lane-kernel route.
    from praline_tpu.kernels import batch as batch_mod

    monkeypatch.setattr(batch_mod, "device_memory_bytes", lambda: 63763120128)
    budget = batch_mod._budget("DISPATCH")
    hs_bytes, _ = per_problem_bytes(1023, 1023)
    assert _snap_batch(budget // hs_bytes, 1 << 20) >= 1024
    lane = batch_mod.lane_dp_bytes(1023, 1023, 23, 2)
    assert _snap_batch(budget // lane, 8192) == 8192
    # the CPU keeps its fixed constant
    monkeypatch.undo()
    assert batch_mod._budget("DISPATCH") == DISPATCH_BYTES_BUDGET


def test_grid_boundary_dispatch_matches_oracle(monkeypatch):
    """End-to-end dispatch that CROSSES a batch-grid boundary (ADVICE r2):
    a monkeypatched dispatch budget caps eff_batch at 32, so 40 ragged
    pairs run as one full 32-chunk plus an 8-chunk padded back up to 32;
    an uncapped run pads the same pairs to one 128-chunk.  Both must be
    bit-equal to the oracle — grid padding can never leak into results."""
    import numpy as np

    from praline_tpu import ALPHABET_AA, builtin_score_matrix
    from praline_tpu.kernels import align_pairs_batched
    from praline_tpu.kernels import batch as batch_mod
    from praline_tpu.oracle import align_profiles
    from praline_tpu.types import Profile

    rng = np.random.default_rng(7)
    m = builtin_score_matrix("blosum62")

    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    pairs = [(one(int(rng.integers(5, 64))), one(int(rng.integers(5, 64))))
             for _ in range(40)]
    hs_bytes, _ = per_problem_bytes(63, 63)
    assert 32 * hs_bytes <= 3_000_000 < 128 * hs_bytes  # cap lands mid-grid
    monkeypatch.setattr(batch_mod, "DISPATCH_BYTES_BUDGET", 3_000_000)
    capped = align_pairs_batched(
        pairs, m, (11, 1), "global", traceback=True, bucket_sizes=(63,),
        batch_pairs=1024,
    )
    monkeypatch.undo()
    wide = align_pairs_batched(
        pairs, m, (11, 1), "global", traceback=True, bucket_sizes=(63,),
        batch_pairs=1024,
    )
    for (px, py), got, ref in zip(pairs, capped, wide):
        want = align_profiles(px, py, m, (11, 1), "global")
        for r in (got, ref):
            assert r.score == want.score
            np.testing.assert_array_equal(r.cols_x, want.cols_x)
            np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_super_dispatch_groups_equal_chunks(monkeypatch):
    """4 identical-shape chunks collapse into ONE scan-of-4 super-dispatch
    (latency amortization), with results still bit-equal to the oracle."""
    import numpy as np

    from praline_tpu import ALPHABET_AA, builtin_score_matrix
    from praline_tpu.kernels import align_pairs_batched
    from praline_tpu.kernels import batch as batch_mod
    from praline_tpu.oracle import align_profiles
    from praline_tpu.types import Profile

    rng = np.random.default_rng(11)
    m = builtin_score_matrix("blosum62")

    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    pairs = [(one(int(rng.integers(5, 64))), one(int(rng.integers(5, 64))))
             for _ in range(128)]
    hs_bytes, _ = per_problem_bytes(63, 63)
    monkeypatch.setattr(batch_mod, "DISPATCH_BYTES_BUDGET", 33 * hs_bytes)

    calls = []
    real = batch_mod._indexed_multi_jit

    def spy():
        fn = real()

        def wrapper(*a, **k):
            calls.append(tuple(a[6].shape))  # ix2: (n_sub, B)
            return fn(*a, **k)

        return wrapper

    monkeypatch.setattr(batch_mod, "_indexed_multi_jit", spy)
    got = align_pairs_batched(
        pairs, m, (11, 1), "global", traceback=False, bucket_sizes=(63,),
        batch_pairs=1024,
    )
    assert calls == [(4, 32)], calls  # one scan-of-4 over 32-pair chunks
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, m, (11, 1), "global")
        assert r.score == want.score
