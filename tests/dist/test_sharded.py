"""Distributed path on a simulated 8-device CPU mesh (SURVEY.md §5.4)."""

import numpy as np
import pytest

import jax

from praline_tpu import ALPHABET_AA, PralineConfig, builtin_score_matrix
from praline_tpu.dist import make_pair_mesh
from praline_tpu.io import format_alignment_fasta
from praline_tpu.kernels import align_pairs_batched
from praline_tpu.msa import msa_align
from praline_tpu.oracle import align_profiles, oracle_msa
from praline_tpu.types import Profile, Sequence

B62 = builtin_score_matrix("blosum62")


def require_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} simulated devices")


def random_pairs(rng, n, lmax=30):
    def one(L):
        return Profile.from_tokens(rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA)

    return [
        (one(int(rng.integers(2, lmax))), one(int(rng.integers(2, lmax)))) for _ in range(n)
    ]


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_sharded_scores_match_oracle(mode):
    require_devices(8)
    mesh = make_pair_mesh(8)
    rng = np.random.default_rng(hash(mode) % 2**32)
    pairs = random_pairs(rng, 11)  # deliberately not divisible by 8
    got = align_pairs_batched(
        pairs, B62, (11, 1), mode, bucket_sizes=(31,), batch_pairs=16, mesh=mesh
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), mode)
        assert r.score == want.score
        assert r.length == want.length


def test_sharded_traceback_matches_unsharded():
    require_devices(4)
    mesh = make_pair_mesh(4)
    rng = np.random.default_rng(7)
    pairs = random_pairs(rng, 6)
    sharded = align_pairs_batched(
        pairs, B62, (11, 1), "global", traceback=True, bucket_sizes=(31,), mesh=mesh
    )
    plain = align_pairs_batched(
        pairs, B62, (11, 1), "global", traceback=True, bucket_sizes=(31,)
    )
    for a, b in zip(sharded, plain):
        assert a.score == b.score
        np.testing.assert_array_equal(a.cols_x, b.cols_x)
        np.testing.assert_array_equal(a.cols_y, b.cols_y)


def test_full_pipeline_on_mesh_matches_oracle():
    require_devices(8)
    mesh = make_pair_mesh(8)
    seqs = [
        Sequence.from_str(n, t, ALPHABET_AA)
        for n, t in [
            ("a", "MKVLAWGYPVED"),
            ("b", "MKVLAWGYPED"),
            ("c", "MKVINWGYPVED"),
            ("d", "MRVLAWGYAVED"),
            ("e", "GGPLNWHHQQAC"),
        ]
    ]
    cfg = PralineConfig(preprofile_mode="global")
    want = oracle_msa(seqs, B62, cfg)
    got = msa_align(seqs, B62, cfg, mesh=mesh)
    assert format_alignment_fasta(got) == format_alignment_fasta(want)


def profile_pairs(rng, n, lmax=24):
    """Integer-count (non-one-hot) profile pairs: the narrow-stack f32 path."""

    def one(L):
        c = rng.integers(0, 3, size=(L, ALPHABET_AA.size)).astype(np.float32)
        c[:, 0] += 1.0
        return Profile(c, np.zeros(L, np.float32), ALPHABET_AA)

    return [
        (one(int(rng.integers(2, lmax))), one(int(rng.integers(2, lmax))))
        for _ in range(n)
    ]


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_sharded_pallas_scores_match_oracle(mode, triton_interpret):
    """VERDICT r1 item 2: the mesh path must run the production scores
    kernel (kernels.lane_dp inside shard_map) — parity on the sim mesh
    (interpret mode on CPU)."""
    require_devices(4)
    mesh = make_pair_mesh(4)
    rng = np.random.default_rng(3)
    pairs = random_pairs(rng, 6) + profile_pairs(rng, 5)
    got = align_pairs_batched(
        pairs, B62, (11, 1), mode, bucket_sizes=(31,), batch_pairs=16,
        mesh=mesh, backend="triton",
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), mode)
        assert r.score == want.score
        assert r.length == want.length


def test_sharded_pallas_traceback_matches_unsharded():
    require_devices(4)
    mesh = make_pair_mesh(4)
    rng = np.random.default_rng(11)
    pairs = random_pairs(rng, 3) + profile_pairs(rng, 3)
    sharded = align_pairs_batched(
        pairs, B62, (11, 1), "global", traceback=True, bucket_sizes=(31,),
        mesh=mesh,
    )
    plain = align_pairs_batched(
        pairs, B62, (11, 1), "global", traceback=True, bucket_sizes=(31,),
    )
    for a, b in zip(sharded, plain):
        assert a.score == b.score
        np.testing.assert_array_equal(a.cols_x, b.cols_x)
        np.testing.assert_array_equal(a.cols_y, b.cols_y)


def test_streamed_route_sharded_under_mesh(monkeypatch):
    """Oversized (streamed-route) problems shard over the mesh's pair axis
    instead of running single-device (VERDICT r2 weak #4), every mode,
    bit-equal to the oracle."""
    import numpy as np

    from praline_tpu import ALPHABET_AA
    from praline_tpu.dist import make_pair_mesh
    from praline_tpu.kernels import batch as batch_mod
    from praline_tpu.oracle import align_profiles
    from praline_tpu.types import Profile

    monkeypatch.setattr(  # stream everything past the 15-bucket
        batch_mod, "HS_BYTES_BUDGET", batch_mod.per_problem_bytes(15, 15)[0]
    )
    rng = np.random.default_rng(21)

    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    pairs = [(one(int(rng.integers(24, 40))), one(int(rng.integers(10, 30))))
             for _ in range(5)]  # 5 pairs over 4 devices: exercises shard pad
    mesh = make_pair_mesh(4)
    for mode in ("global", "semiglobal", "local"):
        got = align_pairs_batched(
            pairs, B62, (11, 1), mode, traceback=True,
            bucket_sizes=(15, 63), mesh=mesh,
        )
        for (px, py), r in zip(pairs, got):
            want = align_profiles(px, py, B62, (11, 1), mode)
            assert r.score == want.score, mode
            np.testing.assert_array_equal(r.cols_x, want.cols_x)
            np.testing.assert_array_equal(r.cols_y, want.cols_y)


def test_sharded_super_dispatch_groups_chunks(monkeypatch):
    """Identical-shape chunks under a mesh collapse into ONE sharded
    scan-of-n jit (dist.sharded_indexed_multi_dispatch), results bit-equal
    to the unsharded driver."""
    import numpy as np

    from praline_tpu import ALPHABET_AA
    from praline_tpu.dist import make_pair_mesh
    from praline_tpu.dist import allpairs as ap_mod
    from praline_tpu.kernels import batch as batch_mod
    from praline_tpu.kernels.batch import per_problem_bytes
    from praline_tpu.types import Profile

    rng = np.random.default_rng(23)

    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    pairs = [(one(int(rng.integers(5, 64))), one(int(rng.integers(5, 64))))
             for _ in range(128)]
    hs_bytes, tb_bytes = per_problem_bytes(63, 63)
    monkeypatch.setattr(
        batch_mod, "DISPATCH_BYTES_BUDGET", 33 * (hs_bytes + tb_bytes)
    )

    calls = []
    real = ap_mod.sharded_indexed_multi_dispatch

    def spy(mesh, *a, **k):
        calls.append(tuple(a[6].shape))  # ix2: (n_sub, B)
        return real(mesh, *a, **k)

    monkeypatch.setattr(batch_mod, "_mesh_spans_processes", lambda m: False)
    import praline_tpu.dist.allpairs as _ap
    monkeypatch.setattr(_ap, "sharded_indexed_multi_dispatch", spy)

    mesh = make_pair_mesh(4)
    got = align_pairs_batched(
        pairs, B62, (11, 1), "global", traceback=True, bucket_sizes=(63,),
        batch_pairs=1024, mesh=mesh,
    )
    plain = align_pairs_batched(
        pairs, B62, (11, 1), "global", traceback=True, bucket_sizes=(63,),
        batch_pairs=1024,
    )
    assert calls == [(4, 32)], calls
    for a, b in zip(got, plain):
        assert a.score == b.score
        np.testing.assert_array_equal(a.cols_x, b.cols_x)


def test_ckpt_route_sharded_under_mesh(monkeypatch):
    """Giant-traceback (checkpointed-route) problems also shard over the
    pair axis under a mesh, bit-equal to the oracle (round 3: the last
    single-device-only route)."""
    import numpy as np

    from praline_tpu import ALPHABET_AA
    from praline_tpu.dist import make_pair_mesh
    from praline_tpu.kernels import batch as batch_mod
    from praline_tpu.oracle import align_profiles
    from praline_tpu.types import Profile

    monkeypatch.setattr(
        batch_mod, "HS_BYTES_BUDGET", batch_mod.per_problem_bytes(15, 15)[0]
    )
    monkeypatch.setattr(batch_mod, "TB_BYTES_BUDGET", 64)  # force ckpt route
    rng = np.random.default_rng(29)

    def one(L):
        return Profile.from_tokens(
            rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
        )

    pairs = [(one(int(rng.integers(24, 40))), one(int(rng.integers(10, 30))))
             for _ in range(3)]  # 3 pairs over 4 devices: shard pad too
    mesh = make_pair_mesh(4)
    for mode in ("global", "local"):
        got = align_pairs_batched(
            pairs, B62, (11, 1), mode, traceback=True,
            bucket_sizes=(15, 63), mesh=mesh,
        )
        for (px, py), r in zip(pairs, got):
            want = align_profiles(px, py, B62, (11, 1), mode)
            assert r.score == want.score, mode
            np.testing.assert_array_equal(r.cols_x, want.cols_x)
            np.testing.assert_array_equal(r.cols_y, want.cols_y)
