"""align_pairs_batched's choice of the lane-per-problem scores kernel
(kernels.lane_dp): "auto" takes it only on a GPU, scores-only dispatches
(super-dispatch groups included) run it, traceback dispatches keep the
XLA scan.  On the CPU the kernel runs in interpret mode."""

import zlib

import numpy as np
import pytest

import jax

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels import align_pairs_batched
from praline_tpu.kernels import batch as batch_mod
from praline_tpu.oracle import align_profiles
from praline_tpu.types import Profile

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]


def test_resolve_backend(monkeypatch):
    """auto picks the lane kernel only on a GPU; asking for it elsewhere
    raises instead of silently interpreting it."""
    assert batch_mod.resolve_backend("auto") == "xla"
    assert batch_mod.resolve_backend("xla") == "xla"
    with pytest.raises(ValueError, match="needs a GPU"):
        batch_mod.resolve_backend("triton")
    with pytest.raises(ValueError, match="unknown backend"):
        batch_mod.resolve_backend("pallas")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert batch_mod.resolve_backend("auto") == "triton"
    assert batch_mod.resolve_backend("xla") == "xla"


def _pairs(rng, n, lo=4, hi=30):
    def one():
        L = int(rng.integers(lo, hi))
        c = rng.integers(0, 3, size=(L, A)).astype(np.float32)
        c[:, 0] += 1.0
        return Profile(c, np.zeros(L, np.float32), ALPHABET_AA)

    return [(one(), one()) for _ in range(n)]


@pytest.mark.parametrize("mode", MODES)
def test_dispatch_scores_take_the_lane_kernel(mode, triton_interpret, monkeypatch):
    """Scores-only dispatches on the "triton" backend run the lane kernel
    (and nothing else), oracle-exact, super-dispatch groups included."""
    import praline_tpu.kernels.lane_dp as lane_mod

    calls = []
    real = lane_mod.lane_dp_scores

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(lane_mod, "lane_dp_scores", spy)
    batch_mod._indexed_jit.cache_clear()
    batch_mod._indexed_multi_jit.cache_clear()
    rng = np.random.default_rng(zlib.crc32(mode.encode()))
    pairs = _pairs(rng, 70)
    got = align_pairs_batched(pairs, B62, (11, 1), mode, bucket_sizes=(31,),
                              batch_pairs=32, backend="triton")
    batch_mod._indexed_jit.cache_clear()
    batch_mod._indexed_multi_jit.cache_clear()
    assert calls, "the lane kernel was not traced"
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (11, 1), mode)
        assert (r.score, r.length) == (want.score, want.length)


def test_dispatch_traceback_stays_on_the_scan(triton_interpret, monkeypatch):
    """Traceback dispatches keep the XLA scan + device replay on the
    "triton" backend: the lane kernel makes scores only."""
    import praline_tpu.kernels.lane_dp as lane_mod

    def boom(*a, **k):
        raise AssertionError("traceback dispatch reached the lane kernel")

    monkeypatch.setattr(lane_mod, "lane_dp_scores", boom)
    batch_mod._indexed_jit.cache_clear()
    rng = np.random.default_rng(8)
    pairs = _pairs(rng, 5)
    got = align_pairs_batched(pairs, B62, (13, 7, 1), "semiglobal",
                              traceback=True, bucket_sizes=(31,),
                              backend="triton")
    batch_mod._indexed_jit.cache_clear()
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, B62, (13, 7, 1), "semiglobal")
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)
