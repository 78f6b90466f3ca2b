"""C++ native kernel == oracle parity (SURVEY.md §9 P6: the
oracle <-> C++ <-> XLA scan <-> lane kernel parity square)."""

import shutil

import zlib

import numpy as np
import pytest

from praline_tpu.oracle import align_scores

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("gap_series", [(11, 1), (3,), (5, 3, 1)])
def test_native_matches_oracle(mode, gap_series):
    from praline_tpu.native import native_align_scores

    rng = np.random.default_rng(zlib.crc32(repr((mode, gap_series)).encode()))
    for _ in range(40):
        L1 = int(rng.integers(1, 30))
        L2 = int(rng.integers(1, 30))
        h = rng.integers(-6, 7, size=(L1, L2)).astype(np.float32)
        want = align_scores(h, gap_series, mode)
        got = native_align_scores(h, gap_series, mode)
        assert got.score == want.score, (mode, gap_series, h)
        np.testing.assert_array_equal(got.cols_x, want.cols_x)
        np.testing.assert_array_equal(got.cols_y, want.cols_y)


def test_native_batch_scores():
    from praline_tpu.native import native_batch_scores

    rng = np.random.default_rng(1)
    hs = [
        rng.integers(-5, 6, size=(int(rng.integers(1, 25)), int(rng.integers(1, 25)))).astype(np.float32)
        for _ in range(12)
    ]
    scores, lengths = native_batch_scores(hs, (11, 1), "global")
    for h, s, ln in zip(hs, scores, lengths):
        want = align_scores(h, (11, 1), "global")
        assert s == want.score
        assert ln == want.length


def test_native_float32_profile_scores():
    """Non-integer (profile) scores stay bit-identical in C++ float."""
    from praline_tpu.native import native_align_scores

    rng = np.random.default_rng(2)
    for mode in ("global", "local"):
        h = (rng.integers(-40, 40, size=(17, 13)).astype(np.float32)
             * np.float32(1.0 / 7.0))
        want = align_scores(h, (11, 1), mode)
        got = native_align_scores(h, (11, 1), mode)
        assert got.score == want.score
        np.testing.assert_array_equal(got.cols_x, want.cols_x)
