"""Long sequences through exact-size buckets (SURVEY.md §6 long-context row).

The batched path handles sequences far beyond the default buckets by giving
oversized problems their own exact-size bucket; cross-checked against the
fast native C++ kernel (the oracle would be too slow at this size).
chip_smoke.py runs the long routes at full size on the GPU.
"""

import shutil

import numpy as np
import pytest

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels import align_pairs_batched
from praline_tpu.oracle.score import pair_score_matrix
from praline_tpu.types import Profile

B62 = builtin_score_matrix("blosum62")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


def test_long_sequence_pair_matches_native():
    from praline_tpu.native import native_align_scores

    rng = np.random.default_rng(0)
    L = 1500
    x = rng.integers(0, 20, size=L).astype(np.int32)
    y = x.copy()
    y[rng.integers(0, L, size=60)] = rng.integers(0, 20, size=60)
    y = np.delete(y, rng.choice(L, size=9, replace=False))
    px = Profile.from_tokens(x, ALPHABET_AA)
    py = Profile.from_tokens(np.ascontiguousarray(y), ALPHABET_AA)

    (r,) = align_pairs_batched([(px, py)], B62, (11, 1), "global", traceback=True)
    nat = native_align_scores(pair_score_matrix(px, py, B62), (11, 1), "global")
    assert r.score == nat.score
    np.testing.assert_array_equal(r.cols_x, nat.cols_x)
    np.testing.assert_array_equal(r.cols_y, nat.cols_y)
