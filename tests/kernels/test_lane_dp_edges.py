"""Edge cases of the lane-per-problem scores kernel (kernels.lane_dp)
against the XLA scan, in interpret mode: length-one sides, padding off
the lane grid and the producer block, mass ties, one-hot sequences, the
deepest gap series, heavy fractional column inverses, bad arguments, and
the route's byte model."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from praline_tpu.kernels import batch as batch_mod
from praline_tpu.kernels.lane_dp import LANES, lane_dp_scores
from .lane_cases import A, MODES, S, case, check_against_scan, counts, inverses


@pytest.mark.parametrize("gap_series", [(11, 1), (3,), (5, 3, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_length_one_sides(mode, gap_series):
    """lx = 1 / ly = 1 problems hit the border cells as terminals."""
    rng = np.random.default_rng(2)
    check_against_scan(case(rng, 4, 12, 12, lx=[1, 1, 12, 7], ly=[1, 12, 1, 9]),
           gap_series, mode)


@pytest.mark.parametrize("B", [1, LANES - 1, LANES + 1, 2 * LANES + 5])
def test_lane_dp_batch_and_column_padding(B):
    """Batches off the lane grid and Ly off the producer block pad and
    unpad without leaking into results."""
    rng = np.random.default_rng(B)
    check_against_scan(case(rng, B, 9, 35), (11, 1), "global")


@pytest.mark.parametrize("gap_series", [(0, 0), (2, 1), (1,)])
@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_mass_ties_pin_tie_breaks(mode, gap_series):
    """A zero matrix manufactures maximal ties everywhere: state priority
    (M > Ix > Iy) and the terminal tie-breaks (semiglobal: larger i then
    j; local: smaller i then j) must match the scan exactly."""
    B, Lx, Ly = 6, 9, 8
    cx = np.zeros((B, Lx, A), np.float32)
    cx[:, :, 1] = 1.0
    cy = np.zeros((B, Ly, A), np.float32)
    cy[:, :, 1] = 1.0
    lx = np.array([9, 5, 7, 3, 1, 9], np.int32)
    ly = np.array([8, 8, 4, 3, 5, 1], np.int32)
    args = (cx, inverses(cx), cy, inverses(cy), np.zeros((A, A), np.float32), lx, ly)
    check_against_scan(args, gap_series, mode)


@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_one_hot_sequences(mode, gap_series):
    """Seq-seq problems (one-hot profiles, unit column inverses): the
    distance stage's default input."""
    rng = np.random.default_rng(5)
    B, Lx, Ly = 7, 14, 10
    cx = np.eye(A, dtype=np.float32)[rng.integers(0, 20, size=(B, Lx))]
    cy = np.eye(A, dtype=np.float32)[rng.integers(0, 20, size=(B, Ly))]
    args = (cx, inverses(cx), cy, inverses(cy), S, rng.integers(1, Lx + 1, B),
            rng.integers(1, Ly + 1, B))
    check_against_scan(args, gap_series, mode)


@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_deepest_gap_series(mode):
    """k = 15, the deepest series the scan supports."""
    rng = np.random.default_rng(15)
    check_against_scan(case(rng, 3, 18, 16), tuple(range(16, 1, -1)), mode)


@pytest.mark.parametrize("gap_series", [(13, 7, 1), (11, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_fractional_inverses(mode, gap_series):
    """Heavy, ragged column totals: the pinned (H_int * inv_x) * inv_y
    rounding reaches the DP add unfused."""
    rng = np.random.default_rng(21)
    cx = counts(rng, 5, 11, top=9)
    cy = counts(rng, 5, 10, top=9)
    args = (cx, inverses(cx), cy, inverses(cy), S, rng.integers(1, 12, 5),
            rng.integers(1, 11, 5))
    check_against_scan(args, gap_series, mode)


def test_lane_dp_rejects_bad_series_and_mode():
    args = tuple(map(jnp.asarray, case(np.random.default_rng(0), 2, 4, 4)))
    with pytest.raises(ValueError):
        lane_dp_scores(*args, gap_series=tuple(range(16)), interpret=True)
    with pytest.raises(ValueError):
        lane_dp_scores(*args, mode="glocal", interpret=True)


def test_lane_dp_bytes_counts_no_score_tensor():
    """The lane route's per-problem bytes grow with L, not L^2: it is what
    lets the dispatcher take a whole distance tile per dispatch."""
    small = batch_mod.lane_dp_bytes(255, 255, A, 2)
    big = batch_mod.lane_dp_bytes(1023, 1023, A, 2)
    assert 3.9 < big / small < 4.1
    assert big < batch_mod.per_problem_bytes(1023, 1023)[0] / 20
    deep = functools.partial(batch_mod.lane_dp_bytes, 1023, 1023, A)
    assert deep(13) > deep(3) > deep(2)
