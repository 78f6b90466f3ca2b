"""Shared cases for the lane-kernel tests: random integer-count batches and
the field-for-field check against the XLA scan (interpret mode)."""

import numpy as np

import jax.numpy as jnp

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels.lane_dp import lane_dp_scores
from praline_tpu.kernels.scan import wavefront_dp
from praline_tpu.kernels.scores import skewed_pair_scores

B62 = builtin_score_matrix("blosum62")
S = np.asarray(B62.as_f32())
A = ALPHABET_AA.size
FIELDS = ("score", "length", "ti", "tj", "tcode")
MODES = ["global", "semiglobal", "local"]
SERIES = [(11, 1), (3,), (5, 3, 1), (13, 7, 1), (10, 5, 3, 1)]


def counts(rng, B, L, top=3):
    c = (rng.integers(0, top, size=(B, L, A)) + (np.arange(A) == 0))
    return c.astype(np.float32)


def inverses(c):
    return (np.float32(1.0) / np.maximum(c.sum(-1), 1.0)).astype(np.float32)


def case(rng, B, Lx, Ly, lx=None, ly=None):
    cx, cy = counts(rng, B, Lx), counts(rng, B, Ly)
    if lx is None:
        lx = rng.integers(1, Lx + 1, size=B)
    if ly is None:
        ly = rng.integers(1, Ly + 1, size=B)
    return (cx, inverses(cx), cy, inverses(cy), S,
            np.asarray(lx, np.int32), np.asarray(ly, np.int32))


def check_against_scan(args, gap_series, mode, ctx=""):
    a = tuple(map(jnp.asarray, args))
    want = wavefront_dp(skewed_pair_scores(*a[:5]), a[5], a[6],
                        gap_series=gap_series, mode=mode)
    got = lane_dp_scores(*a, gap_series=gap_series, mode=mode, interpret=True)
    for key in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(want[key]),
            err_msg=f"{ctx} {mode} {gap_series} {key}",
        )
