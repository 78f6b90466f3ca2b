"""The lane-per-problem scores kernel (kernels.lane_dp) against the XLA scan,
field for field, in interpret mode on the CPU (the same kernel compiles
through Triton on a GPU; the ``gpu``-marked case runs it there)."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from praline_tpu.kernels.lane_dp import lane_dp_scores
from praline_tpu.kernels.scan import wavefront_dp
from praline_tpu.kernels.scores import skewed_pair_scores

from .lane_cases import FIELDS, MODES, SERIES, case, check_against_scan


@pytest.mark.parametrize("shape", [(13, 11), (7, 19), (1, 9), (20, 33)])
@pytest.mark.parametrize("gap_series", SERIES)
@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_matches_scan(mode, gap_series, shape):
    rng = np.random.default_rng(zlib.crc32(repr((mode, gap_series, shape)).encode()))
    check_against_scan(case(rng, 9, *shape), gap_series, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_lane_dp_compiled_matches_scan(gpu, mode):
    """The same contract with the kernel compiled by Triton, at a real
    width (bucket 511)."""
    rng = np.random.default_rng(511)
    args = case(rng, 256, 511, 511, lx=rng.integers(256, 512, 256),
                 ly=rng.integers(256, 512, 256))
    a = tuple(map(jnp.asarray, args))
    want = wavefront_dp(skewed_pair_scores(*a[:5]), a[5], a[6], mode=mode)
    got = lane_dp_scores(*a, mode=mode)
    for key in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
