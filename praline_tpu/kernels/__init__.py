"""Device compute: batched wavefront DP (XLA scan + a Pallas GPU kernel) and dispatch.

Importing this package pulls in JAX; host-only layers (types/io/oracle) do
not depend on it.
"""

from .batch import PairResult, align_pairs_batched, align_tracksets_batched
from .scan import wavefront_dp, wavefront_dp_checkpointed, wavefront_dp_streamed
from .scores import skewed_pair_scores
from .traceback import replay_traceback

__all__ = [
    "PairResult",
    "align_pairs_batched",
    "align_tracksets_batched",
    "replay_traceback",
    "skewed_pair_scores",
    "wavefront_dp",
    "wavefront_dp_checkpointed",
    "wavefront_dp_streamed",
]
