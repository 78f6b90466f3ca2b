"""praline-tpu: a batched multiple sequence alignment engine on JAX.

A from-scratch JAX framework with the capabilities of ibivu/PRALINE
(progressive protein/DNA MSA: affine/gap-series pairwise DP, profile-profile
scoring, preprofiles, guide trees, progressive merging).  See SURVEY.md for
the structural analysis and the pinned parity semantics.

Import layering: this root package only pulls in numpy-based layers (types,
io, oracle).  JAX device code lives under ``praline_tpu.kernels``,
``praline_tpu.dist`` and ``praline_tpu.msa`` and is imported lazily by the
high-level API so host-only tooling never pays device-init cost.
"""

from .io import (
    builtin_score_matrix,
    format_alignment_clustal,
    format_alignment_fasta,
    load_alignment_fasta,
    load_score_matrix,
    load_sequence_fasta,
    resolve_score_matrix,
    write_alignment_clustal,
    write_alignment_fasta,
)
from .types import (
    ALPHABET_AA,
    ALPHABET_DNA,
    GAP,
    Alignment,
    Alphabet,
    PralineConfig,
    Profile,
    ScoreMatrix,
    Sequence,
    SequenceTree,
)

__version__ = "0.1.0"

__all__ = [
    "ALPHABET_AA",
    "ALPHABET_DNA",
    "GAP",
    "Alignment",
    "Alphabet",
    "PralineConfig",
    "Profile",
    "ScoreMatrix",
    "Sequence",
    "SequenceTree",
    "builtin_score_matrix",
    "format_alignment_clustal",
    "format_alignment_fasta",
    "load_alignment_fasta",
    "load_score_matrix",
    "load_sequence_fasta",
    "resolve_score_matrix",
    "write_alignment_clustal",
    "write_alignment_fasta",
    "__version__",
]
