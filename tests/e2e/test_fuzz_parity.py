"""Differential fuzz: the batched pipeline vs the oracle across random
configurations (SURVEY.md §5.5/§5.6 — column-identical output is the
parity contract; this sweeps the config space the curated goldens pin
pointwise).

Deterministic (seeded); sizes kept tiny because the oracle is an
interpreted O(N^2 L^2) Python loop.
"""

import numpy as np
import pytest

from praline_tpu import (
    ALPHABET_AA,
    ALPHABET_DNA,
    PralineConfig,
    builtin_score_matrix,
)
from praline_tpu.io import format_alignment_clustal, format_alignment_fasta
from praline_tpu.io.clustal import parse_alignment_clustal
from praline_tpu.io.fasta import iter_fasta
from praline_tpu.msa import msa_align
from praline_tpu.oracle import oracle_msa
from praline_tpu.types import Sequence

MATRICES = ["blosum45", "blosum62", "blosum80", "pam30", "pam250"]
GAPS = [(11, 1), (13, 7, 1), (8, 2), (10, 5, 3, 1), (5,)]
MODES = ["global", "semiglobal", "local"]
LINKAGES = ["single", "complete", "average"]
PREPROFILES = ["dummy", "global", "local"]


def _family(rng, alphabet, n, lmax):
    hi = min(20, alphabet.size - 1)
    base = rng.integers(0, hi, size=lmax)
    seqs = []
    for i in range(n):
        toks = base.copy()
        for _ in range(int(rng.integers(1, lmax // 2))):
            toks[rng.integers(0, lmax)] = rng.integers(0, hi)
        # random truncation/extension for ragged lengths
        L = int(rng.integers(max(2, lmax // 2), lmax + 1))
        seqs.append(Sequence(f"f{i}", toks[:L].astype(np.int32), alphabet))
    return seqs


@pytest.mark.parametrize("trial", range(16))
def test_random_config_column_identical(trial):
    rng = np.random.default_rng(1000 + trial)
    dna = trial % 5 == 4
    alphabet = ALPHABET_DNA if dna else ALPHABET_AA
    matrix = builtin_score_matrix(
        "dna_simple" if dna else MATRICES[trial % len(MATRICES)]
    )
    cfg = PralineConfig(
        alphabet="dna" if dna else "protein",
        score_matrix="dna_simple" if dna else MATRICES[trial % len(MATRICES)],
        gap_series=GAPS[trial % len(GAPS)],
        merge_mode=MODES[trial % 2],  # global/semiglobal merges
        distance_mode=MODES[trial % 3],
        preprofile_mode=PREPROFILES[trial % 3],
        linkage=LINKAGES[trial % 3],
        score_normalization="length" if trial % 2 else "none",
        backend="xla",
        batch_pairs=(8, 32, 512)[trial % 3],
        bucket_sizes=((7, 15, 31), (31,), (63, 127))[trial % 3],
    )
    seqs = _family(rng, alphabet, n=int(rng.integers(3, 7)), lmax=18)
    want = oracle_msa(seqs, matrix, cfg)
    got = msa_align(seqs, matrix, cfg)
    assert format_alignment_fasta(got) == format_alignment_fasta(want), (
        trial, cfg
    )


@pytest.mark.parametrize("trial", range(6))
def test_roundtrip_fasta_clustal(trial):
    """Emission -> parse roundtrips preserve the alignment exactly."""
    rng = np.random.default_rng(2000 + trial)
    seqs = _family(rng, ALPHABET_AA, n=4, lmax=100)
    cfg = PralineConfig(backend="xla")
    aln = msa_align(seqs, builtin_score_matrix("blosum62"), cfg)

    fasta = format_alignment_fasta(aln, wrap=int(rng.integers(5, 80)))
    texts = {name: t for name, t in iter_fasta(fasta)}
    clustal = format_alignment_clustal(aln)
    back = parse_alignment_clustal(clustal, ALPHABET_AA)
    assert format_alignment_clustal(back) == clustal
    for k, m in enumerate(aln.members):
        row = aln.alphabet.detokenize(aln.rows[k])
        assert texts[m.name] == row
        assert back.alphabet.detokenize(back.rows[k]) == row


@pytest.mark.parametrize("trial", range(6))
def test_heavy_count_profiles_column_identical(trial):
    """Fuzz with HEAVY integer-count profile pairs (counts near 256,
    column totals spanning the 2**15/|S| and 2**24 exactness bounds): the
    dispatcher's narrow integer stacks must stay bit-identical to the
    oracle."""
    from praline_tpu.kernels import align_pairs_batched
    from praline_tpu.oracle import align_profiles
    from praline_tpu.types import Profile

    rng = np.random.default_rng(7000 + trial)
    m = builtin_score_matrix(MATRICES[trial % len(MATRICES)])

    def heavy(L, cmax, ncols):
        c = np.zeros((L, 23), np.float32)
        for pos in range(L):
            for a in rng.permutation(23)[:ncols]:
                c[pos, a] = int(rng.integers(1, cmax + 1))
        return Profile(c, np.zeros(L, np.float32), ALPHABET_AA)

    # Mix of light (fast-eligible) and heavy (HIGHEST-forced) pairs.
    pairs = []
    for _ in range(6):
        kind = rng.integers(0, 3)
        Lx, Ly = int(rng.integers(5, 30)), int(rng.integers(5, 30))
        if kind == 0:  # light: counts <= 8
            pairs.append((heavy(Lx, 8, 3), heavy(Ly, 8, 3)))
        elif kind == 1:  # counts at the bf16-exact edge
            pairs.append((heavy(Lx, 256, 2), heavy(Ly, 4, 2)))
        else:  # counts past the edge -> HIGHEST
            pairs.append((heavy(Lx, 300, 2), heavy(Ly, 3, 2)))
    mode = MODES[trial % 3]
    gs = GAPS[trial % len(GAPS)]
    got = align_pairs_batched(
        pairs, m, gs, mode, traceback=True, bucket_sizes=(31,),
    )
    for (px, py), r in zip(pairs, got):
        want = align_profiles(px, py, m, gs, mode)
        assert r.score == want.score
        np.testing.assert_array_equal(r.cols_x, want.cols_x)
        np.testing.assert_array_equal(r.cols_y, want.cols_y)
