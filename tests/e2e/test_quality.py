"""Alignment-QUALITY regression guard (SURVEY.md §5.5): SP/TC floors on the
hand-curated divergent family, asserted as METRIC floors via util.accuracy —
distinct from the byte-equality goldens (which pin parity, not quality).

testdata/divfam.* (tools/gen_divfam.py) is a BAliBASE-RV11-style case: four
conserved kinase-inspired core blocks, variable-length linkers, ragged
termini, one fragment sequence.  The reference alignment aligns core blocks
column-for-column; linkers left-justify, so even a perfect aligner scores
below 1.0 on SP — the floors are set from measured behavior with margin and
exist to catch quality COLLAPSE (scoring/merge regressions that keep parity
tests green because the oracle regressed identically).
"""

from pathlib import Path

import pytest

from praline_tpu import ALPHABET_AA, PralineConfig, builtin_score_matrix
from praline_tpu.io import load_alignment_fasta, load_sequence_fasta
from praline_tpu.msa import msa_align
from praline_tpu.util.accuracy import sp_tc

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"

# Floors ~0.1 under measured steady state (see test docstring for why the
# ceiling is < 1.0): measured on the CPU backend.
SP_FLOOR = 0.80
TC_FLOOR = 0.55


@pytest.mark.parametrize(
    "cfg",
    [
        PralineConfig(),
        PralineConfig(preprofile_mode="global"),
    ],
    ids=["default", "ppglobal"],
)
def test_divfam_sp_tc_floor(cfg):
    seqs = load_sequence_fasta(TESTDATA / "divfam.fasta", ALPHABET_AA)
    ref = load_alignment_fasta(TESTDATA / "divfam.ref.fasta", ALPHABET_AA)
    got = msa_align(seqs, builtin_score_matrix("blosum62"), cfg)
    sp, tc = sp_tc(got, ref)
    assert sp >= SP_FLOOR, f"SP quality collapsed: {sp:.3f} < {SP_FLOOR}"
    assert tc >= TC_FLOOR, f"TC quality collapsed: {tc:.3f} < {TC_FLOOR}"


def test_divfam_core_blocks_aligned():
    """The conserved motif cores must end up internally aligned (every
    member's block starting in the same column) — the sharpest quality
    signal, independent of how the linkers fall."""
    seqs = load_sequence_fasta(TESTDATA / "divfam.fasta", ALPHABET_AA)
    got = msa_align(seqs, builtin_score_matrix("blosum62"), PralineConfig())
    # Gapped text per member, indexed by alignment column.
    texts = []
    for k, m in enumerate(got.members):
        row = got.rows[k]
        residues = iter(m.text())  # rows hold per-column tokens, -1 = gap
        texts.append(
            "".join("-" if r < 0 else next(residues) for r in row)
        )
    # Shared cores across every variant: RDLKP (catalytic), DFGL (DFG
    # motif), PEV (APE motif).  All members contain each core.
    for block in ("RDLKP", "DFGL", "PEV"):
        starts = set()
        for text in texts:
            i = text.replace("-", "").find(block)
            assert i >= 0, f"{block} missing from a member"
            res_cols = [c for c, ch in enumerate(text) if ch != "-"]
            starts.add(res_cols[i])
        assert len(starts) == 1, (
            f"core block {block} split across columns: {sorted(starts)}"
        )
