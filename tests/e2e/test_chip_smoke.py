"""chip_smoke.py's contract off the card: it refuses to run without a GPU
(non-zero exit, no result line), its last line's format, which phases each
card count runs, its seeded inputs, and that its golden CLI flags rebuild
the configurations the golden tests use."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_refuses_without_a_gpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_result_line_is_the_contract():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    for n in (1, 4):
        line = chip_smoke.result_line([dev] * n)
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n}}
        assert "\n" not in line


@pytest.mark.parametrize("cards,want", [(1, ["kernels", "end_to_end"]),
                                        (4, ["multi_card"])])
def test_card_count_selects_phases(cards, want):
    assert chip_smoke.phases(cards) == want
    for name in want:
        assert callable(getattr(chip_smoke, f"phase_{name}"))


def test_cards_option_accepts_only_one_or_four():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--cards", "2"])


def test_family_is_seeded_and_within_bounds():
    a = chip_smoke.family(20, 250, 350, seed=3)
    b = chip_smoke.family(20, 250, 350, seed=3)
    assert [s.tokens.tolist() for s in a] == [s.tokens.tolist() for s in b]
    assert all(250 <= s.length <= 350 for s in a)
    assert len({s.length for s in a}) > 5


def test_golden_flags_cover_every_golden():
    goldens = {p.name.split(".golden")[0]
               for p in (ROOT / "testdata").glob("*.golden.fasta")}
    assert goldens == set(chip_smoke.GOLDEN_FLAGS)


@pytest.mark.parametrize("tag", sorted(chip_smoke.GOLDEN_FLAGS))
def test_golden_flags_rebuild_the_golden_configs(tag):
    """The CLI flags chip_smoke passes give the PralineConfig the golden
    tests (tests/e2e/test_goldens.py) build directly."""
    from praline_tpu import PralineConfig
    from praline_tpu.cli.main import build_parser, config_from_args

    want = {
        "family10.default": PralineConfig(),
        "family10.ppglobal": PralineConfig(preprofile_mode="global"),
        "family10.series3_local": PralineConfig(
            gap_series=(13, 7, 1), distance_mode="local", linkage="complete"),
        "family16div.default": PralineConfig(),
        "family16div.pam250_semi_pplocal": PralineConfig(
            score_matrix="pam250", merge_mode="semiglobal",
            preprofile_mode="local", gap_series=(10, 2), linkage="single"),
        "dna8.default": PralineConfig(gap_series=(8, 2), alphabet="dna",
                                      score_matrix="dna_simple"),
        "family64.default": PralineConfig(),
        "family64.semi_series3": PralineConfig(
            gap_series=(12, 6, 1), merge_mode="semiglobal", linkage="average"),
    }[tag]
    args = build_parser().parse_args(["in.fasta", "out.fasta",
                                      *chip_smoke.GOLDEN_FLAGS[tag]])
    assert config_from_args(args) == want


TINY = dict(scores_L=(20, 31), scores_B=64, scores_bucket=31, tb_L=(10, 20),
            tb_B=8, tb_bucket=31, stream_min_L=40, ckpt_L=60,
            tracks_L=(10, 30), tracks_B=16, tracks_bucket=31,
            job_big=(12, 25, 35), job_pp=(8, 20, 30))


@pytest.fixture
def tiny_sizes(monkeypatch):
    from praline_tpu.kernels import batch as batch_mod

    for key, value in TINY.items():
        monkeypatch.setitem(chip_smoke.SIZES, key, value)
    # the CPU's fixed HS budget, shrunk so a 48-column pair already streams
    monkeypatch.setattr(batch_mod, "HS_BYTES_BUDGET",
                        batch_mod.per_problem_bytes(48, 48)[0])


def test_kernel_phase_at_tiny_sizes(tiny_sizes, capsys):
    """Every comparison of the kernels phase, on the CPU at toy widths."""
    chip_smoke.phase_kernels()
    out = capsys.readouterr().out
    assert out.count(": ok in ") == 5
    assert "streamed route" in out and "checkpointed traceback" in out


def test_multi_card_phase_at_tiny_sizes(tiny_sizes, capsys):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    chip_smoke.phase_multi_card()
    out = capsys.readouterr().out
    assert "N=12 job on 1 card and on a 8-card mesh: ok" in out


def test_job_check_rejects_rows_out_of_input_order(monkeypatch):
    import praline_tpu.msa.pipeline as pipeline
    from praline_tpu import PralineConfig, builtin_score_matrix

    real = pipeline.msa_align

    def reordered(*a, **k):
        aln = real(*a, **k)
        return type(aln)(aln.members[::-1], aln.rows[::-1])

    monkeypatch.setattr(pipeline, "msa_align", reordered)
    seqs = chip_smoke.family(6, 20, 30, seed=1)
    with pytest.raises(AssertionError):
        chip_smoke._check_job("broken", seqs, PralineConfig(),
                              builtin_score_matrix("blosum62"))
