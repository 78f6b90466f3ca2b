"""CLI surface tests (SURVEY.md C21)."""

import numpy as np
import pytest

from praline_tpu.cli import main


FASTA = """>a
MKVLAWGYPVED
>b
MKVLAWGYPED
>c
MKVINWGYPVED
"""


@pytest.fixture
def in_fasta(tmp_path):
    p = tmp_path / "in.fasta"
    p.write_text(FASTA)
    return p


def test_cli_fasta_output(in_fasta, tmp_path):
    out = tmp_path / "out.fasta"
    rc = main([str(in_fasta), str(out)])
    assert rc == 0
    text = out.read_text()
    assert text.startswith(">a\n")
    assert text.count(">") == 3


def test_cli_clustal_by_extension(in_fasta, tmp_path):
    out = tmp_path / "out.aln"
    rc = main([str(in_fasta), str(out), "-v"])
    assert rc == 0
    assert out.read_text().startswith("CLUSTAL")


def test_cli_platform_cpu(in_fasta, tmp_path):
    """--platform cpu pins the JAX platform before any backend touch (the
    run-without-the-GPU escape hatch)."""
    out = tmp_path / "out.fasta"
    rc = main([str(in_fasta), str(out), "--platform", "cpu"])
    assert rc == 0
    assert out.read_text().count(">") == 3


def test_cli_score_against(in_fasta, tmp_path, capsys):
    out = tmp_path / "out.fasta"
    assert main([str(in_fasta), str(out)]) == 0
    rc = main([str(in_fasta), str(tmp_path / "out2.aln"),
               "--score-against", str(out)])
    assert rc == 0
    assert "SP=1.0000 TC=1.0000" in capsys.readouterr().out
    # missing reference file is a clean error
    rc = main([str(in_fasta), str(tmp_path / "o3.fasta"),
               "--score-against", str(tmp_path / "nope.fasta")])
    assert rc == 2


def test_cli_tree_out(in_fasta, tmp_path):
    out = tmp_path / "out.fasta"
    tree = tmp_path / "guide.nwk"
    rc = main([str(in_fasta), str(out), "--tree-out", str(tree)])
    assert rc == 0
    nwk = tree.read_text().strip()
    assert nwk.endswith(";") and nwk.count("(") == 2  # 3 leaves -> 2 joins
    for name in ("a", "b", "c"):
        assert name in nwk
    # unwritable path: clean error BEFORE the pipeline runs
    rc = main([str(in_fasta), str(tmp_path / "o9.fasta"),
               "--tree-out", str(tmp_path / "no-dir" / "t.nwk")])
    assert rc == 2


def test_newick_quotes_metacharacter_labels(tmp_path):
    p = tmp_path / "in.fasta"
    p.write_text(">sp|P1|ABC protein (fragment), v2\nMKVLAW\n>b\nMKVLAW\n")
    tree = tmp_path / "t.nwk"
    rc = main([str(p), str(tmp_path / "o.fasta"), "--tree-out", str(tree)])
    assert rc == 0
    nwk = tree.read_text().strip()
    assert "'sp|P1|ABC protein (fragment), v2'" in nwk
    # outside quoted labels the topology has exactly one join bracket
    import re

    stripped = re.sub(r"'(?:[^']|'')*'", "L", nwk)
    assert stripped == "(L,b);"
    # oracle backend writes the same tree through the same hook
    tree2 = tmp_path / "guide2.nwk"
    rc = main([str(p), str(tmp_path / "o2.fasta"), "--backend", "oracle",
               "--tree-out", str(tree2)])
    assert rc == 0
    assert tree2.read_text() == tree.read_text()


def test_cli_full_knobs(in_fasta, tmp_path):
    out = tmp_path / "out.fasta"
    rc = main(
        [
            str(in_fasta), str(out),
            "-g", "13,7,1",
            "--mode", "semiglobal",
            "--distance-mode", "local",
            "-p", "global",
            "--linkage", "complete",
            "--score-normalization", "none",
            "--backend", "xla",
        ]
    )
    assert rc == 0
    assert out.read_text().count(">") == 3


def test_cli_checkpoint_resume(in_fasta, tmp_path):
    out = tmp_path / "out.fasta"
    ck = tmp_path / "ckpt"
    rc = main([str(in_fasta), str(out), "-p", "global", "--checkpoint-dir", str(ck)])
    assert rc == 0
    first = out.read_text()
    assert (ck / "distances.npz").exists()
    assert (ck / "tree.json").exists()
    assert (ck / "preprofiles.npz").exists()
    # resume produces the identical alignment
    out2 = tmp_path / "out2.fasta"
    rc = main([str(in_fasta), str(out2), "-p", "global", "--resume", str(ck)])
    assert rc == 0
    assert out2.read_text() == first


def test_cli_bad_inputs(tmp_path, capsys):
    missing = tmp_path / "nope.fasta"
    out = tmp_path / "o"
    assert main([str(missing), str(out)]) == 2
    bad = tmp_path / "bad.fasta"
    bad.write_text("no header\n")
    assert main([str(bad), str(out)]) == 2
    ok = tmp_path / "ok.fasta"
    ok.write_text(">x\nMKV\n")
    assert main([str(ok), str(out), "--matrix", "not_a_matrix"]) == 2
    with pytest.raises(SystemExit):
        main([str(ok), str(out), "-g", "11,banana"])


def test_cli_dna(tmp_path):
    f = tmp_path / "dna.fasta"
    f.write_text(">d1\nACGTACGT\n>d2\nACGTCGT\n")
    out = tmp_path / "out.fasta"
    rc = main([str(f), str(out), "-a", "dna", "-m", "dna_simple", "-g", "8,2"])
    assert rc == 0
    assert out.read_text().count(">") == 2


def test_cli_devices_mesh(in_fasta, tmp_path):
    import jax

    n = min(4, len(jax.devices()))
    out = tmp_path / "mesh.fasta"
    rc = main([str(in_fasta), str(out), "--devices", str(n), "--backend", "xla"])
    assert rc == 0
    ref = tmp_path / "ref.fasta"
    assert main([str(in_fasta), str(ref), "--backend", "xla"]) == 0
    assert out.read_text() == ref.read_text()


def test_cli_profile_dir_nonempty(in_fasta, tmp_path):
    """--profile-dir must produce a real trace (VERDICT r1: dead hook)."""
    prof = tmp_path / "trace"
    out = tmp_path / "out.fasta"
    rc = main([str(in_fasta), str(out), "--backend", "xla",
               "--profile-dir", str(prof)])
    assert rc == 0
    files = [p for p in prof.rglob("*") if p.is_file()]
    assert files, "profile dir is empty — jax.profiler trace was not written"
    # disarm so later tests don't keep tracing (public API, VERDICT r2)
    from praline_tpu.util.metrics import disable_profiling

    disable_profiling()


def test_cli_fasta_wrap_honored(in_fasta, tmp_path):
    """config.fasta_wrap must reach emission (VERDICT r1: dead knob)."""
    import praline_tpu as pt
    from praline_tpu.msa import msa_align
    from praline_tpu.types import PralineConfig

    seqs = pt.load_sequence_fasta(str(in_fasta), pt.ALPHABET_AA)
    m = pt.builtin_score_matrix("blosum62")
    aln = msa_align(seqs, m, PralineConfig(backend="xla"))
    wrapped = pt.format_alignment_fasta(aln, wrap=5)
    body_lines = [l for l in wrapped.splitlines() if not l.startswith(">")]
    assert max(len(l) for l in body_lines) <= 5


def test_config_mesh_shape_builds_mesh(in_fasta, tmp_path):
    """config.mesh_shape alone (no explicit mesh) shards the pipeline."""
    import praline_tpu as pt
    from praline_tpu.msa import msa_align
    from praline_tpu.types import PralineConfig

    seqs = pt.load_sequence_fasta(str(in_fasta), pt.ALPHABET_AA)
    m = pt.builtin_score_matrix("blosum62")
    ref = msa_align(seqs, m, PralineConfig(backend="xla"))
    via_cfg = msa_align(
        seqs, m, PralineConfig(backend="xla", mesh_shape=(2,))
    )
    assert (ref.rows == via_cfg.rows).all()


@pytest.mark.parametrize("flag,value", [("--platform", "metal"),
                                        ("--backend", "pallas")])
def test_cli_rejects_removed_choices(flag, value, capsys):
    from praline_tpu.cli.main import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["in.fasta", "out.fasta", flag, value])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_gpu_only_backend_refused_off_the_gpu(in_fasta, tmp_path, capsys):
    """--backend triton names the GPU kernel: on the CPU it is a clean
    error, never a silent interpret-mode run."""
    rc = main([str(in_fasta), str(tmp_path / "o.fasta"), "--backend", "triton"])
    assert rc == 2
    assert "needs a GPU" in capsys.readouterr().err
    assert not (tmp_path / "o.fasta").exists()


def test_cli_platform_gpu_fails_loudly_without_a_gpu(in_fasta, tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    proc = subprocess.run(
        [sys.executable, "-m", "praline_tpu.cli", str(in_fasta),
         str(tmp_path / "o.fasta"), "--platform", "gpu"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root)},
    )
    assert proc.returncode == 2
    assert "error: --platform gpu" in proc.stderr
    assert not (tmp_path / "o.fasta").exists()
