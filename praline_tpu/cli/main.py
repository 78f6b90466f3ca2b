"""``praline-tpu`` command line (SURVEY.md C21, §4.1 L6).

Reference-equivalent knob set [B:6-12]: score matrix, gap-penalty series,
alignment modes, preprofile strategy (none/global/local, optionally
homology-extended via PSI-BLAST), guide-tree linkage and score
normalization, output format, verbosity — plus the device knobs
(platform, backend, batching, mesh, checkpoints, profiling).

Usage:  praline-tpu input.fasta output.aln [options]
        python -m praline_tpu.cli input.fasta output.aln [options]
"""

from __future__ import annotations

import argparse
from pathlib import Path
import sys
import time

from ..types.config import BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="praline-tpu",
        description="Batched progressive multiple sequence alignment "
        "(PRALINE-capability engine on JAX).",
    )
    p.add_argument("input", help="input FASTA file (ungapped sequences)")
    p.add_argument("output", help="output alignment file")
    p.add_argument(
        "-m", "--matrix", default="blosum62",
        help="builtin matrix name (blosum45/50/62/80, pam30/70/120/250, "
        "dna_simple) or a matrix file path",
    )
    p.add_argument(
        "-a", "--alphabet", choices=["protein", "dna"], default="protein",
    )
    p.add_argument(
        "-g", "--gap-series", default="11,1", metavar="G1,G2,...",
        help="gap penalty series: m-th consecutive gap column costs "
        "G[min(m,k)] (default 11,1 = affine open 11 / extend 1)",
    )
    p.add_argument(
        "--mode", choices=["global", "semiglobal", "local"], default="global",
        help="alignment mode for merges and the distance stage",
    )
    p.add_argument(
        "--distance-mode", choices=["global", "semiglobal", "local"], default=None,
        help="override mode for the all-pairs distance stage",
    )
    p.add_argument(
        "-p", "--preprofile", choices=["none", "global", "local"], default="none",
        help="master-slave preprofile strategy ('none' = plain progressive)",
    )
    p.add_argument(
        "--preprofile-gap-series", default=None, metavar="G1,G2,...",
        help="gap series for preprofile alignments (default: --gap-series)",
    )
    p.add_argument(
        "--blast-db", default=None, metavar="DB",
        help="PSI-BLAST database for homology-extended preprofiles "
        "(requires psiblast on PATH)",
    )
    p.add_argument(
        "--linkage", choices=["single", "complete", "average"], default="average",
    )
    p.add_argument(
        "--score-normalization", choices=["none", "length"], default="length",
        help="normalize pairwise scores by alignment length for the guide tree",
    )
    p.add_argument(
        "-f", "--format", choices=["fasta", "clustal"], default=None,
        help="output format (default: by output extension, else fasta)",
    )
    p.add_argument(
        "--tree-out", default=None, metavar="FILE",
        help="also write the guide tree as Newick (leaf labels = sequence ids)",
    )
    p.add_argument(
        "--score-against", default=None, metavar="REF",
        help="report SP/TC column-accuracy of the result against a "
        "reference alignment (FASTA or CLUSTAL by extension) — metric "
        "only, BAliBASE-style evaluation",
    )
    p.add_argument(
        "--backend", choices=["oracle", *BACKENDS], default="auto",
        help="compute backend (oracle = the NumPy reference; auto = the "
        "fastest device route for the platform)",
    )
    p.add_argument(
        "--platform", choices=["auto", "cpu", "gpu"], default="auto",
        help="pin the JAX platform (cpu = run without touching the GPU; "
        "gpu = fail unless JAX finds one)",
    )
    p.add_argument("--batch-pairs", type=int, default=512, metavar="N",
                   help="pairwise DP problems per batched device dispatch")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="shard the pair space over the first N devices")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="write resumable stage checkpoints here")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="resume from a checkpoint dir (same as --checkpoint-dir)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a jax.profiler trace of device work")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: stage progress, -vv: debug")
    p.add_argument("--log-json", action="store_true",
                   help="emit log lines as JSON")
    return p


def parse_gap_series(text: str) -> tuple[int, ...]:
    try:
        series = tuple(int(x) for x in text.replace(" ", "").split(",") if x)
    except ValueError:
        raise SystemExit(f"error: invalid gap series {text!r} (expected e.g. '11,1')")
    if not series or any(g < 0 for g in series):
        raise SystemExit(f"error: invalid gap series {text!r} (need non-negative costs)")
    return series


def config_from_args(args: argparse.Namespace):
    """The run configuration the parsed command line asks for."""
    from ..types import PralineConfig

    out_format = args.format
    if out_format is None:
        out_format = "clustal" if args.output.endswith((".aln", ".clustal", ".clu")) else "fasta"
    return PralineConfig(
        score_matrix=args.matrix,
        alphabet="dna" if args.alphabet == "dna" else "protein",
        gap_series=parse_gap_series(args.gap_series),
        merge_mode=args.mode,
        distance_mode=args.distance_mode or args.mode,
        preprofile_mode="dummy" if args.preprofile == "none" else args.preprofile,
        preprofile_gap_series=(
            parse_gap_series(args.preprofile_gap_series)
            if args.preprofile_gap_series
            else None
        ),
        linkage=args.linkage,
        score_normalization=args.score_normalization,
        output_format=out_format,
        batch_pairs=args.batch_pairs,
        backend=args.backend,
        checkpoint_dir=args.checkpoint_dir or args.resume,
        mesh_shape=(args.devices,) if args.devices else None,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from .. import io as pio
    from ..types import ALPHABETS
    from ..util.metrics import METRICS, configure_logging, enable_profiling, log

    configure_logging(args.verbose, json_lines=args.log_json)

    if args.platform != "auto":
        # Before any backend touch: jax.config wins over JAX_PLATFORMS.
        import jax

        jax.config.update("jax_platforms", args.platform)
        try:
            platform = jax.devices()[0].platform
        except RuntimeError as e:
            print(f"error: --platform {args.platform}: {e}", file=sys.stderr)
            return 2
        if platform != args.platform:
            print(f"error: --platform {args.platform}: JAX runs on {platform}",
                  file=sys.stderr)
            return 2

    # The oracle backend is pure NumPy: never touch (or initialize) the
    # accelerator for it.
    if args.backend != "oracle":
        from ..kernels.batch import resolve_backend
        from ..util.jax_cache import enable_compile_cache

        try:
            resolve_backend(args.backend)
        except ValueError as e:
            print(f"error: --backend {args.backend}: {e}", file=sys.stderr)
            return 2
        enable_compile_cache()
    if args.profile_dir:
        enable_profiling(args.profile_dir)

    alphabet_name = "dna" if args.alphabet == "dna" else "protein"
    alphabet = ALPHABETS[alphabet_name]
    try:
        matrix = pio.resolve_score_matrix(args.matrix, alphabet)
    except (KeyError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        sequences = pio.load_sequence_fasta(args.input, alphabet)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    log.info("loaded %d sequences from %s", len(sequences), args.input)

    config = config_from_args(args)
    out_format = config.output_format

    extra_slaves = None
    if args.blast_db:
        from ..msa.homology import find_homologs_blast

        with METRICS.timed("blast"):
            extra_slaves = find_homologs_blast(sequences, args.blast_db)

    from ..msa import msa_align

    on_tree = None
    if args.tree_out:
        try:  # fail on an unwritable path BEFORE the expensive stages
            Path(args.tree_out).touch()
        except OSError as e:
            print(f"error: --tree-out: {e}", file=sys.stderr)
            return 2

        def on_tree(tree, _path=args.tree_out):
            names = [s.name for s in sequences]
            Path(_path).write_text(tree.newick(names) + "\n")
            log.info("wrote guide tree to %s", _path)

    # --devices is recorded as config.mesh_shape; msa_align builds the mesh.
    t0 = time.perf_counter()
    alignment = msa_align(
        sequences, matrix, config, extra_slaves=extra_slaves, on_tree=on_tree
    )
    log.info("aligned %d sequences into %d columns in %.2fs",
             alignment.num_members, alignment.num_columns, time.perf_counter() - t0)

    if out_format == "clustal":
        pio.write_alignment_clustal(alignment, args.output)
    else:
        pio.write_alignment_fasta(alignment, args.output, wrap=config.fasta_wrap)

    if args.score_against:
        from ..util.accuracy import sp_tc

        ref_path = args.score_against
        try:
            if ref_path.endswith((".aln", ".clustal", ".clu")):
                ref = pio.load_alignment_clustal(ref_path, alphabet)
            else:
                ref = pio.load_alignment_fasta(ref_path, alphabet)
            sp, tc = sp_tc(alignment, ref)
        except (OSError, ValueError) as e:
            print(f"error: --score-against: {e}", file=sys.stderr)
            return 2
        log.info("column accuracy vs %s: SP=%.4f TC=%.4f", ref_path, sp, tc)
        print(f"SP={sp:.4f} TC={tc:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
