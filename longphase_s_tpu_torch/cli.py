"""Command-line interface of the PyTorch/CUDA port.

``phase`` takes the flags and defaults of ``longphase_s_tpu/cli.py``'s
phase subcommand (lines 15-54), with ``--engine oracle|gpu`` (default
``gpu``) and ``--device`` (default ``cuda``). The other four subcommands
of the JAX package are not ported yet: they say so and exit 2.

    python -m longphase_s_tpu_torch.cli phase --pb -s snps.vcf -b reads.bam \\
        -r ref.fa -o phased --device cuda
"""

from __future__ import annotations

import argparse
import sys

from longphase_s_tpu.cli import _localize_inputs, _validate_files

from . import __version__

NOT_PORTED = ("haplotag", "somatic_haplotag", "estimate_purity", "modcall")


def _add_phase_parser(sub):
    # add_help=False frees -h for --svThreshold, matching the reference's
    # shortopts "h:" (Phasing.cpp:53,85)
    p = sub.add_parser("phase", help="run phasing algorithm", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-s", "--snp-file", required=True)
    p.add_argument("-b", "--bam-file", action="append", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--out-prefix", default="result")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--sv-file", default="")
    p.add_argument("--mod-file", default="")
    p.add_argument("--ont", action="store_true")
    p.add_argument("--pb", action="store_true")
    p.add_argument("--indels", action="store_true")
    p.add_argument("--indelQuality", type=int, default=0)
    p.add_argument("--deepsomatic_output", action="store_true")
    p.add_argument("--dot", action="store_true")
    p.add_argument("-d", "--distance", type=int, default=300000)
    p.add_argument("-1", "--edgeThreshold", type=float, default=0.7)
    p.add_argument("-a", "--connectAdjacent", type=int, default=35)
    p.add_argument("-q", "--mappingQuality", type=int, default=1)
    p.add_argument("-p", "--baseQuality", type=int, default=12)
    p.add_argument("-e", "--edgeWeight", type=float, default=0.1)
    p.add_argument("-n", "--snpConfidence", type=float, default=0.75)
    p.add_argument("-m", "--readConfidence", type=float, default=0.65)
    p.add_argument("-L", "--overlapThreshold", type=float, default=0.2)
    p.add_argument("-w", "--svWindow", type=int, default=20)
    p.add_argument("-h", "--svThreshold", type=float, default=0.1)
    # parsed and reported but never consumed by the reference pipeline
    # (Phasing.cpp:136,351; PhasingProcess.h:25 has no reader)
    p.add_argument("-x", "--mismatchRate", type=float, default=3)
    p.add_argument("--engine", choices=["oracle", "gpu"], default="gpu")
    p.add_argument("--device", default="cuda",
                   help="device of the gpu engine: cuda, cuda:N or cpu")
    p.add_argument("--checkpoint", default="", metavar="DIR")
    p.add_argument("--dist", default="", metavar="HOST:PORT,NPROCS,PID",
                   help="multi-host sharding; not ported yet")
    return p


def build_parser():
    parser = argparse.ArgumentParser(prog="longphase-s-tpu-torch")
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command")
    _add_phase_parser(sub)
    for name in NOT_PORTED:
        sub.add_parser(name, help="not ported to the PyTorch package yet")
    return parser


def _run_phase(args):
    from longphase_s_tpu.core.phase_algo import PhaseParams

    from .models.phase import PhaseConfig, run_phase

    if not args.ont and not args.pb:
        print("phase: missing arguments. --ont or --pb", file=sys.stderr)
        return 1
    params = PhaseParams(
        distance=args.distance, connect_adjacent=args.connectAdjacent,
        mapping_quality=args.mappingQuality, base_quality=args.baseQuality,
        edge_weight=args.edgeWeight, snp_confidence=args.snpConfidence,
        read_confidence=args.readConfidence, edge_threshold=args.edgeThreshold,
        overlap_threshold=args.overlapThreshold, sv_window=args.svWindow,
        sv_threshold=args.svThreshold, is_ont=args.ont,
        phase_indel=args.indels, indel_quality=args.indelQuality)
    cfg = PhaseConfig(
        snp_file=args.snp_file, bam_files=args.bam_file,
        fasta_file=args.reference, result_prefix=args.out_prefix,
        sv_file=args.sv_file, mod_file=args.mod_file,
        num_threads=args.threads, is_ont=args.ont, is_pb=args.pb,
        phase_indel=args.indels, indel_quality=args.indelQuality,
        deepsomatic_output=args.deepsomatic_output, dot=args.dot,
        command=" ".join(sys.argv), engine=args.engine, device=args.device,
        checkpoint_dir=args.checkpoint, dist=args.dist, params=params)
    run_phase(cfg)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"{argv[0]}: not ported to longphase_s_tpu_torch yet; use "
              "python -m longphase_s_tpu.cli", file=sys.stderr)
        return 2
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command != "phase":
        parser.print_help()
        return 1
    _localize_inputs(args)
    _validate_files("phase",
                    [("SNP file", args.snp_file),
                     ("reference file", args.reference)]
                    + [("BAM file", b) for b in args.bam_file],
                    [("SV file", args.sv_file),
                     ("MOD file", args.mod_file)])
    return _run_phase(args)


if __name__ == "__main__":
    sys.exit(main())
