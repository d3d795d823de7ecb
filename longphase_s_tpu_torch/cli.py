"""Command-line interface of the PyTorch/CUDA port.

``phase`` takes the flags and defaults of ``longphase_s_tpu/cli.py``'s
phase subcommand (lines 15-54), with ``--engine oracle|gpu`` (default
``gpu``) and ``--device`` (default ``cuda``). ``haplotag``,
``somatic_haplotag`` and ``estimate_purity`` take those of JAX cli.py:
113-160, with their configs built as at :221-277, plus ``--device``
(default ``cuda``): where the tag reductions run when the engine gate
(``LPS_TAG_ENGINE``, ``LPS_TAG_DEVICE_MIN``) sends a walk to the device.
``modcall`` takes those of JAX cli.py:161-184, with its config built as at
:279-295, plus ``--device`` (default ``cuda``): where the methylation
graph's edge counts run when the same gate sends a chromosome to the
device. ``--dist HOST:PORT,NPROCS,PID`` (or ``LPS_DIST``) runs a
subcommand as NPROCS processes over a gloo group
(``parallel/distributed.py``): each process takes a round-robin shard of
the contigs and runs its device step on its own card (a bare ``--device
cuda`` becomes ``cuda:{PID % device_count}``), the results are
all-gathered and process 0 writes the outputs.

    python -m longphase_s_tpu_torch.cli phase --pb -s snps.vcf -b reads.bam \\
        -r ref.fa -o phased --device cuda
    python -m longphase_s_tpu_torch.cli haplotag -s phased.vcf -b reads.bam \\
        -r ref.fa -o tagged --device cuda
    python -m longphase_s_tpu_torch.cli modcall -b meth.bam -r ref.fa \\
        -s snps.vcf -o modcall_result --device cuda
    # two processes on one host, started together:
    python -m longphase_s_tpu_torch.cli phase ... --dist 127.0.0.1:29500,2,0
    python -m longphase_s_tpu_torch.cli phase ... --dist 127.0.0.1:29500,2,1
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__

_DEVICE_HELP = "device of the tag reductions: cuda, cuda:N or cpu"
_DIST_HELP = ("run as NPROCS processes over a gloo group, each on its "
              "contig shard and its own card; process 0 writes")


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
                   help=_DIST_HELP)
    return p


def _add_tag_parsers(sub):
    """haplotag, somatic_haplotag and estimate_purity (JAX cli.py:113-160)."""
    hp = sub.add_parser("haplotag", help="tag reads by haplotype")
    hp.add_argument("-s", "--snp-file", required=True)
    hp.add_argument("-b", "--bam-file", required=True)
    hp.add_argument("-r", "--reference", required=True)
    hp.add_argument("-o", "--out-prefix", default="result")
    hp.add_argument("-t", "--threads", type=int, default=1)
    hp.add_argument("--sv-file", default="")
    hp.add_argument("--mod-file", default="")
    hp.add_argument("-q", "--qualityThreshold", type=int, default=1)
    hp.add_argument("-p", "--percentageThreshold", type=float, default=0.6)
    hp.add_argument("--tagSupplementary", action="store_true")
    hp.add_argument("--region", default="")
    hp.add_argument("--cram", action="store_true")
    hp.add_argument("--log", action="store_true")
    hp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    hp.add_argument("--dist", default="", metavar="HOST:PORT,NPROCS,PID",
                    help=_DIST_HELP)
    for name in ("somatic_haplotag", "estimate_purity"):
        sp = sub.add_parser(name, help=f"{name.replace('_', ' ')}")
        sp.add_argument("-s", "--snp-file", required=True,
                        help="phased normal SNP VCF")
        sp.add_argument("--tumor-snv-file", required=True)
        sp.add_argument("-b", "--bam-file", required=True, help="normal BAM")
        sp.add_argument("--tumor-bam-file", required=True)
        sp.add_argument("-r", "--reference", required=True)
        sp.add_argument("-o", "--out-prefix", default="result")
        sp.add_argument("-t", "--threads", type=int, default=1)
        sp.add_argument("--sv-file", default="")
        sp.add_argument("--mod-file", default="")
        sp.add_argument("-q", "--qualityThreshold", type=int,
                        default=(20 if name == "estimate_purity" else 1))
        sp.add_argument("-p", "--percentageThreshold", type=float, default=0.6)
        sp.add_argument("--tagSupplementary", action="store_true",
                        default=(name == "estimate_purity"))
        sp.add_argument("--region", default="")
        sp.add_argument("--cram", action="store_true")
        sp.add_argument("--log", action="store_true")
        sp.add_argument("--tumor-purity", type=float, default=None,
                        help="fixed purity (disables automatic estimation)")
        sp.add_argument("--disableFilter", action="store_true")
        sp.add_argument("--output-somatic-vcf", action="store_true")
        sp.add_argument("--somatic-calling-log", action="store_true")
        sp.add_argument("--truth-vcf", default="")
        sp.add_argument("--truth-bed", default="")
        sp.add_argument("--benchmark-log", action="store_true")
        sp.add_argument("--checkpoint", default="", metavar="DIR")
        sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
        sp.add_argument("--dist", default="", metavar="HOST:PORT,NPROCS,PID",
                        help=_DIST_HELP)


def _add_modcall_parser(sub):
    """modcall (JAX cli.py:161-184)."""
    mc = sub.add_parser("modcall", help="5mC methylation calling")
    # the reference's long form is --methylbamfile (ModCall.cpp:49);
    # --bam-file kept as an ours-only convenience alias
    mc.add_argument("-b", "--methylbamfile", "--bam-file", dest="bam_file",
                    action="append", required=True)
    mc.add_argument("-r", "--reference", required=True)
    mc.add_argument("-s", "--snp-file", default="")
    mc.add_argument("-o", "--out-prefix", default="modcall_result")
    mc.add_argument("-t", "--threads", type=int, default=1)
    mc.add_argument("-m", "--modThreshold", type=float, default=0.8)
    mc.add_argument("-u", "--unModThreshold", type=float, default=0.2)
    mc.add_argument("-e", "--heterRatio", type=float, default=0.6)
    # reference short form is -i (ModCall.cpp shortopts "s:o:t:r:b:m:u:e:i:");
    # -n kept as an ours-only alias
    mc.add_argument("-i", "-n", "--noiseRatio", dest="noiseRatio",
                    type=float, default=0.2)
    mc.add_argument("-a", "--connectAdjacent", type=int, default=20)
    mc.add_argument("-c", "--connectConfidence", type=float, default=0.9)
    mc.add_argument("-k", "--iterCount", type=int, default=2)
    mc.add_argument("--all", dest="output_all", action="store_true")
    mc.add_argument("--checkpoint", default="", metavar="DIR")
    mc.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    mc.add_argument("--dist", default="", metavar="HOST:PORT,NPROCS,PID",
                    help=_DIST_HELP)


def _validate_files(program, required, optional=()):
    """FileValidator semantics (ArgumentManager.cpp:32-66): required files
    must exist; optional ones only when non-empty. Exits with a clean error
    instead of a traceback."""
    ok = True
    for desc, path in required:
        if not path:
            print(f"[ERROR] {program}: missing {desc}.", file=sys.stderr)
            ok = False
        elif not os.path.exists(path):
            print(f"[ERROR] {program}: {desc}: {path} not exist.\n",
                  file=sys.stderr)
            ok = False
    for desc, path in optional:
        if path and not os.path.exists(path):
            print(f"[ERROR] {program}: {desc}: {path} not exist.\n",
                  file=sys.stderr)
            ok = False
    if not ok:
        sys.exit(1)


_REMOTE_ATTRS = ("snp_file", "bam_file", "reference", "sv_file", "mod_file",
                 "tumor_snv_file", "tumor_bam_file", "truth_vcf",
                 "truth_bed")


def _localize_inputs(args):
    """http(s) input URLs -> cached local files (io/remote.py), the CLI
    analog of the reference's hfile remote-open
    (htslib/hfile_libcurl.c). Runs before FileValidator so
    validation sees the fetched copy."""
    from .io.remote import is_remote, localize

    for attr in _REMOTE_ATTRS:
        v = getattr(args, attr, None)
        if isinstance(v, list):
            if any(is_remote(x) for x in v):
                setattr(args, attr, [localize(x) for x in v])
        elif is_remote(v):
            setattr(args, attr, localize(v))


def build_parser():
    parser = argparse.ArgumentParser(prog="longphase-s-tpu-torch")
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command")
    _add_phase_parser(sub)
    _add_tag_parsers(sub)
    _add_modcall_parser(sub)
    return parser


def _run_phase(args):
    from .core.phase_algo import PhaseParams
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


def _run_haplotag(args):
    from .models.haplotag import HaplotagConfig, run_haplotag

    _validate_files("haplotag",
                    [("SNP file", args.snp_file),
                     ("BAM file", args.bam_file),
                     ("reference file", args.reference)],
                    [("SV file", args.sv_file),
                     ("MOD file", args.mod_file)])
    run_haplotag(HaplotagConfig(
        snp_file=args.snp_file, bam_file=args.bam_file,
        fasta_file=args.reference, result_prefix=args.out_prefix,
        sv_file=args.sv_file, mod_file=args.mod_file,
        num_threads=args.threads, quality_threshold=args.qualityThreshold,
        percentage_threshold=args.percentageThreshold,
        tag_supplementary=args.tagSupplementary, region=args.region,
        write_read_log=args.log, output_cram=args.cram,
        command=" ".join(sys.argv), dist=args.dist, device=args.device))
    return 0


def _run_somatic(args):
    from .models.somatic import (SomaticConfig, run_estimate_purity,
                                 run_somatic_haplotag)

    _validate_files(args.command,
                    [("SNP file", args.snp_file),
                     ("tumor SNV file", args.tumor_snv_file),
                     ("BAM file", args.bam_file),
                     ("tumor BAM file", args.tumor_bam_file),
                     ("reference file", args.reference)],
                    [("SV file", args.sv_file),
                     ("MOD file", args.mod_file),
                     ("truth VCF file", args.truth_vcf),
                     ("truth BED file", args.truth_bed)])
    cfg = SomaticConfig(
        snp_file=args.snp_file, tumor_snv_file=args.tumor_snv_file,
        bam_file=args.bam_file, tumor_bam_file=args.tumor_bam_file,
        fasta_file=args.reference, result_prefix=args.out_prefix,
        sv_file=args.sv_file, mod_file=args.mod_file,
        num_threads=args.threads, quality_threshold=args.qualityThreshold,
        percentage_threshold=args.percentageThreshold,
        tag_supplementary=args.tagSupplementary, region=args.region,
        write_read_log=args.log,
        tumor_purity=(args.tumor_purity
                      if args.tumor_purity is not None else 0.2),
        estimate_tumor_purity=args.tumor_purity is None,
        enable_filter=not args.disableFilter,
        write_somatic_vcf=args.output_somatic_vcf,
        write_calling_log=args.somatic_calling_log,
        truth_vcf=args.truth_vcf, truth_bed=args.truth_bed,
        write_benchmark_log=args.benchmark_log,
        output_cram=args.cram, checkpoint_dir=args.checkpoint,
        command=" ".join(sys.argv), dist=args.dist, device=args.device)
    if args.command == "somatic_haplotag":
        run_somatic_haplotag(cfg)
    else:
        run_estimate_purity(cfg)
    return 0


def _run_modcall(args):
    from .models.modcall import ModCallConfig, run_modcall

    _validate_files("modcall",
                    [("reference file", args.reference)]
                    + [("BAM file", b) for b in args.bam_file],
                    [("SNP file", args.snp_file)])
    run_modcall(ModCallConfig(
        bam_files=args.bam_file, fasta_file=args.reference,
        snp_file=args.snp_file, result_prefix=args.out_prefix,
        num_threads=args.threads, mod_threshold=args.modThreshold,
        unmod_threshold=args.unModThreshold, heter_ratio=args.heterRatio,
        noise_ratio=args.noiseRatio, connect_adjacent=args.connectAdjacent,
        connect_confidence=args.connectConfidence, iter_count=args.iterCount,
        output_all_mod=args.output_all, command=" ".join(sys.argv),
        checkpoint_dir=args.checkpoint, dist=args.dist, device=args.device))
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    _localize_inputs(args)
    if args.command == "haplotag":
        return _run_haplotag(args)
    if args.command in ("somatic_haplotag", "estimate_purity"):
        return _run_somatic(args)
    if args.command == "modcall":
        return _run_modcall(args)
    _validate_files("phase",
                    [("SNP file", args.snp_file),
                     ("reference file", args.reference)]
                    + [("BAM file", b) for b in args.bam_file],
                    [("SV file", args.sv_file),
                     ("MOD file", args.mod_file)])
    return _run_phase(args)


if __name__ == "__main__":
    sys.exit(main())
