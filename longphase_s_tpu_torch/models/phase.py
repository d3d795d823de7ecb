"""Germline phasing pipeline (reference: PhasingProcess.cpp:5-208).

Counterpart of ``longphase_s_tpu/models/phase.py:run_phase`` with the
per-chromosome dispatch swapped (JAX lines 200-292): ``engine="gpu"`` runs
the device step of this package on ``cfg.device``, ``engine="oracle"`` the
host reference-semantics path (``core.phase_algo``). Parsing, extraction,
filters and the VCF writers are the port's copies of the JAX package's
host layers.
The multichip sink and drain (JAX lines 52-118) batch the deferred
chromosomes on ``cfg.device`` (``parallel/multichip.py``), or run the
site-sharded wavefront over the process's devices, with no
per-chromosome fallback. Under ``--dist`` / ``LPS_DIST``
(``parallel/distributed.py``) each process phases its contig shard on its
own card (``dist.local_device``) and the results are all-gathered;
process 0 writes the VCFs.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .. import REFERENCE_VERSION, native
from ..core.alleles import extract_chromosome
from ..core.clip import get_cnv_intervals
from ..core.fastpath import phase_chromosome_flat, phased_records
from ..core.phase_algo import PhaseParams, phase_chromosome
from ..core.snp_filter import compute_ont_erasures, filter_ont_snps
from ..io import vcf as vcf_io
from ..io.fasta import FastaFile
from ..ops.engine import phase_chromosome_device
from ..parallel import distributed as dist
from ..utils import StageTimer
from ..utils.device import resolve_device

ENGINES = ("oracle", "gpu")


@dataclass
class PhaseConfig:
    snp_file: str
    bam_files: list[str]
    fasta_file: str
    result_prefix: str = "result"
    sv_file: str = ""
    mod_file: str = ""
    num_threads: int = 1
    is_ont: bool = False
    is_pb: bool = False
    phase_indel: bool = False
    indel_quality: int = 0
    dot: bool = False
    deepsomatic_output: bool = False
    command: str = ""
    engine: str = "gpu"  # "oracle" (host, exact) | "gpu" (this package's kernels)
    device: str = "cuda"  # where engine="gpu" runs: "cuda", "cuda:N" or "cpu"
    checkpoint_dir: str = ""  # per-contig resume (utils/checkpoint.py)
    dist: str = ""  # "host:port,nprocs,pid" multi-process spec
    params: PhaseParams = field(default_factory=PhaseParams)


def _merge_flats(flats: list[dict]) -> dict:
    """One ingest dict from the per-BAM dicts (JAX models/phase.py:224-241)."""
    if len(flats) == 1:
        return flats[0]
    offs = [flats[0]["aln_offsets"]]
    noffs = [flats[0]["name_offsets"]]
    for g in flats[1:]:
        offs.append(g["aln_offsets"][1:] + offs[-1][-1])
        noffs.append(g["name_offsets"][1:] + noffs[-1][-1])
    merged = {key: np.concatenate([g[key] for g in flats])
              for key in ("obs_pos", "obs_allele", "obs_qual", "aln_start",
                          "clip_pos", "clip_side")}
    merged["aln_offsets"] = np.concatenate(offs)
    merged["name_offsets"] = np.concatenate(noffs)
    merged["names"] = "".join(g["names"] for g in flats)
    return merged


def _make_multichip_sink(cfg):
    """A list that collects the flat path's chromosomes for one batched
    device step (JAX phase.py:52-70), else None: engine ``gpu`` only;
    ``LPS_MULTICHIP=0`` disables it, ``=1`` forces it (on ``cfg.device``,
    the CPU included), otherwise it is on only when the process owns
    more than one CUDA device (``dist.local_device_count``: one under an
    active group). On one card the default stays per chromosome."""
    env = os.environ.get("LPS_MULTICHIP", "")
    if cfg.engine != "gpu" or env == "0":
        return None
    if env == "1":
        return []
    return [] if dist.local_device_count() > 1 else None


def _use_wavefront(n_chroms: int, device) -> bool:
    """Whether the drain runs the site-sharded wavefront (JAX
    phase.py:90-95): ``LPS_WAVEFRONT=1`` forces it and ``=0`` disables it;
    otherwise it engages when fewer chromosomes are deferred than there are
    devices (the process's CUDA devices for a CUDA ``device``, else 1), so
    never on one card."""
    wf = os.environ.get("LPS_WAVEFRONT", "")
    n_dev = dist.local_device_count() if device.type == "cuda" else 1
    return wf == "1" or (wf != "0" and n_chroms < n_dev)


def _wavefront_devices(device) -> list:
    """The wavefront's devices: ``device`` first, where the pair stage,
    the assembly and the correction run, then the other visible CUDA
    devices in order; a device that is not CUDA, or a process of an active
    group (which owns one card), alone."""
    import torch

    if device.type != "cuda" or dist.is_active():
        return [device]
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    return [torch.device("cuda", first)] + [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
        if i != first]


def _drain_multichip(sink, cfg, device, record):
    """Phase the deferred chromosomes in one batch on ``device``, or with
    the wavefront (``_use_wavefront``) over ``_wavefront_devices``, and
    record each one's result (JAX phase.py:73-118). A failure raises:
    there is no per-chromosome retry."""
    from ..parallel.multichip import (run_fused_phase_multichip,
                                      run_fused_phase_wavefront)

    if _use_wavefront(len(sink), device):
        outs = run_fused_phase_wavefront(sink, cfg.params,
                                         _wavefront_devices(device))
    else:
        outs = run_fused_phase_multichip(sink, cfg.params, device)
    for e, (ps, ori) in zip(sink, outs):
        record(e["chrom"], phased_records(e["chrom"], e["positions"], ps, ori))


def run_phase(cfg: PhaseConfig) -> dict:
    if cfg.engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {cfg.engine!r}")
    dist.init_from_spec(cfg.dist)
    dist.maybe_init_from_env()
    device = resolve_device(dist.local_device(cfg.device)) \
        if cfg.engine == "gpu" else None
    timer = StageTimer()
    cfg.params.is_ont = cfg.is_ont
    cfg.params.phase_indel = cfg.phase_indel
    cfg.params.indel_quality = cfg.indel_quality

    if cfg.deepsomatic_output:
        with timer("preprocessing DeepSomatic VCF (filter GERMLINE, adjust GT by VAF)"):
            pre = cfg.result_prefix + "_preprocessed.vcf"
            if not dist.is_writer():  # avoid cross-process write races
                pre += f".p{dist.process_id()}"
            vcf_io.preprocess_deepsomatic_vcf(cfg.snp_file, pre)
            cfg.snp_file = pre

    with timer("parsing VCF"):
        het = vcf_io.read_het_variants(cfg.snp_file, cfg.phase_indel, cfg.indel_quality)
        if cfg.phase_indel and cfg.indel_quality > 0 and dist.is_writer():
            with open(cfg.result_prefix + "_removed_indels.log", "w") as f:
                f.write("#CHROM\tPOS\tREF\tALT\tQUAL\n")
                for line in het.removed_indel_log:
                    f.write(line + "\n")

    sv_set = None
    meth_set = None
    if cfg.sv_file:
        with timer("parsing SV VCF"):
            sv_set = vcf_io.read_sv_variants(cfg.sv_file, het)
    if cfg.mod_file:
        with timer("parsing Meth VCF"):
            meth_set = vcf_io.read_meth_variants(
                cfg.mod_file, het, sv_set or vcf_io.SVVariantSet())

    with timer("reading reference"):
        fasta = FastaFile(cfg.fasta_file)

    chr_results: dict[str, dict] = {}
    multichip_sink = _make_multichip_sink(cfg)
    ckpt = None
    if cfg.checkpoint_dir:
        from ..utils.checkpoint import ContigCheckpoint, phase_fingerprint

        ckpt = ContigCheckpoint(cfg.checkpoint_dir, phase_fingerprint(cfg))
        resumed = ckpt.load()
        chr_results.update(resumed)
        if resumed:
            print(f"checkpoint: resumed {len(resumed)} contig(s) from "
                  f"{cfg.checkpoint_dir}", file=sys.stderr)

    def record(chrom: str, result: dict):
        chr_results[chrom] = result
        if ckpt is not None:
            ckpt.save(chrom, result)
        print(f"({chrom})", end="", file=sys.stderr, flush=True)

    def phase_flat(chrom, last_snp, positions, infos, variants, ref_string,
                   sv_entries, mod_entries):
        """The native flat path; False when the library declines a BAM."""
        flats = []
        for path in cfg.bam_files:
            f = native.extract_phase(path, chrom, last_snp, positions, infos,
                                     ref_string, cfg.params.mapping_quality,
                                     fasta_path=cfg.fasta_file,
                                     sv_entries=sv_entries,
                                     mod_entries=mod_entries,
                                     sv_window=cfg.params.sv_window,
                                     sv_threshold=cfg.params.sv_threshold)
            if f is None:
                return False
            flats.append(f)
        flat = _merge_flats(flats)
        clip_count: dict[int, list[int]] = {}
        for pos, side in zip(flat["clip_pos"].tolist(),
                             flat["clip_side"].tolist()):
            clip_count.setdefault(pos, [0, 0])[side] += 1
        intervals = get_cnv_intervals(clip_count)
        if len(flat["aln_start"]) == 0:
            return True
        erased = compute_ont_erasures(variants, ref_string) if cfg.is_ont \
            else None
        # duplicated interval list (Clip ctor + explicit call,
        # PhasingProcess.cpp:147-148)
        r = phase_chromosome_flat(flat, intervals + intervals, chrom,
                                  cfg.params, erased, device,
                                  defer_sink=multichip_sink)
        if r != "deferred":
            record(chrom, r)
        return True

    def process_chrom(chrom: str):
        if chrom in chr_results:  # checkpoint-resumed
            return
        last_snp = het.last_snp(chrom)
        if last_snp == -1:
            return
        # reference fetches [0, lastSNP+5] (ParsingBam.cpp:47)
        ref_string = fasta.fetch(chrom, 0, last_snp + 6) if chrom in fasta.index else ""
        variants = het.by_chrom[chrom]
        vcf_io.mark_danger_indels(variants, ref_string)
        positions = sorted(variants)
        infos = [variants[p] for p in positions]
        sv_entries = None
        if sv_set is not None:
            sv_entries = sorted(sv_set.by_chrom.get(chrom, {}).items())
        mod_entries = None
        if meth_set is not None:
            mod_entries = sorted(meth_set.by_chrom.get(chrom, {}).items())

        device_path = cfg.engine == "gpu" and not cfg.dot
        if device_path and native.available() and phase_flat(
                chrom, last_snp, positions, infos, variants, ref_string,
                sv_entries, mod_entries):
            return

        alns, clip_count = extract_chromosome(
            cfg.bam_files, chrom, last_snp, positions, infos, ref_string,
            mapping_quality=cfg.params.mapping_quality,
            sv_entries=sv_entries, mod_entries=mod_entries,
            sv_window=cfg.params.sv_window, sv_threshold=cfg.params.sv_threshold,
            fasta=fasta)
        if cfg.is_ont:
            filter_ont_snps(variants, alns, ref_string)
        if not alns:
            return
        # Clip ctor + the explicit second call duplicate every interval
        # (PhasingProcess.cpp:147-148)
        intervals = get_cnv_intervals(clip_count)
        cnv_vec = intervals + intervals
        if device_path:
            result = phase_chromosome_device(alns, cnv_vec, chrom, cfg.params,
                                             device)
        else:
            result, _read_hp, _g = phase_chromosome(alns, cnv_vec, chrom,
                                                    cfg.params,
                                                    generate_dot=cfg.dot)
        record(chrom, result)

    with timer("phasing chromosomes"):
        chroms = list(het.contigs)
        if dist.is_active():
            chroms = dist.shard_contigs(chroms)
        if cfg.num_threads > 1:
            with ThreadPoolExecutor(max_workers=cfg.num_threads) as pool:
                list(pool.map(process_chrom, chroms))
        else:
            for c in chroms:
                process_chrom(c)
        if multichip_sink:
            _drain_multichip(multichip_sink, cfg, device, record)
        print("", file=sys.stderr)

    if dist.is_active():
        with timer("allgather shard results"):
            chr_results = dist.merge_chr_results(chr_results)

    with timer("merge results"):
        merged: dict[str, tuple[str, int]] = {}
        for chrom in chr_results:
            merged.update(chr_results[chrom])

    if dist.is_writer():
        with timer("writeResult SNP"):
            vcf_io.rewrite_result_vcf(
                cfg.snp_file, cfg.result_prefix + ".vcf", merged, het,
                REFERENCE_VERSION, cfg.command,
                phase_indel=cfg.phase_indel, indel_quality=cfg.indel_quality)
        if sv_set is not None:
            with timer("write SV Result"):
                vcf_io.rewrite_sv_vcf(
                    cfg.sv_file, cfg.result_prefix + "_SV.vcf",
                    merged, sv_set, REFERENCE_VERSION, cfg.command)
        if meth_set is not None:
            with timer("write mod Result"):
                vcf_io.rewrite_meth_vcf(
                    cfg.mod_file, cfg.result_prefix + "_mod.vcf",
                    merged, meth_set, REFERENCE_VERSION, cfg.command)
    return merged
