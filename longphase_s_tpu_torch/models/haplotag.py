"""Germline haplotagging pipeline (HaplotagProcess.cpp + HaplotagStrategy.cpp).

Per chromosome (sequential, ordered BAM output like the reference's
SINGLE_THREAD mode): walk each alignment's CIGAR against the phased-variant
table, count HP1/HP2 allele support (judgeSnpHap / judgeDeletionHap /
judgeSVHap), then assign the read haplotype by majority with PQ and PS
(judgeReadHap) and append HP:i/PS:i/PQ:i aux tags.

The port's copy of ``longphase_s_tpu/models/haplotag.py``. ``run_haplotag``
takes this package's fast path first (``models/haplotag_fast.py``, the
judge reductions on ``cfg.device``); the object path below it serves
``--log`` and CRAM output without a native handle. Under ``--dist`` /
``LPS_DIST`` the fast path tags each process's contig shard on its own
card and gathers the tag segments; process 0 writes the BAM.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

from .. import REFERENCE_VERSION
from ..core.alleles import homopolymer_length
from ..io.bam import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CHARD_CLIP,
                      BAM_CINS, BAM_CMATCH, BAM_CPAD, BAM_CREF_SKIP,
                      BAM_CSOFT_CLIP, SEQ_NT16, BamReader, BamWriter,
                      region_bounds)
from ..io.cram import CramWriter, open_alignment
from ..io.fasta import FastaFile
from ..io.phased_vcf import (NORMAL, PHASED_HETERO, PhasedVcfReader, VcfInfo,
                             VT_DELETION, VT_INSERTION, VT_SNP)
from ..parallel import distributed as dist
from ..utils import StageTimer
from ..utils.device import resolve_device

# ReadHP enum values written to HP:i (HaplotagType.h:97-108)
HP_H1 = 1
HP_H2 = 2
UNTAG = -1


@dataclass
class HaplotagConfig:
    snp_file: str
    bam_file: str
    fasta_file: str
    result_prefix: str = "result"
    sv_file: str = ""
    mod_file: str = ""
    num_threads: int = 1
    quality_threshold: int = 1
    percentage_threshold: float = 0.6
    tag_supplementary: bool = False
    region: str = ""
    write_read_log: bool = False
    output_cram: bool = False
    command: str = ""
    dist: str = ""  # "host:port,nprocs,pid" multi-process spec
    device: str = "cuda"  # where the judge reductions run: cuda, cuda:N, cpu


@dataclass
class ReadStatistics:
    """HaplotagProcess.h:21-45 counter struct."""

    total_alignment: int = 0
    total_supplementary: int = 0
    total_secondary: int = 0
    total_unmapped: int = 0
    total_tag_count: int = 0
    total_untag_count: int = 0
    total_lower_quality: int = 0
    total_empty_variant: int = 0
    total_other_case: int = 0
    total_high_similarity: int = 0
    total_cross_two_block: int = 0
    total_without_variant: int = 0
    hp_count: dict[int, int] = field(default_factory=dict)

    def bump_hp(self, hp: int):
        self.hp_count[hp] = self.hp_count.get(hp, 0) + 1


def _judge_snp_hap(var, base, next_op, hp_count, variants_hp, count_ps, pos):
    """GermlineHaplotagStrategy::judgeSnpHap (HaplotagStrategy.cpp:20-130).

    ``next_op`` is the CIGAR op following the current M op when the variant
    sits at the op's last reference base (IsAltIndel context), else None.
    """
    if var.variant_type == VT_SNP:
        if base == var.ref or base == var.alt:
            if not var.has_ps:
                print(f"[ERROR] (judgeSnpHap) => can't find the position: pos: {pos}",
                      file=sys.stderr)
                sys.exit(0)
            if base == var.hp1:
                hp_count[1] += 1
                variants_hp[pos] = 0
            if base == var.hp2:
                hp_count[2] += 1
                variants_hp[pos] = 1
            count_ps[var.phased_set] = count_ps.get(var.phased_set, 0) + 1
    elif var.variant_type == VT_INSERTION and next_op is not None:
        hp1_long = len(var.hp1) != 1
        hp2_long = len(var.hp2) != 1
        if next_op == BAM_CINS:
            if hp1_long and not hp2_long:
                hp_count[1] += 1
                variants_hp[pos] = 0
            elif not hp1_long and hp2_long:
                hp_count[2] += 1
                variants_hp[pos] = 1
        else:
            if hp1_long and not hp2_long:
                hp_count[2] += 1
                variants_hp[pos] = 1
            elif not hp1_long and hp2_long:
                hp_count[1] += 1
                variants_hp[pos] = 0
        count_ps[var.phased_set] = count_ps.get(var.phased_set, 0) + 1
    elif var.variant_type == VT_DELETION and next_op is not None:
        hp1_long = len(var.hp1) != 1
        hp2_long = len(var.hp2) != 1
        if next_op == BAM_CDEL:
            if hp1_long and not hp2_long:
                hp_count[1] += 1
                variants_hp[pos] = 0
            elif not hp1_long and hp2_long:
                hp_count[2] += 1
                variants_hp[pos] = 1
        else:
            if hp1_long and not hp2_long:
                hp_count[2] += 1
                variants_hp[pos] = 1
            elif not hp1_long and hp2_long:
                hp_count[1] += 1
                variants_hp[pos] = 0
        count_ps[var.phased_set] = count_ps.get(var.phased_set, 0) + 1


class GermlineWalker:
    """Per-chromosome stateful walker (CigarParser + germline hooks)."""

    def __init__(self, positions, variants, ref_string: str):
        self.positions = positions          # sorted list of variant positions
        self.variants = variants            # pos -> {genome: VarData}
        self.ref_string = ref_string
        self.first_idx = 0

    def walk(self, rec):
        """Returns (hp_count[2], variants_hp, count_ps)."""
        positions = self.positions
        variants = self.variants
        n = len(positions)
        hp_count = {1: 0, 2: 0}
        variants_hp: dict[int, int] = {}
        count_ps: dict[int, int] = {}

        while self.first_idx < n and positions[self.first_idx] < rec.pos:
            self.first_idx += 1
        if self.first_idx >= n:
            return hp_count, variants_hp, count_ps
        vi = self.first_idx

        ref_pos = rec.pos
        query_pos = 0
        cigars = rec.cigar_tuples()
        n_cigar = len(cigars)
        seq = rec.seq_nibbles()

        for ci, (op, length) in enumerate(cigars):
            while vi < n and positions[vi] < ref_pos:
                vi += 1
            if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
                while vi < n and positions[vi] < ref_pos + length:
                    pos = positions[vi]
                    offset = pos - ref_pos
                    if offset >= 0:
                        base = SEQ_NT16[seq[query_pos + offset]]
                        entry = variants[pos]
                        var = entry.get(NORMAL)
                        if var is not None:
                            if ci + 1 < n_cigar:
                                next_op = cigars[ci + 1][0] \
                                    if ref_pos + length - 1 == pos else -1
                            else:
                                next_op = None
                            _judge_snp_hap(var, base, next_op, hp_count,
                                           variants_hp, count_ps, pos)
                    vi += 1
                query_pos += length
                ref_pos += length
            elif op == BAM_CINS:
                query_pos += length
            elif op == BAM_CDEL:
                already = False
                while vi < n and positions[vi] < ref_pos + length:
                    pos = positions[vi]
                    var = variants[pos].get(NORMAL)
                    if var is not None and not already:
                        if var.gt == PHASED_HETERO:
                            already = True
                            self._judge_deletion(pos, var, ref_pos, length,
                                                 query_pos, seq, hp_count,
                                                 variants_hp, count_ps)
                    vi += 1
                ref_pos += length
            elif op == BAM_CREF_SKIP:
                ref_pos += length
            elif op == BAM_CSOFT_CLIP:
                query_pos += length
            elif op in (BAM_CHARD_CLIP, BAM_CPAD):
                pass
            else:
                print(f"Alignment find unsupported CIGAR operation from read: "
                      f"{rec.qname}", file=sys.stderr)
                sys.exit(1)
        return hp_count, variants_hp, count_ps

    def _judge_deletion(self, pos, var, ref_pos, del_len, query_pos, seq,
                        hp_count, variants_hp, count_ps):
        """judgeDeletionHap (HaplotagStrategy.cpp:147-209)."""
        if self.ref_string == "":
            return
        if ref_pos + del_len + 1 == pos:
            return
        if not (ref_pos <= pos < ref_pos + del_len):
            return
        if homopolymer_length(pos, self.ref_string) < 3:
            return
        if var.variant_type == VT_SNP:
            base = SEQ_NT16[seq[query_pos]]
            if base == var.hp1:
                hp_count[1] += 1
                variants_hp[pos] = 0
            if base == var.hp2:
                hp_count[2] += 1
                variants_hp[pos] = 1
            count_ps[var.phased_set] = count_ps.get(var.phased_set, 0) + 1
        elif var.variant_type == VT_DELETION:
            hp1_long = len(var.hp1) != 1
            hp2_long = len(var.hp2) != 1
            if hp1_long and not hp2_long:
                hp_count[1] += 1
                variants_hp[pos] = 0
            elif not hp1_long and hp2_long:
                hp_count[2] += 1
                variants_hp[pos] = 1
            count_ps[var.phased_set] = count_ps.get(var.phased_set, 0) + 1


def judge_read_hap(hp_count, percentage_threshold, count_ps, stats=None):
    """judgeReadHap (HaplotagStrategy.cpp:243-300).

    Returns (hp_result, pq, ps).
    """
    h1, h2 = hp_count[1], hp_count[2]
    if h1 > h2:
        mn, mx = float(h2), float(h1)
    else:
        mn, mx = float(h1), float(h2)

    hp_result = UNTAG
    total = mx + mn
    ratio = mx / total if total else math.nan
    if ratio < percentage_threshold:
        pq = 0
        if stats is not None:
            stats.total_high_similarity += 1
    else:
        if h1 > h2:
            hp_result = HP_H1
        if h1 < h2:
            hp_result = HP_H2
        pq = 0  # set below

    if mx == 0:
        pq = 0
        if stats is not None:
            stats.total_without_variant += 1
    elif mx == total:
        pq = 40
    else:
        pq = int(-10 * math.log10(mn / total))

    if len(count_ps) > 1:
        hp_result = UNTAG
    ps = 0
    if hp_result != UNTAG and count_ps:
        # reference dereferences countPS.begin() (smallest PS); an empty map
        # here is UB in C++ (SV-only support) — guard with 0
        ps = min(count_ps)
    return hp_result, pq, ps


def cpp_double(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    if math.isnan(x):
        return "-nan"
    return f"{x:.6g}"


def write_germline_log_header(f, cfg: HaplotagConfig):
    """GermlineTagLog header (HaplotagProcess.cpp:183-208)."""
    f.write(f"##snpFile:{cfg.snp_file}\n")
    f.write(f"##svFile:{cfg.sv_file}\n")
    f.write(f"##bamFile:{cfg.bam_file}\n")
    f.write(f"##resultPrefix:{cfg.result_prefix}\n")
    f.write(f"##numThreads:{cfg.num_threads}\n")
    f.write(f"##region:{cfg.region}\n")
    f.write(f"##qualityThreshold:{cfg.quality_threshold}\n")
    f.write(f"##percentageThreshold:{cpp_double(cfg.percentage_threshold)}\n")
    f.write(f"##tagSupplementary:{int(cfg.tag_supplementary)}\n")
    f.write("#ReadID\tCHROM\tReadStart\tConfidnet(%)\tHaplotype\tPhaseSet\t"
            "TotalAllele\tHP1Allele\tHP2Allele\tphasingQuality(PQ)\t"
            "(Variant,HP)\t(PhaseSet,Variantcount)\n")


def write_germline_log_row(f, rec, chrom, hp_count, variants_hp, count_ps,
                           hp, pq):
    """GermlineTagLog::writeTagReadLog (HaplotagProcess.cpp:210-237)."""
    h1, h2 = hp_count[1], hp_count[2]
    mn, mx = (float(h2), float(h1)) if h1 > h2 else (float(h1), float(h2))
    sim = mx / (mx + mn) if (mx + mn) else float("nan")
    hp_str = "." if hp == UNTAG else str(hp)
    ps_str = "."
    if hp_str != "." and count_ps:
        ps_str = str(min(count_ps))
    f.write(f"{rec.qname}\t{chrom}\t{rec.pos}\t{cpp_double(sim)}\t"
            f"H{hp_str}\t{ps_str}\t{h1 + h2}\t{h1}\t{h2}\t{pq}\t")
    for pos in sorted(variants_hp):
        f.write(f" {pos},{variants_hp[pos]}")
    f.write("\t")
    for ps in sorted(count_ps):
        f.write(f" {ps},{count_ps[ps]}")
    f.write("\n")


def run_haplotag(cfg: HaplotagConfig) -> ReadStatistics:
    from .haplotag_fast import run_haplotag_fast

    dist.init_from_spec(cfg.dist)
    dist.maybe_init_from_env()
    device = resolve_device(dist.local_device(cfg.device))
    fast = run_haplotag_fast(cfg, device)
    if fast is not None:
        return fast

    timer = StageTimer()
    stats = ReadStatistics()

    chr_multi: dict[str, dict[int, dict[int, object]]] = {}
    info = VcfInfo(sample=NORMAL)
    reader = PhasedVcfReader(NORMAL)
    with timer("parsing SNP VCF"):
        reader.parse(cfg.snp_file, info, chr_multi, mode="snp")
    if cfg.sv_file:
        with timer("parsing SV VCF"):
            reader.parse(cfg.sv_file, info, chr_multi, mode="sv")
    if cfg.mod_file:
        with timer("parsing MOD VCF"):
            reader.parse(cfg.mod_file, info, chr_multi, mode="mod")

    chr_vec = list(info.chr_vec)
    if cfg.region:
        region_chr = cfg.region.split(":")[0]
        if region_chr not in chr_vec:
            print(f"[ERROR] Incorrect chromosome for input region: {region_chr}",
                  file=sys.stderr)
            sys.exit(1)
        chr_vec = [region_chr]
    for chrom in list(chr_multi):
        if chrom not in chr_vec:
            del chr_multi[chrom]

    fasta = FastaFile(cfg.fasta_file)
    bam = open_alignment(cfg.bam_file, fasta)
    header = bam.header_text
    if not header.endswith("\n") and header:
        header += "\n"
    pg_id = "longphase-s"
    header += (f"@PG\tID:{pg_id}\tPN:longphase-s\tVN:{REFERENCE_VERSION}"
               f"\tCL:{cfg.command}\n")
    if cfg.output_cram:
        out = CramWriter(cfg.result_prefix + ".cram", header, bam.references,
                         bam.lengths, fasta_path=cfg.fasta_file)
    else:
        out = BamWriter(cfg.result_prefix + ".bam", header, bam.references,
                        bam.lengths)

    sv_counts = info.read_sv_hap_count

    log_f = None
    if cfg.write_read_log:
        log_f = open(cfg.result_prefix + ".out", "w")
        write_germline_log_header(log_f, cfg)

    with timer("tag read"):
        for chrom in chr_vec:
            if chrom not in bam.ref_id:
                continue
            variants = chr_multi.get(chrom, {})
            positions = sorted(variants)
            last_var = positions[-1] if positions else None
            # reference window: [0, last phased variant + 5]
            last_phased = 0
            for p in reversed(positions):
                v = variants[p].get(NORMAL)
                if v is not None and v.has_ps:
                    last_phased = p
                    break
            ref_string = fasta.fetch(chrom, 0, last_phased + 6) \
                if chrom in fasta.index and last_phased else ""
            walker = GermlineWalker(positions, variants, ref_string)
            bam2 = open_alignment(cfg.bam_file, fasta)
            chrom_len = info.chr_length.get(chrom)
            # a ranged --region restricts the BAM iterator itself
            # (HaplotagParsingBam.cpp:448-450 passes it to sam_itr_querys)
            beg, end = region_bounds(cfg.region, chrom_len) if cfg.region \
                else (0, chrom_len)
            for rec in bam2.fetch(chrom, beg, end):
                stats.total_alignment += 1
                flag = rec.flag
                if rec.mapq < cfg.quality_threshold:
                    stats.total_lower_quality += 1
                    stats.total_untag_count += 1
                elif flag & 0x4:
                    stats.total_unmapped += 1
                    stats.total_untag_count += 1
                elif flag & 0x100:
                    stats.total_secondary += 1
                    stats.total_untag_count += 1
                elif (flag & 0x800) and not cfg.tag_supplementary:
                    stats.total_supplementary += 1
                    stats.total_untag_count += 1
                elif last_var is None:
                    stats.total_empty_variant += 1
                    stats.total_untag_count += 1
                elif rec.pos <= last_var:
                    if flag & 0x800:
                        stats.total_supplementary += 1
                    hp_count, variants_hp, count_ps = walker.walk(rec)
                    entry = sv_counts.get(rec.qname)
                    if entry is not None:
                        hp_count[1] += entry[0]
                        hp_count[2] += entry[1]
                    hp, pq, ps = judge_read_hap(
                        hp_count, cfg.percentage_threshold, count_ps, stats)
                    if log_f is not None:
                        write_germline_log_row(log_f, rec, chrom, hp_count,
                                               variants_hp, count_ps, hp, pq)
                    rec.strip_tags({"HP", "PS", "PQ"})
                    if hp != UNTAG:
                        stats.bump_hp(hp)
                        stats.total_tag_count += 1
                        rec.append_tag_int("HP", hp)
                        rec.append_tag_int("PS", ps)
                        rec.append_tag_int("PQ", pq)
                    else:
                        stats.bump_hp(UNTAG)
                        stats.total_untag_count += 1
                else:
                    stats.total_other_case += 1
                    stats.total_untag_count += 1
                out.write(rec)
            bam2.close()
    out.close()
    if log_f is not None:
        log_f.close()

    print("-------------------------------------------", file=sys.stderr)
    print(f"total alignment           : {stats.total_alignment}", file=sys.stderr)
    print(f"total tagged alignments   : {stats.total_tag_count}", file=sys.stderr)
    print(f"    L----total HP1        : {stats.hp_count.get(HP_H1, 0)}", file=sys.stderr)
    print(f"    L----total HP2        : {stats.hp_count.get(HP_H2, 0)}", file=sys.stderr)
    print(f"total untagged            : {stats.total_untag_count}", file=sys.stderr)
    return stats
