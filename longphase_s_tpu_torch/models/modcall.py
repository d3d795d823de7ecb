"""modcall: 5mC methylation / allele-specific methylation calling
(ModCall.cpp, ModCallProcess.cpp, ModCallParsingBam.cpp).

Per chromosome: parse MM/ML base-modification tags during a CIGAR walk
(modified >= modThreshold*255, canonical <= unModThreshold*255, else noise),
compute strand-specific depth from read start/end prefix sums, call per-site
genotypes (merging +/- CpG pairs), then keep heterozygous sites with
confident read connections to nearby SNPs (MethylationGraph) and emit a VCF
with RS=/MR=/NR= INFO and GT:MD:UD:DP.

The port's copy of ``longphase_s_tpu/models/modcall.py``. The object
pipeline below (``MethBamParser``, ``MethylationGraph.add_edge``) stays
host code, as in the JAX package: it serves two or more ``-b`` files and
BAMs the native ingest declines. ``run_modcall`` sends every other
chromosome through ``models/modcall_fast.py``, whose edge counts run on
``cfg.device`` when the engine gate says so. Under ``--dist`` /
``LPS_DIST`` (``parallel/distributed.py``) each process calls its contig
shard on its own card, the result lines are all-gathered and process 0
writes the VCF.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field, replace

from .. import REFERENCE_VERSION
from ..core.alleles import homopolymer_length
from ..io.bam import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CHARD_CLIP,
                      BAM_CINS, BAM_CMATCH, BAM_CPAD, BAM_CREF_SKIP,
                      BAM_CSOFT_CLIP, SEQ_NT16, decode_base_mods)
from ..io import vcf as vcf_io
from ..io.fasta import FastaFile
from ..parallel import distributed as dist
from ..utils import StageTimer
from ..utils.device import resolve_device

# Util.h VariantType enum (MOD=0, SNP=1, INDEL=2, SV=3)
VT_MOD = 0
VT_SNP = 1


@dataclass
class ModCallConfig:
    bam_files: list
    fasta_file: str
    snp_file: str = ""
    result_prefix: str = "modcall_result"
    num_threads: int = 1
    mod_threshold: float = 0.8
    unmod_threshold: float = 0.2
    heter_ratio: float = 0.6
    noise_ratio: float = 0.2
    connect_adjacent: int = 20
    connect_confidence: float = 0.9
    iter_count: int = 2
    output_all_mod: bool = False
    command: str = ""
    checkpoint_dir: str = ""  # per-contig resume (SURVEY §5; ours-only)
    dist: str = ""  # "host:port,nprocs,pid" multi-process spec
    device: str = "cuda"  # where the edge counts run: cuda, cuda:N, cpu


@dataclass
class MethPosInfo:
    methreadcnt: int = 0
    noisereadcnt: int = 0
    canonreadcnt: int = 0
    depth: int = 0
    heterstatus: str = ""
    strand: int = -1
    variant_type: int = VT_MOD
    mod_reads: list = field(default_factory=list)
    nonmod_reads: list = field(default_factory=list)


@dataclass
class ModRead:
    name: str
    is_reverse: bool
    # (pos, allele, qual, vtype)
    variants: list = field(default_factory=list)


class MethBamParser:
    """MethBamParser (ModCallParsingBam.cpp:36-429)."""

    def __init__(self, cfg: ModCallConfig, positions, infos, ref_string):
        self.cfg = cfg
        self.positions = positions    # het SNP positions (may be empty)
        self.infos = infos
        self.ref_string = ref_string
        self.chr_meth: dict[int, MethPosInfo] = {}
        self.read_start_end: dict[int, list[int]] = {}
        self.first_idx = 0

    def detect(self, bam_path, chrom, chrom_len, reads_out, fasta=None):
        tmp_first = self.first_idx
        from ..io.cram import open_alignment
        bam = open_alignment(bam_path, fasta)
        try:
            if chrom not in bam.ref_id:
                return
            self.first_idx = tmp_first
            for rec in bam.fetch(chrom, 0, chrom_len):
                flag = rec.flag
                if (rec.mapq < 1 or flag & 0x4 or flag & 0x100
                        or flag & 0x400 or flag & 0x800):
                    continue
                self.parse_cigar(rec, reads_out)
        finally:
            bam.close()

    def parse_cigar(self, rec, reads_out):
        mods = decode_base_mods(rec, "m")
        if not mods:
            return
        mi = 0
        pos_q, qual_m = mods[0]

        read = ModRead(rec.qname, rec.is_reverse)
        refstart = rec.pos
        refpos = refstart + 1 if rec.is_reverse else refstart
        ref_pos = rec.pos
        querypos = 0
        seq = rec.seq_nibbles()
        quals = rec.qual()
        cigars = rec.cigar_tuples()
        n_cigar = len(cigars)

        positions = self.positions
        n = len(positions)
        while self.first_idx < n and positions[self.first_idx] < ref_pos:
            self.first_idx += 1
        vi = self.first_idx

        mod_hi = self.cfg.mod_threshold * 255
        mod_lo = self.cfg.unmod_threshold * 255
        cm = self.chr_meth

        for ci, (op, length) in enumerate(cigars):
            if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
                while vi < n and positions[vi] < ref_pos + length:
                    vpos = positions[vi]
                    if vpos >= ref_pos:
                        info = self.infos[vi]
                        ref_len = len(info.ref)
                        alt_len = len(info.alt)
                        offset = vpos - ref_pos
                        base_q = 0
                        allele = -1
                        if querypos + offset + 1 > rec.l_seq:
                            return
                        if ref_len == 1 and alt_len == 1:
                            base = SEQ_NT16[seq[querypos + offset]]
                            if base == info.ref[0]:
                                allele = 0
                            elif base == info.alt[0]:
                                allele = 1
                            base_q = int(quals[querypos + offset])
                        if ref_len == 1 and alt_len != 1 and ci + 1 < n_cigar:
                            allele = 1 if (ref_pos + length - 1 == vpos
                                           and cigars[ci + 1][0] == BAM_CINS) else 0
                            base_q = -5 if info.is_danger else -4
                        if ref_len != 1 and alt_len == 1 and ci + 1 < n_cigar:
                            allele = 1 if (ref_pos + length - 1 == vpos
                                           and cigars[ci + 1][0] == BAM_CDEL) else 0
                            base_q = -5 if info.is_danger else -4
                        if allele != -1:
                            read.variants.append((vpos, allele, base_q, VT_SNP))
                            cm.setdefault(vpos, MethPosInfo()).variant_type = VT_SNP
                    vi += 1
                # methylation events inside this M op
                while True:
                    if mi >= len(mods) or mods[mi][0] > querypos + length:
                        break
                    pos_q, qual_m = mods[mi]
                    if rec.is_reverse:
                        methrpos = pos_q - querypos + refpos - 1
                    else:
                        methrpos = pos_q - querypos + refpos
                    if len(self.ref_string) < methrpos:
                        break
                    entry = cm.get(methrpos)
                    if entry is None or entry.variant_type == VT_MOD:
                        if entry is None:
                            entry = cm.setdefault(methrpos, MethPosInfo())
                        if qual_m >= mod_hi:
                            entry.methreadcnt += 1
                            entry.variant_type = VT_MOD
                            entry.strand = 1 if rec.is_reverse else 0
                            entry.mod_reads.append(rec.qname)
                            read.variants.append((methrpos, 0, 60, VT_MOD))
                        elif qual_m <= mod_lo:
                            entry.canonreadcnt += 1
                            entry.nonmod_reads.append(rec.qname)
                            read.variants.append((methrpos, 1, 60, VT_MOD))
                        else:
                            entry.noisereadcnt += 1
                    mi += 1
                querypos += length
                refpos += length
                ref_pos += length
            elif op == BAM_CINS:
                while mi < len(mods) and mods[mi][0] <= querypos + length:
                    mi += 1
                querypos += length
            elif op == BAM_CDEL:
                if self.ref_string != "":
                    vpos = positions[vi] if vi < n else None
                    if vpos is not None and ref_pos + length + 1 == vpos:
                        pass
                    elif vpos is not None and ref_pos <= vpos < ref_pos + length:
                        if homopolymer_length(vpos, self.ref_string) >= 3:
                            info = self.infos[vi]
                            ref_len = len(info.ref)
                            alt_len = len(info.alt)
                            base_q = 0
                            if querypos + 1 > rec.l_seq:
                                return
                            allele = -1
                            if ref_len == 1 and alt_len == 1:
                                base = SEQ_NT16[seq[querypos]]
                                if base == info.ref[0]:
                                    allele = 0
                                elif base == info.alt[0]:
                                    allele = 1
                                base_q = int(quals[querypos])
                            elif ref_len != 1 and alt_len == 1:
                                allele = 1
                                base_q = -4
                            if allele != -1:
                                read.variants.append((vpos, allele, base_q, VT_SNP))
                                cm.setdefault(vpos, MethPosInfo()).variant_type = VT_SNP
                                vi += 1
                refpos += length
                ref_pos += length
            elif op == BAM_CREF_SKIP:
                refpos += length
                ref_pos += length
            elif op == BAM_CSOFT_CLIP:
                while mi < len(mods) and mods[mi][0] <= querypos + length:
                    mi += 1
                querypos += length
            elif op in (BAM_CHARD_CLIP, BAM_CPAD):
                # reference quirk: hard clip/pad advance the mod-mapping refpos
                refpos += length

        refend = refpos if rec.is_reverse else refpos + 1
        side = 1 if rec.is_reverse else 0
        self.read_start_end.setdefault(refstart + 1, [0, 0])[side] += 1
        self.read_start_end.setdefault(refend, [0, 0])[side] -= 1

        if read.variants:
            read.variants.sort(key=lambda v: v[0])
            reads_out.append(read)

    def calculate_depth(self):
        """calculateDepth (ModCallParsingBam.cpp:735-767)."""
        meth_positions = sorted(self.chr_meth)
        se = sorted(self.read_start_end.items())
        cur_f = 0
        cur_r = 0
        mi = 0
        for k in range(len(se)):
            if mi >= len(meth_positions):
                break
            if k + 1 >= len(se):
                break
            pos_k, counts = se[k]
            cur_f += counts[0]
            cur_r += counts[1]
            next_pos = se[k + 1][0]
            while mi < len(meth_positions) and \
                    pos_k <= meth_positions[mi] < next_pos:
                info = self.chr_meth[meth_positions[mi]]
                if info.strand == 0:
                    info.depth = cur_f
                elif info.strand == 1:
                    info.depth = cur_r
                mi += 1
        self.read_start_end.clear()

    def judge_genotype(self, reads, mod_reads_out):
        """judgeMethGenotype (ModCallParsingBam.cpp:625-733)."""
        cfg = self.cfg
        for info in self.chr_meth.values():
            meth = float(info.methreadcnt)
            nonmeth = float(info.canonreadcnt)
            depth = float(info.depth)
            noise = depth - meth - nonmeth
            if meth < 0 or nonmeth < 0:
                continue
            if max(meth, nonmeth) == 0:
                continue
            heter = min(meth, nonmeth) / max(meth, nonmeth)
            noise_ratio = noise / depth if depth else float("inf")
            if heter >= cfg.heter_ratio and noise_ratio <= cfg.noise_ratio:
                info.heterstatus = "0/1"
            elif meth >= nonmeth:
                info.heterstatus = "1/1"
            else:
                info.heterstatus = "0/0"

        position_pairs = set()
        for pos in sorted(self.chr_meth):
            info = self.chr_meth[pos]
            if info.strand == 0 and info.variant_type == VT_MOD:
                nxt = self.chr_meth.get(pos + 1)
                if nxt is not None and nxt.strand == 1 and nxt.variant_type == VT_MOD:
                    t_meth = float(info.methreadcnt + nxt.methreadcnt)
                    t_non = float(info.canonreadcnt + nxt.canonreadcnt)
                    t_depth = float(info.depth + nxt.depth)
                    t_noise = t_depth - t_meth - t_non
                    if max(t_meth, t_non) == 0:
                        continue
                    heter = min(t_meth, t_non) / max(t_meth, t_non)
                    noise_ratio = t_noise / t_depth if t_depth else float("inf")
                    if heter >= cfg.heter_ratio and noise_ratio <= cfg.noise_ratio:
                        status = "0/1"
                        position_pairs.add(pos)
                    elif t_meth >= t_non:
                        status = "1/1"
                    else:
                        status = "0/0"
                    info.heterstatus = status
                    nxt.heterstatus = status

        for read in reads:
            new = ModRead(read.name, read.is_reverse)
            for (pos, allele, qual, vtype) in read.variants:
                if vtype == VT_MOD:
                    strand = self.chr_meth[pos].strand
                    if strand == 0:
                        if pos in position_pairs:
                            new.variants.append((pos, allele, qual, VT_MOD))
                    elif strand == 1:
                        if pos - 1 in position_pairs:
                            new.variants.append((pos - 1, allele, qual, VT_MOD))
                else:
                    new.variants.append((pos, allele, qual, vtype))
            if new.variants:
                mod_reads_out.append(new)

    def export_result(self, chrom, chr_seq, chr_len, pass_positions, out):
        export_result(self.cfg, self.chr_meth, chrom, chr_seq, chr_len,
                      pass_positions, out)


def export_result(cfg, chr_meth, chrom, chr_seq, chr_len, pass_positions,
                  out):
    """exportResult (ModCallParsingBam.cpp:431-593)."""

    def write_pos(pos):
        info = chr_meth.get(pos)
        if info is None:
            return False
        if chr_len < pos:
            return None  # 'continue' semantics
        ref = chr_seq[pos:pos + 1]
        if ref.upper() not in ("A", "T", "C", "G"):
            return None
        if info.strand == 1:
            strandinfo = "RS=N;"
        elif info.strand == 0:
            strandinfo = "RS=P;"
        else:
            return None
        infostr = ""
        if info.mod_reads:
            infostr += "MR=" + ",".join(info.mod_reads) + ";"
        if info.nonmod_reads:
            infostr += "NR=" + ",".join(info.nonmod_reads) + ";"
        if cfg.output_all_mod or info.heterstatus == "0/1":
            sample = (f"{info.heterstatus}:{info.methreadcnt}:"
                      f"{info.canonreadcnt}:{info.depth}")
            out.append(f"{chrom}\t{pos + 1}\t.\t{ref}\tN\t.\tPASS\t"
                       f"{strandinfo}{infostr}\tGT:MD:UD:DP\t{sample}\n")
        return True

    if cfg.output_all_mod:
        for pos in sorted(chr_meth):
            r = write_pos(pos)
            if r is None:
                return  # reference 'return' on abnormal pos in all-mode
    else:
        processed = set()
        for pos in pass_positions:
            if pos in processed:
                continue
            if pos in chr_meth:
                if write_pos(pos) is None:
                    continue  # abnormal pos: reference skips the insert too
            processed.add(pos)
            nxt = pos + 1
            if nxt in chr_meth and nxt not in processed:
                if write_pos(nxt) is None:
                    continue
                processed.add(nxt)


# ---------------------------------------------------------------------------
# MethylationGraph (ModCallParsingBam.cpp:769-1092)
# ---------------------------------------------------------------------------

class MethylationGraph:
    def __init__(self, cfg: ModCallConfig):
        self.cfg = cfg
        # pos -> {read_name: vtype}
        self.node_info: dict[int, dict[str, int]] = {}
        # (pos1, allele0/1) -> {pos2: [ref_count, alt_count]}
        self.edges: dict[tuple[int, int], dict[int, list]] = {}

    def add_edge(self, reads):
        for read in reads:
            for (pos, _a, _q, vtype) in read.variants:
                self.node_info.setdefault(pos, {})[read.name] = vtype
            nv = len(read.variants)
            for i in range(nv):
                p1, a1, _q1, t1 = read.variants[i]
                for j in range(i + 1, min(nv, i + 1 + 50)):
                    p2, a2, _q2, t2 = read.variants[j]
                    if t1 == VT_SNP and t2 == VT_SNP:
                        continue
                    if a1 in (0, 1):
                        cell = self.edges.setdefault((p1, a1), {}).setdefault(
                            p2, [0, 0])
                        if a2 in (0, 1):
                            cell[a2] += 1

    def _number_of_reads(self, p1, p2):
        """VariantEdge::findNumberOfRead — (rr+aa, ra+ar)."""
        rc = self.edges.get((p1, 0), {}).get(p2, (0, 0))
        ac = self.edges.get((p1, 1), {}).get(p2, (0, 0))
        return rc[0] + ac[1], rc[1] + ac[0]

    def _vtype(self, pos):
        node = self.node_info.get(pos)
        if node:
            for t in node.values():
                return t
        return -1

    def connect_results(self, pass_positions, has_snp_data):
        """connectResults (ModCallParsingBam.cpp:825-1068)."""
        cfg = self.cfg
        strong = set()
        weak = set()
        weak2 = set()
        added = set()
        added2 = set()
        prepass = []
        has_connect = set()
        keys = sorted(self.node_info)
        n = len(keys)

        if not has_snp_data:
            for pos in keys:
                if self._vtype(pos) == VT_MOD:
                    strong.add(pos)
        else:
            for i in range(n):
                cur = keys[i]
                if i + 1 >= n:
                    break
                if (cur, 0) not in self.edges and (cur, 1) not in self.edges:
                    continue
                cur_type = self._vtype(cur)
                if cur_type == VT_MOD:
                    sc = 0
                    j = i + 1
                    while j < n and sc < cfg.connect_adjacent:
                        para, cross = self._number_of_reads(cur, keys[j])
                        total = para + cross
                        min_conn = max((len(self.node_info[cur])
                                        + len(self.node_info[keys[j]])) / 4.0, 6.0)
                        if total <= min_conn:
                            break
                        if self._vtype(keys[j]) == VT_SNP:
                            ratio = max(para, cross) / total
                            has_connect.add(cur)
                            if ratio >= cfg.connect_confidence and \
                                    total > min_conn and cur not in strong:
                                strong.add(cur)
                                break
                        j += 1
                        sc += 1
                    if cur not in has_connect:
                        weak.add(cur)
                elif cur_type == VT_SNP:
                    prepass.append(cur)
                    j = i + 1
                    while j < n:
                        para, cross = self._number_of_reads(cur, keys[j])
                        total = para + cross
                        min_conn = max((len(self.node_info[cur])
                                        + len(self.node_info[keys[j]])) / 4.0, 6.0)
                        if total <= min_conn:
                            break
                        if self._vtype(keys[j]) == VT_MOD:
                            ratio = max(para, cross) / total
                            has_connect.add(keys[j])
                            if ratio >= cfg.connect_confidence and \
                                    total > min_conn and keys[i + 1] not in strong:
                                strong.add(keys[i + 1])
                        j += 1

        # second pass: connections between strong points
        strong_sorted = sorted(strong)
        for i1, pos1 in enumerate(strong_sorted):
            if (pos1, 0) not in self.edges and (pos1, 1) not in self.edges:
                continue
            sc = 0
            for pos2 in strong_sorted[i1 + 1:]:
                if sc >= cfg.connect_adjacent:
                    break
                para, cross = self._number_of_reads(pos1, pos2)
                total = para + cross
                min_conn = max((len(self.node_info[pos1])
                                + len(self.node_info[pos2])) / 4.0, 6.0)
                if total <= min_conn:
                    break
                ratio = max(para, cross) / total
                if ratio >= cfg.connect_confidence and total > min_conn:
                    if pos1 not in added:
                        prepass.append(pos1)
                        added.add(pos1)
                        if has_snp_data:
                            weak.add(pos1)
                    if pos2 not in added:
                        prepass.append(pos2)
                        added.add(pos2)
                        if has_snp_data:
                            weak.add(pos2)
                sc += 1

        # third pass: iterate over weak points
        for it in range(cfg.iter_count):
            if not has_snp_data:
                continue
            cur_weak = weak if it % 2 == 0 else weak2
            nxt_weak = weak2 if it % 2 == 0 else weak
            cur_added = added if it % 2 == 0 else added2
            nxt_added = added2 if it % 2 == 0 else added
            nxt_weak.clear()
            nxt_added.clear()
            cur_sorted = sorted(cur_weak)
            for i1, cur in enumerate(cur_sorted):
                if (cur, 0) not in self.edges and (cur, 1) not in self.edges:
                    continue
                sc = 0
                is_added = False
                for nxt in cur_sorted[i1 + 1:]:
                    if sc >= cfg.connect_adjacent:
                        break
                    if nxt not in cur_added and cur not in cur_added:
                        sc += 1
                        continue
                    is_added = True
                    para, cross = self._number_of_reads(cur, nxt)
                    total = para + cross
                    min_conn = max((len(self.node_info[cur])
                                    + len(self.node_info[nxt])) / 4.0, 6.0)
                    if total <= min_conn:
                        break
                    ratio = max(para, cross) / total
                    if ratio >= cfg.connect_confidence and total > min_conn:
                        if cur not in prepass:
                            prepass.append(cur)
                            nxt_weak.add(cur)
                            nxt_added.add(cur)
                        if nxt not in prepass:
                            prepass.append(nxt)
                            nxt_weak.add(nxt)
                            nxt_added.add(nxt)
                    sc += 1
                if not is_added:
                    nxt_weak.add(cur)

        prepass.sort()
        # fourth pass: require good connections to both neighbors
        out = []
        for i, pos in enumerate(prepass):
            if pos in self.node_info and self._vtype(pos) == VT_SNP:
                continue
            good_prev = False
            good_next = False
            if i > 0:
                prev = prepass[i - 1]
                if (prev, 0) not in self.edges and (prev, 1) not in self.edges:
                    good_prev = True
                    continue
                para, cross = self._number_of_reads(prev, pos)
                total = para + cross
                if total != 0:
                    ratio = max(para, cross) / total
                    if ratio >= cfg.connect_confidence and total >= 6:
                        good_prev = True
            if i < len(prepass) - 1 and good_prev:
                nxt = prepass[i + 1]
                if (pos, 0) not in self.edges and (pos, 1) not in self.edges:
                    # reference 'continue' skips the final add despite the flag
                    continue
                para, cross = self._number_of_reads(pos, nxt)
                total = para + cross
                if total != 0:
                    ratio = max(para, cross) / total
                    if ratio >= cfg.connect_confidence and total >= 6:
                        good_next = True
            if good_next or i == 0 or i == len(prepass) - 1:
                pass_positions.append(pos)
        return pass_positions


def run_modcall(cfg: ModCallConfig):
    """JAX models/modcall.py:602-694, on ``cfg.device`` (resolved first: a
    CUDA device that is not there raises), or under a process group on the
    process's own card for its contig shard."""
    dist.init_from_spec(cfg.dist)
    dist.maybe_init_from_env()
    cfg = replace(cfg, device=str(resolve_device(
        dist.local_device(cfg.device))))
    timer = StageTimer()
    with timer("parsing VCF"):
        het = (vcf_io.read_het_variants(cfg.snp_file)
               if cfg.snp_file else vcf_io.HetVariantSet())
        has_snp = bool(cfg.snp_file)

    with timer("reading reference"):
        fasta = FastaFile(cfg.fasta_file)

    results: dict[str, list] = {}
    chrs = [(name, fasta.length(name)) for name in fasta.references]
    mine = set(dist.shard_contigs([name for name, _len in chrs]))
    ckpt = None
    if cfg.checkpoint_dir:
        from ..utils.checkpoint import LinesCheckpoint, modcall_fingerprint
        ckpt = LinesCheckpoint(cfg.checkpoint_dir, modcall_fingerprint(cfg))
        results.update(ckpt.load())
    with timer("modcall"):
        for chrom, chrom_len in chrs:
            if chrom not in mine:
                continue
            if chrom in results:  # checkpointed contig: reuse its lines
                print(f"({chrom}*)", end="", file=sys.stderr)
                continue
            chr_seq = fasta.fetch(chrom, 0, chrom_len + 2)
            variants = het.by_chrom.get(chrom, {})
            if has_snp and variants:
                vcf_io.mark_danger_indels(variants, chr_seq)
            positions = sorted(variants) if has_snp else []
            infos = [variants[p] for p in positions]
            from .modcall_fast import run_chrom_fast
            out_fast: list[str] = []
            if run_chrom_fast(cfg, chrom, chrom_len, chr_seq, positions,
                              infos, has_snp, out_fast):
                results[chrom] = out_fast
                if ckpt is not None:
                    ckpt.save(chrom, out_fast)
                print(f"({chrom})", end="", file=sys.stderr)
                continue
            parser = MethBamParser(cfg, positions, infos, chr_seq)
            reads: list[ModRead] = []
            for bam_path in cfg.bam_files:
                parser.first_idx = 0
                parser.detect(bam_path, chrom, chrom_len, reads,
                              fasta=fasta)
            parser.calculate_depth()
            mod_reads: list[ModRead] = []
            parser.judge_genotype(reads, mod_reads)
            graph = MethylationGraph(cfg)
            graph.add_edge(mod_reads)
            pass_positions: list[int] = []
            graph.connect_results(pass_positions, has_snp)
            out: list[str] = []
            parser.export_result(chrom, chr_seq, chrom_len, pass_positions, out)
            results[chrom] = out
            if ckpt is not None:
                ckpt.save(chrom, out)
            print(f"({chrom})", end="", file=sys.stderr)
        print("", file=sys.stderr)

    if dist.is_active():
        with timer("allgather shard results"):
            merged: dict[str, list] = {}
            for blob in dist.allgather_bytes(json.dumps(results).encode()):
                merged.update(json.loads(blob))
            results = merged
        if not dist.is_writer():
            return results

    with timer("write vcf"):
        with open(cfg.result_prefix + ".vcf", "a") as f:
            f.write("##fileformat=VCFv4.2\n")
            f.write('##INFO=<ID=RS,Number=.,Type=String,Description="Read Strand">\n')
            f.write('##INFO=<ID=MR,Number=.,Type=String,Description="Read Name of Modified position">\n')
            f.write('##INFO=<ID=NR,Number=.,Type=String,Description="Read Name of nonModified position">\n')
            f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
            f.write('##FORMAT=<ID=MD,Number=1,Type=Integer,Description="Modified Depth">\n')
            f.write('##FORMAT=<ID=UD,Number=1,Type=Integer,Description="Unmodified Depth">\n')
            f.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">\n')
            for chrom, length in chrs:
                f.write(f"##contig=<ID={chrom},length={length}>\n")
            f.write(f"##longphaseVersion={REFERENCE_VERSION}\n")
            f.write(f"##commandline=\"{cfg.command}\"\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
            for chrom, _length in chrs:
                f.writelines(results.get(chrom, []))
