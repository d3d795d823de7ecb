"""Vectorized germline haplotag fast path (reference:
HaplotagStrategy.cpp:20-300) with the judge reductions on a torch device.

The port's copy of ``longphase_s_tpu/models/haplotag_fast.py``. The native
whole-BAM walk (``native.NativeBam.tag_walk``) emits flat (alignment,
variant) observation arrays; the judge semantics of
``GermlineHaplotagStrategy`` run either as the numpy host judge below
(``germline_votes`` + ``aggregate_reads``) or as
``ops/tag_kernels.germline_counts`` on a torch device, as the engine gate
says; the native parallel BGZF writer writes the tagged BAM. Produces
record-identical output to ``models/haplotag.run_haplotag``'s object path.
Under an active process group (``parallel/distributed.py``) each process
walks and judges its contig shard, the tag segments are all-gathered
(``_gather_int_segments``) and process 0 writes the BAM.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import REFERENCE_VERSION, native
from ..io.bam import region_bounds
from ..io.cram import is_cram, open_alignment
from ..io.fasta import FastaFile
from ..io.phased_vcf import (NORMAL, PHASED_HETERO, PhasedVcfReader,
                             VT_DELETION, VT_INSERTION, VT_SNP, VcfInfo)
from ..ops import tag_kernels
from ..parallel import distributed as dist
from ..utils import StageTimer
from .haplotag import ReadStatistics


def build_variant_tables(positions, variants, genome=NORMAL):
    """Flat per-variant lookup tables for the vectorized judges."""
    n = len(positions)
    t = {
        "pos": np.asarray(positions, dtype=np.int64),
        "has": np.zeros(n, bool),
        "vtype": np.zeros(n, np.int8),
        "gt": np.full(n, -1, np.int8),
        "ps": np.full(n, -1, np.int64),
        "snp_ref": np.zeros(n, np.uint8),
        "snp_alt": np.zeros(n, np.uint8),
        "hp1c": np.zeros(n, np.uint8),
        "hp2c": np.zeros(n, np.uint8),
        "hp1_long": np.zeros(n, bool),
        "hp2_long": np.zeros(n, bool),
    }
    for i, p in enumerate(positions):
        v = variants[p].get(genome)
        if v is None:
            continue
        t["has"][i] = True
        t["vtype"][i] = v.variant_type
        t["gt"][i] = v.gt
        t["ps"][i] = v.phased_set
        if v.ref:
            t["snp_ref"][i] = ord(v.ref[0])
        if v.alt:
            t["snp_alt"][i] = ord(v.alt[0])
        # base-vs-haplotype compares only ever succeed for 1-char HP strings
        if len(v.hp1) == 1:
            t["hp1c"][i] = ord(v.hp1)
        if len(v.hp2) == 1:
            t["hp2c"][i] = ord(v.hp2)
        t["hp1_long"][i] = len(v.hp1) != 1
        t["hp2_long"][i] = len(v.hp2) != 1
    return t


def germline_votes(walk, t, ref_string_nonempty: bool):
    """Per-observation HP votes + PS-count mask.

    Vectorizes judgeSnpHap (HaplotagStrategy.cpp:20-130) over match
    observations and judgeDeletionHap (:147-209) over in-deletion
    observations (with the caller's one-judgement-per-deletion-op rule,
    HaplotagProcess.cpp:388-400).

    Returns (h1, h2, cps) boolean masks over the observation axis.
    """
    vi = walk["obs_var"]
    al = walk["obs_aln"]
    base = walk["obs_base"]
    fl = walk["obs_flags"]
    kind = walk["obs_kind"]

    vt = t["vtype"][vi]
    norm = t["has"][vi]
    kind0 = kind == 0

    m_snp = kind0 & norm & (vt == VT_SNP) & \
        ((base == t["snp_ref"][vi]) | (base == t["snp_alt"][vi]))
    if np.any(m_snp & (t["ps"][vi] < 0)):
        bad = np.flatnonzero(m_snp & (t["ps"][vi] < 0))[0]
        print("[ERROR] (judgeSnpHap) => can't find the position: pos: "
              f"{t['pos'][vi[bad]]}", file=sys.stderr)
        sys.exit(0)
    h1 = m_snp & (base == t["hp1c"][vi])
    h2 = m_snp & (base == t["hp2c"][vi])
    cps = m_snp.copy()

    has_next = (fl & 1) != 0
    alt_ins = (fl & 2) != 0
    alt_del = (fl & 4) != 0
    only1 = t["hp1_long"][vi] & ~t["hp2_long"][vi]
    only2 = ~t["hp1_long"][vi] & t["hp2_long"][vi]

    m_ins = kind0 & norm & (vt == VT_INSERTION) & has_next
    h1 |= m_ins & ((alt_ins & only1) | (~alt_ins & only2))
    h2 |= m_ins & ((alt_ins & only2) | (~alt_ins & only1))
    cps |= m_ins

    m_del = kind0 & norm & (vt == VT_DELETION) & has_next
    h1 |= m_del & ((alt_del & only1) | (~alt_del & only2))
    h2 |= m_del & ((alt_del & only2) | (~alt_del & only1))
    cps |= m_del

    # judgeDeletionHap: first phased-het variant covered by each D op
    if ref_string_nonempty:
        cand = (kind == 1) & norm & (t["gt"][vi] == PHASED_HETERO)
        if np.any(cand):
            idx = np.flatnonzero(cand)
            aux = walk["obs_aux"][idx].astype(np.int64)
            group = al[idx].astype(np.int64) * (aux.max() + 1) + aux
            _, first = np.unique(group, return_index=True)
            sel = idx[first]
            sel = sel[(fl[sel] & 8) != 0]  # homopolymerLength >= 3
            svt = vt[sel]
            snp = sel[svt == VT_SNP]
            h1[snp[base[snp] == t["hp1c"][vi[snp]]]] = True
            h2[snp[base[snp] == t["hp2c"][vi[snp]]]] = True
            cps[snp] = True
            dele = sel[svt == VT_DELETION]
            h1[dele[only1[dele]]] = True
            h2[dele[only2[dele]]] = True
            cps[dele] = True
    return h1, h2, cps


def aggregate_reads(walk, t, h1, h2, cps, sv_counts=None):
    """Per-alignment HP1/HP2 counts, distinct-PS count and min PS
    (the countPS map of judgeSnpHap / judgeReadHap)."""
    al = walk["obs_aln"]
    A = len(walk["category"])
    h1_cnt = np.bincount(al[h1], minlength=A).astype(np.int64)
    h2_cnt = np.bincount(al[h2], minlength=A).astype(np.int64)

    n_ps = np.zeros(A, np.int64)
    min_ps = np.zeros(A, np.int64)
    cidx = np.flatnonzero(cps)
    if len(cidx):
        psv = t["ps"][walk["obs_var"][cidx]]
        aln_ps = al[cidx].astype(np.int64)
        stride = psv.max() + 1
        uk = np.unique(aln_ps * stride + psv)
        u_aln = uk // stride
        n_ps = np.bincount(u_aln, minlength=A).astype(np.int64)
        ua, ufirst = np.unique(u_aln, return_index=True)
        min_ps[ua] = uk[ufirst] % stride

    if sv_counts:
        names = walk["names"]
        off = walk["name_off"]
        proc = np.flatnonzero(walk["category"] == 0)
        for a in proc:
            entry = sv_counts.get(names[off[a]:off[a + 1]])
            if entry is not None:
                h1_cnt[a] += entry[0]
                h2_cnt[a] += entry[1]
    return h1_cnt, h2_cnt, n_ps, min_ps


def judge_reads(h1_cnt, h2_cnt, n_ps, percentage_threshold):
    """Vectorized judgeReadHap (HaplotagStrategy.cpp:243-300).

    Returns (hp, pq, n_high_similarity, n_without_variant).
    """
    A = len(h1_cnt)
    mx = np.maximum(h1_cnt, h2_cnt).astype(np.float64)
    mn = np.minimum(h1_cnt, h2_cnt).astype(np.float64)
    total = mx + mn
    ratio = np.divide(mx, total, out=np.full(A, np.nan), where=total > 0)

    hp = np.full(A, -1, np.int32)
    ok = ~(ratio < percentage_threshold)  # NaN falls through like C++
    hp[ok & (h1_cnt > h2_cnt)] = 1
    hp[ok & (h1_cnt < h2_cnt)] = 2
    n_high_sim = int(np.count_nonzero(ratio < percentage_threshold))

    pq = np.zeros(A, np.int32)
    full = (mx > 0) & (mn == 0)
    pq[full] = 40
    part = mn > 0
    pq[part] = (-10 * np.log10(mn[part] / total[part])).astype(np.int32)
    n_without = int(np.count_nonzero(mx == 0))

    hp[n_ps > 1] = -1
    return hp, pq, n_high_sim, n_without


def _gather_int_segments(segs, all_rec, all_mode, all_hp, all_ps, all_pq,
                         stats):
    """The multi-process merge of tag segments (JAX haplotag_fast.py:
    193-232): each process's ``(chr_vec index, records)`` segments and
    their record/mode/HP/PS/PQ arrays go out as one ``.npz`` blob, and
    every process gets them all back in ``chr_vec`` order (record indices
    refer to the shared input BAM). The ``ReadStatistics`` counters are
    summed across processes in place (``psum_counters``). The somatic tag
    pass gathers its segments here too, its HP as the integer class that
    its writer turns into HP:Z."""
    import io

    buf = io.BytesIO()

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros(0, dtype)

    np.savez(buf, segs=np.asarray(segs, np.int64).reshape(-1, 2),
             rec=cat(all_rec, np.int64), mode=cat(all_mode, np.uint8),
             hp=cat(all_hp, np.int32), ps=cat(all_ps, np.int64),
             pq=cat(all_pq, np.int32))
    entries = []
    for blob in dist.allgather_bytes(buf.getvalue()):
        z = np.load(io.BytesIO(blob))
        off = 0
        for ci, n in z["segs"].reshape(-1, 2):
            sl = slice(off, off + int(n))
            entries.append((int(ci), z["rec"][sl], z["mode"][sl],
                            z["hp"][sl], z["ps"][sl], z["pq"][sl]))
            off += int(n)
    entries.sort(key=lambda e: e[0])
    counters = {f.name: getattr(stats, f.name)
                for f in stats.__dataclass_fields__.values()
                if f.name != "hp_count"}
    counters.update({f"hp_{k}": v for k, v in stats.hp_count.items()})
    for k, v in dist.psum_counters(counters).items():
        if k.startswith("hp_"):
            stats.hp_count[int(k[3:])] = v
        else:
            setattr(stats, k, v)
    return tuple([e[i] for e in entries] for i in range(1, 6))


def _add_sv_counts(walk, h1_cnt, h2_cnt, sv_counts, aln_mask=None):
    """Host-side SV/MOD per-read vote add (judgeSVHap,
    HaplotagStrategy.cpp:220-226): keyed by read name, so it stays off
    device. Mutates h1_cnt/h2_cnt in place."""
    names = walk["names"]
    off = walk["name_off"]
    proc = np.flatnonzero((walk["category"] == 0) if aln_mask is None
                          else aln_mask)
    for a in proc:
        entry = sv_counts.get(names[off[a]:off[a + 1]])
        if entry is not None:
            h1_cnt[a] += entry[0]
            h2_cnt[a] += entry[1]


def _judge_walk(cfg, walk, t, ref_string, sv_counts, stats, device):
    """Judge one walk batch (a chromosome, or one streaming window of it):
    returns (mode, hp, min_ps, pq) per record and accumulates the
    ReadStatistics counters. Copy of JAX haplotag_fast.py:249-305: the
    device engine runs ``tag_kernels.germline_counts`` on ``device`` and a
    device error raises; the host engine is the numpy judge above."""
    if tag_kernels.engine(len(walk["obs_var"])) == "device":
        h1_cnt, h2_cnt, n_ps, min_ps = tag_kernels.germline_counts(
            walk, t, bool(ref_string), device=device)
        if sv_counts:
            _add_sv_counts(walk, h1_cnt, h2_cnt, sv_counts)
    else:
        h1, h2, cps = germline_votes(walk, t, bool(ref_string))
        h1_cnt, h2_cnt, n_ps, min_ps = aggregate_reads(
            walk, t, h1, h2, cps, sv_counts if sv_counts else None)
    hp, pq, n_high_sim, n_without = judge_reads(
        h1_cnt, h2_cnt, n_ps, cfg.percentage_threshold)

    cat = walk["category"]
    flag = walk["flag"]
    A = len(cat)
    stats.total_alignment += A
    cat_counts = np.bincount(cat, minlength=7)
    stats.total_lower_quality += int(cat_counts[1])
    stats.total_unmapped += int(cat_counts[2])
    stats.total_secondary += int(cat_counts[3])
    stats.total_supplementary += int(cat_counts[4])
    stats.total_empty_variant += int(cat_counts[5])
    stats.total_other_case += int(cat_counts[6])
    proc = cat == 0
    stats.total_supplementary += int(
        np.count_nonzero(proc & ((flag & 0x800) != 0)))
    stats.total_high_similarity += n_high_sim
    stats.total_without_variant += n_without
    tagged = proc & (hp != -1)
    n_tag = int(np.count_nonzero(tagged))
    stats.total_tag_count += n_tag
    stats.total_untag_count += A - n_tag
    n_hp1 = int(np.count_nonzero(tagged & (hp == 1)))
    stats.hp_count[1] = stats.hp_count.get(1, 0) + n_hp1
    stats.hp_count[2] = stats.hp_count.get(2, 0) + (n_tag - n_hp1)
    n_untag_proc = int(np.count_nonzero(proc)) - n_tag
    stats.hp_count[-1] = stats.hp_count.get(-1, 0) + n_untag_proc

    mode = np.zeros(A, np.uint8)
    mode[proc] = 1
    mode[tagged] = 2
    return mode, hp, min_ps, pq


def run_haplotag_fast(cfg, device):
    """Native+vectorized run_haplotag (copy of JAX haplotag_fast.py:308-463).
    Returns ReadStatistics, or None when the configuration requires the
    object path (read log, CRAM out without a native handle). Under an
    active process group it runs or raises: the object path has no
    shard."""
    sharded = dist.is_active()
    if cfg.write_read_log:
        if sharded:
            raise RuntimeError("--dist does not support --log")
        return None
    if os.environ.get("LPS_NO_NATIVE_TAG"):
        if sharded:
            raise RuntimeError("--dist requires the native runtime")
        return None

    # whole-file handle first: one parallel container decode serves both the
    # tag walk and the writer. The container-streaming handle re-decodes
    # every container during the write replay, so it is reserved for inputs
    # past the RAM budget (where bounded memory is worth the second decode).
    # streaming handles re-number records by window, and the sharded
    # gather needs whole-file record indices: not under a group
    nb = native.open_native_bam(cfg.bam_file, cfg.fasta_file)
    if (nb is None and is_cram(cfg.bam_file) and not sharded
            and not cfg.output_cram and native.available()):
        try:
            nb = native.CramStreamingBam(cfg.bam_file, cfg.fasta_file)
        except Exception:  # noqa: BLE001 — e.g. multi-ref containers
            nb = None
    if nb is None:
        if (not sharded and not cfg.output_cram
                and not is_cram(cfg.bam_file) and native.available()
                and os.path.getsize(cfg.bam_file) > native._inmem_budget()):
            # past the RAM budget: windowed streaming handle, same flow
            nb = native.StreamingBam(cfg.bam_file)
        elif sharded:
            raise RuntimeError("--dist requires the native runtime")
        else:
            return None

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
    hdr_reader = open_alignment(cfg.bam_file)  # header only (BAM or CRAM)
    header = hdr_reader.header_text
    if not header.endswith("\n") and header:
        header += "\n"
    header += (f"@PG\tID:longphase-s\tPN:longphase-s\tVN:{REFERENCE_VERSION}"
               f"\tCL:{cfg.command}\n")
    ref_ids = hdr_reader.ref_id
    hdr_reader.close()
    sv_counts = info.read_sv_hap_count

    all_rec = []
    all_mode = []
    all_hp = []
    all_ps = []
    all_pq = []
    segs: list[tuple[int, int]] = []  # (chr_vec index, records) a contig

    with timer("tag read"):
        for chrom in dist.shard_contigs(chr_vec):
            if chrom not in ref_ids:
                continue
            variants = chr_multi.get(chrom, {})
            positions = sorted(variants)
            last_var = positions[-1] if positions else None
            last_phased = 0
            for p in reversed(positions):
                v = variants[p].get(NORMAL)
                if v is not None and v.has_ps:
                    last_phased = p
                    break
            ref_string = fasta.fetch(chrom, 0, last_phased + 6) \
                if chrom in fasta.index and last_phased else ""
            chrom_len = info.chr_length.get(chrom)
            beg, end = region_bounds(cfg.region, chrom_len) if cfg.region \
                else (0, chrom_len)
            walk = nb.tag_walk(chrom, beg, end, positions, last_var,
                               ref_string, cfg.quality_threshold, True,
                               cfg.tag_supplementary)
            if walk is None:
                continue
            t = build_variant_tables(positions, variants)
            mode, hp, min_ps, pq = _judge_walk(cfg, walk, t, ref_string,
                                               sv_counts, stats, device)
            all_rec.append(walk["rec_idx"])
            all_mode.append(mode)
            all_hp.append(hp)
            all_ps.append(min_ps)
            all_pq.append(pq)
            segs.append((chr_vec.index(chrom), len(walk["rec_idx"])))

    if sharded:
        with timer("allgather tag segments"):
            all_rec, all_mode, all_hp, all_ps, all_pq = _gather_int_segments(
                segs, all_rec, all_mode, all_hp, all_ps, all_pq, stats)
        if not dist.is_writer():
            return stats

    with timer("write CRAM" if cfg.output_cram else "write BAM"):
        writer = nb.tag_write_cram if cfg.output_cram else nb.tag_write
        out_path = cfg.result_prefix + (".cram" if cfg.output_cram
                                        else ".bam")
        if all_rec:
            rec = np.concatenate(all_rec)
            ok = writer(header, rec, np.concatenate(all_mode),
                        np.concatenate(all_hp), np.concatenate(all_ps),
                        np.concatenate(all_pq), [""] * len(rec), out_path)
        else:
            ok = writer(header, np.zeros(0, np.int64),
                        np.zeros(0, np.uint8), np.zeros(0, np.int32),
                        np.zeros(0, np.int64), np.zeros(0, np.int32),
                        [], out_path)
        if not ok:
            raise RuntimeError("native tag write failed")

    print("-------------------------------------------", file=sys.stderr)
    print(f"total alignment           : {stats.total_alignment}", file=sys.stderr)
    print(f"total tagged alignments   : {stats.total_tag_count}", file=sys.stderr)
    print(f"    L----total HP1        : {stats.hp_count.get(1, 0)}", file=sys.stderr)
    print(f"    L----total HP2        : {stats.hp_count.get(2, 0)}", file=sys.stderr)
    print(f"total untagged            : {stats.total_untag_count}", file=sys.stderr)
    return stats
