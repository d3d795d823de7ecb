"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: ``phase``, the tag
family (``haplotag``, ``somatic_haplotag``, ``estimate_purity``) and
``modcall``.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU (sm_90a),
``nvcc`` and ``g++``. It imports nothing of JAX and nothing of the JAX
package ``longphase_s_tpu``, and checks so at the end. Phases, each
printed as it ends:

0. device: the card's name and power limit (``nvidia-smi``); exits
   non-zero at once without CUDA; builds the port's native ingest library
   so the run takes the flat main path;
1. build: compiles the CUDA kernels from ``longphase_s_tpu_torch/csrc``,
   one ``nvcc`` a source, in parallel, and prints what ``ptxas -v`` says
   of each kernel's registers and spills;
2. kernels: each kernel against its plain PyTorch version on the card,
   element for element (exact: the arithmetic is integer plus one fixed
   float32 compare): the vote scan's two kernels (``vote_cast``, the
   pre-pass from the pair sums, and ``vote_scan``, the serial pass) each
   against its own plain version and together against the whole plain
   scan and the CPU, at windows 1, 32, 33, 35, 100, 128, 129 and 200, with
   the times at S = 16384; then the pair stage's three kernels
   (``bucket_count``, ``bucket_scatter``, ``pair_cast``) each against its
   plain version (the buckets as sets), on 30x streams with duplicates,
   padding and shuffled reads, at the same windows and S in 1, 33, 300,
   4096 and 16384, with the times at S = 16384, W = 35 and 100;
3. chromosome scale: ``ops/fused.run_fused_phase`` on a synthetic merged
   stream of 319,951 sites at 20x on ``cuda`` against the same call on
   ``cpu`` (the plain versions): ``ps`` equal, ``ori`` equal on phased
   sites; the step's wall time and peak device memory; the read correction
   on the card (``ops/fused.device_read_correction``, its time, bound and
   peak device memory) equal to the host's float64
   ``host_read_correction_merged``, the stage it replaced, timed beside;
   the serial pass's time beside its time before the carry contract; at
   W = 35 and 100 the pair stage (each launch's time, its peak memory, its pairs and its
   bound) against its plain versions, ``vote_cast``'s codes from the plain
   sums equal to ``pair_cast``'s, and the serial pass against the plain
   scan;
4. end to end: ``cli phase --pb --device cuda`` on a simulated 2 Mbp, 30x
   fixture (the flat path), whose VCF must equal the ``--engine oracle``
   run's; every kernel of the flat path launched, ``vote_cast`` not; the
   same at ``-a 100``; then a 300 kbp fixture on the object path (native
   ingest declined), whose VCF must equal the oracle's and which must
   launch ``vote_cast`` and ``vote_scan`` and no pair kernel;
5. chromosome-scale tag reductions: ``ops/tag_kernels`` on a synthetic walk
   of 128,000 reads of 15 kb over 319,951 germline variants (plus 20,000
   tumour-only variants in the somatic modes), about 9.6M observations:
   each reduction on ``cuda`` equals the same call on ``cpu`` key for key,
   and the numpy host path on every key that path computes
   (all but the ``pk`` bytes and the allele counts); its time
   on the card with and without the transfers and on the host, and its
   bound (its input and output tensors' bytes); then the
   germline and extract reductions at about 10^4..10^7 observations, the
   crossover the engine gate's default comes from;
6. tag pipelines end to end: ``cli haplotag`` on phase 4's fixture, and on
   a simulated 1 Mbp tumour/normal pair (``cli phase`` of the normal
   sample first) ``cli somatic_haplotag --output-somatic-vcf`` and ``cli
   estimate_purity``, each with the device engine on ``cuda`` and with the
   host engine: tags, ``_sc.vcf`` and ``_purity.out`` equal, a purity above
   0, and every device reduction called by the device runs;
7. modcall: ``ops/tag_kernels.modcall_edges`` on a synthetic event stream
   of the 64 Mbp chromosome (128,000 reads of 15 kb, 319,951 het SNPs,
   16,000 het-methylated CpG pairs, about 9.7M events) on ``cuda`` equals
   the numpy host path ``modcall_edges_host``, and the same call on ``cpu``
   on the first 10^6 events; its time on the card with and without the
   transfers and on the host, its bound, its peak device memory, its pairs
   and edges; then the crossover at 10^3..10^6 events against the engine
   gate's; then ``cli modcall`` on a simulated 1 Mbp, 30x methylation
   fixture, with ``-s`` and with ``--all``, on both engines: VCFs equal,
   and the device runs call the edge counts on the card;
8. a genome on one card: synthetic merged streams of GRCh38's chr1-22 and
   X (a het site every 1.5 kb on average, about 2.0M sites; reads of about
   10 sites at 30x, about 58M observations) through
   ``parallel/multichip.run_fused_phase_multichip`` on ``cuda`` at W = 35
   and 100: equal to the per-chromosome ``run_fused_phase`` on ``cuda``
   for every chromosome, and (W = 35) to the CPU on chr19-22; one launch
   of each flat-path kernel for the whole genome; the segmented serial
   pass against its plain version on chr19-22 (chr21-22 at W = 100); the
   batched step's wall against the sum of the per-chromosome walls, the
   segmented serial pass against the sum of the per-chromosome ones (and
   its time before the carry contract), the split of the batched step (the
   ``m_aln`` upload and
   the read correction on the card among its stages) and its peak device
   memory; the correction on the card equal to the host's on every
   chromosome, with both times and its bound; then ``cli
   phase`` with ``LPS_MULTICHIP=1`` on a 5-chromosome fixture (VCF equal
   to the oracle's and the per-chromosome device run's, one launch of each
   kernel) and ``somatic_haplotag`` with ``LPS_MULTICHIP=1`` on a
   3-chromosome tumour/normal fixture (equal to ``LPS_MULTICHIP=0``, every
   reduction in one batched call a pass);
9. the carry contract on the card: chr1's chain of phase 8 cut into 2, 4
   and 8 blocks by ``parallel/sharded_scan.sharded_vote_scan`` on
   ``cuda:0`` (block k from block k-1's carry) equal to the whole scan,
   with times; the four blocks' carry launches against the plain chain on
   the cpu, carries included; the 23-chromosome wavefront
   (``run_fused_phase_wavefront``) over four blocks a chromosome on
   ``cuda:0`` equal to phase 8's batch; ``cli phase`` with
   ``LPS_WAVEFRONT=1`` on phase 8's 5-chromosome fixture equal to the
   oracle's VCF, launching the carry kernel;
10. processes sharing the card (``parallel/distributed.py``: a gloo group
   over 127.0.0.1, every process a fresh interpreter that imports only
   the port, on ``cuda:{pid % count}``): (a) phase 8's genome, written
   once to an ``.npz``, in 2 processes, each running
   ``run_fused_phase_multichip`` on its ``shard_contigs`` and
   ``merge_chr_results`` of the result dicts, the merged dict equal to
   phase 8's batch at W = 35 on every site, with each process's step and
   merge walls and the bytes it gathered; (b) ``cli phase --device cuda
   --dist`` in 1, 2 and 4 processes on phase 8's 5-chromosome fixture, the
   VCF equal to phase 8's, every process that owns a contig launching the
   flat path's kernels, then 2 processes with ``LPS_MULTICHIP=1`` and
   ``--checkpoint`` twice (the second resumes, the VCFs equal); (c) on
   phase 8's 3-chromosome tumour/normal fixture, the device engine on
   ``cuda``: ``haplotag``, ``somatic_haplotag --output-somatic-vcf`` and
   ``estimate_purity`` in 2 processes equal to the one-process device runs
   (tags, ``_sc.vcf``, ``_purity.out`` with a purity above 0), every
   process calling its reductions on the card; (d) ``cli modcall`` in 2
   processes on a 3-chromosome methylation fixture, the VCF equal to the
   one-process run's, every process counting its edges on the card; the
   four 2-process runs of (c) and (d) start at once;
11. the in-process mesh on the card (``parallel/mesh.py``; one card, so
   the "devices" are ``[cuda:0] * k`` and the shares run one after
   another): phase 8's genome through ``run_fused_phase_multichip`` over
   ``[cuda:0] * 2`` and ``* 4`` at W = 35, equal to phase 8's one-device
   batch on every chromosome, one launch of each flat-path kernel a share;
   each share's stages timed (packing, uploads, pair stage, serial pass,
   assembly, read correction, download), the serial passes summed against
   their prediction, the step's wall against phase 8's, and the host
   syncs inside the launch halves (``torch.cuda.set_sync_debug_mode``);
   ``make_sharded_phase_step`` over ``[cuda:0] * 4`` on a B = 8 batch
   equal to per-chromosome ``vote_scan_core`` on the card and the cpu;
   phase 5's somatic walk in three chromosomes through
   ``somatic_counts_batched`` over ``[cuda:0] * 3``, equal key for key to
   the one-device batch, one call on the card a share;
12. the soak at chromosome scale (``testing/wgs_soak.py``, steps 1-5 on
   ``cuda``, every run a fresh interpreter with a warm-up run, then the
   timed run): ``CFG`` cut to ``SOAK_LENGTH`` (48 of the 64 Mbp of
   ``tools/wgs_soak.py``'s chromosome) through ``cli phase``, its VCF
   equal to the ``--device cpu`` run's, the flat path's four kernels
   launched and ``vote_cast`` not, its wall split into BAM ingest, merge,
   device step, the rest of the flat path, the writer and the rest, and
   the card's busy share from ``torch.profiler``; ``cli haplotag``
   whole-file, streaming under a 64 MiB budget and with the host engine,
   tags equal, with the walks the engine gate sent to each side; the
   wavefront (``LPS_MULTICHIP=1 LPS_WAVEFRONT=1``) equal to ``cli
   phase``; on ``SOMATIC_CFG`` cut to ``SOAK_SOMATIC_LENGTH``, the normal
   sample phased, ``somatic_haplotag --output-somatic-vcf`` and
   ``estimate_purity`` equal across the device and host engines with a
   purity above 0. The soak's fixtures are simulated in a worker process
   of their own from the start of the run.

The simulated fixtures of phases 4 and 6-8 and 10 are built from the
start, one after another in one worker process, while the card runs the
earlier phases.

Phase 5 also times the somatic batch (``somatic_counts_batched``) on its
walk cut into three chromosomes, against the three per-chromosome calls,
and ``class_counts`` (the port of ``_k_class``, which no pipeline calls)
on the somatic walk, equal on ``cuda``, ``cpu`` and a numpy ``bincount``,
with and without transfers, beside its bound.

Then one JSON line with one entry per kernel (its launches on the run of
phase 4 that drove its path, its time and its plain version's at phase 3's
shapes, and its bound: the bytes it must move over the card's memory rate,
or its int32 operations over the int32 rate where those take longer), one
JSON line with one entry per tag reduction (phases 5 and 7, and the
somatic batch, and ``class_counts``), one JSON line for the read
correction on the card (phases 3 and 8), one JSON line of phase 11's mesh,
and the last line ``{"ok": true, "device": {...}}``. The
JSON line of kernels holds ``vote_scan`` twice: one chromosome a launch
(``"path": "flat"``) and the genome's segments in one launch (``"path":
"batched"``); and ``vote_scan_carry``, the same kernel launched with a
carry (phase 9: launches from ``cli phase`` with ``LPS_WAVEFRONT=1``, time
and bound of chr1's four blocks); each flat-path kernel's entry also holds
``dist_launches``, its launches in each process of phase 10's 2-process
``cli phase``, and ``soak_launches``, its launches in phase 12's timed
``cli phase``. Before the last line, one JSON line of phase 10's processes
(walls, launches, device calls, bytes gathered) and one of phase 12's soak
(every run's wall, split, busy share, peak RSS and device memory,
launches, engine choices, and the cut). Any failed phase raises,
a worker that fails or times out included (its stderr tail in the
message), and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
W = 35
SEED = 20260916
# the kernels each path of cli phase launches: the flat path (native
# ingest, ops/fused.run_fused_phase) and the object path (ops/engine.py)
FLAT_PATH = ("bucket_count", "bucket_scatter", "pair_cast", "vote_scan")
OBJECT_PATH = ("vote_cast", "vote_scan")


# GRCh38 primary assembly lengths (bp) of the chromosomes phase 8 phases
GRCH38 = (("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
          ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
          ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
          ("chr10", 133_797_422), ("chr11", 135_086_622),
          ("chr12", 133_275_309), ("chr13", 114_364_328),
          ("chr14", 107_043_718), ("chr15", 101_991_189),
          ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
          ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
          ("chr22", 50_818_468), ("chrX", 156_040_895))
# the serial pass before it took a carry (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6): phase 3's S = 319,951, W = 35, and phase 8's genome
# in one segmented launch at W = 35 and 100
K1_BEFORE_CARRY_MS = "27.35-27.57"
K1_SEGMENTED_BEFORE_CARRY_MS = {35: "14.48-14.76", 100: "22.11-22.47"}
# the read correction's peak device memory while it widened the stream's
# ranks, alleles and alignments to int64 (the same card; PERF.md section
# 6): phase 3's chromosome and phase 8's genome, MB
RC_PEAK_INT64_MB = {3: 391.184384, 8: 3833.5232}

# the simulated fixtures (testing/simulate.py): name -> (builder, arguments)
FIXTURES = {
    "fix": ("make_fixture", dict(seed=1, length=2_000_000, coverage=30,
                                 read_len=12000, snp_rate=0.005,
                                 error_rate=0.05, qual=20)),
    "obj": ("make_fixture", dict(seed=4, length=300_000, coverage=20,
                                 read_len=10000, snp_rate=0.002,
                                 error_rate=0.04, qual=20)),
    "som": ("make_somatic_fixture", dict(seed=2, length=1_000_000,
                                         normal_coverage=30,
                                         tumor_coverage=40, purity=0.6,
                                         n_somatic=80, n_artifacts=20)),
    "meth": ("make_meth_fixture", dict(seed=3, length=1_000_000, coverage=30,
                                       n_asm=100, n_homo_mod=50)),
    "multi": ("make_multichrom_fixture", dict(seed=29, n_chroms=5,
                                              base_length=60000)),
    "multi_som": ("make_multichrom_somatic_fixture",
                  dict(seed=23, n_chroms=3, base_length=120000)),
    "multi_meth": ("make_multichrom_meth_fixture", dict(seed=5, n_chroms=3)),
}
# phase 12's cut of the soak's configurations (testing/wgs_soak.py): CFG
# and SOMATIC_CFG at these lengths, so that the whole run keeps a third of
# its 1200 s limit to spare (at CFG's 64 Mbp the run took 820.8 s on an
# NVIDIA H100 80GB HBM3 at 700 W, phase 12's steps 342.4 s of it)
SOAK_LENGTH = 48_000_000
SOAK_SOMATIC_LENGTH = 16_000_000
# the genome's stream keys phase 8 writes for phase 10's processes
GENOME_KEYS = ("positions", "vtype", "m_read", "m_rank", "m_allele", "m_qok")


class SmokeFailure(RuntimeError):
    pass


def _simulate(builder: str, out_dir: str, kwargs: dict):
    """One fixture, in a worker process; returns it and its seconds."""
    from longphase_s_tpu_torch.testing import simulate

    t0 = time.perf_counter()
    fx = getattr(simulate, builder)(out_dir, **kwargs)
    return fx, time.perf_counter() - t0


class Fixtures:
    """Every fixture of ``FIXTURES`` built under ``workdir`` by a pool of
    worker processes, all submitted at once; ``get`` waits for one."""

    def __init__(self, workdir: str, pool):
        self.pending = {name: pool.submit(_simulate, builder,
                                          os.path.join(workdir, name), kw)
                        for name, (builder, kw) in FIXTURES.items()}

    def get(self, name: str):
        t0 = time.perf_counter()
        fx, sim_s = self.pending[name].result()
        say(f"fixture {name}: simulated in {sim_s:.3f} s in a worker, "
            f"waited {time.perf_counter() - t0:.3f} s for it")
        return fx


def _soak_fixtures(work: str, length: int, somatic_length: int):
    """Phase 12's fixtures, in a worker process: the soak's ``CFG`` and
    ``SOMATIC_CFG`` cut to these lengths; their metadata and seconds."""
    from longphase_s_tpu_torch.testing import wgs_soak

    t0 = time.perf_counter()
    fix = wgs_soak.get_fixture(work, wgs_soak.cut(wgs_soak.CFG, length))
    sfix = wgs_soak.get_somatic_fixture(
        work, wgs_soak.cut(wgs_soak.SOMATIC_CFG, somatic_length))
    return fix, sfix, time.perf_counter() - t0


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def synthetic_stream(rng, S: int, coverage: int, sites_per_read: int,
                     dup_frac: float = 0.0, pad: int = 0,
                     shuffle_reads: bool = False):
    """A (read, rank)-sorted merged observation stream over S sites: reads
    cover contiguous rank runs of about ``sites_per_read`` sites (5% of
    calls dropped) that never cross one of about S / 5000 coverage breaks
    (so phasing yields many blocks), alleles follow a hidden haplotype with
    5% errors, ``dup_frac`` of the rows repeat their (read, rank) with a
    random allele, ``shuffle_reads`` puts the reads in random order (each
    read's rows stay together), and ``pad`` trailing rows carry m_read ==
    -1."""
    import numpy as np

    n_reads = S * coverage // sites_per_read
    lengths = rng.integers(sites_per_read // 2, sites_per_read * 3 // 2 + 1,
                           n_reads)
    starts = rng.integers(0, S, n_reads)
    breaks = np.append(np.sort(rng.choice(S, max(1, S // 5000),
                                          replace=False)), S)
    limit = breaks[np.searchsorted(breaks, starts, side="right")]
    lengths = np.minimum(starts + lengths, limit) - starts
    total = int(lengths.sum())
    read = np.repeat(np.arange(n_reads), lengths)
    rank = np.repeat(starts, lengths) + (
        np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths))
    keep = rng.random(total) > 0.05
    read, rank = read[keep], rank[keep]
    site_hap = rng.integers(0, 2, S)
    read_hap = rng.integers(0, 2, n_reads)
    allele = site_hap[rank] ^ read_hap[read] ^ (rng.random(len(rank)) < 0.05)
    if dup_frac:
        rep = np.where(rng.random(len(rank)) < dup_frac, 2, 1)
        first = np.cumsum(rep) - rep
        read, rank, allele = (np.repeat(a, rep) for a in (read, rank, allele))
        dup = np.ones(len(rank), bool)
        dup[first] = False
        allele[dup] = rng.integers(0, 2, int(dup.sum()))
    if shuffle_reads:
        order = np.argsort(rng.permutation(n_reads)[read], kind="stable")
        read, rank, allele = read[order], rank[order], allele[order]
    qok = rng.random(len(rank)) < 0.9
    if pad:
        read = np.concatenate([read, np.full(pad, -1)])
        rank = np.concatenate([rank, np.zeros(pad, rank.dtype)])
        allele = np.concatenate([allele, np.zeros(pad, allele.dtype)])
        qok = np.concatenate([qok, np.zeros(pad, bool)])
    return (read.astype(np.int32), rank.astype(np.int32),
            allele.astype(np.int8), qok, n_reads)


def synthetic_sites(rng, S: int, max_gap: int = 400):
    """Sorted positions (gaps below ``max_gap``, and a few beyond the 300
    kbp distance limit) and a variant-type mix: mostly SNPs, some SV, MOD,
    indel and danger indel."""
    import numpy as np

    from longphase_s_tpu_torch.core.phase_algo import (T_DANGER, T_INDEL, T_MOD,
                                                 T_SNP, T_SV)

    gaps = rng.integers(1, max_gap, S).astype(np.int64)
    gaps[rng.choice(S, 3, replace=False)] += 400_000
    positions = np.cumsum(gaps) + 1000
    vtype = rng.choice([T_SNP, T_SV, T_MOD, T_INDEL, T_DANGER], S,
                       p=[0.92, 0.01, 0.03, 0.02, 0.02]).astype(np.int8)
    return positions, vtype


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run, timed with CUDA events on the current stream."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# NVIDIA H100 SXM device memory rate (HBM3, 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12
# its int32 rate outside the tensor cores: 64 int32 lanes an SM (Hopper
# architecture white paper) x 132 SMs x 1.98 GHz, about 16.7 Tops/s
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` once each.
    The scan's kernels and the bucket passes do a few integer operations a
    byte, far below the card's operation rate, so bytes bound them."""
    return 1000 * nbytes / HBM_BYTES_PER_S


def roofline(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` moved once
    each over the memory rate and ``ops`` int32 operations over the int32
    rate."""
    by_ops = 1000 * ops / INT32_OPS_PER_S
    return (by_ops, "operations") if by_ops > bound_ms(nbytes) \
        else (bound_ms(nbytes), "bytes")


def max_abs_err(a, b) -> int:
    return max(int((x.to(int) - y.to(int)).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def correction_on_card(ps0, ori0, vt, rank, allele, aln, A: int, params):
    """``ops/fused.device_read_correction`` on tensors on the card: its
    output, CUDA-event ms, peak device memory above what it found (MB) and
    bound. Each input read once (ps int64, ori, vtype; rank int32, allele
    int8, alignment int32 an observation), new ps and ori written once;
    about 30 integer operations an observation."""
    import torch

    from longphase_s_tpu_torch.ops import fused

    def run():
        return fused.device_read_correction(
            ps0, ori0, vt, rank, allele, aln, A, params.read_confidence,
            params.snp_confidence)

    ms = cuda_ms(run, 5)
    dev = ps0.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = run()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
    S, n = len(ps0), len(rank)
    return out, ms, peak_mb, roofline(S * 19 + n * 9, 30 * n)


def host_correction(entries, seg, ps0, ori0, params):
    """``host_read_correction_merged`` (float64, native) of each entry on
    its slices of the uncorrected numpy ``ps0``/``ori0``: the outputs and
    the host seconds."""
    from longphase_s_tpu_torch.ops.read_correction import \
        host_read_correction_merged

    t0 = time.perf_counter()
    out = [host_read_correction_merged(
        ps0[a:z], ori0[a:z], e["vtype"], e["m_rank"], e["m_allele"],
        e["m_aln"], e["n_aln"], params.read_confidence, params.snp_confidence)
        for e, a, z in zip(entries, seg, seg[1:])]
    return out, time.perf_counter() - t0


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say(smi.stdout.strip().splitlines()[0])
    from longphase_s_tpu_torch import native

    t0 = time.perf_counter()
    check(native.available(), "native ingest library did not build or load")
    say(f"phase 0 device: {torch.cuda.get_device_name(0)}, "
        f"count={torch.cuda.device_count()}, torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}), native library ready in "
        f"{time.perf_counter() - t0:.3f} s")


def phase1_build():
    from longphase_s_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    say(f"phase 1 build: {len(_build.sources())} CUDA sources "
        f"({', '.join(os.path.basename(s) for s in _build.sources())}) "
        f"built in parallel and loaded in {time.perf_counter() - t0:.3f} s")
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            say(f"phase 1 ptxas: {line.strip()}")


def scan_inputs(rng, S: int, dev, window: int = W):
    import numpy as np
    import torch

    from longphase_s_tpu_torch.ops.vote_scan import fold_counts

    hi = torch.from_numpy(rng.integers(0, 30, (S, window, 4)).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, 8, (S, window, 4)).astype(np.int32))
    s_para10, s_cross10 = fold_counts(hi, lo)
    gap = torch.from_numpy(rng.integers(1, 400000, S).astype(np.int32))
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8))
    return [x.to(dev) for x in (s_para10, s_cross10, gap, vtype)]


def phase2_kernels(rng, dev):
    import numpy as np
    import torch

    from longphase_s_tpu_torch.ops import cuda_scan, fused

    windows = (1, 32, 33, W, 100, 128, 129, 200)
    for window in windows:
        for S in (300, 4096, 16384):
            for thr in (0.7, 0.33):
                args = scan_inputs(rng, S, dev, window)
                kw = dict(S=S, window=window, distance=300000,
                          edge_threshold_x10=thr * 10.0)
                codes, site = cuda_scan.vote_codes(*args, **kw)
                plain_codes = cuda_scan.vote_codes_plain(*args, **kw)
                got = cuda_scan.vote_serial(codes, site, S, window)
                serial = cuda_scan.vote_serial_plain(codes, site, S, window)
                whole = cuda_scan.vote_scan_pc_plain(*args, **kw)
                cpu = cuda_scan.vote_scan_pc(*(a.cpu() for a in args), **kw)
                torch.cuda.synchronize()
                where = f"S={S}, W={window}, edgeThreshold={thr}"
                err = max_abs_err((codes, site), plain_codes)
                check(err == 0, f"vote_cast kernel differs from its plain "
                      f"version at {where}: max |diff| {err}")
                err = max_abs_err(got, serial)
                check(err == 0, f"vote_scan kernel differs from its plain "
                      f"version at {where}: max |diff| {err}")
                err = max(max_abs_err(got, whole),
                          max_abs_err([g.cpu() for g in got], cpu))
                check(err == 0, f"the two kernels differ from the plain "
                      f"scan at {where}: max |diff| {err}")
                if S == 16384 and thr == 0.7 and window in (W, 100, 200):
                    both = cuda_ms(
                        lambda: cuda_scan.vote_scan_pc(*args, **kw), 10)
                    cast = cuda_ms(
                        lambda: cuda_scan.vote_codes(*args, **kw), 10)
                    scan = cuda_ms(lambda: cuda_scan.vote_serial(
                        codes, site, S, window), 10)
                    plain = cuda_ms(
                        lambda: cuda_scan.vote_scan_pc_plain(*args, **kw), 1)
                    say(f"phase 2 vote scan S={S} W={window}: both launches "
                        f"{both} ms (vote_cast {cast} ms, vote_scan {scan} "
                        f"ms), plain version on the card {plain} ms")
    say(f"phase 2 vote_cast and vote_scan: each kernel equals its plain "
        f"version, and both the whole plain scan and the CPU, at W in "
        f"{list(windows)} x S in [300, 4096, 16384] x edgeThreshold in "
        "[0.7, 0.33]")

    per_obs = {}
    for window in windows:
        for k, S in enumerate((1, 33, 300, 4096, 16384)):
            read, rank, allele, qok, _n = synthetic_stream(
                rng, S, coverage=30, sites_per_read=60, dup_frac=0.02,
                pad=1000, shuffle_reads=k % 2 == 1)
            stream = fused.stream_to_device(read, rank, allele, qok, dev)
            gap = torch.from_numpy(rng.integers(1, 400000, S)
                                   .astype(np.int32)).to(dev)
            vt = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8)) \
                .to(dev)
            kw = dict(distance=300000, edge_threshold_x10=7.0)
            errs, T = pair_stage_errors(stream, gap, vt, S, window, **kw)
            got = fused.pair_codes(stream, gap, vt, S, window, **kw)
            if S <= 300:  # the CPU's plain version, as the CPU path runs it
                cpu = fused.pair_codes(tuple(x.cpu() for x in stream),
                                       gap.cpu(), vt.cpu(), S, window, **kw)
                errs["pair_codes on the cpu"] = max_abs_err(
                    [g.cpu() for g in got], cpu)
            where = f"S={S}, W={window}, T={T}, {len(read)} rows"
            for name, err in errs.items():
                check(err == 0, f"{name} differs from its plain version at "
                      f"{where}: max |diff| {err}")
            if S >= 4096:
                check(int((got[0] != 0).sum()) > S // 2, f"pair_cast cast too "
                      f"few votes at {where}")
            if S == 16384 and window in (W, 100):
                per_obs[window] = pair_stage_times(stream, gap, vt, S, window,
                                                   10, **kw)
                say(f"phase 2 pair stage S={S} W={window} T={T} "
                    f"({len(read)} rows): {per_obs[window]}")
    say(f"phase 2 bucket_count, bucket_scatter and pair_cast: each kernel "
        f"equals its plain version at W in {list(windows)} x S in [1, 33, "
        "300, 4096, 16384], on 30x streams with duplicate (read, rank) "
        "rows, m_read == -1 padding and (every other size) reads in "
        "random order; pair_codes equals the CPU's plain version up to "
        "S = 300")
    return per_obs


def pair_stage_errors(stream, gap, vt, S: int, window: int, **kw):
    """Each kernel of the pair stage against its plain version on the
    same inputs: the counts exactly; the buckets as sets (the kernel's
    order inside a bucket is arbitrary; its keys must run in tile order and
    each bucket hold the plain version's sources); the codes and site words
    exactly. Returns ({kernel: max |diff|}, T)."""
    import torch

    from longphase_s_tpu_torch.ops import fused

    read, rank = stream[0], stream[1]
    T = fused.pair_tile_rows(S, window, read.device)
    count = fused.bucket_counts(read, rank, S, T)
    order, ends = fused.bucket_order(read, rank, S, T, count)
    codes = fused.pair_cast_tiles(stream, order, ends, gap, vt, S, window, T,
                                  **kw)
    ref_count = fused.bucket_counts_plain(read, rank, S, T)
    ref_order, ref_ends = fused.bucket_order_plain(read, rank, S, T,
                                                   ref_count)
    ref_codes = fused.pair_codes_plain(stream, gap, vt, S, window, **kw)
    torch.cuda.synchronize()
    m = len(ref_order)
    scatter_err = max_abs_err([ends], [ref_ends])
    if scatter_err == 0 and m:
        got = order[:m].long()
        key = rank[got].long() // T
        ref_key = rank[ref_order.long()].long() // T
        n = len(read)
        scatter_err = max(max_abs_err([key], [ref_key]), max_abs_err(
            [torch.sort(key * n + got).values],
            [ref_key * n + ref_order.long()]))
    return {"bucket_count": max_abs_err([count], [ref_count]),
            "bucket_scatter": scatter_err,
            "pair_cast": max_abs_err(codes, ref_codes)}, T


def pair_stage_times(stream, gap, vt, S: int, window: int, reps: int, **kw):
    """CUDA-event ms of each launch of the pair stage and of the whole
    ``pair_codes``, and the tile kernel's ns an observation."""
    from longphase_s_tpu_torch.ops import fused

    read, rank = stream[0], stream[1]
    T = fused.pair_tile_rows(S, window, read.device)
    count = fused.bucket_counts(read, rank, S, T)
    order, ends = fused.bucket_order(read, rank, S, T, count)
    out = {
        "bucket_count": cuda_ms(
            lambda: fused.bucket_counts(read, rank, S, T), reps),
        # the scan of the counts (torch.cumsum) and the scatter
        "bucket_scatter": cuda_ms(
            lambda: fused.bucket_order(read, rank, S, T, count), reps),
        "pair_cast": cuda_ms(lambda: fused.pair_cast_tiles(
            stream, order, ends, gap, vt, S, window, T, **kw), reps),
        "pair_codes": cuda_ms(lambda: fused.pair_codes(
            stream, gap, vt, S, window, **kw), reps)}
    out["pair_cast_ns_per_obs"] = 1e6 * out["pair_cast"] / len(read)
    return out


def pair_work(stream, S: int, window: int):
    """The pairs the function adds on this stream (stream-shift pairs of a
    source with 1 <= d <= the cut window), counted on the card."""
    from longphase_s_tpu_torch.ops import cuda_scan

    read, rank = stream[0], stream[1]
    n, w = len(read), cuda_scan.cut_window(S, window)
    own = (read >= 0) & (rank >= 0) & (rank < S)
    pairs = 0
    for m in range(1, min(window, n - 1) + 1):
        d = rank[m:] - rank[:n - m]
        pairs += int((own[:n - m] & (read[:n - m] == read[m:]) & (d >= 1)
                      & (d <= w)).sum())
    return pairs


def flat_bounds(stream, n: int, S: int, window: int, pairs: int) -> dict:
    """The bound of each flat-path kernel on this stream of ``n``
    observations over ``S`` sites (a chromosome, or a batch's sites end to
    end) that adds ``pairs`` pairs (``pair_work``), as (ms, "bytes" or
    "operations"); the bucket counts from the plain version, so that no
    launch is counted."""
    from longphase_s_tpu_torch.ops import cuda_scan, fused

    T = fused.pair_tile_rows(S, window, stream[0].device)
    tiles, w = -(-S // T), cuda_scan.cut_window(S, window)
    n_src = int(fused.bucket_counts_plain(stream[0], stream[1], S, T).sum())
    return {
        # read, rank in; counts out
        "bucket_count": roofline(n * 8 + tiles * 4, n),
        # read, rank and the counts in; the index out
        "bucket_scatter": roofline(n * 8 + tiles * 4 + n_src * 4, n),
        # the stream, gap and vtype in; S x w codes and the site words out;
        # one add a pair and about 16 operations a cast (t, d)
        "pair_cast": roofline(n * 10 + S * 5 + S * w + S * 4,
                              pairs + 16 * S * w),
        # codes and site words in; assigned, hp and bstart out
        "vote_scan": roofline(S * w + S * 4 + S + 2 * S * 4, 0)}


def phase3_chromosome(rng, dev) -> dict:
    import numpy as np
    import torch

    from longphase_s_tpu_torch.core.phase_algo import PhaseParams
    from longphase_s_tpu_torch.ops import cuda_scan, fused
    from longphase_s_tpu_torch.ops.vote_scan import site_gaps

    S = 319_951
    params = PhaseParams()
    read, rank, allele, qok, n_reads = synthetic_stream(
        rng, S, coverage=20, sites_per_read=60)
    positions, vtype = synthetic_sites(rng, S)
    aln = read.copy()
    args = (read, rank, allele, qok, aln, positions, vtype, n_reads, params)

    walls = []
    for _ in range(4):  # one warm-up, three timed
        t0 = time.perf_counter()
        ps, ori = fused.run_fused_phase(*args, device=dev)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fused.run_fused_phase(*args, device=dev)
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
    t0 = time.perf_counter()
    ps_cpu, ori_cpu = fused.run_fused_phase(*args, device="cpu")
    cpu_wall = time.perf_counter() - t0
    check(ps.shape == (S,) and ori.shape == (S,), "step output shape")
    check(np.array_equal(ps, ps_cpu), "chromosome-scale ps differs cuda/cpu")
    phased = ps_cpu != 0
    check(np.array_equal(ori[phased], ori_cpu[phased]),
          "chromosome-scale ori differs cuda/cpu on phased sites")
    check(phased.sum() > S // 2, f"only {phased.sum()} of {S} sites phased")
    check(len(np.unique(ps[phased])) > S // 10000, "too few phase blocks")
    n = len(read)
    say(f"phase 3 chromosome scale: S={S}, {n} observations, "
        f"{int(phased.sum())} sites phased, {len(np.unique(ps[phased]))} "
        f"blocks; run_fused_phase wall on cuda {walls[1:]} s "
        f"(warm-up {walls[0]} s), on cpu {cpu_wall} s; cuda == cpu; the "
        f"step's peak device memory {peak_mb} MB above what it found")

    # the read correction on the card against the host's, on the step's
    # uncorrected output
    stream = fused.stream_to_device(read, rank, allele, qok, dev)
    gap = torch.from_numpy(site_gaps(positions)).to(dev)
    vt = torch.from_numpy(vtype).to(dev)
    codes, site = fused.pair_codes(stream, gap, vt, S, W, params.distance,
                                   params.edge_threshold * 10.0)
    ps0, ori0 = fused.device_assemble_blocks(
        *cuda_scan.vote_serial(codes, site, S, W),
        torch.from_numpy(positions).to(dev), S)
    (rc_ps, rc_ori), rc_ms, rc_mb, rc_bound = correction_on_card(
        ps0, ori0, vt, stream[1], stream[2], torch.from_numpy(aln).to(dev),
        n_reads, params)
    entry = {"vtype": vtype, "m_rank": rank, "m_allele": allele,
             "m_aln": aln, "n_aln": n_reads}
    (host,), host_s = host_correction([entry], (0, S), ps0.cpu().numpy(),
                                      ori0.cpu().numpy(), params)
    rc_err = max_abs_err((rc_ps.cpu(), rc_ori.cpu()),
                         [torch.from_numpy(x.astype(np.int64)) for x in host])
    check(rc_err == 0 and np.array_equal(rc_ps.cpu().numpy(), ps),
          f"the read correction on the card differs from the host's: {rc_err}")
    erased = int(((ps0 != 0) & (rc_ps == 0)).sum())
    say(f"phase 3 read correction on the card: {rc_ms} ms (bound {rc_bound}), "
        f"peak device memory {rc_mb} MB (with int64 stream tensors "
        f"{RC_PEAK_INT64_MB[3]} MB); host float64 (native) "
        f"{1000 * host_s} ms, the stage it replaced; equal; {erased} sites "
        "lost their phase to it")
    correction = dict(ms=rc_ms, host_ms=1000 * host_s, bound=rc_bound,
                      peak_mb=rc_mb, err=rc_err, observations=n, sites=S)
    del codes, site, ps0, ori0, stream

    stream = fused.stream_to_device(read, rank, allele, qok, dev)
    kw = dict(distance=params.distance,
              edge_threshold_x10=params.edge_threshold * 10.0)
    keys = torch.from_numpy(rank.astype(np.int64)
                            // fused.pair_tile_rows(S, W, dev)).to(dev)
    sort_ms = cuda_ms(lambda: torch.sort(keys), 3)
    out = {}
    for window in (W, 100):
        w = cuda_scan.cut_window(S, window)
        errs, T = pair_stage_errors(stream, gap, vt, S, window, **kw)
        for name, err in errs.items():
            check(err == 0, f"{name} differs from its plain version at "
                  f"chromosome scale, W={window}: {err}")
        times = pair_stage_times(stream, gap, vt, S, window, 10, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        codes, site = fused.pair_codes(stream, gap, vt, S, window, **kw)
        stage_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
        plain_ms = cuda_ms(lambda: fused.pair_codes_plain(
            stream, gap, vt, S, window, **kw), 1)
        pairs = pair_work(stream, S, window)
        bounds = flat_bounds(stream, n, S, window, pairs)
        cast_bound = bounds["pair_cast"]
        say(f"phase 3 pair stage at S={S}, W={window}, T={T}: {times}; "
            f"{pairs} pairs; peak device memory {stage_mb} MB; plain "
            f"version on the card {plain_ms} ms; bound {cast_bound}; equal")
        # the scan, fed by the object path's cast from the plain sums
        sums = fused.pair_sums_plain(*stream, S, window)
        cargs = (*sums, gap, vt)
        skw = dict(S=S, window=window, **kw)
        cast_ms = cuda_ms(lambda: cuda_scan.vote_codes(*cargs, **skw), 10)
        vcodes, vsite = cuda_scan.vote_codes(*cargs, **skw)
        check(torch.equal(vcodes, codes) and torch.equal(vsite, site),
              f"vote_cast and pair_cast cast differently at W={window}")
        serial_ms = cuda_ms(
            lambda: cuda_scan.vote_serial(codes, site, S, window), 10)
        got = cuda_scan.vote_serial(codes, site, S, window)
        t0 = time.perf_counter()
        whole = cuda_scan.vote_scan_pc_plain(*cargs, **skw)
        torch.cuda.synchronize()
        whole_ms = 1000 * (time.perf_counter() - t0)
        err = max_abs_err(got, whole)
        check(err == 0, f"vote scan differs from the plain scan at "
              f"chromosome scale, W={window}: {err}")
        before = f" (before the carry: {K1_BEFORE_CARRY_MS} ms)" \
            if window == W else ""
        say(f"phase 3 vote scan at S={S}, W={window}: vote_serial "
            f"{serial_ms} ms{before} over pair_cast's codes; vote_cast "
            f"(object path) {cast_ms} ms, its codes equal pair_cast's; plain "
            f"scan on the card {whole_ms} ms; equal")
        if window != W:
            continue
        ref = (fused.bucket_counts_plain(stream[0], stream[1], S, T),)
        count_plain_ms = cuda_ms(lambda: fused.bucket_counts_plain(
            stream[0], stream[1], S, T), 3)
        order_plain_ms = cuda_ms(lambda: fused.bucket_order_plain(
            stream[0], stream[1], S, T, ref[0]), 3)
        cast_plain_ms = cuda_ms(
            lambda: cuda_scan.vote_codes_plain(*cargs, **skw), 1)
        cast_err = max_abs_err((vcodes, vsite),
                               cuda_scan.vote_codes_plain(*cargs, **skw))
        t0 = time.perf_counter()
        serial_ref = cuda_scan.vote_serial_plain(codes, site, S, window)
        torch.cuda.synchronize()
        serial_plain_ms = 1000 * (time.perf_counter() - t0)
        serial_err = max_abs_err(got, serial_ref)
        check(cast_err == 0 and serial_err == 0, f"vote_cast / vote_scan "
              f"differ from their plain versions at chromosome scale: "
              f"{cast_err} / {serial_err}")
        share = times["pair_cast"] / (times["bucket_count"]
                                      + times["bucket_scatter"]
                                      + times["pair_cast"])
        # the tile kernel at the tallest tile, which fits fewer blocks on
        # an SM: what latency costs it
        count128 = fused.bucket_counts(stream[0], stream[1], S, 128)
        order128, ends128 = fused.bucket_order(stream[0], stream[1], S, 128,
                                               count128)
        tall_ms = cuda_ms(lambda: fused.pair_cast_tiles(
            stream, order128, ends128, gap, vt, S, window, 128, **kw), 10)
        say(f"phase 3 plain versions on the card at W={W}: bucket_count "
            f"{count_plain_ms} ms, bucket_scatter {order_plain_ms} ms, "
            f"vote_cast {cast_plain_ms} ms, vote_scan {serial_plain_ms} ms; "
            f"torch.sort of the {n} tile keys {sort_ms} ms; equal")
        out = {
            "bucket_count": dict(
                ms=times["bucket_count"], plain_ms=count_plain_ms,
                err=errs["bucket_count"], bound=bounds["bucket_count"],
                limited_by="not measured"),
            "bucket_scatter": dict(
                ms=times["bucket_scatter"], plain_ms=order_plain_ms,
                err=errs["bucket_scatter"], bound=bounds["bucket_scatter"],
                limited_by="not measured"),
            "pair_cast": dict(
                ms=times["pair_cast"], plain_ms=plain_ms,
                err=errs["pair_cast"], bound=cast_bound,
                limited_by=(
                    f"measured: the tile kernel is {share:.3f} of the pair "
                    f"stage's three launches; {times['pair_cast']:.4f} ms "
                    f"at T = {T} against {tall_ms:.4f} ms at T = 128, whose "
                    "shared memory fits fewer blocks an SM: the latency of "
                    "the successor walk (tools/pair_cast_probe.py splits "
                    "it)")),
            "vote_cast": dict(
                ms=cast_ms, plain_ms=cast_plain_ms, err=cast_err,
                # sums, gap and vtype in; codes and site words out
                bound=roofline(2 * S * W * 4 + S * 4 + S + S * w + S * 4, 0),
                limited_by="not measured"),
            "vote_scan": dict(
                ms=serial_ms, plain_ms=serial_plain_ms, err=serial_err,
                bound=bounds["vote_scan"],
                limited_by="latency of its serial chain")}
    return out, correction


def phase4_end_to_end(workdir: str, fixtures) -> dict:
    from longphase_s_tpu_torch import cli, native
    from longphase_s_tpu_torch.ops import _build

    fx = fixtures.get("fix")
    base = ["phase", "--pb", "-s", fx["vcf"], "-b", fx["bam"], "-r",
            fx["fasta"]]
    out_gpu = os.path.join(workdir, "gpu")
    out_oracle = os.path.join(workdir, "oracle")

    _build.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(base + ["-o", out_gpu, "--device", "cuda"])
    gpu_wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(rc == 0, f"cli phase --device cuda returned {rc}")
    t0 = time.perf_counter()
    rc = cli.main(base + ["-o", out_oracle, "--engine", "oracle"])
    oracle_wall = time.perf_counter() - t0
    check(rc == 0, f"cli phase --engine oracle returned {rc}")

    gpu_vcf, oracle_vcf = _vcf_body(out_gpu), _vcf_body(out_oracle)
    n_phased = sum(1 for line in gpu_vcf
                   if not line.startswith("#") and "|" in line.split("\t")[-1])
    check(gpu_vcf == oracle_vcf, "cuda VCF differs from the oracle VCF")
    check(n_phased > 1000, f"only {n_phased} records phased")
    for name in FLAT_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
              "flat path")
    check(launches["vote_cast"] == 0, "the flat path launched vote_cast")
    say(f"phase 4 end to end: cli phase --device cuda {gpu_wall} s, "
        f"--engine oracle {oracle_wall} s, {n_phased} phased records, VCFs "
        f"identical; flat path launches {launches}")

    wide = base + ["-a", "100"]
    t0 = time.perf_counter()
    rc = cli.main(wide + ["-o", out_gpu + "_a100", "--device", "cuda"])
    wide_wall = time.perf_counter() - t0
    check(rc == 0, f"cli phase -a 100 --device cuda returned {rc}")
    rc = cli.main(wide + ["-o", out_oracle + "_a100", "--engine", "oracle"])
    check(rc == 0, f"cli phase -a 100 --engine oracle returned {rc}")
    check(_vcf_body(out_gpu + "_a100") == _vcf_body(out_oracle + "_a100"),
          "cuda VCF differs from the oracle VCF at -a 100")
    say(f"phase 4 -a 100: cli phase --device cuda {wide_wall} s, VCF "
        "identical to --engine oracle")

    # the object path: the native ingest declines, so the pair counts come
    # from the host and the scan casts them with vote_cast
    fx_obj = fixtures.get("obj")
    obj = ["phase", "--pb", "-s", fx_obj["vcf"], "-b", fx_obj["bam"], "-r",
           fx_obj["fasta"]]
    out_obj = os.path.join(workdir, "obj_gpu")
    available = native.available
    native.available = lambda: False
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(obj + ["-o", out_obj, "--device", "cuda"])
        obj_wall = time.perf_counter() - t0
        obj_launches = dict(_build.LAUNCHES)
    finally:
        native.available = available
    check(rc == 0, f"cli phase on the object path returned {rc}")
    rc = cli.main(obj + ["-o", out_obj + "_oracle", "--engine", "oracle"])
    check(rc == 0, "cli phase --engine oracle on the object path's fixture "
          f"returned {rc}")
    obj_vcf = _vcf_body(out_obj)
    check(obj_vcf == _vcf_body(out_obj + "_oracle"),
          "object-path cuda VCF differs from the oracle VCF")
    check(sum("|" in line for line in obj_vcf) > 50,
          "the object path phased too few records")
    for name in OBJECT_PATH:
        check(obj_launches[name] > 0, f"kernel {name} was not launched by "
              "the object path")
    check(not any(obj_launches[k] for k in FLAT_PATH if k != "vote_scan"),
          "the object path launched a pair kernel")
    say(f"phase 4 object path (native ingest declined): cli phase --device "
        f"cuda {obj_wall} s, VCF identical to --engine oracle; launches "
        f"{obj_launches}")
    return {name: launches[name] for name in FLAT_PATH} | {
        "vote_cast": obj_launches["vote_cast"]}, fx, out_gpu + ".vcf"


def synthetic_tag_inputs(rng, n_germline: int = 319_951,
                         n_tumor: int = 20_000, length: int = 64_000_000,
                         coverage: int = 30, read_len: int = 15_000):
    """A native tag walk and its variant tables at the scale of phase 3's
    64 Mbp chromosome, in the style of bench.py:541-564: sorted variant
    positions, reads of ``read_len`` at ``coverage`` that observe every
    variant they cover (96% matches, 3% in deletions, 1% other), bases
    from the read's haplotype with 3% errors, and normal tables for the
    germline variants plus tumour-only variants for the somatic modes.
    Returns (germline walk, germline tables, somatic walk, somatic tables,
    per-observation MAPQ gate of the somatic walk, is_som, derive)."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    S = n_germline + n_tumor
    pos = np.sort(rng.choice(length, S, replace=False)).astype(np.int64)
    tumor_only = np.zeros(S, bool)
    tumor_only[rng.choice(S, n_tumor, replace=False)] = True
    A = length * coverage // read_len
    starts = np.sort(rng.integers(0, length - read_len, A))
    lo = np.searchsorted(pos, starts)
    n = np.searchsorted(pos, starts + read_len) - lo
    No = int(n.sum())
    obs_aln = np.repeat(np.arange(A), n).astype(np.int32)
    obs_var = (np.repeat(lo, n) + np.arange(No)
               - np.repeat(np.cumsum(n) - n, n)).astype(np.int32)
    r = rng.random(No)
    kind = np.where(r < 0.96, 0, np.where(r < 0.99, 1, 2)).astype(np.uint8)
    ref_i = rng.integers(0, 4, S)
    ref = acgt[ref_i]
    alt = acgt[(ref_i + rng.integers(1, 4, S)) % 4]
    alt_on_h1 = rng.random(S) < 0.5
    read_h1 = rng.random(A) < 0.5
    carries = np.where(tumor_only[obs_var], rng.random(No) < 0.3,
                       alt_on_h1[obs_var] == read_h1[obs_aln])
    base = np.where(carries, alt[obs_var], ref[obs_var])
    err = rng.random(No) < 0.03
    base[err] = acgt[rng.integers(0, 4, int(err.sum()))]
    walk = {"obs_var": obs_var, "obs_aln": obs_aln,
            "obs_aux": rng.integers(0, 40, No).astype(np.int32),
            "obs_base": base,
            "obs_flags": rng.integers(0, 16, No).astype(np.uint8),
            "obs_kind": kind, "category": np.zeros(A, np.uint8),
            "mapq": np.where(rng.random(A) < 0.03, 0, 60).astype(np.uint8)}

    vtype = rng.choice(np.array([1, 2, 3], np.int8), S, p=[0.92, 0.04, 0.04])
    block = np.cumsum(rng.random(S) < 1 / 2000)
    ps = pos[np.searchsorted(block, block)] + 1  # first site of each block
    hp1 = np.where(alt_on_h1, alt, ref)
    hp2 = np.where(alt_on_h1, ref, alt)
    indel = vtype != 1
    germline = {"pos": pos, "has": ~tumor_only & (rng.random(S) < 0.97),
                "vtype": vtype, "gt": np.zeros(S, np.int8), "ps": ps,
                "snp_ref": ref, "snp_alt": alt, "hp1c": hp1, "hp2c": hp2,
                "hp1_long": indel & alt_on_h1,
                "hp2_long": indel & ~alt_on_h1}
    somatic = {"pos": pos}
    for key, src in (("nor_has", "has"), ("nor_vt", "vtype"),
                     ("nor_gt", "gt"), ("nor_ps", "ps"),
                     ("nor_ref0", "snp_ref"), ("nor_alt0", "snp_alt"),
                     ("nor_hp1c", "hp1c"), ("nor_hp2c", "hp2c"),
                     ("hp1_long", "hp1_long"), ("hp2_long", "hp2_long")):
        somatic[key] = germline[src]
    somatic.update(
        alt_eq_hp1=alt_on_h1 & ~indel, alt_eq_hp2=~alt_on_h1 & ~indel,
        ref_eq_hp1=~alt_on_h1 & ~indel, ref_eq_hp2=alt_on_h1 & ~indel,
        tum_has=tumor_only | (rng.random(S) < 0.02),
        tum_vt=np.where(tumor_only, 1, vtype).astype(np.int8),
        tum_gt=np.where(tumor_only, 1, 0).astype(np.int8),
        tum_ps=np.where(tumor_only, -1, ps), tum_ref0=ref, tum_alt0=alt,
        tum_ref_is1=np.ones(S, bool), tum_alt_is1=np.ones(S, bool))
    is_som = tumor_only & (rng.random(S) < 0.5)
    derive = np.where(is_som, rng.integers(1, 3, S), 0).astype(np.int8)
    gate = (walk["mapq"] >= 1)[obs_aln]

    # the germline walk: observations of germline variants only
    keep = ~tumor_only[obs_var]
    remap = np.cumsum(~tumor_only) - 1
    gwalk = {k: walk[k][keep] for k in walk if k.startswith("obs_")}
    gwalk["obs_var"] = remap[gwalk["obs_var"]].astype(np.int32)
    gwalk["category"] = walk["category"]
    gtables = {k: v[~tumor_only] for k, v in germline.items()}
    return gwalk, gtables, walk, somatic, gate, is_som, derive


def host_reduction(mode, walk, t, gate, is_som, derive):
    """The numpy host path for one reduction (the host branches of the
    port's core/somatic_fast.py and models/somatic.py, copies of the JAX
    package's): the germline
    judge's (h1, h2, n_ps, min_ps) counts, or a dict of the somatic pass's
    per-alignment counts, PosBase tables ('normal', 'extract') and derive
    counts ('haplotag'), keyed as ``tag_kernels.somatic_counts`` keys
    them."""
    import numpy as np

    from longphase_s_tpu_torch.core.somatic_fast import (accumulate_pos_base,
                                                   nor_ps_aggregate,
                                                   obs_is_alt,
                                                   somatic_match_votes)
    from longphase_s_tpu_torch.models.haplotag_fast import (aggregate_reads,
                                                      germline_votes)

    al = walk["obs_aln"]
    A = len(walk["category"])
    if mode == "germline":
        h1, h2, cps = germline_votes(walk, t, True)
        return aggregate_reads(walk, t, h1, h2, cps)
    is_alt = obs_is_alt(walk, t)
    out = {}
    if mode != "haplotag":
        tables, touched = accumulate_pos_base(walk, t, is_alt, gate,
                                              len(t["pos"]))
        out.update(tables, touched=touched)
    if mode == "normal":
        gt = {"pos": t["pos"], "has": t["nor_has"], "vtype": t["nor_vt"],
              "gt": t["nor_gt"], "ps": t["nor_ps"], "snp_ref": t["nor_ref0"],
              "snp_alt": t["nor_alt0"], "hp1c": t["nor_hp1c"],
              "hp2c": t["nor_hp2c"], "hp1_long": t["hp1_long"],
              "hp2_long": t["hp2_long"]}
        h1, h2, cps = (m & gate for m in germline_votes(walk, gt, True))
        h3 = np.zeros_like(h1)
    else:
        v = somatic_match_votes(walk, t, is_alt, mode, is_somatic=is_som)
        g = gate if mode == "extract" else True
        h1, h2, h3, cps = (v[k] & g for k in ("h1", "h2", "h3", "cps_nor"))
    for key, m in (("h1_cnt", h1), ("h2_cnt", h2), ("h3_cnt", h3)):
        out[key] = np.bincount(al[m], minlength=A)
    out["n_ps"], out["min_ps"], _ = nor_ps_aggregate(walk, t, cps)
    if mode == "haplotag":
        idx = np.flatnonzero(h3)
        dv = derive[walk["obs_var"][idx]]
        for d in (1, 2):
            out[f"d{d}_cnt"] = np.bincount(al[idx[dv == d]], minlength=A)
    return out


def best_s(fn, reps: int = 3) -> float:
    """Best wall seconds of ``fn()`` over ``reps`` runs after a warm-up; a
    device call ends in a download or a synchronize."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def phase5_tag_reductions(rng, dev) -> dict:
    import numpy as np
    import torch

    from longphase_s_tpu_torch.ops import tag_kernels as tk

    t0 = time.perf_counter()
    gwalk, gt, walk, st, gate, is_som, derive = synthetic_tag_inputs(rng)
    say(f"phase 5 inputs: germline walk {len(gwalk['obs_var'])} "
        f"observations over {len(gt['pos'])} variants, somatic walk "
        f"{len(walk['obs_var'])} over {len(st['pos'])}, "
        f"{len(walk['category'])} alignments, built in "
        f"{time.perf_counter() - t0:.3f} s")

    def args(mode, device):
        if mode == "germline":
            return lambda: tk.germline_counts(gwalk, gt, True, device=device)
        kw = dict(is_som=is_som, derive=derive,
                  gate=None if mode == "haplotag" else gate,
                  want_posbase=mode != "haplotag",
                  want_derive=mode == "haplotag", ref_nonempty=True)
        return lambda: tk.somatic_counts(walk, st, mode, device=device, **kw)

    def on_device(mode):
        """The reduction on tensors already on the card, and the bytes of
        its input tensors."""
        if mode == "germline":
            w = tk.walk_to_device(gwalk, None, dev)
            tabs = tk.tables_to_device(gt, tk.GERMLINE_ROWS, dev)
            A = len(gwalk["category"])
            fn = lambda: (tk.germline_reduce(w, tabs, A, True),
                          torch.cuda.synchronize())
        else:
            w = tk.walk_to_device(walk, None if mode == "haplotag" else gate,
                                  dev)
            tabs = tk.tables_to_device(dict(st, is_som=is_som,
                                            derive=derive),
                                       tk.SOMATIC_ROWS, dev)
            A, S = len(walk["category"]), len(st["pos"])
            fn = lambda: (tk.somatic_reduce(w, tabs, A, S, mode,
                                            mode != "haplotag",
                                            mode == "haplotag", True),
                          torch.cuda.synchronize())
        return fn, tensor_bytes(*w.values(), *tabs.values())

    def tensor_bytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    def host(mode, wk=None, tabs=None):
        if mode == "germline":
            return lambda: host_reduction(mode, wk or gwalk, tabs or gt,
                                          None, None, None)
        wk = wk or walk
        g = (wk["mapq"] >= 1)[wk["obs_aln"]]
        return lambda: host_reduction(mode, wk, tabs or st, g, is_som,
                                      derive)

    times = {}
    for mode in ("germline", "normal", "extract", "haplotag"):
        got = args(mode, dev)()
        t0 = time.perf_counter()
        ref = args(mode, "cpu")()
        cpu_s = time.perf_counter() - t0
        on_host = host(mode)()
        if mode == "germline":
            check(all(np.array_equal(a, b) and a.dtype == b.dtype
                      for a, b in zip(got, ref)),
                  "germline reduction differs cuda/cpu")
            check(all(np.array_equal(a, b) for a, b in zip(got, on_host)),
                  "germline reduction differs from the numpy host path")
            h1_cnt, n_ps = got[0], got[2]
        else:
            check(list(got) == list(ref) and all(
                np.array_equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype
                for k in got), f"somatic {mode} reduction differs cuda/cpu")
            diff = [k for k, v in on_host.items()
                    if not np.array_equal(got[k], v)]
            check(not diff, f"somatic {mode} reduction differs from the "
                  f"numpy host path in {diff}")
            h1_cnt, n_ps = got["h1_cnt"], got["n_ps"]
        check(h1_cnt.sum() > 0 and n_ps.max() >= 1,
              f"{mode} reduction counted nothing")
        dev_s = best_s(args(mode, dev))
        reduce, in_bytes = on_device(mode)
        kernel_s = best_s(reduce)
        out = reduce()[0]
        # each input tensor read once, each output written once
        nbytes = in_bytes + tensor_bytes(
            *(out if isinstance(out, tuple) else (out,)))
        host_s = best_s(host(mode))
        times[mode] = (1000 * dev_s, 1000 * kernel_s, 1000 * host_s,
                       bound_ms(nbytes), nbytes)
        say(f"phase 5 {mode}: cuda == cpu == host; on the card {1000 * dev_s}"
            f" ms with transfers, {1000 * kernel_s} ms without (bound "
            f"{bound_ms(nbytes)} ms: {nbytes} bytes); host numpy "
            f"{1000 * host_s} ms; torch on the cpu {1000 * cpu_s} ms")

    # crossover: prefixes of the walks (observations are aln-sorted)
    for mode in ("germline", "extract"):
        wk, tabs = (gwalk, gt) if mode == "germline" else (walk, st)
        rows = []
        No = len(wk["obs_var"])
        for size in [n for n in (10_000, 100_000, 1_000_000) if n < No] + [No]:
            A = int(wk["obs_aln"][size - 1]) + 1
            sub = {k: wk[k][:size] for k in wk if k.startswith("obs_")}
            sub["category"] = wk["category"][:A]
            if "mapq" in wk:
                sub["mapq"] = wk["mapq"][:A]
            if mode == "germline":
                on_card = lambda: tk.germline_counts(sub, tabs, True,
                                                     device=dev)
            else:
                g = (sub["mapq"] >= 1)[sub["obs_aln"]]
                on_card = lambda: tk.somatic_counts(
                    sub, tabs, "extract", gate=g, want_posbase=True,
                    device=dev)
            rows.append((size, 1000 * best_s(on_card),
                         1000 * best_s(host(mode, sub, tabs))))
        say(f"phase 5 crossover {mode} (observations, card ms with "
            f"transfers, host ms): {rows}")

    # the somatic batch: the walk cut into three chromosomes by alignment
    items = split_walk(walk, st, gate, is_som, derive, 3)
    batched = {}
    for mode in ("normal", "extract", "haplotag"):
        kw = dict(want_posbase=mode != "haplotag",
                  want_derive=mode == "haplotag", ref_nonempty=True)
        its = [dict(it, gate=None) if mode == "haplotag" else it
               for it in items]

        def single(it, device=dev):
            return tk.somatic_counts(it["walk"], it["t"], mode, device=device,
                                     is_som=it["is_som"],
                                     derive=it["derive"], gate=it["gate"],
                                     **kw)

        got = tk.somatic_counts_batched(its, mode, device=dev, **kw)
        check(all(list(g) == list(r) and all(np.array_equal(g[k], r[k])
                                             for k in r)
                  for g, r in zip(got, map(single, its))),
              f"somatic_counts_batched {mode} differs from the "
              "per-chromosome calls")
        dev_s = best_s(lambda: tk.somatic_counts_batched(its, mode,
                                                         device=dev, **kw))
        per_s = best_s(lambda: [single(it) for it in its])
        cwalk, cgate, ct, sizes = tk.concat_somatic_items(its)
        w = tk.walk_to_device(cwalk, cgate, dev)
        tabs = tk.tables_to_device(ct, tk.SOMATIC_ROWS, dev)
        A = sum(a for a, _s, _n in sizes)
        reduce = lambda: (tk.somatic_reduce(
            w, tabs, A, len(ct["pos"]), mode, kw["want_posbase"],
            kw["want_derive"], True), torch.cuda.synchronize())
        kernel_s = best_s(reduce)
        nbytes = tensor_bytes(*w.values(), *tabs.values(), *reduce()[0])
        batched[mode] = (1000 * dev_s, 1000 * kernel_s, 1000 * per_s,
                         bound_ms(nbytes), nbytes)
        say(f"phase 5 somatic batch {mode}, 3 chromosomes "
            f"({[n for _a, _s, n in sizes]} observations): one batched call "
            f"{1000 * dev_s} ms with transfers, {1000 * kernel_s} ms without "
            f"(bound {bound_ms(nbytes)} ms: {nbytes} bytes), against "
            f"{1000 * per_s} ms for the three per-chromosome calls; equal")
        del w, tabs

    # _k_class on the somatic walk: the gated observations by variant and
    # by one of five classes an alignment (its own generator, so that the
    # later phases draw what they drew before)
    n_cls, S = 5, len(st["pos"])
    cls = np.random.default_rng(SEED + 5).integers(
        0, n_cls, len(walk["category"])).astype(np.int8)
    sel = gate.astype(bool)
    got = tk.class_counts(walk, sel, cls, S, n_cls, device=dev)

    def on_host():
        v, a = walk["obs_var"][sel], walk["obs_aln"][sel]
        return np.bincount(v.astype(np.int64) * n_cls + cls[a],
                           minlength=S * n_cls).reshape(S, n_cls)

    check(np.array_equal(got, tk.class_counts(walk, sel, cls, S, n_cls,
                                              device="cpu"))
          and np.array_equal(got, on_host()) and got.sum() == sel.sum(),
          "class_counts differs cuda/cpu/host")
    dev_s = best_s(lambda: tk.class_counts(walk, sel, cls, S, n_cls,
                                           device=dev))
    inputs = [torch.from_numpy(np.asarray(x)).to(dev)
              for x in (walk["obs_var"], walk["obs_aln"], sel, cls)]
    kernel_s = best_s(lambda: (tk.class_reduce(*inputs, S, n_cls),
                               torch.cuda.synchronize()))
    host_s = best_s(on_host)
    # the variant and alignment indices, the selection and the classes in
    # once, the int64 [S, n_cls] counts out once
    nbytes = tensor_bytes(*inputs) + S * n_cls * 8
    klass = dict(ms=1000 * dev_s, ms_without_transfers=1000 * kernel_s,
                 host_ms=1000 * host_s, bound_ms=bound_ms(nbytes),
                 bytes=nbytes, observations=len(sel), selected=int(sel.sum()),
                 n_cls=n_cls)
    say(f"phase 5 class_counts (_k_class), {int(sel.sum())} of {len(sel)} "
        f"observations selected, {n_cls} classes: cuda == cpu == host; on "
        f"the card {1000 * dev_s} ms with transfers, {1000 * kernel_s} ms "
        f"without (bound {bound_ms(nbytes)} ms: {nbytes} bytes); host numpy "
        f"{1000 * host_s} ms")
    del inputs
    return times, batched, items, klass


def split_walk(walk, t, gate, is_som, derive, parts: int):
    """Phase 5's somatic walk as ``parts`` chromosomes for
    ``somatic_counts_batched``: consecutive runs of alignments, each with
    the variants its observations reach (neighbours overlap at the cuts)
    and its own indices."""
    import numpy as np

    A = len(walk["category"])
    items = []
    for k in range(parts):
        a0, a1 = A * k // parts, A * (k + 1) // parts
        o0, o1 = np.searchsorted(walk["obs_aln"], [a0, a1])
        var = walk["obs_var"][o0:o1]
        v0, v1 = int(var.min()), int(var.max()) + 1
        w = {key: walk[key][o0:o1] for key in walk if key.startswith("obs_")}
        w["obs_var"] = var - v0
        w["obs_aln"] = w["obs_aln"] - a0
        w["category"], w["mapq"] = walk["category"][a0:a1], walk["mapq"][a0:a1]
        items.append({"walk": w, "t": {key: v[v0:v1] for key, v in t.items()},
                      "is_som": is_som[v0:v1], "derive": derive[v0:v1],
                      "gate": gate[o0:o1]})
    return items


def _tags(bam_path):
    from longphase_s_tpu_torch.io.bam import BamReader

    r = BamReader(bam_path)
    out = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
            rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
    r.close()
    return out


def _vcf_body(prefix):
    """``prefix.vcf`` without its ``##longphase`` and ``##commandline``
    lines, the ones that name the program and its arguments."""
    with open(prefix + ".vcf") as f:
        return [line for line in f
                if not line.startswith(("##longphase", "##commandline"))]


def _text(path):
    """The lines of ``path`` but its ``##commandline``; it must exist."""
    check(os.path.exists(path), f"{path} was not written")
    with open(path) as f:
        return [line for line in f if not line.startswith("##commandline")]


def _run_engines(label, argv, prefix, reductions, outputs):
    """``cli`` with the device engine on ``cuda``, then with the host
    engine; the device-call counts from the device run must cover
    ``reductions``; returns the two walls and the device-call counts."""
    from longphase_s_tpu_torch import cli
    from longphase_s_tpu_torch.ops import tag_kernels as tk

    walls, results = {}, {}
    for engine in ("device", "host"):
        os.environ["LPS_TAG_ENGINE"] = engine
        tk.reset_device_calls()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", f"{prefix}_{engine}", "--device", "cuda"])
        walls[engine] = time.perf_counter() - t0
        calls = dict(tk.DEVICE_CALLS)
        check(rc == 0, f"cli {label} ({engine} engine) returned {rc}")
        results[engine] = outputs(f"{prefix}_{engine}")
        if engine == "device":
            device_calls = calls
            for name in reductions:
                check(calls[name] > 0, f"cli {label} never ran the {name} "
                      "reduction on the card")
        else:
            check(not any(calls.values()), f"cli {label} host engine ran "
                  "on the card")
    os.environ.pop("LPS_TAG_ENGINE")
    check(results["device"] == results["host"],
          f"cli {label}: device and host engines differ")
    return walls, device_calls, results["device"]


def phase6_tag_pipelines(workdir: str, fixtures, phase4_fx,
                         phase4_vcf) -> dict:
    from longphase_s_tpu_torch import cli

    calls = {}

    def add_calls(c):
        for name, n in c.items():
            calls[name] = calls.get(name, 0) + n

    walls, c, tags = _run_engines(
        "haplotag", ["haplotag", "-s", phase4_vcf, "-b", phase4_fx["bam"],
                     "-r", phase4_fx["fasta"]],
        os.path.join(workdir, "hap"), ["germline"],
        lambda p: _tags(p + ".bam"))
    add_calls(c)
    n_tagged = sum(t[3] is not None for t in tags)
    check(n_tagged > 1000, f"haplotag tagged only {n_tagged} records")
    say(f"phase 6 haplotag on phase 4's fixture: device engine {walls['device']}"
        f" s, host engine {walls['host']} s, HP/PS/PQ of {len(tags)} records "
        f"equal ({n_tagged} tagged); device calls {c}")

    fx = fixtures.get("som")
    phased = os.path.join(workdir, "som_phased")
    t0 = time.perf_counter()
    rc = cli.main(["phase", "--pb", "-s", fx["normal_vcf"], "-b",
                   fx["normal_bam"], "-r", fx["fasta"], "-o", phased,
                   "--device", "cuda"])
    check(rc == 0, f"cli phase of the normal sample returned {rc}")
    say(f"phase 6 cli phase of the normal sample: {time.perf_counter() - t0}"
        " s")
    pair = ["-s", phased + ".vcf", "--tumor-snv-file", fx["tumor_vcf"], "-b",
            fx["normal_bam"], "--tumor-bam-file", fx["tumor_bam"], "-r",
            fx["fasta"]]

    def purity(lines):
        value = float(lines[-1].rsplit(":", 1)[1])
        check(value > 0, f"purity {value} is not above 0")
        return value

    walls, c, (tags, sc, pur) = _run_engines(
        "somatic_haplotag", ["somatic_haplotag", *pair, "--output-somatic-vcf"],
        os.path.join(workdir, "somatic"),
        ["somatic_normal", "somatic_extract", "somatic_haplotag"],
        lambda p: (_tags(p + ".bam"), _text(p + "_sc.vcf"),
                   _text(p + "_purity.out")))
    add_calls(c)
    n_somatic = sum(line.split("	")[6] == "PASS" for line in sc
                    if not line.startswith("#"))
    check(n_somatic > 0, "no somatic call passed")
    say(f"phase 6 somatic_haplotag: device engine {walls['device']} s, host "
        f"engine {walls['host']} s; tags of {len(tags)} records, _sc.vcf "
        f"({n_somatic} PASS) and _purity.out (purity {purity(pur)}) equal; "
        f"device calls {c}")
    walls, c, pur = _run_engines(
        "estimate_purity", ["estimate_purity", *pair],
        os.path.join(workdir, "purity"),
        ["somatic_normal", "somatic_extract"],
        lambda p: _text(p + "_purity.out"))
    say(f"phase 6 estimate_purity: device engine {walls['device']} s, host "
        f"engine {walls['host']} s; _purity.out equal (purity "
        f"{purity(pur)}); device calls {c}")
    return calls


def synthetic_modcall_events(rng, n_snps: int = 319_951, n_cpg: int = 16_000,
                             length: int = 64_000_000, coverage: int = 30,
                             read_len: int = 15_000):
    """The filtered event stream of ``models/modcall_fast.py`` at the scale
    of phase 5's 64 Mbp chromosome, in read order as ``lps_modcall_walk``
    emits it: ``n_snps`` het SNPs and ``n_cpg`` het-methylated CpG pairs
    (each pair's events on its + position, as the genotype judge moves the
    - strand's), reads of ``read_len`` at ``coverage`` that report 97% of
    the SNPs and 90% of the CpGs they cover (the rest are noise), SNP
    alleles from the read's haplotype and CpG alleles (0 modified, 1
    canonical) from the methylated haplotype, with 3% and 5% errors.
    Returns (f_pos, f_allele, f_vtype, f_read)."""
    import numpy as np

    snp = np.sort(rng.choice(length, n_snps, replace=False))
    cand = rng.choice(length - 1, 2 * n_cpg, replace=False)
    cand = cand[~np.isin(cand, snp) & ~np.isin(cand + 1, snp)]
    sites = np.concatenate([snp, np.sort(cand[:n_cpg])])
    order = np.argsort(sites, kind="stable")
    sites = sites[order].astype(np.int64)
    vtype = np.concatenate([np.ones(n_snps, np.uint8),
                            np.zeros(n_cpg, np.uint8)])[order]
    site_hap = rng.integers(0, 2, len(sites))
    A = length * coverage // read_len
    starts = np.sort(rng.integers(0, length - read_len, A))
    lo = np.searchsorted(sites, starts)
    n = np.searchsorted(sites, starts + read_len) - lo
    total = int(n.sum())
    site = np.repeat(lo, n) + (np.arange(total) - np.repeat(np.cumsum(n) - n,
                                                            n))
    read = np.repeat(np.arange(A, dtype=np.int64), n)
    vt = vtype[site]
    keep = rng.random(total) < np.where(vt == 1, 0.97, 0.90)
    err = rng.random(total) < np.where(vt == 1, 0.03, 0.05)
    allele = (site_hap[site] ^ rng.integers(0, 2, A)[read] ^ err) \
        .astype(np.int64)
    return sites[site][keep], allele[keep], vt[keep], read[keep]


def modcall_split(run):
    """Wall seconds of ``run()`` and the seconds spent in each stage of the
    modcall fast path: the native walk, the edge counts (either engine)
    and the graph's connect pass; the rest is the genotype judge, the
    export and the VCF write."""
    from longphase_s_tpu_torch import native
    from longphase_s_tpu_torch.models import modcall, modcall_fast
    from longphase_s_tpu_torch.ops import tag_kernels as tk

    spent = {}
    stages = ((native.NativeBam, "modcall_walk", "native walk"),
              (tk, "modcall_edges", "edge counts"),
              (modcall_fast, "modcall_edges_host", "edge counts"),
              (modcall.MethylationGraph, "connect_results", "connect pass"))
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in stages]

    def timed(fn, stage):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[stage] = spent.get(stage, 0.0) + time.perf_counter() - t0
        return wrapper

    for (owner, name, stage), (_, _, fn) in zip(stages, saved):
        setattr(owner, name, timed(fn, stage))
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    spent["rest"] = wall - sum(spent.values())
    return wall, spent


def phase7_modcall(rng, dev, workdir: str, fixtures) -> dict:
    import numpy as np
    import torch

    from longphase_s_tpu_torch import cli
    from longphase_s_tpu_torch.models.modcall_fast import modcall_edges_host
    from longphase_s_tpu_torch.ops import tag_kernels as tk
    t0 = time.perf_counter()
    ev = synthetic_modcall_events(rng)
    E = len(ev[0])
    say(f"phase 7 inputs: {E} events ({int((ev[2] == 1).sum())} SNP, "
        f"{int((ev[2] == 0).sum())} MOD) of {int(ev[3][-1]) + 1} reads, "
        f"built in {time.perf_counter() - t0:.3f} s")

    def same(a, b):
        return all(x.dtype == y.dtype and np.array_equal(x, y)
                   for x, y in zip(a, b))

    got = tk.modcall_edges(*ev, device=dev)
    t0 = time.perf_counter()
    host = modcall_edges_host(*ev)
    host_ms = 1000 * (time.perf_counter() - t0)
    check(same(got, host), "modcall_edges on cuda differs from the numpy "
          "host path at chromosome scale")
    pairs, unique = int(got[2].sum()), len(got[0])
    check(unique > 0 and pairs > E, f"only {pairs} pairs, {unique} edges")
    m = 1_000_000
    prefix = tuple(x[:m] for x in ev)
    check(same(tk.modcall_edges(*prefix, device=dev),
               tk.modcall_edges(*prefix, device="cpu")),
          f"modcall_edges differs cuda/cpu on the first {m} events")
    dev_ms = 1000 * best_s(lambda: tk.modcall_edges(*ev, device=dev))
    on_card = tk.events_to_device(*ev, dev)
    kernel_ms = 1000 * best_s(lambda: (tk.modcall_edge_reduce(on_card),
                                       torch.cuda.synchronize()))
    # the call with transfers, split: the numpy packing of the events, the
    # upload, the reduction and the download of the edges
    edges = tk.modcall_edge_reduce(on_card)
    pack_ms = 1000 * best_s(lambda: tk.events_to_device(*ev, "cpu"))
    upload_ms = 1000 * best_s(lambda: (tk.events_to_device(*ev, dev),
                                       torch.cuda.synchronize())) - pack_ms
    download_ms = 1000 * best_s(lambda: edges.cpu())
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        tk.modcall_edge_reduce(on_card)
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_device_time_total / 1000, e.count)
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda r: -r[1])[:8]
    say(f"phase 7 modcall_edges split (ms): packing {pack_ms}, upload "
        f"{upload_ms}, reduction {kernel_ms}, download {download_ms}; the "
        f"reduction's ops by device time (op, ms, calls): {ops}")
    del on_card, edges
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tk.modcall_edges(*ev, device=dev)
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
    # the int64 [3, E] events in, the int64 [3, U] edges out
    nbytes = 3 * 8 * E + 3 * 8 * unique
    say(f"phase 7 modcall_edges: cuda == host numpy ({E} events), cuda == "
        f"cpu on the first {m}; {pairs} pairs, {unique} unique edges; on the "
        f"card {dev_ms} ms with transfers, {kernel_ms} ms without (bound "
        f"{bound_ms(nbytes)} ms: {nbytes} bytes); host numpy {host_ms} ms; "
        f"peak device memory {peak_mb} MB above what it found")

    rows = []
    for size in (1_000, 10_000, 100_000, 1_000_000):
        sub = tuple(x[:size] for x in ev)
        rows.append((size, 1000 * best_s(
            lambda: tk.modcall_edges(*sub, device=dev)),
            1000 * best_s(lambda: modcall_edges_host(*sub),
                          3 if size < m else 1)))
    rows.append((E, dev_ms, host_ms))
    say(f"phase 7 crossover (events, card ms with transfers, host ms): "
        f"{rows}; the engine gate sends a chromosome to the device from "
        f"{tk.device_min() // 8} events")

    fx = fixtures.get("meth")

    def body(prefix):
        lines = _vcf_body(prefix)
        check(any(not line.startswith("#") for line in lines),
              f"{prefix}.vcf has no record")
        return lines

    calls = 0
    for label, argv in (
            ("modcall", ["-s", fx["vcf"]]),
            ("modcall --all", ["--all"])):
        walls, c, vcf = _run_engines(
            label, ["modcall", "-b", fx["bam"], "-r", fx["fasta"], *argv],
            os.path.join(workdir, label.replace(" --", "_")),
            ["modcall_edges"], body)
        calls += c["modcall_edges"]
        say(f"phase 7 cli {label}: device engine {walls['device']} s, host "
            f"engine {walls['host']} s; VCFs equal "
            f"({sum(not line.startswith('#') for line in vcf)} records); "
            f"device calls {c}")
    argv = ["modcall", "-b", fx["bam"], "-r", fx["fasta"], "-s", fx["vcf"],
            "--device", "cuda"]
    for engine in ("device", "host"):
        os.environ["LPS_TAG_ENGINE"] = engine
        prefix = os.path.join(workdir, f"split_{engine}")
        wall, spent = modcall_split(
            lambda: check(cli.main(argv + ["-o", prefix]) == 0,
                          "cli modcall returned non-zero"))
        say(f"phase 7 cli modcall time split, {engine} engine: wall {wall} s;"
            f" {spent}")
    os.environ.pop("LPS_TAG_ENGINE")
    return dict(ms=dev_ms, ms_without_transfers=kernel_ms, host_ms=host_ms,
                bound_ms=bound_ms(nbytes), bytes=nbytes, calls=calls,
                peak_mb=peak_mb, events=E, pairs=pairs, unique=unique)


def genome_entries(rng, spacing: int = 1500, coverage: int = 30,
                   sites_per_read: int = 10):
    """Merged-stream entries (as ``core/fastpath`` defers them) for
    GRCh38's chr1-22 and X: a het site every ``spacing`` bp on average,
    reads of about ``sites_per_read`` sites at ``coverage`` (phase 3's
    ``synthetic_stream``, read ids from 0 in every chromosome), one
    alignment a read."""
    entries = []
    for chrom, length in GRCH38:
        S = length // spacing
        read, rank, allele, qok, n_reads = synthetic_stream(
            rng, S, coverage=coverage, sites_per_read=sites_per_read)
        positions, vtype = synthetic_sites(rng, S, max_gap=2 * spacing)
        entries.append({"chrom": chrom, "positions": positions,
                        "vtype": vtype, "m_read": read, "m_rank": rank,
                        "m_allele": allele, "m_qok": qok, "m_aln": read,
                        "n_aln": n_reads})
    return entries


def same_phase(a, b) -> bool:
    """Two lists of (ps, ori) numpy pairs are equal, dtypes included."""
    import numpy as np

    return all(np.array_equal(ps, ps1) and np.array_equal(ori, ori1)
               and ps.dtype == ps1.dtype and ori.dtype == ori1.dtype
               for (ps, ori), (ps1, ori1) in zip(a, b)) and len(a) == len(b)


def batch_split(entries, params, dev):
    """The batched step (``ops/fused.run_fused_phase_batch``) stage by
    stage, the card synchronized after each: host seconds of the packing
    (``concat_entries``), the upload of the stream, that of its alignment
    ids, the pair stage, the segmented serial pass, the assembly, the read
    correction and the download; the outputs, the scan's inputs and the
    correction's (the uncorrected ps and ori first)."""
    import torch

    from longphase_s_tpu_torch.ops import cuda_scan, fused

    W = params.connect_adjacent
    spent = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        spent[name] = now - t0
        t0 = now

    batch = fused.concat_entries(entries)
    seg = batch["seg"]
    S = int(seg[-1])
    lap("packing")
    stream = fused.stream_to_device(batch["m_read"], batch["m_rank"],
                                    batch["m_allele"], batch["m_qok"], dev)
    pos, vt, gap = (torch.from_numpy(batch[k]).to(dev)
                    for k in ("positions", "vtype", "gap"))
    lap("upload")
    aln = torch.from_numpy(batch["m_aln"]).to(dev)
    lap("upload m_aln")
    codes, site = fused.pair_codes(stream, gap, vt, S, W, params.distance,
                                   params.edge_threshold * 10.0)
    lap("pair stage")
    assigned, hp, bstart = cuda_scan.vote_serial_segments(codes, site, seg, W)
    lap("scan")
    ps0, ori0 = fused.device_assemble_blocks(assigned, hp, bstart, pos, S,
                                             seg)
    lap("assembly")
    ps, ori = fused.device_read_correction(
        ps0, ori0, vt, stream[1], stream[2], aln, batch["A_tot"],
        params.read_confidence, params.snp_confidence)
    lap("read correction")
    ps, ori = ps.cpu().numpy(), ori.cpu().numpy()
    lap("download")
    out = [(ps[a:z], ori[a:z]) for a, z in zip(seg, seg[1:])]
    return spent, out, (codes, site, seg, (assigned, hp, bstart)), (
        ps0, ori0, vt, stream[1], stream[2], aln, batch["A_tot"])


def phase8_genome(rng, dev, workdir: str, fixtures) -> dict:
    import numpy as np
    import torch

    from longphase_s_tpu_torch import cli
    from longphase_s_tpu_torch.core.phase_algo import PhaseParams
    from longphase_s_tpu_torch.ops import _build, cuda_scan, fused
    from longphase_s_tpu_torch.ops import tag_kernels as tk
    from longphase_s_tpu_torch.parallel.multichip import \
        run_fused_phase_multichip

    t0 = time.perf_counter()
    entries = genome_entries(rng)
    sizes = [len(e["positions"]) for e in entries]
    S_tot, n_obs = sum(sizes), sum(len(e["m_read"]) for e in entries)
    say(f"phase 8 inputs: {len(entries)} chromosomes, {S_tot} sites "
        f"(chr1 {sizes[0]}), {n_obs} observations, built in "
        f"{time.perf_counter() - t0:.3f} s")
    # once, for phase 10's processes (m_aln is m_read: a read a alignment)
    npz = os.path.join(workdir, "genome.npz")
    t0 = time.perf_counter()
    np.savez(npz, chroms=np.array([e["chrom"] for e in entries]),
             **{f"{e['chrom']}/{k}": e[k] for e in entries
                for k in GENOME_KEYS + ("n_aln",)})
    say(f"phase 8 genome written for phase 10: {os.path.getsize(npz)} bytes "
        f"in {time.perf_counter() - t0:.3f} s")
    subset = slice(18, 22)  # chr19-22
    out = {}
    for window in (W, 100):
        params = PhaseParams(connect_adjacent=window)
        run_fused_phase_multichip(entries, params, dev)  # warm-up
        _build.reset_launches()
        t0 = time.perf_counter()
        batched = run_fused_phase_multichip(entries, params, dev)
        walls = [time.perf_counter() - t0]
        launches = dict(_build.LAUNCHES)
        check(all(launches[k] == 1 for k in FLAT_PATH)
              and launches["vote_cast"] == 0,
              f"the genome's batch did not launch each flat-path kernel "
              f"once: {launches}")
        t0 = time.perf_counter()
        check(same_phase(run_fused_phase_multichip(entries, params, dev),
                         batched), "the batched step differs between runs")
        walls.append(time.perf_counter() - t0)

        def per_chromosome():
            return [fused.run_fused_phase(
                e["m_read"], e["m_rank"], e["m_allele"], e["m_qok"],
                e["m_aln"], e["positions"], e["vtype"], e["n_aln"], params,
                dev) for e in entries]

        single_walls = []
        for _ in range(2 if window == W else 1):
            t0 = time.perf_counter()
            single = per_chromosome()
            single_walls.append(time.perf_counter() - t0)
        check(same_phase(batched, single), f"W={window}: the batched step "
              "differs from the per-chromosome steps")
        n_phased = sum(int((ps != 0).sum()) for ps, _ in batched)
        check(n_phased > S_tot // 2, f"only {n_phased} of {S_tot} phased")
        if window == W:
            out["batched"], out["batched_walls"] = batched, walls

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        spent, split_out, (codes, site, seg, scan), correction = batch_split(
            entries, params, dev)
        peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
        check(same_phase(split_out, batched), "the split run differs")
        # the correction on the card against the host's, a chromosome each
        (rc_ps, _rc_ori), rc_ms, rc_mb, rc_bound = correction_on_card(
            *correction, params)
        host, host_s = host_correction(entries, seg,
                                       correction[0].cpu().numpy(),
                                       correction[1].cpu().numpy(), params)
        check(all(np.array_equal(ps, h_ps) and np.array_equal(ori, h_ori)
                  for (ps, ori), (h_ps, h_ori) in zip(batched, host)),
              f"W={window}: the read correction on the card differs from "
              "the host's")
        erased = int(((correction[0] != 0) & (rc_ps == 0)).sum())
        out[f"correction_{window}"] = dict(
            ms=rc_ms, host_ms=1000 * host_s, bound=rc_bound, peak_mb=rc_mb,
            err=0, observations=n_obs, sites=S_tot)
        del correction, rc_ps, _rc_ori
        seg_ms = cuda_ms(lambda: cuda_scan.vote_serial_segments(
            codes, site, seg, window), 3)
        chrom_ms = []
        for e in entries:
            S = len(e["positions"])
            stream = fused.stream_to_device(e["m_read"], e["m_rank"],
                                            e["m_allele"], e["m_qok"], dev)
            gap = torch.from_numpy(fused.site_gaps(e["positions"])).to(dev)
            vt = torch.from_numpy(e["vtype"]).to(dev)
            c, w = fused.pair_codes(stream, gap, vt, S, window,
                                    params.distance,
                                    params.edge_threshold * 10.0)
            chrom_ms.append(cuda_ms(
                lambda: cuda_scan.vote_serial(c, w, S, window), 3))
            del stream, c, w

        # the segmented kernel against its plain version, on the CPU, on a
        # table of the subset's segments (each segment is scanned alone)
        sub = slice(18, 22) if window == W else slice(20, 22)
        a, z = int(seg[sub.start]), int(seg[sub.stop])
        sub_seg = [int(x) - a for x in seg[sub.start:sub.stop + 1]]
        t0 = time.perf_counter()
        plain = cuda_scan.vote_serial_segments_plain(
            codes[a:z].cpu(), site[a:z].cpu(), sub_seg, window)
        plain_ms = 1000 * (time.perf_counter() - t0)
        got = [x[a:z].cpu() for x in scan]
        got[2] = torch.where(got[2] >= 0, got[2] - a, got[2])
        err = max_abs_err(got, plain)
        check(err == 0, f"the segmented vote_scan differs from its plain "
              f"version on chromosomes {sub.start + 1}-{sub.stop}, W="
              f"{window}: {err}")
        cpu_s = None
        if window == W:
            t0 = time.perf_counter()
            cpu = run_fused_phase_multichip(entries[subset], params, "cpu")
            cpu_s = time.perf_counter() - t0
            check(same_phase(cpu, batched[subset]), "the batched step on "
                  "cuda differs from the cpu on chr19-22")
        w = cuda_scan.cut_window(S_tot, window)
        out[window] = dict(
            ms=seg_ms, plain_ms=plain_ms, plain_sites=z - a, err=err,
            # the S_tot x w code bytes and site words in; assigned, hp and
            # bstart out
            bound=roofline(S_tot * w + S_tot * 4 + S_tot * 9, 0))
        longest = int(np.argmax(chrom_ms))
        cpu_note = "" if cpu_s is None else \
            f", and to the cpu on chr19-22 in {cpu_s} s"
        say(f"phase 8 genome W={window}: batched step wall {walls} s against "
            f"{single_walls} s for the {len(entries)} per-chromosome steps "
            f"(equal on every chromosome{cpu_note}); {n_phased} sites "
            f"phased; launches {launches}")
        say(f"phase 8 serial pass W={window}: segmented, one launch "
            f"{seg_ms} ms (before the carry: "
            f"{K1_SEGMENTED_BEFORE_CARRY_MS[window]} ms) against "
            f"{sum(chrom_ms)} ms summed over the "
            f"per-chromosome launches (longest {GRCH38[longest][0]} "
            f"{chrom_ms[longest]} ms); its plain version on the cpu over "
            f"{z - a} sites {plain_ms} ms, equal; bound "
            f"{out[window]['bound']}")
        say(f"phase 8 batched step split W={window} (s): {spent}; peak "
            f"device memory {peak_mb} MB above what it found")
        say(f"phase 8 read correction W={window}: on the card {rc_ms} ms "
            f"(bound {rc_bound}, peak device memory {rc_mb} MB; with int64 "
            f"stream tensors {RC_PEAK_INT64_MB[8]} MB) against "
            f"{1000 * host_s} ms for the host's float64 correction a "
            f"chromosome, the stage it replaced; equal on all "
            f"{len(entries)} chromosomes; {erased} sites lost their phase "
            "to it")
        del codes, site, scan

    # the flat-path kernels' bounds on the whole batch at W = 35, what the
    # batched step and each split of it over cards launch between them
    batch = fused.concat_entries(entries)
    stream = fused.stream_to_device(batch["m_read"], batch["m_rank"],
                                    batch["m_allele"], batch["m_qok"], dev)
    n_b = len(batch["m_read"])
    out["flat_bounds"] = flat_bounds(stream, n_b, S_tot, W,
                                     pair_work(stream, S_tot, W))
    total = sum(b for b, _ in out["flat_bounds"].values())
    say(f"phase 8 bounds of the batch's flat-path kernels at W={W} (ms, "
        f"by): {out['flat_bounds']}, {total} ms together")
    del batch, stream

    # the batch through the cli: five chromosomes, LPS_MULTICHIP=1
    fx = fixtures.get("multi")
    argv = ["phase", "--pb", "-s", fx["vcf"], "-b", fx["bam"], "-r",
            fx["fasta"]]

    vcfs, runs = {}, {}
    for label, env, extra in (("batched", "1", ["--device", "cuda"]),
                              ("per-chromosome", "0", ["--device", "cuda"]),
                              ("oracle", "0", ["--engine", "oracle"])):
        os.environ["LPS_MULTICHIP"] = env
        prefix = os.path.join(workdir, f"multi_{env}_{extra[1]}")
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", prefix] + extra)
        runs[label] = (time.perf_counter() - t0, dict(_build.LAUNCHES))
        check(rc == 0, f"cli phase ({label}) returned {rc}")
        vcfs[label] = _vcf_body(prefix)
    os.environ.pop("LPS_MULTICHIP")
    check(vcfs["batched"] == vcfs["oracle"] == vcfs["per-chromosome"],
          "cli phase LPS_MULTICHIP=1 VCF differs from the oracle's or the "
          "per-chromosome run's")
    n_records = sum("|" in line for line in vcfs["batched"])
    check(n_records > 100, f"only {n_records} phased records")
    cli_launches = runs["batched"][1]
    check(all(cli_launches[k] == 1 for k in FLAT_PATH), "cli phase "
          f"LPS_MULTICHIP=1 did not launch each kernel once: {cli_launches}")
    say(f"phase 8 cli phase LPS_MULTICHIP=1 on 5 chromosomes: {n_records} "
        f"phased records, VCF equal to the oracle's and the per-chromosome "
        f"run's; walls and launches {runs}")

    # the somatic batch through the pipeline
    fx = fixtures.get("multi_som")
    phased = os.path.join(workdir, "multi_som_phased")
    check(cli.main(["phase", "--pb", "-s", fx["normal_vcf"], "-b",
                    fx["normal_bam"], "-r", fx["fasta"], "-o", phased,
                    "--device", "cuda"]) == 0, "cli phase of the normal "
          "sample returned non-zero")
    argv = ["somatic_haplotag", "-s", phased + ".vcf", "--tumor-snv-file",
            fx["tumor_vcf"], "-b", fx["normal_bam"], "--tumor-bam-file",
            fx["tumor_bam"], "-r", fx["fasta"], "--output-somatic-vcf",
            "--device", "cuda"]
    os.environ["LPS_TAG_ENGINE"] = "device"
    results, calls = {}, {}
    for env in ("1", "0"):
        os.environ["LPS_MULTICHIP"] = env
        prefix = os.path.join(workdir, f"multi_som_{env}")
        tk.reset_device_calls()
        t0 = time.perf_counter()
        check(cli.main(argv + ["-o", prefix]) == 0,
              f"cli somatic_haplotag LPS_MULTICHIP={env} returned non-zero")
        wall = time.perf_counter() - t0
        calls[env] = (wall, dict(tk.DEVICE_CALLS))
        results[env] = (_tags(prefix + ".bam"), _text(prefix + "_sc.vcf"))
    os.environ.pop("LPS_MULTICHIP")
    os.environ.pop("LPS_TAG_ENGINE")
    check(results["1"] == results["0"], "somatic_haplotag LPS_MULTICHIP=1 "
          "differs from LPS_MULTICHIP=0")
    out["som"] = dict(fx=fx, phased=phased + ".vcf", single=results["0"],
                      wall=calls["0"][0])
    batched_calls = calls["1"][1]
    check(batched_calls["somatic_batched"] == 3 and not any(
        batched_calls[f"somatic_{m}"] for m in ("normal", "extract",
                                                "haplotag")),
          f"somatic_haplotag LPS_MULTICHIP=1 did not batch every pass: "
          f"{batched_calls}")
    say(f"phase 8 somatic_haplotag LPS_MULTICHIP=1 on 3 chromosomes: tags of "
        f"{len(results['1'][0])} records and _sc.vcf equal to "
        f"LPS_MULTICHIP=0; walls and device calls {calls}")
    out["cli_launches"] = cli_launches["vote_scan"]
    out["entries"], out["oracle_vcf"] = entries, vcfs["oracle"]
    out["npz"], out["multi_walls"] = npz, {k: v[0] for k, v in runs.items()}
    return out


def phase9_carry(dev, workdir: str, fixtures, genome) -> dict:
    """The carry contract on the card (see the module docstring)."""
    import numpy as np
    import torch

    from longphase_s_tpu_torch import cli
    from longphase_s_tpu_torch.core.phase_algo import PhaseParams
    from longphase_s_tpu_torch.ops import _build, cuda_scan, fused
    from longphase_s_tpu_torch.parallel.multichip import \
        run_fused_phase_wavefront
    from longphase_s_tpu_torch.parallel.sharded_scan import (
        block_bounds, sharded_vote_scan)

    params = PhaseParams()
    entries = genome["entries"]
    e = entries[0]  # chr1
    S = len(e["positions"])
    stream = fused.stream_to_device(e["m_read"], e["m_rank"], e["m_allele"],
                                    e["m_qok"], dev)
    gap = torch.from_numpy(fused.site_gaps(e["positions"])).to(dev)
    vt = torch.from_numpy(e["vtype"]).to(dev)
    codes, site = fused.pair_codes(stream, gap, vt, S, W, params.distance,
                                   params.edge_threshold * 10.0)
    del stream
    whole = cuda_scan.vote_serial(codes, site, S, W)
    whole_ms = cuda_ms(lambda: cuda_scan.vote_serial(codes, site, S, W), 3)
    sharded_ms = {}
    for n in (2, 4, 8):
        err = max_abs_err(sharded_vote_scan([dev] * n, codes, site, W),
                          whole)
        check(err == 0, f"chr1 cut into {n} blocks differs from the whole "
              f"scan: {err}")
        sharded_ms[n] = cuda_ms(
            lambda: sharded_vote_scan([dev] * n, codes, site, W), 3)
    say(f"phase 9 chr1 ({S} sites, W={W}) by sharded_vote_scan on {dev}: "
        f"{sharded_ms} ms for 2, 4 and 8 blocks against {whole_ms} ms whole; "
        "equal")

    # the four blocks' carry launches against the plain chain on the cpu
    n_blocks = 4
    cpu_codes, cpu_site = codes.cpu(), site.cpu()
    carry = ref_carry = None
    err, plain_s = 0, 0.0
    for a, z in block_bounds(S, n_blocks):
        *got, carry = cuda_scan.vote_serial_segments(
            codes[a:z], site[a:z], (0, z - a), W, carry, True, a)
        t0 = time.perf_counter()
        *ref, ref_carry = cuda_scan.vote_serial_segments_plain(
            cpu_codes[a:z], cpu_site[a:z], (0, z - a), W, ref_carry, True, a)
        plain_s += time.perf_counter() - t0
        err = max(err, max_abs_err([g.cpu() for g in (*got, carry)],
                                   (*ref, ref_carry)))
    check(err == 0, f"the carry launches differ from the plain chain: {err}")
    w = cuda_scan.cut_window(S, W)
    # codes and site words in, the outputs out, a carry in and out a block
    bound = roofline(S * w + S * 4 + S * 9 + n_blocks * 2 * 4 * (5 * W + 2),
                     0)
    say(f"phase 9 carry launches: chr1 in {n_blocks} blocks on the card "
        f"{sharded_ms[n_blocks]} ms (bound {bound}); the plain chain on the "
        f"cpu {1000 * plain_s} ms; equal, carries included")

    # the wavefront over the genome, four blocks a chromosome on one card
    t0 = time.perf_counter()
    wave = run_fused_phase_wavefront(entries, params, [dev] * n_blocks)
    wave_s = time.perf_counter() - t0
    check(same_phase(wave, genome["batched"]), "the wavefront differs from "
          "phase 8's batch")
    say(f"phase 9 wavefront: {len(entries)} chromosomes x {n_blocks} blocks "
        f"on {dev} in {wave_s} s; equal to phase 8's batch")

    # cli phase with LPS_WAVEFRONT=1 on the 5-chromosome fixture
    fx = fixtures.get("multi")
    prefix = os.path.join(workdir, "multi_wavefront")
    os.environ["LPS_MULTICHIP"] = "1"
    os.environ["LPS_WAVEFRONT"] = "1"
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["phase", "--pb", "-s", fx["vcf"], "-b", fx["bam"],
                       "-r", fx["fasta"], "-o", prefix, "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        os.environ.pop("LPS_MULTICHIP")
        os.environ.pop("LPS_WAVEFRONT")
    check(rc == 0, f"cli phase LPS_WAVEFRONT=1 returned {rc}")
    check(_vcf_body(prefix) == genome["oracle_vcf"], "cli phase "
          "LPS_WAVEFRONT=1 VCF differs from the oracle's")
    check(launches["vote_scan_carry"] > 0 and launches["vote_scan"] == 0
          and all(launches[k] == 1 for k in FLAT_PATH if k != "vote_scan"),
          f"cli phase LPS_WAVEFRONT=1 did not run the wavefront: {launches}")
    say(f"phase 9 cli phase LPS_WAVEFRONT=1 on 5 chromosomes: {cli_s} s, VCF "
        f"equal to the oracle's; launches {launches}")
    return dict(ms=sharded_ms[n_blocks], plain_ms=1000 * plain_s, err=err,
                bound=bound, launches=launches["vote_scan_carry"])


# phase 10 (a): one process of the group on its shard of phase 8's genome
GENOME_WORKER = """
import json, sys, time
t0 = time.perf_counter()
import numpy as np
from longphase_s_tpu_torch.core.fastpath import phased_records
from longphase_s_tpu_torch.core.phase_algo import PhaseParams
from longphase_s_tpu_torch.ops import _build
from longphase_s_tpu_torch.parallel import distributed as dist
from longphase_s_tpu_torch.parallel.multichip import run_fused_phase_multichip
from longphase_s_tpu_torch.utils.device import resolve_device
npz, window, out_path, keys, spec = sys.argv[1:]
dist.init_from_spec(spec)
dev = resolve_device(dist.local_device("cuda"))
z = np.load(npz)
entries = []
for c in dist.shard_contigs([str(c) for c in z["chroms"]]):
    e = {k: z[f"{c}/{k}"] for k in keys.split(",")}
    e.update(chrom=c, m_aln=e["m_read"], n_aln=int(z[f"{c}/n_aln"]))
    entries.append(e)
load_s = time.perf_counter() - t0
params = PhaseParams(connect_adjacent=int(window))
run_fused_phase_multichip(entries, params, dev)  # warm-up
_build.reset_launches()
t1 = time.perf_counter()
outs = run_fused_phase_multichip(entries, params, dev)
step_s = time.perf_counter() - t1
launches = dict(_build.LAUNCHES)
t1 = time.perf_counter()
results = {e["chrom"]: phased_records(e["chrom"], e["positions"], ps, ori)
           for e, (ps, ori) in zip(entries, outs)}
records_s = time.perf_counter() - t1
t1 = time.perf_counter()
merged = dist.merge_chr_results(results)
merge_s = time.perf_counter() - t1
if dist.is_writer():
    with open(out_path, "w") as f:
        json.dump(merged, f)
print("LPS_PROCESS_REPORT " + json.dumps({
    "pid": dist.process_id(), "device": str(dev),
    "chroms": [e["chrom"] for e in entries],
    "sites": sum(len(e["positions"]) for e in entries),
    "phased": sum(len(r) for r in results.values()),
    "load_s": load_s, "step_s": step_s, "records_s": records_s,
    "merge_s": merge_s, "gathered": dict(dist.GATHERED),
    "launches": launches, "wall": time.perf_counter() - t0,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "longphase_s_tpu"))}),
      flush=True)
"""


def phase10_processes(workdir: str, fixtures, genome) -> dict:
    """Processes sharing the card (see the module docstring)."""
    from longphase_s_tpu_torch import cli
    from longphase_s_tpu_torch.core.fastpath import phased_records
    from longphase_s_tpu_torch.testing import processes

    timeout = 300
    out = {}

    def check_reports(label, reports, nprocs):
        check(len(reports) == nprocs and all(
            r["device"] == ("cuda:0" if nprocs > 1 else "cuda")
            and not r["leaked"] for r in reports),
            f"{label}: a process ran elsewhere than its card or imported "
            f"JAX: {reports}")

    # (a) the genome through the collectives
    merged_path = os.path.join(workdir, "genome_merged.json")
    spec = f"127.0.0.1:{processes.free_port()},2"
    t0 = time.perf_counter()
    reports = processes.reports(processes.finish(processes.start(
        GENOME_WORKER, [[genome["npz"], str(W), merged_path,
                         ",".join(GENOME_KEYS), f"{spec},{pid}"]
                        for pid in range(2)], ROOT), timeout))
    wall = time.perf_counter() - t0
    check(all(r["device"] == "cuda:0" and not r["leaked"] for r in reports)
          and all(r["launches"][k] == 1 for r in reports for k in FLAT_PATH),
          f"phase 10 genome: a process did not launch each flat-path kernel "
          f"once on its card: {reports}")
    with open(merged_path) as f:
        merged = {c: {k: (v[0], v[1]) for k, v in d.items()}
                  for c, d in json.load(f).items()}
    want = {e["chrom"]: phased_records(e["chrom"], e["positions"], ps, ori)
            for e, (ps, ori) in zip(genome["entries"], genome["batched"])}
    check(merged == want, "phase 10 genome: the merged result of 2 "
          "processes differs from phase 8's batch")
    n_sites = sum(len(d) for d in merged.values())
    steps = [r["step_s"] for r in reports]
    moved = [(r["gathered"]["sent"], r["gathered"]["received"])
             for r in reports]
    say(f"phase 10 genome in 2 processes on one card: merged {n_sites} "
        f"phased sites equal to phase 8's batch (W={W}); step walls {steps} "
        f"s (sum {sum(steps)}) against phase 8's batched step "
        f"{genome['batched_walls']} s; record dicts "
        f"{[r['records_s'] for r in reports]} s, merge "
        f"{[r['merge_s'] for r in reports]} s (in the gather "
        f"{[r['gathered']['seconds'] for r in reports]} s, the rest JSON), "
        f"bytes sent / received a rank {moved}; start and load "
        f"{[r['load_s'] for r in reports]} s, process walls "
        f"{[r['wall'] for r in reports]} s, {wall} s in all")
    out["genome"] = reports

    # (b) cli phase in 1, 2 and 4 processes, then the checkpointed batch
    fx = fixtures.get("multi")
    argv = ["phase", "--pb", "-s", fx["vcf"], "-b", fx["bam"], "-r",
            fx["fasta"], "--device", "cuda"]
    walls = {}
    for n in (1, 2, 4):
        prefix = os.path.join(workdir, f"dist_phase_{n}")
        reports = processes.run_cli(argv + ["-o", prefix], n, ROOT,
                                    timeout=timeout)
        check_reports(f"cli phase in {n} processes", reports, n)
        check(_vcf_body(prefix) == genome["oracle_vcf"],
              f"cli phase in {n} processes: VCF differs from phase 8's")
        check(all(r["launches"][k] > 0 for r in reports for k in FLAT_PATH),
              f"cli phase in {n} processes: a process launched no flat-path "
              f"kernel: {[r['launches'] for r in reports]}")
        walls[n] = [r["wall"] for r in reports]
        out[f"phase_{n}"] = reports
    say(f"phase 10 cli phase on 5 chromosomes: VCF equal to phase 8's in 1, "
        f"2 and 4 processes; process walls {walls} s (phase 8 in-process: "
        f"{genome['multi_walls']} s); launches "
        f"{[[r['launches'][k] for k in FLAT_PATH] for r in out['phase_2']]} "
        f"(2 processes), "
        f"{[[r['launches'][k] for k in FLAT_PATH] for r in out['phase_4']]} "
        f"(4 processes) of {FLAT_PATH}")
    prefix = os.path.join(workdir, "dist_ckpt")
    argv_ckpt = argv + ["-o", prefix, "--checkpoint", prefix + "_d"]
    env = dict(os.environ, LPS_MULTICHIP="1")
    runs = []
    for _ in range(2):
        results = processes.finish(processes.start(
            processes.CLI_WORKER, processes.dist_args(argv_ckpt, 2), ROOT,
            env), timeout)
        reports = processes.reports(results)
        check_reports("cli phase --checkpoint in 2 processes", reports, 2)
        check(_vcf_body(prefix) == genome["oracle_vcf"],
              "cli phase LPS_MULTICHIP=1 --checkpoint in 2 processes: VCF "
              "differs from phase 8's")
        runs.append((reports, [err for _rc, _o, err in results]))
    check(all(r["launches"][k] == 1 for r in runs[0][0] for k in FLAT_PATH),
          f"the checkpointed batch did not launch each kernel once a "
          f"process: {[r['launches'] for r in runs[0][0]]}")
    check(all("checkpoint: resumed" in err for err in runs[1][1])
          and not any(r["launches"]["vote_scan"] for r in runs[1][0]),
          "the second checkpointed run did not resume every contig")
    say(f"phase 10 cli phase LPS_MULTICHIP=1 --checkpoint in 2 processes: "
        f"VCF equal, then resumed and equal; process walls "
        f"{[[r['wall'] for r in reports] for reports, _e in runs]} s")

    # (c) the tag family and (d) modcall on the device engine
    som = genome["som"]
    sfx = som["fx"]
    pair = ["-s", som["phased"], "--tumor-snv-file", sfx["tumor_vcf"], "-b",
            sfx["normal_bam"], "--tumor-bam-file", sfx["tumor_bam"], "-r",
            sfx["fasta"], "--device", "cuda"]
    hap = ["haplotag", "-s", som["phased"], "-b", sfx["normal_bam"], "-r",
           sfx["fasta"], "--device", "cuda"]
    env = dict(os.environ, LPS_TAG_ENGINE="device")

    def single_run(args, prefix):
        """``cli`` in this process on the device engine; its wall."""
        os.environ["LPS_TAG_ENGINE"] = "device"
        try:
            t0 = time.perf_counter()
            check(cli.main(args + ["-o", prefix]) == 0,
                  f"cli {args[0]} returned non-zero")
            return time.perf_counter() - t0
        finally:
            os.environ.pop("LPS_TAG_ENGINE")

    single = {"somatic_haplotag": som["wall"]}
    single["haplotag"] = single_run(hap, os.path.join(workdir, "single_hap"))
    single["estimate_purity"] = single_run(
        ["estimate_purity", *pair], os.path.join(workdir, "single_pur"))
    mfx = fixtures.get("multi_meth")
    mod = ["modcall", "-b", mfx["bam"], "-r", mfx["fasta"], "-s", mfx["vcf"],
           "--device", "cuda"]
    single["modcall"] = single_run(mod, os.path.join(workdir, "single_mod"))
    cases = (
        ("haplotag", hap, ["germline"], lambda p: _tags(p + ".bam"),
         _tags(os.path.join(workdir, "single_hap.bam"))),
        ("somatic_haplotag", ["somatic_haplotag", *pair,
                              "--output-somatic-vcf"],
         ["somatic_normal", "somatic_extract", "somatic_haplotag"],
         lambda p: (_tags(p + ".bam"), _text(p + "_sc.vcf")), som["single"]),
        ("estimate_purity", ["estimate_purity", *pair],
         ["somatic_normal", "somatic_extract"],
         lambda p: _text(p + "_purity.out"),
         _text(os.path.join(workdir, "single_pur_purity.out"))),
        ("modcall", mod, ["modcall_edges"], _vcf_body,
         _vcf_body(os.path.join(workdir, "single_mod"))))
    # (c) and (d) together: four groups of 2 processes, started at once
    groups = [processes.start(processes.CLI_WORKER, processes.dist_args(
        args + ["-o", os.path.join(workdir, f"dist_{label}")], 2), ROOT, env)
        for label, args, *_ in cases]
    tag_walls = {}
    try:
        for (label, _args, reductions, outputs, want), procs in zip(cases,
                                                                    groups):
            reports = processes.reports(processes.finish(procs, timeout))
            check_reports(f"{label} in 2 processes", reports, 2)
            check(outputs(os.path.join(workdir, f"dist_{label}")) == want,
                  f"{label} in 2 processes differs from the one-process "
                  "device run")
            check(all(r["device_calls"][k] > 0 for r in reports
                      for k in reductions), f"{label} in 2 processes: a "
                  f"process ran no reduction on the card: "
                  f"{[r['device_calls'] for r in reports]}")
            tag_walls[label] = [r["wall"] for r in reports]
            out[label] = reports
    finally:
        for p in (p for procs in groups for p in procs):
            if p.poll() is None:
                p.kill()
    purity = float(cases[2][4][-1].rsplit(":", 1)[1])
    check(purity > 0, f"purity {purity} is not above 0")
    check(len(cases[3][4]) > 10, "modcall wrote almost nothing")
    calls = {k: [r["device_calls"] for r in out[k]] for k in tag_walls}
    say(f"phase 10 tag family and modcall, 2 processes each, the four runs "
        f"at once, device engine: haplotag tags, somatic_haplotag tags and "
        f"_sc.vcf, estimate_purity _purity.out (purity {purity}) and the "
        f"modcall VCF ({len(cases[3][4])} lines) equal to one process; "
        f"process walls {tag_walls} s (one process in-process: {single} "
        f"s); device calls {calls}")
    return out


# the segmented serial pass of phase 8's genome at W = 35 summed over the
# shares of [cuda:0] * k, predicted before the first run of phase 11 from
# chr1's 14.3 ms (about 0.0575 ms a Mbp): the longest chain of each share,
# chr1 and chrX for k = 2, chr1, chr7, chr13 and chrX for k = 4
MESH_SERIAL_PREDICTED_MS = {2: 23, 4: 39}


def phase11_mesh(dev, genome, somatic_items) -> dict:
    """The in-process mesh on the card (see the module docstring)."""
    import warnings

    import numpy as np
    import torch

    from longphase_s_tpu_torch.core.phase_algo import PhaseParams
    from longphase_s_tpu_torch.ops import _build, cuda_scan, fused
    from longphase_s_tpu_torch.ops import tag_kernels as tk
    from longphase_s_tpu_torch.ops.vote_scan import vote_scan_core
    from longphase_s_tpu_torch.parallel import mesh
    from longphase_s_tpu_torch.parallel.multichip import \
        run_fused_phase_multichip

    params = PhaseParams(connect_adjacent=W)
    entries = genome["entries"]
    out = {}
    for k in (2, 4):
        devices = [dev] * k
        shares = mesh.shares(len(entries), devices)
        names = [f"{entries[a]['chrom']}-{entries[z - 1]['chrom']}"
                 for _d, a, z in shares]
        _build.reset_launches()
        t0 = time.perf_counter()
        got = run_fused_phase_multichip(entries, params, devices)
        walls = [time.perf_counter() - t0]
        launches = dict(_build.LAUNCHES)
        check(same_phase(got, genome["batched"]), f"the genome over "
              f"[{dev}] * {k} differs from phase 8's one-device batch")
        check(all(launches[n] == len(shares) for n in FLAT_PATH)
              and launches["vote_cast"] == 0, f"the genome over [{dev}] * "
              f"{k} did not launch each flat-path kernel once a share: "
              f"{launches}")
        t0 = time.perf_counter()
        check(same_phase(run_fused_phase_multichip(entries, params, devices),
                         got), "the split batch differs between runs")
        walls.append(time.perf_counter() - t0)
        # each share staged, the card synchronized after each stage, and
        # its segmented serial pass by CUDA events
        split, serial_ms = [], []
        for _d, a, z in shares:
            spent, _o, (codes, site, seg, _scan), _c = batch_split(
                entries[a:z], params, dev)
            split.append(spent)
            serial_ms.append(cuda_ms(lambda: cuda_scan.vote_serial_segments(
                codes, site, seg, W), 3))
            del codes, site, _scan, _c
        # the host syncs inside the launch halves, one share after another
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pending = [fused.launch_fused_phase_batch(entries[a:z],
                                                          params, d)
                           for d, a, z in shares]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = {}
        for w in caught:
            name = w.filename.split("site-packages/")[-1] \
                if "site-packages/" in w.filename \
                else os.path.relpath(w.filename, ROOT)
            syncs[f"{name}:{w.lineno}"] = syncs.get(f"{name}:{w.lineno}",
                                                    0) + 1
        check(same_phase([o for p in pending
                          for o in fused.collect_fused_phase_batch(p)],
                         got), "the launch and collect halves differ")
        del pending
        out[k] = dict(shares=names, walls=walls, launches=launches,
                      serial_ms=serial_ms, serial_sum_ms=sum(serial_ms),
                      predicted_ms=MESH_SERIAL_PREDICTED_MS[k],
                      split=split, syncs=syncs)
        say(f"phase 11 genome over [{dev}] * {k}, shares {names}: equal to "
            f"phase 8's batch on every chromosome; launches {launches}; "
            f"step walls {walls} s against phase 8's one-device batch "
            f"{genome['batched_walls']} s")
        say(f"phase 11 serial pass over [{dev}] * {k}: {serial_ms} ms a "
            f"share, {sum(serial_ms)} ms summed (predicted about "
            f"{MESH_SERIAL_PREDICTED_MS[k]}; one launch for the genome "
            f"{genome[W]['ms']} ms)")
        say(f"phase 11 split a share over [{dev}] * {k} (s): {split}")
        say(f"phase 11 host syncs in the launch halves over [{dev}] * {k} "
            f"(file:line, count): {syncs}")

    # the sharded scan step over four devices, B = 8
    rng = np.random.default_rng(SEED + 11)
    B, S = 8, 2048
    band = rng.random((B, S, W, 1)) < 0.1
    hi = (rng.integers(0, 30, (B, S, W, 4)) * band).astype(np.int32)
    lo = (rng.integers(0, 8, (B, S, W, 4)) * band).astype(np.int32)
    gap = rng.integers(1, 400000, (B, S)).astype(np.int32)
    gap[rng.random((B, S)) < 0.01] = 10 ** 6
    vt = rng.integers(0, 5, (B, S)).astype(np.int8)
    tgt = np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]
    vb = np.broadcast_to(tgt < S, (B, S, W)).copy()
    tvt = np.where(vb, vt[:, np.minimum(tgt, S - 1)], 0).astype(np.int8)
    step = mesh.make_sharded_phase_step([dev] * 4, W, params.distance,
                                        params.edge_threshold * 10.0)
    _build.reset_launches()
    t0 = time.perf_counter()
    assigned, hp, bstart, total = step(hi, lo, gap, vt, tvt, vb)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_launches = dict(_build.LAUNCHES)
    check(step_launches["vote_scan"] == B and step_launches["vote_cast"] == B,
          f"the sharded step did not launch one scan a chromosome: "
          f"{step_launches}")
    n = 0
    for b in range(B):
        args = [torch.from_numpy(x[b]) for x in (hi, lo, gap, vt)]
        for where in (dev, "cpu"):
            ref = vote_scan_core(*(x.to(where) for x in args), W,
                                 params.distance,
                                 params.edge_threshold * 10.0)
            check(all(torch.equal(g.cpu(), r.cpu()) for g, r in zip(
                (assigned[b], hp[b], bstart[b]), ref)), f"the sharded step "
                f"differs from vote_scan_core on {where}, chromosome {b}")
        n += int(ref[0].sum())
    check(int(total) == n > 0, f"the sharded step's total {int(total)} is "
          f"not the per-chromosome {n}")
    # the B launches of each kernel: vote_cast reads the sums, gap and
    # vtype and writes codes and site words; vote_scan reads those and
    # writes assigned, hp and bstart
    w = cuda_scan.cut_window(S, W)
    bound = B * (roofline(2 * S * W * 4 + S * 4 + S + S * w + S * 4, 0)[0]
                 + roofline(S * w + S * 4 + S + 2 * S * 4, 0)[0])
    out["step"] = dict(B=B, S=S, s=step_s, launches=step_launches,
                       total=int(total), bound_ms=bound)
    say(f"phase 11 make_sharded_phase_step over [{dev}] * 4, B = {B}, S = "
        f"{S}: equal to per-chromosome vote_scan_core on the card and the "
        f"cpu, total {int(total)}; {step_s} s (its kernels' bounds "
        f"{bound} ms together); launches {step_launches}")

    # the somatic batch over three devices, phase 5's walk in three
    som = {}
    for mode in ("normal", "extract", "haplotag"):
        kw = dict(want_posbase=mode != "haplotag",
                  want_derive=mode == "haplotag", ref_nonempty=True)
        its = [dict(it, gate=None) if mode == "haplotag" else it
               for it in somatic_items]
        tk.reset_device_calls()
        got = tk.somatic_counts_batched(its, mode, devices=[dev] * 3, **kw)
        calls = tk.DEVICE_CALLS["somatic_batched"]
        one = tk.somatic_counts_batched(its, mode, device=dev, **kw)
        check(calls == 3 and len(got) == len(one) == 3 and all(
            list(g) == list(o) and all(np.array_equal(g[key], o[key])
                                       and g[key].dtype == o[key].dtype
                                       for key in o)
            for g, o in zip(got, one)), f"somatic_counts_batched {mode} "
            f"over [{dev}] * 3 differs from the one-device batch ({calls} "
            "calls on the card)")
        split_ms = 1000 * best_s(lambda: tk.somatic_counts_batched(
            its, mode, devices=[dev] * 3, **kw))
        one_ms = 1000 * best_s(lambda: tk.somatic_counts_batched(
            its, mode, device=dev, **kw))
        som[mode] = dict(ms=split_ms, one_device_ms=one_ms, calls=calls)
        say(f"phase 11 somatic_counts_batched {mode} over [{dev}] * 3: "
            f"equal to the one-device batch key for key; {split_ms} ms "
            f"with transfers against {one_ms} ms in one batch")
    out["somatic"] = som
    return out


def phase12_soak(soak_fixtures, work: str) -> dict:
    """The soak's steps 1-5 on the card (``testing/wgs_soak.py``) in
    ``work``, where ``soak_fixtures`` (a future of ``_soak_fixtures``)
    builds the fixtures; each step raises on a failed equality. Returns
    the soak's rows."""
    from longphase_s_tpu_torch.testing import wgs_soak

    t0 = time.perf_counter()
    fix, sfix, sim_s = soak_fixtures.result()
    waited = time.perf_counter() - t0
    rows = {"cut": {"length": SOAK_LENGTH,
                    "somatic_length": SOAK_SOMATIC_LENGTH,
                    "of": {"length": wgs_soak.CFG["length"],
                           "somatic_length":
                               wgs_soak.SOMATIC_CFG["length"]}},
            "fixture": {"n_sites": fix["n_sites"], "n_reads": fix["n_reads"],
                        "bam_bytes": os.path.getsize(fix["bam"])},
            "simulate_s": sim_s, "waited_s": waited}
    say(f"phase 12 soak fixtures: CFG at {SOAK_LENGTH} bp of "
        f"{wgs_soak.CFG['length']} ({fix['n_sites']} sites, "
        f"{fix['n_reads']} reads, BAM {rows['fixture']['bam_bytes']} bytes) "
        f"and SOMATIC_CFG at {SOAK_SOMATIC_LENGTH} bp of "
        f"{wgs_soak.SOMATIC_CFG['length']}: simulated in {sim_s:.3f} s in a "
        f"worker, waited {waited:.3f} s for them")
    t0 = time.perf_counter()
    rows.update(wgs_soak.step_phase(fix, work, "cuda", references=("cpu",)))
    ph = rows["phase"]
    say(f"phase 12 cli phase at {SOAK_LENGTH} bp: {ph['wall_s']} s on the "
        f"card ({ph['sites_per_s']} sites/s), --device cpu "
        f"{rows['phase_cpu']['wall_s']} s, VCFs equal; split (s) "
        f"{ph['split']}; busy share {ph['busy_share']} "
        f"({ph['device_time']}); peak RSS {ph['peak_rss_gb']} GB, device "
        f"{ph['peak_device_mb']} MB; launches {ph['launches']}")
    phase_vcf = os.path.join(work, "phase.vcf")
    rows.update(wgs_soak.step_haplotag(fix, phase_vcf, work, "cuda"))
    for name in ("haplotag_whole", "haplotag_stream", "haplotag_host"):
        r = rows[name]
        say(f"phase 12 {name}: {r['wall_s']} s ({r['reads_per_s']} reads/s), "
            f"peak RSS {r['peak_rss_gb']} GB, walks to the device / host "
            f"{r['engines']['device']} / {r['engines']['host']}, stream "
            f"windows {r['stream_windows']}; tags equal")
    rows.update(wgs_soak.step_wavefront(fix, work, phase_vcf, "cuda"))
    r = rows["wavefront"]
    say(f"phase 12 wavefront: {r['wall_s']} s, VCF equal to cli phase's; "
        f"launches {r['launches']}")
    rows.update(wgs_soak.step_somatic(sfix, work, "cuda"))
    say(f"phase 12 somatic at {SOAK_SOMATIC_LENGTH} bp: somatic_haplotag "
        f"{rows['somatic_device']['wall_s']} s device engine, "
        f"{rows['somatic_host']['wall_s']} s host engine; estimate_purity "
        f"{rows['purity_device']['wall_s']} / "
        f"{rows['purity_host']['wall_s']} s; _sc.vcf ({rows['somatic_pass']} "
        f"PASS), tags and _purity.out equal, purity "
        f"{rows['somatic_purity']}")
    rows["steps_s"] = time.perf_counter() - t0
    say(f"phase 12 steps: {rows['steps_s']} s")
    return rows


def main() -> int:
    phase0_device()
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as wd, \
            ProcessPoolExecutor(max_workers=1, mp_context=spawn) as pool, \
            ProcessPoolExecutor(max_workers=1, mp_context=spawn) as soak_pool:
        fixtures = Fixtures(wd, pool)
        soak_work = os.path.join(wd, "soak")
        soak_fixtures = soak_pool.submit(_soak_fixtures, soak_work,
                                         SOAK_LENGTH, SOAK_SOMATIC_LENGTH)
        phase1_build()
        phase2_kernels(rng, dev)
        times, correction = phase3_chromosome(rng, dev)
        launches, fx, phased_vcf = phase4_end_to_end(wd, fixtures)
        tag_times, somatic_batch, som_items, klass = \
            phase5_tag_reductions(rng, dev)
        tag_calls = phase6_tag_pipelines(wd, fixtures, fx, phased_vcf)
        modcall = phase7_modcall(rng, dev, wd, fixtures)
        genome = phase8_genome(rng, dev, wd, fixtures)
        carry = phase9_carry(dev, wd, fixtures, genome)
        procs = phase10_processes(wd, fixtures, genome)
        mesh_out = phase11_mesh(dev, genome, som_items)
        soak = phase12_soak(soak_fixtures, soak_work)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "longphase_s_tpu"))
    check(not leaked, f"the port imported {leaked[:5]}")

    pair = "longphase_s_tpu_torch/csrc/pair_cast.cu"
    scan = "longphase_s_tpu_torch/csrc/vote_scan.cu"
    # (source, the TPU-side function it replaces, the cli phase path whose
    # run gave its launches)
    sources = {"bucket_count": (pair, "longphase_s_tpu/ops/fused.py:26",
                                "flat"),
               "bucket_scatter": (pair, "longphase_s_tpu/ops/fused.py:26",
                                  "flat"),
               "pair_cast": (pair, "longphase_s_tpu/ops/fused.py:26 and "
                             "longphase_s_tpu/ops/pallas_scan.py:77", "flat"),
               "vote_scan": (scan, "longphase_s_tpu/ops/pallas_scan.py:162",
                             "flat"),
               "vote_cast": (scan, "longphase_s_tpu/ops/pallas_scan.py:77",
                             "object")}
    kernels = []
    for name, (source, replaces, path) in sources.items():
        t = times[name]
        bound, bound_by = t["bound"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "path": path,
                        "launches": launches[name], "max_abs_err": t["err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": bound, "bound_by": bound_by,
                        "limited_by": t["limited_by"], "library_ms": None})
        if name in FLAT_PATH:
            kernels[-1]["dist_launches"] = [
                r["launches"][name] for r in procs["phase_2"]]
            kernels[-1]["soak_launches"] = soak["phase"]["launches"][name]
    # the segmented launch at phase 8's genome, W = 35; its launches from
    # cli phase with LPS_MULTICHIP=1, its plain version timed on the cpu
    # over chr19-22
    g = genome[W]
    bound, bound_by = g["bound"]
    kernels.append({
        "name": "vote_scan", "route": "cuda", "source": scan,
        "replaces": "longphase_s_tpu/ops/pallas_scan.py:162 under "
                    "longphase_s_tpu/parallel/multichip.py:84",
        "path": "batched", "launches": genome["cli_launches"],
        "max_abs_err": g["err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
        "plain_on": f"cpu, {g['plain_sites']} sites", "bound_ms": bound,
        "bound_by": bound_by,
        "limited_by": "latency of its longest chain (one warp a "
                      "chromosome)", "library_ms": None})
    # the launch with a carry: chr1 in four blocks (phase 9); its launches
    # from cli phase with LPS_WAVEFRONT=1
    bound, bound_by = carry["bound"]
    kernels.append({
        "name": "vote_scan_carry", "route": "cuda", "source": scan,
        "replaces": "longphase_s_tpu/ops/pallas_scan.py:162 as "
                    "longphase_s_tpu/parallel/sharded_scan.py:152 runs it "
                    "(init_carry, t_offset, return_carry)",
        "path": "wavefront", "launches": carry["launches"],
        "max_abs_err": carry["err"], "ms": carry["ms"],
        "plain_ms": carry["plain_ms"], "plain_on": "cpu, chr1",
        "bound_ms": bound, "bound_by": bound_by,
        "limited_by": "latency of its serial chain (the blocks run one "
                      "after another on one card)", "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"tag_reductions": [
        {"name": name, "ms": ms, "ms_without_transfers": kernel_ms,
         "host_ms": host_ms, "bound_ms": bound, "bound_by": "bytes",
         "bytes": nbytes,
         "calls": tag_calls["germline" if name == "germline"
                            else f"somatic_{name}"]}
        for name, (ms, kernel_ms, host_ms, bound, nbytes)
        in tag_times.items()] + [
        {"name": f"somatic_batched_{name}", "ms": ms,
         "ms_without_transfers": kernel_ms, "per_chromosome_ms": per_ms,
         "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes}
        for name, (ms, kernel_ms, per_ms, bound, nbytes)
        in somatic_batch.items()] + [
        {"name": "modcall_edges", "bound_by": "bytes", **modcall},
        {"name": "class_counts", "bound_by": "bytes",
         "calls": tag_calls["class_counts"], **klass}]}))
    print(json.dumps({"read_correction": [
        {"where": where, "bound_ms": c["bound"][0],
         "bound_by": c["bound"][1], "max_abs_err": c["err"],
         **{k: v for k, v in c.items() if k not in ("bound", "err")}}
        for where, c in (("phase 3, one chromosome", correction),
                         ("phase 8, genome batch, W = 35",
                          genome[f"correction_{W}"]),
                         ("phase 8, genome batch, W = 100",
                          genome["correction_100"]))]}))
    keep = ("pid", "device", "wall", "step_s", "records_s", "merge_s",
            "load_s", "gathered", "launches", "device_calls", "chroms")
    print(json.dumps({"mesh": {
        **{f"genome_over_{k}": {key: v for key, v in mesh_out[k].items()
                                if key != "split"} for k in (2, 4)},
        "flat_bounds_ms": sum(b for b, _ in genome["flat_bounds"].values()),
        "sharded_step": mesh_out["step"], "somatic": mesh_out["somatic"]}}))
    print(json.dumps({"processes": {
        label: [{k: r[k] for k in keep if k in r} for r in reports]
        for label, reports in procs.items()}}))
    print(json.dumps({"soak": soak}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
