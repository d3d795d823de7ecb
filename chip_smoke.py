"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: ``phase`` and the
tag family (``haplotag``, ``somatic_haplotag``, ``estimate_purity``).

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
   sites; the step's wall time and peak device memory; at W = 35 and 100
   the pair stage (each launch's time, its peak memory, its pairs and its
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
   0, and every device reduction called by the device runs.

Then one JSON line with one entry per kernel (its launches on the run of
phase 4 that drove its path, its time and its plain version's at phase 3's
shapes, and its bound: the bytes it must move over the card's memory rate,
or its int32 operations over the int32 rate where those take longer), one
JSON line with one entry per tag reduction, and the last line ``{"ok":
true, "device": {...}}``. Any failed phase raises, and the script exits
non-zero without that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W = 35
SEED = 20260916
# the kernels each path of cli phase launches: the flat path (native
# ingest, ops/fused.run_fused_phase) and the object path (ops/engine.py)
FLAT_PATH = ("bucket_count", "bucket_scatter", "pair_cast", "vote_scan")
OBJECT_PATH = ("vote_cast", "vote_scan")


class SmokeFailure(RuntimeError):
    pass


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


def synthetic_sites(rng, S: int):
    """Sorted positions (a few gaps beyond the 300 kbp distance limit) and
    a variant-type mix: mostly SNPs, some SV, MOD, indel and danger indel."""
    import numpy as np

    from longphase_s_tpu_torch.core.phase_algo import (T_DANGER, T_INDEL, T_MOD,
                                                 T_SNP, T_SV)

    gaps = rng.integers(1, 400, S).astype(np.int64)
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

    stream = fused.stream_to_device(read, rank, allele, qok, dev)
    gap = torch.from_numpy(site_gaps(positions)).to(dev)
    vt = torch.from_numpy(vtype).to(dev)
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
        # the stream, gap and vtype in; S x w codes and the site words out;
        # one add a pair and about 16 operations a cast (t, d)
        cast_bound = roofline(n * 10 + S * 5 + S * w + S * 4,
                              pairs + 16 * S * w)
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
        say(f"phase 3 vote scan at S={S}, W={window}: vote_serial "
            f"{serial_ms} ms over pair_cast's codes; vote_cast (object "
            f"path) {cast_ms} ms, its codes equal pair_cast's; plain scan "
            f"on the card {whole_ms} ms; equal")
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
        n_src = int(ref[0].sum())
        tiles = -(-S // T)
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
                err=errs["bucket_count"], bound=roofline(
                    n * 8 + tiles * 4, n),  # read, rank in; counts out
                limited_by="not measured"),
            "bucket_scatter": dict(
                ms=times["bucket_scatter"], plain_ms=order_plain_ms,
                err=errs["bucket_scatter"], bound=roofline(
                    # read, rank and the counts in; the index out
                    n * 8 + tiles * 4 + n_src * 4, n),
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
                # codes and site words in; assigned, hp and bstart out
                bound=roofline(S * w + S * 4 + S + 2 * S * 4, 0),
                limited_by="latency of its serial chain")}
    return out


def phase4_end_to_end(workdir: str) -> dict:
    from longphase_s_tpu_torch.testing.simulate import make_fixture
    from longphase_s_tpu_torch import cli, native
    from longphase_s_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fx = make_fixture(os.path.join(workdir, "fix"), seed=1, length=2_000_000,
                      coverage=30, read_len=12000, snp_rate=0.005,
                      error_rate=0.05, qual=20)
    say(f"phase 4 fixture: simulated in {time.perf_counter() - t0:.3f} s")
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

    def body(prefix):
        with open(prefix + ".vcf") as f:
            return [line for line in f
                    if not line.startswith(("##longphase", "##commandline"))]

    gpu_vcf, oracle_vcf = body(out_gpu), body(out_oracle)
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
    check(body(out_gpu + "_a100") == body(out_oracle + "_a100"),
          "cuda VCF differs from the oracle VCF at -a 100")
    say(f"phase 4 -a 100: cli phase --device cuda {wide_wall} s, VCF "
        "identical to --engine oracle")

    # the object path: the native ingest declines, so the pair counts come
    # from the host and the scan casts them with vote_cast
    fx_obj = make_fixture(os.path.join(workdir, "obj"), seed=4,
                          length=300_000, coverage=20, read_len=10000,
                          snp_rate=0.002, error_rate=0.04, qual=20)
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
    obj_vcf = body(out_obj)
    check(obj_vcf == body(out_obj + "_oracle"),
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
    return times


def _tags(bam_path):
    from longphase_s_tpu_torch.io.bam import BamReader

    r = BamReader(bam_path)
    out = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
            rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
    r.close()
    return out


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


def phase6_tag_pipelines(workdir: str, phase4_fx, phase4_vcf) -> dict:
    from longphase_s_tpu_torch.testing.simulate import make_somatic_fixture
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

    t0 = time.perf_counter()
    fx = make_somatic_fixture(os.path.join(workdir, "som"), seed=2,
                              length=1_000_000, normal_coverage=30,
                              tumor_coverage=40, purity=0.6, n_somatic=80,
                              n_artifacts=20)
    say(f"phase 6 tumour/normal fixture: simulated in "
        f"{time.perf_counter() - t0:.3f} s")
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

    def text(path):
        check(os.path.exists(path), f"{path} was not written")
        with open(path) as f:
            return [line for line in f if not line.startswith("##commandline")]

    def purity(lines):
        value = float(lines[-1].rsplit(":", 1)[1])
        check(value > 0, f"purity {value} is not above 0")
        return value

    walls, c, (tags, sc, pur) = _run_engines(
        "somatic_haplotag", ["somatic_haplotag", *pair, "--output-somatic-vcf"],
        os.path.join(workdir, "somatic"),
        ["somatic_normal", "somatic_extract", "somatic_haplotag"],
        lambda p: (_tags(p + ".bam"), text(p + "_sc.vcf"),
                   text(p + "_purity.out")))
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
        lambda p: text(p + "_purity.out"))
    say(f"phase 6 estimate_purity: device engine {walls['device']} s, host "
        f"engine {walls['host']} s; _purity.out equal (purity "
        f"{purity(pur)}); device calls {c}")
    return calls


def main() -> int:
    phase0_device()
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    phase1_build()
    phase2_kernels(rng, dev)
    times = phase3_chromosome(rng, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as wd:
        launches, fx, phased_vcf = phase4_end_to_end(wd)
        tag_times = phase5_tag_reductions(rng, dev)
        tag_calls = phase6_tag_pipelines(wd, fx, phased_vcf)
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"tag_reductions": [
        {"name": name, "ms": ms, "ms_without_transfers": kernel_ms,
         "host_ms": host_ms, "bound_ms": bound, "bound_by": "bytes",
         "bytes": nbytes,
         "calls": tag_calls["germline" if name == "germline"
                            else f"somatic_{name}"]}
        for name, (ms, kernel_ms, host_ms, bound, nbytes)
        in tag_times.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
