"""Drive the PyTorch/CUDA port's ``phase`` path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU (sm_90a),
``nvcc`` and ``g++``. It imports no JAX. Phases, each printed as it ends:

0. device: the card's name and power limit (``nvidia-smi``); exits
   non-zero at once without CUDA; builds the native ingest library so the
   run takes the flat main path;
1. build: compiles the CUDA kernels from ``longphase_s_tpu_torch/csrc``;
2. kernels: each kernel against its plain PyTorch version on the card,
   element for element (exact: the arithmetic is integer plus one fixed
   float32 compare), with both times at S = 16384;
3. chromosome scale: ``ops/fused.run_fused_phase`` on a synthetic merged
   stream of 319,951 sites at 20x on ``cuda`` against the same call on
   ``cpu`` (the plain versions): ``ps`` equal, ``ori`` equal on phased
   sites; the step's wall time and each kernel's time beside its plain
   version's on the card at that shape;
4. end to end: ``cli phase --pb --device cuda`` on a simulated 2 Mbp, 30x
   fixture, whose VCF must equal the ``--engine oracle`` run's; every
   kernel's launch count from that run must be above zero.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises,
and the script exits non-zero without that line.
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def synthetic_stream(rng, S: int, coverage: int, sites_per_read: int,
                     dup_frac: float = 0.0, pad: int = 0):
    """A (read, rank)-sorted merged observation stream over S sites: reads
    cover contiguous rank runs of about ``sites_per_read`` sites (5% of
    calls dropped) that never cross one of about S / 5000 coverage breaks
    (so phasing yields many blocks), alleles follow a hidden haplotype with
    5% errors, ``dup_frac`` of the rows repeat their (read, rank) with a
    random allele, and ``pad`` trailing rows carry m_read == -1."""
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

    from longphase_s_tpu.core.phase_algo import (T_DANGER, T_INDEL, T_MOD,
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
    from longphase_s_tpu import native

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
        f"built and loaded in {time.perf_counter() - t0:.3f} s")


def scan_inputs(rng, S: int, dev):
    import numpy as np
    import torch

    from longphase_s_tpu_torch.ops.vote_scan import fold_counts

    hi = torch.from_numpy(rng.integers(0, 30, (S, W, 4)).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, 8, (S, W, 4)).astype(np.int32))
    s_para10, s_cross10 = fold_counts(hi, lo)
    gap = torch.from_numpy(rng.integers(1, 400000, S).astype(np.int32))
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8))
    return [x.to(dev) for x in (s_para10, s_cross10, gap, vtype)]


def phase2_kernels(rng, dev):
    import torch

    from longphase_s_tpu_torch.ops import cuda_scan, fused

    for S in (300, 4096, 16384):
        for thr in (0.7, 0.33):
            args = scan_inputs(rng, S, dev)
            kw = dict(S=S, window=W, distance=300000,
                      edge_threshold_x10=thr * 10.0)
            got = cuda_scan.vote_scan_pc(*args, **kw)
            ref = cuda_scan.vote_scan_pc_plain(*args, **kw)
            cpu = cuda_scan.vote_scan_pc(*(a.cpu() for a in args), **kw)
            torch.cuda.synchronize()
            err = max(max_abs_err(got, ref), max_abs_err([g.cpu() for g in got], cpu))
            check(err == 0, f"vote_scan kernel differs from its plain "
                  f"version at S={S}, edgeThreshold={thr}: max |diff| {err}")
            if S == 16384 and thr == 0.7:
                ms = cuda_ms(lambda: cuda_scan.vote_scan_pc(*args, **kw), 10)
                plain = cuda_ms(
                    lambda: cuda_scan.vote_scan_pc_plain(*args, **kw), 1)
                say(f"phase 2 vote_scan S={S}: kernel {ms} ms, plain "
                    f"version on the card {plain} ms")
    say("phase 2 vote_scan: kernel equals its plain version at "
        "S in {300, 4096, 16384} x edgeThreshold in {0.7, 0.33}")

    for S in (300, 4096, 16384):
        read, rank, allele, qok, _n = synthetic_stream(
            rng, S, coverage=30, sites_per_read=60, dup_frac=0.02, pad=1000)
        stream = fused.stream_to_device(read, rank, allele, qok, dev)
        got = fused.pair_sums(*stream, S, W)
        ref = fused.pair_sums_plain(*stream, S, W)
        cpu = fused.pair_sums(*(x.cpu() for x in stream), S, W)
        torch.cuda.synchronize()
        err = max(max_abs_err(got, ref), max_abs_err([g.cpu() for g in got], cpu))
        check(err == 0, f"pair_pack kernel differs from its plain version "
              f"at S={S}: max |diff| {err}")
        check(int(got[0].sum()) > 0 and int(got[1].sum()) > 0,
              "pair_pack produced empty sums")
        if S == 16384:
            ms = cuda_ms(lambda: fused.pair_sums(*stream, S, W), 20)
            plain = cuda_ms(lambda: fused.pair_sums_plain(*stream, S, W), 3)
            say(f"phase 2 pair_pack S={S} ({len(read)} observations): "
                f"kernel {ms} ms, plain version on the card {plain} ms")
    say("phase 2 pair_pack: kernel equals its plain version on 30x streams "
        "with duplicate (read, rank) rows and m_read == -1 padding")


def phase3_chromosome(rng, dev) -> dict:
    import numpy as np
    import torch

    from longphase_s_tpu.core.phase_algo import PhaseParams
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
    say(f"phase 3 chromosome scale: S={S}, {len(read)} observations, "
        f"{int(phased.sum())} sites phased, {len(np.unique(ps[phased]))} "
        f"blocks; run_fused_phase wall on cuda {walls[1:]} s "
        f"(warm-up {walls[0]} s), on cpu {cpu_wall} s; cuda == cpu")

    stream = fused.stream_to_device(read, rank, allele, qok, dev)
    pack_ms = cuda_ms(lambda: fused.pair_sums(*stream, S, W), 10)
    pack_plain_ms = cuda_ms(lambda: fused.pair_sums_plain(*stream, S, W), 1)
    sums = fused.pair_sums(*stream, S, W)
    pack_err = max_abs_err(sums, fused.pair_sums_plain(*stream, S, W))
    gap = torch.from_numpy(site_gaps(positions)).to(dev)
    vt = torch.from_numpy(vtype).to(dev)
    kw = dict(S=S, window=W, distance=params.distance,
              edge_threshold_x10=params.edge_threshold * 10.0)
    scan_ms = cuda_ms(lambda: cuda_scan.vote_scan_pc(*sums, gap, vt, **kw), 3)
    t0 = time.perf_counter()
    plain_out = cuda_scan.vote_scan_pc_plain(*sums, gap, vt, **kw)
    torch.cuda.synchronize()
    scan_plain_ms = 1000 * (time.perf_counter() - t0)
    scan_err = max_abs_err(cuda_scan.vote_scan_pc(*sums, gap, vt, **kw),
                           plain_out)
    check(pack_err == 0 and scan_err == 0,
          f"kernels differ from plain at chromosome scale: pack {pack_err}, "
          f"scan {scan_err}")
    say(f"phase 3 kernels at S={S}: pair_pack {pack_ms} ms (plain version "
        f"on the card {pack_plain_ms} ms), vote_scan {scan_ms} ms (plain "
        f"version on the card {scan_plain_ms} ms)")
    return {"pair_pack": (pack_ms, pack_plain_ms, pack_err),
            "vote_scan": (scan_ms, scan_plain_ms, scan_err)}


def phase4_end_to_end(workdir: str) -> dict:
    from longphase_s_tpu.testing.simulate import make_fixture
    from longphase_s_tpu_torch import cli
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    say(f"phase 4 end to end: cli phase --device cuda {gpu_wall} s, "
        f"--engine oracle {oracle_wall} s, {n_phased} phased records, VCFs "
        f"identical; launches {launches}")
    return launches


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
        launches = phase4_end_to_end(wd)
    check("jax" not in sys.modules, "the port imported jax")

    sources = {"vote_scan": ("longphase_s_tpu_torch/csrc/vote_scan.cu",
                             "longphase_s_tpu/ops/pallas_scan.py:162"),
               "pair_pack": ("longphase_s_tpu_torch/csrc/pair_pack.cu",
                             "longphase_s_tpu/ops/fused.py:26")}
    kernels = []
    for name, (source, replaces) in sources.items():
        ms, plain_ms, err = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
