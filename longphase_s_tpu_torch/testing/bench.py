"""End-of-round benchmark of the port: the five pipelines' alignments/s,
the writer's share of a raw deflate and the kernels' health, on the card.

Counterpart of ``bench.py`` (the JAX package's benchmark), with its
``PHASE_CFG``, ``SOMATIC_CFG``, ``METH_CFG``, ``REPS`` and ``_median``
letter for letter, and its JSON lines: one a pipeline,

    {"metric": "<name>_reads_per_s", "value": N, "unit": "alignments/s",
     "vs_baseline": median per-rep speedup, "ratio_spread": [min, max],
     "reps": N}

then ``bam_writer_util``, the kernel lines and the closing
``overall_speedup_geomean`` with its ``floor``. The workloads:

  phase            12 Mbp diploid chromosome, 30x reads of 12 kb, 5% error
  haplotag         the same BAM tagged with the port's phased VCF
  haplotag_cram    the same from a CRAM (``io/cram.CramWriter``), the
                   native handle cache drained before every run
  somatic_haplotag 5 Mbp tumour/normal pair (25x/30x, purity 0.6)
  estimate_purity  the same pair, ``-q 20 --tagSupplementary``
  modcall          6 Mbp MM/ML-tagged BAM, 25x

    python -m longphase_s_tpu_torch.testing.bench [workdir]
        [--length-scale X] [--reps N] [--only phase,modcall,...]
        [--device cuda|cpu] [--cold-bam] [--stages] [--out rows.json]

Fixtures come from ``testing/simulate.py`` and are cached in the work
directory (default ``.bench_cache/bench_torch``) by ``fixture_*.json``
markers (``wgs_soak._cached``). ``--length-scale`` cuts every
configuration through ``wgs_soak.cut`` (the somatic, artifact and
methylation-site counts scale with the length). The phased inputs of the
tag pipelines come from the port's ``phase`` on ``--device``, or from the
reference binary ``.refbuild/longphase-s`` where it exists.

"Ours" is the port's device engines on ``--device``: ``phase`` with the
gpu engine, the tag and modcall passes as the engine gate
(``ops/tag_kernels.engine``) chooses, its choices recorded. A pipeline
runs once as a warm-up, then ``--reps`` times timed (LPS_BENCH_REPS,
default 5), all in this process. As in ``bench.py``, the timed runs but
the CRAM's find their BAM already decoded in the native whole-file
cache, which the warm-up filled: they do not pay the BAM decode that a
user's fresh run pays (each line says so in ``bam_cache``);
``--cold-bam`` drains the cache in every run, so that each pays it.
Each timed run goes beside the reference binary's where that exists
(``vs_baseline`` is then the median of the per-rep ratios; else null: no
cached baseline is read). Then the host engines run once (phase
``oracle``, ``LPS_TAG_ENGINE=host``) and their outputs must equal ours:
the VCF but its ``##commandline``, the tags (``wgs_soak.tags_digest``),
``_sc.vcf`` and ``_purity.out`` (or its absence), the modcall VCF; any
difference raises ``wgs_soak.SoakMismatch``. On a card every ``phase``
must launch the flat path's four kernels. Each line also carries the
medians' walls, the host engines' wall, the launches, the device calls
and the gate's choices, the device and its power limit.

The kernel lines, re-based to the card (``device_metrics``):
``kernels_compiled_ok`` (``ops/fused.run_fused_phase`` on the synthetic
input of ``bench.py``'s Mosaic check equal on the card and on the cpu),
``tag_kernel_device_ok`` (``ops/tag_kernels.germline_counts`` on the
card equal to the host's ``aggregate_reads`` on ``bench.py``'s synthetic
walk, its ms a call as ``vs_baseline``) and ``phase_kernel_util`` (the
device half of the phase step on inputs on the card, CUDA events over
``UTIL_CALLS`` calls, against ``step_bound``). ``--stages`` adds the
stage split of ``testing/stage_breakdown.py`` on the same fixtures. The
tunnel probe, the compile cache and ``LPS_STRICT_DEVICE`` of the JAX
tool are not carried over: nothing here falls back, and ``--device
cuda`` without a card raises.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

from . import wgs_soak
from .fuzz_parity import environ
from .wgs_soak import ROOT, Counts, check

MODULE = "longphase_s_tpu_torch.testing.bench"
BENCH_DIR = os.path.join(ROOT, ".bench_cache", "bench_torch")
REF_BIN = wgs_soak.REF_BIN
NTHREADS = os.cpu_count() or 4

PHASE_CFG = dict(seed=20, length=12_000_000, coverage=30, read_len=12000,
                 snp_rate=0.001, error_rate=0.05, qual=20)
SOMATIC_CFG = dict(seed=21, length=5_000_000, normal_coverage=25,
                   tumor_coverage=30, purity=0.6, n_somatic=400,
                   n_artifacts=100, read_len=12000, snp_rate=0.0012,
                   error_rate=0.02, qual=25)
METH_CFG = dict(seed=22, length=6_000_000, coverage=25, read_len=10000,
                snp_rate=0.0012, n_asm=480, n_homo_mod=240, qual=30)

PIPELINES = ("phase", "haplotag", "haplotag_cram", "somatic_haplotag",
             "estimate_purity", "modcall")

REPS = int(os.environ.get("LPS_BENCH_REPS", "5"))


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclass
class Bench:
    """Where and how a run goes: its work directory, device, the scale
    of every configuration and the timed runs a pipeline."""

    work: str = BENCH_DIR
    device: str = "cuda"
    length_scale: float = 1.0
    reps: int = REPS
    bam_cache: str = "warm"  # "cold": every run pays the BAM decode

    def cfg(self, cfg: dict) -> dict:
        return wgs_soak.cut(cfg, round(cfg["length"] * self.length_scale))

    def path(self, name: str) -> str:
        return os.path.join(self.work, name)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def _count_alignments(*bams) -> int:
    from ..io.bam import BamReader

    n = 0
    for path in bams:
        r = BamReader(path)
        try:
            n += sum(1 for _ in r)
        finally:
            r.close()
    return n


def get_phase_fixture(b: Bench) -> dict:
    """``PHASE_CFG`` at ``b``'s scale: bam, vcf, fasta, n_reads."""
    return wgs_soak._germline_fixture(b.work, "fixture_fix.json", "fix",
                                      b.cfg(PHASE_CFG))


def get_somatic_fixture(b: Bench) -> dict:
    """``SOMATIC_CFG`` at ``b``'s scale; n_alignments counts both BAMs."""
    def build():
        from .simulate import make_somatic_fixture

        fix = make_somatic_fixture(b.path("fix_somatic"),
                                   **b.cfg(SOMATIC_CFG))
        meta = {k: fix[k] for k in ("normal_bam", "tumor_bam", "normal_vcf",
                                    "tumor_vcf", "fasta", "chrom")}
        meta["n_alignments"] = _count_alignments(fix["normal_bam"],
                                                 fix["tumor_bam"])
        return meta
    return wgs_soak._cached(b.work, "fixture_fix_somatic.json",
                            b.cfg(SOMATIC_CFG), build)


def get_meth_fixture(b: Bench) -> dict:
    """``METH_CFG`` at ``b``'s scale: bam, vcf, fasta, n_alignments."""
    def build():
        from .simulate import make_meth_fixture

        fix = make_meth_fixture(b.path("fix_meth"), **b.cfg(METH_CFG))
        return {"bam": fix["bam"], "vcf": fix["vcf"], "fasta": fix["fasta"],
                "chrom": fix["chrom"],
                "n_alignments": _count_alignments(fix["bam"])}
    return wgs_soak._cached(b.work, "fixture_fix_meth.json", b.cfg(METH_CFG),
                            build)


def get_fixtures(b: Bench) -> dict:
    """The three fixtures (what ``chip_smoke.py`` simulates in a worker)."""
    return {"phase": get_phase_fixture(b), "somatic": get_somatic_fixture(b),
            "meth": get_meth_fixture(b)}


def _phased(b: Bench, name: str, vcf: str, bam: str, fasta: str) -> str:
    """``name``.vcf, phased from ``vcf`` and ``bam`` by the reference
    binary where it exists, else by the port's gpu engine on
    ``b.device``; kept while it is newer than the BAM."""
    out = b.path(name)
    if os.path.exists(out + ".vcf") and \
            os.path.getmtime(out + ".vcf") > os.path.getmtime(bam):
        return out + ".vcf"
    if os.path.exists(REF_BIN):
        wgs_soak.run_reference_binary(["phase", "--pb", "-s", vcf, "-b", bam,
                                       "-r", fasta, "-o", out])
    else:
        counts = Counts()
        with counts:
            phase_run(b, vcf, bam, fasta, out, "gpu")
        wgs_soak._check_flat_path(counts.row(), b.device, f"phase of {name}")
    return out + ".vcf"


def get_phased_vcf(b: Bench, meta: dict) -> str:
    """The phased VCF the haplotag pipelines tag with."""
    return _phased(b, "phased_input", meta["vcf"], meta["bam"],
                   meta["fasta"])


def get_phased_somatic_vcf(b: Bench, meta: dict) -> str:
    """The phased normal VCF of the somatic pipelines."""
    return _phased(b, "phased_normal_somatic", meta["normal_vcf"],
                   meta["normal_bam"], meta["fasta"])


def get_cram(b: Bench, meta: dict) -> str:
    """The phase fixture's BAM as a CRAM (``io/cram.CramWriter``,
    reference-based), kept while it is newer than the BAM."""
    cram = b.path("fix_reads.cram")
    if os.path.exists(cram) and \
            os.path.getmtime(cram) >= os.path.getmtime(meta["bam"]):
        return cram
    from ..io.bam import BamReader
    from ..io.cram import CramWriter

    br = BamReader(meta["bam"])
    w = CramWriter(cram, br.header_text, br.references, br.lengths,
                   fasta_path=meta["fasta"])
    for rec in br:
        w.write(rec)
    w.close()
    br.close()
    return cram


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


def phase_run(b: Bench, vcf, bam, fasta, prefix, engine: str) -> None:
    from ..core.phase_algo import PhaseParams
    from ..models.phase import PhaseConfig, run_phase

    run_phase(PhaseConfig(snp_file=vcf, bam_files=[bam], fasta_file=fasta,
                          result_prefix=prefix, engine=engine,
                          device=b.device, params=PhaseParams()))


def _somatic_cfg(b: Bench, meta, phased, prefix, **opts):
    from ..models.somatic import SomaticConfig

    return SomaticConfig(snp_file=phased, tumor_snv_file=meta["tumor_vcf"],
                         bam_file=meta["normal_bam"],
                         tumor_bam_file=meta["tumor_bam"],
                         fasta_file=meta["fasta"], result_prefix=prefix,
                         num_threads=NTHREADS, device=b.device, **opts)


def _text_or_none(path: str):
    return wgs_soak.text_lines(path) if os.path.exists(path) else None


def outputs(name: str, prefix: str) -> dict:
    """What a pipeline wrote under ``prefix``, as the equality check
    compares it."""
    if name in ("phase", "modcall"):
        return {".vcf": wgs_soak.text_lines(prefix + ".vcf")}
    if name in ("haplotag", "haplotag_cram"):
        return {"tags": wgs_soak.tags_digest(prefix + ".bam")}
    out = {"_purity.out": _text_or_none(prefix + "_purity.out")}
    if name == "somatic_haplotag":
        out["tags"] = wgs_soak.tags_digest(prefix + ".bam")
        out["_sc.vcf"] = _text_or_none(prefix + "_sc.vcf")
    return out


@dataclass
class Pipeline:
    """One pipeline of the bench: its alignments, how ours and the host
    engines run it into a prefix, and the reference binary's arguments
    but ``-o``."""

    name: str
    n_units: int
    run: object       # run(prefix, host: bool)
    ref_args: list
    # "warm": the timed runs reuse the decoded BAM that the warm-up left in
    # the native whole-file cache (``native.open_native_bam``, two files a
    # process), as ``bench.py``'s do; "cold": drained in every run
    bam_cache: str = "warm"


def pipeline(b: Bench, name: str) -> Pipeline:
    """``name`` of ``PIPELINES`` on ``b``'s fixtures (simulated, phased
    and converted as needed). The CRAM's runs, and every run where
    ``b.bam_cache`` is "cold", first drain the native whole-file cache,
    so that each pays the decode as a user's fresh run does (``bench.py``
    drains it for the CRAM alone: that line is about decode)."""
    p = _pipeline(b, name)
    if name == "haplotag_cram" or b.bam_cache == "cold":
        from .. import native

        warm_run = p.run

        def run(prefix, host):
            native.drain_bam_cache()
            warm_run(prefix, host)
        p.run, p.bam_cache = run, "cold"
    return p


def _pipeline(b: Bench, name: str) -> Pipeline:
    from ..models.haplotag import HaplotagConfig, run_haplotag
    from ..models.modcall import ModCallConfig, run_modcall
    from ..models.somatic import run_estimate_purity, run_somatic_haplotag

    if name == "phase":
        meta = get_phase_fixture(b)
        return Pipeline(name, meta["n_reads"], lambda prefix, host: phase_run(
            b, meta["vcf"], meta["bam"], meta["fasta"], prefix,
            "oracle" if host else "gpu"),
            ["phase", "--pb", "-s", meta["vcf"], "-b", meta["bam"], "-r",
             meta["fasta"]])
    if name in ("haplotag", "haplotag_cram"):
        meta = get_phase_fixture(b)
        phased = get_phased_vcf(b, meta)
        bam = meta["bam"] if name == "haplotag" else get_cram(b, meta)
        return Pipeline(name, meta["n_reads"], lambda prefix, host:
                        run_haplotag(HaplotagConfig(
                            snp_file=phased, bam_file=bam,
                            fasta_file=meta["fasta"], result_prefix=prefix,
                            num_threads=NTHREADS, device=b.device)),
                        ["haplotag", "-s", phased, "-b", bam, "-r",
                         meta["fasta"]])
    if name in ("somatic_haplotag", "estimate_purity"):
        meta = get_somatic_fixture(b)
        phased = get_phased_somatic_vcf(b, meta)
        pair = ["-s", phased, "--tumor-snv-file", meta["tumor_vcf"], "-b",
                meta["normal_bam"], "--tumor-bam-file", meta["tumor_bam"],
                "-r", meta["fasta"]]
        if name == "somatic_haplotag":
            # the JAX tool's run plus the _sc.vcf, which the check compares
            return Pipeline(name, meta["n_alignments"],
                            lambda prefix, host: run_somatic_haplotag(
                                _somatic_cfg(b, meta, phased, prefix,
                                             write_somatic_vcf=True)),
                            ["somatic_haplotag", *pair,
                             "--output-somatic-vcf"])
        return Pipeline(name, meta["n_alignments"],
                        lambda prefix, host: run_estimate_purity(
                            _somatic_cfg(b, meta, phased, prefix,
                                         quality_threshold=20,
                                         tag_supplementary=True)),
                        ["estimate_purity", *pair])
    if name == "modcall":
        meta = get_meth_fixture(b)

        def run(prefix, host):
            # modcall appends to its VCF, as the reference does: every run
            # writes a new one, as one run of a user's would
            with contextlib.suppress(FileNotFoundError):
                os.remove(prefix + ".vcf")
            run_modcall(ModCallConfig(
                bam_files=[meta["bam"]], fasta_file=meta["fasta"],
                snp_file=meta["vcf"], result_prefix=prefix,
                num_threads=NTHREADS, device=b.device))
        return Pipeline(name, meta["n_alignments"], run,
                        ["modcall", "-b", meta["bam"], "-r", meta["fasta"],
                         "-s", meta["vcf"]])
    raise ValueError(f"no pipeline {name!r}: one of {PIPELINES}")


def run_engine(p: Pipeline, prefix: str, host: bool, b: Bench) -> dict:
    """One run of ``p`` into ``prefix`` on ours (the gate's choice) or the
    host engines; its wall and counts. On a card a gpu ``phase`` must
    launch the flat path's four kernels; the host engines launch nothing
    and call nothing on the card."""
    counts = Counts()
    with environ(LPS_TAG_ENGINE="host" if host else None), counts:
        t0 = time.perf_counter()
        p.run(prefix, host)
        wall = time.perf_counter() - t0
    row = {"wall_s": wall, **counts.row(), "counts": counts.row(True)}
    if host:
        check(not any(row["launches"].values())
              and not any(row["device_calls"].values()),
              f"{p.name}: the host engines used the card: {row}")
    elif p.name == "phase":
        wgs_soak._check_flat_path(row, b.device, "phase")
    return row


def _measure_pair(b: Bench, p: Pipeline, ours_prefix: str):
    """``bench.py``'s protocol: a warm-up of each side, then ``b.reps``
    timed runs of ours, each after the reference binary's where it exists
    (its side runs only then). Returns (ours median, reference median or
    None, the per-rep ratios, ours' runs)."""
    have_ref = os.path.exists(REF_BIN)
    ref_args = p.ref_args + ["-o", b.path(f"golden_{p.name}")]
    if have_ref:
        wgs_soak.run_reference_binary(ref_args)
    run_engine(p, ours_prefix, False, b)
    ref_times, runs = [], []
    for _ in range(b.reps):
        if have_ref:
            ref_times.append(wgs_soak.run_reference_binary(ref_args))
        runs.append(run_engine(p, ours_prefix, False, b))
    ours_times = [r["wall_s"] for r in runs]
    ours_med = _median(ours_times)
    if have_ref:
        return (ours_med, _median(ref_times),
                [r / o for r, o in zip(ref_times, ours_times)], runs)
    return ours_med, None, [], runs


def writer_stats(out_bam: str) -> dict | None:
    """bam_writer_util's inputs, right after haplotag's last timed run:
    the native writer's wall and payload, and the best of three level-3
    BGZF compressions of the same payload on the same cores; None where
    the native writer did not run."""
    from .. import native

    stats = native.last_tag_write_stats()
    if not stats or stats[0] <= 0:
        return None
    payload = native.bgzf_inflate_file(out_bam)
    best_s = float("inf")
    for _ in range(3):
        t0 = time.monotonic()
        native.bgzf_compress(payload, 3)
        best_s = min(best_s, time.monotonic() - t0)
    libdeflate = native._lib._name == native._library_path(
        *native._VARIANTS[0])
    return {"wall_ms": stats[0], "payload_n": stats[1], "deflate_s": best_s,
            "deflate": "libdeflate" if libdeflate else "zlib"}


def bench_pipeline(b: Bench, name: str) -> dict:
    """``name`` timed as ``bench.py`` times it, then the host engines'
    run, whose outputs must equal ours. The pipeline's row."""
    p = pipeline(b, name)
    ours = b.path(f"ours_{name}")
    ours_s, ref_s, ratios, runs = _measure_pair(b, p, ours)
    writer = writer_stats(ours + ".bam") if name == "haplotag" else None
    host = b.path(f"host_{name}")
    host_run = run_engine(p, host, True, b)
    mine, theirs = outputs(name, ours), outputs(name, host)
    diff = sorted(k for k in mine if mine[k] != theirs[k])
    check(not diff, f"{name}: ours and the host engines differ in {diff}")
    return {"name": name, "n_units": p.n_units, "ours_s": ours_s,
            "ref_s": ref_s, "ratios": ratios,
            "ours_reps_s": [r["wall_s"] for r in runs],
            "host_s": host_run["wall_s"], "equal": sorted(mine),
            "bam_cache": p.bam_cache,
            "writer": writer, **runs[-1]["counts"]}


def run_pipelines(b: Bench, only=PIPELINES) -> tuple[list, list]:
    """Every pipeline of ``only`` in ``PIPELINES``' order; a failed one
    is reported and leaves a NaN row, as in ``bench.py``. Returns the
    rows and the failures (``name: error``)."""
    from ..utils.device import resolve_device

    resolve_device(b.device)
    os.makedirs(b.work, exist_ok=True)
    rows, failures = [], []
    for name in PIPELINES:
        if name not in only:
            continue
        try:
            rows.append(bench_pipeline(b, name))
        except Exception as e:  # one broken pipeline must not hide the rest
            print(f"bench {name} failed: {e!r}", file=sys.stderr)
            failures.append(f"{name}: {e!r}")
            rows.append({"name": name, "n_units": 0,
                         "ours_s": float("nan"), "ref_s": None,
                         "ratios": []})
    return rows, failures


# ---------------------------------------------------------------------------
# the writer and the kernels
# ---------------------------------------------------------------------------


def writer_metrics(lines: list, stats: dict | None) -> None:
    """bam_writer_util: the native tag writer's measured wall (record
    assembly, parallel BGZF level 3, ordered fwrite) against a parallel
    level-3 compression of the same payload, both taken inside
    haplotag's row; util = deflate wall / writer wall, vs_baseline the
    writer's payload MB/s. ``deflate`` names the library the port's
    native build found (the card's host has zlib only). ``stats``:
    ``writer_stats``' of haplotag's row, or None (no line)."""
    if not stats:
        return
    wall_ms = stats["wall_ms"]
    util = (stats["deflate_s"] * 1e3) / wall_ms
    writer_mb_s = stats["payload_n"] / 1e6 / (wall_ms / 1e3)
    lines.append({"metric": "bam_writer_util", "value": round(util, 4),
                  "unit": "fraction_of_deflate_sol",
                  "vs_baseline": round(writer_mb_s, 1),
                  "payload_mb": round(stats["payload_n"] / 1e6, 1),
                  "writer_ms": round(wall_ms, 1),
                  "deflate_ms": round(stats["deflate_s"] * 1e3, 1),
                  "deflate": stats["deflate"]})


def card_info(device: str) -> dict:
    """The device's name, and on a card its power limit and maximum SM
    clock as ``nvidia-smi`` prints them."""
    import torch

    if not str(device).startswith("cuda"):
        return {"device": "cpu", "power_limit": None, "sm_clock_mhz": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    power, clock = (s.strip() for s in smi.split(","))
    return {"device": torch.cuda.get_device_name(0), "power_limit": power,
            "sm_clock_mhz": float(clock.split()[0])}


# The card's memory rate (H100 SXM, HBM3).
HBM_BYTES_PER_S = 3.35e12
# The steps a site adds to vote_scan's serial chain, by kind, counted from
# csrc/vote_scan.cu's register-ring loop (scan_chunk, every W up to 128):
# what site t+1 waits for from site t. The ring slot that site t+1
# consumes is a register that site t's votes update last, so the chain
# is one warp shuffle of that slot (__shfl_sync of r.hh[R0]; cnt and oo
# go in parallel) and then, one after another: (1) split the 16-bit
# halves, (2) test oh1 and oh2 for zero, (3) combine that with cnt > 3
# into use_special, (4) select H1 and H2, (5) compare H1 == H2, (6) fold
# in the skip bit and t < last_connect into assigned, (7) select the
# packed add for the site's hp and assigned, (8) add it into the ring
# register: (1) and (8) integer arithmetic, (2)-(7) compares, predicate
# folds and selects. last_connect's own loop (select, compare, fold: 3
# operations) is shorter, and the code loads and their decode do not
# depend on the carry, so the unrolled loop hoists them. Each kind's
# latency is measured on the card (``chain_latency``).
CHAIN_STEPS = {"shuffle": 1, "alu": 2, "select": 6}


def chain_latency(device) -> dict:
    """Cycles of each kind of step of ``CHAIN_STEPS`` on ``device``'s
    card, measured by ``csrc/chain_latency.cu`` (clock64 over 4,096
    dependent steps of each kind in one warp), and ``cycles_per_site``:
    the chain's steps times their latencies. Raises off a card."""
    import torch

    from ..ops import _build

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"chain_latency times the card's steps, not {dev}'s")
    with torch.cuda.device(dev):
        out = torch.zeros(4, dtype=torch.int64, device=dev)
        sink = torch.zeros(32, dtype=torch.int32, device=dev)
        err = _build.library().lps_chain_latency(
            out.data_ptr(), sink.data_ptr(), 1, 3, 5,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch("chain_latency", err)
        shuffle, alu, select, steps = out.tolist()
    cycles = {"shuffle": shuffle / steps, "alu": alu / (2 * steps),
              "select": select / (2 * steps)}
    check(all(0 < c < 1000 for c in cycles.values()),
          f"chain_latency read {cycles} cycles a step")
    cycles["cycles_per_site"] = sum(n * cycles[k]
                                    for k, n in CHAIN_STEPS.items())
    return cycles


def chain_floor_ms(S: int, cycles_per_site: float,
                   sm_clock_mhz: float) -> float:
    """The least time of ``S`` sites of vote_scan's serial chain:
    ``S * cycles_per_site`` cycles at the SM clock."""
    return 1e3 * S * cycles_per_site / (sm_clock_mhz * 1e6)


# bench.py's synthetic phase input (its Mosaic check): S = 4096 - 7
# sites at 30x, each read spanning 128 sites, seed 0; K calls timed
SYNTH_S = 4096 - 7
UTIL_CALLS = 128


def synthetic_phase_input(seed: int = 0) -> dict:
    """``bench.py``'s input of ``pallas_compiled_ok``, without its
    padding: reads of 128 consecutive sites from random starts, random
    alleles, 5% low-quality observations, a site every 150 bp, every
    site a SNP; the alignment of an observation is its read."""
    import numpy as np

    S, cov, span = SYNTH_S, 30, 128
    rng = np.random.default_rng(seed)
    n_reads = S * cov // span
    No = n_reads * span
    m_read = np.repeat(np.arange(n_reads, dtype=np.int32), span)
    start = rng.integers(0, max(S - span, 1), n_reads)
    m_rank = (np.repeat(start, span)
              + np.tile(np.arange(span), n_reads)).astype(np.int32)
    m_allele = rng.integers(0, 2, No).astype(np.int8)
    m_qok = rng.random(No) > 0.05
    return {"m_read": m_read, "m_rank": m_rank, "m_allele": m_allele,
            "m_qok": m_qok, "m_aln": m_read.copy(),
            "positions": np.arange(S, dtype=np.int64) * 150,
            "vtype": np.zeros(S, np.int8), "n_aln": n_reads}


def kernels_compiled_ok(x: dict, device) -> bool:
    """``ops/fused.run_fused_phase`` on ``device`` equals the same call on
    the cpu (the kernels' plain versions): ``ps`` and ``ori`` on every
    site."""
    import numpy as np

    from ..core.phase_algo import PhaseParams
    from ..ops import fused

    args = [x[k] for k in ("m_read", "m_rank", "m_allele", "m_qok", "m_aln",
                           "positions", "vtype", "n_aln")]
    ps, ori = fused.run_fused_phase(*args, PhaseParams(), device=device)
    ps_c, ori_c = fused.run_fused_phase(*args, PhaseParams(), device="cpu")
    return bool(np.array_equal(ps, ps_c) and np.array_equal(ori, ori_c))


def device_step(x: dict, device):
    """The device half of the phase step on ``x`` uploaded to ``device``
    once: a function that runs the pair stage, the serial vote scan, the
    block assembly and the read correction (as
    ``ops/fused.launch_fused_phase_batch`` does after its upload), and
    the tensors it reads and writes."""
    import numpy as np
    import torch

    from ..core.phase_algo import PhaseParams
    from ..ops import cuda_scan, fused
    from ..ops.vote_scan import site_gaps

    params = PhaseParams()
    W, S = params.connect_adjacent, len(x["positions"])
    seg = np.array([0, S], np.int64)
    stream = fused.stream_to_device(x["m_read"], x["m_rank"], x["m_allele"],
                                    x["m_qok"], device)
    aln, pos, vtype, gap = (torch.from_numpy(np.ascontiguousarray(a)).to(
        device) for a in (x["m_aln"], x["positions"], x["vtype"],
                          site_gaps(x["positions"])))

    def step():
        codes, site = fused.pair_codes(stream, gap, vtype, S, W,
                                       params.distance,
                                       float(params.edge_threshold) * 10.0)
        assigned, hp, bstart = cuda_scan.vote_serial_segments(codes, site,
                                                              seg, W)
        ps, ori = fused.device_assemble_blocks(assigned, hp, bstart, pos, S,
                                               seg)
        return fused.device_read_correction(
            ps, ori, vtype, stream[1], stream[2], aln, x["n_aln"],
            params.read_confidence, params.snp_confidence)
    return step, (*stream, aln, pos, vtype, gap)


def step_bound(inputs, outputs, S: int, cycles: dict,
               sm_clock_mhz: float) -> dict:
    """The least time of the device step: its bytes (each input read
    once, each output written once) over ``HBM_BYTES_PER_S``, plus the
    serial chain of its ``S`` sites at ``cycles["cycles_per_site"]``
    (``chain_floor_ms``). The two add and do not overlap: the step's
    kernels run one after another on one stream, every byte counted is
    moved by the pair stage before the scan or by the assembly and
    correction after it, and the scan itself moves none of them (its
    codes and site words are the pair stage's, not the step's inputs)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*inputs, *outputs))
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    chain_ms = chain_floor_ms(S, cycles["cycles_per_site"], sm_clock_mhz)
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "chain_ms": chain_ms,
            "chain_cycles": cycles, "bound_ms": bytes_ms + chain_ms}


def step_ms(step, calls: int = UTIL_CALLS) -> float:
    """Mean device milliseconds of ``step()`` over ``calls`` calls after
    two warm-up calls, timed with CUDA events on the current stream."""
    import torch

    for _ in range(2):
        step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def synthetic_tag_walk(seed: int = 7):
    """``bench.py``'s synthetic germline walk of ``tag_kernel_device_ok``:
    400,000 observations over 4,000 alignments and 3,000 variants."""
    import numpy as np

    rng = np.random.default_rng(seed)
    No, A, S = 400_000, 4_000, 3_000
    acgt = np.frombuffer(b"ACGT", np.uint8)
    walk = {
        "obs_var": rng.integers(0, S, No).astype(np.int32),
        "obs_aln": np.sort(rng.integers(0, A, No)).astype(np.int32),
        "obs_base": rng.choice(acgt, No),
        "obs_flags": rng.integers(0, 16, No).astype(np.uint8),
        "obs_kind": rng.choice(np.array([0, 0, 0, 1], np.uint8), No),
        "obs_aux": rng.integers(0, 50, No).astype(np.int32),
        "category": np.zeros(A, np.uint8),
    }
    t = {
        "pos": np.arange(S, dtype=np.int64) * 97 + 1000,
        "has": rng.random(S) > 0.05,
        "vtype": rng.choice(np.array([1, 1, 2, 3], np.int8), S),
        "gt": np.zeros(S, np.int8),
        "ps": rng.integers(1, 1 << 30, S),
        "snp_ref": rng.choice(acgt, S),
        "snp_alt": rng.choice(acgt, S),
        "hp1c": rng.choice(acgt, S),
        "hp2c": rng.choice(acgt, S),
        "hp1_long": rng.random(S) > 0.8,
        "hp2_long": rng.random(S) > 0.8,
    }
    return walk, t


def tag_kernel_check(device) -> tuple[bool, float]:
    """``ops/tag_kernels.germline_counts`` on ``device`` against the host's
    ``germline_votes`` and ``aggregate_reads`` on the synthetic walk:
    (equal, the best of three calls' ms after a warm-up, transfers
    included)."""
    import numpy as np

    from ..models.haplotag_fast import aggregate_reads, germline_votes
    from ..ops import tag_kernels

    walk, t = synthetic_tag_walk()
    h1, h2, cps = germline_votes(walk, t, True)
    host = aggregate_reads(walk, t, h1, h2, cps)
    dev = tag_kernels.germline_counts(walk, t, True, device=device)
    ms = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        tag_kernels.germline_counts(walk, t, True, device=device)
        ms = min(ms, (time.perf_counter() - t0) * 1e3)
    ok = all(np.array_equal(np.asarray(a), np.asarray(c))
             for a, c in zip(host, dev))
    return ok, ms


def device_metrics(b: Bench, info: dict | None = None) -> list:
    """The kernel lines (see the module docstring), each with ``info``
    (default ``card_info``); on the cpu, as ``bench.py`` on a CPU
    backend, every value None."""
    info = info or card_info(b.device)
    if not str(b.device).startswith("cuda"):
        return [{"metric": m, "value": None, "unit": u, "vs_baseline": None,
                 **info} for m, u in (("kernels_compiled_ok", "bool"),
                                      ("tag_kernel_device_ok", "bool"),
                                      ("phase_kernel_util",
                                       "fraction_of_sol"))]
    from ..utils.device import resolve_device

    dev = resolve_device(b.device)
    x = synthetic_phase_input()
    lines = [{"metric": "kernels_compiled_ok",
              "value": int(kernels_compiled_ok(x, dev)), "unit": "bool",
              "vs_baseline": None, **info}]
    ok, ms = tag_kernel_check(dev)
    lines.append({"metric": "tag_kernel_device_ok", "value": int(ok),
                  "unit": "bool", "vs_baseline": round(ms, 3), **info})
    step, inputs = device_step(x, dev)
    per_call = step_ms(step)
    bound = step_bound(inputs, step(), SYNTH_S, chain_latency(dev),
                       info["sm_clock_mhz"])
    lines.append({"metric": "phase_kernel_util",
                  "value": round(bound["bound_ms"] / per_call, 4),
                  "unit": "fraction_of_sol",
                  "vs_baseline": round(per_call * 1e3, 1),  # us/call
                  "calls": UTIL_CALLS, "sites": SYNTH_S,
                  "observations": len(x["m_read"]), **bound, **info})
    return lines


# ---------------------------------------------------------------------------
# the lines
# ---------------------------------------------------------------------------


def haplotag_writer(rows) -> dict | None:
    """The writer's stats of haplotag's row, where it ran."""
    return next((r["writer"] for r in rows if r.get("writer")), None)


def _geo(rs):
    return round(math.exp(sum(math.log(r) for r in rs) / len(rs)), 4)


def result_lines(rows, writer_lines, device_lines, info) -> list:
    """``bench.py``'s lines: the writer's, the kernels', one a pipeline,
    then the geometric mean; each pipeline's line also holds its
    walls, counts and gate choices, and the device."""
    lines = list(writer_lines) + list(device_lines)
    med_ratios, min_ratios = [], []
    for row in rows:
        n_units, ours_s, reps = row["n_units"], row["ours_s"], row["ratios"]
        value = round(n_units / ours_s, 2) if ours_s and ours_s == ours_s \
            else None
        line = {"metric": f"{row['name']}_reads_per_s", "value": value,
                "unit": "alignments/s", "vs_baseline": None}
        if reps and ours_s and ours_s == ours_s:
            vs = round(_median(reps), 4)
            med_ratios.append(vs)
            min_ratios.append(min(reps))
            line["vs_baseline"] = vs
            line["ratio_spread"] = [round(min(reps), 4), round(max(reps), 4)]
            line["reps"] = len(reps)
        line.update({k: row[k] for k in (
            "n_units", "ours_s", "ref_s", "ours_reps_s", "host_s", "equal",
            "bam_cache", "launches", "device_calls", "gate") if k in row})
        line.update(info)
        lines.append(line)
    geo = _geo(med_ratios) if med_ratios else None
    lines.append({"metric": "overall_speedup_geomean", "value": geo,
                  "unit": "x_vs_reference", "vs_baseline": geo,
                  "floor": _geo(min_ratios) if min_ratios else None})
    return lines


def run_bench(b: Bench, only=PIPELINES) -> dict:
    """The whole bench: the pipelines of ``only``, the writer and the
    kernels. Returns the lines, the rows and the failures."""
    rows, failures = run_pipelines(b, only)
    writer = []
    writer_metrics(writer, haplotag_writer(rows))
    info = card_info(b.device)
    lines = result_lines(rows, writer, device_metrics(b, info),
                         {k: info[k] for k in ("device", "power_limit")})
    return {"lines": lines, "rows": rows, "failures": failures}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m " + MODULE,
                                description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?", default=BENCH_DIR)
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--only", default=",".join(PIPELINES),
                   help="pipelines to run, comma-separated")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cold-bam", action="store_true",
                   help="drain the decoded-BAM cache in every run")
    p.add_argument("--stages", action="store_true",
                   help="also the stage split (testing/stage_breakdown.py)")
    p.add_argument("--out", default=None, help="where the lines, rows and "
                   "stages go as JSON")
    args = p.parse_args(argv)
    only = tuple(s for s in args.only.split(",") if s)
    for name in only:
        if name not in PIPELINES:
            p.error(f"--only: no pipeline {name!r}")
    b = Bench(args.workdir, args.device, args.length_scale, args.reps,
              "cold" if args.cold_bam else "warm")
    out = run_bench(b, only)
    if args.stages:
        from . import stage_breakdown

        out["stages"] = stage_breakdown.breakdown(b, only)
        for row in out["stages"]:
            print(json.dumps({"stages": row}), flush=True)
    out["cut"] = {"length_scale": args.length_scale,
                  "phase_length": b.cfg(PHASE_CFG)["length"],
                  "somatic_length": b.cfg(SOMATIC_CFG)["length"],
                  "meth_length": b.cfg(METH_CFG)["length"]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    for line in out["lines"]:
        print(json.dumps(line), flush=True)
    if out["failures"]:
        print(f"bench: {len(out['failures'])} failed: {out['failures']}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
