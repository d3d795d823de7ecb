"""Chromosome-scale soak of the port: the main path from a BAM at the size
users run, on the card.

Counterpart of ``tools/wgs_soak.py`` (the JAX package's scale run), with
its three configurations letter for letter: ``CFG``, a 64 Mbp chromosome
(chr20 scale: 319,951 het sites, 213,332 reads of 12 kb at 20x),
``SOMATIC_CFG``, a 32 Mbp tumour/normal pair, and ``PHASEMEM_CFG``, a
250 Mbp chromosome (chr1 scale). Fixtures come from ``testing/simulate``
and are cached under the work directory by ``fixture*.json`` markers.

    python -m longphase_s_tpu_torch.testing.wgs_soak [workdir] [--length N]
        [--somatic-only] [--phase-mem] [--skip-wavefront]
        [--device cuda|cpu] [--out rows.json]

As in the JAX tool, the default run is steps 1-4 on ``CFG``,
``--somatic-only`` runs step 5 on ``SOMATIC_CFG`` and ``--phase-mem``
step 6 on ``PHASEMEM_CFG``.
``--length`` sets the length of every configuration the run simulates
(the somatic and artifact counts scale with it, ``cut``), and is printed
as the cut. Steps:

1. ``phase``: ``cli phase --pb`` (the device step on ``--device``) against
   the same run on ``--device cpu`` (the kernels' plain versions) and, in
   the full run, the reference binary ``.refbuild/longphase-s`` where it
   exists, else ``--engine oracle``: the VCFs (without ``##longphase`` and
   ``##commandline``) equal. On a card the flat path's four kernels must
   launch and ``vote_cast`` must not.
2. the split of the timed phase run: ``native.extract_phase`` (BAM decode
   and the allele walk), ``core/fastpath.merge_observations``, the device
   step ``ops/fused.run_fused_phase``, the rest of
   ``core/fastpath.phase_chromosome_flat``, the VCF writer, and what
   remains of the wall (VCF parse, reference fetch, filters); on a card
   also the busy share, the kernel and copy time ``torch.profiler``
   records over the wall.
3. ``haplotag`` whole-file, then streaming under ``LPS_MAX_INMEM_BAM`` =
   64 MiB (half the BAM where that is less), then whole-file with
   ``LPS_TAG_ENGINE=host``: equal tags (qname, flag, pos, HP, PS, PQ),
   and how many walks the engine gate (``ops/tag_kernels.engine``) sent
   to the device and to the host.
4. the wavefront: ``cli phase`` with ``LPS_MULTICHIP=1 LPS_WAVEFRONT=1``,
   its VCF equal to step 1's; on a card the carry kernel launches.
5. somatic: the normal sample phased by the port, then ``cli
   somatic_haplotag --output-somatic-vcf`` and ``cli estimate_purity``
   with the device engine and with the host engine: ``_sc.vcf``, the tags
   and ``_purity.out`` equal, the purity above 0 (in the full run also
   equal to the reference binary's where it exists).
6. ``--phase-mem``: ``cli phase`` whole-file against streaming under a
   256 MiB input budget, equal VCFs, the streaming peak RSS under 8 GB.

Every run is a fresh interpreter (``python -m ... --child``) that runs the
command once as a warm-up (page cache, CUDA context, kernel libraries),
drops the native BAM handle cache so the timed run decodes the BAM as a
fresh process would, then runs it again timed, and reports its wall, its
peak RSS over both runs (``PeakRss``, sampled), peak device memory,
kernel launches (``ops/_build.LAUNCHES``), tag reductions on the card
(``ops/tag_kernels.DEVICE_CALLS``) and the gate's choices. Reference runs are single runs. Any failed equality raises
``SoakMismatch``; a failed run raises ``RuntimeError`` with its stderr
tail; ``--device cuda`` without a card fails. The step functions are what
``chip_smoke.py`` phase 12 and the tests call.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_BIN = os.path.join(ROOT, ".refbuild", "longphase-s")
MODULE = "longphase_s_tpu_torch.testing.wgs_soak"

CFG = dict(seed=33, length=64_000_000, coverage=20, read_len=12000,
           snp_rate=0.005, error_rate=0.04, qual=22)
SOMATIC_CFG = dict(seed=37, length=32_000_000, normal_coverage=25,
                   tumor_coverage=30, purity=0.6, n_somatic=2500,
                   n_artifacts=600, read_len=12000, snp_rate=0.0012,
                   error_rate=0.02, qual=25)
PHASEMEM_CFG = dict(seed=53, length=250_000_000, coverage=20,
                    read_len=12000, snp_rate=0.001, error_rate=0.03,
                    qual=22)

# the kernels of cli phase's flat path, and the one it must not launch
FLAT_PATH = ("bucket_count", "bucket_scatter", "pair_cast", "vote_scan")
STREAM_BUDGET = 64 << 20      # step 3's LPS_MAX_INMEM_BAM
PHASEMEM_BUDGET = 256 << 20   # step 6's
REPORT = "LPS_SOAK_REPORT "
# the parts of the timed phase run (step 2), in pipeline order
SPLIT_KEYS = ("ingest_s", "merge_s", "step_s", "rest_s", "write_s",
              "other_s")


class SoakMismatch(AssertionError):
    """An output of the port differs from the one it must equal."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SoakMismatch(msg)


# counts a chromosome that a cut scales with its length, so that their
# density per Mbp stays the configuration's (a tumour/normal pair of
# SOMATIC_CFG's 3,100 sites kept 300 bp apart from each other and from
# every germline site has no room for them below about 5 Mbp; the same
# holds for the methylated CpG sites of a methylation fixture)
PER_LENGTH = ("n_somatic", "n_artifacts", "n_asm", "n_homo_mod")


def cut(cfg: dict, length: int | None) -> dict:
    """``cfg`` at ``length`` (None keeps it), its ``PER_LENGTH`` counts
    scaled with it (at least 1); every other key as it was."""
    if length is None:
        return dict(cfg)
    out = dict(cfg, length=int(length))
    for key in PER_LENGTH:
        if key in cfg:
            out[key] = max(1, round(cfg[key] * length / cfg["length"]))
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def _cached(work: str, marker: str, cfg: dict, build):
    """The fixture ``build()`` makes, or the one a marker file records for
    the same ``cfg``. ``build`` returns the metadata (paths, counts)."""
    path = os.path.join(work, marker)
    key = {k: str(v) for k, v in cfg.items()}
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
        files = [v for k, v in meta.items() if k in (
            "bam", "vcf", "fasta", "normal_bam", "tumor_bam", "normal_vcf",
            "tumor_vcf")]
        if meta.get("cfg") == key and all(map(os.path.exists, files)):
            return meta
    t0 = time.perf_counter()
    meta = build()
    meta["cfg"] = key
    meta["simulate_s"] = time.perf_counter() - t0
    os.makedirs(work, exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f)
    return meta


def _germline_fixture(work, marker, subdir, cfg):
    def build():
        from .simulate import make_fixture

        fix = make_fixture(os.path.join(work, subdir), **cfg)
        return {"bam": fix["bam"], "vcf": fix["vcf"], "fasta": fix["fasta"],
                "chrom": fix["chrom"], "n_reads": len(fix["reads"]),
                "n_sites": len(fix["variants"])}
    return _cached(work, marker, cfg, build)


def get_fixture(work: str, cfg: dict = CFG) -> dict:
    """The phase and haplotag fixture (default ``CFG``)."""
    return _germline_fixture(work, "fixture.json", "fix", cfg)


def get_phasemem_fixture(work: str, cfg: dict = PHASEMEM_CFG) -> dict:
    """The ``--phase-mem`` fixture (default ``PHASEMEM_CFG``)."""
    return _germline_fixture(work, "fixture_phasemem.json", "fix_pm", cfg)


def get_somatic_fixture(work: str, cfg: dict = SOMATIC_CFG) -> dict:
    """The tumour/normal pair (default ``SOMATIC_CFG``)."""
    def build():
        from .simulate import make_somatic_fixture

        fix = make_somatic_fixture(os.path.join(work, "fix_som"), **cfg)
        return {k: fix[k] for k in ("normal_bam", "tumor_bam", "normal_vcf",
                                    "tumor_vcf", "fasta", "chrom")}
    return _cached(work, "fixture_somatic.json", cfg, build)


# ---------------------------------------------------------------------------
# the child interpreter
# ---------------------------------------------------------------------------


def _split_wrappers(split: dict, sync):
    """Time the parts of ``cli phase`` (step 2) into ``split``, the card
    synchronized at every boundary; returns the undo list."""
    from .. import native
    from ..core import fastpath
    from ..io import vcf as vcf_io
    from ..models import phase

    undo = []

    def wrap(module, name, key):
        fn = getattr(module, name)

        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                split[key] += time.perf_counter() - t0
        setattr(module, name, timed)
        undo.append((module, name, fn))

    wrap(native, "extract_phase", "ingest_s")
    wrap(fastpath, "merge_observations", "merge_s")
    wrap(fastpath, "run_fused_phase", "step_s")
    wrap(phase, "phase_chromosome_flat", "flat_s")
    wrap(vcf_io, "rewrite_result_vcf", "write_s")
    return undo


def _device_time(prof) -> dict:
    """Seconds of kernels, copies and fills on the card in a profile."""
    from torch.autograd import DeviceType

    out = {"kernel_s": 0.0, "memcpy_s": 0.0, "memset_s": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("memcpy_s" if e.name.startswith("Memcpy") else
               "memset_s" if e.name.startswith("Memset") else "kernel_s")
        out[key] += e.time_range.elapsed_us() / 1e6
    return out


def resident_bytes() -> int | None:
    """This process's resident set now (``/proc/self/statm``, else
    ``VmRSS`` of ``/proc/self/status``), or None where neither is given."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class PeakRss:
    """The peak of ``resident_bytes`` over a ``with`` block, sampled every
    ``period`` seconds on a thread. ``ru_maxrss`` would carry the parent's
    resident set at the fork into an exec'd child, and ``VmHWM`` is not
    given everywhere."""

    def __init__(self, period: float = 0.01):
        import threading

        self.period, self.peak = period, resident_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.period):
            self._sample()

    def _sample(self):
        now = resident_bytes()
        if now is not None:
            self.peak = max(self.peak or 0, now)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()

    @property
    def gb(self) -> float | None:
        return None if self.peak is None else self.peak / 1e9


def _timed_run(spec, run, sync, cuda, windows):
    """The timed run of ``child_main``: the window count and the card's
    peak memory reset first, the split and the profile taken where asked.
    Returns (wall, split or None, the card's busy time or None)."""
    import torch

    windows[0] = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    split = dict.fromkeys(("ingest_s", "merge_s", "step_s", "flat_s",
                           "write_s"), 0.0)
    undo = _split_wrappers(split, sync) if spec["split"] else []
    prof = None
    if undo and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        run()
        sync()
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        for module, name, fn in undo:
            setattr(module, name, fn)
    if undo:
        flat = split.pop("flat_s")
        split["rest_s"] = flat - split["merge_s"] - split["step_s"]
        split["other_s"] = wall - split["ingest_s"] - flat - split["write_s"]
        split = {k: split[k] for k in SPLIT_KEYS}
    return wall, (split if undo else None), (
        _device_time(prof) if prof is not None else None)


def child_main(spec: dict) -> dict:
    """Run ``cli.main(spec["argv"])``: a warm-up run when
    ``spec["warmup"]``, then the timed run; returns the report."""
    import torch

    from .. import cli, native

    cuda = spec["device"].startswith("cuda")
    if spec["stream_window"]:
        native.StreamingBam.WINDOW = int(spec["stream_window"])
    windows = [0]
    stream_windows = native.StreamingBam._windows

    def counted_windows(self, chrom):
        for window in stream_windows(self, chrom):
            windows[0] += 1
            yield window
    native.StreamingBam._windows = counted_windows

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run():
        rc = cli.main(list(spec["argv"]))
        if rc != 0:
            raise RuntimeError(f"cli {spec['argv'][0]} returned {rc}")

    with PeakRss() as rss:
        if spec["warmup"]:
            run()
            native.drain_bam_cache()
            sync()
        with Counts() as counts:
            wall, split, busy = _timed_run(spec, run, sync, cuda, windows)
    report = {
        "wall_s": wall,
        "peak_rss_gb": rss.gb,
        "peak_device_mb": (torch.cuda.max_memory_allocated() / 1e6
                           if cuda else None),
        "launches": counts.launches,
        "device_calls": counts.device_calls,
        "engines": counts.gate, "stream_windows": windows[0],
        "warm": bool(spec["warmup"]),
        "leaked": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "longphase_s_tpu"))}
    if split is not None:
        report["split"] = split
    if busy is not None:
        report["device_time"] = busy
        report["busy_share"] = sum(busy.values()) / wall
    return report


def run_child(argv, device: str, env: dict | None = None,
              warmup: bool = True, split: bool = False,
              stream_window: int | None = None,
              timeout: float = 7200, module: str = MODULE) -> dict:
    """``cli`` ``argv`` in a fresh interpreter (``module``'s ``--child``,
    by default ``child_main``) with ``env`` added to this process's
    environment (a value of None removes the variable); its report."""
    spec = {"argv": list(argv), "device": device, "warmup": warmup,
            "split": split, "stream_window": stream_window}
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, full_env.get("PYTHONPATH")) if p)
    for key, value in (env or {}).items():
        if value is None:
            full_env.pop(key, None)
        else:
            full_env[key] = value
    r = subprocess.run([sys.executable, "-m", module, "--child",
                        json.dumps(spec)], env=full_env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    lines = [line for line in r.stdout.splitlines()
             if line.startswith(REPORT)]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"cli {argv[0]} exited {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    report = json.loads(lines[-1][len(REPORT):])
    check(not report["leaked"], f"the port imported {report['leaked']}")
    return report


def run_reference_binary(args, timeout: float = 14400) -> float:
    """The reference binary on ``args`` with every core; its wall."""
    t0 = time.perf_counter()
    subprocess.run([REF_BIN, *args, "-t", str(os.cpu_count())], check=True,
                   capture_output=True, timeout=timeout)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------


def strip_vcf(path: str) -> list[str]:
    """The lines of a VCF but those that name the program and its
    arguments."""
    with open(path) as f:
        return [line for line in f
                if not line.startswith(("##longphase", "##commandline"))]


def text_lines(path: str) -> list[str]:
    """The lines of ``path`` but its ``##commandline``."""
    with open(path) as f:
        return [line for line in f if not line.startswith("##commandline")]


def tags_digest(path: str) -> str:
    """sha256 over every record's (qname, flag, pos, HP, PS, PQ)."""
    from ..io.bam import BamReader

    h = hashlib.sha256()
    r = BamReader(path)
    try:
        for rec in r:
            h.update(repr((rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                           rec.get_tag("PS"), rec.get_tag("PQ"))).encode())
    finally:
        r.close()
    return h.hexdigest()


def _purity(path: str) -> float:
    with open(path) as f:
        return float(f.read().strip().splitlines()[-1].rsplit(":", 1)[1])


class Counts:
    """Kernel launches (``ops/_build.LAUNCHES``), reductions on a card
    (``ops/tag_kernels.DEVICE_CALLS``) and the engine gate's choices over
    a ``with`` block, by difference: the global counts run on."""

    def __init__(self):
        self.launches, self.device_calls = {}, {}
        self.gate = {"device": 0, "host": 0}

    def __enter__(self):
        from ..ops import _build
        from ..ops import tag_kernels as tk

        self._before = (dict(_build.LAUNCHES), dict(tk.DEVICE_CALLS))
        self._engine = gate = tk.engine

        def counted(n_work=None):
            choice = gate(n_work)
            self.gate[choice] += 1
            return choice
        tk.engine = counted
        return self

    def __exit__(self, *exc):
        from ..ops import _build
        from ..ops import tag_kernels as tk

        tk.engine = self._engine
        for now, before, into in ((_build.LAUNCHES, self._before[0],
                                   self.launches),
                                  (tk.DEVICE_CALLS, self._before[1],
                                   self.device_calls)):
            for k, v in now.items():
                into[k] = into.get(k, 0) + v - before.get(k, 0)

    def row(self, nonzero: bool = False) -> dict:
        """The counts; with ``nonzero`` only the launches and calls that
        happened."""
        return {"launches": {k: v for k, v in self.launches.items()
                             if v or not nonzero},
                "device_calls": {k: v for k, v in self.device_calls.items()
                                 if v or not nonzero},
                "gate": dict(self.gate)}


def _check_flat_path(row: dict, device: str, label: str) -> None:
    """On a card the flat path's kernels launched and ``vote_cast`` did
    not; on the CPU the plain versions ran and nothing launched."""
    launches = row["launches"]
    if device.startswith("cuda"):
        check(all(launches[k] > 0 for k in FLAT_PATH)
              and launches["vote_cast"] == 0,
              f"{label} did not take the flat path: {launches}")
    else:
        check(not any(launches.values()), f"{label} launched {launches}")


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def phase_argv(fix: dict, prefix: str, device: str, *extra) -> list[str]:
    return ["phase", "--pb", "-s", fix["vcf"], "-b", fix["bam"], "-r",
            fix["fasta"], "-o", prefix, "--device", device, *extra]


def step_phase(fix: dict, work: str, device: str = "cuda",
               references=("cpu",)) -> dict:
    """Steps 1 and 2: ``cli phase`` on ``device``, timed and split, its
    VCF equal to each reference's (``"cpu"``: ``--device cpu``;
    ``"oracle"``: ``--engine oracle``; ``"binary"``: the reference
    binary)."""
    prefix = os.path.join(work, "phase")
    row = run_child(phase_argv(fix, prefix, device), device, split=True)
    row["sites_per_s"] = fix["n_sites"] / row["wall_s"]
    _check_flat_path(row, device, "cli phase")
    rows = {"phase": row}
    ours = strip_vcf(prefix + ".vcf")
    check(sum("|" in line for line in ours) > 0, "cli phase phased nothing")
    for ref in references:
        ref_prefix = os.path.join(work, f"phase_{ref}")
        if ref == "binary":
            wall = run_reference_binary(
                ["phase", "--pb", "-s", fix["vcf"], "-b", fix["bam"], "-r",
                 fix["fasta"], "-o", ref_prefix])
            rows[f"phase_{ref}"] = {"wall_s": wall}
        else:
            extra = ("--engine", "oracle") if ref == "oracle" else ()
            rows[f"phase_{ref}"] = run_child(
                phase_argv(fix, ref_prefix, "cpu", *extra), "cpu",
                warmup=False)
        check(strip_vcf(ref_prefix + ".vcf") == ours,
              f"cli phase on {device}: VCF differs from the {ref} run's")
        rows[f"phase_{ref}"]["vcf_equal"] = True
    return rows


def step_haplotag(fix: dict, phased_vcf: str, work: str,
                  device: str = "cuda", stream_budget: int = STREAM_BUDGET,
                  stream_window: int | None = None) -> dict:
    """Step 3: ``cli haplotag`` whole-file, streaming under
    ``LPS_MAX_INMEM_BAM=stream_budget`` (half the BAM's size where that
    is less, so that a cut fixture streams too; with ``StreamingBam``
    windows of ``stream_window`` bytes where given), and whole-file with
    the host engine: equal tags."""
    argv = ["haplotag", "-s", phased_vcf, "-b", fix["bam"], "-r",
            fix["fasta"], "--device", device]
    stream_budget = min(stream_budget, os.path.getsize(fix["bam"]) // 2)
    runs = (("haplotag_whole", {}),
            ("haplotag_stream", {"LPS_MAX_INMEM_BAM": str(stream_budget)}),
            ("haplotag_host", {"LPS_TAG_ENGINE": "host"}))
    rows, digests = {}, {}
    for name, env in runs:
        prefix = os.path.join(work, name)
        rows[name] = run_child(argv + ["-o", prefix], device, env=env,
                               stream_window=(stream_window if "stream" in
                                              name else None))
        rows[name]["reads_per_s"] = fix["n_reads"] / rows[name]["wall_s"]
        digests[name] = tags_digest(prefix + ".bam")
    rows["haplotag_stream"]["budget"] = stream_budget
    check(rows["haplotag_stream"]["stream_windows"] > 0
          and rows["haplotag_whole"]["stream_windows"] == 0,
          "the streaming run did not stream, or the whole-file run did")
    check(rows["haplotag_host"]["engines"]["device"] == 0,
          "the host engine sent a walk to the device")
    for name in ("haplotag_stream", "haplotag_host"):
        check(digests[name] == digests["haplotag_whole"],
              f"{name}: tags differ from the whole-file run's")
    rows["haplotag_tags_sha256"] = digests["haplotag_whole"]
    return rows


def step_wavefront(fix: dict, work: str, phase_vcf: str,
                   device: str = "cuda") -> dict:
    """Step 4: ``cli phase`` with ``LPS_MULTICHIP=1 LPS_WAVEFRONT=1``, its
    VCF equal to ``phase_vcf`` (step 1's)."""
    prefix = os.path.join(work, "wavefront")
    row = run_child(phase_argv(fix, prefix, device), device,
                    env={"LPS_MULTICHIP": "1", "LPS_WAVEFRONT": "1"})
    if device.startswith("cuda"):
        check(row["launches"]["vote_scan_carry"] > 0
              and row["launches"]["vote_scan"] == 0,
              f"the wavefront did not run: {row['launches']}")
    check(strip_vcf(prefix + ".vcf") == strip_vcf(phase_vcf),
          "the wavefront's VCF differs from cli phase's")
    return {"wavefront": row}


def step_somatic(sfix: dict, work: str, device: str = "cuda",
                 binary: bool = False) -> dict:
    """Step 5: the normal sample phased by the port on ``device``; ``cli
    somatic_haplotag --output-somatic-vcf`` and ``cli estimate_purity``
    with the device engine and with the host engine: ``_sc.vcf``, tags and
    ``_purity.out`` equal, the purity above 0; with ``binary`` also equal
    to the reference binary's."""
    phased = os.path.join(work, "som_phased")
    rows = {"somatic_phase": run_child(
        ["phase", "--pb", "-s", sfix["normal_vcf"], "-b", sfix["normal_bam"],
         "-r", sfix["fasta"], "-o", phased, "--device", device], device,
        warmup=False)}
    pair = ["-s", phased + ".vcf", "--tumor-snv-file", sfix["tumor_vcf"],
            "-b", sfix["normal_bam"], "--tumor-bam-file", sfix["tumor_bam"],
            "-r", sfix["fasta"]]
    outputs = {}
    for engine in ("device", "host"):
        prefix = os.path.join(work, f"somatic_{engine}")
        rows[f"somatic_{engine}"] = run_child(
            ["somatic_haplotag", *pair, "--output-somatic-vcf", "-o", prefix,
             "--device", device], device, env={"LPS_TAG_ENGINE": engine})
        purity_prefix = os.path.join(work, f"purity_{engine}")
        rows[f"purity_{engine}"] = run_child(
            ["estimate_purity", *pair, "-o", purity_prefix, "--device",
             device], device, env={"LPS_TAG_ENGINE": engine})
        outputs[engine] = (strip_vcf(prefix + "_sc.vcf"),
                           tags_digest(prefix + ".bam"),
                           text_lines(prefix + "_purity.out"),
                           text_lines(purity_prefix + "_purity.out"))
    for mode in ("somatic", "purity"):
        calls = rows[f"{mode}_device"]["device_calls"]
        if device.startswith("cuda"):
            check(calls["somatic_normal"] > 0 and calls["somatic_extract"] > 0,
                  f"{mode}: the device engine ran nothing on the card")
        check(not any(rows[f"{mode}_host"]["device_calls"].values()),
              f"{mode}: the host engine ran on the card")
    check(outputs["device"] == outputs["host"],
          "somatic: the device and host engines' outputs differ")
    sc, digest, purity_out, estimate_out = outputs["device"]
    rows["somatic_purity"] = _purity(os.path.join(
        work, "somatic_device_purity.out"))
    rows["estimate_purity"] = _purity(os.path.join(
        work, "purity_device_purity.out"))
    check(rows["somatic_purity"] > 0 and rows["estimate_purity"] > 0,
          f"purity {rows['somatic_purity']} / {rows['estimate_purity']} "
          "is not above 0")
    rows["somatic_pass"] = sum(line.split("\t")[6] == "PASS" for line in sc
                               if not line.startswith("#"))
    rows["somatic_tags_sha256"] = digest
    if binary:
        golden = os.path.join(work, "som_binary")
        rows["somatic_binary"] = {"wall_s": run_reference_binary(
            ["somatic_haplotag", *pair, "--output-somatic-vcf", "-o",
             golden])}
        check(strip_vcf(golden + "_sc.vcf") == sc,
              "somatic: _sc.vcf differs from the reference binary's")
        check(tags_digest(golden + ".bam") == digest,
              "somatic: tags differ from the reference binary's")
    return rows


def step_phase_mem(fix: dict, work: str, device: str = "cuda",
                   budget: int = PHASEMEM_BUDGET,
                   binary: bool = False) -> dict:
    """Step 6: ``cli phase`` whole-file against streaming under an input
    budget of ``budget`` bytes: equal VCFs, streaming peak RSS under 8
    GB."""
    check(os.path.getsize(fix["bam"]) > budget,
          "the streaming run's budget holds the whole BAM")
    rows = {}
    for name, env in (("phasemem_whole", {}),
                      ("phasemem_stream", {"LPS_MAX_INMEM_BAM": str(budget)})):
        rows[name] = run_child(
            phase_argv(fix, os.path.join(work, name), device), device,
            env=env)
    check(rows["phasemem_stream"]["peak_rss_gb"] < 8.0,
          f"streaming peak RSS {rows['phasemem_stream']['peak_rss_gb']} GB")
    stream = strip_vcf(os.path.join(work, "phasemem_stream.vcf"))
    check(stream == strip_vcf(os.path.join(work, "phasemem_whole.vcf")),
          "phase-mem: streaming and whole-file VCFs differ")
    if binary:
        golden = os.path.join(work, "pm_binary")
        rows["phasemem_binary"] = {"wall_s": run_reference_binary(
            ["phase", "--pb", "-s", fix["vcf"], "-b", fix["bam"], "-r",
             fix["fasta"], "-o", golden])}
        check(strip_vcf(golden + ".vcf") == stream,
              "phase-mem: VCF differs from the reference binary's")
    return rows


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------


def _say(label: str, value) -> None:
    print(f"{label}: {json.dumps(value)}", flush=True)


def soak(work: str, device: str = "cuda", length: int | None = None,
         somatic_only: bool = False, phase_mem: bool = False,
         skip_wavefront: bool = False) -> dict:
    """The tool's run (see the module docstring); the rows."""
    from ..utils.device import resolve_device

    resolve_device(device)
    os.makedirs(work, exist_ok=True)
    binary = os.path.exists(REF_BIN)
    rows = {"device": device, "reference": "binary" if binary else "oracle"}
    if phase_mem:
        cfg = cut(PHASEMEM_CFG, length)
        rows["cut"] = {"phasemem_length": cfg["length"]}
        _say("cut", rows["cut"])
        fix = get_phasemem_fixture(work, cfg)
        rows.update(step_phase_mem(fix, work, device, binary=binary))
        return rows
    if not somatic_only:
        cfg = cut(CFG, length)
        rows["cut"] = {"length": cfg["length"]}
        _say("cut", rows["cut"])
        fix = get_fixture(work, cfg)
        rows["fixture"] = {k: fix.get(k) for k in ("n_sites", "n_reads",
                                                   "simulate_s")}
        rows["fixture"]["bam_bytes"] = os.path.getsize(fix["bam"])
        rows.update(step_phase(fix, work, device,
                               references=("cpu", rows["reference"])))
        _say("phase", rows["phase"])
        rows.update(step_haplotag(fix, os.path.join(work, "phase.vcf"),
                                  work, device))
        _say("haplotag", {k: rows[k] for k in (
            "haplotag_whole", "haplotag_stream", "haplotag_host")})
        if not skip_wavefront:
            rows.update(step_wavefront(fix, work,
                                       os.path.join(work, "phase.vcf"),
                                       device))
            _say("wavefront", rows["wavefront"])
        return rows
    scfg = cut(SOMATIC_CFG, length)
    rows["cut"] = {k: scfg[k] for k in ("length", *PER_LENGTH) if k in scfg}
    _say("cut", rows["cut"])
    sfix = get_somatic_fixture(work, scfg)
    rows.update(step_somatic(sfix, work, device, binary=binary))
    _say("somatic", {k: rows[k] for k in (
        "somatic_device", "somatic_host", "purity_device", "purity_host",
        "somatic_purity")})
    return rows


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m " + MODULE,
                                description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(ROOT, ".bench_cache",
                                        "wgs_soak_torch"))
    p.add_argument("--length", type=int, default=None)
    p.add_argument("--somatic-only", action="store_true")
    p.add_argument("--phase-mem", action="store_true")
    p.add_argument("--skip-wavefront", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="where the rows go as JSON (default: "
                        "WORKDIR/soak.json)")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child is not None:
        print(REPORT + json.dumps(child_main(json.loads(args.child))),
              flush=True)
        return 0
    rows = soak(args.workdir, args.device, args.length, args.somatic_only,
                args.phase_mem, args.skip_wavefront)
    out = args.out or os.path.join(args.workdir, "soak.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    print(json.dumps({"soak": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
