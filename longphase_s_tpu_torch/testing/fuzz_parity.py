"""Randomized parity fuzzer of the port: the counterpart of
``tests/fuzz_parity.py``.

Sweeps seeds across six pipeline modes (``pb``, ``ont``, ``indels``,
``somatic``, ``svmod``, ``modcall``), each seed's fixture simulated by
``testing/simulate.py`` with the JAX tool's formulas, and holds one runner
(``ours``) record for record against another (``golden``). The JAX tool's
golden side is the reference binary; here it is a runner the caller
passes in:

- on the card, ``ours`` is the port on ``--device`` with the gpu phase
  engine and ``LPS_TAG_ENGINE=device``, ``golden`` the port's host engines
  (the ``oracle`` phase engine, ``LPS_TAG_ENGINE=host``);
- in the tier-1 tests (``tests/test_torch_fuzz_parity.py``), ``golden`` is
  the JAX package's pipeline functions, called as the JAX tool calls them,
  and ``ours`` the port on the CPU with both tag engines.

A runner has the methods ``phase``, ``haplotag``, ``somatic_haplotag`` and
``modcall`` of ``PortRunner`` (the first three pass keyword options to
their config as they are). The haplotag steps run on the golden
phased VCF; in ``somatic`` mode the golden side phases the normal sample
and both sides run ``somatic_haplotag`` on that VCF. The comparisons are
the JAX tool's: VCF rows without ``##`` lines (``.vcf``, ``_SV.vcf``,
``_mod.vcf``, ``_sc.vcf``, the modcall VCF), tags as (qname, flag, pos,
HP, PS, PQ), the seven somatic calling logs with the prefix replaced, and
``_purity.out`` (whether it exists, and its text).

    python -m longphase_s_tpu_torch.testing.fuzz_parity <workdir> [n_seeds]
        [--realism] [--device cuda|cpu] [--jobs N] [--out rows.json]

Seeds run in order from ``FUZZ_BASE`` (default 1000), 50 by default;
``--realism`` simulates every fixture but modcall's under
``simulate.REALISM_PROFILE`` (homopolymer indels, split reads at SV
breakpoints, chimeras). A failed case writes ``FAIL_<mode>_<seed>.txt``
into the work directory and prints ``[FAIL]``; a case that passes prints
``[ok]`` and its directory is removed. ``--jobs`` runs that many cases at
once in spawned worker processes. The exit code is 1 when any case failed
(the JAX tool exits 0 either way). On a CUDA device every gpu-engine
``phase`` must launch each flat-path kernel (``ops/_build.LAUNCHES``) and
every device-engine tag or modcall pass must run its reductions on the
card (``ops/tag_kernels.DEVICE_CALLS``), or the case fails.

``SURFACES`` are the options and knobs a seed sweep does not reach, held
the same way on two fixtures of the golden tests (``surface_fixtures``):
``phase --deepsomatic_output``, ``haplotag --log`` (whose read log takes
the host object path in both packages, so no reduction runs on a card),
``--region`` as a contig and as a range, ``--cram``, and
``LPS_MAX_INMEM_BAM=1000`` streaming for ``haplotag`` and
``somatic_haplotag`` (without the calling log, whose tag pass takes the
host object path in both packages, as the fuzz cases' does), each run by
``surface_row``. ``chip_smoke.py`` phase 14 runs twelve cases and every
surface on the card, ``tests/test_torch_fuzz_parity.py`` every surface
against JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import sys
import time

MODULE = "longphase_s_tpu_torch.testing.fuzz_parity"
MODES = ("pb", "ont", "indels", "somatic", "svmod", "modcall")
FLAT_PATH = ("bucket_count", "bucket_scatter", "pair_cast", "vote_scan")
# the reductions a device-engine pass must run on the card
DEVICE_REDUCTIONS = {
    "haplotag": ("germline",),
    "somatic_haplotag": ("somatic_normal", "somatic_extract",
                         "somatic_haplotag"),
    "modcall": ("modcall_edges",),
}
# the calling logs the JAX tool byte-compares (tests/fuzz_parity.py:178-182)
SOMATIC_LOGS = ("_somatic_var.out", "_dense_tumor_snp_interval.log",
                "_somatic_filter.log", "_read_count_filter.log",
                "_messy_read_filter.log", "_read_distri_scaller.out",
                "_germlineReadHpCountInNorBam_histogram.out")


class CaseMismatch(AssertionError):
    """A difference inside one runner (its engines disagree, or a device
    run did not reach the card); ``run_case`` returns its message."""


def vcf_rows(path: str) -> list[str]:
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def bam_tags(path: str) -> list[tuple]:
    from ..io.bam import BamReader

    r = BamReader(path)
    try:
        return [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                 rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
    finally:
        r.close()


def _prefixed_lines(path: str, prefix: str) -> list[str]:
    with open(path) as f:
        return [line.replace(prefix, "P") for line in f]


def cram_tags(path: str, fasta: str) -> list[tuple]:
    from ..io.cram import CramReader
    from ..io.fasta import FastaFile

    return [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
             rec.get_tag("PS"), rec.get_tag("PQ"))
            for rec in CramReader(path, fasta=FastaFile(fasta))]


def cram_body(path: str) -> bytes:
    """A CRAM's bytes but its file id (bytes 6-25, the tail of the path
    it was written to)."""
    with open(path, "rb") as f:
        data = f.read()
    return data[:6] + data[26:]


def tagged_reads(prefix: str, fasta: str) -> list[tuple]:
    """The tags of ``prefix.bam``, or of ``prefix.cram`` where no BAM was
    written."""
    if os.path.exists(prefix + ".bam"):
        return bam_tags(prefix + ".bam")
    return cram_tags(prefix + ".cram", fasta)


def haplotag_outputs(prefix: str, fasta: str) -> dict:
    """The tags and, where written, the read log with the prefix
    replaced."""
    out = {"tags": tagged_reads(prefix, fasta)}
    if os.path.exists(prefix + ".out"):
        out[".out"] = _prefixed_lines(prefix + ".out", prefix)
    return out


def somatic_outputs(prefix: str, fasta: str = "") -> dict:
    """Every output of ``somatic_haplotag`` the JAX tool compares, with
    the prefix replaced; a missing file is None."""
    out = {}
    for sfx in SOMATIC_LOGS + ("_purity.out",):
        path = prefix + sfx
        out[sfx] = (_prefixed_lines(path, prefix) if os.path.exists(path)
                    else None)
    out["_sc.vcf"] = vcf_rows(prefix + "_sc.vcf")
    out["tags"] = tagged_reads(prefix, fasta)
    return out


# the outputs of each tag step by which a runner's engines are compared
STEP_OUTPUTS = {
    "haplotag": haplotag_outputs,
    "somatic_haplotag": somatic_outputs,
    "modcall": lambda prefix, fasta: vcf_rows(prefix + ".vcf"),
}


@contextlib.contextmanager
def environ(**values):
    """The environment variables ``values`` set (None: unset) while the
    block runs, then restored."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class PortRunner:
    """The port's pipelines through its model functions, as the JAX tool
    calls the JAX package's. ``phase_engine`` is ``gpu`` or ``oracle``;
    each tag step runs once for each of ``tag_engines`` (the first writes
    ``prefix``, the others ``prefix.<engine>``) and raises ``CaseMismatch``
    where their outputs differ. ``runs`` records every call: the step, the
    engine, its wall, the kernel launches and the device calls."""

    def __init__(self, device: str = "cuda", phase_engine: str = "gpu",
                 tag_engines=("device",), label: str = "ours"):
        self.device = device
        self.phase_engine = phase_engine
        self.tag_engines = tuple(tag_engines)
        self.label = label
        self.cuda = str(device).startswith("cuda")
        self.runs: list[dict] = []

    def _run(self, step: str, engine: str, fn, expect=None) -> None:
        """``fn`` timed, its launches and device calls recorded. On a CUDA
        device a gpu-engine phase must launch every flat-path kernel and
        a device-engine tag step must run each reduction of ``expect``
        (by default ``DEVICE_REDUCTIONS[step]``) there."""
        from .wgs_soak import Counts

        with Counts() as counts:
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        row = counts.row(nonzero=True)
        launches, calls = row["launches"], row["device_calls"]
        self.runs.append({"step": step, "engine": engine, "wall_s": wall,
                          "launches": launches, "device_calls": calls})
        if not self.cuda:
            return
        if step == "phase" and engine == "gpu":
            missing = [k for k in FLAT_PATH if not launches.get(k)]
            if missing:
                raise CaseMismatch(f"{self.label} phase launched no "
                                   f"{missing} on {self.device}")
        if engine == "device":
            if expect is None:
                expect = DEVICE_REDUCTIONS[step]
            missing = [k for k in expect if not calls.get(k)]
            if missing:
                raise CaseMismatch(f"{self.label} {step} ran no {missing} "
                                   f"reduction on {self.device}")

    def _tag_step(self, step: str, prefix: str, fasta: str, make_cfg, run,
                  expect=None) -> None:
        outputs = {}
        for i, engine in enumerate(self.tag_engines):
            out = prefix if i == 0 else f"{prefix}.{engine}"
            with environ(LPS_TAG_ENGINE=engine):
                self._run(step, engine, lambda: run(make_cfg(out)), expect)
            outputs[engine] = STEP_OUTPUTS[step](out, fasta)
        first = self.tag_engines[0]
        for engine in self.tag_engines[1:]:
            if outputs[engine] != outputs[first]:
                raise CaseMismatch(f"{self.label} {step}: the {engine} "
                                   f"engine differs from the {first} engine")

    def phase(self, prefix, vcf, bam, fasta, ont=False, indels=False,
              sv_file="", mod_file="", **opts):
        from ..core.phase_algo import PhaseParams
        from ..models.phase import PhaseConfig, run_phase

        cfg = PhaseConfig(
            snp_file=vcf, bam_files=[bam], fasta_file=fasta,
            result_prefix=prefix, sv_file=sv_file, mod_file=mod_file,
            engine=self.phase_engine, device=self.device, is_ont=ont,
            is_pb=not ont, phase_indel=indels,
            params=PhaseParams(is_ont=ont, phase_indel=indels), **opts)
        self._run("phase", self.phase_engine, lambda: run_phase(cfg))

    def haplotag(self, prefix, vcf, bam, fasta, sv_file="", mod_file="",
                 **opts):
        from ..models.haplotag import HaplotagConfig, run_haplotag

        # the read log takes the host object path (as in the JAX package)
        expect = () if opts.get("write_read_log") else None
        self._tag_step("haplotag", prefix, fasta, lambda out: HaplotagConfig(
            snp_file=vcf, sv_file=sv_file, mod_file=mod_file, bam_file=bam,
            fasta_file=fasta, result_prefix=out, device=self.device, **opts),
            run_haplotag, expect)

    def somatic_haplotag(self, prefix, vcf, tumor_vcf, normal_bam,
                         tumor_bam, fasta, **opts):
        from ..models.somatic import SomaticConfig, run_somatic_haplotag

        opts = {"write_somatic_vcf": True, "write_calling_log": True, **opts}
        # with a log the tag pass takes the host object path (as in the
        # JAX package): only the extraction passes reduce on the card
        expect = None
        if opts["write_calling_log"] or opts.get("write_read_log"):
            expect = ("somatic_normal", "somatic_extract")
        self._tag_step("somatic_haplotag", prefix, fasta,
                       lambda out: SomaticConfig(
                           snp_file=vcf, tumor_snv_file=tumor_vcf,
                           bam_file=normal_bam, tumor_bam_file=tumor_bam,
                           fasta_file=fasta, result_prefix=out,
                           device=self.device, **opts),
                       run_somatic_haplotag, expect)

    def modcall(self, prefix, bam, fasta):
        from ..models.modcall import ModCallConfig, run_modcall

        self._tag_step("modcall", prefix, fasta, lambda out: ModCallConfig(
            bam_files=[bam], fasta_file=fasta, snp_file="",
            result_prefix=out, device=self.device), run_modcall)


def case_fixture(mode: str, seed: int, work: str,
                 realism: bool = False) -> dict:
    """The fixture of one case under ``work/fix``, from the JAX tool's
    seed-derived parameters (tests/fuzz_parity.py:54-62, :94-100,
    :134-138, :151-155); modcall keeps the plain profile."""
    from . import simulate

    os.makedirs(work, exist_ok=True)
    out = os.path.join(work, "fix")
    rng_bits = (seed * 2654435761) & 0xFFFF
    if mode in ("pb", "ont", "indels"):
        return simulate.make_fixture(
            out, seed=seed, realism=realism,
            length=100000 + (rng_bits % 7) * 30000,
            coverage=8 + seed % 12, read_len=4000 + (rng_bits % 5) * 2500,
            snp_rate=0.0008 + (seed % 5) * 0.0004,
            indel_rate=0.0004 if mode == "indels" else 0.0,
            error_rate=0.01 + (seed % 4) * 0.02, qual=15 + (seed % 4) * 8)
    if mode == "svmod":
        return simulate.make_fixture(
            out, seed=seed, realism=realism,
            length=120000 + (rng_bits % 5) * 30000,
            coverage=12 + seed % 10, read_len=6000 + (rng_bits % 4) * 2500,
            snp_rate=0.001 + (seed % 4) * 0.0004,
            error_rate=0.01 + (seed % 3) * 0.02, qual=18 + (seed % 3) * 8,
            n_svs=2 + seed % 7, n_mods=2 + (seed >> 2) % 8)
    if mode == "modcall":
        return simulate.make_meth_fixture(
            out, seed=seed, length=100000 + (rng_bits % 4) * 40000,
            coverage=10 + seed % 16, read_len=5000 + (rng_bits % 4) * 2500,
            n_asm=4 + seed % 12, n_homo_mod=2 + (seed >> 3) % 8)
    if mode == "somatic":
        return simulate.make_somatic_fixture(
            out, seed=seed, realism=realism,
            length=120000 + (rng_bits % 5) * 30000,
            purity=0.15 + (seed % 8) * 0.1,
            n_somatic=8 + seed % 20, n_artifacts=seed % 8)
    raise ValueError(mode)


def _compare_case(mode: str, work: str, fix: dict, golden, ours):
    """One case's runs and comparisons (tests/fuzz_parity.py:63-189);
    the first difference as a message, or None."""
    def p(name):
        return os.path.join(work, name)

    if mode in ("pb", "ont", "indels"):
        flags = dict(ont=(mode == "ont"), indels=(mode == "indels"))
        golden.phase(p("golden"), fix["vcf"], fix["bam"], fix["fasta"],
                     **flags)
        ours.phase(p("ours"), fix["vcf"], fix["bam"], fix["fasta"], **flags)
        g, o = vcf_rows(p("golden.vcf")), vcf_rows(p("ours.vcf"))
        if g != o:
            n = sum(1 for a, b in zip(g, o) if a != b)
            return f"phase VCF rows differ ({n} of {len(g)}/{len(o)})"
        golden.haplotag(p("gh"), p("golden.vcf"), fix["bam"], fix["fasta"])
        ours.haplotag(p("oh"), p("golden.vcf"), fix["bam"], fix["fasta"])
        if bam_tags(p("gh.bam")) != bam_tags(p("oh.bam")):
            return "haplotag tags differ"
        return None
    if mode == "svmod":
        files = dict(sv_file=fix["sv_vcf"], mod_file=fix["mod_vcf"])
        golden.phase(p("golden"), fix["vcf"], fix["bam"], fix["fasta"],
                     **files)
        ours.phase(p("ours"), fix["vcf"], fix["bam"], fix["fasta"], **files)
        for suffix in (".vcf", "_SV.vcf", "_mod.vcf"):
            if vcf_rows(p("golden") + suffix) != vcf_rows(p("ours") + suffix):
                return f"phase{suffix} differs"
        files = dict(sv_file=p("golden_SV.vcf"), mod_file=p("golden_mod.vcf"))
        golden.haplotag(p("gh"), p("golden.vcf"), fix["bam"], fix["fasta"],
                        **files)
        ours.haplotag(p("oh"), p("golden.vcf"), fix["bam"], fix["fasta"],
                      **files)
        if bam_tags(p("gh.bam")) != bam_tags(p("oh.bam")):
            return "haplotag svmod tags differ"
        return None
    if mode == "modcall":
        golden.modcall(p("golden"), fix["bam"], fix["fasta"])
        ours.modcall(p("ours"), fix["bam"], fix["fasta"])
        if vcf_rows(p("golden.vcf")) != vcf_rows(p("ours.vcf")):
            return "modcall VCF differs"
        return None
    if mode == "somatic":
        golden.phase(p("phased"), fix["normal_vcf"], fix["normal_bam"],
                     fix["fasta"])
        pair = (p("phased.vcf"), fix["tumor_vcf"], fix["normal_bam"],
                fix["tumor_bam"], fix["fasta"])
        golden.somatic_haplotag(p("golden"), *pair)
        ours.somatic_haplotag(p("ours"), *pair)
        # the calling logs carry the full float surface (VAFs, z-scores,
        # ratios): byte-compare them all
        for sfx in SOMATIC_LOGS:
            g, o = p("golden") + sfx, p("ours") + sfx
            if os.path.exists(g) != os.path.exists(o):
                return f"{sfx} presence differs"
            if os.path.exists(g) and (_prefixed_lines(g, p("golden"))
                                      != _prefixed_lines(o, p("ours"))):
                return f"{sfx} differs"
        g_has = os.path.exists(p("golden_purity.out"))
        o_has = os.path.exists(p("ours_purity.out"))
        if g_has != o_has:
            return (f"purity report presence differs (golden={g_has} "
                    f"ours={o_has})")
        if g_has:
            with open(p("golden_purity.out")) as fg, \
                    open(p("ours_purity.out")) as fo:
                if fg.read() != fo.read():
                    return "purity report differs"
        if vcf_rows(p("golden_sc.vcf")) != vcf_rows(p("ours_sc.vcf")):
            return "_sc.vcf differs"
        if bam_tags(p("golden.bam")) != bam_tags(p("ours.bam")):
            return "somatic tags differ"
        return None
    raise ValueError(mode)


def run_case(mode: str, seed: int, work: str, golden, ours,
             realism: bool = False, fix: dict | None = None) -> str | None:
    """One case in ``work``: the fixture (``fix``, or simulated by
    ``case_fixture``), then ``golden`` against ``ours``; the first
    difference as a message, or None. A ``CaseMismatch`` either runner
    raises is a difference."""
    if fix is None:
        fix = case_fixture(mode, seed, work, realism)
    try:
        return _compare_case(mode, work, fix, golden, ours)
    except CaseMismatch as e:
        return str(e)


# ---------------------------------------------------------------------------
# the surfaces
# ---------------------------------------------------------------------------

SURFACES = ("deepsomatic", "log", "region_contig", "region_range", "cram",
            "stream_haplotag", "stream_somatic")


def surface_fixtures(work: str) -> dict:
    """The surfaces' fixtures: ``tests/conftest.py``'s small_fixture
    (``germ``) and ``tests/test_golden_somatic.py``'s pair (``som``)."""
    from . import simulate

    return {"germ": simulate.make_fixture(
                os.path.join(work, "germ"), seed=7, length=120000,
                coverage=20, read_len=12000, snp_rate=0.001),
            "som": simulate.make_somatic_fixture(
                os.path.join(work, "som"), seed=42, length=250000,
                normal_coverage=25, tumor_coverage=30, purity=0.6,
                n_somatic=25, n_artifacts=6)}


def phase_surface_inputs(work: str, fixtures: dict, golden) -> dict:
    """The golden side's phased VCFs of both fixtures (the germline
    sample, the normal sample)."""
    os.makedirs(work, exist_ok=True)
    germ, som = fixtures["germ"], fixtures["som"]
    golden.phase(os.path.join(work, "germ_phased"), germ["vcf"], germ["bam"],
                 germ["fasta"])
    golden.phase(os.path.join(work, "som_phased"), som["normal_vcf"],
                 som["normal_bam"], som["fasta"])
    return {"germ": os.path.join(work, "germ_phased.vcf"),
            "som": os.path.join(work, "som_phased.vcf")}


def write_deepsomatic_vcf(path: str, fix: dict, rng) -> None:
    """A DeepSomatic-style VCF of ``fix``'s SNVs
    (``tests/test_golden_deepsomatic.py``'s writer): somatic-like PASS rows
    (dropped by the preprocessing), homozygous GERMLINE rows, and GERMLINE
    rows whose wrong GT the preprocessing re-derives from AD."""
    chrom = fix["chrom"]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={fix['length']}>\n")
        f.write('##FILTER=<ID=PASS,Description="ok">\n')
        f.write('##FILTER=<ID=GERMLINE,Description="germline">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n')
        f.write('##FORMAT=<ID=AD,Number=.,Type=Integer,Description="AD">\n')
        f.write('##FORMAT=<ID=VAF,Number=.,Type=Float,Description="VAF">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for pos, ref_a, alt_a, _hap in fix["variants"]:
            if len(ref_a) != 1 or len(alt_a) != 1:
                continue
            r = rng.random()
            row = f"{chrom}\t{pos + 1}\t.\t{ref_a}\t{alt_a}"
            if r < 0.1:
                f.write(f"{row}\t12\tPASS\t.\tGT:AD:VAF\t0/1:25,5:0.17\n")
                continue
            if r < 0.2:
                f.write(f"{row}\t40\tGERMLINE\t.\tGT:AD:VAF\t0/0:1,29:0.97\n")
                continue
            ref_d = 13 + int(rng.integers(0, 5))
            alt_d = 14 + int(rng.integers(0, 5))
            f.write(f"{row}\t40\tGERMLINE\t.\tGT:AD:VAF\t1/1:{ref_d},{alt_d}:"
                    f"{alt_d / (ref_d + alt_d):.3f}\n")


def _compare_surface(name: str, work: str, fixtures: dict, phased: dict,
                     golden, ours):
    def p(label):
        return os.path.join(work, label)

    germ, som = fixtures["germ"], fixtures["som"]
    hap = (phased["germ"], germ["bam"], germ["fasta"])
    if name == "deepsomatic":
        import numpy as np

        ds = p("deepsomatic.vcf")
        write_deepsomatic_vcf(ds, germ, np.random.default_rng(5))
        for side, runner in (("golden", golden), ("ours", ours)):
            runner.phase(p(side), ds, germ["bam"], germ["fasta"],
                         deepsomatic_output=True)
        with open(p("golden_preprocessed.vcf")) as fg, \
                open(p("ours_preprocessed.vcf")) as fo:
            if fg.read() != fo.read():
                return "_preprocessed.vcf differs"
        if vcf_rows(p("golden.vcf")) != vcf_rows(p("ours.vcf")):
            return "phase VCF rows differ"
        return None
    if name == "stream_somatic":
        pair = (phased["som"], som["tumor_vcf"], som["normal_bam"],
                som["tumor_bam"], som["fasta"])
        # without the calling log, so the tag pass streams too
        with environ(LPS_MAX_INMEM_BAM="1000"):
            golden.somatic_haplotag(p("golden"), *pair,
                                    write_calling_log=False)
            ours.somatic_haplotag(p("ours"), *pair, write_calling_log=False)
        g = somatic_outputs(p("golden"), som["fasta"])
        o = somatic_outputs(p("ours"), som["fasta"])
        diff = [k for k in g if g[k] != o[k]]
        return f"somatic outputs differ: {diff}" if diff else None
    opts, env = {}, {}
    if name == "log":
        opts["write_read_log"] = True
    elif name == "region_contig":
        opts["region"] = germ["chrom"]
    elif name == "region_range":
        third = germ["length"] // 3
        opts["region"] = f"{germ['chrom']}:{third}-{2 * third}"
    elif name == "cram":
        opts["output_cram"] = True
    elif name == "stream_haplotag":
        env["LPS_MAX_INMEM_BAM"] = "1000"
    else:
        raise ValueError(name)
    with environ(**env):
        golden.haplotag(p("golden"), *hap, **opts)
        ours.haplotag(p("ours"), *hap, **opts)
    g = haplotag_outputs(p("golden"), germ["fasta"])
    o = haplotag_outputs(p("ours"), germ["fasta"])
    if g["tags"] != o["tags"]:
        return "haplotag tags differ"
    if g.get(".out") != o.get(".out"):
        return "read log differs"
    if name == "cram" and (cram_body(p("golden.cram"))
                           != cram_body(p("ours.cram"))):
        return "CRAM bytes differ"
    return None


def run_surface(name: str, work: str, fixtures: dict, phased: dict, golden,
                ours) -> str | None:
    """One surface in ``work`` on ``fixtures`` and the golden side's
    ``phased`` VCFs: the first difference as a message, or None."""
    os.makedirs(work, exist_ok=True)
    try:
        return _compare_surface(name, work, fixtures, phased, golden, ours)
    except CaseMismatch as e:
        return str(e)


def port_runners(device: str = "cuda") -> tuple[PortRunner, PortRunner]:
    """(golden, ours) of a run on ``device``: the port's host engines and
    the port on the device."""
    return (PortRunner(device, "oracle", ("host",), label="golden"),
            PortRunner(device, "gpu", ("device",), label="ours"))


def _row(tag: str, workdir: str, golden, ours, run) -> dict:
    """``run(case_dir)`` in ``workdir/<tag>`` as the JAX tool runs a case
    (an exception is a failure; a failure writes ``FAIL_<tag>.txt`` and
    keeps the directory, a pass removes it); one row: the message or
    None, the walls, each side's launches and device calls."""
    case_dir = os.path.join(workdir, tag)
    n_golden, n_ours = len(golden.runs), len(ours.runs)
    t0 = time.perf_counter()
    try:
        msg = run(case_dir)
    except Exception as e:  # noqa: BLE001
        msg = f"exception: {e!r}"
    wall = time.perf_counter() - t0
    runs = {"golden": golden.runs[n_golden:], "ours": ours.runs[n_ours:]}
    row = {"case": tag, "ok": not msg, "msg": msg, "wall_s": wall}
    for side, rs in runs.items():
        row[f"{side}_s"] = sum(r["wall_s"] for r in rs)
        launches, calls = {}, {}
        for r in rs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for k, v in r["device_calls"].items():
                calls[k] = calls.get(k, 0) + v
        row[f"{side}_launches"], row[f"{side}_device_calls"] = launches, calls
    if msg:
        with open(os.path.join(workdir, f"FAIL_{tag}.txt"), "w") as f:
            f.write(msg + "\n")
    else:
        shutil.rmtree(case_dir, ignore_errors=True)
    return row


def case_row(mode: str, seed: int, workdir: str, golden, ours,
             realism: bool = False, fix: dict | None = None) -> dict:
    """``run_case`` in ``workdir/<mode>_<seed>``; its row (``_row``) with
    the mode, the seed and the profile."""
    row = _row(f"{mode}_{seed}", workdir, golden, ours,
               lambda d: run_case(mode, seed, d, golden, ours, realism, fix))
    row.update(mode=mode, seed=seed, realism=realism)
    return row


def surface_row(name: str, workdir: str, fixtures: dict, phased: dict,
                golden, ours) -> dict:
    """``run_surface`` in ``workdir/<name>``; its row (``_row``)."""
    return _row(name, workdir, golden, ours,
                lambda d: run_surface(name, d, fixtures, phased, golden,
                                      ours))


def row_line(row: dict) -> str:
    """The line a case prints: ``[ok]`` or ``[FAIL]``, the case, the
    message, the walls."""
    tag = row["case"]
    walls = (f"(case {row['wall_s']:.3f} s, golden {row['golden_s']:.3f} s, "
             f"ours {row['ours_s']:.3f} s)")
    if row["ok"]:
        return f"[ok] {tag} {walls}"
    return f"[FAIL] {tag}: {row['msg']} {walls}"


def _case_task(mode: str, seed: int, workdir: str, device: str,
               realism: bool) -> dict:
    """One case in a worker process, with runners of its own."""
    golden, ours = port_runners(device)
    return case_row(mode, seed, workdir, golden, ours, realism)


def cases(n_seeds: int):
    """(mode, seed) in the JAX tool's order: seeds from ``FUZZ_BASE``, the
    six modes each."""
    base = int(os.environ.get("FUZZ_BASE", "1000"))
    return [(mode, seed) for seed in range(base, base + n_seeds)
            for mode in MODES]


def fuzz(workdir: str, n_seeds: int = 50, realism: bool = False,
         device: str = "cuda", jobs: int = 1, out: str = "") -> list[dict]:
    """Every case of ``cases(n_seeds)``, ``jobs`` at once; prints a line a
    case in order and returns the rows (also written to ``out``)."""
    os.makedirs(workdir, exist_ok=True)
    rows = []

    def done(row):
        rows.append(row)
        print(row_line(row), flush=True)
        if out:
            with open(out, "w") as f:
                json.dump(rows, f, indent=1)

    golden, ours = port_runners(device)
    if jobs <= 1:
        for mode, seed in cases(n_seeds):
            done(case_row(mode, seed, workdir, golden, ours, realism))
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        from .. import native
        from ..ops import _build

        # build once here, not in every worker at once
        native.available()
        if ours.cuda:
            _build.library()
        task = importlib.import_module(MODULE)._case_task  # by name: spawn
        with ProcessPoolExecutor(max_workers=jobs, mp_context=multiprocessing
                                 .get_context("spawn")) as pool:
            pending = [pool.submit(task, mode, seed, workdir, device,
                                   realism) for mode, seed in cases(n_seeds)]
            for f in pending:
                done(f.result())
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m longphase_s_tpu_torch.testing.fuzz_parity",
        description="seeds x modes of the port's device engines against "
                    "its host engines")
    ap.add_argument("workdir")
    ap.add_argument("n_seeds", nargs="?", type=int, default=50)
    ap.add_argument("--realism", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = fuzz(args.workdir, args.n_seeds, args.realism, args.device,
                args.jobs, args.out)
    fails = sum(not r["ok"] for r in rows)
    print(f"done: {fails} failures over {args.n_seeds} seeds x {len(MODES)} "
          f"modes in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
