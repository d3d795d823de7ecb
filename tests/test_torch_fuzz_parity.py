"""The port's fuzzer (``longphase_s_tpu_torch/testing/fuzz_parity.py``)
against the JAX package: ``run_case`` with the JAX package's pipeline
functions as the golden side, called as ``tests/fuzz_parity.py`` calls
them (``run_phase`` with engine ``tpu``, ``run_haplotag``,
``run_somatic_haplotag`` with the somatic VCF and the calling logs,
``run_modcall``), and the port on the CPU as ours: the gpu phase engine
(the plain versions of its kernels) and every tag step on both tag
engines, which must agree with each other too.

The six modes at seed 1000 on the plain profile and at seed 1001 under
``--realism``; every comparison of the JAX tool, exact. Then the module's
own behaviour: the seeds it takes, a failed case's file and exit code,
and the parameters it simulates.
"""

import os

import pytest

from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.modcall import ModCallConfig, run_modcall
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.models.somatic import SomaticConfig, run_somatic_haplotag
from longphase_s_tpu_torch.testing import fuzz_parity as fp
# a fixture: the cram surface compares CRAM bytes with JAX's native writer's
from tests.test_torch_self_contained import jax_native_up  # noqa: F401


class JaxRunner:
    """The JAX package's pipelines, called as tests/fuzz_parity.py:70-76,
    :86-89, :108-112, :123-126, :144-146 and :171-175 call them."""

    def __init__(self):
        self.runs = []

    def _run(self, step, fn):
        import time

        t0 = time.perf_counter()
        fn()
        self.runs.append({"step": step, "engine": "jax",
                          "wall_s": time.perf_counter() - t0,
                          "launches": {}, "device_calls": {}})

    def phase(self, prefix, vcf, bam, fasta, ont=False, indels=False,
              sv_file="", mod_file="", **opts):
        self._run("phase", lambda: run_phase(PhaseConfig(
            snp_file=vcf, bam_files=[bam], fasta_file=fasta,
            result_prefix=prefix, sv_file=sv_file, mod_file=mod_file,
            engine="tpu", is_ont=ont, is_pb=not ont, phase_indel=indels,
            params=PhaseParams(is_ont=ont, phase_indel=indels), **opts)))

    def haplotag(self, prefix, vcf, bam, fasta, sv_file="", mod_file="",
                 **opts):
        self._run("haplotag", lambda: run_haplotag(HaplotagConfig(
            snp_file=vcf, sv_file=sv_file, mod_file=mod_file, bam_file=bam,
            fasta_file=fasta, result_prefix=prefix, **opts)))

    def somatic_haplotag(self, prefix, vcf, tumor_vcf, normal_bam,
                         tumor_bam, fasta, **opts):
        from longphase_s_tpu import native

        native.drain_bam_cache()
        opts = {"write_somatic_vcf": True, "write_calling_log": True, **opts}
        self._run("somatic_haplotag", lambda: run_somatic_haplotag(
            SomaticConfig(snp_file=vcf, tumor_snv_file=tumor_vcf,
                          bam_file=normal_bam, tumor_bam_file=tumor_bam,
                          fasta_file=fasta, result_prefix=prefix, **opts)))

    def modcall(self, prefix, bam, fasta):
        self._run("modcall", lambda: run_modcall(ModCallConfig(
            bam_files=[bam], fasta_file=fasta, snp_file="",
            result_prefix=prefix)))


def _ours():
    return fp.PortRunner("cpu", "gpu", ("device", "host"))


# chip_smoke.py phase 14's twelve cases: seed 1000 plain, 1001 --realism
CASES = [(mode, 1000, False) for mode in fp.MODES] + \
    [(mode, 1001, True) for mode in fp.MODES]


@pytest.mark.parametrize("mode,seed,realism", CASES)
def test_fuzz_case_matches_jax(mode, seed, realism, tmp_path):
    golden, ours = JaxRunner(), _ours()
    row = fp.case_row(mode, seed, str(tmp_path), golden, ours, realism)
    assert row["ok"], row["msg"]
    assert not os.path.exists(tmp_path / f"{mode}_{seed}")
    steps = [r["step"] for r in ours.runs]
    want = {"modcall": ["modcall", "modcall"],
            "somatic": ["somatic_haplotag"] * 2}.get(
        mode, ["phase", "haplotag", "haplotag"])
    assert steps == want
    assert [r["engine"] for r in ours.runs if r["step"] != "phase"] == \
        ["device", "host"]


@pytest.fixture(scope="module")
def surfaces(tmp_path_factory, jax_native_up):
    """The surfaces' fixtures and the JAX package's phased VCFs of them."""
    work = str(tmp_path_factory.mktemp("surfaces"))
    fixtures = fp.surface_fixtures(work)
    return fixtures, fp.phase_surface_inputs(work, fixtures, JaxRunner())


@pytest.mark.parametrize("name", fp.SURFACES)
def test_surface_matches_jax(name, surfaces, tmp_path):
    """Each surface chip_smoke.py phase 14 drives on the card, here with
    the JAX package as the golden side and the port on both tag
    engines."""
    fixtures, phased = surfaces
    golden, ours = JaxRunner(), _ours()
    row = fp.surface_row(name, str(tmp_path), fixtures, phased, golden, ours)
    assert row["ok"], row["msg"]
    assert [r["engine"] for r in ours.runs] == (
        ["gpu"] if name == "deepsomatic" else ["device", "host"])


def test_surface_outputs_are_not_empty(surfaces, tmp_path):
    """What the surfaces compare is there: a preprocessed VCF without the
    PASS rows, a read log, fewer reads in a range than in the contig, a
    CRAM, streamed somatic calls."""
    fixtures, phased = surfaces
    golden, ours = JaxRunner(), _ours()
    for name in fp.SURFACES:
        assert fp.run_surface(name, str(tmp_path / name), fixtures, phased,
                              golden, ours) is None, name
    pre = (tmp_path / "deepsomatic" / "ours_preprocessed.vcf").read_text()
    assert "GERMLINE" in pre and "\tPASS\t" not in pre
    fasta = fixtures["germ"]["fasta"]
    log = fp.haplotag_outputs(str(tmp_path / "log" / "ours"), fasta)
    assert len(log[".out"]) > 100
    ranged = fp.tagged_reads(str(tmp_path / "region_range" / "ours"), fasta)
    whole = fp.tagged_reads(str(tmp_path / "region_contig" / "ours"), fasta)
    assert 0 < len(ranged) < len(whole)
    assert os.path.exists(tmp_path / "cram" / "ours.cram")
    assert not os.path.exists(tmp_path / "cram" / "ours.bam")
    som = fp.somatic_outputs(str(tmp_path / "stream_somatic" / "ours"))
    assert sum(not r.startswith("#") for r in som["_sc.vcf"]) > 0


def test_case_outputs_are_not_empty(tmp_path):
    """A case's outputs hold what the comparisons compare: phased rows,
    tagged reads, somatic calls, modcall rows."""
    golden, ours = JaxRunner(), _ours()
    work = str(tmp_path / "pb")
    assert fp.run_case("pb", 1000, work, golden, ours) is None
    rows = fp.vcf_rows(os.path.join(work, "ours.vcf"))
    assert sum("|" in r for r in rows) > 20
    tags = fp.bam_tags(os.path.join(work, "oh.bam"))
    assert sum(t[3] is not None for t in tags) > 100
    work = str(tmp_path / "somatic")
    assert fp.run_case("somatic", 1000, work, golden, ours) is None
    out = fp.somatic_outputs(os.path.join(work, "ours"))
    assert all(out[sfx] for sfx in fp.SOMATIC_LOGS)
    assert sum(not r.startswith("#") for r in out["_sc.vcf"]) > 0


def test_failed_case_is_reported(tmp_path, monkeypatch, capsys):
    """A difference writes FAIL_<mode>_<seed>.txt, keeps the case's
    directory, prints [FAIL] and makes main exit 1; the seeds run in order
    from FUZZ_BASE."""
    real = fp.PortRunner.modcall

    def broken(self, prefix, bam, fasta):
        real(self, prefix, bam, fasta)
        if self.label == "ours":
            with open(prefix + ".vcf", "a") as f:
                f.write("chr20\t1\t.\tC\tT\t.\t.\t.\n")

    monkeypatch.setattr(fp.PortRunner, "modcall", broken)
    monkeypatch.setattr(fp, "MODES", ("modcall",))
    monkeypatch.setenv("FUZZ_BASE", "1002")
    assert fp.cases(2) == [("modcall", 1002), ("modcall", 1003)]
    rc = fp.main([str(tmp_path), "1", "--device", "cpu"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "[FAIL] modcall_1002: modcall VCF differs" in out
    assert (tmp_path / "FAIL_modcall_1002.txt").read_text() == \
        "modcall VCF differs\n"
    assert os.path.isdir(tmp_path / "modcall_1002")


def test_engines_that_differ_fail_the_case(tmp_path, monkeypatch):
    """A runner whose two tag engines disagree fails the case even where
    its first engine agrees with the golden side."""
    from longphase_s_tpu_torch.models import haplotag as port_haplotag

    real = port_haplotag.run_haplotag

    def host_drops_a_record(cfg):
        real(cfg)
        if os.environ.get("LPS_TAG_ENGINE") == "host":
            from longphase_s_tpu_torch.io.bam import BamReader, BamWriter

            r = BamReader(cfg.result_prefix + ".bam")
            recs = list(r)
            w = BamWriter(cfg.result_prefix + ".bam", r.header_text,
                          r.references, r.lengths)
            for rec in recs[1:]:
                w.write(rec)
            w.close()
            r.close()

    monkeypatch.setattr(port_haplotag, "run_haplotag", host_drops_a_record)
    msg = fp.run_case("pb", 1000, str(tmp_path), JaxRunner(), _ours())
    assert msg == "ours haplotag: the host engine differs from the device " \
        "engine"


def test_case_fixture_follows_the_jax_tool(tmp_path):
    """The seed-derived parameters of tests/fuzz_parity.py: seed 1000's
    pb fixture is 100000 + (rng_bits % 7) * 30000 bp at 8 + seed % 12 x;
    --realism adds split reads (supplementary records)."""
    seed = 1000
    rng_bits = (seed * 2654435761) & 0xFFFF
    fix = fp.case_fixture("pb", seed, str(tmp_path / "plain"))
    assert fix["length"] == 100000 + (rng_bits % 7) * 30000
    real = fp.case_fixture("pb", seed, str(tmp_path / "real"), realism=True)
    flags = [t[1] for t in fp.bam_tags(real["bam"])]
    assert any(f & 0x800 for f in flags)
    assert not any(t[1] & 0x800 for t in fp.bam_tags(fix["bam"]))
