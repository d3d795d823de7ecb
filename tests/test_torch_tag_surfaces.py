"""The surfaces of the port's ``haplotag`` and ``somatic_haplotag``
against the JAX package, each on the inputs of its golden test, with the
JAX package's ``run_haplotag`` / ``run_somatic_haplotag`` as the reference
and the port's ``cli --device cpu`` as ours, on both tag engines
(``LPS_TAG_ENGINE=device``, which runs ``ops/tag_kernels`` on the CPU,
and ``=host``). Every phased VCF is the JAX package's (oracle engine):

- ``haplotag --log``: the ``.out`` read log with the prefix replaced
  (test_golden_logs.py:35);
- ``haplotag --region``, a contig and a range (test_golden_misc.py:63,
  :38);
- a gzip or BGZF ``-s`` VCF (test_golden_misc.py:252);
- supplementary, secondary and duplicate reads, with and without
  ``--tagSupplementary`` (test_golden_misc.py:204);
- ``LPS_MAX_INMEM_BAM=1000``, where both packages stream the BAMs
  through windowed handles (test_golden_haplotag.py:42,
  test_golden_somatic.py:213);
- ``LPS_NO_NATIVE_TAG=1``, where both take the object path of the tag
  walk (JAX models/haplotag_fast.py:325, models/somatic.py:101);
- ``somatic_haplotag --somatic-calling-log``: all fourteen files
  (test_golden_logs.py:96);
- ``somatic_haplotag --checkpoint``: a run killed in the tumour pass of
  its second contig resumes (test_checkpoint.py:83).

Tags are (qname, flag, pos, HP, PS, PQ) of every record; ``_sc.vcf`` is
compared without ``##`` lines.
"""

import pytest

from longphase_s_tpu import native as jax_native
from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.models.somatic import SomaticConfig, run_somatic_haplotag
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch import native as port_native
from longphase_s_tpu_torch.models import somatic as port_somatic
from longphase_s_tpu_torch.testing.fuzz_parity import bam_tags, vcf_rows
from longphase_s_tpu_torch.testing.simulate import (
    make_fixture, make_multichrom_somatic_fixture, make_somatic_fixture,
    write_bam_with_index)
from tests.test_torch_phase_surfaces import compress_vcf

ENGINES = ["device", "host"]


def _oracle_phase(vcf, bam, fasta, prefix):
    run_phase(PhaseConfig(snp_file=vcf, bam_files=[bam], fasta_file=fasta,
                          result_prefix=prefix, is_pb=True, engine="oracle",
                          params=PhaseParams()))
    return prefix + ".vcf"


def _port(monkeypatch, engine, *argv):
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    rc = cli.main([*argv, "--device", "cpu"])
    monkeypatch.delenv("LPS_TAG_ENGINE")
    assert rc == 0


@pytest.fixture(scope="module")
def germ(tmp_path_factory):
    """conftest.py's small_fixture, simulated by the port and phased by
    the JAX package."""
    d = tmp_path_factory.mktemp("tag_surfaces")
    fix = make_fixture(str(d / "fix"), seed=7, length=120000, coverage=20,
                       read_len=12000, snp_rate=0.001)
    fix["phased"] = _oracle_phase(fix["vcf"], fix["bam"], fix["fasta"],
                                  str(d / "phased"))
    return fix


def _jax_haplotag(fix, prefix, **kw):
    run_haplotag(HaplotagConfig(
        snp_file=kw.pop("snp_file", fix["phased"]),
        bam_file=kw.pop("bam_file", fix["bam"]), fasta_file=fix["fasta"],
        result_prefix=prefix, **kw))
    return bam_tags(prefix + ".bam")


def _port_haplotag(fix, prefix, monkeypatch, engine, *extra, snp=None,
                   bam=None):
    _port(monkeypatch, engine, "haplotag", "-s", snp or fix["phased"], "-b",
          bam or fix["bam"], "-r", fix["fasta"], "-o", prefix, *extra)
    return bam_tags(prefix + ".bam")


def _tagged(tags):
    return sum(t[3] is not None for t in tags)


@pytest.mark.parametrize("engine", ENGINES)
def test_haplotag_log_matches_jax(germ, tmp_path, monkeypatch, engine):
    golden, ours = str(tmp_path / "golden"), str(tmp_path / "ours")
    want = _jax_haplotag(germ, golden, write_read_log=True)
    got = _port_haplotag(germ, ours, monkeypatch, engine, "--log")
    assert got == want

    def norm(prefix):
        with open(prefix + ".out") as f:
            return [line.replace(prefix, "PREFIX") for line in f]

    log = norm(ours)
    assert len(log) > _tagged(got)
    assert log == norm(golden)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("span", ["contig", "range"])
def test_haplotag_region_matches_jax(germ, tmp_path, monkeypatch, span,
                                     engine):
    region = germ["chrom"]
    if span == "range":
        third = germ["length"] // 3
        region = f"{germ['chrom']}:{third}-{2 * third}"
    want = _jax_haplotag(germ, str(tmp_path / "golden"), region=region)
    got = _port_haplotag(germ, str(tmp_path / "ours"), monkeypatch, engine,
                         "--region", region)
    assert _tagged(got) > 50
    assert got == want
    whole = bam_tags(germ["bam"])
    assert (len(got) < len(whole)) == (span == "range")


@pytest.mark.parametrize("how", ["gzip", "bgzf"])
def test_compressed_vcf_haplotag_matches_jax(germ, tmp_path, monkeypatch,
                                             how):
    gz = compress_vcf(germ["phased"], str(tmp_path / "phased.vcf.gz"), how)
    want = _jax_haplotag(germ, str(tmp_path / "golden"), snp_file=gz)
    for engine in ENGINES:
        got = _port_haplotag(germ, str(tmp_path / engine), monkeypatch,
                             engine, snp=gz)
        assert _tagged(got) > 100
        assert got == want, engine
    assert want == _jax_haplotag(germ, str(tmp_path / "plain"))


@pytest.fixture(scope="module")
def flagged(tmp_path_factory):
    """tests/test_golden_misc.py:204's BAM: every eleventh read from the
    third supplementary, from the fifth secondary, from the seventh
    duplicate; phased by the JAX package."""
    d = tmp_path_factory.mktemp("flagged")
    fix = make_fixture(str(d / "fix"), seed=66, length=100000, coverage=10,
                       read_len=8000, snp_rate=0.0012, error_rate=0.03,
                       qual=22)
    reads = []
    for i, entry in enumerate(fix["reads"]):
        entry = list(entry)
        while len(entry) < 7:
            entry.append(b"" if len(entry) == 5 else 0)
        entry[6] = {3: 0x800, 5: 0x100, 7: 0x400}.get(i % 11, entry[6])
        reads.append(tuple(entry))
    fix["bam"] = str(d / "flagged.bam")
    write_bam_with_index(fix["bam"], fix["chrom"], fix["length"], reads)
    fix["phased"] = _oracle_phase(fix["vcf"], fix["bam"], fix["fasta"],
                                  str(d / "phased"))
    return fix


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sup", [False, True])
def test_flagged_reads_match_jax(flagged, tmp_path, monkeypatch, sup,
                                 engine):
    want = _jax_haplotag(flagged, str(tmp_path / "golden"),
                         tag_supplementary=sup)
    got = _port_haplotag(flagged, str(tmp_path / "ours"), monkeypatch,
                         engine, *(["--tagSupplementary"] if sup else []))
    assert {t[1] & 0xD00 for t in got} == {0, 0x100, 0x400, 0x800}
    sup_tagged = any(t[1] & 0x800 and t[3] is not None for t in got)
    assert sup_tagged == sup
    assert got == want


@pytest.fixture
def stream_spy(monkeypatch):
    """Records every ``StreamingBam`` the port opens."""
    opened = []
    orig = port_native.StreamingBam

    class Spy(orig):
        def __init__(self, path):
            opened.append(path)
            super().__init__(path)

    monkeypatch.setattr(port_native, "StreamingBam", Spy)
    port_native._bam_cache.clear()
    jax_native.drain_bam_cache()
    yield opened
    port_native._bam_cache.clear()
    jax_native.drain_bam_cache()


@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_haplotag_matches_jax(germ, tmp_path, monkeypatch,
                                        stream_spy, engine):
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    want = _jax_haplotag(germ, str(tmp_path / "golden"))
    got = _port_haplotag(germ, str(tmp_path / "ours"), monkeypatch, engine)
    assert stream_spy == [germ["bam"]]
    assert _tagged(got) > 100
    assert got == want


@pytest.mark.parametrize("engine", ENGINES)
def test_no_native_tag_haplotag_matches_jax(germ, tmp_path, monkeypatch,
                                            engine):
    from longphase_s_tpu_torch.models import haplotag_fast

    monkeypatch.setenv("LPS_NO_NATIVE_TAG", "1")
    want = _jax_haplotag(germ, str(tmp_path / "golden"))
    walks = []
    real = haplotag_fast.run_haplotag_fast

    def spy(cfg, *a, **kw):
        out = real(cfg, *a, **kw)
        walks.append(out is not None)
        return out

    monkeypatch.setattr(haplotag_fast, "run_haplotag_fast", spy)
    got = _port_haplotag(germ, str(tmp_path / "ours"), monkeypatch, engine)
    assert walks == [False]
    assert _tagged(got) > 100
    assert got == want


# somatic_haplotag (tests/test_golden_somatic.py's fixture)


@pytest.fixture(scope="module")
def som(tmp_path_factory):
    d = tmp_path_factory.mktemp("somatic_surfaces")
    fix = make_somatic_fixture(str(d / "fix"), seed=42, length=250000,
                               normal_coverage=25, tumor_coverage=30,
                               purity=0.6, n_somatic=25, n_artifacts=6)
    fix["phased"] = _oracle_phase(fix["normal_vcf"], fix["normal_bam"],
                                  fix["fasta"], str(d / "phased"))
    return fix


def _jax_somatic(fix, prefix, **kw):
    jax_native.drain_bam_cache()
    run_somatic_haplotag(SomaticConfig(
        snp_file=fix["phased"], tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
        fasta_file=fix["fasta"], result_prefix=prefix,
        write_somatic_vcf=True, **kw))
    return _somatic_outputs(prefix)


def _somatic_outputs(prefix):
    with open(prefix + "_purity.out") as f:
        purity = f.read()
    return {"tags": bam_tags(prefix + ".bam"),
            "sc": vcf_rows(prefix + "_sc.vcf"), "purity": purity}


def _port_somatic(fix, prefix, monkeypatch, engine, *extra):
    _port(monkeypatch, engine, "somatic_haplotag", "-s", fix["phased"],
          "--tumor-snv-file", fix["tumor_vcf"], "-b", fix["normal_bam"],
          "--tumor-bam-file", fix["tumor_bam"], "-r", fix["fasta"], "-o",
          prefix, "--output-somatic-vcf", *extra)
    return _somatic_outputs(prefix)


def _somatic_calls(out):
    return sum(line.split("\t")[6] == "PASS" for line in out["sc"]
               if not line.startswith("#"))


@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_somatic_matches_jax(som, tmp_path, monkeypatch,
                                       stream_spy, engine):
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    want = _jax_somatic(som, str(tmp_path / "golden"))
    got = _port_somatic(som, str(tmp_path / "ours"), monkeypatch, engine)
    assert sorted(set(stream_spy)) == sorted([som["normal_bam"],
                                              som["tumor_bam"]])
    assert _somatic_calls(got) > 0
    assert got == want


@pytest.mark.parametrize("engine", ENGINES)
def test_no_native_tag_somatic_matches_jax(som, tmp_path, monkeypatch,
                                           engine):
    monkeypatch.setenv("LPS_NO_NATIVE_TAG", "1")
    want = _jax_somatic(som, str(tmp_path / "golden"))
    assert port_somatic._native_bams(port_somatic.SomaticConfig(
        snp_file="", tumor_snv_file="", bam_file=som["normal_bam"],
        tumor_bam_file=som["tumor_bam"], fasta_file="")) == (None, None)
    got = _port_somatic(som, str(tmp_path / "ours"), monkeypatch, engine)
    assert _somatic_calls(got) > 0
    assert got == want


# every calling log of --somatic-calling-log (test_golden_logs.py:96)
CALLING_LOGS = ("_somatic_var.out", "_dense_tumor_snp_interval.log",
                "_somatic_filter.log", "_read_count_filter.log",
                "_messy_read_filter.log", "_read_hp_detail.log",
                "_read_distri_scaller.out",
                "_read_distri_scaller_derive_by_H1_H2.out",
                "_densealt_filter.log",
                "_read_distri_before_inheritance.out",
                "_read_distri_after_inheritance.out",
                "_snp_cover_region.out", "_read_cover_region.bed",
                "_germlineReadHpCountInNorBam_histogram.out")


@pytest.mark.parametrize("engine", ENGINES)
def test_somatic_calling_logs_match_jax(tmp_path, monkeypatch, engine):
    """The fourteen files of ``--somatic-calling-log`` on the golden
    test's pair, with the prefix replaced."""
    fix = make_somatic_fixture(str(tmp_path / "fix"), seed=19, length=220000,
                               purity=0.55, n_somatic=18, n_artifacts=5)
    fix["phased"] = _oracle_phase(fix["normal_vcf"], fix["normal_bam"],
                                  fix["fasta"], str(tmp_path / "phased"))
    golden, ours = str(tmp_path / "golden"), str(tmp_path / "ours")
    want = _jax_somatic(fix, golden, write_calling_log=True)
    got = _port_somatic(fix, ours, monkeypatch, engine,
                        "--somatic-calling-log")
    assert got == want

    def norm(prefix, suffix):
        with open(prefix + suffix) as f:
            return [line.replace(prefix, "PREFIX") for line in f]

    for suffix in CALLING_LOGS:
        lines = norm(ours, suffix)
        assert lines or suffix == "_densealt_filter.log", suffix
        assert lines == norm(golden, suffix), suffix


@pytest.mark.parametrize("engine", ENGINES)
def test_somatic_kill_and_resume_matches_jax(tmp_path, monkeypatch, engine):
    """Killed in the tumour pass of its second contig, the run resumes
    with every normal-pass contig and the first tumour contig from the
    checkpoint; ``_sc.vcf`` and the tags equal the uninterrupted run's and
    JAX's."""
    fix = make_multichrom_somatic_fixture(str(tmp_path / "fix"), seed=19,
                                          n_chroms=3, base_length=120000)
    fix["phased"] = _oracle_phase(fix["normal_vcf"], fix["normal_bam"],
                                  fix["fasta"], str(tmp_path / "phased"))
    want = _jax_somatic(fix, str(tmp_path / "jax"))
    straight = _port_somatic(fix, str(tmp_path / "straight"), monkeypatch,
                             engine)
    ckpt = str(tmp_path / "ckpt")
    real_tum = port_somatic.extract_tumor_chromosome_fast
    real_nor = port_somatic.extract_normal_chromosome_fast
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise KeyboardInterrupt("simulated kill")
        return real_tum(*a, **kw)

    monkeypatch.setattr(port_somatic, "extract_tumor_chromosome_fast", dying)
    with pytest.raises(KeyboardInterrupt):
        _port_somatic(fix, str(tmp_path / "killed"), monkeypatch, engine,
                      "--checkpoint", ckpt)
    counts = {"nor": 0, "tum": 0}

    def counting(key, real):
        def run(*a, **kw):
            counts[key] += 1
            return real(*a, **kw)
        return run

    monkeypatch.setattr(port_somatic, "extract_tumor_chromosome_fast",
                        counting("tum", real_tum))
    monkeypatch.setattr(port_somatic, "extract_normal_chromosome_fast",
                        counting("nor", real_nor))
    resumed = _port_somatic(fix, str(tmp_path / "resumed"), monkeypatch,
                            engine, "--checkpoint", ckpt)
    assert counts == {"nor": 0, "tum": 2}
    assert _somatic_calls(resumed) > 0
    assert resumed == straight == want
