"""The surfaces of the port's ``phase`` against the JAX package, each on
the inputs of its golden test (``tests/test_golden_*.py``,
``tests/test_checkpoint.py``), with the JAX package's ``run_phase``
(engine ``tpu``, or ``oracle`` where the golden test uses it) as the
reference and the port's ``cli phase --device cpu`` (the plain versions
of its kernels) as ours:

- ``--dot``: the ``{chrom}.dot`` written into the working directory and
  the VCF (test_golden_logs.py:8);
- ``--deepsomatic_output``: ``_preprocessed.vcf`` and the VCF, on the
  golden test's input (its writer is ``fuzz_parity.write_deepsomatic_vcf``;
  test_golden_deepsomatic.py);
- a gzip or BGZF ``-s`` VCF (test_golden_misc.py:252);
- a VCF with no het site and a BAM with no reads, through both CLIs: the
  exit code, the files written and the VCF (test_golden_misc.py:157);
- two BAMs; four chromosomes with ``--threads 4``; a multi-chromosome
  fixture phased and tagged (test_golden_misc.py:14, :187, :84);
- ``--checkpoint``: a run killed after two of four contigs resumes the
  rest, on both phase engines; a stale checkpoint is ignored
  (test_checkpoint.py:34, :68);
- ``LPS_GUARD_MOD_END`` off and on, the native and the Python walk
  (test_golden_svmod.py:79).

VCFs are compared without ``##commandline`` and ``##longphase``, the
lines that name the program and its arguments.
"""

import gzip
import os

import numpy as np
import pytest

from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.io import bgzf
from longphase_s_tpu_torch.models import phase as port_phase
from longphase_s_tpu_torch.testing.fuzz_parity import (bam_tags,
                                                       write_deepsomatic_vcf)
from longphase_s_tpu_torch.testing.simulate import (make_fixture,
                                                    make_multichrom_fixture,
                                                    simulate_reads,
                                                    write_bam_with_index)


def _vcf(path):
    with open(path) as f:
        return [line for line in f
                if not line.startswith(("##commandline", "##longphase"))]


def _jax_phase(fix, prefix, snp=None, bams=None, engine="tpu", **kw):
    return run_phase(PhaseConfig(
        snp_file=snp or fix["vcf"], bam_files=bams or [fix["bam"]],
        fasta_file=fix["fasta"], result_prefix=prefix, is_pb=True,
        engine=engine, params=kw.pop("params", PhaseParams()), **kw))


def _port_phase(fix, prefix, *extra, snp=None, bams=None):
    bam_args = [a for b in (bams or [fix["bam"]]) for a in ("-b", b)]
    return cli.main(["phase", "--pb", "-s", snp or fix["vcf"], *bam_args,
                     "-r", fix["fasta"], "-o", prefix, "--device", "cpu",
                     *extra])


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """conftest.py's small_fixture, simulated by the port."""
    d = tmp_path_factory.mktemp("phase_surfaces")
    return make_fixture(str(d / "fix"), seed=7, length=120000, coverage=20,
                        read_len=12000, snp_rate=0.001)


def test_phase_dot_matches_jax(fx, tmp_path, monkeypatch):
    (tmp_path / "g").mkdir()
    (tmp_path / "o").mkdir()
    monkeypatch.chdir(tmp_path / "g")
    _jax_phase(fx, str(tmp_path / "g" / "out"), dot=True)
    monkeypatch.chdir(tmp_path / "o")
    assert _port_phase(fx, str(tmp_path / "o" / "out"), "--dot") == 0
    dot = f"{fx['chrom']}.dot"
    port = (tmp_path / "o" / dot).read_text()
    assert port.count("->") > 20
    assert port == (tmp_path / "g" / dot).read_text()
    assert _vcf(tmp_path / "o" / "out.vcf") == _vcf(tmp_path / "g" / "out.vcf")


def test_phase_deepsomatic_matches_jax(tmp_path):
    fix = make_fixture(str(tmp_path / "fix"), seed=13, length=150000,
                       coverage=25, read_len=10000, snp_rate=0.0015,
                       error_rate=0.03, qual=25)
    ds_vcf = str(tmp_path / "deepsomatic.vcf")
    write_deepsomatic_vcf(ds_vcf, fix, np.random.default_rng(5))
    _jax_phase(fix, str(tmp_path / "golden"), snp=ds_vcf,
               deepsomatic_output=True)
    assert _port_phase(fix, str(tmp_path / "ours"), "--deepsomatic_output",
                       snp=ds_vcf) == 0
    pre = (tmp_path / "ours_preprocessed.vcf").read_text()
    assert "GERMLINE" in pre and "PASS" not in pre.split("#CHROM")[1]
    assert pre == (tmp_path / "golden_preprocessed.vcf").read_text()
    ours = _vcf(tmp_path / "ours.vcf")
    assert sum("|" in line for line in ours) > 20
    assert ours == _vcf(tmp_path / "golden.vcf")


def compress_vcf(src, dst, how):
    """``src`` as a gzip member (``gzip.open``, as the golden test writes
    it) or as BGZF blocks (``io/bgzf.BgzfWriter``, as bgzip writes it)."""
    with open(src, "rb") as fin:
        data = fin.read()
    if how == "gzip":
        with gzip.open(dst, "wb") as fout:
            fout.write(data)
    else:
        w = bgzf.BgzfWriter(dst)
        w.write(data)
        w.close()
    return dst


@pytest.mark.parametrize("how", ["gzip", "bgzf"])
def test_compressed_vcf_input_matches_jax(fx, tmp_path, how):
    gz = compress_vcf(fx["vcf"], str(tmp_path / "snp.vcf.gz"), how)
    _jax_phase(fx, str(tmp_path / "golden"), snp=gz)
    assert _port_phase(fx, str(tmp_path / "ours"), snp=gz) == 0
    ours = _vcf(tmp_path / "ours.vcf")
    assert sum("|" in line for line in ours) > 20
    assert ours == _vcf(tmp_path / "golden.vcf")
    _port_phase(fx, str(tmp_path / "plain"))
    assert ours == _vcf(tmp_path / "plain.vcf")


@pytest.mark.parametrize("case", ["emptyvcf", "noreads"])
def test_degenerate_inputs_match_jax(fx, tmp_path, case):
    """A VCF with no het site, a BAM with no reads: JAX's ``cli`` and the
    port's return the same code and write the same files, whose rows
    pass the input through."""
    from longphase_s_tpu import cli as jax_cli

    snp, bam = fx["vcf"], fx["bam"]
    if case == "emptyvcf":
        snp = str(tmp_path / "empty.vcf")
        with open(snp, "w") as f:
            f.write("##fileformat=VCFv4.2\n"
                    f"##contig=<ID={fx['chrom']},length={fx['length']}>\n"
                    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                    "S\n")
    else:
        bam = str(tmp_path / "noreads.bam")
        write_bam_with_index(bam, fx["chrom"], fx["length"], [])
    for side, main, extra in (("g", jax_cli.main, []),
                              ("o", cli.main, ["--device", "cpu"])):
        out = tmp_path / side
        out.mkdir()
        rc = main(["phase", "--pb", "-s", snp, "-b", bam, "-r", fx["fasta"],
                   "-o", str(out / "out"), *extra])
        assert rc == 0, side
    assert sorted(os.listdir(tmp_path / "o")) == \
        sorted(os.listdir(tmp_path / "g")) == ["out.vcf"]
    ours = _vcf(tmp_path / "o" / "out.vcf")
    assert not any("|" in line for line in ours)
    assert ours == _vcf(tmp_path / "g" / "out.vcf")


def test_phase_two_bams_matches_jax(tmp_path):
    fix = make_fixture(str(tmp_path / "fix"), seed=71, length=140000,
                       coverage=12, read_len=9000, snp_rate=0.0012,
                       error_rate=0.03, qual=22)
    reads2 = simulate_reads(np.random.default_rng(72), fix["ref_seq"],
                            fix["variants"], 12, 9000, 0.03, 22,
                            name_prefix="extra")
    bam2 = str(tmp_path / "fix" / "reads2.bam")
    write_bam_with_index(bam2, fix["chrom"], fix["length"], reads2)
    bams = [fix["bam"], bam2]
    _jax_phase(fix, str(tmp_path / "golden"), bams=bams)
    assert _port_phase(fix, str(tmp_path / "ours"), bams=bams) == 0
    ours = _vcf(tmp_path / "ours.vcf")
    assert sum("|" in line for line in ours) > 20
    assert ours == _vcf(tmp_path / "golden.vcf")


def test_phase_threads_multichrom_matches_jax(tmp_path):
    fix = make_multichrom_fixture(str(tmp_path / "fix"), seed=91, n_chroms=4)
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"],
                          result_prefix=str(tmp_path / "golden"),
                          num_threads=4, engine="tpu", params=PhaseParams()))
    assert _port_phase(fix, str(tmp_path / "ours"), "-t", "4") == 0
    ours = _vcf(tmp_path / "ours.vcf")
    assert len({line.split("\t")[0] for line in ours
                if "|" in line}) == 4
    assert ours == _vcf(tmp_path / "golden.vcf")


@pytest.mark.parametrize("engine", ["device", "host"])
def test_phase_haplotag_multichrom_matches_jax(tmp_path, monkeypatch,
                                               engine):
    fix = make_multichrom_fixture(str(tmp_path / "fix"), seed=55)
    _jax_phase(fix, str(tmp_path / "golden"))
    assert _port_phase(fix, str(tmp_path / "ours")) == 0
    assert _vcf(tmp_path / "ours.vcf") == _vcf(tmp_path / "golden.vcf")
    run_haplotag(HaplotagConfig(snp_file=str(tmp_path / "golden.vcf"),
                                bam_file=fix["bam"], fasta_file=fix["fasta"],
                                result_prefix=str(tmp_path / "gh")))
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    assert cli.main(["haplotag", "-s", str(tmp_path / "golden.vcf"), "-b",
                     fix["bam"], "-r", fix["fasta"], "-o",
                     str(tmp_path / "oh"), "--device", "cpu"]) == 0
    tags = bam_tags(str(tmp_path / "oh.bam"))
    assert len({t[3] for t in tags}) == 3  # None, 1, 2
    assert tags == bam_tags(str(tmp_path / "gh.bam"))


# the checkpoint tests (tests/test_checkpoint.py's fixture)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_fix")
    return make_multichrom_fixture(str(d / "fix"), seed=41, n_chroms=4,
                                   base_length=50000)


def _port_cfg(fix, prefix, engine, ckpt="", **kw):
    from longphase_s_tpu_torch.core.phase_algo import \
        PhaseParams as PortPhaseParams

    return port_phase.PhaseConfig(
        snp_file=fix["vcf"], bam_files=[fix["bam"]], fasta_file=fix["fasta"],
        result_prefix=prefix, is_pb=True, engine=engine, device="cpu",
        checkpoint_dir=ckpt, params=kw.pop("params", PortPhaseParams()),
        **kw)


# the function each engine phases one contig with
CONTIG_STEP = {"gpu": "phase_chromosome_flat", "oracle": "phase_chromosome"}


@pytest.mark.parametrize("engine", ["gpu", "oracle"])
def test_phase_kill_and_resume_matches_jax(multi, tmp_path, monkeypatch,
                                           engine):
    """Killed in its third contig, the run resumes the first two from the
    checkpoint and computes only the other two; the VCF equals the
    uninterrupted run's and JAX's."""
    _jax_phase(multi, str(tmp_path / "jax"), engine="oracle")
    straight = port_phase.run_phase(
        _port_cfg(multi, str(tmp_path / "straight"), engine))
    name = CONTIG_STEP[engine]
    real = getattr(port_phase, name)
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setattr(port_phase, name, dying)
    with pytest.raises(KeyboardInterrupt):
        port_phase.run_phase(_port_cfg(multi, str(tmp_path / "killed"),
                                       engine, ckpt))
    calls2 = {"n": 0}

    def counting(*a, **kw):
        calls2["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(port_phase, name, counting)
    resumed = port_phase.run_phase(
        _port_cfg(multi, str(tmp_path / "resumed"), engine, ckpt))
    assert calls2["n"] == 2
    assert resumed == straight
    ours = _vcf(tmp_path / "resumed.vcf")
    assert ours == _vcf(tmp_path / "straight.vcf")
    assert ours == _vcf(tmp_path / "jax.vcf")


def test_stale_checkpoint_ignored_matches_jax(multi, tmp_path, monkeypatch):
    """Other parameters make another fingerprint: the run recomputes every
    contig and the directory then holds its fingerprint, so the first
    parameters again recompute every contig too, in both packages (the
    JAX test's comment says they resume; its code asserts only the
    results)."""
    from longphase_s_tpu.models import phase as jax_phase
    from longphase_s_tpu_torch.core.phase_algo import \
        PhaseParams as PortPhaseParams

    calls = {"jax": 0, "port": 0}

    def counting(side, real):
        def step(*a, **kw):
            calls[side] += 1
            return real(*a, **kw)
        return step

    monkeypatch.setattr(jax_phase, "phase_chromosome",
                        counting("jax", jax_phase.phase_chromosome))
    monkeypatch.setattr(port_phase, "phase_chromosome_flat",
                        counting("port", port_phase.phase_chromosome_flat))
    runs = {}
    for label, distance in (("first", 300000), ("other", 299999),
                            ("again", 300000)):
        before = dict(calls)
        _jax_phase(multi, str(tmp_path / f"jax_{label}"), engine="oracle",
                   checkpoint_dir=str(tmp_path / "jax_ckpt"),
                   params=PhaseParams(distance=distance))
        runs[label] = port_phase.run_phase(_port_cfg(
            multi, str(tmp_path / label), "gpu", str(tmp_path / "ckpt"),
            params=PortPhaseParams(distance=distance)))
        assert calls["port"] - before["port"] == \
            calls["jax"] - before["jax"] == 4, label
        assert _vcf(tmp_path / f"{label}.vcf") == \
            _vcf(tmp_path / f"jax_{label}.vcf"), label
    assert set(runs["other"]) == set(runs["first"])
    assert runs["again"] == runs["first"]
    assert _vcf(tmp_path / "again.vcf") == _vcf(tmp_path / "first.vcf")


@pytest.mark.parametrize("guard", [False, True])
def test_guard_mod_end_matches_jax(tmp_path, monkeypatch, guard):
    """``LPS_GUARD_MOD_END=1`` keeps the mods past the last SNP that the
    reference's ``map::end()`` quirk drops (test_golden_svmod.py:79): the
    port's native walk (gpu engine) and its Python walk (oracle engine,
    the native walk declined) equal JAX's under either setting. On this
    fixture the two settings write the same files; the golden test too
    holds only the walks' agreement."""
    from longphase_s_tpu.core import alleles as jax_alleles
    from longphase_s_tpu_torch import native as port_native
    from longphase_s_tpu_torch.core import alleles as port_alleles

    fx = make_fixture(str(tmp_path / "fix"), seed=66, length=120000,
                      coverage=18, read_len=8000, snp_rate=0.0015,
                      n_svs=2, n_mods=8)
    if guard:
        monkeypatch.setenv("LPS_GUARD_MOD_END", "1")
        monkeypatch.setattr(jax_alleles, "_GUARD_MOD_END", True)
        monkeypatch.setattr(port_alleles, "_GUARD_MOD_END", True)
    files = dict(sv_file=fx["sv_vcf"], mod_file=fx["mod_vcf"])
    want = _jax_phase(fx, str(tmp_path / "jax"), **files)
    extra = ("--sv-file", fx["sv_vcf"], "--mod-file", fx["mod_vcf"])
    assert _port_phase(fx, str(tmp_path / "gpu"), *extra) == 0
    monkeypatch.setattr(port_native, "extract_phase", lambda *a, **k: None)
    got = port_phase.run_phase(_port_cfg(fx, str(tmp_path / "oracle"),
                                         "oracle", **files))
    assert got == want
    for suffix in (".vcf", "_SV.vcf", "_mod.vcf"):
        ours = _vcf(tmp_path / f"gpu{suffix}")
        assert ours == _vcf(tmp_path / f"oracle{suffix}"), suffix
        assert ours == _vcf(tmp_path / f"jax{suffix}"), suffix
