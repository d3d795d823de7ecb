"""The port's purity sweep (``testing/purity_sweep.py``) and the filter
tiers of ``somatic_haplotag`` against the JAX package, on the CPU.

- two sweep points at ``CFG`` (0.1, where the estimator's model fails and
  no ``_purity.out`` is written, and 0.6) run by the sweep module with
  ``--device cpu`` on both engines equal the JAX package's
  ``run_estimate_purity`` and ``run_somatic_haplotag`` on the same phased
  VCF, and ``PURITY_SWEEP.md``'s reference estimates;
- ``somatic_haplotag --tumor-purity x`` on tests/test_torch_somatic.py's
  fixture equals JAX's ``SomaticConfig(estimate_tumor_purity=False,
  tumor_purity=x)`` at a purity in each of the five filter tiers and on
  each boundary between them, with the same filter parameters set; and on
  sweep point 0.6's fixture, where each tier's calls differ;
- the truth benchmark and the read log (``--truth-vcf --truth-bed
  --benchmark-log --log``) equal JAX's;
- the rows hold what ``chip_smoke.py`` phase 13 prints, a planted
  difference raises and ``--device cuda`` without a card fails.

JAX runs on its host engine, which its own tests hold equal to its device
engine.
"""

import os

import pytest

from longphase_s_tpu import native as jax_native
from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.core.somatic_caller import FilterParams as JaxParams
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.models.somatic import (SomaticConfig,
                                            run_estimate_purity,
                                            run_somatic_haplotag)
from longphase_s_tpu.testing.simulate import (make_somatic_fixture,
                                              write_truth_files)
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.core.somatic_caller import FilterParams
from longphase_s_tpu_torch.testing import purity_sweep, wgs_soak

# PURITY_SWEEP.md's reference estimates at the two points
REFERENCE = {0.1: "0.000000", 0.6: "0.460022"}
# a given purity in each tier and each tier's lower bound, and its tier
GIVEN = {0.15: "under 0.3", 0.3: "0.3-0.5", 0.4: "0.3-0.5",
         0.5: "0.5-0.7", 0.6: "0.5-0.7", 0.7: "0.7-0.9", 0.8: "0.7-0.9",
         0.9: "0.9-1.0", 0.95: "0.9-1.0"}
BENCHMARK_FILES = ("_somatic_haplotag.metrics",
                   "_total_truth_somatic_read.out", "_total_tagged_read.out",
                   "_allele_count.out", "_var_in_bed.out", "_var_out_bed.out")


def _lines(path, drop=("##commandline",)):
    """The file's lines but those starting with ``drop``; None where it
    does not exist."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [line for line in f if not line.startswith(drop)]


def _port_outputs(prefix):
    return {"sc": wgs_soak.strip_vcf(prefix + "_sc.vcf"),
            "tags": wgs_soak.tags_digest(prefix + ".bam"),
            "purity_out": _lines(prefix + "_purity.out")}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Points 0.1 and 0.6 of the sweep on the CPU, cold, both at once, also
    with the engine gate's own choice."""
    work = str(tmp_path_factory.mktemp("sweep"))
    fixtures = purity_sweep.build_fixtures(work, sorted(REFERENCE))
    rows = purity_sweep.run_points(work, fixtures, "cpu", gate=True,
                                   warmup=False, workers=2)
    assert [row["purity"] for row in rows] == sorted(REFERENCE)
    return {"work": work, "rows": {row["purity"]: row for row in rows}}


@pytest.mark.parametrize("purity", sorted(REFERENCE))
def test_sweep_point_matches_jax(sweep, purity, tmp_path, monkeypatch):
    row = sweep["rows"][purity]
    out = os.path.join(sweep["work"], f"p{purity:0.1f}_cpu")
    fix = purity_sweep.get_point_fixture(sweep["work"], purity)
    files = dict(snp_file=os.path.join(out, "phased.vcf"),
                 tumor_snv_file=fix["tumor_vcf"], bam_file=fix["normal_bam"],
                 tumor_bam_file=fix["tumor_bam"], fasta_file=fix["fasta"])
    monkeypatch.setenv("LPS_TAG_ENGINE", "host")
    jax_native.drain_bam_cache()
    # the CLI's estimate_purity defaults: -q 20, --tagSupplementary
    estimate = run_estimate_purity(SomaticConfig(
        result_prefix=str(tmp_path / "purity"), quality_threshold=20,
        tag_supplementary=True, **files))
    run_somatic_haplotag(SomaticConfig(
        result_prefix=str(tmp_path / "somatic"), write_somatic_vcf=True,
        **files))
    assert row["estimate"] == estimate
    assert row["estimate_6"] == row["reference_estimate"] == \
        REFERENCE[purity]
    jax_purity_out = _lines(str(tmp_path / "purity_purity.out"))
    assert row["purity_out"] == (jax_purity_out is not None) == \
        (purity != 0.1)
    want = _port_outputs(str(tmp_path / "somatic"))
    assert sum(line.split("\t")[6] == "PASS" for line in want["sc"]
               if not line.startswith("#")) == row["sc_pass"] > 0
    for engine in ("device", "host"):
        assert _port_outputs(os.path.join(out, f"somatic_{engine}")) == \
            want, engine
        assert _lines(os.path.join(out, f"purity_{engine}_purity.out")) == \
            jax_purity_out, engine
    if purity == 0.1:
        assert estimate == 0.0 and row["filter_purity"] == 0.0
        assert want["purity_out"] is None
        assert row["tier"] == purity_sweep.LOW_TIER


def test_rows_hold_what_phase_13_prints(sweep):
    keys = ("purity", "length", "seed", "estimate", "estimate_6",
            "purity_out", "purity_out_text", "filter_purity", "tier",
            "sc_pass", "tags_sha256", "reference_estimate", "runs")
    runs = ("phase", "somatic_device", "somatic_host", "purity_device",
            "purity_host")
    for purity, row in sweep["rows"].items():
        assert all(k in row for k in keys), purity
        assert row["length"] == purity_sweep.CFG["length"]
        assert row["seed"] == int(purity * 10) + 100
        for name in runs:
            run = row["runs"][name]
            assert run["wall_s"] > 0 and 0 < run["peak_rss_gb"] < 8, name
            assert run["launches"] == {} and run["device_calls"] == {}, name
        assert row["runs"]["somatic_host"]["engines"]["device"] == 0
        assert row["runs"]["purity_device"]["engines"]["host"] == 0
    row = sweep["rows"][0.6]
    assert row["engines_compared"] == ["device", "gate", "host"]
    assert sum(row["runs"]["somatic_gate"]["engines"].values()) > 0
    assert row["purity_out_text"].rstrip().endswith(row["estimate_6"])


def test_a_planted_difference_raises(sweep, tmp_path):
    out = os.path.join(sweep["work"], "p0.6_cpu")
    prefixes = {e: (os.path.join(out, f"somatic_{e}"),
                    os.path.join(out, f"purity_{e}")) for e in
                ("device", "host")}
    reports = {"filter_purity": 0.46, "estimate": 0.46}
    got = {e: purity_sweep.outputs(*p, reports, reports)
           for e, p in prefixes.items()}
    purity_sweep.check_same(got["host"], got["device"], "as run")
    lost = dict(got["host"], purity_out=None)
    with pytest.raises(wgs_soak.SoakMismatch, match="purity_out"):
        purity_sweep.check_same(lost, got["device"], "a lost _purity.out")
    moved = dict(got["host"], estimate=0.4600220415132806)
    with pytest.raises(wgs_soak.SoakMismatch, match="estimate"):
        purity_sweep.check_same(moved, got["device"], "an estimate")
    # a reference table the run does not reach, or that lacks the point
    row = sweep["rows"][0.6]
    assert purity_sweep.check_reference(row) == "0.460022"
    table = tmp_path / "table.md"
    table.write_text("| true purity | reference estimate | ours | same |\n"
                     "|---|---|---|---|\n| 0.6 | 0.460023 | 0.460023 | yes |\n")
    assert purity_sweep.reference_estimates(str(table)) == {0.6: "0.460023"}
    with pytest.raises(wgs_soak.SoakMismatch, match="0.460023 in table.md"):
        purity_sweep.check_reference(row, str(table))
    with pytest.raises(wgs_soak.SoakMismatch, match="None"):
        purity_sweep.check_reference(sweep["rows"][0.1], str(table))


def test_a_cuda_request_without_a_card_fails(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        purity_sweep.main([str(tmp_path), "--device", "cuda", "--purities",
                           "0.6"])
    assert not os.listdir(tmp_path)


def test_tiers_follow_set_with_purity():
    """``tier`` names the parameter set ``set_with_purity`` picks: one set
    a label, five labels."""
    by_label = {}
    for purity in (*GIVEN, 0.0, 0.29999, 0.49999, 0.69999, 0.89999, 1.0):
        params = FilterParams()
        params.set_with_purity(purity)
        fields = tuple(v for k, v in sorted(vars(params).items())
                       if k != "tumor_purity")
        by_label.setdefault(purity_sweep.tier(purity), set()).add(fields)
    assert sorted(by_label) == sorted(
        [label for label, *_ in purity_sweep.TIERS] + [purity_sweep.LOW_TIER])
    assert all(len(sets) == 1 for sets in by_label.values())
    assert len(set().union(*by_label.values())) == 5


@pytest.fixture(scope="module")
def given(tmp_path_factory):
    """tests/test_torch_somatic.py's fixture (seed 13, 220 kbp), the normal
    sample phased by the oracle."""
    d = tmp_path_factory.mktemp("given")
    fix = make_somatic_fixture(str(d / "fix"), seed=13, length=220000,
                               normal_coverage=22, tumor_coverage=26,
                               purity=0.55, n_somatic=20, n_artifacts=5)
    phased = str(d / "phased")
    run_phase(PhaseConfig(snp_file=fix["normal_vcf"],
                          bam_files=[fix["normal_bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          engine="oracle", params=PhaseParams()))
    files = dict(snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
                 bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
                 fasta_file=fix["fasta"])
    args = ["-s", phased + ".vcf", "--tumor-snv-file", fix["tumor_vcf"],
            "-b", fix["normal_bam"], "--tumor-bam-file", fix["tumor_bam"],
            "-r", fix["fasta"]]
    return {"dir": d, "fix": fix, "files": files, "args": args}


def _jax_somatic(given, prefix, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPS_TAG_ENGINE", "host")
        jax_native.drain_bam_cache()
        run_somatic_haplotag(SomaticConfig(
            result_prefix=prefix, write_somatic_vcf=True, **given["files"],
            **kw))


def _port_somatic(given, prefix, engine, *extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPS_TAG_ENGINE", engine)
        assert cli.main(["somatic_haplotag", *given["args"],
                         "--output-somatic-vcf", "-o", prefix, "--device",
                         "cpu", *extra]) == 0


@pytest.mark.parametrize("purity", sorted(GIVEN))
def test_given_purity_tier_matches_jax(given, purity, tmp_path, monkeypatch):
    set_with = []
    orig = FilterParams.set_with_purity

    def spy(self, p):
        orig(self, p)
        set_with.append((p, dict(vars(self))))
    monkeypatch.setattr(FilterParams, "set_with_purity", spy)
    _jax_somatic(given, str(tmp_path / "jax"), estimate_tumor_purity=False,
                 tumor_purity=purity)
    want = _port_outputs(str(tmp_path / "jax"))
    assert want["purity_out"] is None
    jax_params = JaxParams()
    jax_params.set_with_purity(purity)
    for engine in ("device", "host"):
        prefix = str(tmp_path / engine)
        _port_somatic(given, prefix, engine, "--tumor-purity", str(purity))
        assert _port_outputs(prefix) == want, engine
        assert set_with[-1] == (purity, vars(jax_params)), engine
    assert purity_sweep.tier(purity) == GIVEN[purity]


# one given purity a tier on sweep point 0.6's fixture (1 Mbp), and the
# PASS count of its _sc.vcf: unlike the 220 kbp fixture's, every tier's
# calls differ there
SWEEP_GIVEN = {0.15: 99, 0.3: 97, 0.5: 84, 0.8: 86, 0.95: 80}


@pytest.mark.parametrize("purity", sorted(SWEEP_GIVEN))
def test_given_purity_on_a_sweep_point_matches_jax(sweep, purity, tmp_path):
    out = os.path.join(sweep["work"], "p0.6_cpu")
    fix = purity_sweep.get_point_fixture(sweep["work"], 0.6)
    point = {"files": dict(snp_file=os.path.join(out, "phased.vcf"),
                           tumor_snv_file=fix["tumor_vcf"],
                           bam_file=fix["normal_bam"],
                           tumor_bam_file=fix["tumor_bam"],
                           fasta_file=fix["fasta"])}
    point["args"] = ["-s", point["files"]["snp_file"], "--tumor-snv-file",
                     fix["tumor_vcf"], "-b", fix["normal_bam"],
                     "--tumor-bam-file", fix["tumor_bam"], "-r", fix["fasta"]]
    _jax_somatic(point, str(tmp_path / "jax"), estimate_tumor_purity=False,
                 tumor_purity=purity)
    want = _port_outputs(str(tmp_path / "jax"))
    assert sum(line.split("\t")[6] == "PASS" for line in want["sc"]
               if not line.startswith("#")) == SWEEP_GIVEN[purity]
    for engine in ("device", "host"):
        _port_somatic(point, str(tmp_path / engine), engine,
                      "--tumor-purity", str(purity))
        assert _port_outputs(str(tmp_path / engine)) == want, engine


@pytest.fixture(scope="module")
def truth(given):
    """JAX's somatic_haplotag with the truth VCF and BED, the benchmark
    log and the read log."""
    d = given["dir"]
    fix = given["fix"]
    tvcf, tbed = write_truth_files(str(d), fix["chrom"], fix["length"],
                                   fix["somatic"])
    prefix = str(d / "jax_truth")
    _jax_somatic(given, prefix, truth_vcf=tvcf, truth_bed=tbed,
                 write_benchmark_log=True, write_read_log=True)
    return {"flags": ["--truth-vcf", tvcf, "--truth-bed", tbed,
                      "--benchmark-log", "--log"], "prefix": prefix}


@pytest.mark.parametrize("engine", ["device", "host"])
def test_truth_benchmark_and_read_log_match_jax(given, truth, engine,
                                                tmp_path):
    prefix = str(tmp_path / "port")
    _port_somatic(given, prefix, engine, *truth["flags"])
    for suffix in BENCHMARK_FILES:
        want = _lines(truth["prefix"] + suffix)
        assert want, suffix
        assert _lines(prefix + suffix) == want, suffix
    log = _lines(prefix + ".out", ("##commandline", "##resultPrefix"))
    assert len(log) > 20
    assert log == _lines(truth["prefix"] + ".out",
                         ("##commandline", "##resultPrefix"))
    assert _port_outputs(prefix) == _port_outputs(truth["prefix"])
