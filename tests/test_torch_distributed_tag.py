"""The port's tag family and ``modcall`` in 2 processes of one gloo group
(``--dist``, ``--device cpu``, the device engine) against the JAX
package's one-process run, at the fixture sizes of
tests/test_distributed.py:

- ``haplotag`` on ``make_multichrom_fixture(seed=43, n_chroms=5,
  base_length=40000)``: HP/PS/PQ of every record;
- ``somatic_haplotag --output-somatic-vcf`` and ``estimate_purity`` on
  ``make_multichrom_somatic_fixture(seed=82, n_chroms=3)``: tags and
  ``_sc.vcf``; the purity and ``_purity.out``;
- ``somatic_haplotag --somatic-calling-log``, which runs every contig in
  every process and writes from process 0: every file it writes, where
  the JAX package's own 2-process run counts each purity point twice
  (ROADMAP Queue C);
- ``modcall`` on ``make_multichrom_meth_fixture(seed=5, n_chroms=3)``: the
  VCF.

Every process is a fresh interpreter that imports only the port
(``testing/processes.py``); the JAX side runs in the test process on its
host engine, which its own tests hold equal to its device engine.
"""

import os

import pytest

from longphase_s_tpu import native as jax_native
from longphase_s_tpu.io.bam import BamReader
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.modcall import ModCallConfig, run_modcall
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.models.somatic import (SomaticConfig,
                                            run_estimate_purity,
                                            run_somatic_haplotag)
from longphase_s_tpu.testing.simulate import (make_multichrom_fixture,
                                              make_multichrom_meth_fixture,
                                              make_multichrom_somatic_fixture)
from longphase_s_tpu_torch.testing import processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.pop("XLA_FLAGS", None)
    env["LPS_TAG_ENGINE"] = "device"
    return env


def _tags(path):
    r = BamReader(path)
    out = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
            rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
    r.close()
    return out


def _body(path):
    with open(path) as f:
        return [line for line in f
                if not line.startswith(("##commandline", "##longphase"))]


def _run(argv, prefix):
    """``argv -o prefix --device cpu`` in 2 processes, each reporting its
    device and no import of JAX."""
    reports = processes.run_cli(argv + ["-o", prefix, "--device", "cpu"], 2,
                                REPO, _env(), TIMEOUT)
    assert all(r["device"] == "cpu" and not r["leaked"] for r in reports)


@pytest.fixture(scope="module")
def jax_tag(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("LPS_TAG_ENGINE", "host")
    return tmp_path_factory.mktemp("dist_tag")


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _phase(fx_vcf, fx_bam, fasta, prefix):
    run_phase(PhaseConfig(snp_file=fx_vcf, bam_files=[fx_bam],
                          fasta_file=fasta, result_prefix=prefix,
                          num_threads=2, is_pb=True, engine="oracle"))
    return prefix + ".vcf"


def test_haplotag_processes_match_one_process(jax_tag, tmp_path):
    fx = make_multichrom_fixture(str(jax_tag / "germ"), seed=43, n_chroms=5,
                                 base_length=40000)
    phased = _phase(fx["vcf"], fx["bam"], fx["fasta"],
                    str(jax_tag / "germ_phased"))
    run_haplotag(HaplotagConfig(snp_file=phased, bam_file=fx["bam"],
                                fasta_file=fx["fasta"],
                                result_prefix=str(jax_tag / "germ_jax")))
    _run(["haplotag", "-s", phased, "-b", fx["bam"], "-r", fx["fasta"]],
         str(tmp_path / "dist"))
    want = _tags(str(jax_tag / "germ_jax.bam"))
    assert _tags(str(tmp_path / "dist.bam")) == want
    assert sum(t[3] is not None for t in want) > 100


@pytest.fixture(scope="module")
def somatic(jax_tag):
    """The normal sample phased by the JAX oracle, then somatic_haplotag
    and estimate_purity of the JAX package in one process."""
    fx = make_multichrom_somatic_fixture(str(jax_tag / "som"), seed=82,
                                         n_chroms=3)
    phased = _phase(fx["normal_vcf"], fx["normal_bam"], fx["fasta"],
                    str(jax_tag / "som_phased"))
    base = dict(snp_file=phased, tumor_snv_file=fx["tumor_vcf"],
                bam_file=fx["normal_bam"], tumor_bam_file=fx["tumor_bam"],
                fasta_file=fx["fasta"])
    jax_native.drain_bam_cache()
    run_somatic_haplotag(SomaticConfig(
        **base, write_somatic_vcf=True,
        result_prefix=str(jax_tag / "som_jax")))
    jax_native.drain_bam_cache()
    purity_cfg = dict(base, quality_threshold=20, tag_supplementary=True)
    purity = run_estimate_purity(SomaticConfig(
        **purity_cfg, result_prefix=str(jax_tag / "pur_jax")))
    argv = ["-s", phased, "--tumor-snv-file", fx["tumor_vcf"], "-b",
            fx["normal_bam"], "--tumor-bam-file", fx["tumor_bam"], "-r",
            fx["fasta"]]
    return {"argv": argv, "purity": purity, "purity_cfg": purity_cfg,
            "dir": jax_tag}


def test_somatic_haplotag_processes_match_one_process(somatic, tmp_path):
    _run(["somatic_haplotag", *somatic["argv"], "--output-somatic-vcf"],
         str(tmp_path / "dist"))
    d = somatic["dir"]
    assert _tags(str(tmp_path / "dist.bam")) == _tags(str(d / "som_jax.bam"))
    assert _body(tmp_path / "dist_sc.vcf") == _body(d / "som_jax_sc.vcf")
    assert _body(tmp_path / "dist_purity.out") == \
        _body(d / "som_jax_purity.out")


def test_somatic_calling_log_processes_match_one_process(somatic, tmp_path):
    """The log path stays unsharded: each process holds every contig, so
    the purity estimator must not gather them again."""
    d = somatic["dir"]
    cfg = dict(somatic["purity_cfg"], quality_threshold=1,
               tag_supplementary=False, write_calling_log=True,
               result_prefix=str(d / "log_jax"))
    jax_native.drain_bam_cache()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPS_TAG_ENGINE", "host")
        run_somatic_haplotag(SomaticConfig(**cfg))
    _run(["somatic_haplotag", *somatic["argv"], "--somatic-calling-log"],
         str(tmp_path / "dist"))
    names = sorted(f[len("log_jax"):] for f in os.listdir(d)
                   if f.startswith("log_jax"))
    assert len(names) > 10 and ".bam" in names
    assert sorted(f[len("dist"):] for f in os.listdir(tmp_path)) == names

    def body(path):
        if path.endswith(".bam"):
            return _tags(path)
        return [line for line in _body(path)
                if not line.startswith("##resultPrefix")]

    for name in names:
        assert body(str(tmp_path / f"dist{name}")) == \
            body(str(d / f"log_jax{name}")), name


PURITY_WORKER = """
import json, sys
from longphase_s_tpu_torch.models.somatic import (SomaticConfig,
                                                  run_estimate_purity)
cfg = SomaticConfig(**json.loads(sys.argv[1]), dist=sys.argv[2])
print("PURITY " + repr(run_estimate_purity(cfg)))
"""


def test_estimate_purity_processes_match_one_process(somatic, tmp_path):
    import json

    cfg = json.dumps(dict(somatic["purity_cfg"], device="cpu",
                          result_prefix=str(tmp_path / "dist")))
    spec = f"127.0.0.1:{processes.free_port()},2"
    results = processes.finish(processes.start(
        PURITY_WORKER, [[cfg, f"{spec},{pid}"] for pid in range(2)], REPO,
        _env()), TIMEOUT)
    purities = []
    for rc, out, err in results:
        assert rc == 0, err[-2000:]
        purities.append(float(out.split("PURITY ")[-1]))
    assert purities == [somatic["purity"]] * 2 and somatic["purity"] > 0
    assert (tmp_path / "dist_purity.out").read_text() == \
        (somatic["dir"] / "pur_jax_purity.out").read_text()


def test_modcall_processes_match_one_process(jax_tag, tmp_path):
    fx = make_multichrom_meth_fixture(str(jax_tag / "meth"), seed=5,
                                      n_chroms=3)
    run_modcall(ModCallConfig(bam_files=[fx["bam"]], fasta_file=fx["fasta"],
                              snp_file=fx["vcf"],
                              result_prefix=str(jax_tag / "meth_jax")))
    _run(["modcall", "-b", fx["bam"], "-r", fx["fasta"], "-s", fx["vcf"]],
         str(tmp_path / "dist"))
    want = _body(jax_tag / "meth_jax.vcf")
    assert _body(tmp_path / "dist.vcf") == want and len(want) > 10
