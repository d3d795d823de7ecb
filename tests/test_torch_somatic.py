"""The port's tag pipelines against the JAX package's, on the fixtures of
tests/test_tag_kernels.py:

- ``haplotag``: HP/PS/PQ of every record;
- ``somatic_haplotag``: tags, ``_sc.vcf`` without ``##commandline`` and
  ``_purity.out``;
- ``estimate_purity``: ``_purity.out``.

The port runs through its CLI with ``--device cpu`` on both engines (the
device engine then runs ``ops/tag_kernels`` on the CPU); the JAX package
runs on its host engine, which its own tests hold equal to its device
engine. Then the guards: a fresh interpreter runs all three subcommands
without importing jax, a device error raises instead of falling back to
the host, ``--device cuda`` without a card raises, and a ``--dist`` spec
of one process runs like no spec.
"""

import os
import subprocess
import sys

import pytest
import torch

from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.io.bam import BamReader
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.models.somatic import (SomaticConfig,
                                            run_estimate_purity,
                                            run_somatic_haplotag)
from longphase_s_tpu.testing.simulate import make_fixture, make_somatic_fixture
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.ops import tag_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tags(bam_path):
    r = BamReader(bam_path)
    out = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
            rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
    r.close()
    return out


def _lines(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##commandline")]


@pytest.fixture(scope="module")
def germline(tmp_path_factory):
    """tests/test_tag_kernels.py:38-40, phased by the oracle, tagged by the
    JAX package."""
    d = tmp_path_factory.mktemp("germline")
    fix = make_fixture(str(d / "fix"), seed=11, length=150000, coverage=22,
                       read_len=9000, snp_rate=0.0015, error_rate=0.04,
                       qual=22, indel_rate=0.0004)
    phased = str(d / "phased")
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          engine="oracle", phase_indel=True,
                          params=PhaseParams()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPS_TAG_ENGINE", "host")
        run_haplotag(HaplotagConfig(snp_file=phased + ".vcf",
                                    bam_file=fix["bam"],
                                    fasta_file=fix["fasta"],
                                    result_prefix=str(d / "jax")))
    return {"args": ["-s", phased + ".vcf", "-b", fix["bam"], "-r",
                     fix["fasta"]],
            "tags": _tags(str(d / "jax.bam"))}


@pytest.fixture(scope="module")
def somatic(tmp_path_factory):
    """tests/test_tag_kernels.py:65-67, the normal sample phased by the
    oracle, then somatic_haplotag and estimate_purity of the JAX package."""
    d = tmp_path_factory.mktemp("somatic")
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
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPS_TAG_ENGINE", "host")
        run_somatic_haplotag(SomaticConfig(
            result_prefix=str(d / "jax"), write_somatic_vcf=True, **files))
        # the CLI's estimate_purity defaults: -q 20, --tagSupplementary
        run_estimate_purity(SomaticConfig(
            result_prefix=str(d / "jax_purity"), quality_threshold=20,
            tag_supplementary=True, **files))
    return {"args": ["-s", phased + ".vcf", "--tumor-snv-file",
                     fix["tumor_vcf"], "-b", fix["normal_bam"],
                     "--tumor-bam-file", fix["tumor_bam"], "-r",
                     fix["fasta"]],
            "tags": _tags(str(d / "jax.bam")),
            "sc": _lines(str(d / "jax_sc.vcf")),
            "purity": _lines(str(d / "jax_purity.out")),
            "estimate": _lines(str(d / "jax_purity_purity.out"))}


@pytest.fixture
def spy_reductions(monkeypatch):
    """Record the mode of every tag reduction the port runs."""
    calls = []

    def germline(*a, **kw):
        calls.append("germline")
        return orig_germline(*a, **kw)

    def somatic_counts(walk, t, mode, **kw):
        calls.append(mode)
        return orig_somatic(walk, t, mode, **kw)

    orig_germline = tag_kernels.germline_counts
    orig_somatic = tag_kernels.somatic_counts
    monkeypatch.setattr(tag_kernels, "germline_counts", germline)
    monkeypatch.setattr(tag_kernels, "somatic_counts", somatic_counts)
    return calls


def _port(subcommand, args, prefix, *extra):
    assert cli.main([subcommand, *args, "-o", prefix, "--device", "cpu",
                     *extra]) == 0


@pytest.mark.parametrize("engine", ["device", "host"])
def test_haplotag_matches_jax(germline, tmp_path, monkeypatch,
                              spy_reductions, engine):
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    _port("haplotag", germline["args"], str(tmp_path / "port"))
    tags = _tags(str(tmp_path / "port.bam"))
    assert tags == germline["tags"]
    assert sum(t[3] is not None for t in tags) > 100
    assert spy_reductions == (["germline"] if engine == "device" else [])


@pytest.mark.parametrize("engine", ["device", "host"])
def test_somatic_haplotag_matches_jax(somatic, tmp_path, monkeypatch,
                                      spy_reductions, engine):
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    prefix = str(tmp_path / "port")
    _port("somatic_haplotag", somatic["args"], prefix, "--output-somatic-vcf")
    tags = _tags(prefix + ".bam")
    assert tags == somatic["tags"]
    assert _lines(prefix + "_sc.vcf") == somatic["sc"]
    assert _lines(prefix + "_purity.out") == somatic["purity"]
    assert any(t[3] == "3" or (t[3] or "").startswith("1-") for t in tags)
    expected = {"normal", "extract", "haplotag"} if engine == "device" \
        else set()
    assert set(spy_reductions) == expected


@pytest.mark.parametrize("engine", ["device", "host"])
def test_estimate_purity_matches_jax(somatic, tmp_path, monkeypatch,
                                     spy_reductions, engine):
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    prefix = str(tmp_path / "port")
    _port("estimate_purity", somatic["args"], prefix)
    assert _lines(prefix + "_purity.out") == somatic["estimate"]
    expected = {"normal", "extract"} if engine == "device" else set()
    assert set(spy_reductions) == expected


def _purity(path):
    with open(path) as f:
        return float(f.read().rsplit("Tumor purity:", 1)[1])


def test_tag_subcommands_import_no_jax(germline, somatic, tmp_path):
    """A fresh interpreter with only the repo on its path runs all three
    subcommands at the default engine gate, which leaves these small walks
    on the host path, without importing jax or any module of the JAX
    package; the JAX estimator would fail there for want of jax and write
    no _purity.out."""
    out = str(tmp_path)
    code = (
        "import sys\n"
        "from longphase_s_tpu_torch.cli import main\n"
        f"assert main(['haplotag', *{germline['args']!r}, '-o', "
        f"{out + '/hap'!r}, '--device', 'cpu']) == 0\n"
        f"assert main(['somatic_haplotag', *{somatic['args']!r}, '-o', "
        f"{out + '/som'!r}, '--device', 'cpu']) == 0\n"
        f"assert main(['estimate_purity', *{somatic['args']!r}, '-o', "
        f"{out + '/est'!r}, '--device', 'cpu']) == 0\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'longphase_s_tpu'))\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTHON", "JAX", "XLA", "LPS_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX" in proc.stdout
    assert os.path.exists(tmp_path / "hap.bam")
    assert _purity(tmp_path / "som_purity.out") > 0
    assert _purity(tmp_path / "est_purity.out") > 0


@pytest.mark.parametrize("subcommand", ["haplotag", "somatic_haplotag"])
def test_device_error_raises_without_host_fallback(germline, somatic,
                                                   tmp_path, monkeypatch,
                                                   subcommand):
    def lost(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setenv("LPS_TAG_ENGINE", "device")
    monkeypatch.setattr(tag_kernels, "germline_counts", lost)
    monkeypatch.setattr(tag_kernels, "somatic_counts", lost)
    args = germline["args"] if subcommand == "haplotag" else somatic["args"]
    with pytest.raises(RuntimeError, match="device lost"):
        _port(subcommand, args, str(tmp_path / "port"))


def test_cuda_without_a_card_raises(germline, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["haplotag", *germline["args"], "-o",
                  str(tmp_path / "port"), "--device", "cuda"])


@pytest.mark.parametrize("subcommand", ["haplotag", "estimate_purity"])
def test_dist_spec_is_refused(germline, somatic, tmp_path, monkeypatch,
                              subcommand):
    """A ``--dist`` spec is no longer refused (the name is the case's from
    before the multi-process port): a spec of one process forms no group
    and the outputs equal the JAX package's, as the run without a spec
    does (tests/test_torch_distributed_tag.py runs groups)."""
    from longphase_s_tpu_torch.parallel import distributed as dist
    from longphase_s_tpu_torch.testing.processes import free_port

    monkeypatch.setattr(dist, "_initialized", False)
    args = germline["args"] if subcommand == "haplotag" else somatic["args"]
    prefix = str(tmp_path / "port")
    _port(subcommand, args, prefix, "--dist",
          f"127.0.0.1:{free_port()},1,0")
    assert not dist.is_active()
    if subcommand == "haplotag":
        assert _tags(prefix + ".bam") == germline["tags"]
    else:
        assert _lines(prefix + "_purity.out") == somatic["estimate"]
