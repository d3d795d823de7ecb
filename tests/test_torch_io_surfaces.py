"""The port's input and output surfaces against the JAX package:

- CRAM (test_cram.py:77, :104, :138): ``haplotag`` with a CRAM in and
  ``--cram`` out, and ``somatic_haplotag`` with a CRAM tumour input and
  ``--cram`` out, each on the native CRAM codec and under
  ``LPS_NO_NATIVE_CRAM=1`` (the pure-Python one), on both tag engines.
  The input CRAM is the JAX package's writer's (no htslib here); the
  output CRAM's tags equal the JAX package's BAM-in, BAM-out run, and its
  bytes but its file id (the path's tail) equal the JAX package's
  ``--cram`` output. The port's
  ``CramWriter`` writes the same bytes as JAX's from the same records;
- http inputs (test_remote.py:35): ``python -m longphase_s_tpu_torch.cli
  haplotag --device cpu`` in a fresh interpreter with the VCF, the BAM
  and the reference served by an ``http.server`` on 127.0.0.1, then again
  from ``LPS_REMOTE_CACHE``: the tags equal the local run's and JAX's;
- the CLI (test_cli_options.py, which needs the reference's sources):
  every option string of every subcommand of JAX's ``build_parser`` is
  accepted by the port's with the same destination, action and default;
  ``--device`` is the only option the port adds, and ``phase --engine``
  names its device engine ``gpu`` where JAX names it ``tpu``; a missing
  input file exits 1 with JAX's message.

CRAM 3.1 input (test_cram.py:181, :234) is not held: its oracle is the
htslib-linked ``tools/bam2cram31``, which neither package can build
without the reference's sources.
"""

import http.server
import os
import socketserver
import subprocess
import sys
import threading

import pytest

from longphase_s_tpu import cli as jax_cli
from longphase_s_tpu import native as jax_native
from longphase_s_tpu.io.cram import CramWriter as JaxCramWriter
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.somatic import SomaticConfig, run_somatic_haplotag
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch import native as port_native
from longphase_s_tpu_torch.io.bam import BamReader
from longphase_s_tpu_torch.io.cram import CramReader, CramWriter
from longphase_s_tpu_torch.io.fasta import FastaFile
from longphase_s_tpu_torch.models import haplotag as port_haplotag
from longphase_s_tpu_torch.models import somatic as port_somatic
from longphase_s_tpu_torch.testing.fuzz_parity import (bam_tags, cram_body,
                                                       cram_tags, vcf_rows)
from longphase_s_tpu_torch.testing.simulate import (make_fixture,
                                                    make_somatic_fixture)
# a fixture: the CRAM bytes compared are JAX's native writer's
from tests.test_torch_self_contained import jax_native_up  # noqa: F401
from tests.test_torch_tag_surfaces import _oracle_phase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ["device", "host"]
CODECS = ["native", "python"]


def _write_cram(writer_cls, bam, path):
    br = BamReader(bam)
    w = writer_cls(path, br.header_text, br.references, br.lengths)
    for rec in br:
        w.write(rec)
    w.close()
    br.close()
    return path


def _out(tmp_path, side):
    os.makedirs(tmp_path / side, exist_ok=True)
    return str(tmp_path / side / "out")


def _cram_bytes(path):
    """``cram_body`` of ``path``, whose file id (bytes 6-25) both writers
    fill with the last 20 bytes of the path."""
    with open(path, "rb") as f:
        assert f.read(26)[6:] == os.fsencode(path)[-20:].ljust(20, b"\0")
    return cram_body(path)


@pytest.fixture
def codec(request, monkeypatch):
    """The CRAM codec both packages use: their native one, or the
    pure-Python one under ``LPS_NO_NATIVE_CRAM=1``."""
    if request.param == "python":
        monkeypatch.setenv("LPS_NO_NATIVE_CRAM", "1")
    port_native._bam_cache.clear()
    jax_native.drain_bam_cache()
    yield request.param
    port_native._bam_cache.clear()
    jax_native.drain_bam_cache()


@pytest.fixture(scope="module")
def germ(tmp_path_factory, jax_native_up):
    """conftest.py's small_fixture, simulated by the port and phased by
    the JAX package, with its BAM written as CRAM by the JAX package."""
    d = tmp_path_factory.mktemp("io_surfaces")
    fix = make_fixture(str(d / "fix"), seed=7, length=120000, coverage=20,
                       read_len=12000, snp_rate=0.001)
    fix["phased"] = _oracle_phase(fix["vcf"], fix["bam"], fix["fasta"],
                                  str(d / "phased"))
    fix["cram"] = _write_cram(JaxCramWriter, fix["bam"], str(d / "reads.cram"))
    run_haplotag(HaplotagConfig(snp_file=fix["phased"], bam_file=fix["bam"],
                                fasta_file=fix["fasta"],
                                result_prefix=str(d / "bam_tagged")))
    fix["bam_tags"] = bam_tags(str(d / "bam_tagged.bam"))
    return fix


@pytest.mark.parametrize("codec", CODECS, indirect=True)
def test_cram_writer_matches_jax(germ, tmp_path, codec):
    ours = _write_cram(CramWriter, germ["bam"], _out(tmp_path, "o") + ".cram")
    golden = _write_cram(JaxCramWriter, germ["bam"],
                         _out(tmp_path, "g") + ".cram")
    assert _cram_bytes(ours) == _cram_bytes(golden)
    want = [(r.qname, r.flag, r.pos, r.cigar_tuples(), r.seq())
            for r in BamReader(germ["bam"])]
    got = [(r.qname, r.flag, r.pos, r.cigar_tuples(), r.seq())
           for r in CramReader(ours, fasta=FastaFile(germ["fasta"]))]
    assert got == want


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("codec", CODECS, indirect=True)
def test_haplotag_cram_in_cram_out_matches_jax(germ, tmp_path, monkeypatch,
                                               codec, engine):
    files = dict(snp_file=germ["phased"], bam_file=germ["cram"],
                 fasta_file=germ["fasta"], output_cram=True)
    golden, ours = _out(tmp_path, "g"), _out(tmp_path, "o")
    run_haplotag(HaplotagConfig(result_prefix=golden, **files))
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    port_haplotag.run_haplotag(port_haplotag.HaplotagConfig(
        result_prefix=ours, device="cpu", **files))
    got = cram_tags(ours + ".cram", germ["fasta"])
    assert sum(t[3] is not None for t in got) > 100
    assert got == germ["bam_tags"]
    assert _cram_bytes(ours + ".cram") == _cram_bytes(golden + ".cram")


@pytest.fixture(scope="module")
def som(tmp_path_factory, jax_native_up):
    """test_cram.py:104's pair, the tumour BAM written as CRAM by the JAX
    package, the normal phased by it."""
    d = tmp_path_factory.mktemp("somatic_cram")
    fix = make_somatic_fixture(str(d / "fix"), seed=31, length=150000,
                               purity=0.6, n_somatic=10, n_artifacts=3)
    fix["phased"] = _oracle_phase(fix["normal_vcf"], fix["normal_bam"],
                                  fix["fasta"], str(d / "phased"))
    fix["tumor_cram"] = _write_cram(JaxCramWriter, fix["tumor_bam"],
                                    str(d / "tumor.cram"))
    jax_native.drain_bam_cache()
    run_somatic_haplotag(SomaticConfig(
        snp_file=fix["phased"], tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
        fasta_file=fix["fasta"], result_prefix=str(d / "bam_tagged"),
        write_somatic_vcf=True))
    fix["bam_tags"] = bam_tags(str(d / "bam_tagged.bam"))
    fix["bam_sc"] = vcf_rows(str(d / "bam_tagged_sc.vcf"))
    return fix


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("codec", CODECS, indirect=True)
def test_somatic_cram_matches_jax(som, tmp_path, monkeypatch, codec,
                                  engine):
    """A CRAM tumour input, and ``--cram`` out."""
    files = dict(snp_file=som["phased"], tumor_snv_file=som["tumor_vcf"],
                 bam_file=som["normal_bam"],
                 tumor_bam_file=som["tumor_cram"], fasta_file=som["fasta"],
                 write_somatic_vcf=True, output_cram=True)
    golden, ours = _out(tmp_path, "g"), _out(tmp_path, "o")
    jax_native.drain_bam_cache()
    run_somatic_haplotag(SomaticConfig(result_prefix=golden, **files))
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    port_somatic.run_somatic_haplotag(port_somatic.SomaticConfig(
        result_prefix=ours, device="cpu", **files))
    got = cram_tags(ours + ".cram", som["fasta"])
    assert sum(t[3] is not None for t in got) > 100
    assert got == som["bam_tags"]
    assert vcf_rows(ours + "_sc.vcf") == som["bam_sc"] == \
        vcf_rows(golden + "_sc.vcf")
    assert _cram_bytes(ours + ".cram") == _cram_bytes(golden + ".cram")


# http inputs


@pytest.fixture
def http_root(germ):
    fixdir = os.path.dirname(germ["bam"])

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=fixdir, **kw)

        def log_message(self, *a):
            pass

    httpd = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_remote_inputs_match_jax(germ, http_root, tmp_path):
    import shutil

    shutil.copy(germ["phased"],
                os.path.join(os.path.dirname(germ["bam"]), "phased.vcf"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTHON", "JAX", "XLA"))
           and "proxy" not in k.lower()}
    env.update(PYTHONPATH=REPO, NO_PROXY="127.0.0.1", no_proxy="127.0.0.1",
               LPS_REMOTE_CACHE=str(tmp_path / "cache"))

    def run(out, *inputs):
        r = subprocess.run(
            [sys.executable, "-m", "longphase_s_tpu_torch.cli", "haplotag",
             "-s", inputs[0], "-b", inputs[1], "-r", inputs[2],
             "-o", str(tmp_path / out), "--device", "cpu"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        return r.stderr, bam_tags(str(tmp_path / f"{out}.bam"))

    _, local = run("local", germ["phased"], germ["bam"], germ["fasta"])
    urls = [f"{http_root}/{name}" for name in ("phased.vcf", "reads.bam",
                                               "ref.fa")]
    log, fetched = run("url", *urls)
    assert log.count("fetching http://127.0.0.1") == 3
    cached = os.listdir(tmp_path / "cache")
    assert any(n.endswith("reads.bam.bai") for n in cached)
    log, again = run("url2", *urls)
    assert "fetching" not in log
    assert sorted(os.listdir(tmp_path / "cache")) == sorted(cached)
    assert sum(t[3] is not None for t in local) > 100
    assert fetched == again == local == germ["bam_tags"]


# the CLI


def _subparsers(parser):
    return parser._subparsers._group_actions[0].choices


def _option_actions(sub):
    return {s: a for a in sub._actions for s in a.option_strings}


# the port's own name for JAX's device phase engine
ENGINE_NAMES = {"tpu": "gpu", "oracle": "oracle"}


@pytest.mark.parametrize("command", ["phase", "haplotag", "somatic_haplotag",
                                     "estimate_purity", "modcall"])
def test_cli_options_match_jax(command):
    jax_sub = _subparsers(jax_cli.build_parser())[command]
    port_sub = _subparsers(cli.build_parser())[command]
    jax_opts, port_opts = _option_actions(jax_sub), _option_actions(port_sub)
    assert set(port_opts) - set(jax_opts) == {"--device"}
    assert set(jax_opts) <= set(port_opts)
    for opt, ja in jax_opts.items():
        pa = port_opts[opt]
        assert type(pa) is type(ja), opt
        assert (pa.dest, pa.nargs, pa.type, pa.required, pa.const) == \
            (ja.dest, ja.nargs, ja.type, ja.required, ja.const), opt
        if opt == "--engine":
            assert pa.choices == [ENGINE_NAMES[c] for c in ja.choices]
            assert pa.default == ENGINE_NAMES[ja.default]
        else:
            assert (pa.default, pa.choices) == (ja.default, ja.choices), opt
    positional = [a.dest for a in jax_sub._actions if not a.option_strings]
    assert positional == [a.dest for a in port_sub._actions
                          if not a.option_strings]


@pytest.mark.parametrize("command", ["phase", "haplotag", "somatic_haplotag",
                                     "modcall"])
def test_missing_input_file_matches_jax(germ, tmp_path, capsys, command):
    """FileValidator (PARITY.md §2.1): a missing input file exits 1 with
    the same message from both CLIs, before any output is written."""
    missing = str(tmp_path / "missing.bam")
    argv = {"phase": ["phase", "--pb", "-s", germ["vcf"], "-b", missing],
            "haplotag": ["haplotag", "-s", germ["phased"], "-b", missing],
            "somatic_haplotag": ["somatic_haplotag", "-s", germ["phased"],
                                 "--tumor-snv-file", germ["vcf"], "-b",
                                 germ["bam"], "--tumor-bam-file", missing],
            "modcall": ["modcall", "-b", missing]}[command]
    argv += ["-r", germ["fasta"], "-o", str(tmp_path / "out")]
    errors = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 1
        errors.append(capsys.readouterr().err)
    assert f"{missing} not exist" in errors[1]
    assert errors[1] == errors[0]
    assert not any(p.name.startswith("out") for p in tmp_path.iterdir())
