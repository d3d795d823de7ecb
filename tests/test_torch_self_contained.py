"""The port stands alone: it imports nothing of the JAX package, and its
copies of the JAX package's host layers give the same answers.

- an AST scan of every module of ``longphase_s_tpu_torch`` and of
  ``chip_smoke.py``: no import of ``longphase_s_tpu`` or of ``jax``;
- host-layer parity on the ``testing/simulate.py`` fixtures, each case the
  port's copy against the JAX package's on the same files: the simulator
  itself, BAM records, the VCF parse, a CRAM written and read back, the
  native ``extract_phase`` arrays and both somatic extraction passes of
  ``core/somatic_fast``.

``jax_native_ready`` brings the JAX package's native library up before
any comparison: in a fresh tree one xdist worker can load the library
while another's ``g++`` still writes it in place, and the JAX loader then
gives up for that worker's life (ROADMAP, Queue C).
"""

import ast
import dataclasses
import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

import longphase_s_tpu as jax_pkg
import longphase_s_tpu_torch as port_pkg
from longphase_s_tpu import native as jax_native
from longphase_s_tpu.core import somatic_fast as jax_somatic_fast
from longphase_s_tpu.io import bam as jax_bam
from longphase_s_tpu.io import cram as jax_cram
from longphase_s_tpu.io import fasta as jax_fasta
from longphase_s_tpu.io import phased_vcf as jax_phased_vcf
from longphase_s_tpu.io import vcf as jax_vcf
from longphase_s_tpu.models import somatic as jax_somatic
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.testing import simulate as jax_simulate
from longphase_s_tpu_torch import native as port_native
from longphase_s_tpu_torch.core import somatic_fast as port_somatic_fast
from longphase_s_tpu_torch.io import bam as port_bam
from longphase_s_tpu_torch.io import cram as port_cram
from longphase_s_tpu_torch.io import fasta as port_fasta
from longphase_s_tpu_torch.io import phased_vcf as port_phased_vcf
from longphase_s_tpu_torch.io import vcf as port_vcf
from longphase_s_tpu_torch.models import somatic as port_somatic
from longphase_s_tpu_torch.testing import simulate as port_simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "longphase_s_tpu_torch")
FORBIDDEN = ("longphase_s_tpu", "jax")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT_DIR):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return [os.path.relpath(p, REPO) for p in out]


@pytest.mark.parametrize("path", _port_sources())
def test_port_module_imports_nothing_of_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found, f"{path} imports {found}"


def test_port_sources_cover_every_layer():
    paths = _port_sources()
    for layer in ("io", "native", "core", "ops", "models", "utils",
                  "testing", "parallel"):
        assert any(p.startswith(f"longphase_s_tpu_torch/{layer}/")
                   for p in paths), layer
    for module in ("mesh", "multichip", "sharded_scan"):
        assert f"longphase_s_tpu_torch/parallel/{module}.py" in paths
    assert "longphase_s_tpu_torch/testing/wgs_soak.py" in paths
    assert "longphase_s_tpu_torch/testing/purity_sweep.py" in paths
    assert "longphase_s_tpu_torch/testing/fuzz_parity.py" in paths
    assert "longphase_s_tpu_torch/testing/bench.py" in paths
    assert "longphase_s_tpu_torch/testing/stage_breakdown.py" in paths
    assert port_pkg.REFERENCE_VERSION == jax_pkg.REFERENCE_VERSION


def _plain(x):
    """Objects of either package as comparable plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if hasattr(x, "__slots__") and not isinstance(x, (str, bytes)):
        return (type(x).__name__,
                {k: _plain(getattr(x, k)) for k in x.__slots__
                 if hasattr(x, k)})
    if hasattr(x, "__dict__"):
        return (type(x).__name__, _plain(vars(x)))
    return x


def _read(path):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def jax_native_ready(timeout: float = 120.0) -> None:
    """Load the JAX package's native library in this process, or fail.

    ``longphase_s_tpu/native`` has ``g++`` write ``liblps.so`` in place
    and sets ``_tried`` before it loads, under a thread lock only, so a
    worker that loads a library another worker is still writing gets None
    for the rest of its life. Under a lock file shared by the workers
    here: while the library does not load, wait until its
    ``liblps.so.srchash`` stamp names the sources (a build has ended; at
    most 30 s, then this worker builds it itself), clear ``_tried`` and
    load again, for at most ``timeout`` seconds."""
    stamp = jax_native._LIB_PATH + ".srchash"
    want = jax_native._src_hash()
    deadline = time.monotonic() + timeout
    lock_path = os.path.join(tempfile.gettempdir(), "lps_jax_native.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        while not jax_native.available():
            if time.monotonic() > deadline:
                pytest.fail(
                    f"the JAX package's native library did not load in "
                    f"{timeout:.0f} s: its build writes liblps.so in place "
                    f"and a worker that loads it half written gives up "
                    f"(longphase_s_tpu/native/__init__.py:25-71)")
            stop = min(deadline, time.monotonic() + 30)
            while _read(stamp) != want and time.monotonic() < stop:
                time.sleep(0.2)
            time.sleep(0.5)  # a build begun before the stamp may still write
            jax_native._tried = False


@pytest.fixture(scope="module")
def jax_native_up():
    """``jax_native_ready`` once a module (other test files import it)."""
    jax_native_ready()


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory, jax_native_up):
    d = tmp_path_factory.mktemp("host_parity")
    germ = jax_simulate.make_fixture(
        str(d / "germ"), seed=31, length=90000, coverage=18, read_len=8000,
        snp_rate=0.0015, indel_rate=0.0004, error_rate=0.03, qual=22)
    som = jax_simulate.make_somatic_fixture(
        str(d / "som"), seed=32, length=120000, normal_coverage=20,
        tumor_coverage=24, purity=0.6, n_somatic=12, n_artifacts=4)
    phased = str(d / "phased")
    run_phase(PhaseConfig(snp_file=som["normal_vcf"],
                          bam_files=[som["normal_bam"]],
                          fasta_file=som["fasta"], result_prefix=phased,
                          engine="oracle"))
    som["phased_vcf"] = phased + ".vcf"
    return {"dir": d, "germ": germ, "som": som}


def _files_equal(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _case_simulate(fx):
    d = fx["dir"]
    kw = dict(seed=5, length=40000, coverage=10, read_len=6000,
              snp_rate=0.002)
    a = jax_simulate.make_fixture(str(d / "sim_jax"), **kw)
    b = port_simulate.make_fixture(str(d / "sim_port"), **kw)
    for key in ("bam", "vcf", "fasta"):
        assert _files_equal(a[key], b[key]), key
    assert _files_equal(a["bam"] + ".bai", b["bam"] + ".bai")


def _records(mod, path, region=None):
    r = mod.BamReader(path)
    it = r.fetch(*region) if region else iter(r)
    out = [bytes(rec.raw) for rec in it]
    r.close()
    return out


def _case_bam_records(fx):
    path, chrom = fx["germ"]["bam"], fx["germ"]["chrom"]
    got = _records(port_bam, path)
    assert len(got) > 100 and got == _records(jax_bam, path)
    region = (chrom, 20000, 50000)
    assert _records(port_bam, path, region) == _records(jax_bam, path, region)


def _case_vcf_parse(fx):
    het_jax = jax_vcf.read_het_variants(fx["germ"]["vcf"], True)
    het_port = port_vcf.read_het_variants(fx["germ"]["vcf"], True)
    assert het_port.contigs == het_jax.contigs
    assert _plain(het_port.by_chrom) == _plain(het_jax.by_chrom)
    multi = []
    for mod in (jax_phased_vcf, port_phased_vcf):
        info, chr_multi = mod.VcfInfo(sample=mod.NORMAL), {}
        mod.PhasedVcfReader(mod.NORMAL).parse(fx["som"]["phased_vcf"], info,
                                              chr_multi, mode="snp")
        multi.append(_plain(chr_multi))
    assert multi[0] == multi[1] and multi[0]


def _case_cram_roundtrip(fx):
    d, germ = fx["dir"], fx["germ"]
    paths = []
    for mod, bam_mod, name in ((jax_cram, jax_bam, "jax"),
                               (port_cram, port_bam, "port")):
        br = bam_mod.BamReader(germ["bam"])
        path = str(d / f"{name}.cram")
        w = mod.CramWriter(path, br.header_text, br.references, br.lengths)
        for rec in br:
            w.write(rec)
        w.close()
        br.close()
        paths.append(path)
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
    # the file definition's 20-byte id is the tail of the path
    assert blobs[0][26:] == blobs[1][26:] and blobs[0][:6] == blobs[1][:6]
    reads = [[bytes(r.raw) for r in mod.CramReader(
        paths[1], fasta=fa_mod.FastaFile(germ["fasta"]))]
        for mod, fa_mod in ((jax_cram, jax_fasta), (port_cram, port_fasta))]
    assert len(reads[0]) > 100 and reads[0] == reads[1]


def _extract_phase(native_mod, vcf_mod, fasta_mod, germ):
    het = vcf_mod.read_het_variants(germ["vcf"])
    chrom = germ["chrom"]
    last_snp = het.last_snp(chrom)
    ref_string = fasta_mod.FastaFile(germ["fasta"]).fetch(chrom, 0,
                                                          last_snp + 6)
    variants = het.by_chrom[chrom]
    vcf_mod.mark_danger_indels(variants, ref_string)
    positions = sorted(variants)
    return native_mod.extract_phase(germ["bam"], chrom, last_snp, positions,
                                    [variants[p] for p in positions],
                                    ref_string, 1, fasta_path=germ["fasta"])


def _case_native_extract_phase(fx):
    assert port_native.available() and jax_native.available()
    a = _extract_phase(jax_native, jax_vcf, jax_fasta, fx["germ"])
    b = _extract_phase(port_native, port_vcf, port_fasta, fx["germ"])
    assert sorted(a) == sorted(b) and len(a["obs_pos"]) > 1000
    for key in a:
        assert _plain(a[key]) == _plain(b[key]), key


def _extraction(pkg_native, phased_vcf, somatic_mod, fast_mod, fasta_mod,
                som, **device):
    """Both extraction passes of one package over the somatic fixture."""
    chr_multi = {}
    nor_info = phased_vcf.VcfInfo(sample=phased_vcf.NORMAL)
    phased_vcf.PhasedVcfReader(phased_vcf.NORMAL).parse(
        som["phased_vcf"], nor_info, chr_multi, mode="snp")
    tum_info = phased_vcf.VcfInfo(sample=phased_vcf.TUMOR)
    phased_vcf.PhasedVcfReader(phased_vcf.TUMOR).parse(
        som["tumor_vcf"], tum_info, chr_multi, mode="snp")
    cfg = somatic_mod.SomaticConfig(
        snp_file=som["phased_vcf"], tumor_snv_file=som["tumor_vcf"],
        bam_file=som["normal_bam"], tumor_bam_file=som["tumor_bam"],
        fasta_file=som["fasta"])
    fasta = fasta_mod.FastaFile(som["fasta"])
    out = []
    for chrom in tum_info.chr_vec:
        variants = chr_multi[chrom]
        positions = sorted(variants)
        tables = fast_mod.build_somatic_tables(positions, variants)
        length = tum_info.chr_length.get(chrom)
        refs = [fasta.fetch(chrom, 0, somatic_mod._last_var_pos(
            positions, variants, g) + 6)
            for g in (phased_vcf.NORMAL, phased_vcf.TUMOR)]
        nor = pkg_native.open_native_bam(som["normal_bam"], som["fasta"])
        tum = pkg_native.open_native_bam(som["tumor_bam"], som["fasta"])
        out.append(fast_mod.extract_normal_chromosome_fast(
            nor, chrom, length, positions, variants, refs[0],
            nor_info.read_sv_hap_count, cfg, tables=tables, **device))
        out.append(fast_mod.extract_tumor_chromosome_fast(
            tum, chrom, length, positions, variants, refs[1], cfg,
            tables=tables, **device))
    return out


def _case_somatic_fast(fx, monkeypatch):
    som = fx["som"]
    monkeypatch.setenv("LPS_TAG_ENGINE", "host")
    # the JAX package's handle cache closes the oldest of three open files
    # even while it is held: start it empty, so the two held here survive
    jax_native.drain_bam_cache()
    ref = _plain(_extraction(jax_native, jax_phased_vcf, jax_somatic,
                             jax_somatic_fast, jax_fasta, som))
    assert ref and ref[0]
    assert _plain(_extraction(port_native, port_phased_vcf, port_somatic,
                              port_somatic_fast, port_fasta, som,
                              device="cpu")) == ref
    # the port's device engine, on the CPU, gives the host engine's answer
    monkeypatch.setenv("LPS_TAG_ENGINE", "device")
    assert _plain(_extraction(port_native, port_phased_vcf, port_somatic,
                              port_somatic_fast, port_fasta, som,
                              device="cpu")) == ref


CASES = {"simulate": _case_simulate, "bam_records": _case_bam_records,
         "vcf_parse": _case_vcf_parse, "cram_roundtrip": _case_cram_roundtrip,
         "native_extract_phase": _case_native_extract_phase,
         "somatic_fast": _case_somatic_fast}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_layer_matches_jax(case, fixtures, monkeypatch):
    fn = CASES[case]
    if case == "somatic_fast":
        fn(fixtures, monkeypatch)
    else:
        fn(fixtures)


def test_native_cache_keeps_held_handles_open(fixtures):
    """Three files opened while the first two are held: the port's cache
    evicts the oldest but leaves it open for its holder."""
    paths = [fixtures["germ"]["bam"], fixtures["som"]["normal_bam"],
             fixtures["som"]["tumor_bam"]]
    port_native.drain_bam_cache()
    held = [port_native.open_native_bam(p, fixtures["som"]["fasta"])
            for p in paths]
    assert len(port_native._bam_cache) == 2
    assert all(nb._h and nb.tid("chr20") == 0 for nb in held)
    assert port_native.open_native_bam(paths[2]) is held[2]  # a cache hit
