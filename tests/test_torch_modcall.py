"""``modcall`` on the port against the JAX package.

- ``ops/tag_kernels.modcall_edges`` on the CPU against JAX
  ``modcall_edges_device`` (XLA on the CPU backend) and the port's numpy
  ``modcall_edges_host``, on event streams made from numpy seeds: reads
  contiguous, positions non-decreasing within a read, SNP/MOD mixes with
  all-SNP reads, E from 0 to 3,000, one read or many short ones. Then a
  stream with a position that falls within a read (JAX's device path
  agrees, the host path's composite key does not) and one with positions
  above 2^30 (the host path agrees, JAX's device path refuses).
- ``cli modcall --device cpu`` against JAX ``run_modcall``, on both tag
  engines, without ``##commandline`` and ``##longphase``: the default
  output, ``--all``, several chromosomes, two ``-b`` files (the object
  path), the per-chromosome streaming handle on BAM and CRAM, and a
  checkpoint kill and resume.
- The guards: a spec of one process through ``--dist`` or ``LPS_DIST``
  runs like no spec, ``--device cuda`` without a card raises, a device error raises without a host fallback, and a
  fresh interpreter runs ``cli modcall`` without importing jax or the JAX
  package.

Every comparison is exact: the edge counts are integer arithmetic and a
sort.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from longphase_s_tpu.models.modcall import ModCallConfig, run_modcall
from longphase_s_tpu.ops import tag_kernels as jax_tk
from longphase_s_tpu.testing.simulate import (make_meth_fixture,
                                              make_multichrom_meth_fixture)
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch import native as port_native
from longphase_s_tpu_torch.io.bam import BamReader
from longphase_s_tpu_torch.io.cram import CramWriter
from longphase_s_tpu_torch.models import modcall_fast
from longphase_s_tpu_torch.ops import tag_kernels as tk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VT_MOD, VT_SNP = 0, 1


def _events(rng, E, n_reads):
    """E events of ``n_reads`` contiguous reads in read order: positions
    non-decreasing within a read (gaps 0..39 from a random start), 70% SNP
    events, every fourth read all SNP, alleles 0/1."""
    read = np.sort(rng.integers(0, n_reads, E)).astype(np.int64)
    start = rng.integers(0, 1_000_000, n_reads)
    first = np.ones(E, bool)
    first[1:] = read[1:] != read[:-1]
    gap = np.where(first, 0, rng.integers(0, 40, E))
    csum = np.cumsum(gap)
    pos = start[read] + csum - csum[first][np.cumsum(first) - 1]
    vtype = np.where((rng.random(E) < 0.7) | (read % 4 == 3), VT_SNP,
                     VT_MOD).astype(np.uint8)
    allele = rng.integers(0, 2, E).astype(np.int64)
    return pos.astype(np.int64), allele, vtype, read


def _same(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int64
        assert np.array_equal(x, y)


@pytest.mark.parametrize("layout", ["one_read", "short_reads"])
@pytest.mark.parametrize("E", [0, 1, 2, 50, 51, 52, 1000, 3000])
def test_modcall_edges_match_jax_and_host(E, layout):
    rng = np.random.default_rng(E * 2 + (layout == "one_read"))
    n_reads = 1 if layout == "one_read" else max(1, E // 8)
    ev = _events(rng, E, n_reads)
    if E:
        assert np.all(np.diff(ev[0])[np.diff(ev[3]) == 0] >= 0)
    got = tk.modcall_edges(*ev, device="cpu")
    _same(jax_tk.modcall_edges_device(*ev), got)
    _same(modcall_fast.modcall_edges_host(*ev), got)
    if E >= 50:
        assert len(got[0]) > 0


def test_a_position_within_a_read_matches_jax_not_host():
    """One read of MOD events at 100, 99, 120, 130: the pair (100, 99) is
    the edge (200, -1) on both device paths. The host path's composite key
    decodes it as (199, 63), the key of the pair (99, 130), which it then
    counts twice; the port's host copy keeps the JAX package's decode."""
    ev = (np.array([100, 99, 120, 130]), np.array([0, 1, 0, 1]),
          np.zeros(4, np.uint8), np.zeros(4, np.int64))
    got = tk.modcall_edges(*ev, device="cpu")
    _same(jax_tk.modcall_edges_device(*ev), got)

    def counts(k1, k2, cnt):
        return dict(zip(zip(k1.tolist(), k2.tolist()), cnt.tolist()))

    edges = counts(*got)
    host = counts(*modcall_fast.modcall_edges_host(*ev))
    assert edges[(200, -1)] == 1 and edges[(199, 63)] == 1
    assert (200, -1) not in host and host[(199, 63)] == 2
    del edges[(200, -1)], edges[(199, 63)], host[(199, 63)]
    assert edges == host


def test_positions_above_2_30_match_host():
    rng = np.random.default_rng(5)
    pos, allele, vtype, read = _events(rng, 2000, 40)
    pos = pos + 2**31
    got = tk.modcall_edges(pos, allele, vtype, read, device="cpu")
    _same(modcall_fast.modcall_edges_host(pos, allele, vtype, read), got)
    assert got[0].min() > 2**32
    with pytest.raises(OverflowError):
        jax_tk.modcall_edges_device(pos, allele, vtype, read)


# ---------------------------------------------------------------------------
# cli modcall against JAX run_modcall
# ---------------------------------------------------------------------------


def _body(path):
    with open(path) as f:
        return [line for line in f
                if not line.startswith(("##longphase", "##commandline"))]


@pytest.fixture(scope="module")
def meth(tmp_path_factory):
    """tests/test_golden_modcall.py's fixture and a three-chromosome one
    (tests/test_checkpoint.py), with the JAX package's VCFs."""
    d = tmp_path_factory.mktemp("meth")
    fix = make_meth_fixture(str(d / "fix"), seed=17, length=150000,
                            coverage=25, read_len=10000, n_asm=12,
                            n_homo_mod=6)
    multi = make_multichrom_meth_fixture(str(d / "multi"), seed=23,
                                         n_chroms=3, base_length=100000)
    runs = {"default": (fix, [fix["bam"]], True, False),
            "all": (fix, [fix["bam"]], False, True),
            "multichrom": (multi, [multi["bam"]], True, False),
            "two_bams": (fix, [fix["bam"], fix["bam"]], True, False)}
    out = {"fix": fix, "multi": multi, "jax": {}}
    for name, (fx, bams, with_snps, output_all) in runs.items():
        prefix = str(d / f"jax_{name}")
        run_modcall(ModCallConfig(
            bam_files=bams, fasta_file=fx["fasta"],
            snp_file=fx["vcf"] if with_snps else "", result_prefix=prefix,
            output_all_mod=output_all))
        out["jax"][name] = _body(prefix + ".vcf")
    return out


def _args(fx, bams=None, with_snps=True):
    args = ["-r", fx["fasta"]]
    for bam in bams or [fx["bam"]]:
        args += ["-b", bam]
    return args + (["-s", fx["vcf"]] if with_snps else [])


def _port(args, prefix, *extra):
    assert cli.main(["modcall", *args, "-o", prefix, "--device", "cpu",
                     *extra]) == 0
    return _body(prefix + ".vcf")


@pytest.fixture
def spy_edges(monkeypatch):
    """Record every call of the device edge counts."""
    calls = []
    orig = tk.modcall_edges

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return orig(*a, **kw)

    monkeypatch.setattr(tk, "modcall_edges", spy)
    return calls


def _streamed(meth, tmp_path, monkeypatch, path):
    used = {}
    orig = port_native.open_chrom_native_bam

    def spy(bam, fasta_path, chrom):
        nb = orig(bam, fasta_path, chrom)
        used["chrom_handle"] = nb is not None
        return nb

    monkeypatch.setattr(modcall_fast, "open_chrom_native_bam", spy)
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    monkeypatch.setenv("LPS_MAX_CHROM_IMAGE", str(64 << 20))
    port_native.drain_bam_cache()
    try:
        body = _port(_args(meth["fix"], [path]), str(tmp_path / "port"))
    finally:
        port_native.drain_bam_cache()
    assert used.get("chrom_handle"), \
        "the memory cap did not engage the per-chromosome streaming handle"
    return body, "default"


def _case_default(meth, tmp_path, monkeypatch):
    return _port(_args(meth["fix"]), str(tmp_path / "port")), "default"


def _case_all(meth, tmp_path, monkeypatch):
    return _port(_args(meth["fix"], with_snps=False), str(tmp_path / "port"),
                 "--all"), "all"


def _case_multichrom(meth, tmp_path, monkeypatch):
    return _port(_args(meth["multi"]), str(tmp_path / "port")), "multichrom"


def _case_two_bams(meth, tmp_path, monkeypatch):
    fix = meth["fix"]
    return _port(_args(fix, [fix["bam"], fix["bam"]]),
                 str(tmp_path / "port")), "two_bams"


def _case_stream_bam(meth, tmp_path, monkeypatch):
    return _streamed(meth, tmp_path, monkeypatch, meth["fix"]["bam"])


def _case_stream_cram(meth, tmp_path, monkeypatch):
    cram = str(tmp_path / "reads.cram")
    br = BamReader(meth["fix"]["bam"])
    w = CramWriter(cram, br.header_text, br.references, br.lengths)
    for rec in br:
        w.write(rec)
    w.close()
    br.close()
    return _streamed(meth, tmp_path, monkeypatch, cram)


def _case_resume(meth, tmp_path, monkeypatch):
    """Killed on the second chromosome, then resumed from the per-contig
    line checkpoints: only the two unfinished contigs are recomputed."""
    args = _args(meth["multi"])
    ckpt = str(tmp_path / "ckpt")
    real = modcall_fast.run_chrom_fast
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(modcall_fast, "run_chrom_fast", dying)
    with pytest.raises(KeyboardInterrupt):
        _port(args, str(tmp_path / "killed"), "--checkpoint", ckpt)
    calls["n"] = 0
    monkeypatch.setattr(modcall_fast, "run_chrom_fast", counting)
    body = _port(args, str(tmp_path / "port"), "--checkpoint", ckpt)
    assert calls["n"] == 2
    return body, "multichrom"


CASES = {"default": _case_default, "all": _case_all,
         "multichrom": _case_multichrom, "two_bams": _case_two_bams,
         "stream_bam": _case_stream_bam, "stream_cram": _case_stream_cram,
         "resume": _case_resume}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_modcall_matches_jax(case, engine, meth, tmp_path, monkeypatch,
                                 spy_edges):
    monkeypatch.setenv("LPS_TAG_ENGINE", engine)
    body, ref = CASES[case](meth, tmp_path, monkeypatch)
    assert body == meth["jax"][ref]
    assert sum(not line.startswith("#") for line in body) >= 10
    # the object path (two -b files) counts its edges on the host in
    # Python, as the JAX package does; the killed run computes one contig
    # and the resumed run the other two
    n_chroms = {"multichrom": 3, "resume": 3, "two_bams": 0}.get(case, 1)
    assert spy_edges == (["cpu"] * n_chroms if engine == "device" else [])


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_device_error_raises_without_host_fallback(meth, tmp_path,
                                                   monkeypatch):
    def lost(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setenv("LPS_TAG_ENGINE", "device")
    monkeypatch.setattr(tk, "modcall_edges", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        _port(_args(meth["fix"]), str(tmp_path / "port"))


def test_cuda_without_a_card_raises(meth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("device", "host"):
        monkeypatch.setenv("LPS_TAG_ENGINE", engine)
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(["modcall", *_args(meth["fix"]), "-o",
                      str(tmp_path / "port"), "--device", "cuda"])
    with pytest.raises(RuntimeError, match="is_available"):
        tk.modcall_edges(*_events(np.random.default_rng(1), 60, 2))


@pytest.mark.parametrize("how", ["flag", "env"])
def test_dist_spec_is_refused(meth, tmp_path, monkeypatch, how):
    """A spec is no longer refused (the name is the case's from before the
    multi-process port): a spec of one process, through ``--dist`` or
    ``LPS_DIST``, forms no group and the VCF equals the JAX package's, as
    the run without a spec does (tests/test_torch_distributed_tag.py runs
    groups)."""
    from longphase_s_tpu_torch.parallel import distributed as dist
    from longphase_s_tpu_torch.testing.processes import free_port

    monkeypatch.setattr(dist, "_initialized", False)
    spec = f"127.0.0.1:{free_port()},1,0"
    extra = ["--dist", spec] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("LPS_DIST", spec)
    assert _port(_args(meth["fix"]), str(tmp_path / "port"), *extra) == \
        meth["jax"]["default"]
    assert not dist.is_active()


def test_modcall_imports_no_jax(meth, tmp_path):
    """A fresh interpreter with only the repo on its path runs cli modcall
    on both engines without importing jax or any module of the JAX
    package."""
    args = _args(meth["fix"])
    code = (
        "import os, sys\n"
        "from longphase_s_tpu_torch.cli import main\n"
        "for engine in ('device', 'host'):\n"
        "    os.environ['LPS_TAG_ENGINE'] = engine\n"
        f"    assert main(['modcall', *{args!r}, '-o', "
        f"{str(tmp_path) + '/'!r} + engine, '--device', 'cpu']) == 0\n"
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
    for engine in ("device", "host"):
        assert _body(tmp_path / f"{engine}.vcf") == meth["jax"]["default"]
