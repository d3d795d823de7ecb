"""The port's phase step and slice against the JAX package, plus the guards
that keep the port free of JAX and of silent CPU fallbacks.

- step: longphase_s_tpu_torch ops/fused.run_fused_phase on the CPU against
  the JAX run_fused_phase (Pallas scan in interpret mode) on both of its
  pack paths: ps equal, ori equal on phased sites;
- slice: the port's ``cli phase --device cpu`` against the JAX run_phase
  with engine "tpu" and "oracle": VCF lines other than ``##`` headers equal.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from longphase_s_tpu.core.fastpath import merge_observations
from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.models.phase import PhaseConfig as JaxPhaseConfig
from longphase_s_tpu.models.phase import run_phase as jax_run_phase
from longphase_s_tpu.ops.fused import run_fused_phase as jax_run_fused_phase
from longphase_s_tpu.ops.vote_scan import assemble_blocks as jax_assemble_blocks
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.ops import cuda_scan
from longphase_s_tpu_torch.ops.fused import (device_assemble_blocks,
                                             run_fused_phase)
from longphase_s_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_alignments(seed, unique_names):
    """Alignments over up to 500 sites with every variant-type quality
    sentinel (tests/test_fused_phase.py's draw)."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(50, 500))
    A = int(rng.integers(30, 250))
    positions = np.sort(rng.choice(np.arange(S * 120), size=S,
                                   replace=False)).astype(np.int64)
    chunks, names = [], []
    for a in range(A):
        start = int(rng.integers(0, S))
        ln = int(rng.integers(1, min(60, S - start) + 1))
        idx = np.arange(start, start + ln)
        chunks.append((idx, rng.integers(0, 2, size=ln),
                       rng.choice([30, 5, -4, -5, -1, -2], size=ln)))
        names.append(f"r{a}" if unique_names else f"r{int(rng.integers(0, A))}")
    obs_pos = np.concatenate([positions[i] for i, _, _ in chunks])
    obs_allele = np.concatenate([x for _, x, _ in chunks]).astype(np.int8)
    obs_qual = np.concatenate([q for _, _, q in chunks]).astype(np.int16)
    offsets = np.concatenate(
        [[0], np.cumsum([len(i) for i, _, _ in chunks])]).astype(np.int64)
    return obs_pos, obs_allele, obs_qual, offsets, names


@pytest.mark.parametrize("seed,gram_path", [(0, False), (1, False),
                                            (2, True), (3, True)])
def test_fused_phase_matches_jax_step(seed, gram_path, monkeypatch):
    """JAX takes the Gram-matmul path (_mxu_phase) when LPS_MXU_PACK_MIN is
    at or below the stream size and the stream has unique (read, rank)
    pairs, else the scatter path (_fused_phase); the port has one path."""
    params = PhaseParams()
    flat = _random_alignments(seed, unique_names=gram_path)
    positions, vtype, _rank, m_read, m_rank, m_allele, m_qok, m_aln = \
        merge_observations(*flat, params)
    n_aln = len(flat[3]) - 1
    monkeypatch.setenv("LPS_MXU_PACK_MIN", "1" if gram_path else str(1 << 40))
    ps0, ori0 = jax_run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln,
                                    positions, vtype, n_aln, params,
                                    use_pallas=True, interpret=True)
    ps1, ori1 = run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln,
                                positions, vtype, n_aln, params, device="cpu")
    assert (ps0 != 0).sum() > 0
    assert np.array_equal(ps0, ps1)
    phased = ps0 != 0
    assert np.array_equal(ori0[phased], ori1[phased])


@pytest.mark.parametrize("seed", [11, 12])
def test_device_assemble_blocks_matches_host_assembly(seed):
    rng = np.random.default_rng(seed)
    S, W = 600, 35
    sparse = rng.random((S, W)) < 0.02  # sparse edges: many blocks
    s_para10 = torch.from_numpy(
        (rng.integers(0, 60, (S, W)) * sparse).astype(np.int32))
    s_cross10 = torch.from_numpy(
        (rng.integers(0, 60, (S, W)) * sparse).astype(np.int32))
    gap = torch.from_numpy(rng.choice([100, 400000], S, p=[0.97, 0.03])
                           .astype(np.int32))
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8))
    assigned, hp, bstart = cuda_scan.vote_scan_pc(
        s_para10, s_cross10, gap, vtype, S, W, 300000, 7.0)
    positions = np.sort(rng.choice(10**7, S, replace=False)).astype(np.int64)
    ps0, ori0 = jax_assemble_blocks(positions, assigned.numpy(), hp.numpy(),
                                    bstart.numpy())
    ps1, ori1 = device_assemble_blocks(assigned, hp, bstart,
                                       torch.from_numpy(positions), S)
    assert len(np.unique(ps0[ps0 != 0])) > 1
    assert np.array_equal(ps0, ps1.numpy())
    assert np.array_equal(ori0, ori1.numpy())


def _vcf_body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def _jax_phase(fx, prefix, engine, **files):
    jax_run_phase(JaxPhaseConfig(
        snp_file=fx["vcf"], bam_files=[fx["bam"]], fasta_file=fx["fasta"],
        result_prefix=prefix, num_threads=1, is_pb=True, engine=engine,
        **files))


def _port_phase(fx, prefix, *extra):
    rc = cli.main(["phase", "--pb", "-s", fx["vcf"], "-b", fx["bam"], "-r",
                   fx["fasta"], "-o", prefix, "--device", "cpu", *extra])
    assert rc == 0


@pytest.mark.parametrize("engine", ["gpu", "oracle"])
def test_cli_phase_matches_jax(small_fixture, tmp_path, engine):
    _port_phase(small_fixture, str(tmp_path / "port"), "--engine", engine)
    port = _vcf_body(tmp_path / "port.vcf")
    assert sum("|" in line for line in port) > 10
    for jax_engine in ("tpu", "oracle"):
        _jax_phase(small_fixture, str(tmp_path / jax_engine), jax_engine)
        assert port == _vcf_body(tmp_path / f"{jax_engine}.vcf"), jax_engine


def test_object_path_matches_jax(small_fixture, tmp_path, monkeypatch):
    """Without the native ingest library the device engine takes the
    object path (ops/engine.py)."""
    from longphase_s_tpu import native
    from longphase_s_tpu_torch.ops import engine

    calls = []
    orig = engine.phase_chromosome_device

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr("longphase_s_tpu_torch.models.phase."
                        "phase_chromosome_device", spy)
    _port_phase(small_fixture, str(tmp_path / "port"))
    assert calls
    monkeypatch.undo()
    _jax_phase(small_fixture, str(tmp_path / "tpu"), "tpu")
    assert _vcf_body(tmp_path / "port.vcf") == _vcf_body(tmp_path / "tpu.vcf")


def test_cli_phase_svmod_matches_jax(tmp_path):
    from longphase_s_tpu.testing.simulate import make_fixture

    fx = make_fixture(str(tmp_path / "fix"), seed=55, length=150000,
                      coverage=20, read_len=8000, snp_rate=0.0015,
                      n_svs=4, n_mods=5)
    files = dict(sv_file=fx["sv_vcf"], mod_file=fx["mod_vcf"])
    _port_phase(fx, str(tmp_path / "port"), "--sv-file", fx["sv_vcf"],
                "--mod-file", fx["mod_vcf"])
    for jax_engine in ("tpu", "oracle"):
        _jax_phase(fx, str(tmp_path / jax_engine), jax_engine, **files)
        for suffix in (".vcf", "_SV.vcf", "_mod.vcf"):
            assert _vcf_body(tmp_path / f"port{suffix}") == \
                _vcf_body(tmp_path / f"{jax_engine}{suffix}"), \
                (jax_engine, suffix)


def test_cli_phase_ont_indels_realism_matches_jax(tmp_path):
    """ONT erasure, indel phasing, and split-read/chimera alignments that
    repeat a read name: the port's flat path against both JAX engines."""
    from longphase_s_tpu.testing.simulate import make_fixture

    fx = make_fixture(str(tmp_path / "fix"), seed=21, length=120000,
                      coverage=25, read_len=9000, snp_rate=0.002,
                      indel_rate=0.0005, error_rate=0.03, qual=20,
                      realism=True)
    rc = cli.main(["phase", "--ont", "--indels", "-s", fx["vcf"], "-b",
                   fx["bam"], "-r", fx["fasta"], "-o", str(tmp_path / "port"),
                   "--device", "cpu"])
    assert rc == 0
    port = _vcf_body(tmp_path / "port.vcf")
    assert sum("|" in line for line in port) > 10
    for jax_engine in ("tpu", "oracle"):
        jax_run_phase(JaxPhaseConfig(
            snp_file=fx["vcf"], bam_files=[fx["bam"]], fasta_file=fx["fasta"],
            result_prefix=str(tmp_path / jax_engine), num_threads=1,
            is_ont=True, phase_indel=True, engine=jax_engine))
        assert port == _vcf_body(tmp_path / f"{jax_engine}.vcf"), jax_engine


def test_port_phase_imports_no_jax(small_fixture, tmp_path):
    """The pytest process has jax loaded (conftest.py); a fresh interpreter
    with only the repo on its path runs the port's phase without it."""
    code = (
        "import sys\n"
        "from longphase_s_tpu_torch.cli import main\n"
        f"rc = main(['phase', '--pb', '-s', {small_fixture['vcf']!r}, "
        f"'-b', {small_fixture['bam']!r}, '-r', {small_fixture['fasta']!r}, "
        f"'-o', {str(tmp_path / 'out')!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTHON", "JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX" in proc.stdout
    assert os.path.exists(tmp_path / "out.vcf")


def test_resolve_device_has_no_cpu_fallback(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        run_fused_phase(np.zeros(2, np.int32), np.zeros(2, np.int32),
                        np.zeros(2, np.int8), np.ones(2, bool),
                        np.zeros(2, np.int32), np.array([10, 20]),
                        np.zeros(2, np.int8), 1, PhaseParams(), device="cuda")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("mps")


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    from longphase_s_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()
    fake = tmp_path / "no_cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(_build.KernelBuildError, match="refused"):
        _build.library()
    assert _build._lib is None


def test_other_subcommands_are_not_ported(capsys):
    assert cli.main(["haplotag", "-s", "x.vcf"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_dist_spec_is_refused(small_fixture, tmp_path):
    with pytest.raises(NotImplementedError):
        _port_phase(small_fixture, str(tmp_path / "port"),
                    "--dist", "localhost:1234,2,0")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_fast_without_a_card(tmp_path, alone):
    """chip_smoke.py refuses to run without CUDA, and in a directory that
    holds nothing else of the repo, before it simulates any fixture."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert time.perf_counter() - t0 < 60
