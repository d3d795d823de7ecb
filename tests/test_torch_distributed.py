"""The port's multi-process run (``parallel/distributed.py``, ``--dist``)
against the JAX package's one-process run, as tests/test_distributed.py
holds the JAX package's own:

- ``cli phase --device cpu`` (engine ``gpu``, the plain versions of the
  kernels) in 2 and 4 processes of one gloo group on
  ``make_multichrom_fixture(seed=43, n_chroms=5, base_length=40000)``: the
  VCF equals the JAX package's one-process VCF and the port's;
- the same in 2 processes with ``LPS_MULTICHIP=1`` and ``--checkpoint``,
  twice: the second run resumes, and both VCFs are equal;
- the API in 3 processes: ``allgather_bytes`` with blobs of different
  lengths and an empty one, ``allgather_f64``, ``psum_counters`` and
  ``merge_chr_results``;
- the per-process device: a bare ``cuda`` is ``cuda:{pid % count}``, and the
  multichip sink, the wavefront and the somatic batch count one card under
  a group (the device count and the group faked);
- no fallback: a peer that exits right after joining makes the other exit
  non-zero well within the timeout, without an output, and a group that
  cannot form raises.

Every process is a fresh interpreter that imports only the port
(``testing/processes.py``); the JAX side runs in the test process.
"""

import os
import time

import pytest
import torch

from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.testing.simulate import make_multichrom_fixture
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.parallel import distributed as dist
from longphase_s_tpu_torch.testing import processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _body(path):
    with open(path) as f:
        return [line for line in f
                if not line.startswith(("##commandline", "##longphase"))]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    """The fixture of tests/test_distributed.py, phased in one process by
    the JAX package and by the port."""
    d = tmp_path_factory.mktemp("dist_fix")
    fx = make_multichrom_fixture(str(d / "fix"), seed=43, n_chroms=5,
                                 base_length=40000)
    run_phase(PhaseConfig(snp_file=fx["vcf"], bam_files=[fx["bam"]],
                          fasta_file=fx["fasta"], result_prefix=str(d / "jax"),
                          num_threads=2, is_pb=True, engine="oracle"))
    argv = ["phase", "--pb", "-s", fx["vcf"], "-b", fx["bam"], "-r",
            fx["fasta"], "--device", "cpu"]
    assert cli.main(argv + ["-o", str(d / "port")]) == 0
    jax_vcf = _body(d / "jax.vcf")
    assert _body(d / "port.vcf") == jax_vcf
    assert sum("|" in line for line in jax_vcf) > 100
    return {"argv": argv, "vcf": jax_vcf, "n_chroms": len(fx["chroms"])}


@pytest.mark.parametrize("nprocs", [2, 4])
def test_phase_processes_match_one_process(fix, tmp_path, nprocs):
    prefix = str(tmp_path / "dist")
    reports = processes.run_cli(fix["argv"] + ["-o", prefix], nprocs, REPO,
                                _env(), TIMEOUT)
    assert _body(prefix + ".vcf") == fix["vcf"]
    assert [r["pid"] for r in reports] == list(range(nprocs))
    assert all(r["nprocs"] == nprocs and r["device"] == "cpu"
               and not r["leaked"] for r in reports)
    # only process 0 writes: no per-process leftovers
    assert sorted(os.listdir(tmp_path)) == ["dist.vcf"]


def test_checkpointed_multichip_processes_resume(fix, tmp_path):
    """2 processes, each batching its shard (LPS_MULTICHIP=1) and writing
    per-contig checkpoints; a second run resumes every contig."""
    argv = fix["argv"] + ["-o", str(tmp_path / "combo"), "--checkpoint",
                          str(tmp_path / "ckpt")]
    env = _env(LPS_MULTICHIP="1")
    first = processes.finish(processes.start(
        processes.CLI_WORKER, processes.dist_args(argv, 2), REPO, env),
        TIMEOUT)
    processes.reports(first)
    assert _body(tmp_path / "combo.vcf") == fix["vcf"]
    assert not any("checkpoint: resumed" in err for _rc, _out, err in first)
    assert len(os.listdir(tmp_path / "ckpt")) == fix["n_chroms"]
    second = processes.finish(processes.start(
        processes.CLI_WORKER, processes.dist_args(argv, 2), REPO, env),
        TIMEOUT)
    processes.reports(second)
    assert all(f"checkpoint: resumed {fix['n_chroms']} contig(s)" in err
               for _rc, _out, err in second)
    assert _body(tmp_path / "combo.vcf") == fix["vcf"]


API_WORKER = """
import json, sys
from longphase_s_tpu_torch.parallel import distributed as dist
dist.init_from_spec(sys.argv[1])
pid = dist.process_id()
blob = {0: b"abc", 1: b"", 2: bytes(range(256)) * 3}[pid]
print(json.dumps({
    "active": dist.is_active(), "writer": dist.is_writer(),
    "shard": dist.shard_contigs([f"chr{i}" for i in range(7)]),
    "bytes": [b.hex() for b in dist.allgather_bytes(blob)],
    "f64": dist.allgather_f64([pid + 0.25] * pid).tolist(),
    "counters": dist.psum_counters({"a": pid, f"only{pid}": 1}),
    "merged": dist.merge_chr_results(
        {f"chr{pid}": {f"chr{pid}_{p}": (f"{p % 2}|{1 - p % 2}", 10 * pid)
                       for p in range(pid + 1)}}),
}))
"""


def test_collectives_in_three_processes():
    spec = f"127.0.0.1:{processes.free_port()},3"
    results = processes.finish(processes.start(
        API_WORKER, [[f"{spec},{pid}"] for pid in range(3)], REPO, _env()),
        TIMEOUT)
    import json

    outs = []
    for rc, out, err in results:
        assert rc == 0, err[-2000:]
        outs.append(json.loads(out.splitlines()[-1]))
    blobs = [b"abc", b"", bytes(range(256)) * 3]
    merged = {f"chr{pid}": {f"chr{pid}_{p}": [f"{p % 2}|{1 - p % 2}", 10 * pid]
                            for p in range(pid + 1)} for pid in range(3)}
    for pid, o in enumerate(outs):
        assert o["active"] and o["writer"] == (pid == 0)
        assert o["shard"] == [f"chr{i}" for i in range(pid, 7, 3)]
        assert [bytes.fromhex(b) for b in o["bytes"]] == blobs
        assert o["f64"] == [1.25, 2.25, 2.25]
        assert o["counters"] == {"a": 3, "only0": 1, "only1": 1, "only2": 1}
        assert o["merged"] == merged


def test_no_group_is_one_process(monkeypatch):
    """Without a group the API answers for one process, and a gather is
    the process's own blob; a malformed spec raises."""
    monkeypatch.setattr(dist, "_initialized", False)
    assert not dist.is_active() and dist.is_writer()
    assert dist.process_id() == 0 and dist.process_count() == 1
    assert dist.shard_contigs(["a", "b"]) == ["a", "b"]
    assert dist.allgather_bytes(b"") == [b""]
    assert dist.merge_chr_results({"c": {"c_1": ("0|1", 7)}}) == \
        {"c": {"c_1": ("0|1", 7)}}
    assert dist.local_device("cuda") == "cuda"
    with pytest.raises(ValueError, match="HOST:PORT"):
        dist.init_from_spec("127.0.0.1:1234,2,2")


@pytest.mark.parametrize("pid,count,device,want", [
    (0, 1, "cuda", "cuda:0"), (3, 1, "cuda", "cuda:0"),
    (3, 2, "cuda", "cuda:1"), (2, 4, "cuda", "cuda:2"),
    (5, 4, "cuda:3", "cuda:3"), (1, 4, "cpu", "cpu"), (1, 0, "cuda", "cuda")])
def test_local_device_under_a_group(monkeypatch, pid, count, device, want):
    monkeypatch.setattr(dist, "is_active", lambda: True)
    monkeypatch.setattr(dist, "process_id", lambda: pid)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert str(dist.local_device(device)) == want
    assert dist.local_device_count() == min(count, 1)


def test_a_process_counts_its_one_card(monkeypatch):
    """With eight cards visible, a process of a group batches and
    wavefronts its contigs on its own card only: the multichip sink and
    the somatic batch stay off and the wavefront has one device."""
    from longphase_s_tpu_torch.models import phase, somatic

    monkeypatch.delenv("LPS_MULTICHIP", raising=False)
    monkeypatch.delenv("LPS_WAVEFRONT", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = phase.PhaseConfig(snp_file="", bam_files=[], fasta_file="")
    card = torch.device("cuda", 1)
    assert phase._make_multichip_sink(cfg) == []
    assert phase._use_wavefront(2, card)
    assert len(phase._wavefront_devices(card)) == 8
    monkeypatch.setattr(dist, "is_active", lambda: True)
    assert phase._make_multichip_sink(cfg) is None
    assert not phase._use_wavefront(2, card)
    assert phase._wavefront_devices(card) == [card]
    assert somatic._mesh_devices("cuda:1") is None


PEER_WORKER = """
import os, sys
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.parallel import distributed as dist
argv = sys.argv[1:]
if argv[-1].endswith(",1"):
    dist.init_from_spec(argv[-1])
    os._exit(0)
sys.exit(cli.main(argv))
"""


def test_a_dead_peer_fails_the_other(fix, tmp_path):
    """Process 1 joins, then exits: process 0's gather raises, it exits
    non-zero long before the group's timeout and writes no VCF."""
    prefix = str(tmp_path / "dist")
    t0 = time.perf_counter()
    results = processes.finish(processes.start(
        PEER_WORKER, processes.dist_args(fix["argv"] + ["-o", prefix], 2),
        REPO, _env(LPS_DIST_TIMEOUT="120")), TIMEOUT)
    wall = time.perf_counter() - t0
    assert results[1][0] == 0
    assert results[0][0] != 0 and "CollectiveError" in results[0][2]
    assert wall < 60, wall
    assert not os.path.exists(prefix + ".vcf")


def test_a_group_that_cannot_form_raises(fix, tmp_path):
    """Process 1 of 2 alone: joining times out and it exits non-zero
    without an output."""
    prefix = str(tmp_path / "alone")
    argv = fix["argv"] + ["-o", prefix]
    results = processes.finish(processes.start(
        processes.CLI_WORKER, processes.dist_args(argv, 2)[1:], REPO,
        _env(LPS_DIST_TIMEOUT="3")), TIMEOUT)
    rc, _out, err = results[0]
    assert rc != 0 and "timed out" in err
    assert not os.path.exists(prefix + ".vcf")
