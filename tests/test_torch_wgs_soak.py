"""The port's chromosome-scale soak (``testing/wgs_soak.py``) and the
simulator it builds its fixtures with, on the CPU at a small size.

- the port's fixture builders write files byte-equal to the JAX package's
  ``testing/simulate`` on the same seeds, and the simulator's vectorised
  base packing and substitution errors equal the per-base loops they
  replaced;
- soak steps 1-6 with ``device="cpu"`` on a 300 kbp cut of ``CFG`` and
  ``SOMATIC_CFG`` pass their own checks and return every row key
  ``chip_smoke.py`` phase 12 prints; the split of the timed ``cli phase``
  sums to at most its wall;
- the soak's phase VCF, haplotag tags and ``_sc.vcf`` equal the JAX
  package's ``run_phase(engine="tpu")``, ``run_haplotag`` and
  ``run_somatic_haplotag`` on the same files.
"""

import os

import numpy as np
import pytest

from longphase_s_tpu import native as jax_native
from longphase_s_tpu.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_tpu.models.phase import PhaseConfig, run_phase
from longphase_s_tpu.models.somatic import (SomaticConfig,
                                            run_somatic_haplotag)
from longphase_s_tpu.testing import simulate as jax_simulate
from longphase_s_tpu_torch.io.bam import SEQ_NT16, BamReader
from longphase_s_tpu_torch.testing import simulate as port_simulate
from longphase_s_tpu_torch.testing import wgs_soak

SOAK_LENGTH = 300_000
# the keys of every run's row (chip_smoke.py phase 12 prints them)
RUN_KEYS = ("wall_s", "peak_rss_gb", "peak_device_mb", "launches",
            "device_calls", "engines", "stream_windows", "warm")

BUILDERS = {
    "make_fixture": dict(seed=5, length=60000, coverage=12, read_len=6001,
                         snp_rate=0.002, indel_rate=0.3, error_rate=0.04,
                         qual=22),
    "make_fixture_realism": dict(seed=6, length=80000, coverage=12,
                                 read_len=7001, snp_rate=0.002, n_svs=6,
                                 n_mods=20, error_rate=0.03, realism=True),
    "make_somatic_fixture": dict(seed=37, length=120000, normal_coverage=12,
                                 tumor_coverage=15, purity=0.6, n_somatic=30,
                                 n_artifacts=10, read_len=6001,
                                 snp_rate=0.0012, error_rate=0.02, qual=25),
    "make_multichrom_fixture": dict(seed=29, n_chroms=3, base_length=40000),
    "make_meth_fixture": dict(seed=3, length=80000, coverage=12, n_asm=20,
                              n_homo_mod=10),
}


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_simulator_files_equal_jax(case, tmp_path):
    builder = case.replace("_realism", "")
    kw = BUILDERS[case]
    getattr(jax_simulate, builder)(str(tmp_path / "jax"), **kw)
    getattr(port_simulate, builder)(str(tmp_path / "port"), **kw)
    jax_files, port_files = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert any(f.endswith(".bam") for f in port_files)
    assert sorted(port_files) == sorted(jax_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    bams = [os.path.join(tmp_path, "port", f) for f in port_files
            if f.endswith(".bam")]
    records = [rec for path in bams for rec in BamReader(path)]
    # odd lengths take the half-filled last byte
    assert any(len(rec.seq()) % 2 for rec in records)
    if case == "make_fixture_realism":   # split and chimeric reads
        assert any(rec.flag & 0x800 for rec in records)
    if case == "make_fixture":           # indels in the CIGARs
        assert any(op in (1, 2) for rec in records
                   for op, _ in rec.cigar_tuples())


def _pack_loop(seq):
    """The per-base packing ``_pack_seq`` replaced."""
    nib = [SEQ_NT16.index(c) for c in seq.upper()]
    if len(nib) % 2:
        nib.append(0)
    return bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))


def test_pack_seq_equals_per_base_loop():
    rng = np.random.default_rng(0)
    alphabet = SEQ_NT16 + SEQ_NT16.lower()
    for n in (0, 1, 2, 7, 64, 1001):
        seq = "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        assert port_simulate._pack_seq(seq) == _pack_loop(seq)
    for bad in ("ACGTX", "AC GT", "ACGé"):
        with pytest.raises(ValueError):
            port_simulate._pack_seq(bad)


def _substitute_loop(rng, seq, error_rate):
    """The per-error loop ``_substitute`` replaced."""
    seq_l = list(seq)
    n_err = rng.binomial(len(seq_l), error_rate)
    for j in rng.integers(0, len(seq_l), size=n_err):
        seq_l[j] = port_simulate._other_base(rng, seq_l[j])
    return "".join(seq_l)


@pytest.mark.parametrize("seed", range(4))
def test_substitute_equals_per_error_loop(seed):
    """Same bases and the same generator state after, repeated positions
    (rewritten from their new base) and a base outside ACGT included."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    src = np.random.default_rng(100 + seed)
    for n, rate in ((0, 0.1), (1, 0.9), (40, 0.5), (3000, 0.04),
                    (500, 0.3)):
        seq = "".join("ACGTN"[i] for i in src.integers(0, 5, n))
        assert port_simulate._substitute(a, seq, rate) == \
            _substitute_loop(b, seq, rate)
    assert a.bit_generator.state == b.bit_generator.state


def test_cut_keeps_somatic_density():
    got = wgs_soak.cut(wgs_soak.SOMATIC_CFG, 3_200_000)
    assert got["length"] == 3_200_000
    assert (got["n_somatic"], got["n_artifacts"]) == (250, 60)
    assert {k: v for k, v in got.items() if k not in (
        "length", "n_somatic", "n_artifacts")} == {
        k: v for k, v in wgs_soak.SOMATIC_CFG.items() if k not in (
            "length", "n_somatic", "n_artifacts")}
    assert wgs_soak.cut(wgs_soak.CFG, None) == wgs_soak.CFG
    assert wgs_soak.cut(wgs_soak.CFG, 1000)["length"] == 1000


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    """Steps 1-5 of the soak on the CPU at 300 kbp, references the oracle
    engine; the streaming haplotag in 1 MiB windows under a 1 MiB
    budget."""
    work = str(tmp_path_factory.mktemp("soak"))
    fix = wgs_soak.get_fixture(work, wgs_soak.cut(wgs_soak.CFG, SOAK_LENGTH))
    sfix = wgs_soak.get_somatic_fixture(
        work, wgs_soak.cut(wgs_soak.SOMATIC_CFG, SOAK_LENGTH))
    rows = wgs_soak.step_phase(fix, work, "cpu", references=("oracle",))
    phase_vcf = os.path.join(work, "phase.vcf")
    rows.update(wgs_soak.step_haplotag(fix, phase_vcf, work, "cpu",
                                       stream_budget=1 << 20,
                                       stream_window=1 << 20))
    rows.update(wgs_soak.step_wavefront(fix, work, phase_vcf, "cpu"))
    rows.update(wgs_soak.step_somatic(sfix, work, "cpu"))
    return {"work": work, "fix": fix, "sfix": sfix, "rows": rows}


def test_soak_rows_hold_what_chip_smoke_prints(soak):
    rows = soak["rows"]
    runs = ("phase", "phase_oracle", "haplotag_whole", "haplotag_stream",
            "haplotag_host", "wavefront", "somatic_phase", "somatic_device",
            "somatic_host", "purity_device", "purity_host")
    for name in runs:
        assert all(k in rows[name] for k in RUN_KEYS), name
        assert rows[name]["leaked"] == [], name
        assert rows[name]["wall_s"] > 0, name
        assert 0 < rows[name]["peak_rss_gb"] < 8, name
    assert set(rows["phase"]["split"]) == set(wgs_soak.SPLIT_KEYS)
    assert rows["phase"]["sites_per_s"] > 0
    assert rows["phase_oracle"]["vcf_equal"]
    for name in ("haplotag_whole", "haplotag_stream", "haplotag_host"):
        assert rows[name]["reads_per_s"] > 0
        assert sum(rows[name]["engines"].values()) >= 1
    assert rows["haplotag_stream"]["stream_windows"] > 1
    assert rows["haplotag_host"]["engines"]["device"] == 0
    assert rows["somatic_device"]["engines"]["host"] == 0
    assert rows["somatic_purity"] > 0 and rows["somatic_pass"] > 0
    # the CPU launches no kernel and measures no device
    assert not any(rows["phase"]["launches"].values())
    assert rows["phase"]["peak_device_mb"] is None
    assert "busy_share" not in rows["phase"]


def test_split_sums_within_the_wall(soak):
    row = soak["rows"]["phase"]
    parts = row["split"]
    assert all(parts[k] >= 0 for k in wgs_soak.SPLIT_KEYS if k != "other_s")
    assert sum(v for k, v in parts.items() if k != "other_s") <= \
        row["wall_s"]
    assert sum(parts.values()) == pytest.approx(row["wall_s"])
    assert parts["ingest_s"] > 0 and parts["step_s"] > 0


def test_soak_outputs_equal_jax(soak, tmp_path):
    fix, sfix, work = soak["fix"], soak["sfix"], soak["work"]
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"],
                          result_prefix=str(tmp_path / "phase"),
                          is_pb=True, engine="tpu"))
    ours = wgs_soak.strip_vcf(os.path.join(work, "phase.vcf"))
    assert sum("|" in line for line in ours) > 100
    assert wgs_soak.strip_vcf(str(tmp_path / "phase.vcf")) == ours
    run_haplotag(HaplotagConfig(snp_file=str(tmp_path / "phase.vcf"),
                                bam_file=fix["bam"], fasta_file=fix["fasta"],
                                result_prefix=str(tmp_path / "tag")))
    assert wgs_soak.tags_digest(str(tmp_path / "tag.bam")) == \
        soak["rows"]["haplotag_tags_sha256"]
    # the JAX package's handle cache closes a held handle on a third open
    jax_native.drain_bam_cache()
    run_somatic_haplotag(SomaticConfig(
        snp_file=os.path.join(work, "som_phased.vcf"),
        tumor_snv_file=sfix["tumor_vcf"], bam_file=sfix["normal_bam"],
        tumor_bam_file=sfix["tumor_bam"], fasta_file=sfix["fasta"],
        result_prefix=str(tmp_path / "somatic"), write_somatic_vcf=True))
    assert wgs_soak.strip_vcf(str(tmp_path / "somatic_sc.vcf")) == \
        wgs_soak.strip_vcf(os.path.join(work, "somatic_device_sc.vcf"))
    assert wgs_soak.tags_digest(str(tmp_path / "somatic.bam")) == \
        soak["rows"]["somatic_tags_sha256"]


def test_phase_mem_streams_to_the_same_vcf(soak):
    work = os.path.join(soak["work"], "phasemem")
    os.makedirs(work)
    rows = wgs_soak.step_phase_mem(soak["fix"], work, "cpu", budget=1 << 20)
    assert rows["phasemem_stream"]["peak_rss_gb"] < 8.0
    assert rows["phasemem_whole"]["wall_s"] > 0
    with pytest.raises(wgs_soak.SoakMismatch, match="budget holds"):
        wgs_soak.step_phase_mem(soak["fix"], work, "cpu", budget=1 << 40)


def test_a_failed_equality_raises(soak, tmp_path):
    """A VCF that differs from step 1's fails the wavefront step."""
    bad = tmp_path / "bad.vcf"
    lines = wgs_soak.strip_vcf(os.path.join(soak["work"], "phase.vcf"))
    bad.write_text("".join(lines[:-1]))
    with pytest.raises(wgs_soak.SoakMismatch, match="wavefront"):
        wgs_soak.step_wavefront(soak["fix"], str(tmp_path), str(bad), "cpu")


def test_a_cuda_request_without_a_card_fails(soak, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        wgs_soak.run_child(wgs_soak.phase_argv(
            soak["fix"], str(tmp_path / "p"), "cuda"), "cuda", warmup=False)
