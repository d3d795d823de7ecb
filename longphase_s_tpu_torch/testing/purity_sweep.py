"""Tumour-purity sweep of the port (BASELINE config 5): ``estimate_purity``
and ``somatic_haplotag`` on simulated tumour/normal mixtures at 10-100%
purity, on the card.

Counterpart of ``tools/purity_sweep.py`` (the JAX package's sweep), with
its ``SWEEP`` and ``CFG`` letter for letter: 1 Mbp, 50x tumour over 25x
normal, 80 somatic SNVs and 20 artifact sites, a point at each purity
0.1, 0.2, ..., 1.0 simulated from seed ``int(purity * 10) + 100`` by
``testing/simulate.make_somatic_fixture``. Fixtures are cached under the
work directory by ``fixture_p*.json`` markers (``wgs_soak._cached``).

    python -m longphase_s_tpu_torch.testing.purity_sweep [workdir]
        [--length N] [--purities 0.1,0.6] [--device cuda|cpu] [--gate]
        [--compare-cpu] [--jobs N] [--out rows.json]

``--length`` cuts ``CFG`` through ``wgs_soak.cut`` (the somatic and
artifact counts scale with it); ``--jobs`` simulates that many fixtures
at once before the first point runs. At each point:

1. ``cli phase --pb`` phases the normal sample on ``--device`` (on a card
   the flat path's four kernels launch and ``vote_cast`` does not);
2. ``cli estimate_purity`` (the CLI's defaults, ``-q 20
   --tagSupplementary``) and ``cli somatic_haplotag --output-somatic-vcf``
   run with ``LPS_TAG_ENGINE=device``, then ``=host``, and with
   ``--gate`` once more with the variable unset (the engine gate's own
   choice);
3. every engine's outputs must equal the device engine's: ``_sc.vcf``
   without ``##longphase`` and ``##commandline``, the tags (qname, flag,
   pos, HP, PS, PQ), each ``_purity.out`` or its absence (the estimator's
   model fails at low purity: the purity is then 0.0 and no file is
   written), the estimate and the purity the filters were set with. On a
   card the device engine must call its reductions there and the host
   engine none;
4. at ``CFG``'s full length the estimate, printed ``%.6f``, must equal the
   reference binary's in ``PURITY_SWEEP.md`` (read, never written);
5. with ``--compare-cpu`` the point runs again on ``--device cpu`` (the
   phase VCF and the device engine's outputs equal the card's); where
   ``.refbuild/longphase-s`` exists its ``estimate_purity`` and
   ``somatic_haplotag`` must agree too.

Each run is a fresh interpreter (``wgs_soak.run_child`` with this
module's ``--child``, which also records every value
``PurityEstimator.estimate`` returned and every purity
``FilterParams.set_with_purity`` was given), with a warm-up run first
(``run_points`` can leave it out and run several points at once). A row
a point: the true purity, the estimate (full and ``%.6f``),
``_purity.out`` and its text, the filter purity and its tier, the PASS
count of ``_sc.vcf``, the tags' sha256, and each run's wall, peak RSS,
the engine gate's choices, the device calls and the launches, written to
``--out`` after each point. Any failed equality raises
``wgs_soak.SoakMismatch``; ``--device cuda`` without a card fails. The
rows go to JSON only. ``chip_smoke.py`` phase 13 calls ``run_points``.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

from . import wgs_soak
from .wgs_soak import check, strip_vcf, tags_digest, text_lines

ROOT = wgs_soak.ROOT
MODULE = "longphase_s_tpu_torch.testing.purity_sweep"
REFERENCE_TABLE = os.path.join(ROOT, "PURITY_SWEEP.md")

SWEEP = [round(0.1 * i, 1) for i in range(1, 11)]
CFG = dict(length=1_000_000, normal_coverage=25, tumor_coverage=50,
           n_somatic=80, n_artifacts=20, read_len=12000,
           snp_rate=0.0012, error_rate=0.02, qual=25)

# core/somatic_caller.FilterParams.set_with_purity's five filter tiers,
# highest first: (label, lowest purity, highest, the highest included)
TIERS = (("0.9-1.0", 0.9, 1.0, True), ("0.7-0.9", 0.7, 0.9, False),
         ("0.5-0.7", 0.5, 0.7, False), ("0.3-0.5", 0.3, 0.5, False))
LOW_TIER = "under 0.3"
ENGINES = ("device", "host")
# the report keys a row keeps of each run
RUN_KEYS = ("wall_s", "peak_rss_gb", "peak_device_mb", "engines")


def tier(purity: float) -> str:
    """The filter tier ``set_with_purity`` picks for ``purity``."""
    for label, low, high, closed in TIERS:
        if low <= purity and (purity <= high if closed else purity < high):
            return label
    return LOW_TIER


def point_cfg(purity: float, length: int | None = None) -> dict:
    """The simulator's arguments at one point: ``CFG`` cut to ``length``,
    the JAX tool's seed, the purity."""
    return dict(wgs_soak.cut(CFG, length), seed=int(purity * 10) + 100,
                purity=purity)


def get_point_fixture(work: str, purity: float,
                      length: int | None = None) -> dict:
    """The tumour/normal pair of one point, cached under ``work``."""
    cfg = point_cfg(purity, length)

    def build():
        from .simulate import make_somatic_fixture

        fix = make_somatic_fixture(
            os.path.join(work, f"p{purity:0.1f}"), **cfg)
        return {k: fix[k] for k in ("normal_bam", "tumor_bam", "normal_vcf",
                                    "tumor_vcf", "fasta", "chrom")}
    return wgs_soak._cached(work, f"fixture_p{purity:0.1f}.json", cfg, build)


def build_fixtures(work: str, purities, length: int | None = None,
                   jobs: int = 1) -> dict:
    """Every point's fixture, ``jobs`` simulated at once in spawned
    worker processes; purity -> fixture."""
    if jobs <= 1:
        return {p: get_point_fixture(work, p, length) for p in purities}
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    build = importlib.import_module(MODULE).get_point_fixture
    with ProcessPoolExecutor(max_workers=jobs, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        pending = {p: pool.submit(build, work, p, length) for p in purities}
        return {p: f.result() for p, f in pending.items()}


def reference_estimates(path: str = REFERENCE_TABLE) -> dict:
    """The "reference estimate" column of ``PURITY_SWEEP.md``: true
    purity -> the estimate as written (``%.6f``)."""
    out = {}
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            try:
                out[round(float(cells[0]), 1)] = f"{float(cells[1]):.6f}"
            except (ValueError, IndexError):
                continue
    return out


def check_reference(row: dict, path: str = REFERENCE_TABLE) -> str:
    """A row's estimate (``%.6f``) against the reference column at its
    purity; that reference, or ``SoakMismatch``."""
    reference = reference_estimates(path).get(round(row["purity"], 1))
    check(reference == row["estimate_6"],
          f"purity {row['purity']:0.1f}: estimate {row['estimate_6']} "
          f"against {reference} in {os.path.basename(path)}")
    return reference


# ---------------------------------------------------------------------------
# the child interpreter
# ---------------------------------------------------------------------------


def child_main(spec: dict) -> dict:
    """``wgs_soak.child_main`` with ``PurityEstimator.estimate`` and
    ``FilterParams.set_with_purity`` recorded; the report adds the last
    ``estimate`` and ``filter_purity`` (None where none was made)."""
    from ..core.purity import PurityEstimator
    from ..core.somatic_caller import FilterParams

    seen = {"estimate": [], "filter_purity": []}
    estimate, set_with_purity = (PurityEstimator.estimate,
                                 FilterParams.set_with_purity)

    def recorded_estimate(self):
        value = estimate(self)
        seen["estimate"].append(value)
        return value

    def recorded_set_with_purity(self, purity):
        seen["filter_purity"].append(purity)
        return set_with_purity(self, purity)

    PurityEstimator.estimate = recorded_estimate
    FilterParams.set_with_purity = recorded_set_with_purity
    report = wgs_soak.child_main(spec)
    for key, values in seen.items():
        report[key] = values[-1] if values else None
    return report


def run_child(argv, device: str, env: dict | None = None,
              warmup: bool = True) -> dict:
    """``cli`` ``argv`` in a fresh interpreter (``child_main``)."""
    return wgs_soak.run_child(argv, device, env=env, warmup=warmup,
                              module=MODULE)


# ---------------------------------------------------------------------------
# a point
# ---------------------------------------------------------------------------


def maybe_lines(path: str):
    """``text_lines(path)``, or None where the file does not exist."""
    return text_lines(path) if os.path.exists(path) else None


def outputs(somatic_prefix: str, purity_prefix: str, somatic: dict,
            purity: dict) -> dict:
    """What a pair of runs (``somatic_haplotag``, ``estimate_purity``) must
    agree on with another pair, from their prefixes and reports."""
    return {"sc": strip_vcf(somatic_prefix + "_sc.vcf"),
            "tags": tags_digest(somatic_prefix + ".bam"),
            "somatic_purity_out": maybe_lines(somatic_prefix + "_purity.out"),
            "purity_out": maybe_lines(purity_prefix + "_purity.out"),
            "filter_purity": somatic["filter_purity"],
            "estimate": purity["estimate"]}


def check_same(got: dict, want: dict, label: str) -> None:
    """``got`` equals ``want`` key for key, or ``SoakMismatch`` names the
    keys that differ."""
    differ = sorted(k for k in want if got.get(k) != want[k])
    check(not differ, f"{label}: {', '.join(differ)} differ")


def _run_row(report: dict) -> dict:
    row = {k: report[k] for k in RUN_KEYS}
    for key in ("device_calls", "launches"):
        row[key] = {k: v for k, v in report[key].items() if v}
    return row


def _engine_runs(pair, prefix: str, device: str, engine: str,
                 warmup: bool):
    """``somatic_haplotag`` and ``estimate_purity`` with ``engine``
    (``"gate"``: ``LPS_TAG_ENGINE`` unset); their reports and outputs."""
    env = {"LPS_TAG_ENGINE": None if engine == "gate" else engine}
    som, est = f"{prefix}somatic_{engine}", f"{prefix}purity_{engine}"
    somatic = run_child(["somatic_haplotag", *pair, "--output-somatic-vcf",
                         "-o", som, "--device", device], device, env=env,
                        warmup=warmup)
    purity = run_child(["estimate_purity", *pair, "-o", est, "--device",
                        device], device, env=env, warmup=warmup)
    return somatic, purity, outputs(som, est, somatic, purity)


def _check_device_calls(runs: dict, engine: str, cuda: bool) -> None:
    for mode, want in (("somatic", ("somatic_normal", "somatic_extract",
                                    "somatic_haplotag")),
                       ("purity", ("somatic_normal", "somatic_extract"))):
        report = runs[f"{mode}_{engine}"]
        calls, engines = report["device_calls"], report["engines"]
        if engine == "host":
            check(not any(calls.values()) and engines["device"] == 0,
                  f"{mode}: the host engine ran on the device: {calls}")
        elif engine == "device":
            check(engines["host"] == 0 and (
                not cuda or all(calls[k] > 0 for k in want)),
                f"{mode}: the device engine did not run {want} on the "
                f"card: {calls}, walks {engines}")


def _phase(fix: dict, prefix: str, device: str) -> dict:
    report = run_child(["phase", "--pb", "-s", fix["normal_vcf"], "-b",
                        fix["normal_bam"], "-r", fix["fasta"], "-o", prefix,
                        "--device", device], device, warmup=False)
    wgs_soak._check_flat_path(report, device, "cli phase of the normal")
    return report


def _reference_binary(pair, work: str, want: dict) -> dict:
    """The reference binary's ``estimate_purity`` and ``somatic_haplotag
    --output-somatic-vcf`` on the same files: ``_purity.out`` (or its
    absence), ``_sc.vcf`` and the tags equal ``want``'s."""
    est, som = os.path.join(work, "binary_purity"), os.path.join(
        work, "binary_somatic")
    walls = {"purity": wgs_soak.run_reference_binary(
        ["estimate_purity", *pair, "-o", est])}
    walls["somatic"] = wgs_soak.run_reference_binary(
        ["somatic_haplotag", *pair, "--output-somatic-vcf", "-o", som])
    got = {"purity_out": maybe_lines(est + "_purity.out"),
           "sc": strip_vcf(som + "_sc.vcf"),
           "tags": tags_digest(som + ".bam")}
    check_same(got, {k: want[k] for k in got}, "the reference binary")
    return walls


def run_point(purity: float, work: str, device: str = "cuda",
              length: int | None = None, gate: bool = False,
              compare_cpu: bool = False, warmup: bool = True,
              fix: dict | None = None) -> dict:
    """One point of the sweep (see the module docstring) in
    ``work/p<purity>_<device type>/``; its row. ``fix`` is the point's
    fixture where it is built already."""
    fix = fix or get_point_fixture(work, purity, length)
    cfg = point_cfg(purity, length)
    cuda = device.startswith("cuda")
    out = os.path.join(work, f"p{purity:0.1f}_{device.split(':')[0]}")
    os.makedirs(out, exist_ok=True)
    label = f"purity {purity:0.1f}"
    runs = {"phase": _phase(fix, os.path.join(out, "phased"), device)}
    phased = os.path.join(out, "phased.vcf")
    pair = ["-s", phased, "--tumor-snv-file", fix["tumor_vcf"], "-b",
            fix["normal_bam"], "--tumor-bam-file", fix["tumor_bam"], "-r",
            fix["fasta"]]
    got = {}
    for engine in ENGINES + (("gate",) if gate else ()):
        (runs[f"somatic_{engine}"], runs[f"purity_{engine}"],
         got[engine]) = _engine_runs(pair, out + os.sep, device, engine,
                                     warmup)
        _check_device_calls(runs, engine, cuda)
        check_same(got[engine], got["device"],
                   f"{label}: the {engine} engine against the device's")
    want = got["device"]
    if compare_cpu and cuda:
        cpu = os.path.join(work, f"p{purity:0.1f}_cpu")
        os.makedirs(cpu, exist_ok=True)
        runs["phase_cpu"] = _phase(fix, os.path.join(cpu, "phased"), "cpu")
        check(strip_vcf(os.path.join(cpu, "phased.vcf")) ==
              strip_vcf(phased), f"{label}: the cpu's phase VCF differs")
        (runs["somatic_cpu"], runs["purity_cpu"], got["cpu"]) = _engine_runs(
            pair, cpu + os.sep, "cpu", "device", warmup)
        check_same(got["cpu"], want, f"{label}: --device cpu against cuda")
    sc = want["sc"]
    row = {"purity": purity, "length": cfg["length"], "seed": cfg["seed"],
           "device": device, "estimate": want["estimate"],
           "estimate_6": f"{want['estimate']:.6f}",
           "purity_out": want["purity_out"] is not None,
           "purity_out_text": (None if want["purity_out"] is None
                               else "".join(want["purity_out"])),
           "filter_purity": want["filter_purity"],
           "tier": tier(want["filter_purity"]),
           "sc_pass": sum(line.split("\t")[6] == "PASS" for line in sc
                          if not line.startswith("#")),
           "tags_sha256": want["tags"],
           "simulate_s": fix.get("simulate_s"),
           "engines_compared": sorted(got),
           "runs": {name: _run_row(r) for name, r in runs.items()}}
    if cfg["length"] == CFG["length"]:
        row["reference_estimate"] = check_reference(row)
    if os.path.exists(wgs_soak.REF_BIN):
        row["binary_s"] = _reference_binary(pair, out, want)
    return row


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------


def run_points(work: str, fixtures: dict, device: str = "cuda",
               length: int | None = None, gate: bool = False,
               compare_cpu: bool = False, warmup: bool = True,
               workers: int = 1, done=None) -> list[dict]:
    """``run_point`` at every purity of ``fixtures`` (purity -> fixture),
    ``workers`` points at once (each a chain of child interpreters, so
    their walls then share the host and the card); ``done(row)`` after
    each point. The rows in purity order."""
    def one(purity):
        row = run_point(purity, work, device, length, gate, compare_cpu,
                        warmup, fixtures[purity])
        if done is not None:
            done(row)
        return row
    if workers <= 1:
        return [one(p) for p in sorted(fixtures)]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(one, sorted(fixtures)))


def sweep(work: str, purities=SWEEP, device: str = "cuda",
          length: int | None = None, gate: bool = False,
          compare_cpu: bool = False, jobs: int = 1,
          out: str | None = None) -> list[dict]:
    """The tool's run (see the module docstring); a row a point, the rows
    so far written to ``out`` as JSON after each point where given."""
    from ..utils.device import resolve_device

    resolve_device(device)
    os.makedirs(work, exist_ok=True)
    rows = []

    def done(row):
        rows.append(row)
        if out:
            with open(out, "w") as f:
                json.dump(rows, f, indent=2)
        wgs_soak._say(f"purity {row['purity']:0.1f}", {
            k: row[k] for k in ("estimate", "purity_out", "filter_purity",
                                "tier", "sc_pass")})
    run_points(work, build_fixtures(work, purities, length, jobs), device,
               length, gate, compare_cpu, done=done)
    wgs_soak._say("tiers", sorted({row["tier"] for row in rows}))
    return rows


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m " + MODULE,
                                description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(ROOT, ".bench_cache",
                                        "purity_sweep_torch"))
    p.add_argument("--length", type=int, default=None)
    p.add_argument("--purities", default=",".join(map(str, SWEEP)),
                   help="a comma list (default: SWEEP)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--gate", action="store_true",
                   help="also run with the engine gate's own choice")
    p.add_argument("--compare-cpu", action="store_true")
    p.add_argument("--jobs", type=int, default=1,
                   help="fixtures simulated at once")
    p.add_argument("--out", default=None,
                   help="where the rows go as JSON (default: "
                        "WORKDIR/purity_sweep.json)")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child is not None:
        print(wgs_soak.REPORT + json.dumps(child_main(json.loads(
            args.child))), flush=True)
        return 0
    purities = [round(float(x), 1) for x in args.purities.split(",")]
    rows = sweep(args.workdir, purities, args.device, args.length, args.gate,
                 args.compare_cpu, args.jobs,
                 args.out or os.path.join(args.workdir, "purity_sweep.json"))
    print(json.dumps({"purity_sweep": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
