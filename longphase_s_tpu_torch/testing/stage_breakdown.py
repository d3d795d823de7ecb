"""Per-pipeline stage split of the port at the bench's fixtures.

Counterpart of ``tools/stage_breakdown.py`` (the JAX package's split),
with its ``STAGE_RE`` and ``capture`` letter for letter: each of the five
pipelines runs once as a warm-up and once more with the stage timers'
stderr lines (``utils/timers.StageTimer``, the reference's format)
captured and parsed, a bare loop total as ``(loop body)``. The pipelines
and fixtures are ``testing/bench.py``'s (``bench.pipeline``): ours, on
``--device``, as the engine gate chooses.

    python -m longphase_s_tpu_torch.testing.stage_breakdown [workdir]
        [--length-scale X] [--only phase,modcall,...] [--device cuda|cpu]
        [--out rows.json]

One JSON row a pipeline: its stages with their seconds (the timers print
tenths), their total, and beside them what the port counts of the
captured run: the kernel launches (``ops/_build.LAUNCHES``), the
reductions on a card (``ops/tag_kernels.DEVICE_CALLS``) and the engine
gate's choices. No file is written but ``--out``. ``bench.py --stages``
calls ``breakdown``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys

from . import bench
from .fuzz_parity import environ
from .wgs_soak import Counts

MODULE = "longphase_s_tpu_torch.testing.stage_breakdown"
# tools/stage_breakdown.py's five pipelines (bench.py's but the CRAM run)
PIPELINES = ("phase", "haplotag", "somatic_haplotag", "estimate_purity",
             "modcall")

STAGE_RE = re.compile(r"^(.*\S)\s*\.\.\.\s*([0-9.]+)s\s*$")


def capture(fn):
    fn()  # warm-up
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        fn()
    stages = []
    for line in buf.getvalue().splitlines():
        m = STAGE_RE.match(line.strip())
        if m:
            stages.append((m.group(1), float(m.group(2))))
        elif line.strip().endswith("s") and line.strip()[:-1].replace(
                ".", "").isdigit():
            # bare per-loop total (e.g. the phasing chromosomes line)
            stages.append(("(loop body)", float(line.strip()[:-1])))
    return stages


def _label(b: bench.Bench, name: str) -> str:
    mbp = {"phase": b.cfg(bench.PHASE_CFG), "haplotag":
           b.cfg(bench.PHASE_CFG), "modcall": b.cfg(bench.METH_CFG)}.get(
               name, b.cfg(bench.SOMATIC_CFG))["length"] / 1e6
    return f"{name} ({mbp:g} Mbp, ours on {b.device})"


def breakdown(b: bench.Bench, only=PIPELINES) -> list[dict]:
    """The split of every pipeline of ``only`` in ``PIPELINES`` (the CRAM
    run has none of its own) on ``b``'s fixtures; one row each."""
    from ..utils.device import resolve_device

    resolve_device(b.device)
    rows = []
    for name in PIPELINES:
        if name not in only:
            continue
        p = bench.pipeline(b, name)
        prefix = b.path(f"stages_{name}")
        counts = []

        def run():
            counts.append(Counts())
            with environ(LPS_TAG_ENGINE=None), counts[-1]:
                p.run(prefix, False)
        stages = capture(run)
        rows.append({"pipeline": name, "label": _label(b, name),
                     "bam_cache": p.bam_cache,
                     "stages": [list(s) for s in stages],
                     "total_s": sum(s for _, s in stages),
                     **counts[-1].row(nonzero=True)})
    return rows


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m " + MODULE,
                                description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?", default=bench.BENCH_DIR)
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--only", default=",".join(PIPELINES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    b = bench.Bench(args.workdir, args.device, args.length_scale)
    rows = breakdown(b, tuple(args.only.split(",")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
