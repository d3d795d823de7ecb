"""Run the port as N processes of one gloo group on this host.

Each process is a fresh interpreter (``python -c``) started in ``cwd`` (a
checkout's root) that imports only this package. ``run_cli`` drives one
subcommand of ``cli.main`` with ``--dist 127.0.0.1:<free port>,N,<pid>``
and returns each process's report: its exit code, rank, device, kernel
launches (``ops/_build.LAUNCHES``), device reductions
(``ops/tag_kernels.DEVICE_CALLS``), wall seconds and any module of JAX or
of the JAX package it imported.

    reports = run_cli(["phase", "--pb", "-s", vcf, "-b", bam, "-r", fa,
                       "-o", prefix, "--device", "cpu"], 2, cwd=root)
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time

REPORT = "LPS_PROCESS_REPORT "

CLI_WORKER = f"""
import json, sys, time
t0 = time.perf_counter()
from longphase_s_tpu_torch import cli
from longphase_s_tpu_torch.ops import _build, tag_kernels
from longphase_s_tpu_torch.parallel import distributed as dist
argv = sys.argv[1:]
rc = cli.main(argv)
device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
print({REPORT!r} + json.dumps({{
    "rc": rc, "pid": dist.process_id(), "nprocs": dist.process_count(),
    "device": str(dist.local_device(device)),
    "launches": dict(_build.LAUNCHES),
    "device_calls": dict(tag_kernels.DEVICE_CALLS),
    "wall": time.perf_counter() - t0,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "longphase_s_tpu"))}}),
      flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(code: str, args_by_rank, cwd: str, env=None):
    """One ``python -c code *args`` process a rank, all started at once."""
    return [subprocess.Popen([sys.executable, "-c", code, *args],
                             cwd=cwd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for args in args_by_rank]


def finish(procs, timeout: float):
    """``(returncode, stdout, stderr)`` of every process, waiting at most
    ``timeout`` seconds for all of them together. On timeout every process
    still running is killed and TimeoutError raised, stderr tails
    included."""
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tails = [p.communicate()[1][-800:] for p in procs]
        raise TimeoutError(f"processes still running after {timeout} s; "
                           f"stderr tails: {tails}") from None
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def reports(results) -> list[dict]:
    """Each process's report line, or RuntimeError with the stderr tail of
    the first process that failed."""
    out = []
    for rank, (rc, stdout, stderr) in enumerate(results):
        lines = [line for line in stdout.splitlines()
                 if line.startswith(REPORT)]
        if rc != 0 or not lines:
            raise RuntimeError(f"process {rank} exited {rc}; stderr tail: "
                               f"{stderr[-2000:]}")
        out.append(json.loads(lines[-1][len(REPORT):]))
    return out


def dist_args(argv, nprocs: int, port=None):
    """``argv`` with ``--dist 127.0.0.1:<port>,nprocs,<pid>``, a rank each."""
    port = free_port() if port is None else port
    return [list(argv) + ["--dist", f"127.0.0.1:{port},{nprocs},{pid}"]
            for pid in range(nprocs)]


def run_cli(argv, nprocs: int, cwd: str, env=None,
            timeout: float = 300) -> list[dict]:
    """``cli.main(argv)`` as ``nprocs`` processes of one group; the
    reports in rank order."""
    return reports(finish(start(CLI_WORKER, dist_args(argv, nprocs), cwd,
                                env), timeout))
