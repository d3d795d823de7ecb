"""Probe what the pair_cast tile kernel's time is made of, on one NVIDIA GPU.

    python3 tools/pair_cast_probe.py [--out DIR]

Run from the root of a checkout. On ``chip_smoke.py``'s synthetic
chromosome (319,951 sites at 20x) at W = 35 and W = 100 it times the tile
kernel of ``csrc/pair_cast.cu`` (CUDA events, three means of ten calls each
after a warm-up):

1. at every tile height T from 8 to 128, through the port's wrappers
   (``ops/fused.bucket_counts``, ``bucket_order``, ``pair_cast_tiles``),
   its codes checked against ``ops/fused.pair_codes``;
2. at the T the kernel picks, beside copies of the source built into
   ``DIR`` with one part changed: ``no_walk`` (one add a source instead of
   the walk over its W successors), ``no_cast`` (no epilogue: the sums
   are never cast, the outputs never written), ``plain_add`` (racy plain
   shared-memory adds in place of ``atomicAdd``) and ``stop_early`` (the
   walk stops at the first row of another read or past the window, which
   gives the same codes only on a stream grouped by read with ranks
   sorted inside a read, as this one is). The first three give wrong
   outputs by design.

Prints one JSON line per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK = "    for (long long j = i + 1; j <= last; ++j) {\n"
ATOMIC = ("      atomicAdd(sh_sums + row + d + (m_allele[j] == allele ? 0 : tw),"
          " add);\n")
TEST = ("      if (m_read[j] != read) continue;\n"
        "      const int d = m_rank[j] - rank;\n"
        "      if (d < 1 || d > w) continue;\n")
CAST = "  for (int t = threadIdx.x >> 5; t < rows; t += kWarps) {\n"
# (anchor in csrc/pair_cast.cu, its replacement): each change is compiled
# in only under its PROBE_* macro
PATCHES = (
    (WALK, "#ifdef PROBE_NO_WALK\n"
           "    atomicAdd(sh_sums + row + 1, read + allele + qok);\n"
           "    continue;\n#endif\n" + WALK),
    (ATOMIC, "#ifdef PROBE_PLAIN_ADD\n"
             "      sh_sums[row + d + (m_allele[j] == allele ? 0 : tw)] += add;"
             "\n#else\n" + ATOMIC + "#endif\n"),
    (TEST, "#ifdef PROBE_STOP_EARLY\n"
           "      if (m_read[j] != read) break;\n"
           "      const int d = m_rank[j] - rank;\n"
           "      if (d > w) break;\n"
           "      if (d < 1) continue;\n#else\n" + TEST + "#endif\n"),
    (CAST, "#ifdef PROBE_NO_CAST\n"
           "  for (int t = threadIdx.x >> 5; t < 0; t += kWarps) {\n"
           "#else\n" + CAST + "#endif\n"),
)
PROBES = ("no_walk", "no_cast", "plain_add", "stop_early")


def build_probes(out: str) -> dict:
    """One library a probe, built in parallel from a patched copy of the
    source; ``{probe: ctypes library}``."""
    from longphase_s_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "pair_cast.cu")) as f:
        text = f.read()
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"csrc/pair_cast.cu changed: {anchor!r}")
        text = text.replace(anchor, replacement)
    source = os.path.join(out, "pair_cast_probe.cu")
    with open(source, "w") as f:
        f.write(text)
    jobs = {}
    for probe in PROBES:
        lib = os.path.join(out, f"libpair_cast_{probe}.so")
        jobs[probe] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             f"-DPROBE_{probe.upper()}", "-o", lib, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for probe, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {probe}:\n{log}")
        cdll = ctypes.CDLL(lib)
        cdll.lps_pair_cast.argtypes = _build._SIGNATURES["lps_pair_cast"]
        cdll.lps_pair_cast.restype = ctypes.c_int
        libs[probe] = cdll
    return libs


def cuda_ms(fn, reps=10, rounds=3):
    import torch

    fn()
    means = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return means


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, ".scratch",
                                                  "pair_cast_probe"),
                    help="where the patched source and its libraries go")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from longphase_s_tpu_torch.core.phase_algo import (T_DANGER, T_INDEL,
                                                       T_MOD, T_SNP)
    from longphase_s_tpu_torch.ops import cuda_scan, fused
    from longphase_s_tpu_torch.ops.vote_scan import site_gaps

    libs = build_probes(args.out)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(chip_smoke.SEED)
    S = 319_951
    read, rank, allele, qok, _n = chip_smoke.synthetic_stream(
        rng, S, coverage=20, sites_per_read=60)
    positions, vtype = chip_smoke.synthetic_sites(rng, S)
    stream = fused.stream_to_device(read, rank, allele, qok, dev)
    gap = torch.from_numpy(site_gaps(positions)).to(dev)
    vt = torch.from_numpy(vtype).to(dev)
    kw = dict(distance=300000, edge_threshold_x10=7.0)
    n = len(read)
    for window in (35, 100):
        ref = fused.pair_codes(stream, gap, vt, S, window, **kw)
        picked = fused.pair_tile_rows(S, window, dev)
        for T in (8, 16, 32, 64, 128):
            count = fused.bucket_counts(stream[0], stream[1], S, T)
            order, ends = fused.bucket_order(stream[0], stream[1], S, T,
                                             count)

            def tiles():
                return fused.pair_cast_tiles(stream, order, ends, gap, vt, S,
                                             window, T, **kw)
            got = tiles()
            print(json.dumps({
                "W": window, "T": T, "picked": T == picked,
                "kernel": "pair_cast", "ms": cuda_ms(tiles),
                "equal": all(torch.equal(a, b) for a, b in zip(got, ref))}),
                flush=True)
        w, Wp = cuda_scan.cut_window(S, window), cuda_scan.code_width(S, window)
        T = picked
        count = fused.bucket_counts(stream[0], stream[1], S, T)
        order, ends = fused.bucket_order(stream[0], stream[1], S, T, count)
        codes = torch.empty(S, Wp, dtype=torch.uint8, device=dev)
        site = torch.empty(S, dtype=torch.int32, device=dev)
        for probe, lib in libs.items():
            def run():
                err = lib.lps_pair_cast(
                    stream[0].data_ptr(), stream[1].data_ptr(),
                    stream[2].data_ptr(), stream[3].data_ptr(), n,
                    order.data_ptr(), ends.data_ptr(), gap.data_ptr(),
                    vt.data_ptr(), S, window, w, Wp, T, kw["distance"],
                    kw["edge_threshold_x10"], T_SNP, T_MOD, T_INDEL, T_DANGER,
                    codes.data_ptr(), site.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{probe}: cudaError {err}")
            ms = cuda_ms(run)
            print(json.dumps({
                "W": window, "T": T, "kernel": probe, "ms": ms,
                "equal": torch.equal(codes, ref[0])
                and torch.equal(site, ref[1])}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
