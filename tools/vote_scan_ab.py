"""Time the port's vote scan, or its pair stage, of two checkouts on the
same inputs, in turns, on one NVIDIA GPU.

    python3 tools/vote_scan_ab.py OTHER_ROOT [--out DIR] [--pair-stage]

Run from the root of a checkout. It writes the inputs once, from this
checkout, then times each checkout in a fresh process, in the order other,
this, this, other (CUDA events, three means of ten calls each after a
warm-up), checks that the two give equal outputs, and prints one JSON line
per run, then the card's name and power limit.

The vote scan (default): the inputs are the x10 pair sums of
``chip_smoke.py``'s synthetic chromosome (319,951 sites at 20x) at W = 35
and W = 100 (``ops/fused.pair_sums_plain`` on the card) and random sums
over 16,384 sites at W = 200; it times ``ops/cuda_scan.vote_scan_pc``, and
``vote_codes`` and ``vote_serial`` alone where a checkout has them.

The pair stage (``--pair-stage``): the inputs are the merged streams of
that chromosome and of one of 16,384 sites at 20x, with their gaps and
variant types. It times what turns a stream into the serial pass's codes at
W = 35 and W = 100: ``ops/fused.pair_codes`` where a checkout has it (the
``pair_cast`` kernels), else ``pair_sums`` followed by
``cuda_scan.vote_codes`` (the ``pair_pack`` and ``vote_cast`` kernels), and
in such a checkout ``pair_sums`` alone at both sizes, per observation. Each
run also gives the peak device memory of the pair stage and of one
``ops/fused.run_fused_phase`` step at W = 35.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("chromosome_w35", 35), ("chromosome_w100", 100), ("random_w200", 200))
PAIR_CASES = (("chromosome", 319_951), ("l2", 16_384))


def make_inputs(out: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from longphase_s_tpu_torch.ops import fused
    from longphase_s_tpu_torch.ops.vote_scan import site_gaps

    rng = np.random.default_rng(chip_smoke.SEED)
    S = 319_951
    read, rank, allele, qok, _n = chip_smoke.synthetic_stream(
        rng, S, coverage=20, sites_per_read=60)
    positions, vtype = chip_smoke.synthetic_sites(rng, S)
    dev = torch.device("cuda", 0)
    stream = fused.stream_to_device(read, rank, allele, qok, dev)
    for name, window in CASES[:2]:
        para, cross = (x.cpu().numpy() for x in
                       fused.pair_sums_plain(*stream, S, window))
        np.savez(os.path.join(out, f"{name}.npz"), s_para10=para,
                 s_cross10=cross, gap=site_gaps(positions), vtype=vtype)
    para, cross, gap, vt = chip_smoke.scan_inputs(rng, 16384, "cpu", 200)
    np.savez(os.path.join(out, "random_w200.npz"), s_para10=para.numpy(),
             s_cross10=cross.numpy(), gap=gap.numpy(), vtype=vt.numpy())


def make_pair_inputs(out: str) -> None:
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke

    rng = np.random.default_rng(chip_smoke.SEED)
    for name, S in PAIR_CASES:
        read, rank, allele, qok, n_reads = chip_smoke.synthetic_stream(
            rng, S, coverage=20, sites_per_read=60)
        positions, vtype = chip_smoke.synthetic_sites(rng, S)
        np.savez(os.path.join(out, f"pair_{name}.npz"), read=read, rank=rank,
                 allele=allele, qok=qok, positions=positions, vtype=vtype,
                 n_reads=n_reads)


def cuda_ms(fn, reps=10, rounds=3):
    """Three means of ``reps`` calls each, CUDA events, after a warm-up."""
    import torch

    fn()
    best = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best.append(start.elapsed_time(end) / reps)
    return best


def peak_mb(fn) -> float:
    """Device memory ``fn()`` takes at its peak above what it found, MB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def digest(tensors) -> str:
    import hashlib

    import torch

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.to(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()


def time_pair_checkout(out: str) -> dict:
    """Runs in a process whose path starts with the checkout under test."""
    import numpy as np
    import torch

    from longphase_s_tpu_torch.core.phase_algo import PhaseParams
    from longphase_s_tpu_torch.ops import cuda_scan, fused
    from longphase_s_tpu_torch.ops.vote_scan import site_gaps

    dev = torch.device("cuda", 0)
    params = PhaseParams()
    kw = dict(distance=params.distance,
              edge_threshold_x10=params.edge_threshold * 10.0)
    fused_cast = hasattr(fused, "pair_codes")
    result = {"route": "pair_cast" if fused_cast else "pair_pack+vote_cast"}
    for name, S in PAIR_CASES:
        z = np.load(os.path.join(out, f"pair_{name}.npz"))
        stream = fused.stream_to_device(z["read"], z["rank"], z["allele"],
                                        z["qok"], dev)
        gap = torch.from_numpy(site_gaps(z["positions"])).to(dev)
        vt = torch.from_numpy(z["vtype"]).to(dev)
        n = len(z["read"])
        for window in (35, 100):
            if fused_cast:
                def stage():
                    return fused.pair_codes(stream, gap, vt, S, window, **kw)
            else:
                def stage():
                    return cuda_scan.vote_codes(
                        *fused.pair_sums(*stream, S, window), gap, vt, S=S,
                        window=window, **kw)
            row = {"S": S, "W": window, "observations": n,
                   "stage_ms": cuda_ms(stage),
                   "stage_peak_mb": peak_mb(stage),
                   "outputs_sha256": digest(stage())}
            if not fused_cast:
                pack = cuda_ms(lambda: fused.pair_sums(*stream, S, window))
                row["pair_pack_ms"] = pack
                row["pair_pack_ns_per_obs"] = [1e6 * t / n for t in pack]
            result[f"{name}_w{window}"] = row
        if name == "chromosome":
            args = (z["read"], z["rank"], z["allele"], z["qok"],
                    z["read"].copy(), z["positions"], z["vtype"],
                    int(z["n_reads"]), params)
            fused.run_fused_phase(*args, device=dev)
            result["step_peak_mb"] = peak_mb(
                lambda: fused.run_fused_phase(*args, device=dev))
    return result


def time_checkout(out: str) -> dict:
    """Runs in a process whose path starts with the checkout under test."""
    import numpy as np
    import torch

    from longphase_s_tpu_torch.ops import cuda_scan

    dev = torch.device("cuda", 0)
    result = {}
    for name, window in CASES:
        z = np.load(os.path.join(out, f"{name}.npz"))
        args = [torch.from_numpy(np.ascontiguousarray(z[k])).to(dev)
                for k in ("s_para10", "s_cross10", "gap", "vtype")]
        S = args[0].shape[0]
        kw = dict(S=S, window=window, distance=300000,
                  edge_threshold_x10=7.0)
        row = {"S": S, "W": window,
               "both_ms": cuda_ms(lambda: cuda_scan.vote_scan_pc(*args, **kw))}
        # a checkout from before the split (one kernel) times as a whole only
        if hasattr(cuda_scan, "vote_codes"):
            codes, site = cuda_scan.vote_codes(*args, **kw)
            row["vote_cast_ms"] = cuda_ms(
                lambda: cuda_scan.vote_codes(*args, **kw))
            row["vote_scan_ms"] = cuda_ms(
                lambda: cuda_scan.vote_serial(codes, site, S, window))
        row["outputs_sha256"] = digest(cuda_scan.vote_scan_pc(*args, **kw))
        result[name] = row
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--out", default=os.path.join(ROOT, ".scratch",
                                                  "vote_scan_ab"),
                    help="where the inputs go (about 200 MB)")
    ap.add_argument("--pair-stage", action="store_true",
                    help="time the pair stage instead of the vote scan")
    ap.add_argument("--time-only", action="store_true",
                    help="time the checkout on the python path on the inputs "
                         "already in --out and print one JSON line (what the "
                         "tool runs in each child process)")
    args = ap.parse_args()
    timer = time_pair_checkout if args.pair_stage else time_checkout
    if args.time_only:
        print(json.dumps(timer(args.out)), flush=True)
        return 0
    os.makedirs(args.out, exist_ok=True)
    (make_pair_inputs if args.pair_stage else make_inputs)(args.out)
    roots = {"other": os.path.abspath(args.other_root), "this": ROOT}
    runs = []
    for label in ("other", "this", "this", "other"):
        env = dict(os.environ, PYTHONPATH=roots[label])
        mode = ["--pair-stage"] if args.pair_stage else []
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-only", *mode,
             "--out", args.out, args.other_root], env=env, cwd=roots[label],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(json.dumps({"checkout": label, **runs[-1][1]}), flush=True)
    digests = {json.dumps({k: v["outputs_sha256"] for k, v in r.items()
                           if isinstance(v, dict)})
               for _, r in runs}
    print(json.dumps({"outputs_equal": len(digests) == 1}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip())
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
