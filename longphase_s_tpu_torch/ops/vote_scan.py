"""Vote scan from the four-combo pair counts, and the object-path wrapper.

Counterpart of ``longphase_s_tpu/ops/vote_scan.py``. The scan itself is
``ops/cuda_scan.vote_scan_pc`` (CUDA kernel on a CUDA tensor, plain
PyTorch on a CPU tensor); this module folds the ``[S, W, 4]`` hi/lo count
planes of ``core/matrix.pack_chromosome`` into the x10 sums it takes, and
keeps a numpy copy of ``assemble_blocks`` (the JAX module imports jax).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .cuda_scan import vote_scan_pc

INT32_MAX = np.iinfo(np.int32).max


def fold_counts(counts_hi, counts_lo):
    """``[S, W, 4]`` hi/lo combo counts (combo = a1*2 + a2) -> the x10
    parallel (rr + aa) and cross (ra + ar) sums, int32 ``[S, W]``."""
    x10 = counts_hi.to(torch.int32) * 10 + counts_lo.to(torch.int32)
    s_para10 = (x10[..., 0] + x10[..., 3]).contiguous()
    s_cross10 = (x10[..., 1] + x10[..., 2]).contiguous()
    return s_para10, s_cross10


def vote_scan_core(counts_hi, counts_lo, gap, vtype, window: int,
                   distance: int, edge_threshold_x10: float):
    """``vote_scan_core`` of the JAX package, from int32 ``[S, W, 4]``
    count planes, with the target bands derived from ``vtype``. Returns
    ``(assigned bool[S], hp int32[S], bstart int32[S])`` on the input's
    device."""
    S = counts_hi.shape[0]
    s_para10, s_cross10 = fold_counts(counts_hi, counts_lo)
    return vote_scan_pc(s_para10, s_cross10, gap, vtype, S, window, distance,
                        edge_threshold_x10)


def site_gaps(positions: np.ndarray) -> np.ndarray:
    """int32[S] position gap to the next site, INT32_MAX for the last."""
    S = len(positions)
    gap = np.full(S, INT32_MAX, dtype=np.int32)
    if S > 1:
        gap[:-1] = np.minimum(np.diff(positions), INT32_MAX).astype(np.int32)
    return gap


def run_vote_scan(packed, params, device):
    """Object path: scan a ``PackedChromosome`` on ``device`` and assemble
    blocks. Returns (ps int64[S], ori int8[S]) numpy arrays."""
    S = len(packed.positions)
    if S == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int8)
    dev = resolve_device(device)
    hi = torch.from_numpy(np.ascontiguousarray(packed.counts_hi, np.int32))
    lo = torch.from_numpy(np.ascontiguousarray(packed.counts_lo, np.int32))
    gap = torch.from_numpy(site_gaps(packed.positions))
    vtype = torch.from_numpy(np.ascontiguousarray(packed.vtype, np.int8))
    assigned, hp, bstart = vote_scan_core(
        hi.to(dev), lo.to(dev), gap.to(dev), vtype.to(dev),
        window=packed.window, distance=params.distance,
        edge_threshold_x10=float(params.edge_threshold) * 10.0)
    return assemble_blocks(packed.positions, assigned.cpu().numpy(),
                           hp.cpu().numpy(), bstart.cpu().numpy())


def assemble_blocks(positions, assigned, hp, bstart):
    """Block assembly from raw scan outputs (PhasingGraph.cpp:423-467),
    including the reference's "last site never processed" rule. A copy of
    ``longphase_s_tpu/ops/vote_scan.py:assemble_blocks``."""
    S = len(positions)
    assigned = assigned.copy()
    assigned[S - 1] = False
    ps = np.zeros(S, dtype=np.int64)
    ori = np.zeros(S, dtype=np.int8)
    members = np.nonzero(assigned)[0]
    if len(members) == 0:
        return ps, ori
    mb = bstart[members]
    run_breaks = np.nonzero(np.diff(mb) != 0)[0] + 1
    run_starts = np.concatenate([[0], run_breaks])
    run_ends = np.concatenate([run_breaks, [len(members)]])
    for rs, re in zip(run_starts, run_ends):
        if re - rs <= 1:
            continue
        idx = members[rs:re]
        ps[idx] = positions[mb[rs]] + 1
        flips = (hp[idx][1:] != hp[idx][:-1]).astype(np.int8)
        ori[idx] = np.concatenate([[0], np.cumsum(flips) % 2]).astype(np.int8)
    return ps, ori
