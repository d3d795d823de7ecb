"""Haplotype vote scan: the CUDA kernel ``csrc/vote_scan.cu`` and its plain
PyTorch version.

Counterpart of ``longphase_s_tpu/ops/pallas_scan.py`` (the Pallas kernel
``_scan_kernel`` with ``planes_from_pc``). ``vote_scan_pc`` takes the x10
parallel/cross pair sums ``[S, W]`` and returns ``(assigned bool[S],
hp int32[S], bstart int32[S])``, the contract of
``longphase_s_tpu/ops/vote_scan.py:vote_scan_core``. The target-site bands
(``vtype_band``, ``valid_band``) are derived from ``vtype`` and ``S``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel;
any other device raises. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from longphase_s_tpu.core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP

from . import _build

MAX_WINDOW = 64  # the kernel's ring: two slots per lane of one warp
_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def vote_scan_pc(s_para10, s_cross10, gap, vtype, S: int, window: int,
                 distance: int, edge_threshold_x10: float):
    """Run the scan over ``S`` sites.

    Args:
      s_para10, s_cross10: int32[S, W] x10 same-allele / cross-allele pair
        sums between site t and site t+d (column d-1).
      gap: int32[S] position gap to the next site (huge for the last).
      vtype: int8[S] variant type per site.
      distance: a site whose gap exceeds it is skipped; clamped to int32,
        which changes no compare with an int32 gap.
      edge_threshold_x10: the edge-similarity threshold times 10; rounded
        once to float32, as JAX rounds its weak-typed constant.
    """
    distance = min(max(int(distance), _I32_MIN), _I32_MAX)
    if s_para10.device.type == "cpu":
        return vote_scan_pc_plain(s_para10, s_cross10, gap, vtype, S, window,
                                  distance, edge_threshold_x10)
    return _vote_scan_cuda(s_para10, s_cross10, gap, vtype, S, window,
                           distance, edge_threshold_x10)


def vote_planes(s_para10, s_cross10, vtype, S: int, window: int,
                edge_threshold_x10: float):
    """Carry-independent half of the scan (pallas_scan.py:77-126), over
    ``[S, W]``: the ring increment each site casts if it decides hp == 1
    (``inc1``) or hp == 2 (``inc2``), as ``[S, W, 5]`` int32 with fields
    (h1, h2, cnt, oh1, oh2), and the largest connectable offset ``dmax[S]``."""
    W = window
    dev = s_para10.device
    sp = s_para10.to(torch.int32)
    sc = s_cross10.to(torch.int32)
    total = sp + sc
    mn = torch.minimum(sp, sc)
    mx = torch.maximum(sp, sc)

    tgt = torch.arange(S, device=dev)[:, None] + \
        torch.arange(1, W + 1, device=dev)[None, :]
    valid = tgt < S
    vt_pad = torch.cat([vtype.to(torch.int32),
                        torch.zeros(W, dtype=torch.int32, device=dev)])
    tvt = torch.where(valid, vt_pad[tgt], 0)
    vt = vtype.to(torch.int32)[:, None]

    modsnp = ((vt == T_SNP) & (tvt == T_MOD)) | ((vt == T_MOD) & (tvt == T_SNP))
    thr_edge = torch.tensor(edge_threshold_x10, dtype=torch.float32, device=dev)
    thr10 = torch.where(
        modsnp,
        torch.where(total < 10, torch.tensor(-10.0, device=dev),
                    torch.tensor(3.0, device=dev)),
        thr_edge)
    reject = (mx > 0) & (10.0 * mn.to(torch.float32)
                         > thr10 * mx.to(torch.float32))
    conn_ok = (sp != sc) & ~reject & valid

    big = ((10 * mn <= mx) & (total >= 10)) | \
        ((sp < 10) & (sc >= 10)) | ((sp >= 10) & (sc < 10))
    weight = torch.where(big, 200, 10).to(torch.int32)
    weight = torch.where(vt == T_DANGER, 1, weight).to(torch.int32)

    conn = conn_ok.to(torch.int32)
    small = (conn_ok & (total <= 10)).to(torch.int32)
    elig = (conn_ok & (total > 10) & (5 * mn < mx) & (weight >= 10)
            & (vt != T_INDEL)).to(torch.int32)
    same = (sp > sc).to(torch.int32)
    diff = 1 - same
    v1 = conn * weight * same
    v2 = conn * weight * diff
    e1 = elig * weight * same
    e2 = elig * weight * diff
    inc1 = torch.stack([v1, v2, small, e1, e2], dim=-1)
    inc2 = torch.stack([v2, v1, small, e2, e1], dim=-1)
    d_plus1 = torch.arange(1, W + 1, device=dev, dtype=torch.int32)[None, :]
    dmax = torch.where(conn_ok, d_plus1, 0).amax(dim=1)
    return inc1, inc2, dmax


def vote_scan_pc_plain(s_para10, s_cross10, gap, vtype, S: int, window: int,
                       distance: int, edge_threshold_x10: float):
    """Plain PyTorch version of the kernel: the vote planes vectorized over
    ``[S, W]``, then a Python loop over sites. It runs on the inputs'
    device; ``vote_scan_pc`` hands it CPU tensors only, and ``chip_smoke.py``
    times it on the card beside the kernel.

    The W-deep ring is kept unrolled as per-site accumulators ``acc[S + W,
    5]``: what the ring's slot d holds at step t is ``acc[t + d]``. Votes
    from site t land in ``acc[t+1 : t+1+W]``; targets past the chromosome
    carry zero increments."""
    W = window
    _check_shapes(s_para10, s_cross10, gap, vtype, S, W)
    dev = s_para10.device
    inc1, inc2, dmax = vote_planes(s_para10, s_cross10, vtype, S, W,
                                   edge_threshold_x10)
    acc = torch.zeros(S + W, 5, dtype=torch.int32, device=dev)
    skip_distance = (gap > distance).tolist()
    dmax = dmax.tolist()
    assigned = [False] * S
    hp = [1] * S
    bstart = [-1] * S
    last_connect = -1
    block_start = -1
    for t in range(S):
        h1, h2, cnt, oh1, oh2 = acc[t].tolist()
        if cnt > 3 and not (oh1 == 0 and oh2 == 0):
            h1, h2 = oh1, oh2
        eq = h1 == h2
        skip_connected = eq and t < last_connect
        a = not skip_distance[t] and not skip_connected
        if eq and a:
            block_start = t
        hp[t] = 1 if eq or h1 > h2 else 2
        if a:
            assigned[t] = True
            bstart[t] = block_start
            if dmax[t] > 0:
                last_connect = t + dmax[t]
            acc[t + 1:t + 1 + W] += inc1[t] if hp[t] == 1 else inc2[t]
    return (torch.tensor(assigned, dtype=torch.bool, device=dev),
            torch.tensor(hp, dtype=torch.int32, device=dev),
            torch.tensor(bstart, dtype=torch.int32, device=dev))


def _check_shapes(s_para10, s_cross10, gap, vtype, S: int, W: int):
    if s_para10.shape != (S, W) or s_cross10.shape != (S, W):
        raise ValueError(f"pair sums must be [S={S}, W={W}], got "
                         f"{tuple(s_para10.shape)} / {tuple(s_cross10.shape)}")
    if gap.shape != (S,) or vtype.shape != (S,):
        raise ValueError(f"gap and vtype must be [S={S}], got "
                         f"{tuple(gap.shape)} / {tuple(vtype.shape)}")


def _vote_scan_cuda(s_para10, s_cross10, gap, vtype, S: int, window: int,
                    distance: int, edge_threshold_x10: float):
    W = window
    _check_shapes(s_para10, s_cross10, gap, vtype, S, W)
    dev = s_para10.device
    if dev.type != "cuda":
        raise RuntimeError(f"vote_scan_pc: no kernel for device {dev}")
    for name, x, dtype in (("s_para10", s_para10, torch.int32),
                           ("s_cross10", s_cross10, torch.int32),
                           ("gap", gap, torch.int32),
                           ("vtype", vtype, torch.int8)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"vote_scan_pc: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}, got {x.dtype} on "
                             f"{x.device} (contiguous={x.is_contiguous()})")
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"vote_scan_pc: the CUDA kernel takes 1 <= W <= "
                         f"{MAX_WINDOW}, got W={W}")
    assigned = torch.empty(S, dtype=torch.bool, device=dev)
    hp = torch.empty(S, dtype=torch.int32, device=dev)
    bstart = torch.empty(S, dtype=torch.int32, device=dev)
    if S == 0:
        return assigned, hp, bstart
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lps_vote_scan(
            s_para10.data_ptr(), s_cross10.data_ptr(), gap.data_ptr(),
            vtype.data_ptr(), S, W, distance, float(edge_threshold_x10),
            T_SNP, T_MOD, T_INDEL, T_DANGER, assigned.data_ptr(),
            hp.data_ptr(), bstart.data_ptr(), stream)
    _build.check_launch("vote_scan", err)
    _build.LAUNCHES["vote_scan"] += 1
    return assigned, hp, bstart
