"""The phase device step: pair pack -> vote scan -> block assembly on the
device, read correction on the host.

Counterpart of ``longphase_s_tpu/ops/fused.py`` (``_fused_phase`` and
``_mxu_phase``). One code path serves every stream size: the merged
observation stream is uploaded once, the banded pair pack (CUDA kernel
``csrc/pair_pack.cu``) writes the x10 pair sums the vote scan (CUDA kernel
``csrc/vote_scan.cu``) reads, block assembly runs as plain torch, and
``ps``/``ori`` come back for the float64 read correction on the host
(``longphase_s_tpu/ops/mxu_pack.host_read_correction_merged``, native when
the C++ library is built), as the JAX package's chromosome-scale path does.
There is no 2^18-observation split, no host tile build and no padding to
powers of two.
"""

from __future__ import annotations

import numpy as np
import torch

from longphase_s_tpu.ops.mxu_pack import host_read_correction_merged

from ..utils.device import resolve_device
from . import _build
from .cuda_scan import vote_scan_pc
from .vote_scan import site_gaps

_I32 = np.iinfo(np.int32)


def stream_to_device(m_read, m_rank, m_allele, m_qok, device):
    """The merged observation stream (numpy, from
    ``core/fastpath.merge_observations``) as tensors on ``device``: int32
    reads and ranks, int8 alleles, bool ``qok``.

    Raises ValueError when a read or rank does not fit int32, or an allele
    lies outside {0, 1}: the x10 parallel/cross sums hold only for alleles
    in {0, 1} (mxu_pack.py:58)."""
    dev = resolve_device(device)
    m_read = np.asarray(m_read)
    m_rank = np.asarray(m_rank)
    m_allele = np.asarray(m_allele)
    for name, a in (("m_read", m_read), ("m_rank", m_rank)):
        if len(a) and (a.min() < _I32.min or a.max() > _I32.max):
            raise ValueError(f"{name} does not fit int32: "
                             f"[{a.min()}, {a.max()}]")
    if len(m_allele) and (m_allele.min() < 0 or m_allele.max() > 1):
        raise ValueError("alleles must lie in {0, 1}, got "
                         f"[{m_allele.min()}, {m_allele.max()}]")
    arrays = (m_read.astype(np.int32), m_rank.astype(np.int32),
              m_allele.astype(np.int8), np.asarray(m_qok, dtype=bool))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def pair_sums(m_read, m_rank, m_allele, m_qok, S: int, window: int):
    """x10 pair sums ``(s_para10, s_cross10)``, int32 ``[S, W]``, from the
    merged stream tensors of ``stream_to_device``. A CPU tensor takes the
    plain version, a CUDA tensor launches the kernel, any other device
    raises."""
    if m_read.device.type == "cpu":
        return pair_sums_plain(m_read, m_rank, m_allele, m_qok, S, window)
    return _pair_sums_cuda(m_read, m_rank, m_allele, m_qok, S, window)


def pair_sums_plain(m_read, m_rank, m_allele, m_qok, S: int, window: int):
    """Plain PyTorch version of the kernel: W shifted compares of the
    stream against itself (fused.py:35-57) and one ``index_add_``. Like the
    kernel, it skips observations whose rank lies outside [0, S). It runs
    on the inputs' device; ``pair_sums`` hands it CPU tensors only."""
    W = window
    n = m_read.shape[0]
    own = (m_read >= 0) & (m_rank >= 0) & (m_rank < S)
    idx_parts = []
    val_parts = []
    for m in range(1, min(W, n - 1) + 1):
        r0, r1 = m_read[:n - m], m_read[m:]
        d = m_rank[m:] - m_rank[:n - m]
        keep = own[:n - m] & (r0 == r1) & (d >= 1) & (d <= W)
        cross = m_allele[:n - m][keep] != m_allele[m:][keep]
        both = m_qok[:n - m][keep] & m_qok[m:][keep]
        lin = (m_rank[:n - m][keep].to(torch.int64) * W
               + (d[keep].to(torch.int64) - 1) + cross.to(torch.int64) * S * W)
        idx_parts.append(lin)
        val_parts.append(torch.where(both, 10, 1).to(torch.int32))
    buf = torch.zeros(2 * S * W, dtype=torch.int32, device=m_read.device)
    if idx_parts:
        buf.index_add_(0, torch.cat(idx_parts), torch.cat(val_parts))
    return buf[:S * W].view(S, W), buf[S * W:].view(S, W)


def _pair_sums_cuda(m_read, m_rank, m_allele, m_qok, S: int, window: int):
    W = window
    dev = m_read.device
    if dev.type != "cuda":
        raise RuntimeError(f"pair_sums: no kernel for device {dev}")
    n = m_read.shape[0]
    for name, x, dtype in (("m_read", m_read, torch.int32),
                           ("m_rank", m_rank, torch.int32),
                           ("m_allele", m_allele, torch.int8),
                           ("m_qok", m_qok, torch.bool)):
        if x.device != dev or x.dtype != dtype or x.shape != (n,) \
                or not x.is_contiguous():
            raise ValueError(f"pair_sums: {name} must be a contiguous {dtype} "
                             f"[{n}] tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if W < 1:
        raise ValueError(f"pair_sums: window must be >= 1, got {W}")
    s_para10 = torch.zeros(S, W, dtype=torch.int32, device=dev)
    s_cross10 = torch.zeros(S, W, dtype=torch.int32, device=dev)
    if n == 0 or S == 0:
        return s_para10, s_cross10
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lps_pair_pack(
            m_read.data_ptr(), m_rank.data_ptr(), m_allele.data_ptr(),
            m_qok.data_ptr(), n, S, W, s_para10.data_ptr(),
            s_cross10.data_ptr(), stream)
    _build.check_launch("pair_pack", err)
    _build.LAUNCHES["pair_pack"] += 1
    return s_para10, s_cross10


def device_assemble_blocks(assigned, hp, bstart, positions, S: int):
    """Block assembly on the device (PhasingGraph.cpp:423-467), a port of
    ``longphase_s_tpu/ops/fused.py:device_assemble_blocks``: contiguous
    member runs sharing a block start, single-member runs dropped,
    orientation = parity of hp flips within the run, the last site never a
    member. Neighbour lookups ride masked cummax scans. Returns
    (ps int64[S], ori int8[S]) on the input's device."""
    dev = assigned.device
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    hp = hp.to(torch.int64)
    bstart = bstart.to(torch.int64)
    member = assigned & (idx != S - 1)
    minus1 = torch.full((1,), -1, dtype=torch.int64, device=dev)

    def excl(x):  # shift right by one, -1 in front
        return torch.cat([minus1, x[:-1]])

    # previous member's hp: cummax of (idx << 2 | hp) over members
    prev = excl(torch.cummax(torch.where(member, (idx << 2) | hp, -1), 0)[0])
    has_prev = prev >= 0
    hp_prev = prev & 3
    # bstart is non-decreasing over members, so its masked cummax is the
    # previous member's value
    pb = excl(torch.cummax(torch.where(member, bstart, -1), 0)[0])
    same_run = member & has_prev & (pb == bstart)
    flip = same_run & (hp_prev != hp)
    run_start = member & ~same_run
    cums = torch.cumsum(flip.to(torch.int64), 0)
    ffc = torch.cummax(torch.where(run_start, cums, -1), 0)[0]
    ori = torch.where(member, (cums - ffc.clamp(min=0)) % 2, 0)
    # next member's same_run flag: reversed masked cummax of
    # ((S - idx) << 1 | same_run)
    npacked = torch.where(member, ((S - idx) << 1) | same_run.to(torch.int64),
                          -1)
    rev = torch.flip(torch.cummax(torch.flip(npacked, (0,)), 0)[0], (0,))
    nxt = torch.cat([rev[1:], minus1])
    next_same = (nxt >= 0) & ((nxt & 1) == 1)
    keep = member & (same_run | next_same)
    ps = torch.where(keep, positions[bstart.clamp(min=0)] + 1, 0)
    return ps, ori.to(torch.int8)


def run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln, positions, vtype,
                    n_aln: int, params, device):
    """Phase one chromosome from its merged observation stream on
    ``device``. Returns (ps int64[S], ori int8[S]) numpy arrays, after read
    correction."""
    dev = resolve_device(device)
    W = params.connect_adjacent
    S = len(positions)
    if S == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int8)
    m_rank = np.asarray(m_rank)
    if len(m_rank) and (m_rank.min() < 0 or m_rank.max() >= S):
        raise ValueError(f"m_rank must lie in [0, {S}), got "
                         f"[{m_rank.min()}, {m_rank.max()}]")
    read_t, rank_t, allele_t, qok_t = stream_to_device(
        m_read, m_rank, m_allele, m_qok, dev)
    pos_t = torch.from_numpy(np.ascontiguousarray(positions, np.int64)).to(dev)
    vtype_t = torch.from_numpy(np.ascontiguousarray(vtype, np.int8)).to(dev)
    gap_t = torch.from_numpy(site_gaps(positions)).to(dev)

    s_para10, s_cross10 = pair_sums(read_t, rank_t, allele_t, qok_t, S, W)
    assigned, hp, bstart = vote_scan_pc(
        s_para10, s_cross10, gap_t, vtype_t, S, W, params.distance,
        float(params.edge_threshold) * 10.0)
    ps, ori = device_assemble_blocks(assigned, hp, bstart, pos_t, S)
    ps = ps.cpu().numpy()
    ori = ori.cpu().numpy()
    new_ps, new_ori = host_read_correction_merged(
        ps, ori, vtype, m_rank, m_allele, m_aln, n_aln,
        params.read_confidence, params.snp_confidence)
    return new_ps.astype(np.int64), new_ori.astype(np.int8)
