"""The phase device step: pair cast -> vote scan -> block assembly on the
device, read correction on the host.

Counterpart of ``longphase_s_tpu/ops/fused.py`` (``_fused_phase`` and
``_mxu_phase``). One code path serves every stream size: the merged
observation stream is uploaded once, the pair cast (CUDA kernels
``csrc/pair_cast.cu``) turns it into the vote codes the serial vote scan
(CUDA kernel ``csrc/vote_scan.cu``) reads, with the x10 pair sums kept in
shared memory, block assembly runs as plain torch, and ``ps``/``ori`` come
back for the float64 read correction on the host
(``ops/read_correction.host_read_correction_merged``, native when the
C++ library is built), as the JAX package's chromosome-scale path does.
There is no 2^18-observation split, no host tile build and no padding to
powers of two.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP
from . import _build
from .cuda_scan import code_width, cut_window, vote_codes_plain, vote_serial
from .read_correction import host_read_correction_merged
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


def pair_sums_plain(m_read, m_rank, m_allele, m_qok, S: int, window: int):
    """The x10 pair sums ``(s_para10, s_cross10)``, int32 ``[S, W]``, from
    the merged stream tensors of ``stream_to_device``: W shifted compares
    of the stream against itself (fused.py:35-57) and one ``index_add_``.
    Observations whose rank lies outside [0, S) are no sources. The plain
    reference of the sums that ``pair_cast`` keeps in shared memory; it
    runs on the inputs' device."""
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


def pair_codes(stream, gap, vtype, S: int, window: int, distance: int,
               edge_threshold_x10: float):
    """The vote scan's codes straight from the merged stream tensors of
    ``stream_to_device``: ``(codes uint8[S, Wp], site int32[S])``, what
    ``cuda_scan.vote_codes`` makes of ``pair_sums_plain``'s sums, for
    ``cuda_scan.vote_serial``. A CPU tensor takes ``pair_codes_plain``; a
    CUDA tensor launches the three kernels of ``csrc/pair_cast.cu``
    (``bucket_counts``, ``bucket_order``, ``pair_cast_tiles``); any other
    device raises."""
    distance = min(max(int(distance), _I32.min), _I32.max)
    m_read, m_rank = stream[0], stream[1]
    if m_read.device.type == "cpu":
        return pair_codes_plain(stream, gap, vtype, S, window, distance,
                                edge_threshold_x10)
    if m_read.device.type != "cuda":
        raise RuntimeError(f"pair_codes: no kernel for device {m_read.device}")
    T = pair_tile_rows(S, window, m_read.device)
    count = bucket_counts(m_read, m_rank, S, T)
    order, ends = bucket_order(m_read, m_rank, S, T, count)
    return pair_cast_tiles(stream, order, ends, gap, vtype, S, window, T,
                           distance, edge_threshold_x10)


def pair_codes_plain(stream, gap, vtype, S: int, window: int, distance: int,
                     edge_threshold_x10: float):
    """Plain PyTorch version of ``pair_codes``: the sums of
    ``pair_sums_plain``, cast by ``vote_codes_plain``. It runs on the
    inputs' device; ``pair_codes`` hands it CPU tensors only."""
    return vote_codes_plain(*pair_sums_plain(*stream, S, window), gap, vtype,
                            S, window, distance, edge_threshold_x10)


def pair_tile_rows(S: int, window: int, device) -> int:
    """The sites a ``pair_cast`` tile holds at this window, as the kernel
    chooses them for ``device``'s shared memory (32 at W = 35, 16 at W =
    100). Raises ValueError where even one site row does not fit."""
    if window < 1:
        raise ValueError(f"pair_codes: window must be >= 1, got {window}")
    w, Wp = cut_window(S, window), code_width(S, window)
    with torch.cuda.device(device):
        T = _build.library().lps_pair_tile(w, Wp)
    if T < 0:
        _build.check_launch("pair_cast", -T)
    if T == 0:
        raise ValueError(f"pair_codes: window {window} (cut to {w}) is too "
                         "wide: one site row of pair sums does not fit a "
                         "block's shared memory")
    return T


def _source_tiles(m_read, m_rank, S: int, T: int):
    """The source observations (m_read >= 0, rank in [0, S)) in stream
    order and their tiles, rank // T, both int64."""
    idx = torch.nonzero((m_read >= 0) & (m_rank >= 0) & (m_rank < S))[:, 0]
    return idx, m_rank[idx].to(torch.int64) // T


def bucket_counts(m_read, m_rank, S: int, T: int):
    """The number of source observations of each tile of T sites, int32
    ``[ceil(S/T)]``. A CPU tensor takes ``bucket_counts_plain``, a CUDA
    tensor launches ``bucket_count``."""
    if m_read.device.type == "cpu":
        return bucket_counts_plain(m_read, m_rank, S, T)
    n = _check_cuda("bucket_counts", m_read.device,
                    (("m_read", m_read, torch.int32, None),
                     ("m_rank", m_rank, torch.int32, None)))
    count = torch.zeros(-(-S // T), dtype=torch.int32, device=m_read.device)
    if n == 0 or S == 0:
        return count
    with torch.cuda.device(m_read.device):
        err = _build.library().lps_bucket_count(
            m_read.data_ptr(), m_rank.data_ptr(), n, S, T, count.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("bucket_count", err)
    _build.LAUNCHES["bucket_count"] += 1
    return count


def bucket_counts_plain(m_read, m_rank, S: int, T: int):
    """Plain PyTorch version of ``bucket_count``: one ``bincount``."""
    _idx, key = _source_tiles(m_read, m_rank, S, T)
    return torch.bincount(key, minlength=-(-S // T)).to(torch.int32)


def bucket_order(m_read, m_rank, S: int, T: int, count):
    """The source observations grouped by tile: ``(order int32, ends
    int32[ceil(S/T)])``, tile b's sources at ``order[ends[b-1]:ends[b]]``
    (``ends`` the inclusive scan of ``count``), in any order within a tile.
    A CPU tensor takes ``bucket_order_plain``; a CUDA tensor launches
    ``bucket_scatter`` into an ``order`` of n entries, those past
    ``ends[-1]`` left unwritten."""
    if m_read.device.type == "cpu":
        return bucket_order_plain(m_read, m_rank, S, T, count)
    dev = m_read.device
    n = _check_cuda("bucket_order", dev,
                    (("m_read", m_read, torch.int32, None),
                     ("m_rank", m_rank, torch.int32, None),
                     ("count", count, torch.int32, (-(-S // T),))))
    ends = torch.cumsum(count, 0, dtype=torch.int32)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0 or S == 0:
        return order, ends
    cursor = ends - count
    with torch.cuda.device(dev):
        err = _build.library().lps_bucket_scatter(
            m_read.data_ptr(), m_rank.data_ptr(), n, S, T, cursor.data_ptr(),
            order.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("bucket_scatter", err)
    _build.LAUNCHES["bucket_scatter"] += 1
    return order, ends


def bucket_order_plain(m_read, m_rank, S: int, T: int, count):
    """Plain PyTorch version of ``bucket_scatter``: a stable sort of the
    sources by tile, so each bucket keeps stream order."""
    idx, key = _source_tiles(m_read, m_rank, S, T)
    order = idx[torch.sort(key, stable=True).indices].to(torch.int32)
    return order, torch.cumsum(count, 0, dtype=torch.int32)


def pair_cast_tiles(stream, order, ends, gap, vtype, S: int, window: int,
                    T: int, distance: int, edge_threshold_x10: float):
    """The codes of ``pair_codes`` from the stream and its buckets (of
    ``bucket_order``), one tile of T sites a block. A CPU tensor takes
    ``pair_codes_plain``, which needs no buckets; a CUDA tensor launches
    ``pair_cast``."""
    distance = min(max(int(distance), _I32.min), _I32.max)
    m_read, m_rank, m_allele, m_qok = stream
    if m_read.device.type == "cpu":
        return pair_codes_plain(stream, gap, vtype, S, window, distance,
                                edge_threshold_x10)
    dev = m_read.device
    n = _check_cuda("pair_cast_tiles", dev,
                    (("m_read", m_read, torch.int32, None),
                     ("m_rank", m_rank, torch.int32, None),
                     ("m_allele", m_allele, torch.int8, None),
                     ("m_qok", m_qok, torch.bool, None),
                     ("order", order, torch.int32, None),
                     ("ends", ends, torch.int32, (-(-S // T),)),
                     ("gap", gap, torch.int32, (S,)),
                     ("vtype", vtype, torch.int8, (S,))))
    if window < 1:
        raise ValueError(f"pair_codes: window must be >= 1, got {window}")
    w, Wp = cut_window(S, window), code_width(S, window)
    codes = torch.empty(S, Wp, dtype=torch.uint8, device=dev)
    site = torch.empty(S, dtype=torch.int32, device=dev)
    if S == 0:
        return codes, site
    with torch.cuda.device(dev):
        err = _build.library().lps_pair_cast(
            m_read.data_ptr(), m_rank.data_ptr(), m_allele.data_ptr(),
            m_qok.data_ptr(), n, order.data_ptr(), ends.data_ptr(),
            gap.data_ptr(), vtype.data_ptr(), S, window, w, Wp, T, distance,
            float(edge_threshold_x10), T_SNP, T_MOD, T_INDEL, T_DANGER,
            codes.data_ptr(), site.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("pair_cast", err)
    _build.LAUNCHES["pair_cast"] += 1
    return codes, site


def _check_cuda(name: str, dev, specs) -> int:
    """Raise unless ``dev`` is a CUDA device and each ``(arg, tensor,
    dtype, shape)`` a contiguous tensor of that dtype on it, of that shape
    (``None``: the stream's ``[n]``, n from the first); returns n."""
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    n = specs[0][1].shape[0]
    if n > _I32.max:
        raise ValueError(f"{name}: {n} observations do not fit int32 "
                         "indices")
    for arg, x, dtype, shape in specs:
        shape = (n,) if shape is None else shape
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dtype} "
                             f"{list(shape)} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return n


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

    codes, site = pair_codes((read_t, rank_t, allele_t, qok_t), gap_t,
                             vtype_t, S, W, params.distance,
                             float(params.edge_threshold) * 10.0)
    assigned, hp, bstart = vote_serial(codes, site, S, W)
    ps, ori = device_assemble_blocks(assigned, hp, bstart, pos_t, S)
    ps = ps.cpu().numpy()
    ori = ori.cpu().numpy()
    new_ps, new_ori = host_read_correction_merged(
        ps, ori, vtype, m_rank, m_allele, m_aln, n_aln,
        params.read_confidence, params.snp_confidence)
    return new_ps.astype(np.int64), new_ori.astype(np.int8)
