"""Pair-cast parity: the port's vote codes straight from the merged stream
(longphase_s_tpu_torch/ops/fused.py:pair_codes, the CPU side of the
pair_cast kernel) against the JAX package, and a numpy emulation of the
kernel's tile decomposition against the plain version.

- JAX: the codes, decoded, equal the vote planes that
  longphase_s_tpu/ops/pallas_scan.py:planes_from_pc builds from the JAX
  scatter pack's (device_pair_counts) folded sums, and the serial pass over
  the codes equals the JAX lax.scan engine on the same counts. Above W =
  128, where planes_from_pc's 128-lane layout does not reach, the decoded
  codes equal the port's vote_planes on JAX's sums instead.
- Tiles: buckets keyed by rank // T, sums accumulated per tile in local
  rows, the cast with a halo of w target types, as csrc/pair_cast.cu does,
  equal pair_codes_plain at T in {1, 7, 64}, on streams in (read, rank)
  order, with their reads shuffled and with every row shuffled.

Exact equality throughout: the sums are integers and the one float32
compare is the same compare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longphase_s_tpu.core.fastpath import merge_observations
from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.ops.fused import device_pair_counts
from longphase_s_tpu.ops.pallas_scan import planes_from_pc
from longphase_s_tpu.ops.vote_scan import vote_scan_core as jax_vote_scan_core
from longphase_s_tpu_torch.core.phase_algo import (T_DANGER, T_INDEL, T_MOD,
                                                   T_SNP)
from longphase_s_tpu_torch.ops import _build, cuda_scan, fused
from longphase_s_tpu_torch.ops.vote_scan import site_gaps

_scatter_pack = jax.jit(device_pair_counts, static_argnums=(4, 5))
_planes = jax.jit(planes_from_pc, static_argnames=("edge_threshold_x10",))
_jax_core = jax.jit(jax_vote_scan_core,
                    static_argnames=("window", "distance", "edge_threshold_x10"))
# (edgeThreshold, distance): the second skips about one site in eight
SETTINGS = ((0.7, 300000), (0.33, 250))
PAD = 17  # m_read == -1 rows after the stream


def _random_alignments(seed):
    """Alignments over up to 500 sites with every variant-type quality
    sentinel and shared read names (tests/test_torch_phase.py's draw)."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(50, 500))
    A = int(rng.integers(30, 250))
    positions = np.sort(rng.choice(np.arange(S * 120), size=S,
                                   replace=False)).astype(np.int64)
    chunks, names = [], []
    for _ in range(A):
        start = int(rng.integers(0, S))
        ln = int(rng.integers(1, min(60, S - start) + 1))
        idx = np.arange(start, start + ln)
        chunks.append((idx, rng.integers(0, 2, size=ln),
                       rng.choice([30, 5, -4, -5, -1, -2], size=ln)))
        names.append(f"r{int(rng.integers(0, A))}")
    obs_pos = np.concatenate([positions[i] for i, _, _ in chunks])
    obs_allele = np.concatenate([x for _, x, _ in chunks]).astype(np.int8)
    obs_qual = np.concatenate([q for _, _, q in chunks]).astype(np.int16)
    offsets = np.concatenate(
        [[0], np.cumsum([len(i) for i, _, _ in chunks])]).astype(np.int64)
    return obs_pos, obs_allele, obs_qual, offsets, names


def _stream(seed):
    """A merged stream with duplicate (read, rank) rows from split
    alignments and PAD trailing m_read == -1 rows; its positions and
    variant types."""
    positions, vtype, _rank, m_read, m_rank, m_allele, m_qok, _aln = \
        merge_observations(*_random_alignments(seed), PhaseParams())
    pad = np.full(PAD, -1, np.int64)
    stream = (np.concatenate([m_read, pad]).astype(np.int32),
              np.concatenate([m_rank, np.zeros(PAD, np.int64)]).astype(np.int32),
              np.concatenate([m_allele, np.zeros(PAD, np.int64)]).astype(np.int8),
              np.concatenate([m_qok, np.ones(PAD, bool)]))
    return stream, positions, vtype


def _reorder(stream, how, seed):
    rng = np.random.default_rng(seed)
    read = stream[0]
    if how == "sorted":
        return stream
    if how == "rows_shuffled":
        perm = rng.permutation(len(read))
    else:  # reads_shuffled: each read's rows stay together, in order
        ids = np.unique(read)
        place = dict(zip(ids, rng.permutation(len(ids))))
        perm = np.argsort([place[r] for r in read], kind="stable")
    return tuple(a[perm] for a in stream)


def _bands(vt, W):
    S = len(vt)
    tgt = np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]
    valid = tgt < S
    tvt = np.where(valid, np.concatenate([vt, np.zeros(W, np.int8)])[tgt], 0)
    return tvt.astype(np.int8), valid


def _port_codes(stream, positions, vtype, W, thr, distance):
    S = len(positions)
    gap = torch.from_numpy(site_gaps(positions))
    vt = torch.from_numpy(np.asarray(vtype, np.int8))
    tensors = fused.stream_to_device(*stream, "cpu")
    codes, site = fused.pair_codes(tensors, gap, vt, S, W, distance,
                                   thr * 10.0)
    assert codes.dtype == torch.uint8 and site.dtype == torch.int32
    assert codes.shape == (S, cuda_scan.code_width(S, W))
    return codes, site


@pytest.mark.parametrize("W", [1, 33, 35, 129])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_codes_match_jax_planes_and_scan(seed, W):
    stream, positions, vtype = _stream(seed)
    S = len(positions)
    w = cuda_scan.cut_window(S, W)
    hi, lo = _scatter_pack(*(jnp.asarray(a) for a in stream), S, W)
    x10 = np.asarray(hi) * 10 + np.asarray(lo)
    s_para10 = x10[..., 0] + x10[..., 3]
    s_cross10 = x10[..., 1] + x10[..., 2]
    assert s_para10.sum() > 0 and s_cross10.sum() > 0
    tvt, valid = _bands(vtype, W)
    gap = site_gaps(positions)
    for thr, distance in SETTINGS:
        codes, site = _port_codes(stream, positions, vtype, W, thr, distance)
        inc1, inc2, dmax, skip = cuda_scan.decode_codes(codes, site)
        assert not codes[:, w:].any()
        if W <= 128:
            plane, jax_dmax = _planes(jnp.asarray(s_para10),
                                      jnp.asarray(s_cross10),
                                      jnp.asarray(vtype), jnp.asarray(tvt),
                                      jnp.asarray(valid),
                                      edge_threshold_x10=thr * 10.0)
            p = np.asarray(plane)[:, :, :W].astype(np.int64)
            ref1 = np.stack([p[:, 0] >> 16, p[:, 0] & 0xFFFF, p[:, 1] & 0x3F,
                             p[:, 1] >> 19, (p[:, 1] >> 6) & 0x1FFF], -1)
            ref2 = np.stack([p[:, 2] >> 16, p[:, 2] & 0xFFFF, p[:, 3] & 0x3F,
                             p[:, 3] >> 19, (p[:, 3] >> 6) & 0x1FFF], -1)
            ref_dmax = np.asarray(jax_dmax)
        else:
            r1, r2, r_dmax = cuda_scan.vote_planes(
                torch.from_numpy(s_para10), torch.from_numpy(s_cross10),
                torch.from_numpy(vtype), S, W, thr * 10.0)
            ref1, ref2, ref_dmax = r1.numpy(), r2.numpy(), r_dmax.numpy()
        assert not ref1[:, w:].any() and not ref2[:, w:].any()
        assert np.array_equal(inc1[:, :w].numpy(), ref1[:, :w])
        assert np.array_equal(inc2[:, :w].numpy(), ref2[:, :w])
        assert np.array_equal(dmax.numpy(), ref_dmax)
        assert np.array_equal(skip.numpy(), gap > distance)

        got = [x.numpy() for x in cuda_scan.vote_serial(codes, site, S, W)]
        ref = _jax_core(hi, lo, jnp.asarray(gap), jnp.asarray(vtype),
                        jnp.asarray(tvt), jnp.asarray(valid), window=W,
                        distance=distance, edge_threshold_x10=thr * 10.0)
        for name, a, b in zip(("assigned", "hp", "bstart"), ref, got):
            assert np.array_equal(np.asarray(a).astype(np.int64),
                                  b.astype(np.int64)), name
        assert got[0].sum() > S // 4


def _cast(sp, sc, vt, tvt, valid, thr10):
    """cast_code (csrc/vote_code.cuh) over arrays, in numpy."""
    total = sp + sc
    mn, mx = np.minimum(sp, sc), np.maximum(sp, sc)
    modsnp = ((vt == T_SNP) & (tvt == T_MOD)) | ((vt == T_MOD) & (tvt == T_SNP))
    thr = np.where(modsnp, np.where(total < 10, np.float32(-10.0),
                                    np.float32(3.0)), np.float32(thr10))
    reject = (mx > 0) & (np.float32(10.0) * mn.astype(np.float32)
                         > thr.astype(np.float32) * mx.astype(np.float32))
    conn = valid & (sp != sc) & ~reject
    big = ((10 * mn <= mx) & (total >= 10)) | ((sp < 10) & (sc >= 10)) \
        | ((sp >= 10) & (sc < 10))
    wclass = np.where(vt == T_DANGER, 1, np.where(big, 3, 2))
    small = total <= 10
    elig = ~small & (5 * mn < mx) & (wclass >= 2) & (vt != T_INDEL)
    code = wclass + 4 * (sp > sc) + 8 * small + 16 * elig
    return np.where(conn, code, 0).astype(np.uint8)


def _tile_emulation(stream, gap, vtype, S, W, T, distance, thr10):
    """The three launches of csrc/pair_cast.cu in numpy: bucket the sources
    by tile (inside a bucket in reverse stream order: the order must not
    matter), add each tile's pairs into local rows [T, w], then cast every
    (t, d) of a tile against its halo vt[s0 .. s0+T+w) and write the rows
    of the sites it holds."""
    read, rank, allele, qok = stream
    n = len(read)
    w, Wp = cuda_scan.cut_window(S, W), cuda_scan.code_width(S, W)
    tiles = -(-S // T)
    src = (read >= 0) & (rank >= 0) & (rank < S)
    order = np.flatnonzero(src)
    order = order[np.lexsort((-order, rank[order] // T))]
    tile = rank[order] // T
    local = rank[order] - tile * T

    sums = np.zeros((tiles, 2, T, w), np.int64)
    for m in range(1, W + 1):
        j = order + m
        ok = j < n
        jj = np.where(ok, j, 0)
        d = rank[jj] - rank[order]
        ok &= (read[jj] == read[order]) & (d >= 1) & (d <= w)
        cross = allele[jj] != allele[order]
        add = np.where(qok[order] & qok[jj], 10, 1)
        np.add.at(sums, (tile[ok], cross[ok].astype(int), local[ok],
                         d[ok] - 1), add[ok])

    halo = np.zeros((tiles, T + w), np.int64)
    s_of = np.arange(tiles)[:, None] * T + np.arange(T + w)[None, :]
    halo[s_of < S] = vtype[s_of[s_of < S]]
    t = np.arange(T)[None, :, None]
    d = np.arange(1, w + 1)[None, None, :]
    s0 = (np.arange(tiles) * T)[:, None, None]
    tvt = np.take_along_axis(halo[:, None, :].repeat(T, 1),
                             np.broadcast_to(t + d, (tiles, T, w)), 2)
    vt = halo[:, :T, None]
    code = _cast(sums[:, 0], sums[:, 1], vt, tvt, s0 + t + d < S, thr10)
    dmax = np.where(code > 0, d, 0).max(-1)
    codes = np.zeros((tiles * T, Wp), np.uint8)
    codes[:, :w] = code.reshape(tiles * T, w)
    site = dmax.reshape(-1)[:S] | ((gap > distance).astype(np.int64) << 16)
    return codes[:S], site.astype(np.int32)


@pytest.mark.parametrize("order", ["sorted", "reads_shuffled",
                                   "rows_shuffled"])
@pytest.mark.parametrize("T", [1, 7, 64])
@pytest.mark.parametrize("seed,W", [(2, 35), (3, 129), (4, 1)])
def test_tile_emulation_matches_plain(seed, W, T, order):
    stream, positions, vtype = _stream(seed)
    stream = _reorder(stream, order, seed)
    S = len(positions)
    gap = site_gaps(positions)
    for thr, distance in SETTINGS:
        codes, site = _port_codes(stream, positions, vtype, W, thr, distance)
        got = _tile_emulation(stream, gap, np.asarray(vtype, np.int64), S, W,
                              T, distance, thr * 10.0)
        assert np.array_equal(got[0], codes.numpy())
        assert np.array_equal(got[1], site.numpy())
        # a shuffled stream keeps few same-read rows within W of each other
        assert int((codes != 0).sum()) > (0 if order == "rows_shuffled" else 10)


def test_tile_emulation_on_a_window_wider_than_the_chromosome():
    """S = 9 sites, W = 35: the window is cut to 8, every tile's halo runs
    past the chromosome."""
    rng = np.random.default_rng(9)
    S, n = 9, 300
    read = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    rank = rng.integers(0, S, n).astype(np.int32)
    order = np.lexsort((rank, read))
    stream = (read[order], rank[order], rng.integers(0, 2, n).astype(np.int8),
              rng.random(n) < 0.8)
    positions = np.arange(S, dtype=np.int64) * 100 + 1000
    vtype = rng.integers(0, 5, S).astype(np.int8)
    codes, site = _port_codes(stream, positions, vtype, 35, 0.7, 300000)
    assert codes.shape == (S, 32)
    for T in (1, 4, 64):
        got = _tile_emulation(stream, site_gaps(positions),
                              vtype.astype(np.int64), S, 35, T, 300000, 7.0)
        assert np.array_equal(got[0], codes.numpy())
        assert np.array_equal(got[1], site.numpy())
    assert (site.numpy() & 0xFFFF).max() >= 1


def test_pair_codes_on_a_non_cpu_tensor_never_takes_the_plain_version():
    S, n = 8, 20
    meta = dict(device="meta")
    stream = (torch.empty(n, dtype=torch.int32, **meta),
              torch.empty(n, dtype=torch.int32, **meta),
              torch.empty(n, dtype=torch.int8, **meta),
              torch.empty(n, dtype=torch.bool, **meta))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.pair_codes(stream, torch.empty(S, dtype=torch.int32, **meta),
                         torch.empty(S, dtype=torch.int8, **meta), S, 35,
                         300000, 7.0)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("T", [1, 7, 64])
def test_buckets_hold_each_tiles_sources_in_stream_order(T):
    """The plain versions of the two bucket passes on a stream with its
    rows shuffled: tile b's slice of ``order`` is exactly its sources."""
    stream, positions, _vtype = _stream(5)
    read, rank = (torch.from_numpy(a) for a in _reorder(stream,
                                                        "rows_shuffled", 5)[:2])
    S = len(positions)
    count = fused.bucket_counts(read, rank, S, T)
    order, ends = fused.bucket_order(read, rank, S, T, count)
    assert count.dtype == ends.dtype == order.dtype == torch.int32
    assert count.shape == (-(-S // T),) and int(ends[-1]) == len(order)
    src = (read >= 0) & (rank >= 0) & (rank < S)
    assert len(order) == int(src.sum()) < len(read)
    begin = 0
    for b, end in enumerate(ends.tolist()):
        want = torch.nonzero(src & (rank // T == b))[:, 0].to(torch.int32)
        assert torch.equal(order[begin:end], want)
        begin = end
