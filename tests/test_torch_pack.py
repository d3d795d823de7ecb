"""Pair-sum parity: the port's plain pair sums
(longphase_s_tpu_torch/ops/fused.py:pair_sums_plain, the reference of the
sums the pair_cast kernel keeps in shared memory) against the JAX package's
scatter pack (device_pair_counts, folded to x10 sums) on merged streams
with shared read names, and against its Gram-matmul pack (mxu_pc_counts over
build_tiles) on unique streams. Exact equality: the sums are integers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longphase_s_tpu.core.fastpath import merge_observations
from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.ops.fused import device_pair_counts
from longphase_s_tpu.ops.mxu_pack import build_tiles, mxu_pc_counts
from longphase_s_tpu_torch.ops.fused import pair_sums_plain, stream_to_device

W = 35
_scatter_pack = jax.jit(device_pair_counts, static_argnums=(4, 5))


def _random_flat(seed, unique_names, n_reads=40, max_obs=60, n_sites=300):
    """Random alignments as tests/test_fused_pack.py draws them: about 15%
    of them share the previous alignment's name (split alignments) unless
    ``unique_names``."""
    rng = np.random.default_rng(seed)
    positions = np.sort(rng.choice(np.arange(1000, 400000, 7), n_sites,
                                   replace=False))
    obs_pos, offsets, names = [], [0], []
    for r in range(n_reads):
        k = int(rng.integers(1, max_obs))
        lo = int(rng.integers(0, n_sites - 1))
        hi = min(n_sites, lo + int(rng.integers(1, 80)))
        sites = np.sort(rng.choice(np.arange(lo, hi), min(k, hi - lo),
                                   replace=False))
        obs_pos.extend(positions[sites])
        offsets.append(len(obs_pos))
        shared = not unique_names and rng.random() <= 0.15
        names.append(f"read_{max(0, r - 1) if shared else r}")
    n = len(obs_pos)
    return (np.array(obs_pos, np.int64), rng.integers(0, 2, n).astype(np.int8),
            rng.integers(0, 40, n).astype(np.int16),
            np.array(offsets, np.int64), names)


def _merged(seed, unique_names):
    positions, _vtype, _rank, m_read, m_rank, m_allele, m_qok, _aln = \
        merge_observations(*_random_flat(seed, unique_names), PhaseParams())
    return len(positions), m_read, m_rank, m_allele, m_qok


def _folded_scatter(m_read, m_rank, m_allele, m_qok, S):
    hi, lo = _scatter_pack(
        jnp.asarray(np.asarray(m_read, np.int32)), jnp.asarray(m_rank),
        jnp.asarray(np.asarray(m_allele, np.int8)), jnp.asarray(m_qok), S, W)
    x10 = np.asarray(hi) * 10 + np.asarray(lo)
    return x10[..., 0] + x10[..., 3], x10[..., 1] + x10[..., 2]


def _port(m_read, m_rank, m_allele, m_qok, S):
    s_para10, s_cross10 = pair_sums_plain(
        *stream_to_device(m_read, m_rank, m_allele, m_qok, "cpu"), S, W)
    assert s_para10.dtype == torch.int32 and s_para10.shape == (S, W)
    return s_para10.numpy(), s_cross10.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_sums_match_scatter_pack(seed):
    S, *stream = _merged(seed, unique_names=False)
    ref = _folded_scatter(*stream, S)
    got = _port(*stream, S)
    assert ref[0].sum() > 0 and ref[1].sum() > 0
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[1], got[1])


@pytest.mark.parametrize("seed", [5, 6])
def test_pair_sums_match_gram_pack_on_unique_streams(seed):
    S, m_read, m_rank, m_allele, m_qok = _merged(seed, unique_names=True)
    S_pad = max(256, 1 << int(np.ceil(np.log2(S))))
    bits = build_tiles(m_read, m_rank, m_allele, m_qok, S_pad, W)
    assert bits is not None
    s_para10, s_cross10 = mxu_pc_counts(jnp.asarray(bits), W)
    got = _port(m_read, m_rank, m_allele, m_qok, S)
    assert np.array_equal(np.asarray(s_para10)[:S], got[0])
    assert np.array_equal(np.asarray(s_cross10)[:S], got[1])


def test_pair_sums_follow_stream_shift_on_duplicates_and_padding():
    """Split alignments that repeat a (read, rank) and m_read == -1 rows:
    pairs are the stream-shift pairs of the scatter pack, not all same-read
    pairs (build_tiles refuses such streams)."""
    m_read = np.array([0, 0, 0, 0, 1, 1, -1, -1], np.int32)
    m_rank = np.array([3, 3, 5, 5, 2, 4, 0, 1], np.int32)
    m_allele = np.array([0, 1, 0, 1, 1, 1, 0, 0], np.int64)
    m_qok = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    S = 8
    assert build_tiles(m_read, m_rank, m_allele, m_qok, 256, W) is None
    ref = _folded_scatter(m_read, m_rank, m_allele, m_qok, S)
    got = _port(m_read, m_rank, m_allele, m_qok, S)
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[1], got[1])
    # rank 3 -> 5 (d = 2): (0,0) lo, (0,1) hi, (1,0) lo, (1,1) hi
    assert got[0][3, 1] == 1 + 10 and got[1][3, 1] == 1 + 10
    assert got[0][2, 1] == 10  # read 1: rank 2 -> 4, same allele, both qok
    assert got[0][:, 0].sum() == 0 and got[1][:, 0].sum() == 0  # no d = 1


def test_stream_to_device_checks_its_inputs():
    read = np.array([0, 0, 1], np.int64)
    rank = np.array([0, 1, 2], np.int64)
    allele = np.array([0, 1, 1], np.int64)
    qok = np.array([1, 0, 1], bool)
    r, k, a, q = stream_to_device(read, rank, allele, qok, "cpu")
    assert (r.dtype, k.dtype, a.dtype, q.dtype) == \
        (torch.int32, torch.int32, torch.int8, torch.bool)
    with pytest.raises(ValueError, match="alleles"):
        stream_to_device(read, rank, np.array([0, 2, 1]), qok, "cpu")
    with pytest.raises(ValueError, match="m_rank"):
        stream_to_device(read, np.array([0, 1, 2**31]), allele, qok, "cpu")
    with pytest.raises(ValueError, match="m_read"):
        stream_to_device(np.array([0, -2**31 - 1, 1]), rank, allele, qok,
                         "cpu")
