"""Vote-scan parity: the port's plain PyTorch scan (the CPU side of
longphase_s_tpu_torch/ops/cuda_scan.py) against the JAX package's lax.scan
engine and its Pallas kernel in interpret mode. Exact equality of all three
outputs (assigned, hp, bstart) at every site: the arithmetic is integer plus
one fixed float32 compare."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longphase_s_tpu.ops.pallas_scan import vote_scan_pallas
from longphase_s_tpu.ops.vote_scan import vote_scan_core as jax_vote_scan_core
from longphase_s_tpu_torch.ops import _build, cuda_scan
from longphase_s_tpu_torch.ops.vote_scan import vote_scan_core

W = 35
_jax_core = jax.jit(jax_vote_scan_core,
                    static_argnames=("window", "distance", "edge_threshold_x10"))


def _inputs(seed, S):
    """Random counts as tests/test_pallas_scan.py draws them; the target
    bands follow from vtype, as the port derives them."""
    rng = np.random.default_rng(seed)
    ch = rng.integers(0, 30, (S, W, 4)).astype(np.int32)
    cl = rng.integers(0, 8, (S, W, 4)).astype(np.int32)
    gap = rng.integers(1, 400000, S).astype(np.int32)
    vt = rng.integers(0, 5, S).astype(np.int8)
    return ch, cl, gap, vt


def _bands(vt):
    S = len(vt)
    tgt = np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]
    valid = tgt < S
    tvt = np.where(valid, np.concatenate([vt, np.zeros(W, np.int8)])[tgt], 0)
    return tvt.astype(np.int8), valid


def _jax_scan(ch, cl, gap, vt, edge_threshold, pallas=False):
    tvt, valid = _bands(vt)
    args = tuple(jnp.asarray(x) for x in (ch, cl, gap, vt, tvt, valid))
    kw = dict(window=W, distance=300000,
              edge_threshold_x10=float(edge_threshold) * 10.0)
    out = vote_scan_pallas(*args, interpret=True, **kw) if pallas \
        else _jax_core(*args, **kw)
    return [np.asarray(x) for x in out]


def _port_scan(ch, cl, gap, vt, edge_threshold):
    out = vote_scan_core(
        *(torch.from_numpy(x) for x in (ch, cl, gap, vt)), window=W,
        distance=300000, edge_threshold_x10=float(edge_threshold) * 10.0)
    return [x.numpy() for x in out]


def _assert_equal(ref, got):
    for name, a, b in zip(("assigned", "hp", "bstart"), ref, got):
        assert a.shape == b.shape, name
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


@pytest.mark.parametrize("edge_threshold", [0.7, 0.33])
@pytest.mark.parametrize("seed,S", [(1, 256), (2, 512), (3, 300), (5, 4096)])
def test_plain_scan_matches_lax_scan(seed, S, edge_threshold):
    ch, cl, gap, vt = _inputs(seed, S)
    _assert_equal(_jax_scan(ch, cl, gap, vt, edge_threshold),
                  _port_scan(ch, cl, gap, vt, edge_threshold))


def test_plain_scan_matches_pallas_interpret():
    ch, cl, gap, vt = _inputs(4, 256)
    _assert_equal(_jax_scan(ch, cl, gap, vt, 0.7, pallas=True),
                  _port_scan(ch, cl, gap, vt, 0.7))


def test_edge_similarity_boundary_is_float32():
    """mn = 33, mx = 100 under edgeThreshold 0.33: in float32,
    10*mn = 330 == f32(3.3)*100 = 330, so the edge is kept. A double-
    precision or FMA-contracted compare sees 330 > 329.99999523 and rejects
    it, which would start a new block at site 1."""
    S = 3
    ch = np.zeros((S, W, 4), np.int32)
    cl = np.zeros((S, W, 4), np.int32)
    ch[0, 0, 0] = 10   # s_para10[0, 0] = 100 (rr, both reads pass qok)
    cl[0, 0, 1] = 33   # s_cross10[0, 0] = 33 (ra, low-quality)
    gap = np.full(S, 100, np.int32)
    vt = np.zeros(S, np.int8)
    assert np.float32(10.0) * np.float32(33) == \
        np.float32(0.33 * 10.0) * np.float32(100)
    ref = _jax_scan(ch, cl, gap, vt, 0.33)
    got = _port_scan(ch, cl, gap, vt, 0.33)
    _assert_equal(ref, got)
    assert got[2][1] == 0 and got[1][1] == 1  # site 1 joined block 0 on hap 1


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor reaches the plain version: any other device goes
    to the kernel wrapper, which raises where it has no kernel."""
    S = 8
    meta = dict(device="meta")
    args = (torch.empty(S, W, dtype=torch.int32, **meta),
            torch.empty(S, W, dtype=torch.int32, **meta),
            torch.empty(S, dtype=torch.int32, **meta),
            torch.empty(S, dtype=torch.int8, **meta))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_scan.vote_scan_pc(*args, S=S, window=W, distance=300000,
                               edge_threshold_x10=7.0)
    assert _build.LAUNCHES == before


def test_plain_scan_checks_shapes():
    ch, cl, gap, vt = _inputs(1, 16)
    with pytest.raises(ValueError, match="gap and vtype"):
        vote_scan_core(*(torch.from_numpy(x) for x in (ch, cl, gap[:-1], vt)),
                       window=W, distance=300000, edge_threshold_x10=7.0)
