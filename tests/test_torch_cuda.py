"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, and builds the kernels with ``nvcc`` on first use. Run on a machine
with the GPU:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from longphase_s_tpu_torch.ops import _build, cuda_scan, fused
from longphase_s_tpu_torch.ops.vote_scan import fold_counts

W = 35
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _scan_inputs(seed, S, dev):
    rng = np.random.default_rng(seed)
    hi = torch.from_numpy(rng.integers(0, 30, (S, W, 4)).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, 8, (S, W, 4)).astype(np.int32))
    s_para10, s_cross10 = fold_counts(hi, lo)
    gap = torch.from_numpy(rng.integers(1, 400000, S).astype(np.int32))
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8))
    return [x.to(dev) for x in (s_para10, s_cross10, gap, vtype)]


@pytest.mark.parametrize("edge_threshold", [0.7, 0.33])
@pytest.mark.parametrize("seed,S", [(1, 1), (2, 33), (3, 300), (4, 4096)])
def test_vote_scan_kernel_matches_plain(cuda_device, seed, S, edge_threshold):
    args = _scan_inputs(seed, S, cuda_device)
    kw = dict(S=S, window=W, distance=300000,
              edge_threshold_x10=edge_threshold * 10.0)
    before = _build.LAUNCHES["vote_scan"]
    got = cuda_scan.vote_scan_pc(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["vote_scan"] == before + 1
    ref = cuda_scan.vote_scan_pc(*(a.cpu() for a in args), **kw)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("window", [1, 32, 33, 64])
def test_vote_scan_kernel_window_edges(cuda_device, window):
    rng = np.random.default_rng(window)
    S = 500
    sums = [torch.from_numpy(rng.integers(0, 300, (S, window))
                             .astype(np.int32)).to(cuda_device)
            for _ in range(2)]
    gap = torch.full((S,), 100, dtype=torch.int32, device=cuda_device)
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8)) \
        .to(cuda_device)
    kw = dict(S=S, window=window, distance=300000, edge_threshold_x10=7.0)
    got = cuda_scan.vote_scan_pc(*sums, gap, vtype, **kw)
    ref = cuda_scan.vote_scan_pc(*(a.cpu() for a in (*sums, gap, vtype)),
                                 **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_vote_scan_kernel_refuses_wide_windows(cuda_device):
    S, window = 8, 65
    z = torch.zeros(S, window, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="W <= 64"):
        cuda_scan.vote_scan_pc(z, z, torch.zeros(S, dtype=torch.int32,
                                                  device=cuda_device),
                               torch.zeros(S, dtype=torch.int8,
                                           device=cuda_device),
                               S=S, window=window, distance=1,
                               edge_threshold_x10=7.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_pack_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed)
    S, n = 2000, 60000
    read = np.sort(rng.integers(0, 1000, n)).astype(np.int32)
    rank = np.empty(n, np.int32)
    for r in np.unique(read):  # contiguous rank runs per read
        idx = np.nonzero(read == r)[0]
        rank[idx] = np.sort(rng.integers(0, S, len(idx)))
    read[-50:] = -1
    allele = rng.integers(0, 2, n).astype(np.int8)
    qok = rng.random(n) < 0.8
    stream = fused.stream_to_device(read, rank, allele, qok, cuda_device)
    before = _build.LAUNCHES["pair_pack"]
    got = fused.pair_sums(*stream, S, W)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair_pack"] == before + 1
    ref = fused.pair_sums(*(x.cpu() for x in stream), S, W)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
