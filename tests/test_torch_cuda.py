"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the tag-family reductions on the card against the same calls on the CPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, and builds the kernels with ``nvcc`` on first use. Run on a machine
with the GPU:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from longphase_s_tpu_torch.ops import _build, cuda_scan, fused, tag_kernels
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
    before = dict(_build.LAUNCHES)
    got = cuda_scan.vote_scan_pc(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["vote_cast"] == before["vote_cast"] + 1
    assert _build.LAUNCHES["vote_scan"] == before["vote_scan"] + 1
    ref = cuda_scan.vote_scan_pc(*(a.cpu() for a in args), **kw)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("S,window", [(500, 1), (500, 32), (500, 33),
                                      (500, 64), (500, 65), (500, 100),
                                      (500, 128), (500, 129), (500, 200),
                                      (2000, 1000), (50, 100), (2, 300)])
def test_vote_scan_kernel_window_edges(cuda_device, S, window):
    """Every ring layout: 1-4 register slots a lane (W <= 128), the
    shared-memory ring above, and windows cut to S-1 on short chromosomes
    (strided staging)."""
    rng = np.random.default_rng(window + S)
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


# every ring layout of the serial kernel, and windows wider than the
# chromosome (W > S), which both steps cut to S-1
KERNEL_CASES = [(400, w) for w in (1, 31, 32, 33, 35, 64, 65, 100, 128, 129,
                                   200)] + [(50, 100), (2, 300), (33, 40)]


def _window_inputs(S, window, dev):
    rng = np.random.default_rng(window * 7 + S)
    sums = [torch.from_numpy(rng.integers(0, 300, (S, window))
                             .astype(np.int32)).to(dev) for _ in range(2)]
    gap = torch.from_numpy(rng.choice([100, 400000], S, p=[0.95, 0.05])
                           .astype(np.int32)).to(dev)
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8)).to(dev)
    return (*sums, gap, vtype)


@pytest.mark.parametrize("S,window", KERNEL_CASES)
def test_vote_cast_kernel_matches_plain(cuda_device, S, window):
    args = _window_inputs(S, window, cuda_device)
    kw = dict(S=S, window=window, distance=300000, edge_threshold_x10=3.3)
    before = _build.LAUNCHES["vote_cast"]
    codes, site = cuda_scan.vote_codes(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["vote_cast"] == before + 1
    ref_codes, ref_site = cuda_scan.vote_codes_plain(*args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(site, ref_site)


@pytest.mark.parametrize("S,window", KERNEL_CASES)
def test_vote_serial_kernel_matches_plain(cuda_device, S, window):
    args = _window_inputs(S, window, cuda_device)
    codes, site = cuda_scan.vote_codes_plain(
        *args, S=S, window=window, distance=300000, edge_threshold_x10=7.0)
    before = _build.LAUNCHES["vote_scan"]
    got = cuda_scan.vote_serial(codes, site, S, window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["vote_scan"] == before + 1
    ref = cuda_scan.vote_serial_plain(codes.cpu(), site.cpu(), S, window)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_vote_scan_kernel_refuses_empty_window(cuda_device):
    S = 8
    z = torch.zeros(S, 0, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="window must be >= 1"):
        cuda_scan.vote_scan_pc(z, z, torch.zeros(S, dtype=torch.int32,
                                                  device=cuda_device),
                               torch.zeros(S, dtype=torch.int8,
                                           device=cuda_device),
                               S=S, window=0, distance=1,
                               edge_threshold_x10=7.0)


def _pair_stream(rng, S, shuffle_reads):
    """A 20x merged stream over S sites: reads of 1-90 contiguous ranks
    with 5% of calls dropped, 3% of rows repeated as split alignments
    with a random allele, 50 trailing m_read == -1 rows; with
    ``shuffle_reads`` the reads come in random order."""
    n_reads = max(2, S * 20 // 60)
    lengths = rng.integers(1, 91, n_reads)
    starts = rng.integers(0, S, n_reads)
    read, rank = [], []
    for r in (rng.permutation(n_reads) if shuffle_reads else range(n_reads)):
        ranks = np.arange(starts[r], min(S, starts[r] + lengths[r]))
        ranks = ranks[rng.random(len(ranks)) > 0.05]
        ranks = np.repeat(ranks, np.where(rng.random(len(ranks)) < 0.03, 2, 1))
        read.append(np.full(len(ranks), r))
        rank.append(ranks)
    read = np.concatenate(read + [np.full(50, -1)]).astype(np.int32)
    rank = np.concatenate(rank + [np.zeros(50, int)]).astype(np.int32)
    allele = rng.integers(0, 2, len(read)).astype(np.int8)
    qok = rng.random(len(read)) < 0.9
    return read, rank, allele, qok


@pytest.mark.parametrize("shuffle_reads", [False, True])
@pytest.mark.parametrize("window", [1, 32, 33, 35, 100, 128, 129, 200])
@pytest.mark.parametrize("S", [1, 33, 300, 4096, 16384])
def test_pair_cast_kernel_matches_plain(cuda_device, S, window,
                                        shuffle_reads):
    """Every tile height the kernel picks (T = 128 down to 8 over these
    windows), windows cut to S-1 (W > S), duplicates, padding and any read
    order; one launch of each of the three kernels a call."""
    rng = np.random.default_rng(S * 1000 + window * 2 + shuffle_reads)
    stream = fused.stream_to_device(*_pair_stream(rng, S, shuffle_reads),
                                    cuda_device)
    gap = torch.from_numpy(rng.choice([100, 400000], S, p=[0.95, 0.05])
                           .astype(np.int32)).to(cuda_device)
    vtype = torch.from_numpy(rng.integers(0, 5, S).astype(np.int8)) \
        .to(cuda_device)
    kw = dict(S=S, window=window, distance=300000, edge_threshold_x10=3.3)
    before = dict(_build.LAUNCHES)
    codes, site = fused.pair_codes(stream, gap, vtype, **kw)
    torch.cuda.synchronize()
    for name in ("bucket_count", "bucket_scatter", "pair_cast"):
        assert _build.LAUNCHES[name] == before[name] + 1, name
    ref_codes, ref_site = fused.pair_codes_plain(stream, gap, vtype, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(site, ref_site)
    if S >= 300:  # random alleles: few pairs decide at W = 1
        assert int((codes != 0).sum()) > 10


def test_pair_cast_refuses_a_window_too_wide_for_shared_memory(cuda_device):
    S = 40000
    stream = fused.stream_to_device(np.zeros(4, np.int32),
                                    np.arange(4, dtype=np.int32),
                                    np.zeros(4, np.int8), np.ones(4, bool),
                                    cuda_device)
    gap = torch.full((S,), 100, dtype=torch.int32, device=cuda_device)
    vtype = torch.zeros(S, dtype=torch.int8, device=cuda_device)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="too wide"):
        fused.pair_codes(stream, gap, vtype, S, 30000, 300000, 7.0)
    assert _build.LAUNCHES == before


def _tag_walk(rng, S, A, No):
    bases = np.frombuffer(b"ACGTN", np.uint8)
    walk = {"obs_var": rng.integers(0, S, No).astype(np.int32),
            "obs_aln": np.sort(rng.integers(0, A, No)).astype(np.int32),
            "obs_aux": rng.integers(0, 4, No).astype(np.int32),
            "obs_base": bases[rng.integers(0, 5, No)],
            "obs_flags": rng.integers(0, 16, No).astype(np.uint8),
            "obs_kind": rng.integers(0, 3, No).astype(np.uint8),
            "category": np.zeros(A, np.uint8)}
    t = {"pos": np.arange(S, dtype=np.int64) * 10}
    for key in tag_kernels.SOMATIC_ROWS + tag_kernels.GERMLINE_ROWS:
        if key.endswith("ps"):
            t[key] = rng.integers(1, 6, S).astype(np.int64) * 1000
        elif key.endswith(("vt", "vtype")):
            t[key] = rng.integers(0, 4, S).astype(np.int8)
        elif key.endswith("gt"):
            t[key] = rng.integers(-1, 3, S).astype(np.int8)
        elif key == "derive":
            t[key] = rng.integers(0, 3, S).astype(np.int8)
        elif key in tag_kernels._BOOL_ROWS:
            t[key] = rng.random(S) < 0.7
        else:
            t[key] = bases[rng.integers(0, 4, S)]
    return walk, t


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        a, b = list(a.values()), list(b.values())
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["germline", "normal", "extract",
                                  "haplotag"])
def test_tag_reductions_on_the_card_match_the_cpu(cuda_device, mode):
    rng = np.random.default_rng(7)
    walk, t = _tag_walk(rng, 3000, 2500, 200_000)
    gate = rng.random(200_000) < 0.9
    name = "germline" if mode == "germline" else f"somatic_{mode}"
    before = tag_kernels.DEVICE_CALLS[name]
    outs = []
    for dev in (cuda_device, "cpu"):
        if mode == "germline":
            outs.append(tag_kernels.germline_counts(walk, t, True, gate=gate,
                                                    device=dev))
        else:
            outs.append(tag_kernels.somatic_counts(
                walk, t, mode, is_som=t["is_som"], derive=t["derive"],
                gate=gate,
                want_posbase=mode != "haplotag",
                want_derive=mode == "haplotag", ref_nonempty=True,
                device=dev))
    assert tag_kernels.DEVICE_CALLS[name] == before + 1
    _same(outs[1], outs[0])
