"""Multi-process contig sharding over a ``torch.distributed`` gloo group.

Counterpart of ``longphase_s_tpu/parallel/distributed.py``, with the same
API and the same blob encodings, so that a blob means the same thing on
both sides:

- every process ingests and phases only its contig shard (round-robin over
  the VCF contig order: contig sizes are long-tailed, and round-robin
  spreads the big ones),
- per-contig results are small next to the BAMs, so the merge is an
  all-gather of serialised result blobs (a plain union: the shards are
  disjoint),
- every process ends with the full merged result; process 0 writes the
  files.

Activation: ``LPS_DIST=host:port,nprocs,pid`` in the environment, or
``--dist`` on any subcommand. The group is gloo on CPU tensors: what
crosses processes is host bytes (result blobs, purity points, counters),
and gloo, unlike NCCL, lets several processes share one card. Each process
runs its device step on its own card (``local_device``).

A process cannot hang forever: joining the group and every collective run
under the group's timeout (``LPS_DIST_TIMEOUT`` seconds, default 1800), a
peer that dies makes the others' next collective raise ``CollectiveError``,
and the group is torn down at exit.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import time

import numpy as np

_initialized = False
DEFAULT_TIMEOUT_S = 1800
# what this process moved through allgather_bytes under a group: its blobs
# (sent), the padded payload round it received and the seconds spent in
# both rounds (waiting for the slowest peer included); the rest of a
# merge's wall is encoding and decoding
GATHERED = {"calls": 0, "sent": 0, "received": 0, "seconds": 0.0}


class CollectiveError(RuntimeError):
    """A collective of the group failed: a peer died or timed out."""


def parse_spec(spec: str):
    """``"host:port,nprocs,pid"`` -> (coordinator, nprocs, pid)."""
    coord, nprocs, pid = spec.rsplit(",", 2)
    return coord, int(nprocs), int(pid)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(
        os.environ.get("LPS_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def init_from_spec(spec: str) -> None:
    """Join the gloo group of an LPS_DIST-style spec, once a process. A
    spec of one process forms no group and runs like no spec at all; a
    group of more that cannot form raises."""
    global _initialized
    if _initialized or not spec:
        return
    coord, nprocs, pid = parse_spec(spec)
    host, _, port = coord.rpartition(":")
    if not host or not port.isdigit() or not 0 <= pid < nprocs:
        raise ValueError(f"bad dist spec {spec!r}: want HOST:PORT,NPROCS,PID "
                         "with 0 <= PID < NPROCS")
    if nprocs > 1:
        import torch.distributed as td

        if host in ("127.0.0.1", "localhost"):
            # every process is on this host: keep gloo's pairs on loopback
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        td.init_process_group("gloo", init_method=f"tcp://{coord}",
                              world_size=nprocs, rank=pid,
                              timeout=_timeout())
        atexit.register(_teardown)
    _initialized = True


def _teardown() -> None:
    import torch.distributed as td

    if td.is_initialized():
        td.destroy_process_group()


def maybe_init_from_env() -> None:
    init_from_spec(os.environ.get("LPS_DIST", ""))


def is_active() -> bool:
    """A group of more than one process is formed; creates nothing."""
    import torch.distributed as td

    return td.is_available() and td.is_initialized() \
        and td.get_world_size() > 1


def process_id() -> int:
    import torch.distributed as td

    return td.get_rank() if is_active() else 0


def process_count() -> int:
    import torch.distributed as td

    return td.get_world_size() if is_active() else 1


def is_writer() -> bool:
    """Only one process writes output files (they land on a shared FS)."""
    return process_id() == 0


def shard_contigs(contigs):
    """Round-robin contig shard for this process (stable across processes:
    everyone shards the same VCF-ordered contig list)."""
    n, p = process_count(), process_id()
    return [c for i, c in enumerate(contigs) if i % n == p]


def local_device(device):
    """The device this process runs its device step on: under an active
    group a bare ``"cuda"`` becomes ``cuda:{pid % device_count}``, the
    port's form of JAX's per-process ``jax.local_devices()``; ``"cuda:N"``,
    ``"cpu"`` and a host without a card stay as given (``resolve_device``
    raises for the last)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not is_active():
        return device
    n = torch.cuda.device_count()
    return torch.device("cuda", process_id() % n) if n else device


def local_device_count() -> int:
    """The CUDA devices this process owns: every visible one, or under an
    active group the one ``local_device`` picks (the shards are disjoint,
    so a process batches its contigs on its own card only)."""
    import torch

    n = torch.cuda.device_count()
    return min(n, 1) if is_active() else n


def _all_gather(tensor):
    """``all_gather`` of one CPU tensor a process, a failure raised as
    ``CollectiveError``."""
    import torch
    import torch.distributed as td

    out = [torch.empty_like(tensor) for _ in range(td.get_world_size())]
    try:
        td.all_gather(out, tensor)
    except Exception as e:  # noqa: BLE001 — re-raised as one type
        raise CollectiveError(f"all_gather failed on process "
                              f"{td.get_rank()}: {e}") from e
    return out


def allgather_bytes(blob: bytes) -> list[bytes]:
    """All-gather one variable-length byte blob per process, in process
    order (two rounds: int64 lengths, then uint8 payloads padded to the
    longest). Without an active group: ``[blob]``."""
    if not is_active():
        return [blob]
    import torch

    t0 = time.perf_counter()
    lens = [int(t) for t in _all_gather(torch.tensor([len(blob)],
                                                     dtype=torch.int64))]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if blob:
        buf[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    gathered = _all_gather(buf)
    GATHERED["calls"] += 1
    GATHERED["sent"] += len(blob)
    GATHERED["received"] += len(buf) * len(gathered)
    GATHERED["seconds"] += time.perf_counter() - t0
    return [t[:n].numpy().tobytes() for t, n in zip(gathered, lens)]


def allgather_f64(values) -> np.ndarray:
    """All-gather variable-length float64 vectors, concatenated in process
    order."""
    blobs = allgather_bytes(np.asarray(values, np.float64).tobytes())
    return np.concatenate([np.frombuffer(b, np.float64) for b in blobs])


def psum_counters(counters: dict) -> dict:
    """Sum integer counter dicts across processes (JSON blobs)."""
    merged: dict = {}
    for blob in allgather_bytes(json.dumps(
            {k: int(v) for k, v in counters.items()}).encode()):
        for k, v in json.loads(blob).items():
            merged[k] = merged.get(k, 0) + v
    return merged


def merge_chr_results(chr_results: dict) -> dict:
    """Union per-contig phase results ``{chrom: {key: (gt, ps)}}`` across
    processes (JSON blobs). Contig shards are disjoint, so the union is
    exact."""
    blob = json.dumps({
        chrom: {k: [v[0], v[1]] for k, v in result.items()}
        for chrom, result in chr_results.items()}).encode()
    merged: dict = {}
    for b in allgather_bytes(blob):
        for chrom, result in json.loads(b).items():
            merged[chrom] = {k: (v[0], int(v[1])) for k, v in result.items()}
    return merged
