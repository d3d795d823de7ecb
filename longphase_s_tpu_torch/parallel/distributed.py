"""Single-process stand-in for ``longphase_s_tpu/parallel/distributed.py``.

The JAX shim asks ``jax._src.distributed`` on every call; the port runs
one process, so every query answers for a run of one. The API is the same
so that the pipelines read alike. Multi-host contig sharding (``--dist``
or ``LPS_DIST``) is not ported yet and raises instead of being ignored.
"""

from __future__ import annotations

import os


def init_from_spec(spec: str) -> None:
    """Refuse a ``"host:port,nprocs,pid"`` spec: multi-host is not ported."""
    if spec:
        raise NotImplementedError(
            f"multi-host phasing ({spec!r}) is not ported to the PyTorch "
            "package yet; run without --dist / LPS_DIST")


def maybe_init_from_env() -> None:
    init_from_spec(os.environ.get("LPS_DIST", ""))


def is_active() -> bool:
    return False


def process_id() -> int:
    return 0


def is_writer() -> bool:
    return True


def shard_contigs(contigs):
    return list(contigs)


def merge_chr_results(chr_results: dict) -> dict:
    return chr_results
