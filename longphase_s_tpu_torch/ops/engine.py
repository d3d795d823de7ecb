"""Object-path phasing engine: filtered alignments -> phased sites.

Counterpart of ``longphase_s_tpu/ops/engine.py:phase_chromosome_tpu``. The
phase pipeline takes this path when the native ingest library declines a
BAM (``native.extract_phase`` returns None); the flat path is
``core/fastpath.phase_chromosome_flat``.
"""

from __future__ import annotations

import numpy as np

from longphase_s_tpu.core import phase_algo
from longphase_s_tpu.core.matrix import pack_chromosome
from longphase_s_tpu.core.phase_algo import PhaseParams
from longphase_s_tpu.ops.read_correction import read_correction_packed

from .vote_scan import run_vote_scan


def phase_chromosome_device(alns, cnv_vec, chrom: str, params: PhaseParams,
                            device) -> dict[str, tuple[str, int]]:
    """Overlap and CNV filters on the host, pair counts on the host, the
    vote scan on ``device``, read correction on the host. Returns
    ``{"<chrom>_<pos>": ("o|1-o", ps)}`` for the phased sites."""
    alns = phase_algo.filter_overlap_alignments(alns, params.overlap_threshold)
    phase_algo.cnv_mismatch_filter(alns, cnv_vec)
    packed = pack_chromosome(alns, params)
    if packed is None:
        return {}
    ps, ori = run_vote_scan(packed, params, device)
    ps, ori, _read_hp = read_correction_packed(packed, ps, ori, params)
    return {f"{chrom}_{int(packed.positions[i])}":
            (f"{int(ori[i])}|{1 - int(ori[i])}", int(ps[i]))
            for i in np.nonzero(ps)[0]}
