"""Flat-array phase path: native ingest arrays -> the device step.

Counterpart of ``longphase_s_tpu/core/fastpath.py:phase_chromosome_flat``
(lines 216-347). The host filters (ONT erasure, overlap filter, CNV
erasure) and the merged observation stream are the JAX package's own
functions, imported; the device step is ``ops/fused.run_fused_phase``.
There is no multichip sink and no fallback to the host packer: a device
error propagates.
"""

from __future__ import annotations

import numpy as np

from longphase_s_tpu.core.fastpath import (_cnv_filter_flat,
                                           filter_overlap_flat,
                                           merge_observations)
from longphase_s_tpu.core.phase_algo import PhaseParams

from ..ops.fused import run_fused_phase


def phase_chromosome_flat(flat: dict, cnv_vec, chrom: str,
                          params: PhaseParams, erased_positions,
                          device) -> dict[str, tuple[str, int]]:
    """Phase one chromosome from the native ingest dict on ``device``.
    Returns ``{"<chrom>_<pos>": ("o|1-o", ps)}`` for the phased sites."""
    obs_pos = flat["obs_pos"]
    obs_allele = flat["obs_allele"]
    obs_qual = flat["obs_qual"]
    aln_offsets = flat["aln_offsets"]
    name_offsets = flat["name_offsets"]
    names_blob = flat["names"]
    A = len(aln_offsets) - 1
    if A == 0:
        return {}
    names = [names_blob[name_offsets[i]:name_offsets[i + 1]] for i in range(A)]

    # ONT erasure of error-prone SNPs; alignments that lose every
    # observation stay as inert entries, as in the reference
    if erased_positions:
        mask = ~np.isin(obs_pos, np.fromiter(erased_positions, np.int64,
                                             len(erased_positions)))
        kept_per_aln = np.add.reduceat(mask.astype(np.int64), aln_offsets[:-1]) \
            if len(mask) else np.zeros(A, np.int64)
        obs_pos = obs_pos[mask]
        obs_allele = obs_allele[mask]
        obs_qual = obs_qual[mask]
        aln_offsets = np.concatenate([[0], np.cumsum(kept_per_aln)])

    # overlap filter over the non-empty alignments
    sizes = np.diff(aln_offsets)
    ne_idx = np.nonzero(sizes > 0)[0]
    keep = np.ones(A, dtype=bool)
    if len(ne_idx):
        first_pos = obs_pos[aln_offsets[:-1][ne_idx]]
        last_pos = obs_pos[aln_offsets[1:][ne_idx] - 1]
        keep[ne_idx] = filter_overlap_flat(
            [names[i] for i in ne_idx], first_pos, last_pos,
            params.overlap_threshold)
    if not keep.all():
        obs_keep = np.repeat(keep, sizes)
        obs_pos = obs_pos[obs_keep]
        obs_allele = obs_allele[obs_keep]
        obs_qual = obs_qual[obs_keep]
        aln_offsets = np.concatenate([[0], np.cumsum(sizes[keep])])
        names = [n for n, k in zip(names, keep) if k]

    # CNV high-mismatch erasure, after the overlap filter
    if cnv_vec:
        obs_pos, obs_allele, obs_qual, aln_offsets = _cnv_filter_flat(
            obs_pos, obs_allele, obs_qual, aln_offsets, cnv_vec)
    if len(obs_pos) == 0:
        return {}

    positions, vtype, _rank, m_read, m_rank, m_allele, m_qok, m_aln = \
        merge_observations(obs_pos, obs_allele, obs_qual, aln_offsets, names,
                           params)
    ps, ori = run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln,
                              positions, vtype, len(aln_offsets) - 1, params,
                              device)
    return {f"{chrom}_{int(positions[i])}":
            (f"{int(ori[i])}|{1 - int(ori[i])}", int(ps[i]))
            for i in np.nonzero(ps)[0]}
