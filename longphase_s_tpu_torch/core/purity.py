"""Tumor purity estimation (TumorPurityEstimator.{h,cpp}).

Pipeline: LCVF filters -> bimodal-valley histogram threshold (Gaussian
smoothing, peak/trend analysis, lowest-valley selection) -> box-plot outlier
removal -> quadratic regression on (median, IQR) of the germline read-HP
imbalance ratio.

The port's copy of ``longphase_s_tpu/core/purity.py``. An estimator built
over one process's contig shard (``sharded``) gathers every process's
feature points and filter tallies (``_merge_distributed``) before its
statistics, and only process 0 writes ``_purity.out``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from dataclasses import dataclass, field

from ..parallel import distributed as dist
from .somatic_types import RH_H1, RH_H2

import numpy as _np

# LCVF constants (TumorPurityEstimator.h:280-284) — declared `constexpr
# float`, so boundary compares happen against the float32 value of 0.7
# (0.69999998...), which flips decisions for exact-0.7 ratios
IMBALANCE_MIN = 0.0
IMBALANCE_NOR_MIN = 0.0
IMBALANCE_NOR_MAX = float(_np.float32(0.7))
PCT_GERMLINE_NOR_MAX = float(_np.float32(0.7))
READ_COUNT_NOR_MIN = 5
THRESHOLD_PERCENTAGE_LIMIT = 0.3  # double in PeakProcessor


@dataclass
class PurityPoint:
    chrom: str
    pos: int
    imbalance: float          # germlineReadHpImbalanceRatio (tumor bam)
    read_count_nor: int       # germlineReadHpCountInNorBam


@dataclass
class FilterCounts:
    imbalance_nor: int = 0
    imbalance: int = 0
    imbalance_nor_max: int = 0
    read_count_nor: int = 0
    pct_germline: int = 0
    peak_valley: int = 0
    outliers: int = 0


@dataclass
class BoxPlot:
    data_size: int = 0
    q1: float = 0.0
    median: float = 0.0
    q3: float = 0.0
    iqr: float = 0.0
    lower: float = 0.0
    upper: float = 0.0
    outliers: int = 0


@dataclass
class Peak:
    index: int = 0
    height: float = 0.0
    left_trend: str = "NONE"
    right_trend: str = "NONE"
    is_main: bool = False


class PurityEstimator:
    def __init__(self, chr_vec, nor_base_by_chr, somatic_info_by_chr,
                 write_log=False, result_prefix="", sharded=False):
        self.chr_vec = chr_vec
        # the per-chr dicts hold this process's contig shard only
        self.sharded = sharded
        self.nor_base = nor_base_by_chr          # chr -> {pos: PosBase}
        self.somatic_info = somatic_info_by_chr  # chr -> {pos: SomaticData}
        self.write_log = write_log
        self.result_prefix = result_prefix
        self.counts = FilterCounts()
        self.initial_data_size = 0
        self.flags: dict[tuple[str, int], bool] = {}
        self.threshold = 0
        self.plot = BoxPlot()

    # ------------------------------------------------------------------
    def estimate(self) -> float:
        print("estimating tumor purity ... ", end="", file=sys.stderr)
        try:
            points = self._merge_distributed(self.build_points())
            if not points:
                raise RuntimeError(
                    "Failed to build purity feature vector: empty vector")
            self.threshold = self.find_bimodal_valley_threshold(points)
            points = self.bimodal_valley_filter(points, self.threshold)
            plot = self.statistic(points)
            for _ in range(1):
                points = self.remove_outliers(points, plot)
                plot = self.statistic(points)
            self.plot = plot
            median, iqr = plot.median, plot.iqr
            purity = (-3.3454 * median + 14.7747 * iqr + 4.0344 * median * median
                      - 13.7777 * median * iqr - 5.2434 * iqr * iqr + 0.3058)
            if purity > 1.0:
                purity = 1.0
            elif purity < 0.0:
                raise RuntimeError(
                    "The value of purity exceeds the model's estimation range")
            print("", file=sys.stderr)
            self.write_result(purity, plot)
            return purity
        except dist.CollectiveError:
            raise  # a failed gather is no local result
        except Exception as e:  # noqa: BLE001 — degrade to 0.0 like the reference
            print(f"[ERROR] {e}", file=sys.stderr)
            print("[ERROR] Failed to estimate tumor purity, set purity to 0.0",
                  file=sys.stderr)
            return 0.0

    def build_points(self) -> list[PurityPoint]:
        """buildPurityFeatureValueVec (TumorPurityEstimator.cpp:92-149)."""
        out = []
        for chrom in self.chr_vec:
            for pos, sd in sorted(self.somatic_info.get(chrom, {}).items()):
                self.initial_data_size += 1
                imb = sd.base.germline_hp_imbalance
                nb = self.nor_base.get(chrom, {}).get(pos)
                h1 = nb.read_hp_count.get(RH_H1, 0) if nb else 0
                h2 = nb.read_hp_count.get(RH_H2, 0) if nb else 0
                nor_count = h1 + h2
                nor_imb = nb.germline_hp_imbalance if nb else 0.0
                nor_pct = nb.pct_germline_hp if nb else 0.0
                if nor_imb == IMBALANCE_NOR_MIN:
                    self.counts.imbalance_nor += 1
                elif imb == IMBALANCE_MIN:
                    self.counts.imbalance += 1
                elif nor_imb >= IMBALANCE_NOR_MAX:
                    self.counts.imbalance_nor_max += 1
                elif nor_count <= READ_COUNT_NOR_MIN:
                    self.counts.read_count_nor += 1
                elif nor_pct <= PCT_GERMLINE_NOR_MAX:
                    self.counts.pct_germline += 1
                else:
                    out.append(PurityPoint(chrom, pos, imb, nor_count))
                    self.flags[(chrom, pos)] = True
        return out  # empty-vector error raised post-merge in estimate()

    def _merge_distributed(self, points):
        """The multi-process merge (JAX purity.py:145-172): all-gather the
        shard's feature points and filter tallies (JSON blobs), so that the
        global median/IQR/histogram of TumorPurityEstimator.cpp:31-84 is
        computed over every contig. Points re-sort into ``chr_vec`` order,
        the one-process scan order. Only for a sharded estimator under an
        active group: an unsharded one already holds every contig."""
        if not (self.sharded and dist.is_active()):
            return points
        blob = json.dumps([[p.chrom, p.pos, p.imbalance, p.read_count_nor]
                           for p in points]).encode()
        merged = []
        for b in dist.allgather_bytes(blob):
            merged.extend(PurityPoint(c, p, i, n)
                          for c, p, i, n in json.loads(b))
        order = {c: i for i, c in enumerate(self.chr_vec)}
        merged.sort(key=lambda p: (order.get(p.chrom, 1 << 30), p.pos))
        tallies = dist.psum_counters(
            {**dataclasses.asdict(self.counts),
             "initial_data_size": self.initial_data_size})
        self.initial_data_size = tallies.pop("initial_data_size")
        self.counts = FilterCounts(**tallies)
        return merged

    # -- histogram / peaks ---------------------------------------------
    def find_bimodal_valley_threshold(self, points) -> int:
        """findBimodalValleyThreshold (TumorPurityEstimator.cpp:158-226)."""
        try:
            counts, pct, max_h, _rng = _build_histogram([p.read_count_nor
                                                         for p in points])
            s_counts = _gaussian_smooth(counts, 0.5)
            s_counts, s_pct, s_max, s_rng = _histogram_stats(s_counts,
                                                             len(points))
            # reference quirk: the smoothed copy keeps the pre-smoothing
            # max_height member (calculateStatistics only raises it), so the
            # original maximum governs both thresholds
            s_max = max(s_max, max_h)
            peak_thr = float(max(int(s_max * 0.05), 1))
            ana = PeakAnalysis()
            ana.find_peaks(s_counts, peak_thr)
            ana.remove_close_peaks(2)
            ana.determine_trends()
            ana.find_main_peak_candidates()
            ana.set_threshold_by_valley(s_counts, s_pct, s_max)
            if self.write_log and self.result_prefix and dist.is_writer():
                ana.write_peak_valley_log(
                    self.result_prefix, counts, pct, s_counts, s_pct,
                    len(points), s_rng, s_max, 0.05, peak_thr, 0.5)
            return ana.threshold
        except Exception as e:  # noqa: BLE001
            print(f"[ERROR] {e}", file=sys.stderr)
            print("[ERROR] Failed to find peak valley threshold, set threshold "
                  "to 0", file=sys.stderr)
            return 0

    def bimodal_valley_filter(self, points, threshold):
        """bimodalValleyFilter (TumorPurityEstimator.cpp:235-247)."""
        kept = []
        for p in points:
            if p.read_count_nor < threshold:
                self.counts.peak_valley += 1
                self.flags[(p.chrom, p.pos)] = False
            else:
                kept.append(p)
        return kept

    def remove_outliers(self, points, plot):
        """removeOutliers (TumorPurityEstimator.cpp:256-272)."""
        kept = []
        for p in points:
            if p.imbalance < plot.lower or p.imbalance > plot.upper:
                self.flags[(p.chrom, p.pos)] = False
                self.counts.outliers += 1
            else:
                kept.append(p)
        return kept

    def statistic(self, points) -> BoxPlot:
        """statisticPurityData (TumorPurityEstimator.cpp:281-344)."""
        plot = BoxPlot()
        plot.data_size = len(points)
        if plot.data_size == 0:
            raise RuntimeError("the data size is 0")
        values = sorted(p.imbalance for p in points)

        def percentile(p):
            pos = p * (plot.data_size - 1)
            idx = int(pos)
            frac = pos - idx
            if idx + 1 >= plot.data_size:
                return values[-1]
            return values[idx] * (1.0 - frac) + values[idx + 1] * frac

        plot.q1 = percentile(0.25)
        plot.median = percentile(0.5)
        plot.q3 = percentile(0.75)
        plot.iqr = plot.q3 - plot.q1
        plot.lower = max(0.0, plot.q1 - 1.5 * plot.iqr)
        plot.upper = plot.q3 + 1.5 * plot.iqr
        plot.outliers = sum(1 for v in values if v < plot.lower or v > plot.upper)
        return plot

    def mark_statistic_flag(self):
        """markStatisticFlag (TumorPurityEstimator.cpp:352-364)."""
        for (chrom, pos), flag in self.flags.items():
            sd = self.somatic_info.get(chrom, {}).get(pos)
            if sd is not None:
                sd.statistic_purity = flag

    def write_result(self, purity, plot):
        """writePurityResult (TumorPurityEstimator.cpp:375-424)."""
        if not self.result_prefix or not dist.is_writer():
            return
        path = self.result_prefix + "_purity.out"
        with open(path, "w") as f:
            f.write("#==================================\n")
            f.write("# TUMOR PURITY ESTIMATION REPORT\n")
            f.write("#==================================\n")
            f.write(f"#Initial data size: {self.initial_data_size}\n")
            f.write("#==========filter parameters==========\n")
            f.write(f"#GERMLINE_HP_IMBALANCE_RATIO_MIN_THR: {IMBALANCE_MIN:g}\n")
            f.write(f"#GERMLINE_HP_IMBALANCE_RATIO_IN_NOR_BAM_MIN_THR: {IMBALANCE_NOR_MIN:g}\n")
            f.write(f"#GERMLINE_HP_IMBALANCE_RATIO_IN_NOR_BAM_MAX_THR: {IMBALANCE_NOR_MAX:g}\n")
            f.write(f"#GERMLINE_HP_PERCENTAGE_IN_NOR_BAM_MAX_THR: {PCT_GERMLINE_NOR_MAX:g}\n")
            f.write(f"#GERMLINE_HP_READ_COUNT_IN_NOR_BAM_MIN_THR: {READ_COUNT_NOR_MIN}\n")
            f.write(f"#GERMLINE_HP_READ_COUNT_IN_NOR_BAM_DYNAMIC_THR: {self.threshold}\n")
            f.write("#==========Initial filter out data count==========\n")
            f.write(f"#imbalanceRatioInNorBam: {self.counts.imbalance_nor}\n")
            f.write(f"#imbalanceRatio: {self.counts.imbalance}\n")
            f.write(f"#imbalanceRatioInNorBam_over_thr: {self.counts.imbalance_nor_max}\n")
            f.write(f"#readHpCountInNorBam: {self.counts.read_count_nor}\n")
            f.write(f"#percentageOfGermlineHpInNorBam: {self.counts.pct_germline}\n")
            f.write("#==========Second filter out data count==========\n")
            f.write(f"#peakValley count: {self.counts.peak_valley}\n")
            f.write("#==========Whisker filter out data count==========\n")
            f.write("#iteration times: 1\n")
            f.write(f"#remove outliers: {self.counts.outliers}\n")
            f.write("#==========Statistical analysis===========\n")
            f.write(f"Data size: {plot.data_size}\n")
            f.write(f"Median: {_fmt(plot.median)}\n")
            f.write(f"Q1: {_fmt(plot.q1)}\n")
            f.write(f"Q3: {_fmt(plot.q3)}\n")
            f.write(f"IQR: {_fmt(plot.iqr)}\n")
            f.write(f"Whiskers: {_fmt(plot.lower)} to {_fmt(plot.upper)}\n")
            f.write(f"Outliers: {plot.outliers}\n")
            f.write("#==========Estimation result===========\n")
            f.write(f"Tumor purity: {_fmt(purity)}\n")


def _fmt(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{x:.6g}"


# ---------------------------------------------------------------------------
# histogram helpers (Histogram / PeakProcessor, TumorPurityEstimator.cpp:426-1031)
# ---------------------------------------------------------------------------

def _build_histogram(read_counts):
    size = 1000
    mx = max(read_counts)
    while mx >= size:
        size *= 2
        if size >= 1000000:
            raise OverflowError("Read count exceeds maximum histogram size")
    counts = [0.0] * size
    for rc in read_counts:
        counts[rc] += 1
    return _histogram_stats(counts, len(read_counts))


def _histogram_stats(counts, total):
    """Histogram::calculateStatistics (TumorPurityEstimator.cpp:478-516)."""
    pct = [0.0] * len(counts)
    total_pct = 0.0
    max_h = 0.0
    first = 0
    last = 0
    loaded_first = False
    for i, c in enumerate(counts):
        total_pct += c / total
        pct[i] = total_pct
        if c > max_h:
            max_h = c
        if not loaded_first and c > 0:
            first = i
            loaded_first = True
        if c > 0:
            last = i
    if max_h == 0:
        raise RuntimeError("max_height is 0 in histogram")
    counts = counts[:last + 1]
    pct = pct[:last + 1]
    return counts, pct, max_h, (first, last)


def _gaussian_smooth(counts, sigma):
    """Histogram::applyGaussianFilter (TumorPurityEstimator.cpp:524-569)."""
    ks = int(6 * sigma + 1)
    if ks % 2 == 0:
        ks += 1
    half = ks // 2
    kernel = [math.exp(-0.5 * ((i - half) / sigma) ** 2) for i in range(ks)]
    s = sum(kernel)
    kernel = [k / s for k in kernel]
    out = []
    n = len(counts)
    for i in range(n):
        v = 0.0
        for j in range(ks):
            if i + j >= half:
                idx = i + j - half
                if idx >= n:
                    idx = n - 1
            else:
                idx = 0
            v += counts[idx] * kernel[j]
        out.append(v)
    return out


def _d6(x) -> str:
    """std::to_string(double): fixed with 6 decimals."""
    return f"{float(x):.6f}"


_INT_MAX = 2**31 - 1


class PeakAnalysis:
    """PeakProcessor with its execution log (TumorPurityEstimator.cpp:640-1201).

    Carries every piece of state the histogram log prints: the peak vector
    with trends, the selected main/secondary/next/prev peaks, the lowest
    valley, and the exec_log strings (std::to_string renders doubles
    fixed-6)."""

    def __init__(self):
        self.exec_log: list[str] = []
        self.peaks: list[Peak] = []
        self.main_peak_count = 0
        self.main_sel = Peak()
        self.sec_sel = Peak()
        self.sec_next = Peak()
        self.sec_pre = Peak()
        # lowestValley (index, height, percentage); findLowestValley resets
        # only the height (to INT_MAX) before searching, as the C++ does
        self.valley_index = 0
        self.valley_height = 0.0
        self.valley_pct = 0.0
        self.threshold_pct = 0.0
        self.threshold = 0

    # -- findPeaks (TumorPurityEstimator.cpp:649-690) -------------------
    def find_peaks(self, counts, min_height):
        peaks = []
        n = len(counts)
        for i in range(n):
            if counts[i] < min_height:
                continue
            is_peak = False
            if i == 0 and i != n - 1:
                is_peak = counts[i] > counts[i + 1]
            elif i == n - 1 and i != 0:
                is_peak = counts[i] > counts[i - 1]
            elif 0 < i < n - 1:
                is_peak = (counts[i] > counts[i - 1]
                           and counts[i] > counts[i + 1])
            if is_peak:
                peaks.append(Peak(i, counts[i]))
        for i, p in enumerate(peaks):
            self.exec_log.append(f"[INFO] Peak {i}: {p.index}, {_d6(p.height)}")
        self.peaks = peaks

    # -- removeClosePeaks (TumorPurityEstimator.cpp:698-721) ------------
    def remove_close_peaks(self, min_distance):
        peaks = self.peaks
        if not peaks:
            raise RuntimeError("No peaks found in peaksVec")
        i = 0
        while i < len(peaks) - 1:
            if peaks[i + 1].index - peaks[i].index < min_distance:
                if peaks[i].height >= peaks[i + 1].height:
                    self.exec_log.append(
                        f"[INFO] remove the peak {peaks[i + 1].index}"
                        f"({_d6(peaks[i + 1].height)}) because it is too close "
                        f"to the peak {peaks[i].index}({_d6(peaks[i].height)})")
                    del peaks[i + 1]
                else:
                    self.exec_log.append(
                        f"[INFO] remove the peak {peaks[i].index}"
                        f"({_d6(peaks[i].height)}) because it is too close "
                        f"to the peak {peaks[i + 1].index}"
                        f"({_d6(peaks[i + 1].height)})")
                    del peaks[i]
            else:
                i += 1

    # -- determineTrends (TumorPurityEstimator.cpp:728-751) -------------
    def determine_trends(self):
        peaks = self.peaks
        if not peaks:
            raise RuntimeError("No peaks found in peaksVec")
        for i in range(len(peaks) - 1):
            if peaks[i].height < peaks[i + 1].height:
                peaks[i].right_trend = "UP"
                peaks[i + 1].left_trend = "UP"
            elif peaks[i].height > peaks[i + 1].height:
                peaks[i].right_trend = "DOWN"
                peaks[i + 1].left_trend = "DOWN"
            else:
                peaks[i].right_trend = "FLAG"
                peaks[i + 1].left_trend = "FLAG"

    # -- findMainPeakCandidates (TumorPurityEstimator.cpp:758-793) ------
    def find_main_peak_candidates(self):
        peaks = self.peaks
        if not peaks:
            raise RuntimeError("No peaks found in peaksVec")
        if len(peaks) == 1:
            self.exec_log.append("[INFO] Only one peak found")
            peaks[0].is_main = True
            self.main_peak_count = 1
            return
        for i, p in enumerate(peaks):
            if i == 0:
                p.is_main = p.right_trend == "DOWN"
            elif i == len(peaks) - 1:
                p.is_main = p.left_trend == "UP"
            else:
                p.is_main = p.left_trend == "UP" and p.right_trend == "DOWN"
            if p.is_main:
                self.main_peak_count += 1

    # -- findLowestValley (TumorPurityEstimator.cpp:911-935) ------------
    def _find_lowest_valley(self, counts, pct, start, end):
        if start >= end or end > len(counts):
            self.exec_log.append(
                f"[ERROR] (findLowestValley) index out of range: "
                f"start: {start} end: {end} histogram.size(): {len(counts)}")
            return False
        found = False
        self.valley_height = float(_INT_MAX)
        for i in range(start + 1, end - 1):
            if counts[i] < counts[i - 1] and counts[i] < counts[i + 1]:
                if not found or counts[i] < self.valley_height:
                    self.valley_index = i
                    self.valley_height = counts[i]
                    self.valley_pct = pct[i]
                    found = True
        return found

    def _reset_valley(self):
        self.valley_index = 0
        self.valley_height = 0.0
        self.valley_pct = 0.0

    def _get_peak(self, index, offset):
        """getPeak (TumorPurityEstimator.cpp:1037-1056)."""
        for i, p in enumerate(self.peaks):
            if p.index == index:
                return self.peaks[i + offset]
        raise RuntimeError(f"Peak not found: histo_index: {index} "
                           f"offset: {offset}")

    # -- setThresholdByValley (TumorPurityEstimator.cpp:944-1031) -------
    def set_threshold_by_valley(self, counts, pct, max_height):
        peaks = self.peaks
        self._reset_valley()
        self.threshold_pct = 0.0
        self.threshold = 0

        # findFirstPriorityMainPeak (TumorPurityEstimator.cpp:800-840)
        main = [p for p in peaks if p.is_main]
        if not main:
            raise RuntimeError("No main peaks found in peaksVec")
        if len(main) == 1:
            main_idx = main[0].index
        else:
            by_height = sorted(main, key=lambda p: -p.height)
            main_idx = max(by_height[0].index, by_height[1].index)
        self.main_sel = self._get_peak(main_idx, 0)
        self.exec_log.append(
            f"[INFO] found the first main peak :{self.main_sel.index}")

        # findSecondaryPeak (TumorPurityEstimator.cpp:850-905)
        sec_idx = None
        found_secondary = False
        if peaks[0].index == main_idx:
            self.exec_log.append(
                "[INFO] the first main peak is the first peak")
        else:
            pi = 0
            while peaks[pi].index != main_idx:
                pi += 1
            pi -= 1
            if pi == 0:
                sec_idx = peaks[0].index
                found_secondary = True
            else:
                while pi > 0:
                    if (peaks[pi].left_trend == "DOWN"
                            and peaks[pi].right_trend == "UP"):
                        sec_idx = peaks[pi].index
                        found_secondary = True
                        break
                    pi -= 1
                if not found_secondary:
                    self.exec_log.append(
                        "[INFO] no secondary peak found, select the first "
                        f"peak as the secondary peak: {peaks[0].index}")
                    sec_idx = peaks[0].index
                    found_secondary = True

        if found_secondary:
            self.sec_sel = self._get_peak(sec_idx, 0)
            self.exec_log.append(
                f"[INFO] found the secondary peak :{self.sec_sel.index}")
            self.exec_log.append(
                "[INFO] check the next peak of the secondary peak")
            self.sec_next = self._get_peak(sec_idx, 1)
            found_valley = self._find_lowest_valley(
                counts, pct, self.sec_sel.index, self.sec_next.index)
            if found_valley:
                self.exec_log.append(
                    f"[INFO] find the lowest height valley: "
                    f"{self.valley_index}({_d6(self.valley_pct)})")
                self.threshold_pct = self.valley_pct
                self.threshold = self.valley_index
            else:
                self.exec_log.append("[INFO] no valley found")

            if self.threshold_pct >= THRESHOLD_PERCENTAGE_LIMIT \
                    or not found_valley:
                self._reset_valley()
                self.threshold_pct = 0.0
                self.threshold = 0
                self.exec_log.append(
                    f"[INFO] threshold >= {_d6(THRESHOLD_PERCENTAGE_LIMIT)}%, "
                    f"reset threshold to {self.threshold}"
                    f"({_d6(self.threshold_pct)})")
                self.exec_log.append(
                    "[INFO] check the pre peak of the secondary peak")
                if self.sec_sel.index != peaks[0].index:
                    self.sec_pre = self._get_peak(self.sec_sel.index, -1)
                    self.exec_log.append(
                        f"[INFO] secondary peak have a pre peak "
                        f"{self.sec_pre.index}->{self.sec_sel.index}")
                    found_valley = self._find_lowest_valley(
                        counts, pct, self.sec_pre.index, self.sec_sel.index)
                    if found_valley:
                        self.exec_log.append(
                            f"[INFO] find the lowest height valley : "
                            f"{self.valley_index}({_d6(self.valley_pct)})")
                        self.threshold_pct = self.valley_pct
                        self.threshold = self.valley_index
                    else:
                        self.exec_log.append(
                            "[INFO] no valley found between the secondary "
                            "peak and its pre peak")
                else:
                    self.exec_log.append("[INFO] no pre peak found")
        else:
            self.exec_log.append("[INFO] no secondary peak found")

        # a valley that cannot separate the two distributions
        if self.valley_height > max_height * 0.7:
            self.exec_log.append(
                f"[INFO] valley height is too high, set the threshold to 0: "
                f"valley height: {_d6(self.valley_height)} "
                f"max height: {_d6(max_height)}")
            self.threshold_pct = 0.0
            self.threshold = 0
        if self.threshold_pct >= THRESHOLD_PERCENTAGE_LIMIT:
            self.exec_log.append(
                f"[INFO] Final threshold over {_d6(THRESHOLD_PERCENTAGE_LIMIT)}"
                f"%, set to 0: {self.threshold}({_d6(self.threshold_pct)})")
            self.threshold_pct = 0.0
            self.threshold = 0
        self.exec_log.append(
            f"[INFO] Final threshold: {self.threshold}"
            f"({_d6(self.threshold_pct)})")

    # -- writePeakValleyLog (TumorPurityEstimator.cpp:1095-1201) --------
    def write_peak_valley_log(self, result_prefix, counts, pct, s_counts,
                              s_pct, total_snp_count, data_range, max_height,
                              min_peak_ratio, peak_threshold, sigma):
        """Writes _germlineReadHpCountInNorBam_histogram.out. The fixed<<
        setprecision(2) manipulator set by the smoothed-histogram loop is
        sticky, so every later double (raw histogram, peak heights, valley
        percentage) also prints fixed-2."""
        path = result_prefix + "_germlineReadHpCountInNorBam_histogram.out"
        with open(path, "w") as f:
            f.write(f"#total snp count: {total_snp_count}\n")
            f.write(f"#data range: {data_range[0]} to {data_range[1]}\n")
            f.write(f"#max height: {_fmt(max_height)}\n")
            f.write(f"#min peak ratio: {_fmt(min_peak_ratio)}\n")
            f.write(f"#peak threshold: {_fmt(peak_threshold)}\n")
            f.write(f"#gaussian filter sigma: {_fmt(sigma)}\n")
            f.write("#========Execution Log==========\n")
            for log in self.exec_log:
                f.write(f"#{log}\n")
            f.write("\nindex (germline Hp read count in normal bam), "
                    "height (snp count), percentage\n\n")
            f.write("#Smoothed Histogram Start\n")
            for i in range(len(s_counts)):
                f.write(f"{i}\t{s_counts[i]:.2f}\t{s_pct[i]:.2f}\n")
            f.write("#Smoothed Histogram End\n\n")
            f.write("#Histogram Start\n")
            for i in range(len(counts)):
                f.write(f"{i}\t{counts[i]:.2f}\t{pct[i]:.2f}\n")
            f.write("#Histogram End\n\n")
            f.write("\n#==========Peak Trend Analysis==========\n")
            f.write(f"#peak count: {len(self.peaks)}\n")
            f.write(f"#Peak \t{'Position':<10}\t{'Height':<10}\t"
                    f"{'Left_Trend':<10}\t{'Right_Trend':<10}\n")
            for i, p in enumerate(self.peaks):
                f.write(f"{i + 1}\t{p.index:<10}\t{f'{p.height:.2f}':<10}\t"
                        f"{p.left_trend:<10}\t{p.right_trend:<10}\n")
            f.write("\n#==========Main Peak Analysis==========\n")
            if self.main_peak_count == 0:
                f.write("#main peak count: 0\n")
            else:
                f.write(f"#main peak count: {self.main_peak_count}\n")
                f.write(f"#Peak \t{'Position':<10}\t{'Height':<10}\t"
                        f"{'Left_Trend':<10}\t{'Right_Trend':<10}\n")
                # the row label increments for every peak, main or not
                for i, p in enumerate(self.peaks):
                    if p.is_main:
                        f.write(f"{i + 1}\t{p.index:<10}\t"
                                f"{f'{p.height:.2f}':<10}\t"
                                f"{p.left_trend:<10}\t{p.right_trend:<10}\n")
            f.write("\n#==========Selected Peaks & Valleys==========\n")
            for label, p in (("#first main peak         : ", self.main_sel),
                             ("#secondary peak          : ", self.sec_sel),
                             ("#secondary peak next peak: ", self.sec_next),
                             ("#secondary peak prev peak: ", self.sec_pre)):
                f.write(f"{label}{p.index}\t{p.height:.2f}\t"
                        f"{p.left_trend}\t{p.right_trend}\n")
            f.write(f"#lowest height valley    : {self.valley_index}\t"
                    f"{self.valley_pct:.2f}\n")
            f.write(f"#threshold percentage: {self.threshold_pct:.2f}\n")
            f.write(f"#threshold: {self.threshold}\n")
