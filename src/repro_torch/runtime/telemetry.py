"""Online calibration: measured step/stage times -> EWMA efficiency factors.

The planner's cost model predicts per-stage times from ``DeviceProfile``
specs scaled by ``device.efficiency``.  On a live fleet the prediction
drifts — thermal throttling, noisy neighbors, background daemons.  The
calibrator folds measurements back into per-sub-cluster efficiency estimates:

    eff_est = eff_used_at_plan_time * t_predicted / t_measured

EWMA-smoothed per sub-cluster.  ``calibrated(cluster)`` returns a cluster
value with the estimates applied (only when outside the deadband, so noise
does not thrash the plan cache), and ``drift(cluster)`` is the controller's
replan trigger signal.

**Bandwidth tiers** calibrate the same way (:meth:`observe_comm`): a
measured transfer/collective time against its prediction yields a per-tier
bandwidth estimate —

    bw_est = bw_assumed_at_plan_time * t_predicted / t_measured

for the ``"cross"`` WAN link or a named sub-cluster's inter-node fabric.
Since the comm subsystem selects collective algorithms *from* these
bandwidths, a calibrated shift propagates through ``calibrated()`` ->
controller replan -> fresh ``CommModel`` -> re-selected algorithms (e.g. a
congested WAN tips the gradient sync from ring to two-level hierarchical).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.cluster import (
    HeteroCluster, set_efficiency, set_inter_node_bw, subcluster_index,
    with_cross_bw,
)
from repro_torch.core.strategy import ParallelStrategy

CROSS = "cross"        # the tier name of the shared cross-cluster WAN link


@dataclass
class StepObservation:
    step: int
    step_time: float                          # measured wall time (s)
    stage_times: Optional[List[float]] = None  # per-stage f+b per microbatch


class TelemetryCalibrator:
    def __init__(self, alpha: float = 0.25, deadband: float = 0.05,
                 min_efficiency: float = 0.05):
        self.alpha = alpha
        self.deadband = deadband
        self.min_efficiency = min_efficiency
        self._eff: Dict[str, float] = {}       # sub-cluster name -> EWMA estimate
        self._bw: Dict[str, float] = {}        # CROSS | sub-cluster name ->
                                               # EWMA bytes/s (inter-node tier)
        self.n_observations = 0

    # -- folding measurements ------------------------------------------------

    def _fold(self, name: str, current_eff: float, est: float):
        est = max(self.min_efficiency, est)
        prev = self._eff.get(name, current_eff)
        self._eff[name] = (1 - self.alpha) * prev + self.alpha * est

    def seed_from_kbench(self, cluster: HeteroCluster,
                         kbench) -> Dict[str, float]:
        """Seed the EWMA efficiency anchors from a measured kernel table.

        The first ``observe()`` normally anchors each sub-cluster at its
        modeled efficiency (effectively 1.0 on an uncalibrated fleet); with
        a :class:`repro_torch.kbench.bridge.KBenchModel` (or ``KBenchConfig``)
        covering a device, the anchor becomes the *implied* efficiency —
        measured achieved MFU over the analytic ``base_mfu`` — so the first
        EWMA fold starts from measurement instead of optimism.  Uncovered
        sub-clusters and already-seeded names are left alone.  Returns the
        seeds applied.

        Intended for fleets whose plan was priced *analytically*: when the
        plan itself already used kbench pricing, predicted stage times
        include the measured anchor and seeding here would double-count the
        same correction."""
        from repro_torch.kbench.bridge import KBenchConfig, KBenchModel

        if isinstance(kbench, KBenchConfig):
            kbench = KBenchModel(kbench)
        seeded: Dict[str, float] = {}
        for sub in cluster.subclusters:
            if sub.name in self._eff:
                continue
            measured = kbench.measured_mfu(sub)
            if measured is None:
                continue
            est = max(self.min_efficiency, measured / sub.device.base_mfu)
            self._eff[sub.name] = est
            seeded[sub.name] = est
        return seeded

    def observe(self, cluster: HeteroCluster, strategy: ParallelStrategy,
                obs: StepObservation):
        """Fold one step's measurement.  ``cluster`` must be the cluster the
        strategy was PLANNED on — its efficiencies are what the predictions
        assume, so they anchor the estimate (anchoring to an
        already-calibrated value would compound the correction).  With
        per-stage times, each stage calibrates its own sub-cluster; with only
        the aggregate step time, the global predicted/measured ratio is
        attributed to every sub-cluster the strategy runs on (coarse but
        unbiased)."""
        self.n_observations += 1
        if obs.stage_times:
            for s, t_meas in zip(strategy.stages, obs.stage_times):
                if t_meas <= 0 or s.t <= 0:
                    continue
                sub = cluster.subclusters[s.cluster_idx]
                self._fold(sub.name, sub.device.efficiency,
                           sub.device.efficiency * s.t / t_meas)
        elif obs.step_time > 0 and strategy.est_step_time > 0:
            ratio = strategy.est_step_time / obs.step_time
            for name in {cluster.subclusters[s.cluster_idx].name
                         for s in strategy.stages}:
                i = subcluster_index(cluster, name)
                eff = cluster.subclusters[i].device.efficiency
                self._fold(name, eff, eff * ratio)

    def observe_comm(self, cluster: HeteroCluster, link: str,
                     predicted_s: float, measured_s: float):
        """Fold one measured transfer/collective against its prediction for
        a bandwidth tier: ``link`` is :data:`CROSS` (the WAN) or a
        sub-cluster name (its inter-node fabric).  ``cluster`` must be the
        fleet the prediction was priced on — its bandwidth anchors the
        estimate, exactly like efficiency calibration."""
        if predicted_s <= 0 or measured_s <= 0:
            return
        self.n_observations += 1
        if link == CROSS:
            assumed = cluster.cross_bw
        else:
            assumed = cluster.subclusters[
                subcluster_index(cluster, link)].inter_node_bw
        est = max(1.0, assumed * predicted_s / measured_s)
        prev = self._bw.get(link, assumed)
        self._bw[link] = (1 - self.alpha) * prev + self.alpha * est

    # -- reading the calibration --------------------------------------------

    def efficiency(self, name: str, default: float = 1.0) -> float:
        return self._eff.get(name, default)

    def bandwidth(self, link: str, default: float = 0.0) -> float:
        """Calibrated bytes/s estimate for a tier (see :meth:`observe_comm`)."""
        return self._bw.get(link, default)

    def _bw_current(self, cluster: HeteroCluster, link: str
                    ) -> Optional[float]:
        if link == CROSS:
            return cluster.cross_bw
        try:
            return cluster.subclusters[
                subcluster_index(cluster, link)].inter_node_bw
        except KeyError:
            return None        # the sub-cluster left the fleet

    def drift(self, cluster: HeteroCluster) -> float:
        """Largest relative gap between the fleet's modeled parameters
        (per-sub-cluster efficiency, per-tier bandwidth) and the calibrated
        estimates.  The controller replans when this exceeds its
        threshold."""
        worst = 0.0
        for s in cluster.subclusters:
            if s.name not in self._eff:
                continue
            cur = s.device.efficiency
            worst = max(worst, abs(self._eff[s.name] - cur) / max(cur, 1e-9))
        for link, est in self._bw.items():
            cur = self._bw_current(cluster, link)
            if cur is not None:
                worst = max(worst, abs(est - cur) / max(cur, 1e-9))
        return worst

    def calibrated(self, cluster: HeteroCluster) -> HeteroCluster:
        """Cluster value with estimates applied (deadband-gated per
        sub-cluster: small drifts keep the modeled value so equal-fingerprint
        plan-cache hits survive noise)."""
        out = cluster
        for s in cluster.subclusters:
            est = self._eff.get(s.name)
            if est is None:
                continue
            cur = s.device.efficiency
            if abs(est - cur) / max(cur, 1e-9) > self.deadband:
                out = set_efficiency(out, s.name, est)
        for link, est in self._bw.items():
            cur = self._bw_current(out, link)
            if cur is None:
                continue
            if abs(est - cur) / max(cur, 1e-9) > self.deadband:
                out = with_cross_bw(out, est) if link == CROSS \
                    else set_inter_node_bw(out, link, est)
        return out

    def reset(self, name: Optional[str] = None):
        """Forget estimates (e.g. after hardware replacement)."""
        if name is None:
            self._eff.clear()
            self._bw.clear()
        else:
            self._eff.pop(name, None)
            self._bw.pop(name, None)

    def reset_bandwidth(self, link: Optional[str] = None):
        """Forget bandwidth estimates only (a committed bandwidth change
        supersedes the EWMA history for that tier)."""
        if link is None:
            self._bw.clear()
        else:
            self._bw.pop(link, None)
