"""Bridge: measured latency table -> planner cost model.

:class:`KBenchConfig` is the serializable knob (``PlannerConfig.kbench`` /
``HarpConfig.kbench``); :class:`KBenchModel` is the live object the planner
builds from it.  The model answers one question for the cost model — "what
MFU does this device *actually* achieve?" — as the flop-weighted achieved
throughput over the device's fresh table cells divided by peak.  That
measured anchor replaces the spec-sheet ``base_mfu`` in ``costmodel._mfu``;
the telemetry ``efficiency`` scale and tp/dp decays still apply on top, so
runtime calibration composes with plan-time measurement.

Fallback semantics (invariant: *fallback never errors*): a device with no
fresh table cells — wrong fingerprint, stale entries, empty table, missing
file — prices exactly as the analytic model; no exception escapes lookup.
``kbench=None`` plans are bit-identical to pre-kbench plans (off-state
invariant, pinned in tests).

Pure Python — no jax.  Collecting tables is ``harness``/``autotune``'s job.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.kbench.table import LatencyTable


@dataclass(frozen=True)
class KBenchConfig:
    """Serializable measured-pricing knob.

    table_path:  JSON latency table on disk (missing file -> empty table,
                 i.e. full analytic fallback, never an error).
    table:       inline table document (``LatencyTable.to_dict`` form) —
                 merged over ``table_path`` when both are given; makes Plan
                 artifacts self-contained.
    max_age_s:   staleness horizon for measurements (0 = never stale).
    device_map:  DeviceProfile.name -> table device fingerprint.  Planner
                 devices are fleet archetypes ("A100-40G") while tables are
                 stamped with what the harness ran on ("gpu:NVIDIA A100...");
                 unmapped names are looked up verbatim.
    """

    table_path: Optional[str] = None
    table: Optional[Dict[str, Any]] = None
    max_age_s: float = 0.0
    device_map: Optional[Dict[str, str]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"table_path": self.table_path, "table": self.table,
                "max_age_s": self.max_age_s, "device_map": self.device_map}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "KBenchConfig":
        return KBenchConfig(
            table_path=d.get("table_path"), table=d.get("table"),
            max_age_s=float(d.get("max_age_s", 0.0)),
            device_map=(None if d.get("device_map") is None
                        else dict(d["device_map"])))


# measured MFU is clamped into a sane band: a corrupted cell can't produce
# a zero/negative denominator or a >100% "efficiency"
_MFU_MIN, _MFU_MAX = 1e-6, 1.0


class KBenchModel:
    """Live measured-pricing model built from a :class:`KBenchConfig`."""

    def __init__(self, cfg: KBenchConfig):
        self.cfg = cfg
        table = LatencyTable()
        if cfg.table_path and os.path.exists(cfg.table_path):
            table = table.merge(LatencyTable.load(cfg.table_path))
        if cfg.table:
            table = table.merge(LatencyTable.from_dict(cfg.table))
        self.table = table
        self._fresh = table.fresh(cfg.max_age_s)
        self._mfu_cache: Dict[str, Optional[float]] = {}

    # -- identity -----------------------------------------------------------

    def fingerprint(self) -> str:
        """Joins the profiler's cost-cache key: everything pricing reads."""
        blob = json.dumps({"table": self._fresh.fingerprint(),
                           "max_age_s": self.cfg.max_age_s,
                           "device_map": self.cfg.device_map},
                          sort_keys=True)
        return "kbench:" + hashlib.sha256(blob.encode()).hexdigest()[:16]

    def device_key(self, profile_name: str) -> str:
        if self.cfg.device_map and profile_name in self.cfg.device_map:
            return self.cfg.device_map[profile_name]
        return profile_name

    # -- pricing ------------------------------------------------------------

    def measured_mfu(self, sub) -> Optional[float]:
        """Achieved MFU for this sub-cluster's device; None = uncovered.

        Flop-weighted over the device's fresh cells: total measured FLOPs /
        total measured seconds, divided by the device's peak.  Cells without
        a FLOP count (flops=0) can't be weighted and are skipped."""
        name = sub.device.name
        if name not in self._mfu_cache:
            self._mfu_cache[name] = self._compute_mfu(sub)
        return self._mfu_cache[name]

    def _compute_mfu(self, sub) -> Optional[float]:
        entries = [e for e in self._fresh.for_device(self.device_key(sub.device.name))
                   if e.flops > 0 and e.median_s > 0]
        if not entries:
            return None
        achieved = sum(e.flops for e in entries) / sum(e.median_s for e in entries)
        return min(_MFU_MAX, max(_MFU_MIN, achieved / sub.device.peak_flops))

    def covered_devices(self) -> Dict[str, float]:
        """Table device fingerprint -> achieved FLOP/s (diagnostics)."""
        out: Dict[str, float] = {}
        for dev in self._fresh.devices():
            entries = [e for e in self._fresh.for_device(dev)
                       if e.flops > 0 and e.median_s > 0]
            if entries:
                out[dev] = (sum(e.flops for e in entries)
                            / sum(e.median_s for e in entries))
        return out

    def estimate_s(self, device_name: str, op: str, shape,
                   flops: Optional[float] = None) -> Optional[float]:
        """Nearest-bucket latency estimate through the device map."""
        return self._fresh.estimate_s(self.device_key(device_name), op,
                                      shape, flops=flops)

    # -- profiler hook ------------------------------------------------------

    def as_measure_fn(self, cfgm=None, comm=None):
        """Adapt the table into the ``ZeroRedundantProfiler.measure_fn``
        contract: ``fn(layers, sub, mesh, mb_tokens) -> StageCost`` priced
        with the measured MFU anchor (analytic fallback when uncovered)."""
        from repro_torch.core.costmodel import CostModelConfig, stage_cost

        cfgm = cfgm if cfgm is not None else CostModelConfig()

        def fn(layers, sub, mesh, mb_tokens):
            return stage_cost(layers, sub, mesh, mb_tokens, cfgm,
                              comm=comm, kbench=self)

        return fn

    def describe(self) -> str:
        lines = [f"kbench table: {len(self.table)} cells "
                 f"({len(self._fresh)} fresh), "
                 f"devices: {', '.join(self.table.devices()) or '(none)'}"]
        for dev, flops in sorted(self.covered_devices().items()):
            lines.append(f"  {dev}: achieved {flops / 1e12:.3f} TFLOP/s")
        return "\n".join(lines)
