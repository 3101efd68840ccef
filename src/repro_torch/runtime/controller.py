"""ElasticController: the offline HAPT planner closed into a runtime loop.

Owns the current ``HeteroCluster`` + ``ParallelStrategy``, consumes cluster
events, and picks the *cheapest sufficient* response:

1. **warm-up retune** — a bandwidth-only change leaves stage placement and
   compute untouched; recompute inter-stage comm times and the H-1F1B
   warm-up counts (§4) in place.  Near-free.
2. **incremental re-search** — the DP re-runs, warm-started from the shared
   stage-cost cache (``ZeroRedundantProfiler.cost_cache``): only meshes of
   the *changed* sub-cluster miss; untouched sub-clusters are never
   re-profiled.
3. **full replan** — cold cache (first plan, or every sub-cluster changed).

Voluntary replans (the fleet still runs the current plan) are gated by the
amortization rule:

    (t_current - t_candidate) * remaining_steps  >  migration_bytes/cross_bw
                                                    + search_time

Forced replans (the plan no longer fits the fleet) always adopt.  Adopted
plans are persisted as JSON (``ParallelStrategy.to_json``) in
``plan_cache_dir`` keyed by a fingerprint of (arch, planner config, cluster),
so a restarted controller reloads instead of re-searching.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import (
    HeteroCluster, SubCluster, cluster_fingerprint, cluster_from_dict,
    cluster_to_dict, remove_nodes,
)
from repro_torch.core.dp_search import SearchTimeout
from repro_torch.core.h1f1b import h1f1b_counts
from repro_torch.core.layering import Layer, build_layers
from repro_torch.core.opgraph import build_op_sequence
from repro_torch.core.pipesim import eta_load_balance, sim_memo_stats, simulate
from repro_torch.core.planner import HAPTPlanner, PlannerConfig
from repro_torch.core.strategy import ParallelStrategy
from repro_torch.migrate import (
    DEFAULT_RESTORE_BW, diff_layouts, layout_from_strategy, lost_devices,
    price_migration,
)
from repro_torch.runtime.events import (
    BandwidthShift, ClusterEvent, NodeJoin, apply_event,
)
from repro_torch.runtime.replay import (
    feasible_under, project_step, recompute_c_links,
)
from repro_torch.runtime.telemetry import (
    CROSS, StepObservation, TelemetryCalibrator,
)

# Plan-cache entry format: {"schema": 2, "cluster": <fleet spec>,
# "strategy": <ParallelStrategy dict>}.  The cluster rider is what lets the
# degraded ladder check a cached plan's feasibility on a *different* fleet
# (feasible_under needs the fleet the plan was priced on).  Legacy raw
# strategy JSON still loads for keyed hits; anything unparseable is
# quarantined to ``*.bad`` and treated as a miss.
PLAN_CACHE_SCHEMA = 2


@dataclass
class ControllerConfig:
    """Controller knobs.  Units: steps are training-step counts, times are
    seconds, ``drift_threshold``/``replan_slowdown`` are dimensionless
    ratios."""
    total_steps: int = 10_000          # training horizon (amortization window)
    seq_len: int = 1024
    global_batch: int = 1024
    replan_slowdown: float = 1.15      # bw retune worse than this vs. pre-event
                                       # -> also evaluate a re-search
    drift_threshold: float = 0.15      # telemetry drift that triggers a replan
    telemetry_warmup_steps: int = 1    # ignore the first N measured steps
                                       # (jit compilation inflates them)
    amortize: bool = True              # False = always adopt a better plan
    plan_cache_dir: Optional[str] = None
    migration_pricing: str = "priced"  # "priced": layout differ + netsim
                                       # (repro_torch.migrate); "legacy": the old
                                       # params-over-the-cross-link guess
    opt_bytes_per_param: float = 2.0   # optimizer bytes per param byte (ZeRO-1)
    restore_bw: float = DEFAULT_RESTORE_BW  # checkpoint-restore path, bytes/s
    overlap_migration: bool = True     # charge only wall beyond the old
                                       # plan's drain, not stop-the-world
    # -- chaos hardening (all defaults preserve the unhardened decision
    #    sequence exactly: windows of 0 never defer, and the ladder only
    #    engages where the unhardened controller raised) ------------------
    debounce_steps: int = 0            # >0: voluntary replans wait until the
                                       # fleet has been quiet this many steps
                                       # (events coalesce into one re-search)
    min_steps_between_replans: int = 0  # hysteresis: voluntary re-searches at
                                       # least this many steps apart
    replan_deadline_s: float = 0.0     # wall-clock budget per re-search;
                                       # exceeded -> SearchTimeout -> the
                                       # degraded ladder (0 = unlimited)
    degraded_ladder: bool = True       # False = legacy behavior: planner
                                       # failure on a broken plan raises
                                       # (the unhardened baseline)
    restart_retry_steps: int = 25      # while checkpoint-restarted, retry
                                       # planning every N steps even without
                                       # a fleet event


@dataclass
class ReplanDecision:
    """One controller reaction.  All times are seconds; ``step_time_*`` are
    per-training-step, ``search_time_s``/``migration_s`` are one-off
    downtime charged to the wall clock at the decision step."""
    step: int
    action: str                        # none | warmup_only | incremental |
                                       # full | deferred | ignored |
                                       # degraded_cached | degraded_pool_drop
                                       # | degraded_half_batch |
                                       # checkpoint_restart | restart
    reason: str
    event: Optional[str] = None
    step_time_before: float = 0.0      # current plan under the new conditions
    step_time_after: float = 0.0       # adopted (or retained) plan
    search_time_s: float = 0.0
    migration_s: float = 0.0
    migration_bytes: float = 0.0       # live + checkpoint-restored bytes the
                                       # adopted plan must ship (differ bound)
    plan_cache_hit: bool = False
    profile_cache_hits: int = 0
    sim_memo_hits: int = 0      # pipesim memo hits while handling this event
    sim_memo_misses: int = 0    # (hits > 0 on a warm re-plan = cache-served)
    coalesced: int = 0          # deferred events folded into this decision
    serve_replanned: bool = False  # serving placement re-searched alongside

    @property
    def downtime_s(self) -> float:
        return self.search_time_s + self.migration_s

    def describe(self) -> str:
        parts = [f"step {self.step}: {self.action} ({self.reason})"]
        if self.step_time_before and self.step_time_after:
            parts.append(f"{self.step_time_before * 1e3:.0f}ms"
                         f" -> {self.step_time_after * 1e3:.0f}ms")
        if self.downtime_s:
            parts.append(f"downtime {self.downtime_s:.2f}s")
        if self.migration_bytes:
            parts.append(f"migrate {self.migration_bytes / 1e6:.0f}MB")
        if self.sim_memo_hits or self.sim_memo_misses:
            parts.append(f"sim-cache {self.sim_memo_hits}h"
                         f"/{self.sim_memo_misses}m")
        return " ".join(parts)


class ElasticController:
    """Event -> cheapest-sufficient-replan state machine (module docstring).

    Invariants: ``self.cluster`` is always the *true* fleet and
    ``self.plan_cluster`` the fleet the adopted ``self.strategy`` was priced
    on (telemetry anchors to the latter); layering is built once and reused
    across every replan; ``profile_cache`` keys fingerprint everything the
    cost model reads — including the intra-op sharding degree, so a
    ``planner_cfg`` with ``intra_op=True`` re-searches the *joint*
    inter+intra space incrementally on cluster events (only the changed
    sub-cluster's variants miss).  All step times are seconds.
    """

    def __init__(self, cluster: HeteroCluster,
                 arch: Union[str, ArchConfig],
                 planner_cfg: Optional[PlannerConfig] = None,
                 cfg: Optional[ControllerConfig] = None,
                 telemetry: Optional[TelemetryCalibrator] = None,
                 injector=None, serving_cfg=None):
        self.cfg = cfg or ControllerConfig()
        self.planner_cfg = planner_cfg or PlannerConfig()
        self.arch = get_config(arch) if isinstance(arch, str) else arch
        self.cluster = cluster
        # layering is fleet-independent: build once, reuse across every replan
        ops = build_op_sequence(self.arch, seq_len=self.cfg.seq_len)
        self.layers: List[Layer] = build_layers(
            ops, self.planner_cfg.granularity, z=self.planner_cfg.z_heavy)
        self.profile_cache: Dict = {}       # shared stage-cost cache (tables)
        self.telemetry = telemetry or TelemetryCalibrator()
        self.strategy: Optional[ParallelStrategy] = None
        self.plan_cluster: Optional[HeteroCluster] = None
        self.decisions: List[ReplanDecision] = []
        self._mem_plans: Dict[str, str] = {}   # key -> cache-entry JSON
        self._last_observed_step: Optional[int] = None
        # chaos hardening state
        self.injector = injector            # chaos.inject.FaultInjector | None
        self.serving_cfg = serving_cfg      # serving.config value | None
        self.serve_plan = None              # last good ServePlan (follow-on)
        self.serve_replans = 0
        self._serve_cost_cache: Dict = {}
        self._removed_pools: Dict[str, SubCluster] = {}  # specs of pools that
        #                                     left the fleet (templated rejoin)
        self._bootstrapped = False
        self._pending_why: Optional[str] = None   # coalesced deferred reason
        self._pending_events = 0
        self._pending_bw_only = True
        self._last_event_step = -(1 << 30)
        self._last_search_step = -(1 << 30)
        self._last_restart_try = -(1 << 30)
        self._last_plan_error: Optional[str] = None
        # observability (record-only): a repro_torch.obs.DriftLedger the facade
        # wires when HarpConfig.obs is set — it observes the same telemetry
        # this controller acts on but never alters a decision
        self.drift_ledger = None

    # ------------------------------------------------------------------
    # planning (with persistent plan cache + warm profile tables)
    # ------------------------------------------------------------------

    def _plan_key(self, cluster: HeteroCluster,
                  pcfg: Optional[PlannerConfig] = None,
                  global_batch: Optional[int] = None) -> str:
        pcfg = pcfg or self.planner_cfg
        pc = dataclasses.asdict(pcfg)
        # callables don't serialize; key on identity so an analytic-model plan
        # is never silently reused by an on-hardware-profiling controller
        fn = pc.pop("measure_fn", None)
        pc["measure_fn_id"] = None if fn is None else \
            getattr(fn, "__qualname__", repr(fn))
        # execution knobs don't alter plans: worker parallelism, the search
        # engine/batching (oracle and vectorized are bit-identical), and the
        # wall-clock deadline (a search that *finishes* under a deadline
        # found the same optimum an unbounded one would)
        for knob in ("n_workers", "engine", "batch_size", "deadline_s"):
            pc["search"].pop(knob, None)
        # search() overwrites its n_microbatches from the planner config at
        # plan time; normalize so keys match before and after the first plan
        pc["search"]["n_microbatches"] = pcfg.n_microbatches
        material = json.dumps({
            "arch": self.arch.arch_id,
            "seq_len": self.cfg.seq_len,
            "global_batch": global_batch or self.cfg.global_batch,
            "planner": pc,
            "cluster": cluster_fingerprint(cluster),
        }, sort_keys=True, default=str)
        return hashlib.sha1(material.encode()).hexdigest()[:16]

    def _cache_path(self, key: str) -> Optional[str]:
        if not self.cfg.plan_cache_dir:
            return None
        return os.path.join(self.cfg.plan_cache_dir, f"plan_{key}.json")

    @staticmethod
    def _parse_plan_entry(s: str) -> Optional[
            Tuple[ParallelStrategy, Optional[HeteroCluster]]]:
        """(strategy, fleet-it-was-planned-on | None) — None on corrupt or
        stale-schema entries (the caller treats those as cache misses).
        Legacy entries (raw strategy JSON, no cluster rider) still load."""
        try:
            d = json.loads(s)
            if isinstance(d, dict) and "strategy" in d:
                if d.get("schema") != PLAN_CACHE_SCHEMA:
                    return None
                return (ParallelStrategy.from_json(json.dumps(d["strategy"])),
                        cluster_from_dict(d["cluster"]))
            return ParallelStrategy.from_json(s), None
        except Exception:
            return None

    def _load_cached_plan(self, key: str) -> Optional[ParallelStrategy]:
        s = self._mem_plans.get(key)
        path = self._cache_path(key)
        if s is None:
            if not (path and os.path.exists(path)):
                return None
            with open(path) as f:
                s = f.read()
        parsed = self._parse_plan_entry(s)
        if parsed is None:
            # corrupt or stale-schema entry: quarantine so the next run
            # doesn't trip on it again, report a miss (never raise)
            self._mem_plans.pop(key, None)
            if path and os.path.exists(path):
                os.replace(path, path + ".bad")
            return None
        self._mem_plans[key] = s
        return parsed[0]

    def _store_plan(self, key: str, strategy: ParallelStrategy,
                    cluster: HeteroCluster):
        s = json.dumps({"schema": PLAN_CACHE_SCHEMA,
                        "cluster": cluster_to_dict(cluster),
                        "strategy": json.loads(strategy.to_json())})
        self._mem_plans[key] = s
        path = self._cache_path(key)
        if path:
            os.makedirs(self.cfg.plan_cache_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(s)
            os.replace(tmp, path)

    def _cached_candidates(self):
        """Every parseable cache entry that carries its fleet rider —
        the degraded ladder's rung-1 pool.  In-memory entries first, then
        any on-disk entries not already seen."""
        seen = set()
        for key, s in list(self._mem_plans.items()):
            parsed = self._parse_plan_entry(s)
            if parsed is not None and parsed[1] is not None:
                seen.add(key)
                yield parsed
        d = self.cfg.plan_cache_dir
        if d and os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                if not (fn.startswith("plan_") and fn.endswith(".json")):
                    continue
                if fn[5:-5] in seen:
                    continue
                try:
                    with open(os.path.join(d, fn)) as f:
                        s = f.read()
                except OSError:
                    continue
                parsed = self._parse_plan_entry(s)
                if parsed is not None and parsed[1] is not None:
                    yield parsed

    def _plan(self, cluster: HeteroCluster, *,
              pcfg: Optional[PlannerConfig] = None,
              global_batch: Optional[int] = None
              ) -> Tuple[Optional[ParallelStrategy], float, bool, int]:
        """(strategy | None, search_seconds, plan_cache_hit, profile_hits).
        ``self._last_plan_error`` records why a None came back ("timeout",
        "injected timeout", "injected infeasible", or the error text)."""
        self._last_plan_error = None
        key = self._plan_key(cluster, pcfg, global_batch)
        cached = self._load_cached_plan(key)
        if cached is not None:
            return cached, 0.0, True, 0
        inj = self.injector
        if inj is not None:
            fault = inj.planner_fault()
            if fault == "timeout":
                self._last_plan_error = "injected timeout"
                burned = self.cfg.replan_deadline_s \
                    if self.cfg.replan_deadline_s > 0 \
                    else inj.cfg.planner_timeout_s
                return None, burned, False, 0
            if fault == "infeasible":
                self._last_plan_error = "injected infeasible"
                return None, 0.0, False, 0
        run_cfg = pcfg or self.planner_cfg
        if self.cfg.replan_deadline_s > 0 and run_cfg.search.deadline_s <= 0:
            run_cfg = dataclasses.replace(
                run_cfg, search=dataclasses.replace(
                    run_cfg.search, deadline_s=self.cfg.replan_deadline_s))
        planner = HAPTPlanner(cluster, run_cfg)
        t0 = time.perf_counter()
        try:
            strategy = planner.plan(
                self.arch, seq_len=self.cfg.seq_len,
                global_batch=global_batch or self.cfg.global_batch,
                layers=self.layers, profile_cache=self.profile_cache)
        except (RuntimeError, AssertionError) as exc:
            self._last_plan_error = "timeout" \
                if isinstance(exc, SearchTimeout) else str(exc)
            return None, time.perf_counter() - t0, False, 0
        dt = time.perf_counter() - t0
        hits = strategy.planner_meta.get("profiler", {}).get("n_cache_hits", 0)
        self._store_plan(key, strategy, cluster)
        return strategy, dt, False, hits

    def bootstrap(self) -> ParallelStrategy:
        """Initial plan on the current fleet."""
        snap = sim_memo_stats().snapshot()
        strategy, dt, cache_hit, hits = self._plan(self.cluster)
        if strategy is None:
            raise RuntimeError("bootstrap planning failed: no feasible plan")
        self.strategy = strategy
        self.plan_cluster = self.cluster
        self._bootstrapped = True
        live = sim_memo_stats()
        self.decisions.append(ReplanDecision(
            step=0, action="incremental" if (cache_hit or hits) else "full",
            reason="bootstrap", step_time_after=strategy.est_step_time,
            search_time_s=dt, plan_cache_hit=cache_hit,
            profile_cache_hits=hits,
            sim_memo_hits=live.hits - snap.hits,
            sim_memo_misses=live.misses - snap.misses))
        return strategy

    # ------------------------------------------------------------------
    # event handling
    # ------------------------------------------------------------------

    def handle(self, event: ClusterEvent, *,
               step: Optional[int] = None) -> ReplanDecision:
        """Fold one fleet event: apply it to the true cluster, then walk the
        decision ladder (retune / incremental re-search / full replan /
        keep).  Returns the decision, also appended to ``self.decisions``.

        With ``cfg.degraded_ladder`` (the default), this never raises once
        bootstrap has succeeded: unappliable events are recorded and
        skipped, planner failures and timeouts fall down the degraded-mode
        ladder, and the committed strategy never references a removed node.
        """
        step = event.step if step is None else step
        hardened = self.cfg.degraded_ladder and self._bootstrapped
        self._last_event_step = step
        try:
            event, new_cluster = self._apply_event_tracked(event)
        except Exception as exc:
            if not hardened:
                raise
            decision = ReplanDecision(
                step=step, action="ignored",
                reason=f"unappliable event ({exc})", event=event.describe(),
                step_time_after=self.strategy.est_step_time
                if self.strategy else 0.0)
            self.decisions.append(decision)
            return decision
        if self._bootstrapped and self.strategy is None:
            # checkpoint-restart state: every fleet event is a chance to
            # come back up
            return self._attempt_restart(new_cluster, step, event.describe())
        bandwidth_only = isinstance(event, BandwidthShift)
        if not hardened:
            return self._react(new_cluster, step, event.describe(),
                               bandwidth_only=bandwidth_only)
        return self._guarded_react(new_cluster, step, event.describe(),
                                   bandwidth_only)

    def _apply_event_tracked(
            self, event: ClusterEvent
    ) -> Tuple[ClusterEvent, HeteroCluster]:
        """``apply_event`` plus pool-spec memory: remembers the spec of every
        pool that leaves the fleet so a template-less rejoin targeting a
        vanished pool can re-create it."""
        if isinstance(event, NodeJoin) and event.template is None:
            names = {s.name for s in self.cluster.subclusters}
            if event.subcluster not in names \
                    and event.subcluster in self._removed_pools:
                event = dataclasses.replace(
                    event, template=self._removed_pools[event.subcluster])
        before = {s.name: s for s in self.cluster.subclusters}
        new_cluster = apply_event(self.cluster, event)
        after = {s.name for s in new_cluster.subclusters}
        for name, sub in before.items():
            if name not in after:
                self._removed_pools[name] = sub
        for name in after:
            self._removed_pools.pop(name, None)
        return event, new_cluster

    def poll(self, step: int) -> Optional[ReplanDecision]:
        """Per-step tick (the replay harness calls this every step): fires
        a deferred (debounced) re-search once both windows close, and
        retries planning while checkpoint-restarted.  None = nothing due."""
        if self._bootstrapped and self.strategy is None:
            if step - self._last_restart_try >= max(
                    1, self.cfg.restart_retry_steps):
                return self._attempt_restart(self.cluster, step,
                                             "restart retry")
            return None
        if self._pending_events == 0 or self.strategy is None:
            return None
        c = self.cfg
        if c.debounce_steps > 0 \
                and step - self._last_event_step < c.debounce_steps:
            return None
        if c.min_steps_between_replans > 0 \
                and step - self._last_search_step < c.min_steps_between_replans:
            return None
        why = f"deferred x{self._pending_events}: {self._pending_why}"
        n, bw_only = self._pending_events, self._pending_bw_only
        self._pending_why, self._pending_events = None, 0
        self._pending_bw_only = True
        decision = self._guarded_react(self.cluster, step, why, bw_only)
        decision.coalesced = n
        return decision

    def on_step_time(self, step: int, step_time: float,
                     stage_times: Optional[Sequence[float]] = None
                     ) -> Optional[ReplanDecision]:
        """Trainer telemetry hook: fold the measured step time; replan when
        the calibrated fleet drifts past the threshold."""
        if self.strategy is None:
            return None
        if step <= self.cfg.telemetry_warmup_steps:
            return None    # jit-compile-inflated steps would poison the EWMA
        # anchor the calibration to the efficiencies the prediction was made
        # with (plan_cluster), not the current fleet value — anchoring to the
        # already-calibrated value would compound the correction every step
        self.telemetry.observe(
            self.plan_cluster, self.strategy,
            StepObservation(step, step_time,
                            list(stage_times) if stage_times else None))
        if self.drift_ledger is not None:
            self.drift_ledger.observe_step(step, step_time, stage_times)
        self._last_observed_step = step
        drift = self.telemetry.drift(self.cluster)
        if drift <= self.cfg.drift_threshold:
            return None
        calibrated = self.telemetry.calibrated(self.cluster)
        return self._react(calibrated, step,
                           f"telemetry drift {drift:.0%}", bandwidth_only=False)

    def on_comm_time(self, step: int, link: str, predicted_s: float,
                     measured_s: float) -> Optional[ReplanDecision]:
        """Comm telemetry hook: fold one measured transfer/collective time
        against its prediction for a bandwidth tier (``"cross"`` or a
        sub-cluster name — see ``telemetry.observe_comm``).  When the
        calibrated fleet drifts past the threshold the decision ladder runs
        as a bandwidth-only change; a re-search then rebuilds the
        ``CommModel`` from the calibrated tiers, so collective algorithms
        are *re-selected* under the observed bandwidths (a congested WAN
        tips ring syncs into the two-level hierarchy, and vice versa)."""
        if self.strategy is None:
            return None
        self.telemetry.observe_comm(self.plan_cluster, link,
                                    predicted_s, measured_s)
        drift = self.telemetry.drift(self.cluster)
        if drift <= self.cfg.drift_threshold:
            return None
        calibrated = self.telemetry.calibrated(self.cluster)
        if cluster_fingerprint(calibrated) == cluster_fingerprint(self.cluster):
            return None
        return self._react(calibrated, step,
                           f"comm drift on {link} ({drift:.0%})",
                           bandwidth_only=True)

    def on_straggler(self, step: int, step_time: float, ewma: float
                     ) -> Optional[ReplanDecision]:
        """Drop-in for ``Trainer(on_straggler=...)`` — a sustained skew is a
        strong single observation; fold it (unless on_step_time already saw
        this step: the Trainer fires both hooks with the same measurement)
        and react immediately."""
        if self.strategy is None:
            return None
        if self._last_observed_step != step:
            self.telemetry.observe(self.plan_cluster, self.strategy,
                                   StepObservation(step, step_time))
            self._last_observed_step = step
        calibrated = self.telemetry.calibrated(self.cluster)
        if cluster_fingerprint(calibrated) == cluster_fingerprint(self.cluster):
            return None
        return self._react(calibrated, step,
                           f"straggler {step_time / max(ewma, 1e-12):.2f}x",
                           bandwidth_only=False)

    def trainer_hooks(self) -> Dict:
        """Keyword arguments for ``train.trainer.Trainer``."""
        return {"on_straggler": self.on_straggler,
                "on_step_time": self.on_step_time}

    # ------------------------------------------------------------------
    # hardened path: debounce + never-raise + degraded ladder
    # ------------------------------------------------------------------

    def _windows_open(self, step: int) -> bool:
        """True while a voluntary re-search should wait: the fleet hasn't
        been quiet for ``debounce_steps``, or the last search was fewer than
        ``min_steps_between_replans`` steps ago."""
        c = self.cfg
        if c.debounce_steps > 0 \
                and step - self._last_event_step < c.debounce_steps:
            return True
        if c.min_steps_between_replans > 0 \
                and step - self._last_search_step < c.min_steps_between_replans:
            return True
        return False

    def _guarded_react(self, new_cluster: HeteroCluster, step: int, why: str,
                       bandwidth_only: bool) -> ReplanDecision:
        """The hardened wrapper around :meth:`_react`: voluntary replans
        within the debounce/hysteresis windows are deferred (coalesced into
        one later re-search — a flapping node costs one replan, not one per
        flap), and *any* failure of the planning path falls down the
        degraded ladder instead of raising."""
        try:
            feasible = feasible_under(self.strategy, self.plan_cluster,
                                      new_cluster)
            if feasible and self._windows_open(step):
                # the fleet still fits the committed plan: absorb the event
                # now (bandwidth retunes are near-free), search later
                if bandwidth_only:
                    self._retune_schedule(new_cluster)
                self._pending_events += 1
                self._pending_bw_only = self._pending_bw_only and bandwidth_only
                self._pending_why = why if self._pending_why is None \
                    else f"{self._pending_why} + {why}"
                decision = ReplanDecision(
                    step=step, action="deferred",
                    reason=(f"{why}; within replan window "
                            f"({self._pending_events} pending)"),
                    event=why,
                    step_time_after=self.strategy.est_step_time)
                return self._commit(decision, new_cluster, adopted=None)
            return self._react(new_cluster, step, why,
                               bandwidth_only=bandwidth_only)
        except Exception as exc:
            return self._ladder(
                new_cluster, step,
                f"{why}; planning failed ({type(exc).__name__}: {exc})")

    def _degraded_candidate(self, new_cluster: HeteroCluster):
        """Rungs 1-3 of the degraded ladder.  Returns
        ``(strategy, plan_cluster, action, note)`` or None; never raises
        past what the caller's guard absorbs."""
        # rung 1: best cached plan that still fits a surviving subset
        best = None
        for strat, cached_cl in self._cached_candidates():
            if not feasible_under(strat, cached_cl, new_cluster):
                continue
            res = project_step(strat, cached_cl, new_cluster, self.layers)
            if res is None:
                continue
            if best is None or res.makespan < best[2]:
                best = (strat, cached_cl, res.makespan)
        if best is not None:
            return (best[0], best[1], "degraded_cached",
                    f"cached plan projected at {best[2] * 1e3:.0f}ms/step")
        # rung 2: drop the smallest pool(s) and re-search — a partially-dead
        # or unplannable pool shouldn't take the fleet down with it
        fleet = new_cluster
        while len(fleet.subclusters) > 1:
            smallest = min(fleet.subclusters, key=lambda s: s.peak_flops)
            fleet = remove_nodes(fleet, smallest.name, smallest.n_nodes)
            cand, _, _, _ = self._plan(fleet)
            if cand is not None:
                return (cand, fleet, "degraded_pool_drop",
                        f"re-searched without pool {smallest.name!r}")
        # rung 3: halve the microbatch count (and the global batch with it,
        # so per-microbatch memory is unchanged) until something fits
        B = self.planner_cfg.n_microbatches // 2
        gb = self.cfg.global_batch // 2
        while B >= 1 and gb >= 1:
            pcfg = dataclasses.replace(self.planner_cfg, n_microbatches=B)
            cand, _, _, _ = self._plan(new_cluster, pcfg=pcfg,
                                       global_batch=gb)
            if cand is not None:
                return (cand, new_cluster, "degraded_half_batch",
                        f"halved to B={B}, global batch {gb}")
            B //= 2
            gb //= 2
        return None

    def _ladder(self, new_cluster: HeteroCluster, step: int,
                why: str, charged: float = 0.0) -> ReplanDecision:
        """Guaranteed degraded-mode response when planning failed or timed
        out: cached feasible plan -> drop smallest pool -> halve microbatch
        count -> checkpoint-restart.  Never raises; always leaves the
        controller in a state where the committed strategy (if any) fits
        ``new_cluster``."""
        t0 = time.perf_counter()
        try:
            found = self._degraded_candidate(new_cluster)
            if found is not None:
                strat, pcl, action, note = found
                decision = ReplanDecision(
                    step=step, action=action, reason=f"{why}; {note}",
                    event=why, step_time_after=strat.est_step_time,
                    search_time_s=charged + time.perf_counter() - t0)
                return self._commit(decision, new_cluster, adopted=strat,
                                    plan_cluster=pcl)
        except Exception as exc:   # the ladder itself must never raise
            why = f"{why}; ladder error ({type(exc).__name__}: {exc})"
        # rung 4: checkpoint-restart — stop earning tokens, hold position,
        # retry planning on every event (and every restart_retry_steps)
        self.strategy = None
        self.plan_cluster = None
        self.cluster = new_cluster
        self._pending_why, self._pending_events = None, 0
        self._pending_bw_only = True
        self._last_restart_try = step
        decision = ReplanDecision(
            step=step, action="checkpoint_restart",
            reason=f"{why}; no degraded plan found, holding at checkpoint",
            event=why, search_time_s=charged + time.perf_counter() - t0)
        self.decisions.append(decision)
        return decision

    def _attempt_restart(self, new_cluster: HeteroCluster, step: int,
                         why: str) -> ReplanDecision:
        """From the checkpoint-restart rung: try to come back up on the
        current fleet (full search first, then the cheap ladder rungs).
        Adoption charges the checkpoint-restore time."""
        self._last_restart_try = step
        t0 = time.perf_counter()
        pcl = new_cluster
        try:
            cand = self._plan(new_cluster)[0]
            if cand is None:
                found = self._degraded_candidate(new_cluster)
                if found is not None:
                    cand, pcl, _, note = found
                    why = f"{why}; {note}"
        except Exception:
            cand = None
        if cand is None:
            decision = ReplanDecision(
                step=step, action="none",
                reason=f"{why}; still no feasible plan "
                       "(checkpoint-restart pending)",
                event=why, search_time_s=time.perf_counter() - t0)
            self.cluster = new_cluster
            self.decisions.append(decision)
            return decision
        decision = ReplanDecision(
            step=step, action="restart",
            reason=f"{why}; restored from checkpoint", event=why,
            step_time_after=cand.est_step_time,
            search_time_s=time.perf_counter() - t0,
            migration_s=self._restore_seconds(),
            migration_bytes=self._state_bytes())
        return self._commit(decision, new_cluster, adopted=cand,
                            plan_cluster=pcl)

    def _state_bytes(self) -> float:
        return sum(l.param_bytes for l in self.layers) \
            * (1.0 + self.cfg.opt_bytes_per_param)

    def _restore_seconds(self) -> float:
        return self._state_bytes() / max(self.cfg.restore_bw, 1.0)

    # ------------------------------------------------------------------
    # decision ladder
    # ------------------------------------------------------------------

    def _react(self, new_cluster: HeteroCluster, step: int, why: str,
               bandwidth_only: bool) -> ReplanDecision:
        assert self.strategy is not None, "call bootstrap() first"
        self._memo_snap = sim_memo_stats().snapshot()
        old_est = self.strategy.est_step_time
        res = project_step(self.strategy, self.plan_cluster, new_cluster,
                           self.layers)
        feasible = res is not None
        t_before = res.makespan if feasible else float("inf")

        # rung 1: bandwidth-only -> retune comm times + warm-up counts in place
        if bandwidth_only and feasible:
            self._retune_schedule(new_cluster)
            t_retuned = self.strategy.est_step_time
            if t_retuned <= self.cfg.replan_slowdown * old_est:
                decision = ReplanDecision(
                    step=step, action="warmup_only", reason=why, event=why,
                    step_time_before=t_before, step_time_after=t_retuned)
                return self._commit(decision, new_cluster, adopted=None)
            t_before = t_retuned   # degradation too large: try a re-search

        # rung 2/3: re-search (incremental thanks to the warm profile cache)
        cand, search_s, plan_hit, profile_hits = self._plan(new_cluster)
        self._last_search_step = step
        if cand is None:
            if not feasible:
                if self.cfg.degraded_ladder and self._bootstrapped:
                    return self._ladder(
                        new_cluster, step,
                        f"{why}; plan broken and re-search found nothing "
                        f"({self._last_plan_error})", charged=search_s)
                raise RuntimeError(
                    f"fleet change ({why}) broke the plan and re-planning "
                    f"found no feasible strategy on {new_cluster.describe()}")
            decision = ReplanDecision(
                step=step, action="warmup_only" if bandwidth_only else "none",
                reason=f"{why}; re-search infeasible, keeping current plan",
                event=why, step_time_before=t_before, step_time_after=t_before,
                search_time_s=search_s)
            return self._commit(decision, new_cluster, adopted=None)

        action = "incremental" if (plan_hit or profile_hits > 0) else "full"
        mig_s, mig_bytes = self._migration_cost(cand, new_cluster)

        if not feasible:
            decision = ReplanDecision(
                step=step, action=action, reason=f"{why}; forced (plan broken)",
                event=why, step_time_before=t_before,
                step_time_after=cand.est_step_time, search_time_s=search_s,
                migration_s=mig_s, migration_bytes=mig_bytes,
                plan_cache_hit=plan_hit, profile_cache_hits=profile_hits)
            return self._commit(decision, new_cluster, adopted=cand)

        # amortization: expected gain over the remaining horizon vs. the
        # one-off cost of migrating state and having searched
        remaining = max(0, self.cfg.total_steps - step)
        gain_s = (t_before - cand.est_step_time) * remaining
        cost_s = mig_s + search_s
        if self.cfg.amortize and gain_s <= cost_s:
            decision = ReplanDecision(
                step=step, action="warmup_only" if bandwidth_only else "none",
                reason=(f"{why}; not amortized "
                        f"(gain {gain_s:.1f}s <= cost {cost_s:.1f}s)"),
                event=why, step_time_before=t_before, step_time_after=t_before,
                search_time_s=search_s, plan_cache_hit=plan_hit,
                profile_cache_hits=profile_hits)
            return self._commit(decision, new_cluster, adopted=None)

        decision = ReplanDecision(
            step=step, action=action,
            reason=f"{why}; amortized (gain {gain_s:.1f}s > cost {cost_s:.1f}s)"
            if self.cfg.amortize else f"{why}; amortization off",
            event=why, step_time_before=t_before,
            step_time_after=cand.est_step_time, search_time_s=search_s,
            migration_s=mig_s, migration_bytes=mig_bytes,
            plan_cache_hit=plan_hit, profile_cache_hits=profile_hits)
        return self._commit(decision, new_cluster, adopted=cand)

    def _commit(self, decision: ReplanDecision, new_cluster: HeteroCluster,
                adopted: Optional[ParallelStrategy],
                plan_cluster: Optional[HeteroCluster] = None
                ) -> ReplanDecision:
        """Adopt ``new_cluster`` (and ``adopted``, if any) and record the
        decision.  ``plan_cluster`` overrides the fleet the adopted strategy
        was priced on (degraded-ladder adoptions: a cached plan keeps the
        fleet it was searched on; a pool-drop plan keeps the reduced
        fleet)."""
        if adopted is not None:
            priced_on = plan_cluster if plan_cluster is not None \
                else new_cluster
            if not feasible_under(adopted, priced_on, new_cluster):
                # the no-dead-nodes invariant: nothing referencing a removed
                # node may be committed.  Unreachable by construction; the
                # hardened path catches this and checkpoint-restarts.
                raise AssertionError(
                    "refusing to commit a strategy that does not fit "
                    f"{new_cluster.describe()}")
        # pipesim-memo traffic while this decision was being made: a warm
        # re-plan whose simulations were all cache-served shows hits with
        # zero misses in the decision log (and replay traces)
        snap = getattr(self, "_memo_snap", None)
        if snap is not None:
            live = sim_memo_stats()
            decision.sim_memo_hits = live.hits - snap.hits
            decision.sim_memo_misses = live.misses - snap.misses
            self._memo_snap = None
        # a committed efficiency change (event or calibration) supersedes the
        # EWMA history for that sub-cluster — keeping the stale estimate would
        # read as spurious drift against the new model and churn replans
        old_eff = {s.name: s.device.efficiency for s in self.cluster.subclusters}
        for s in new_cluster.subclusters:
            if s.name in old_eff and old_eff[s.name] != s.device.efficiency:
                self.telemetry.reset(s.name)
        # same rule for bandwidth tiers (comm calibration)
        if new_cluster.cross_bw != self.cluster.cross_bw:
            self.telemetry.reset_bandwidth(CROSS)
        old_ib = {s.name: s.inter_node_bw for s in self.cluster.subclusters}
        for s in new_cluster.subclusters:
            if s.name in old_ib and old_ib[s.name] != s.inter_node_bw:
                self.telemetry.reset_bandwidth(s.name)
        pools_changed = (
            {(s.name, s.n_nodes, s.devices_per_node)
             for s in self.cluster.subclusters}
            != {(s.name, s.n_nodes, s.devices_per_node)
                for s in new_cluster.subclusters})
        self.cluster = new_cluster
        if adopted is not None:
            self.strategy = adopted
            self.plan_cluster = plan_cluster if plan_cluster is not None \
                else new_cluster
            if self.drift_ledger is not None:
                # the adopted strategy's estimate is the new prediction to
                # hold to account; old-plan samples don't indict it
                self.drift_ledger.register_plan(
                    {"makespan_s": adopted.est_step_time},
                    stage_pools={
                        i: self.plan_cluster.subclusters[st.cluster_idx].name
                        for i, st in enumerate(adopted.stages)})
        if pools_changed:
            self._replan_serving(new_cluster, decision)
        self.decisions.append(decision)
        return decision

    def _replan_serving(self, new_cluster: HeteroCluster,
                        decision: ReplanDecision) -> None:
        """Serving follow-on: a pool-structure change re-runs the serving
        placement search on the surviving fleet (PR 6's named remainder),
        through the same never-raise guard as training replans — a failed
        re-placement keeps the last good serve plan.  Control-plane work:
        not charged to training downtime."""
        if self.serving_cfg is None:
            return
        try:
            from repro_torch.serving.placement import search_placement
            self.serve_plan = search_placement(
                self.arch, new_cluster, self.serving_cfg,
                cost_cache=self._serve_cost_cache)
            self.serve_replans += 1
            decision.serve_replanned = True
        except Exception as exc:
            decision.reason += (f"; serving re-placement failed "
                                f"({type(exc).__name__}), keeping last "
                                f"serve plan")

    # ------------------------------------------------------------------
    # cheap responses + costs
    # ------------------------------------------------------------------

    def _retune_schedule(self, new_cluster: HeteroCluster):
        """Bandwidth-only response: stage placement and compute stand; only
        comm times, H-1F1B warm-up counts, and the simulated step time move."""
        strat = self.strategy
        c_links = recompute_c_links(strat, self.plan_cluster, new_cluster,
                                    self.layers)
        counts = h1f1b_counts([s.t for s in strat.stages], c_links,
                              strat.n_microbatches)
        res = simulate([s.t_f for s in strat.stages],
                       [s.t_b for s in strat.stages],
                       c_links, strat.n_microbatches, counts)
        strat.c_links = c_links
        strat.warmup_counts = counts
        strat.est_step_time = res.makespan
        strat.eta = eta_load_balance(
            res.stage_compute,
            [s.n_devices
             * self.plan_cluster.subclusters[s.cluster_idx].device.peak_flops
             for s in strat.stages])
        # deliberately NOT stored in the plan cache: only genuinely searched
        # plans belong there — caching the retuned plan under the new fleet's
        # key would short-circuit rung 2's re-search with our own retune

    def _migration_cost(self, cand: ParallelStrategy,
                        new_cluster: HeteroCluster) -> Tuple[float, float]:
        """(seconds, bytes) of moving live state from the current plan to
        ``cand``.  The priced path diffs the two plans' exact per-device
        byte layouts (``repro_torch.migrate``) — only *moved* bytes, sourced from
        the nearest surviving replica or the checkpoint — and prices the
        transfer set through the comm topology's tiered links, overlapped
        with the old plan's drain.  Bytes = live + checkpoint-restored
        (the differ's bound an executor cannot beat)."""
        if self.cfg.migration_pricing == "legacy":
            return self._migration_seconds(cand, new_cluster), 0.0
        old_lay = layout_from_strategy(
            self.strategy, self.plan_cluster, self.layers,
            opt_bytes_per_param=self.cfg.opt_bytes_per_param)
        new_lay = layout_from_strategy(
            cand, new_cluster, self.layers,
            opt_bytes_per_param=self.cfg.opt_bytes_per_param)
        lost = lost_devices(self.plan_cluster, new_cluster)
        mplan = diff_layouts(old_lay, new_lay, lost=lost)
        cost = price_migration(
            mplan, old_lay, new_cluster,
            old_strategy=self.strategy, old_cluster=self.plan_cluster,
            layers=self.layers, restore_bw=self.cfg.restore_bw,
            overlap=self.cfg.overlap_migration)
        return cost.downtime_s, float(mplan.moved_bytes + mplan.ckpt_bytes)

    def _migration_seconds(self, cand: ParallelStrategy,
                           new_cluster: HeteroCluster) -> float:
        """Legacy guess (``migration_pricing="legacy"``): parameter bytes
        whose owning sub-cluster changes, over the cross link (optimizer
        state assumed re-sharded locally, not shipped)."""
        def owners(strategy: ParallelStrategy, cluster: HeteroCluster
                   ) -> Dict[int, str]:
            out: Dict[int, str] = {}
            for s in strategy.stages:
                name = cluster.subclusters[s.cluster_idx].name
                for li in range(s.layer_start, s.layer_end):
                    out[li] = name
            return out

        old = owners(self.strategy, self.plan_cluster)
        new = owners(cand, new_cluster)
        moved = sum(self.layers[li].param_bytes
                    for li in new if old.get(li) != new[li])
        if moved <= 0:
            return 0.0
        return moved / new_cluster.cross_bw + new_cluster.cross_latency
