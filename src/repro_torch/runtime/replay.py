"""Discrete-event replay: a (strategy, fleet-history) pair -> throughput
timeline, composed from ``core.pipesim.simulate``.

Two primitives make any plan projectable onto any fleet state:

- :func:`feasible_under` — does the strategy's mesh footprint still fit?
- :func:`project_step` — exact pipeline-DAG step simulation with stage times
  rescaled by the *true* device efficiency (vs. the efficiency assumed at
  plan time) and inter-stage comm recomputed from the *true* link bandwidths.

:func:`run_replay` folds an :class:`EventTrace` over a training run.  In
elastic mode the controller consumes each event (its replan downtime is
charged to the wall clock); in static mode the initial plan is kept and
infeasible steps earn zero tokens (checkpoint-restart waiting for the fleet
to recover — the standard non-elastic baseline).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import HeteroCluster, cluster_fingerprint
from repro_torch.core.h1f1b import h1f1b_counts
from repro_torch.core.layering import Layer
from repro_torch.core.pipesim import SimResult, simulate
from repro_torch.core.strategy import ParallelStrategy
from repro_torch.runtime.events import EventTrace, apply_event


# ---------------------------------------------------------------------------
# Projection primitives
# ---------------------------------------------------------------------------


def _true_sub(plan_cluster: HeteroCluster, true_cluster: HeteroCluster,
              cluster_idx: int):
    """The current incarnation of the sub-cluster a stage was planned on
    (matched by name; None if it left the fleet)."""
    name = plan_cluster.subclusters[cluster_idx].name
    for s in true_cluster.subclusters:
        if s.name == name:
            return s
    return None


def feasible_under(strategy: ParallelStrategy, plan_cluster: HeteroCluster,
                   true_cluster: HeteroCluster) -> bool:
    """Does the plan's mesh footprint fit the true fleet?  Per-stage mesh
    shape must fit its sub-cluster, and stages sharing a sub-cluster must
    jointly fit its device count."""
    used: Dict[str, int] = {}
    for s in strategy.stages:
        sub = _true_sub(plan_cluster, true_cluster, s.cluster_idx)
        if sub is None or s.mesh_n > sub.n_nodes or s.mesh_m > sub.devices_per_node:
            return False
        used[sub.name] = used.get(sub.name, 0) + s.n_devices
    for s in true_cluster.subclusters:
        if used.get(s.name, 0) > s.n_devices:
            return False
    return True


def project_step(strategy: ParallelStrategy, plan_cluster: HeteroCluster,
                 true_cluster: HeteroCluster, layers: Sequence[Layer], *,
                 no_overlap: bool = False) -> Optional[SimResult]:
    """Simulate one step of ``strategy`` under the true fleet state.

    Stage compute is rescaled by (efficiency assumed at plan time) /
    (true efficiency); inter-stage comm is recomputed from boundary
    activation bytes over the true links.  Returns None when infeasible.
    """
    if not feasible_under(strategy, plan_cluster, true_cluster):
        return None
    t_f, t_b = [], []
    for s in strategy.stages:
        planned_eff = plan_cluster.subclusters[s.cluster_idx].device.efficiency
        true_eff = _true_sub(plan_cluster, true_cluster,
                             s.cluster_idx).device.efficiency
        scale = planned_eff / true_eff
        t_f.append(s.t_f * scale)
        t_b.append(s.t_b * scale)
    c_links = recompute_c_links(strategy, plan_cluster, true_cluster, layers)
    return simulate(t_f, t_b, c_links, strategy.n_microbatches,
                    strategy.warmup_counts, no_overlap=no_overlap)


def sync_priced_step(strategy: ParallelStrategy, cluster: HeteroCluster,
                     layers: Sequence[Layer], *,
                     no_overlap: bool = False,
                     counts_fn: Optional[Callable] = None) -> SimResult:
    """Referee pricing for planner ablations: simulate one step with the
    per-step data-parallel gradient sync charged (amortized per microbatch)
    to every stage's backward time.

    The joint (``intra_op=True``) search already prices this term — its
    stages carry ``IntraOpPlan.sync_time`` and are left untouched; plans
    from the inter-op-only search get the recomputed charge added, so both
    search modes are compared under the SAME cost accounting (the analogue
    of Fig. 11b's plan-blind-evaluate-real methodology).

    ``counts_fn(t_per_stage, c_links, B) -> warm-up counts`` selects the
    schedule under referee pricing (default H-1F1B) — the api facade passes
    its config's named scheduler here so priced numbers match the lowering.

    Comm-aware plans: a stage whose sync was priced under a *selected*
    collective algorithm (``IntraOpPlan.sync_algo`` set, amortized into
    ``t_b``) keeps the planner's charge — that algorithm is what actually
    runs, so topping it back up to the flat ring would erase a real
    advantage the selection earned.  The flat-ring recompute only applies
    to stages whose search never amortized the sync.
    """
    B = strategy.n_microbatches
    t_b = []
    for s in strategy.stages:
        io = s.intra_op
        if io is not None and io.sync_algo is not None and io.sync_time > 0:
            t_b.append(s.t_b)      # selected-algorithm charge already in t_b
            continue
        sub = cluster.subclusters[s.cluster_idx]
        params = sum(layers[li].param_bytes
                     for li in range(s.layer_start, s.layer_end))
        if s.dp > 1:
            bw = sub.inter_node_bw if s.mesh_n > 1 else sub.intra_node_bw
            sync_mb = params * 2 * (s.dp - 1) / s.dp / bw / B
        else:
            sync_mb = 0.0
        already = io.sync_time if io is not None else 0.0
        t_b.append(s.t_b + max(0.0, sync_mb - already))
    t_f = [s.t_f for s in strategy.stages]
    counts = (counts_fn or h1f1b_counts)(
        [f + b for f, b in zip(t_f, t_b)], strategy.c_links, B)
    return simulate(t_f, t_b, strategy.c_links, B, counts,
                    no_overlap=no_overlap)


def recompute_c_links(strategy: ParallelStrategy, plan_cluster: HeteroCluster,
                      true_cluster: HeteroCluster,
                      layers: Sequence[Layer]) -> List[float]:
    """Inter-stage comm times under the true link bandwidths (boundary
    activation bytes are a property of the layering, not the fleet).

    A comm-aware strategy (``planner_meta["comm"]`` with latency pricing
    on) was searched with the WAN's per-transfer latency in every
    cluster-crossing cut; the recompute keeps that term so retuned warm-up
    counts and projections are priced like the plan itself."""
    meta_comm = strategy.planner_meta.get("comm")
    wan_lat = bool(meta_comm) and meta_comm.get("p2p_latency", True)
    out = []
    for i in range(strategy.n_stages - 1):
        s, nxt = strategy.stages[i], strategy.stages[i + 1]
        cut = layers[s.layer_end - 1].act_out_bytes_per_token * strategy.mb_tokens
        src = _true_sub(plan_cluster, true_cluster, s.cluster_idx)
        dst = _true_sub(plan_cluster, true_cluster, nxt.cluster_idx)
        if src is not None and dst is not None and src.name == dst.name:
            out.append(cut / src.inter_node_bw)
        else:
            out.append(cut / true_cluster.cross_bw
                       + (true_cluster.cross_latency if wan_lat else 0.0))
    return out


# ---------------------------------------------------------------------------
# Replay harness
# ---------------------------------------------------------------------------


@dataclass
class ReplaySample:
    step: int
    wall_s: float            # cumulative wall clock at end of step
    step_time_s: float       # this step's duration (stall time when starved)
    tokens: int              # tokens earned this step (0 during outage)
    events: List[str] = field(default_factory=list)
    decision: Optional[str] = None


@dataclass
class ReplayResult:
    samples: List[ReplaySample]
    tokens_total: int
    wall_total_s: float
    decisions: List = field(default_factory=list)   # ReplanDecision records
    stalled_steps: int = 0
    sim_memo_hits: int = 0      # pipesim-memo traffic across all replans:
    sim_memo_misses: int = 0    # hits/misses summed over `decisions`
    metrics: Dict = field(default_factory=dict)
    # obs.MetricsRegistry snapshot of this run (counters / gauges /
    # histograms — tokens, stalls, per-action decision counts, downtime)

    @property
    def cache_served_replans(self) -> int:
        """Decisions whose simulations were answered entirely from the
        pipesim memo (warm re-plans that never re-solved a schedule)."""
        return sum(1 for d in self.decisions
                   if getattr(d, "sim_memo_hits", 0) > 0
                   and getattr(d, "sim_memo_misses", 0) == 0)

    @property
    def migration_s(self) -> float:
        """Total priced migration downtime charged across all decisions."""
        return sum(getattr(d, "migration_s", 0.0) for d in self.decisions)

    @property
    def search_s(self) -> float:
        """Total plan-search downtime charged across all decisions."""
        return sum(getattr(d, "search_time_s", 0.0) for d in self.decisions)

    @property
    def migration_bytes(self) -> float:
        """Total bytes the adopted plans had to ship (the differ's
        live + checkpoint-restore bound, summed over adoptions)."""
        return sum(getattr(d, "migration_bytes", 0.0) for d in self.decisions)

    def throughput(self) -> float:
        return self.tokens_total / self.wall_total_s if self.wall_total_s else 0.0

    def throughput_between(self, start_step: int, end_step: int) -> float:
        """Average tokens/s over steps in [start_step, end_step)."""
        window = [s for s in self.samples if start_step <= s.step < end_step]
        wall = sum(s.step_time_s for s in window)
        tok = sum(s.tokens for s in window)
        return tok / wall if wall > 0 else 0.0

    def tokens_lost(self, ideal_throughput: float) -> float:
        """Tokens an undisrupted fleet at ``ideal_throughput`` would have
        produced in the same wall time, minus what this run produced."""
        return ideal_throughput * self.wall_total_s - self.tokens_total

    def recovery_latency(self, event_step: int) -> Tuple[int, float]:
        """(#starved steps, seconds) from ``event_step`` until tokens flow
        again — the time-to-recover after a disruption."""
        stalled, secs = 0, 0.0
        seen = False
        for s in self.samples:
            if s.step < event_step:
                continue
            if s.tokens == 0:
                seen = True
                stalled += 1
                secs += s.step_time_s
            elif seen or s.step > event_step:
                break
        return stalled, secs


def run_replay(trace: EventTrace, n_steps: int, *,
               controller=None,
               strategy: Optional[ParallelStrategy] = None,
               plan_cluster: Optional[HeteroCluster] = None,
               layers: Optional[Sequence[Layer]] = None,
               no_overlap: bool = False,
               feed_telemetry: bool = True,
               sink=None) -> ReplayResult:
    """Replay ``trace`` over ``n_steps`` training steps.

    Elastic mode (``controller`` given): events are routed through
    ``controller.handle``; its replan downtime (search + migration) is
    charged to the wall clock at the event step, and measured step times are
    fed back as telemetry.  Static mode (``strategy`` given): the plan never
    changes; steps whose plan does not fit the fleet earn zero tokens and
    burn the last known step time waiting (checkpoint-restart baseline).

    ``sink`` (an ``obs.RunLog`` or anything with ``emit(kind, t, **f)``)
    receives one ``step`` event per step and one ``decision`` event per
    controller decision, stamped with the replay's own wall clock — the
    sim-clock-only invariant of ``repro_torch.obs.sink``.
    """
    elastic = controller is not None
    if elastic:
        if controller.strategy is None:
            controller.bootstrap()
        layers = controller.layers
        true_cluster = controller.cluster
    else:
        assert strategy is not None and plan_cluster is not None \
            and layers is not None, "static replay needs strategy+cluster+layers"
        true_cluster = plan_cluster

    samples: List[ReplaySample] = []
    decisions: List = []
    wall = 0.0
    tokens_total = 0
    stalled_steps = 0
    last_step_time = (controller.strategy if elastic else strategy).est_step_time
    sim_cache: Dict = {}

    def _log_decision(step: int, d) -> None:
        if sink is not None:
            sink.emit("decision", wall, step=step, action=d.action,
                      reason=d.reason, downtime_s=d.downtime_s,
                      search_time_s=d.search_time_s,
                      migration_s=d.migration_s, coalesced=d.coalesced)

    def _log_sample(s: ReplaySample) -> None:
        if sink is not None:
            sink.emit("step", s.wall_s, step=s.step,
                      step_time_s=s.step_time_s, tokens=s.tokens,
                      events=s.events, decision=s.decision)

    for step in range(n_steps):
        evs = trace.at(step)
        ev_names = [e.describe() for e in evs]
        decision_str = None
        for ev in evs:
            if elastic:
                d = controller.handle(ev, step=step)
                decisions.append(d)
                wall += d.downtime_s
                _log_decision(step, d)
                decision_str = d.action if decision_str is None \
                    else f"{decision_str},{d.action}"
            else:
                true_cluster = apply_event(true_cluster, ev)

        if elastic and hasattr(controller, "poll"):
            d = controller.poll(step)
            if d is not None:
                decisions.append(d)
                wall += d.downtime_s
                _log_decision(step, d)
                decision_str = d.action if decision_str is None \
                    else f"{decision_str},{d.action}"

        if elastic:
            strat, pcl = controller.strategy, controller.plan_cluster
            true_cluster = controller.cluster
            if strat is None:
                # checkpoint-restart rung: the fleet holds at the last
                # checkpoint, earning nothing, until planning succeeds
                stalled_steps += 1
                wall += last_step_time
                samples.append(ReplaySample(step, wall, last_step_time, 0,
                                            ev_names, decision_str))
                _log_sample(samples[-1])
                continue
        else:
            strat, pcl = strategy, plan_cluster

        key = (cluster_fingerprint(true_cluster), tuple(strat.warmup_counts),
               tuple((s.layer_start, s.layer_end, s.cluster_idx,
                      s.mesh_n, s.mesh_m) for s in strat.stages))
        if key not in sim_cache:
            res = project_step(strat, pcl, true_cluster, layers,
                               no_overlap=no_overlap)
            sim_cache[key] = res.makespan if res is not None else None
        makespan = sim_cache[key]

        if makespan is None:
            # starved: plan does not fit the fleet; wait one nominal step
            stalled_steps += 1
            wall += last_step_time
            samples.append(ReplaySample(step, wall, last_step_time, 0,
                                        ev_names, decision_str))
            _log_sample(samples[-1])
            continue

        wall += makespan
        last_step_time = makespan
        tok = strat.tokens_per_step()
        tokens_total += tok
        samples.append(ReplaySample(step, wall, makespan, tok,
                                    ev_names, decision_str))
        _log_sample(samples[-1])
        if elastic and feed_telemetry:
            d = controller.on_step_time(step, makespan)
            if d is not None:
                decisions.append(d)
                wall += d.downtime_s
                _log_decision(step, d)

    memo_hits = sum(getattr(d, "sim_memo_hits", 0) for d in decisions)
    memo_misses = sum(getattr(d, "sim_memo_misses", 0) for d in decisions)

    # deterministic metrics digest of the run (obs.metrics snapshot shape)
    from repro_torch.obs.metrics import MetricsRegistry, record_decision
    reg = MetricsRegistry()
    reg.inc("replay.tokens", tokens_total)
    reg.inc("replay.stalled_steps", stalled_steps)
    reg.gauge("replay.steps", n_steps)
    reg.gauge("replay.wall_s", wall)
    reg.gauge("replay.sim_memo_hits", memo_hits)
    reg.gauge("replay.sim_memo_misses", memo_misses)
    for d in decisions:
        record_decision(d, reg)

    return ReplayResult(
        samples, tokens_total, wall, decisions, stalled_steps,
        sim_memo_hits=memo_hits, sim_memo_misses=memo_misses,
        metrics=reg.snapshot())
