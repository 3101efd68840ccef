"""The one public entry point: ``compile(arch, cluster, config) -> Executable``.

Counterpart of ``repro/api/facade.py``, staged exactly like a compiler —
every stage's artifact is inspectable and JSON-serializable, so planning and
execution can run on different machines (and in either package: the Plan and
LoweredPlan JSON are byte-identical to the reference's):

    plan(arch, cluster, cfg)   -> Plan         (HAPT search + provenance)
    lower(plan)                -> LoweredPlan  (meshes, apportionment,
                                                schedule, collective plan)
    compile(arch, cluster, cfg) -> Executable  (both stages + .fit() /
                                                .simulate() / .describe() /
                                                .attach_elastic())

``fit`` (the training half) and ``generate`` (the serving half) are also
exposed at module level for cluster-less local runs; they run on ``cuda``
unless ``device="cpu"``.  ``Executable.fit`` delegates to ``fit`` (its
keyword arguments, ``device=`` and ``params=`` included, pass through) and
wires the elastic controller's telemetry hooks automatically; like the
reference's, it trains the whole model on the local device and does not run
the plan's stage split.  ``Executable.stage_mesh`` materializes one stage's
intra-op plan as a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group the caller has initialised.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.comm.selector import collective_breakdown
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import HeteroCluster, cluster_fingerprint
from repro_torch.core.layering import Layer, build_layers
from repro_torch.core.opgraph import build_op_sequence
from repro_torch.core.pipesim import SimResult, simulate
from repro_torch.core.planner import HAPTPlanner
from repro_torch.core.strategy import IntraOpPlan, ParallelStrategy
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models.api import MODALITY, modality_inputs
from repro_torch.models.prefill import prefill
from repro_torch.parallel.sharding import (
    batch_shard_sizes, intra_op_mesh_axes, mesh_from_intra_op,
)
from repro_torch.runtime.controller import (
    ControllerConfig, ElasticController, ReplanDecision,
)
from repro_torch.runtime.events import EventTrace
from repro_torch.runtime.replay import ReplayResult, run_replay, sync_priced_step
from repro_torch.serve.step import (
    greedy_tokens, gumbel_noise, make_serve_step, sample_tokens,
)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer

from repro_torch.api import registry
from repro_torch.api.artifacts import (
    SCHEMA_VERSION, LoweredPlan, Plan, StageLowering, cluster_to_dict,
    sim_summary,
)
from repro_torch.api.config import HarpConfig

_DEPRECATION_WARNED: set = set()


def warn_deprecated(key: str, message: str) -> None:
    """Warn-once deprecation shim used by the legacy call paths."""
    if key in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def _resolve_arch(arch: Union[str, ArchConfig]) -> ArchConfig:
    return get_config(arch) if isinstance(arch, str) else arch


def _build_layers(arch: ArchConfig, cfg: HarpConfig) -> List[Layer]:
    ops = build_op_sequence(arch, seq_len=cfg.seq_len)
    return build_layers(ops, cfg.planner.granularity, z=cfg.planner.z_heavy)


# ---------------------------------------------------------------------------
# Stage 1: plan
# ---------------------------------------------------------------------------


def plan(arch: Union[str, ArchConfig], cluster: HeteroCluster,
         config: Optional[HarpConfig] = None, *,
         verbose: bool = False) -> Plan:
    """Run the HAPT search and wrap the result with provenance.

    The returned :class:`Plan` is self-contained: it embeds the serialized
    cluster spec, the exact config, and the predicted step simulation under
    the *named* scheduler, so ``lower()``/``compile(plan=...)`` reproduce the
    same execution on any machine."""
    cfg = (config if config is not None else HarpConfig()).validate()
    arch_cfg = _resolve_arch(arch)
    strategy = HAPTPlanner(cluster, cfg.planner).plan(
        arch_cfg, seq_len=cfg.seq_len, global_batch=cfg.global_batch,
        verbose=verbose)
    sched = registry.resolve("scheduler", cfg.scheduler)
    counts = sched([s.t for s in strategy.stages], strategy.c_links,
                   strategy.n_microbatches)
    res = simulate([s.t_f for s in strategy.stages],
                   [s.t_b for s in strategy.stages],
                   strategy.c_links, strategy.n_microbatches, counts)
    serve = None
    if cfg.serving is not None:
        # the serving placement search reuses the training comm model (same
        # CommConfig knob) so KV handoffs are priced on the same tiered links
        # the planner saw; serving=None skips this branch entirely — the
        # off-state invariant (DESIGN.md §7)
        from repro_torch.comm.selector import CommModel
        from repro_torch.serving.placement import search_placement
        comm = CommModel(cluster, cfg.planner.comm)
        serve = search_placement(arch_cfg, cluster, cfg.serving, comm=comm,
                                 verbose=verbose).to_dict()
    return Plan(
        arch=arch_cfg.arch_id, strategy=strategy, config=cfg,
        cluster=cluster_to_dict(cluster),
        cluster_fingerprint=cluster_fingerprint(cluster),
        predicted=sim_summary(res, strategy.tokens_per_step()),
        serve=serve)


# ---------------------------------------------------------------------------
# Stage 2: lower
# ---------------------------------------------------------------------------


def _stage_intra_plan(s) -> IntraOpPlan:
    """The stage's intra-op plan, or the even degenerate one for strategies
    from the inter-op-only search (tp/dp still factorize the submesh)."""
    if s.intra_op is not None:
        return s.intra_op
    dp = max(1, s.dp)
    return IntraOpPlan(axis="data" if dp >= max(1, s.tp) else "tensor",
                       tp=max(1, s.tp), dp=dp,
                       shard_ratios=(1.0 / dp,) * dp,
                       comm_bytes=0.0, comm_time_f=0.0, comm_time_b=0.0)


def lower(plan_artifact: Plan, *,
          layers: Optional[Sequence[Layer]] = None) -> LoweredPlan:
    """Lower a :class:`Plan` to executable form: per-stage logical meshes
    (via ``parallel.sharding.intra_op_mesh_axes``), integer microbatch
    apportionment, warm-up counts from the config's named scheduler, and the
    collective plan (per-link activation bytes over the plan's layering)."""
    cfg = plan_artifact.config
    strategy = plan_artifact.strategy
    cluster = plan_artifact.to_cluster()
    arch_cfg = _resolve_arch(plan_artifact.arch)
    if layers is None:
        layers = _build_layers(arch_cfg, cfg)
    B = strategy.n_microbatches
    # exact by HarpConfig.validate() (global_batch % n_microbatches == 0)
    mb_samples = cfg.global_batch // B

    sched = registry.resolve("scheduler", cfg.scheduler)
    counts = [int(c) for c in
              sched([s.t for s in strategy.stages], strategy.c_links, B)]
    res = simulate([s.t_f for s in strategy.stages],
                   [s.t_b for s in strategy.stages],
                   strategy.c_links, B, counts)

    breakdown = collective_breakdown(strategy, cluster, layers)
    stages = []
    for i, s in enumerate(strategy.stages):
        io = _stage_intra_plan(s)
        axes = [[name, size] for name, size in intra_op_mesh_axes(io)]
        e = breakdown["stages"][i]
        stages.append(StageLowering(
            stage=i,
            subcluster=cluster.subclusters[s.cluster_idx].name,
            layer_start=s.layer_start, layer_end=s.layer_end,
            mesh_axes=axes, n_devices=s.n_devices,
            microbatch_shards=batch_shard_sizes(io, mb_samples),
            intra_comm_bytes=io.comm_bytes,
            intra_comm_time_s=io.comm_time,
            ar_algorithm=e["ar_algorithm"],
            sync_algorithm=e["sync_algorithm"],
            sync_compressed=e["sync_compressed"],
            sync_time_s=e["sync_time_s"],
            sync_link=e["sync_link"]))

    link_bytes = [
        layers[strategy.stages[i].layer_end - 1].act_out_bytes_per_token
        * strategy.mb_tokens
        for i in range(strategy.n_stages - 1)]

    return LoweredPlan(
        scheduler=cfg.scheduler, n_microbatches=B,
        microbatch_samples=mb_samples, warmup_counts=counts,
        c_links_s=[float(c) for c in strategy.c_links],
        link_bytes=link_bytes, stages=stages,
        est_step_time_s=res.makespan,
        link_ids=breakdown["link_ids"],
        link_occupancy_s=breakdown["link_occupancy_s"],
        contended_links=breakdown["contended_links"])


# ---------------------------------------------------------------------------
# Stage 3: Executable
# ---------------------------------------------------------------------------


class Executable:
    """A compiled (plan, lowering) pair bound to a concrete cluster.

    ``simulate()`` referee-prices the plan exactly like
    ``runtime.replay.sync_priced_step`` (amortized DP gradient sync charged
    identically to joint and inter-only plans), so numbers from the facade
    are comparable across search modes; ``simulate(priced=False)`` is the
    raw pipeline-DAG simulation of the lowered schedule."""

    def __init__(self, plan_artifact: Plan, lowered: LoweredPlan,
                 cluster: HeteroCluster, arch: ArchConfig,
                 layers: Sequence[Layer]):
        self.plan = plan_artifact
        self.lowered = lowered
        self.cluster = cluster
        self.arch = arch
        self.layers = list(layers)
        self.controller: Optional[ElasticController] = None
        self.drift_ledger = None    # obs.DriftLedger when config.obs is set
        #                             (wired by attach_elastic / fit)

    @property
    def strategy(self) -> ParallelStrategy:
        return self.plan.strategy

    @property
    def config(self) -> HarpConfig:
        return self.plan.config

    # -- inspection ----------------------------------------------------------

    def describe(self, *, timeline: bool = False, comm: bool = False) -> str:
        lines = [self.plan.describe(), self.lowered.describe()]
        if comm:
            lines.append(self.explain_comm())
        if timeline:
            # the ASCII timeline renders the same span model the Chrome
            # exporter serializes (obs.trace) — one source for both views
            from repro_torch.obs import render_ascii
            lines.append(render_ascii(self.trace(decisions=False), width=100))
        return "\n".join(lines)

    def trace(self, out: Optional[str] = None, *, priced: bool = False,
              contention: bool = False, decisions: bool = True):
        """Lower this executable's one-step simulation into the typed span
        model (:class:`repro_torch.obs.Trace`) — per-stage compute lanes with
        warmup/steady/cooldown phases, per-boundary comm lanes, link-busy
        counters — plus a controller-decision track when an elastic
        controller with decisions is attached.

        ``out`` additionally writes Chrome-trace JSON (load in Perfetto /
        ``chrome://tracing``).  Pure lowering of already-computed timing
        artifacts: nothing is re-simulated beyond the (memoized)
        ``simulate()`` call itself."""
        from repro_torch.obs import (trace_from_decisions, trace_from_sim,
                               trace_to_chrome)
        res = self.simulate(priced=priced, contention=contention)
        tr = trace_from_sim(
            res, name=f"{self.plan.arch}"
                      f"@{self.plan.cluster_fingerprint[:8]}")
        tr.meta["arch"] = self.plan.arch
        tr.meta["priced"] = priced
        tr.meta["contention"] = contention
        if decisions and self.controller is not None \
                and self.controller.decisions:
            tr.extend(trace_from_decisions(self.controller.decisions))
        if out is not None:
            trace_to_chrome(tr, out)
        return tr

    def explain_comm(self) -> str:
        """Per-stage collective breakdown: selected algorithm, payload
        bytes, priced time, and the physical links each collective occupies
        (``ring*`` marks the legacy implicit flat ring of plans searched
        without a comm model)."""
        bd = collective_breakdown(self.strategy, self.cluster, self.layers)
        lines = ["collective breakdown (per stage):"]
        for e in bd["stages"]:
            ar = e["ar_algorithm"] or ("ring*" if e["ar_time_s"] > 0 else "-")
            sync = e["sync_algorithm"] or \
                ("ring*" if e["sync_time_s"] > 0 else "-")
            if e["sync_compressed"]:
                sync += "+int8"
            lines.append(
                f"  stage{e['stage']} [{e['subcluster']}] tp={e['tp']} "
                f"dp={e['dp']}: ar={ar} {e['ar_time_s'] * 1e3:.2f}ms/mb on "
                f"{e['ar_link']}; sync={sync} "
                f"{e['sync_time_s'] * 1e3:.2f}ms/step on {e['sync_link']}; "
                f"payload {e['comm_bytes'] / 1e6:.2f} MB/mb")
        if bd["link_ids"]:
            lines.append("  boundary links: " + ", ".join(
                f"{i}->{i + 1}:{l}" for i, l in enumerate(bd["link_ids"])))
        occ = ", ".join(f"{l}={t * 1e3:.1f}ms"
                        for l, t in sorted(bd["link_occupancy_s"].items()))
        lines.append(f"  link occupancy per step: {occ or 'none'}")
        lines.append("  contended links: "
                     + (", ".join(bd["contended_links"]) or "none"))
        return "\n".join(lines)

    def explain_costs(self) -> str:
        """Per-stage price provenance: measured (kbench table) vs analytic.

        Re-prices every stage at its chosen tp both ways; stages on devices
        the table covers show the measured anchor MFU next to the spec-sheet
        ``base_mfu`` and the analytic price they displaced.  Without
        ``config.kbench`` (or with an empty/uncovering table) every stage is
        analytic — the fallback never errors."""
        from repro_torch.comm.selector import CommModel
        from repro_torch.core.costmodel import Submesh, intra_op_candidates
        from repro_torch.kbench.bridge import KBenchModel

        pcfg = self.config.planner
        kb = KBenchModel(pcfg.kbench) if pcfg.kbench is not None else None
        comm = CommModel(self.cluster, pcfg.comm) \
            if pcfg.comm is not None and pcfg.comm.enabled else None
        mb = self.strategy.mb_tokens
        lines = ["stage price provenance (per microbatch, f+b):"]
        for i, s in enumerate(self.strategy.stages):
            sub = self.cluster.subclusters[s.cluster_idx]
            mesh = Submesh(s.cluster_idx, s.mesh_n, s.mesh_m)
            joint = s.intra_op is not None
            stage_layers = self.layers[s.layer_start:s.layer_end]
            kw = dict(uneven=joint,
                      amortize_microbatches=pcfg.n_microbatches if joint else 0,
                      comm=comm)
            analytic = next(
                (c for c in intra_op_candidates(stage_layers, sub, mesh, mb,
                                                pcfg.cost, **kw)
                 if c.tp == s.tp), None)
            mfu = kb.measured_mfu(sub) if kb is not None else None
            tag = f"measured (mfu={mfu:.3f} vs base {sub.device.base_mfu:.3f})" \
                if mfu is not None else "analytic"
            line = (f"  stage{i} [{sub.name}] tp={s.tp} dp={s.dp}: "
                    f"t={(s.t_f + s.t_b) * 1e3:.2f}ms  source={tag}")
            if mfu is not None and analytic is not None:
                line += f"  (analytic would be {analytic.t * 1e3:.2f}ms)"
            lines.append(line)
        if kb is not None:
            lines.append("  " + kb.describe().replace("\n", "\n  "))
        else:
            lines.append("  kbench: off (analytic pricing everywhere)")
        return "\n".join(lines)

    # -- simulation ----------------------------------------------------------

    def sim_cache_stats(self) -> Dict[str, int]:
        """Counters of the process-wide pipesim memo (``core.pipesim``):
        repeated ``simulate()`` calls — warm elastic re-plans, repeated
        ``describe()``/``throughput()`` queries — are served from cache
        instead of re-solving the schedule."""
        from repro_torch.core.pipesim import sim_memo_stats
        s = sim_memo_stats()
        return {"hits": s.hits, "misses": s.misses,
                "fast_path": s.fast_path, "graph_path": s.graph_path}

    def simulate(self, *, priced: bool = True,
                 no_overlap: bool = False,
                 contention: bool = False,
                 share_links: bool = True,
                 trace_out: Optional[str] = None) -> SimResult:
        """One-step discrete-event simulation, served from the pipesim memo
        on repeat signatures (treat the result as immutable).
        ``priced=True`` (default) is the referee accounting
        (== ``sync_priced_step``); ``priced=False`` simulates the lowered
        schedule as-is.

        ``contention=True`` runs the fair-share occupancy engine instead:
        stage boundaries are mapped to their *physical* links (every
        cluster-crossing boundary shares ``"wan"``) and each stage's
        per-step gradient sync becomes an explicit transfer released after
        its last backward — so overlapping activation sends and grad syncs
        slow each other down.  The sync is removed from the amortized
        backward time first (no double counting), making this directly
        comparable to ``priced=True``.  ``share_links=False`` keeps the
        explicit syncs but gives every transfer a private link — the
        uncontended baseline that isolates the *sharing* cost from the
        injected sync work.

        ``trace_out`` additionally writes the result as Chrome-trace JSON
        (``obs.trace_from_sim`` — the returned numbers are unchanged)."""
        if contention:
            if no_overlap:
                raise ValueError("contention=True is overlap-mode only")
            strat = self.strategy
            bd = collective_breakdown(strat, self.cluster, self.layers)
            t_b, sync_work = [], []
            for i, s in enumerate(strat.stages):
                amort = s.intra_op.sync_time if s.intra_op is not None else 0.0
                t_b.append(s.t_b - amort)
                e = bd["stages"][i]
                if e["sync_time_s"] > 0:
                    link = e["sync_link"] if share_links \
                        else f"__private_sync{i}"
                    sync_work.append((i, link, e["sync_time_s"]))
            res = simulate(
                [s.t_f for s in strat.stages], t_b, strat.c_links,
                strat.n_microbatches, self.lowered.warmup_counts,
                contention=True,
                link_ids=bd["link_ids"] if share_links else None,
                sync_work=sync_work)
        elif priced:
            res = sync_priced_step(
                self.strategy, self.cluster, self.layers,
                no_overlap=no_overlap,
                counts_fn=registry.resolve("scheduler",
                                           self.config.scheduler))
        else:
            strat = self.strategy
            res = simulate([s.t_f for s in strat.stages],
                           [s.t_b for s in strat.stages],
                           strat.c_links, strat.n_microbatches,
                           self.lowered.warmup_counts, no_overlap=no_overlap)
        if trace_out is not None:
            from repro_torch.obs import trace_from_sim, trace_to_chrome
            trace_to_chrome(trace_from_sim(res, name=self.plan.arch),
                            trace_out)
        return res

    def throughput(self, *, priced: bool = True) -> float:
        res = self.simulate(priced=priced)
        return self.strategy.tokens_per_step() / res.makespan

    def stage_mesh(self, stage: int, devices: Optional[Sequence[int]] = None,
                   *, device_type: str = "cuda"):
        """Materialize stage ``stage``'s logical mesh as a ``DeviceMesh``
        over global ranks ``devices`` (default: every rank of the
        initialised process group; see
        ``parallel.sharding.mesh_from_intra_op`` for the device-order
        contract on uneven plans).  Collective, unlike the reference's:
        every rank of the group calls it for every stage, in the same
        order (``mesh_from_intra_op``'s contract on ranks)."""
        return mesh_from_intra_op(
            _stage_intra_plan(self.strategy.stages[stage]), devices,
            device_type=device_type)

    # -- elastic runtime -----------------------------------------------------

    def attach_elastic(self, controller_cfg: Optional[ControllerConfig] = None,
                       telemetry=None) -> ElasticController:
        """Wire an :class:`ElasticController` around this executable, seeded
        with the compiled plan (no bootstrap re-search).  The controller's
        trainer hooks are then wired automatically by :meth:`fit`.

        Workload fields of a supplied ``ControllerConfig`` that are still at
        their class defaults are backfilled from this executable's config
        (so ``ControllerConfig(drift_threshold=0.1)`` tweaks one knob
        without re-stating the workload); an explicitly different workload
        raises — the controller would replan for the wrong shape."""
        import dataclasses

        cfg = self.config
        ccfg = controller_cfg or cfg.elastic or ControllerConfig(
            total_steps=cfg.trainer.total_steps, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch)
        d = ControllerConfig()
        fill = {}
        for fld, want in (("seq_len", cfg.seq_len),
                          ("global_batch", cfg.global_batch),
                          ("total_steps", cfg.trainer.total_steps)):
            have = getattr(ccfg, fld)
            if have == getattr(d, fld) and have != want:
                fill[fld] = want
            elif fld != "total_steps" and have != want:
                raise ValueError(
                    f"attach_elastic: controller {fld}={have} disagrees "
                    f"with the compiled plan's {fld}={want}")
        if fill:
            ccfg = dataclasses.replace(ccfg, **fill)
        # chaos wiring (schema v7): a FaultInjector when cfg.chaos is set,
        # and the serving config so pool-structure changes re-run the
        # serving placement through the hardened path.  chaos=None and
        # serving=None leave both hooks off — the off-state invariant.
        injector = None
        if cfg.chaos is not None:
            from repro_torch.chaos.inject import FaultInjector
            injector = FaultInjector(cfg.chaos)
        ctrl = ElasticController(self.cluster, self.arch,
                                 planner_cfg=cfg.planner, cfg=ccfg,
                                 telemetry=telemetry, injector=injector,
                                 serving_cfg=cfg.serving)
        if self.plan.serve is not None:
            from repro_torch.serving.placement import ServePlan
            ctrl.serve_plan = ServePlan.from_dict(self.plan.serve)
        # seed with a copy — the controller retunes its strategy in place,
        # which must not mutate the immutable Plan artifact
        ctrl.strategy = ParallelStrategy.from_json(self.strategy.to_json())
        ctrl.plan_cluster = self.cluster
        # seeding from a compiled plan IS a successful bootstrap — the
        # degraded ladder's never-raise guarantee starts here
        ctrl._bootstrapped = True
        ctrl.decisions.append(ReplanDecision(
            step=0, action="none", reason="seeded from compiled plan",
            step_time_after=ctrl.strategy.est_step_time))
        # obs wiring (schema v8): a record-only drift ledger holding the
        # compiled plan's prediction to account.  obs=None leaves the hook
        # off — and even when wired it never alters a controller decision.
        if cfg.obs is not None:
            ledger = cfg.obs.ledger()
            ledger.register_plan(self.plan.predicted,
                                 stage_pools=self._stage_pools())
            ctrl.drift_ledger = ledger
            self.drift_ledger = ledger
        self.controller = ctrl
        return ctrl

    def _stage_pools(self) -> Dict[int, str]:
        """stage index -> sub-cluster (pool) name, for per-pool drift."""
        return {i: self.cluster.subclusters[s.cluster_idx].name
                for i, s in enumerate(self.strategy.stages)}

    def drift_report(self):
        """The attached drift ledger's current :class:`obs.DriftReport`
        (predicted vs observed step times; needs ``config.obs`` and an
        ``attach_elastic()``/``fit()`` that observed steps)."""
        if self.drift_ledger is None:
            raise ValueError(
                "no drift ledger — set HarpConfig.obs and attach_elastic() "
                "or fit() first")
        return self.drift_ledger.report()

    def replay(self, trace: Union[str, EventTrace], n_steps: int, *,
               elastic: bool = True, trace_out: Optional[str] = None,
               **trace_kw) -> ReplayResult:
        """Replay a fleet-dynamics trace against this executable.  ``trace``
        is an :class:`EventTrace` or a registered event-source name
        (``"paper"``, ``"random"``, ...); elastic mode routes events through
        the attached (or newly attached) controller, static mode keeps the
        compiled plan and stalls through infeasible periods.

        With ``config.obs.run_log`` set, every step and controller decision
        is appended to the JSONL run-log on the replay's own wall clock.
        ``trace_out`` writes a Chrome trace: the pipeline lanes of the
        compiled plan plus a controller-decision track with one span per
        :class:`ReplanDecision`, placed at its replay wall time."""
        if isinstance(trace, str):
            trace = registry.resolve("event_source", trace)(
                self.cluster, n_steps, **trace_kw)
        sink = None
        obs_cfg = self.config.obs
        if obs_cfg is not None and obs_cfg.run_log:
            from repro_torch.obs import RunLog
            sink = RunLog(obs_cfg.run_log)
        try:
            if elastic:
                ctrl = self.controller or self.attach_elastic()
                result = run_replay(trace, n_steps, controller=ctrl,
                                    sink=sink)
            else:
                result = run_replay(trace, n_steps, strategy=self.strategy,
                                    plan_cluster=self.cluster,
                                    layers=self.layers, sink=sink)
        finally:
            if sink is not None:
                sink.close()
        if trace_out is not None:
            from repro_torch.obs import (trace_from_decisions, trace_from_sim,
                                   trace_to_chrome)
            tr = trace_from_sim(self.simulate(priced=False),
                                name=f"{self.plan.arch} replay")
            if result.decisions:
                # decision spans on the replay wall clock: each decision at
                # the wall where its step landed (step index when stalled
                # before the first sample)
                wall = {s.step: s.wall_s for s in result.samples}
                tr.extend(trace_from_decisions(result.decisions,
                                               wall_times=wall))
            tr.meta["tokens_total"] = result.tokens_total
            tr.meta["wall_total_s"] = result.wall_total_s
            tr.meta["stalled_steps"] = result.stalled_steps
            trace_to_chrome(tr, trace_out)
        return result

    def migrate_to(self, target: Union["Executable", Plan, HeteroCluster], *,
                   opt_bytes_per_param: float = 2.0,
                   restore_bw: Optional[float] = None,
                   overlap: bool = True,
                   verbose: bool = False) -> "Executable":
        """Plan the live move of this executable's state onto ``target``.

        ``target`` is a new fleet (a fresh HAPT search runs on it), or an
        already-planned :class:`Plan`/:class:`Executable`.  The exact
        per-device byte layouts of both plans are diffed
        (``repro_torch.migrate``): only *moved* bytes ship, each from the nearest
        surviving replica (or the checkpoint when no replica survived a
        shrink), priced through the comm topology's tiered links overlapped
        with this plan's drain.  Returns the target compiled as a new
        :class:`Executable` whose ``plan.migration`` section carries the
        full priced transfer summary (schema v5)."""
        import dataclasses as _dc

        from repro_torch.migrate import (
            DEFAULT_RESTORE_BW, diff_layouts, layout_from_strategy,
            lost_devices, price_migration,
        )

        if isinstance(target, Executable):
            new_plan, new_cluster = target.plan, target.cluster
        elif isinstance(target, Plan):
            new_plan, new_cluster = target, target.to_cluster()
        elif isinstance(target, HeteroCluster):
            new_plan, new_cluster = plan(self.arch, target, self.config,
                                         verbose=verbose), target
        else:
            raise TypeError(
                f"migrate_to() takes an Executable, Plan, or HeteroCluster, "
                f"not {type(target).__name__}")
        if new_plan.arch != self.plan.arch:
            raise ValueError(
                f"migrate_to(): cannot migrate {self.plan.arch} state onto "
                f"a {new_plan.arch} plan")
        for fld in ("seq_len",):
            if getattr(new_plan.config, fld) != getattr(self.config, fld):
                raise ValueError(f"migrate_to(): target plan's {fld} differs "
                                 f"— state layouts would not correspond")
        for fld in ("granularity", "z_heavy"):
            if getattr(new_plan.config.planner, fld) != \
                    getattr(self.config.planner, fld):
                raise ValueError(
                    f"migrate_to(): target plan's layering ({fld}) differs — "
                    f"leaf-to-leaf correspondence needs the same layering")

        old_lay = layout_from_strategy(
            self.strategy, self.cluster, self.layers,
            opt_bytes_per_param=opt_bytes_per_param)
        new_lay = layout_from_strategy(
            new_plan.strategy, new_cluster, self.layers,
            opt_bytes_per_param=opt_bytes_per_param)
        lost = lost_devices(self.cluster, new_cluster)
        mplan = diff_layouts(old_lay, new_lay, lost=lost)
        cost = price_migration(
            mplan, old_lay, new_cluster,
            old_strategy=self.strategy, old_cluster=self.cluster,
            layers=self.layers,
            restore_bw=restore_bw if restore_bw is not None
            else DEFAULT_RESTORE_BW,
            overlap=overlap)
        migration = {
            "from_fingerprint": self.plan.cluster_fingerprint,
            "to_fingerprint": new_plan.cluster_fingerprint,
            "moved_bytes": int(mplan.moved_bytes),
            "ckpt_bytes": int(mplan.ckpt_bytes),
            "local_bytes": int(mplan.local_bytes),
            "total_bytes": int(mplan.total_bytes),
            "n_transfers": int(mplan.n_transfers),
            "link_bytes": {k: int(v) for k, v in
                           sorted(cost.link_bytes.items())},
            "serial_s": float(cost.serial_s),
            "drain_s": float(cost.drain_s),
            "downtime_s": float(cost.downtime_s),
            "overlapped": bool(cost.overlapped),
        }
        stamped = _dc.replace(new_plan, migration=migration,
                              version=SCHEMA_VERSION)
        return compile(cluster=new_cluster, plan_artifact=stamped)

    # -- serving -------------------------------------------------------------

    def serve_simulate(self, trace=None, *, qps: Optional[float] = None,
                       duration_s: Optional[float] = None,
                       seed: Optional[int] = None,
                       trace_out: Optional[str] = None):
        """Replay a request trace through this plan's serving placement
        (the event-driven continuous-batching simulator,
        :func:`repro_torch.serving.batching.simulate_trace`).

        ``trace`` is a :class:`~repro_torch.serving.workload.ServeTrace` (remapped
        to ``qps`` when given); without one, a Poisson trace is drawn from
        the compiled :class:`ServingConfig` with any of ``qps`` /
        ``duration_s`` / ``seed`` overridden.  Requires the plan to have been
        compiled with ``config.serving`` set."""
        if self.plan.serve is None:
            raise ValueError(
                "serve_simulate() needs a serving plan — compile with "
                "HarpConfig(serving=ServingConfig(...)) first")
        from repro_torch.serving.batching import simulate_trace
        from repro_torch.serving.placement import ServePlan
        from repro_torch.serving.workload import poisson_trace
        splan = ServePlan.from_dict(self.plan.serve)
        scfg = self.config.serving
        if trace is None:
            trace = poisson_trace(
                qps if qps is not None else scfg.qps,
                duration_s if duration_s is not None else scfg.duration_s,
                seed=seed if seed is not None else scfg.seed,
                prompt_mean=scfg.prompt_mean, output_mean=scfg.output_mean)
        elif qps is not None:
            trace = trace.remapped(qps)
        if trace_out is None:
            return simulate_trace(splan, trace)
        # record dispatches and lower them to per-pool Chrome-trace lanes
        # on the simulator's event-heap clock (timestamps never wall time)
        from repro_torch.obs import trace_from_serve, trace_to_chrome
        recorder: List = []
        res = simulate_trace(splan, trace, recorder=recorder)
        tr = trace_from_serve(recorder, name=f"{self.plan.arch} serving")
        tr.meta["n_completed"] = res.n_completed
        tr.meta["n_rejected"] = res.n_rejected
        tr.meta["n_handoffs"] = res.n_handoffs
        trace_to_chrome(tr, trace_out)
        return res

    # -- training ------------------------------------------------------------

    def fit(self, **kwargs) -> Dict[str, Any]:
        """Train under this executable's config through :func:`fit`, which
        takes every keyword argument (``device=``, ``params=``, ``seed=``,
        ...); on ``cuda`` unless ``device="cpu"``.  An attached elastic
        controller's telemetry hooks are wired in unless the caller passes
        explicit hooks.

        With ``config.obs`` set, measured step times also feed the drift
        ledger (unless an attached controller already does) and, when
        ``obs.run_log`` names a path, a JSONL run-log on the trainer's own
        clock — record-only, the training loop is unchanged."""
        if self.controller is not None:
            kwargs.setdefault("on_step_time", self.controller.on_step_time)
            kwargs.setdefault("on_straggler", self.controller.on_straggler)
        obs_cfg = self.config.obs
        if obs_cfg is None:
            return fit(self.arch, self.config, **kwargs)
        if self.drift_ledger is None:
            self.drift_ledger = obs_cfg.ledger()
            self.drift_ledger.register_plan(self.plan.predicted,
                                            stage_pools=self._stage_pools())
        ledger = self.drift_ledger
        # an attached controller feeds the ledger from its own hook;
        # feeding it here too would double-count every step
        feed_ledger = self.controller is None \
            or getattr(self.controller, "drift_ledger", None) is not ledger
        sink = None
        if obs_cfg.run_log:
            from repro_torch.obs import RunLog
            sink = RunLog(obs_cfg.run_log)
        inner = kwargs.get("on_step_time")
        t_acc = [0.0]   # trainer-clock seconds, never time.time()

        def on_step_time(step, step_time, *a, **kw):
            t_acc[0] += step_time
            if feed_ledger:
                ledger.observe_step(step, step_time)
            if sink is not None:
                sink.emit("step", t_acc[0], step=step,
                          step_time_s=step_time)
            if inner is not None:
                return inner(step, step_time, *a, **kw)
            return None

        kwargs["on_step_time"] = on_step_time
        try:
            return fit(self.arch, self.config, **kwargs)
        finally:
            if sink is not None:
                sink.close()


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


def compile(arch: Union[str, ArchConfig, None] = None,
            cluster: Optional[HeteroCluster] = None,
            config: Optional[HarpConfig] = None, *,
            plan_artifact: Optional[Plan] = None,
            verbose: bool = False) -> Executable:
    """Plan -> lower -> executable, in one call.

    Either pass ``(arch, cluster[, config])`` to search from scratch, or
    ``plan_artifact=Plan.from_json(...)`` to lower a previously-searched plan
    (optionally overriding ``cluster`` with the live fleet; a fingerprint
    mismatch warns — the plan was priced for a different fleet)."""
    if plan_artifact is None:
        if arch is None or cluster is None:
            raise TypeError("compile() needs (arch, cluster) or plan_artifact")
        plan_artifact = plan(arch, cluster, config, verbose=verbose)
    if cluster is None:
        cluster = plan_artifact.to_cluster()
    elif cluster_fingerprint(cluster) != plan_artifact.cluster_fingerprint:
        warnings.warn(
            "compile(): cluster fingerprint differs from the plan's — the "
            "strategy was priced for a different fleet; predicted times are "
            "not transferable (attach_elastic() to replan on drift)",
            stacklevel=2)
    arch_cfg = _resolve_arch(plan_artifact.arch)
    layers = _build_layers(arch_cfg, plan_artifact.config)
    lowered = lower(plan_artifact, layers=layers)
    return Executable(plan_artifact, lowered, cluster, arch_cfg, layers)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(arch: Union[str, ArchConfig],
        config: Optional[HarpConfig] = None, *,
        train_step: Optional[Callable] = None,
        state: Optional[Dict[str, Any]] = None,
        data_cfg: Optional[DataConfig] = None,
        optimizer: Optional[OptimizerConfig] = None,
        n_microbatches: int = 1,
        on_step_time: Optional[Callable] = None,
        on_straggler: Optional[Callable] = None,
        log_fn: Callable = print,
        clock: Optional[Callable[[], float]] = None,
        start_step: Optional[int] = None,
        seed: int = 0,
        device: DeviceLike = None,
        params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Config -> model -> AdamW -> the fault-tolerant :class:`Trainer` loop.

    Runs on ``cuda`` unless ``device="cpu"``, with the port's kernels on
    (flash attention for the dense, MoE, VLM and audio families, the SSD
    intra-chunk kernel for the SSM family, both for the hybrid family: its
    SSD layers and its shared attention block).  The MoE family's loss adds
    the layers' router aux losses (``aux_loss`` in each step's metrics).
    Pass ``train_step`` + ``state`` to run a custom step function; otherwise
    the arch's model is built, its params drawn from a generator seeded by
    ``seed`` (or taken from ``params``, a dict of tensors on the device), and
    AdamW with ``warmup_steps=min(20, total_steps)``.  ``config.data`` (or a
    ``DataConfig`` derived from the arch) feeds the deterministic synthetic
    pipeline, which makes tokens and labels only: the VLM and audio
    families, whose batches also need ``image_embeds`` / ``frames``, train
    only through a ``train_step`` that adds them (without one, ``fit``
    raises ``ValueError`` before it builds anything).  Returns
    ``{"final_step", "history", "state"}``; the state is updated in place,
    step by step."""
    cfg = config if config is not None else HarpConfig()
    arch_cfg = _resolve_arch(arch)
    if train_step is None and arch_cfg.family in MODALITY:
        raise ValueError(
            f"fit({arch_cfg.arch_id!r}): the {arch_cfg.family} family's batches "
            f"need {MODALITY[arch_cfg.family][0]!r}, which the synthetic "
            f"pipeline does not make; pass train_step=... and state=... with "
            f"a step that adds it")
    if train_step is None:
        opt_cfg = optimizer or OptimizerConfig(
            warmup_steps=min(20, cfg.trainer.total_steps),
            total_steps=cfg.trainer.total_steps)
        step_fn, model, opt_init = make_train_step(
            arch_cfg, opt_cfg, n_microbatches=n_microbatches,
            device=resolve_device(device))
        if params is None:
            params = model.init(generator(model.device, seed))
        state = {"params": params, "opt_state": opt_init(params)}
    else:
        if state is None:
            raise TypeError("fit(train_step=...) also needs state=...")
        step_fn = train_step
    data = data_cfg or cfg.data or DataConfig(
        vocab_size=arch_cfg.vocab_size, seq_len=cfg.seq_len,
        global_batch=cfg.global_batch, seed=seed)
    trainer = Trainer(cfg.trainer, data, step_fn, state,
                      on_straggler=on_straggler, on_step_time=on_step_time,
                      log_fn=log_fn,
                      clock=clock if clock is not None else time.perf_counter)
    return trainer.run(start_step)


def generate(arch: Union[str, ArchConfig], *,
             batch: int = 4, prompt_len: int = 32, gen_tokens: int = 32,
             seed: int = 0, greedy: bool = True, temperature: float = 1.0,
             use_kernels: bool = True, reduced: bool = False,
             log_fn: Optional[Callable] = None, device: DeviceLike = None,
             params: Optional[Dict[str, Any]] = None,
             prompt: Optional[Any] = None) -> Dict[str, Any]:
    """Prefill a prompt batch, then batched greedy or temperature decode.

    Runs on ``cuda`` unless ``device="cpu"``.  Params come from the port's
    own init with a generator seeded by ``seed``, unless ``params`` is given
    (a dict of tensors on the device, e.g. from ``convert.params_from_jax``);
    the prompt is drawn from the same generator unless ``prompt`` (B, P)
    integer tokens are given.  The dense and MoE families' KV cache is
    bfloat16, (L, B, S, KV, D), as in the reference; the SSM family's decode
    state is float32 and does not grow with the sequence (``pos`` is unused
    by its decode step); the hybrid family's cache holds both: float32 SSD
    states per SSD layer beside a bfloat16 KV cache per application of its
    shared attention block, (n_apps, B, S, KV, D).  The VLM's and the audio
    family's stub frontend inputs, ``image_embeds`` (B, n_image_tokens, d)
    and ``frames`` (B, enc_frames, d), are drawn as 0.02 N(0, 1) from the
    generator after the prompt, as the reference does; their caches add
    each cross layer's bfloat16 K/V of that memory.  MoE routing capacity is
    taken over the tokens of each call: B * prompt_len in the prefill, B in
    each decode step.

    Returns ``{"tokens": (B, gen_tokens) int array, "prefill_s",
    "decode_s", "decode_tokens_per_s"}``.  The first generated token comes
    from the prefill logits."""
    cfg = _resolve_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    serve_step, model, _ = make_serve_step(
        cfg, use_kernels=use_kernels, greedy=greedy, temperature=temperature,
        device=dev)
    gen = generator(dev, seed)
    if params is None:
        params = model.init(gen)
    if prompt is None:
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen, device=dev)
    else:
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=dev)
        batch, prompt_len = tokens.shape
    total = prompt_len + gen_tokens
    feed = {"tokens": tokens, **modality_inputs(cfg, batch, gen)}

    _sync(dev)
    t0 = time.perf_counter()
    last_logits, cache = prefill(cfg, params, feed, cache_len=total,
                                 use_kernels=use_kernels)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    if log_fn:
        log_fn(f"[serve] prefill {batch}x{prompt_len} ({cfg.arch_id}): "
               f"{prefill_s * 1e3:.0f} ms")

    if greedy:
        tok = greedy_tokens(last_logits)
    else:
        tok = sample_tokens(last_logits[:, -1], temperature,
                            gumbel_noise(last_logits[:, -1].shape, gen))
    toks = [tok]
    t0 = time.perf_counter()
    # the prefill logits supplied token 1; decode the remaining gen_tokens-1
    for t in range(prompt_len, prompt_len + gen_tokens - 1):
        if greedy:
            tok, cache = serve_step(params, cache, tok, t)
        else:
            tok, cache = serve_step(params, cache, tok, t, gen)
        toks.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    n_decoded = batch * (gen_tokens - 1)
    tps = n_decoded / decode_s if decode_s > 0 else 0.0
    if log_fn:
        log_fn(f"[serve] {gen_tokens} tokens x {batch} seqs in "
               f"{decode_s * 1e3:.0f} ms ({tps:.0f} tok/s "
               f"{'greedy' if greedy else f'T={temperature}'})")
    return {"tokens": torch.cat(toks, dim=1).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tokens_per_s": tps}
