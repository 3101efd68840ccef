"""Named-component registry for the compile pipeline.

Cost models, pipeline schedulers and event sources are selected *by name*
in :class:`~repro_torch.api.config.HarpConfig`, so a plan artifact can say
``"scheduler": "h1f1b"`` instead of embedding a callable — and third-party
code can plug in alternatives without touching the facade:

    from repro_torch.api import registry

    @registry.scheduler("my_sched")
    def my_counts(t_per_stage, c_links, n_microbatches):
        return [1] * len(t_per_stage)

Registered kinds and their contracts (all times seconds):

- ``scheduler``: ``fn(t_per_stage, c_links, n_microbatches) -> List[int]``
  (per-stage warm-up counts, the 1F1B family's only degree of freedom).
- ``cost_model``: ``fn() -> CostModelConfig`` (factory, so each plan gets a
  fresh value).
- ``event_source``: ``fn(cluster, n_steps, **kw) -> EventTrace``.
- ``cluster``: ``fn(**kw) -> HeteroCluster`` (the canonical fleets, for the
  CLI and config files).
- ``collective``: a :class:`repro_torch.comm.algorithms.CollectiveAlgorithm`
  instance.  This kind is *backed by* ``repro_torch.comm.algorithms.ALGORITHMS``
  (the planner resolves algorithms there without importing the api
  package), so registrations through either door are visible to both.
- ``serve_trace``: ``fn(serving_cfg, **kw) -> ServeTrace`` (request-arrival
  generators for the serving simulator; the CLI's ``simulate --trace``
  resolves here).
- ``device``: a :class:`repro_torch.core.cluster.DeviceProfile` instance (the
  canonical fleet archetypes; ``benchmarks/roofline.py`` and the
  ``repro_torch kbench`` CLI resolve devices by name here).
- ``trace_adapter``: ``fn(artifact, **kw) -> repro_torch.obs.Trace`` (lowerings
  of existing timing artifacts into the typed span model; built-ins
  ``sim`` / ``netsim`` / ``migration`` / ``serve`` / ``decisions`` wrap
  the :mod:`repro_torch.obs.trace` adapters).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from repro_torch.comm import algorithms as _collectives
from repro_torch.core import cluster as _cluster_lib
from repro_torch.core.costmodel import CostModelConfig
from repro_torch.core.h1f1b import (
    classic_1f1b_counts, eager_1f1b_counts, h1f1b_counts,
)
from repro_torch.runtime.events import EventTrace, paper_trace, random_trace
from repro_torch.serving.workload import poisson_trace, scripted_trace

KINDS = ("scheduler", "cost_model", "event_source", "cluster", "collective",
         "serve_trace", "device", "trace_adapter")

_REGISTRY: Dict[str, Dict[str, Any]] = {k: {} for k in KINDS}


def register(kind: str, name: str, obj: Any, *, overwrite: bool = False) -> Any:
    """Register ``obj`` under (kind, name).  Returns ``obj`` so it can be
    used as a decorator body.  Re-registration requires ``overwrite=True`` —
    silent shadowing of a built-in would be a debugging trap."""
    if kind == "collective":
        return _collectives.register_collective(name, obj,
                                                overwrite=overwrite)
    if kind not in _REGISTRY:
        raise KeyError(f"unknown registry kind {kind!r}; kinds: {KINDS}")
    if name in _REGISTRY[kind] and not overwrite:
        raise ValueError(
            f"{kind} {name!r} already registered (pass overwrite=True)")
    _REGISTRY[kind][name] = obj
    return obj


def resolve(kind: str, name: str) -> Any:
    if kind == "collective":
        return _collectives.get_algorithm(name)
    if kind not in _REGISTRY:
        raise KeyError(f"unknown registry kind {kind!r}; kinds: {KINDS}")
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise KeyError(
            f"unknown {kind} {name!r}; available: {available(kind)}") from None


def available(kind: str) -> List[str]:
    if kind == "collective":
        return _collectives.available_collectives()
    return sorted(_REGISTRY[kind])


def scheduler(name: str) -> Callable:
    """Decorator: ``@registry.scheduler("name")`` registers a warm-up-count
    function."""
    return lambda fn: register("scheduler", name, fn)


def event_source(name: str) -> Callable:
    return lambda fn: register("event_source", name, fn)


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

register("scheduler", "h1f1b", h1f1b_counts)
register("scheduler", "classic_1f1b",
         lambda t, c, B: classic_1f1b_counts(len(t), B))
register("scheduler", "eager_1f1b",
         lambda t, c, B: eager_1f1b_counts(len(t), B))

register("cost_model", "analytic", CostModelConfig)

register("event_source", "paper",
         lambda cluster, n_steps=0, **kw: paper_trace(cluster, **kw))
register("event_source", "random", random_trace)
register("event_source", "none", lambda cluster, n_steps=0, **kw: EventTrace([]))


def _chaos_trace(cluster, n_steps=0, **kw):
    # lazy: keeps the chaos package off the import path of plain planning
    from repro_torch.chaos.faults import chaos_storm
    return chaos_storm(cluster, n_steps, **kw)


register("event_source", "chaos", _chaos_trace)

register("cluster", "paper_case_study", _cluster_lib.paper_case_study_cluster)
register("cluster", "paper_eval", _cluster_lib.paper_eval_cluster)
register("cluster", "homogeneous", _cluster_lib.homogeneous_cluster)
register("cluster", "tpu_multipod", _cluster_lib.tpu_multipod_cluster)
register("cluster", "heterogeneous_tpu", _cluster_lib.heterogeneous_tpu_cluster)


def _poisson_serve_trace(scfg, *, qps=None, duration_s=None, seed=None, **kw):
    return poisson_trace(
        qps if qps is not None else scfg.qps,
        duration_s if duration_s is not None else scfg.duration_s,
        seed=seed if seed is not None else scfg.seed,
        prompt_mean=scfg.prompt_mean, output_mean=scfg.output_mean, **kw)


def _scripted_serve_trace(scfg, *, qps=None, n_requests=None,
                          duration_s=None, seed=None, **kw):
    # seed accepted for interface parity; scripted arrivals are deterministic
    del seed
    q = qps if qps is not None else scfg.qps
    dur = duration_s if duration_s is not None else scfg.duration_s
    n = n_requests if n_requests is not None else max(1, int(q * dur))
    kw.setdefault("prompt_tokens", scfg.prompt_mean)
    kw.setdefault("output_tokens", scfg.output_mean)
    return scripted_trace(q, n, **kw)


register("serve_trace", "poisson", _poisson_serve_trace)
register("serve_trace", "scripted", _scripted_serve_trace)

for _name, _profile in _cluster_lib.DEVICE_PROFILES.items():
    register("device", _name, _profile)


def _lazy_trace_adapter(attr):
    # lazy: keeps the obs package off the import path of plain planning
    def _adapter(artifact, **kw):
        import repro_torch.obs as _obs
        return getattr(_obs, attr)(artifact, **kw)
    _adapter.__name__ = attr
    return _adapter


register("trace_adapter", "sim", _lazy_trace_adapter("trace_from_sim"))
register("trace_adapter", "netsim", _lazy_trace_adapter("trace_from_netsim"))
register("trace_adapter", "migration",
         _lazy_trace_adapter("trace_from_migration"))
register("trace_adapter", "serve", _lazy_trace_adapter("trace_from_serve"))
register("trace_adapter", "decisions",
         _lazy_trace_adapter("trace_from_decisions"))
