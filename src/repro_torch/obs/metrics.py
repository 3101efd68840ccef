"""Process-local metrics registry: counters / gauges / histograms with
labels, deterministic snapshots, and shims over the stack's pre-existing
scattered counters.

The registry is intentionally tiny and dependency-free (the planner stays
numpy-only; nothing here imports jax).  Series are keyed
``(name, sorted(label items))`` and snapshots render as
``name{k=v,...}`` in sorted order — two runs that record the same values
produce byte-identical snapshot dicts.

Back-compat shims (the old surfaces keep working; ``obs.metrics`` *reads*
them): :func:`sync_from_sim_memo` mirrors ``pipesim.sim_memo_stats()``
into ``sim_memo.*`` gauges, :func:`sync_from_injector` mirrors a chaos
``FaultInjector.stats()`` into ``chaos.*``, and
:func:`record_decision` folds one ``ReplanDecision`` into
``controller.*`` counters.  ``checkpoint/ckpt.py`` increments
``ckpt.bytes_written`` on the default registry at every save.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return (name, tuple(sorted(labels.items())))


def _render(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Counters (monotone), gauges (last value), histograms (count / sum /
    min / max).  ``snapshot()`` is a plain JSON-safe dict with
    deterministically ordered keys; ``reset()`` clears everything."""

    def __init__(self) -> None:
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, Dict[str, float]] = {}

    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels: Any) -> None:
        k = _key(name, labels)
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = {"count": 0, "sum": 0.0,
                                  "min": value, "max": value}
        h["count"] += 1
        h["sum"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "counters": {_render(k): self._counters[k]
                         for k in sorted(self._counters)},
            "gauges": {_render(k): self._gauges[k]
                       for k in sorted(self._gauges)},
            "histograms": {_render(k): dict(self._hists[k])
                           for k in sorted(self._hists)},
        }
        return out

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()


DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT_REGISTRY


# ---------------------------------------------------------------------------
# Shims over pre-existing counters
# ---------------------------------------------------------------------------


def sync_from_sim_memo(reg: Optional[MetricsRegistry] = None
                       ) -> MetricsRegistry:
    """Mirror the live ``pipesim.sim_memo_stats()`` counters into
    ``sim_memo.*`` gauges (the memo predates this registry and keeps its
    own counters; this reads, never resets)."""
    from repro_torch.core.pipesim import sim_memo_stats

    reg = reg if reg is not None else DEFAULT_REGISTRY
    s = sim_memo_stats()
    reg.gauge("sim_memo.hits", s.hits)
    reg.gauge("sim_memo.misses", s.misses)
    reg.gauge("sim_memo.fast_path", s.fast_path)
    reg.gauge("sim_memo.graph_path", s.graph_path)
    reg.gauge("sim_memo.contended_path", s.contended_path)
    return reg


def sync_from_injector(injector, reg: Optional[MetricsRegistry] = None
                       ) -> MetricsRegistry:
    """Mirror a chaos ``FaultInjector.stats()`` dict into ``chaos.<seam>``
    gauges."""
    reg = reg if reg is not None else DEFAULT_REGISTRY
    for seam, n in sorted(injector.stats().items()):
        reg.gauge("chaos.draws", n, seam=seam)
    return reg


def record_decision(d, reg: Optional[MetricsRegistry] = None
                    ) -> MetricsRegistry:
    """Fold one ``ReplanDecision`` into ``controller.*``: per-action
    counts, coalesced folds, downtime / search / migration seconds."""
    reg = reg if reg is not None else DEFAULT_REGISTRY
    reg.inc("controller.decisions", action=d.action)
    if d.coalesced:
        reg.inc("controller.coalesced", d.coalesced)
    reg.observe("controller.downtime_s", d.downtime_s)
    if d.search_time_s:
        reg.observe("controller.search_time_s", d.search_time_s)
    if d.migration_s:
        reg.observe("controller.migration_s", d.migration_s)
    if d.migration_bytes:
        reg.inc("controller.migration_bytes", d.migration_bytes)
    return reg


def record_serve_result(res, reg: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
    """Fold a ``ServeSimResult`` into ``serve.*`` (kv_violations — always 0
    by construction — rejections, handoffs, per-pool busy seconds)."""
    reg = reg if reg is not None else DEFAULT_REGISTRY
    reg.inc("serve.kv_violations", res.kv_violations)
    reg.inc("serve.rejected", res.n_rejected)
    reg.inc("serve.completed", res.n_completed)
    reg.inc("serve.handoffs", res.n_handoffs)
    reg.inc("serve.handoff_bytes", res.handoff_bytes)
    for pool, busy in sorted(res.pool_busy_s.items()):
        reg.gauge("serve.busy_s", busy["prefill"], pool=pool, kind="prefill")
        reg.gauge("serve.busy_s", busy["decode"], pool=pool, kind="decode")
    return reg
