"""Event-driven continuous-batching simulator (``comm/netsim.py`` style).

One global event heap drives per-pool serial engines.  Each pool runs one
unit of work at a time:

- a *prefill chunk* (``ServePlan.prefill_chunk`` tokens of the queue-head
  request, priced by the pool's ``prefill_chunk_s``), or
- a *decode step* (one token for every active sequence, priced by the
  roofline ``max(weights+KV reads / HBM, batch FLOPs / decode FLOPs)`` —
  small batches are bandwidth-bound on the weight sweep, large batches
  turn compute-bound).

``mixed`` pools alternate the two when both kinds of work are pending —
the prefill-decode interference that disaggregated placement removes.

Admission control (never OOM, the Eq.-18-analog contract):

- arrivals whose routed prefill queue is at ``max_queue`` are rejected;
- a finished prefill reserves its sequence's *worst-case* paged blocks
  (prompt + full output, :meth:`ServePlan.seq_blocks`) before its first
  decode step; requests that can never fit any decode pool are rejected,
  requests that transiently don't fit wait in the pool's ready queue
  (bounded by ``max_queue``, rejected beyond);
- the simulator asserts ``blocks_used <= blocks_capacity`` after every
  reservation and reports the violation count (always 0 by construction).

Prefill→decode KV handoff is priced through the plan's link tables
(:meth:`ServePlan.handoff_seconds`); same-pool handoff is free.

Determinism: the heap is keyed (time, seq#); no randomness anywhere, so a
(plan, trace) pair always produces identical samples.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.serving.objective import percentile
from repro_torch.serving.placement import ServePlan
from repro_torch.serving.workload import Request, ServeTrace


@dataclass
class _Seq:
    """Mutable per-request simulation state."""
    req: Request
    prefill_left: int
    prefill_pool: int = -1
    decode_pool: int = -1
    blocks: int = 0
    ctx: int = 0                  # tokens currently cached
    done: int = 0                 # output tokens produced
    t_first: float = -1.0
    t_last: float = -1.0


class _Pool:
    """One serial pool engine."""

    def __init__(self, idx: int, spec):
        self.idx = idx
        self.spec = spec
        self.prefill_q: deque = deque()     # _Seq awaiting/under prefill
        self.ready: deque = deque()         # _Seq with KV landed, not active
        self.active: List[_Seq] = []
        self.blocks_used = 0
        self.pending_blocks = 0             # ready + in-flight handoffs
        self.peak_blocks = 0
        self.queued_prefill_tokens = 0
        self.busy = False
        self.last_prefill = False
        self.busy_prefill_s = 0.0
        self.busy_decode_s = 0.0
        self.sum_ctx = 0

    @property
    def free_blocks_for_routing(self) -> int:
        return self.spec.blocks_capacity - self.blocks_used \
            - self.pending_blocks


@dataclass
class ServeSimResult:
    """Per-request latency samples + capacity/occupancy accounting."""
    n_completed: int
    n_rejected: int
    ttft_s: List[float]
    tpot_s: List[float]
    makespan_s: float
    completed_output_tokens: int
    goodput_output_tokens: int
    slo_ttft_s: float
    slo_tpot_s: float
    peak_blocks: Dict[str, int] = field(default_factory=dict)
    blocks_capacity: Dict[str, int] = field(default_factory=dict)
    kv_violations: int = 0
    n_handoffs: int = 0
    handoff_bytes: float = 0.0
    pool_busy_s: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def p50_ttft_s(self) -> float:
        return percentile(self.ttft_s, 50)

    @property
    def p99_ttft_s(self) -> float:
        return percentile(self.ttft_s, 99)

    @property
    def p50_tpot_s(self) -> float:
        return percentile(self.tpot_s, 50)

    @property
    def p99_tpot_s(self) -> float:
        return percentile(self.tpot_s, 99)

    @property
    def throughput_tokens_per_s(self) -> float:
        return self.completed_output_tokens / self.makespan_s \
            if self.makespan_s > 0 else 0.0

    @property
    def goodput_tokens_per_s(self) -> float:
        """Output tokens/s of requests that met both SLOs."""
        return self.goodput_output_tokens / self.makespan_s \
            if self.makespan_s > 0 else 0.0

    def summary(self) -> Dict[str, Any]:
        """JSON-stable digest (rides on ``ServePlan.predicted``)."""
        return {
            "n_completed": self.n_completed,
            "n_rejected": self.n_rejected,
            "p50_ttft_s": self.p50_ttft_s,
            "p99_ttft_s": self.p99_ttft_s,
            "p50_tpot_s": self.p50_tpot_s,
            "p99_tpot_s": self.p99_tpot_s,
            "makespan_s": self.makespan_s,
            "throughput_tokens_per_s": self.throughput_tokens_per_s,
            "goodput_tokens_per_s": self.goodput_tokens_per_s,
            "kv_violations": self.kv_violations,
            "n_handoffs": self.n_handoffs,
            "handoff_bytes": self.handoff_bytes,
            "peak_blocks": dict(self.peak_blocks),
        }

    def describe(self) -> str:
        return (f"{self.n_completed} completed / {self.n_rejected} rejected; "
                f"p99 TTFT {self.p99_ttft_s * 1e3:.1f} ms, "
                f"p99 TPOT {self.p99_tpot_s * 1e3:.2f} ms, "
                f"goodput {self.goodput_tokens_per_s:,.0f} tok/s "
                f"over {self.makespan_s:.2f} s")


def _decode_step_seconds(plan: ServePlan, pool: _Pool) -> float:
    """Roofline decode step: every active sequence reads the weights once
    (amortized across the batch) plus its own KV; compute is the batch's
    GEMV flops."""
    spec = pool.spec
    kv_bytes = pool.sum_ctx * plan.kv_bytes_per_token \
        + len(pool.active) * plan.state_bytes_per_seq
    t_mem = (spec.weights_bytes + kv_bytes) / spec.hbm_bytes_per_s
    t_flops = len(pool.active) * plan.flops_per_token / spec.decode_flops_per_s
    return max(t_mem, t_flops) + plan.step_overhead_s


def simulate_trace(plan: ServePlan, trace: ServeTrace,
                   recorder: Optional[List] = None) -> ServeSimResult:
    """Replay ``trace`` against ``plan``; deterministic.

    ``recorder`` (a list, appended in dispatch order) captures every
    prefill chunk and decode step as
    ``(t, dur, pool_idx, pool_name, kind, n)`` tuples — the raw material
    ``obs.trace_from_serve`` turns into per-pool Chrome-trace lanes.
    ``recorder=None`` (the default) changes nothing."""
    pools = [_Pool(i, spec) for i, spec in enumerate(plan.pools)]
    prefill_pools = [p for p in pools if p.spec.can_prefill]
    decode_pools = [p for p in pools if p.spec.can_decode]
    if not prefill_pools or not decode_pools:
        raise ValueError("ServePlan needs >=1 prefill-capable and >=1 "
                         "decode-capable pool")

    events: List = []               # (t, seq#, kind, payload)
    seq_no = 0

    def push(t: float, kind: str, payload) -> None:
        nonlocal seq_no
        heapq.heappush(events, (t, seq_no, kind, payload))
        seq_no += 1

    ttft: List[float] = []
    tpot: List[float] = []
    n_rejected = 0
    n_completed = 0
    completed_tokens = 0
    goodput_tokens = 0
    kv_violations = 0
    n_handoffs = 0
    handoff_bytes = 0.0
    makespan = 0.0
    rr_counter = 0                  # uniform routing cursor

    # -- routing -------------------------------------------------------------

    def route_prefill(s: _Seq) -> _Pool:
        nonlocal rr_counter
        if plan.routing == "uniform":
            pool = prefill_pools[rr_counter % len(prefill_pools)]
            rr_counter += 1
            return pool
        # least_loaded: smallest estimated queue drain time (queued tokens
        # at the pool's per-chunk rate); ties break on pool index
        return min(prefill_pools, key=lambda p: (
            (p.queued_prefill_tokens + s.req.prompt_tokens)
            * p.spec.prefill_chunk_s / plan.prefill_chunk,
            p.idx))

    def route_decode(s: _Seq, src: _Pool) -> Optional[_Pool]:
        blocks = plan.seq_blocks(s.req.prompt_tokens + s.req.output_tokens)
        if all(blocks > p.spec.blocks_capacity for p in decode_pools):
            return None             # can never fit anywhere
        if plan.routing == "uniform" and src.spec.can_decode:
            return src              # colocated: decode where you prefilled
        fits = [p for p in decode_pools if blocks <= p.spec.blocks_capacity
                and len(p.ready) < plan.max_queue]
        if not fits:
            return None             # every eligible ready queue is full
        # most free KV blocks wins; prefer the source pool on ties (free
        # handoff), then the lowest index
        return max(fits, key=lambda p: (p.free_blocks_for_routing,
                                        p is src, -p.idx))

    # -- pool engine ---------------------------------------------------------

    def admit(pool: _Pool) -> None:
        nonlocal kv_violations
        while pool.ready:
            s = pool.ready[0]
            if pool.blocks_used + s.blocks > pool.spec.blocks_capacity:
                break               # head-of-line waits for blocks to free
            pool.ready.popleft()
            pool.blocks_used += s.blocks
            pool.pending_blocks -= s.blocks
            if pool.blocks_used > pool.spec.blocks_capacity:
                kv_violations += 1  # unreachable by construction; counted
            pool.peak_blocks = max(pool.peak_blocks, pool.blocks_used)
            s.ctx = s.req.prompt_tokens
            pool.sum_ctx += s.ctx
            pool.active.append(s)

    def dispatch(pool: _Pool, t: float) -> None:
        if pool.busy:
            return
        admit(pool)
        has_prefill = pool.spec.can_prefill and bool(pool.prefill_q)
        has_decode = pool.spec.can_decode and bool(pool.active)
        if has_prefill and has_decode:
            do_prefill = not pool.last_prefill    # alternate: interference
        else:
            do_prefill = has_prefill
        if do_prefill:
            s = pool.prefill_q[0]
            chunk = min(s.prefill_left, plan.prefill_chunk)
            dur = pool.spec.prefill_chunk_s * chunk / plan.prefill_chunk
            pool.busy = True
            pool.last_prefill = True
            pool.busy_prefill_s += dur
            if recorder is not None:
                recorder.append((t, dur, pool.idx, pool.spec.name,
                                 "prefill", chunk))
            push(t + dur, "chunk", (pool.idx, s, chunk))
        elif has_decode:
            dur = _decode_step_seconds(plan, pool)
            pool.busy = True
            pool.last_prefill = False
            pool.busy_decode_s += dur
            if recorder is not None:
                recorder.append((t, dur, pool.idx, pool.spec.name,
                                 "decode", len(pool.active)))
            push(t + dur, "step", (pool.idx, list(pool.active)))

    # -- event handlers ------------------------------------------------------

    def on_arrive(t: float, s: _Seq) -> None:
        nonlocal n_rejected
        pool = route_prefill(s)
        if len(pool.prefill_q) >= plan.max_queue:
            n_rejected += 1
            return
        s.prefill_pool = pool.idx
        pool.prefill_q.append(s)
        pool.queued_prefill_tokens += s.req.prompt_tokens
        dispatch(pool, t)

    def on_chunk(t: float, pool: _Pool, s: _Seq, chunk: int) -> None:
        nonlocal n_rejected, n_handoffs, handoff_bytes
        pool.busy = False
        s.prefill_left -= chunk
        pool.queued_prefill_tokens -= chunk
        if s.prefill_left <= 0:
            pool.prefill_q.popleft()
            dst = route_decode(s, pool)
            if dst is None:
                n_rejected += 1
            else:
                s.decode_pool = dst.idx
                s.blocks = plan.seq_blocks(
                    s.req.prompt_tokens + s.req.output_tokens)
                dst.pending_blocks += s.blocks
                nbytes = plan.seq_kv_bytes(s.req.prompt_tokens)
                delay = plan.handoff_seconds(pool.idx, dst.idx, nbytes)
                if dst.idx != pool.idx:
                    n_handoffs += 1
                    handoff_bytes += nbytes
                push(t + delay, "ready", (dst.idx, s))
        dispatch(pool, t)

    def on_ready(t: float, pool: _Pool, s: _Seq) -> None:
        pool.ready.append(s)
        dispatch(pool, t)

    def on_step(t: float, pool: _Pool, batch: List[_Seq]) -> None:
        nonlocal n_completed, completed_tokens, goodput_tokens, makespan
        pool.busy = False
        for s in batch:
            s.done += 1
            s.ctx += 1
            pool.sum_ctx += 1
            if s.t_first < 0:
                s.t_first = t
            if s.done >= s.req.output_tokens:
                s.t_last = t
                pool.active.remove(s)
                pool.sum_ctx -= s.ctx
                pool.blocks_used -= s.blocks
                n_completed += 1
                completed_tokens += s.req.output_tokens
                makespan = max(makespan, t)
                t_ttft = s.t_first - s.req.arrival_s
                ttft.append(t_ttft)
                ok = t_ttft <= plan.slo_ttft_s
                if s.req.output_tokens > 1:
                    t_tpot = (s.t_last - s.t_first) \
                        / (s.req.output_tokens - 1)
                    tpot.append(t_tpot)
                    ok = ok and t_tpot <= plan.slo_tpot_s
                if ok:
                    goodput_tokens += s.req.output_tokens
        dispatch(pool, t)

    # -- run -----------------------------------------------------------------

    for r in trace.requests:
        push(r.arrival_s, "arrive",
             _Seq(req=r, prefill_left=r.prompt_tokens))

    while events:
        t, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            on_arrive(t, payload)
        elif kind == "chunk":
            pidx, s, chunk = payload
            on_chunk(t, pools[pidx], s, chunk)
        elif kind == "ready":
            pidx, s = payload
            on_ready(t, pools[pidx], s)
        else:
            pidx, batch = payload
            on_step(t, pools[pidx], batch)

    return ServeSimResult(
        n_completed=n_completed, n_rejected=n_rejected,
        ttft_s=ttft, tpot_s=tpot, makespan_s=makespan,
        completed_output_tokens=completed_tokens,
        goodput_output_tokens=goodput_tokens,
        slo_ttft_s=plan.slo_ttft_s, slo_tpot_s=plan.slo_tpot_s,
        peak_blocks={p.spec.name: p.peak_blocks for p in pools},
        blocks_capacity={p.spec.name: p.spec.blocks_capacity for p in pools},
        kv_violations=kv_violations,
        n_handoffs=n_handoffs, handoff_bytes=handoff_bytes,
        pool_busy_s={p.spec.name: {"prefill": p.busy_prefill_s,
                                   "decode": p.busy_decode_s}
                     for p in pools})
