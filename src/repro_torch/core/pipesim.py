"""Pipeline-DAG discrete-event simulator (paper §4.2's DAG made executable).

Nodes: F/B compute per (microbatch, stage), CF/CB communication per
(microbatch, link); edges: per-stage issue order (the schedule under test),
per-link in-order transmission (full duplex), and microbatch data
dependencies.  Start times solve the longest-path recurrence
``s(v) >= s(u) + d(u)`` exactly — no sampling.

Two engines produce bit-identical results:

- **closed-form fast path** (default when eligible): the 1F1B grid is
  static, so start times are filled by an index-based recurrence over
  (stage, microbatch) — no node dicts, no Kahn sort.  Eligible whenever the
  warm-up counts are non-increasing along the pipeline (every H-1F1B /
  classic / eager schedule qualifies) and sends overlap compute;
- **graph simulator** (fallback): the original explicit-DAG longest-path
  solve, kept as the reference oracle and for irregular schedules
  (``no_overlap`` synchronous sends, warm-up vectors that grow downstream).

Repeated calls are served from a bounded memo keyed on the full input
signature ``(t_f, t_b, comm, counts, intra)`` — warm elastic re-plans and
``api.Executable.simulate()`` hit cache instead of re-solving; counters are
exposed via :func:`sim_memo_stats`.  Treat returned :class:`SimResult`
objects as immutable (cache entries are shared).

Supports classic 1F1B / Eager-1F1B / H-1F1B (any warm-up count vector) and a
``no_overlap`` mode (HexiScale-like synchronous sends that block compute).

Outputs makespan, per-stage busy/idle/comm breakdown (paper Fig. 8), overlap
ratio, and the eta load-balance metric (Eq. 19).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Node = Tuple[str, int, int]  # (kind, microbatch, stage/link)


@dataclass
class SimResult:
    makespan: float
    start: Dict[Node, float]
    dur: Dict[Node, float]
    stage_compute: List[float]        # busy compute time per stage
    stage_comm_blocking: List[float]  # comm time charged to the stage (no_overlap)
    stage_idle: List[float]           # makespan - compute - blocking comm
    comm_total: float                 # total link-busy time (all links)
    comm_exposed: float               # comm time that delayed a compute op
    warmup_counts: List[int]
    stage_intra_comm: List[float] = field(default_factory=list)
    # exposed intra-op collective time per stage over the whole step (the
    # non-overlapped share of TP all-reduce / DP sync inside each F/B op)
    link_busy: Dict[str, float] = field(default_factory=dict)
    # contended engine only: seconds each physical link (by occupancy key,
    # "<link>/fwd" or "<link>/bwd") had at least one active transfer

    @property
    def overlap_ratio(self) -> float:
        if self.comm_total <= 0:
            return 1.0
        return max(0.0, 1.0 - self.comm_exposed / self.comm_total)

    def throughput(self, tokens_per_microbatch: int, n_microbatches: int) -> float:
        return tokens_per_microbatch * n_microbatches / self.makespan


def _stage_order(i: int, S: int, B: int, N_i: int) -> List[Tuple[str, int]]:
    """Issue order of compute ops on stage i: warm-up forwards, 1F1B steady
    alternation, cool-down backwards."""
    order: List[Tuple[str, int]] = []
    n_warm = min(N_i, B)
    for j in range(n_warm):
        order.append(("F", j))
    nf, nb = n_warm, 0
    while nb < B:
        order.append(("B", nb))
        nb += 1
        if nf < B:
            order.append(("F", nf))
            nf += 1
    return order


def fast_path_eligible(warmup_counts: Sequence[int],
                       no_overlap: bool = False) -> bool:
    """Can the closed-form recurrence evaluate this schedule?

    True iff sends overlap compute and the warm-up counts are non-increasing
    along the pipeline with every stage launching at least one warm-up
    forward.  (The recurrence processes ops in issue-order position; the
    monotone counts guarantee every cross-stage dependency lands at an
    earlier — or tie-broken earlier — position, which is exactly the shape
    of every H-1F1B / classic-1F1B / eager-1F1B schedule.)"""
    if no_overlap:
        return False
    prev: Optional[int] = None
    for c in warmup_counts:
        if c < 1:
            return False
        if prev is not None and c > prev:
            return False
        prev = c
    return True


# ---------------------------------------------------------------------------
# Closed-form fast path
# ---------------------------------------------------------------------------


def _simulate_fast(t_f: List[float], t_b: List[float],
                   c_links: Sequence[float], B: int,
                   warmup_counts: Sequence[int],
                   cb: List[float]) -> Tuple:
    """Index-based recurrence over (stage, microbatch) start times.

    Processes ops in increasing issue-order position; at each position all
    forwards run in ascending stage order, then all backwards in descending
    stage order — a topological order of the 1F1B DAG whenever the warm-up
    counts are non-increasing (see :func:`fast_path_eligible`).  Every float
    expression mirrors the graph simulator's, so results are bit-identical.

    Returns (f_start, f_end, b_start, b_end, cf_start, cf_end, cb_start,
    cb_end, exposed) — per-(stage, microbatch) grids as nested lists plus the
    per-(stage, order-position) exposed-comm contributions.
    """
    S = len(t_f)
    orders = [_stage_order(i, S, B, warmup_counts[i]) for i in range(S)]
    # per issue position: which (stage, microbatch) forwards/backwards run
    f_at: List[List[Tuple[int, int]]] = [[] for _ in range(2 * B)]
    b_at: List[List[Tuple[int, int]]] = [[] for _ in range(2 * B)]
    for i in range(S):
        for p, (kind, j) in enumerate(orders[i]):
            (f_at if kind == "F" else b_at)[p].append((i, j))
    f_start = [[0.0] * B for _ in range(S)]
    f_end = [[0.0] * B for _ in range(S)]
    b_start = [[0.0] * B for _ in range(S)]
    b_end = [[0.0] * B for _ in range(S)]
    cf_start = [[0.0] * B for _ in range(S - 1)]
    cf_end = [[0.0] * B for _ in range(S - 1)]
    cb_start = [[0.0] * B for _ in range(S - 1)]
    cb_end = [[0.0] * B for _ in range(S - 1)]
    exposed = [[0.0] * (2 * B) for _ in range(S)]
    prev_end: List[Optional[float]] = [None] * S

    for p in range(2 * B):
        # forwards at this position, upstream first (CF arrivals are ready)
        for i, j in f_at[p]:
            pe = prev_end[i]
            if i > 0:
                arrive = cf_end[i - 1][j]
                s0 = arrive if pe is None else max(pe, arrive)
                ex = arrive - (0.0 if pe is None else pe)
                if ex > 1e-12:
                    exposed[i][p] = ex
            else:
                s0 = 0.0 if pe is None else pe
            e = s0 + t_f[i]
            f_start[i][j] = s0
            f_end[i][j] = e
            prev_end[i] = e
            if i < S - 1:
                cs = e if j == 0 else max(e, cf_end[i][j - 1])
                cf_start[i][j] = cs
                cf_end[i][j] = cs + c_links[i]
        # backwards at this position, downstream first (CB arrivals are ready)
        for i, j in reversed(b_at[p]):
            pe = prev_end[i]
            if i < S - 1:
                arrive = cb_end[i][j]
                s0 = arrive if pe is None else max(pe, arrive)
                ex = arrive - (0.0 if pe is None else pe)
                if ex > 1e-12:
                    exposed[i][p] = ex
            else:
                # last stage: data dep is its own forward (not a comm node)
                arrive = f_end[i][j]
                s0 = arrive if pe is None else max(pe, arrive)
            e = s0 + t_b[i]
            b_start[i][j] = s0
            b_end[i][j] = e
            prev_end[i] = e
            if i > 0:
                cs = e if j == 0 else max(e, cb_end[i - 1][j - 1])
                cb_start[i - 1][j] = cs
                cb_end[i - 1][j] = cs + cb[i - 1]
    return (f_start, f_end, b_start, b_end, cf_start, cf_end,
            cb_start, cb_end, exposed, orders)


def _fast_result(t_f, t_b, c_links, B, warmup_counts, cb, in_f, in_b
                 ) -> SimResult:
    """Assemble a SimResult from the fast-path grids, accumulating every
    reduction in the same element order as the graph simulator (so sums and
    maxima are bit-identical, not merely close)."""
    S = len(t_f)
    (f_start, f_end, b_start, b_end, cf_start, cf_end, cb_start, cb_end,
     exposed, orders) = _simulate_fast(t_f, t_b, c_links, B, warmup_counts, cb)

    start: Dict[Node, float] = {}
    dur: Dict[Node, float] = {}
    stage_compute = [0.0] * S
    for i in range(S):
        row_f, row_b = f_start[i], b_start[i]
        start.update({("F", j, i): row_f[j] for j in range(B)})
        start.update({("B", j, i): row_b[j] for j in range(B)})
        tfi, tbi = t_f[i], t_b[i]
        dur.update({("F", j, i): tfi for j in range(B)})
        dur.update({("B", j, i): tbi for j in range(B)})
        # stage busy time accumulated in issue order ([F]*n_w, [B,F]*(B-n_w),
        # [B]*n_w) so the float sum matches the graph engine's bit for bit
        n_w = min(warmup_counts[i], B)
        acc = 0.0
        for _ in range(n_w):
            acc += tfi
        for _ in range(B - n_w):
            acc += tbi
            acc += tfi
        for _ in range(n_w):
            acc += tbi
        stage_compute[i] = acc
    comm_total = 0.0
    for i in range(S - 1):
        row_cf, row_cb = cf_start[i], cb_start[i]
        start.update({("CF", j, i): row_cf[j] for j in range(B)})
        start.update({("CB", j, i): row_cb[j] for j in range(B)})
        ci, cbi = c_links[i], cb[i]
        dur.update({("CF", j, i): ci for j in range(B)})
        dur.update({("CB", j, i): cbi for j in range(B)})
        for _ in range(B):
            comm_total += ci
            comm_total += cbi
    makespan = max(max(row) for row in (f_end + b_end + cf_end + cb_end))

    comm_exposed = 0.0
    for row in exposed:
        for x in row:
            if x > 1e-12:
                comm_exposed += x
    comm_exposed = min(comm_exposed, comm_total)

    stage_comm_blocking = [0.0] * S
    stage_idle = [makespan - stage_compute[i] - stage_comm_blocking[i]
                  for i in range(S)]
    stage_intra = [B * (in_f[i] + in_b[i]) for i in range(S)]
    return SimResult(makespan, start, dur, stage_compute, stage_comm_blocking,
                     stage_idle, comm_total, comm_exposed,
                     list(warmup_counts), stage_intra)


# ---------------------------------------------------------------------------
# Contended engine (fair-share link occupancy via repro_torch.comm.netsim)
# ---------------------------------------------------------------------------


def _simulate_contended(t_f, t_b, c_links, B, warmup_counts, cb, in_f, in_b,
                        link_ids: Sequence[str],
                        sync_work) -> SimResult:
    """The 1F1B DAG solved under *contention*: comm ops are occupancy
    intervals on named physical links (``link_ids[i]`` per stage boundary;
    equal ids share capacity), solved by the event-driven fair-share netsim.
    Boundaries that never share a link reproduce the graph engine's timing;
    cluster-crossing boundaries all ride the same ``"wan"`` id and slow each
    other down — as do optional per-stage gradient syncs (``sync_work``
    entries ``(stage, link_id, seconds)``, released after the stage's last
    backward, occupying both link directions like a real allreduce)."""
    from repro_torch.comm.netsim import SimNode, run as netsim_run

    S = len(t_f)
    nodes: List = []
    deps_of: Dict[Node, List[Node]] = {}

    def add(node: Node, work: float, deps, links=()):
        deps = tuple(d for d in deps if d is not None)
        nodes.append(SimNode(node, work, deps, tuple(links)))
        deps_of[node] = list(deps)

    for i in range(S):
        order = _stage_order(i, S, B, warmup_counts[i])
        prev: Optional[Node] = None
        for kind, j in order:
            node = (kind, j, i)
            data_dep: Optional[Node] = None
            if kind == "F" and i > 0:
                data_dep = ("CF", j, i - 1)
            elif kind == "B":
                data_dep = ("CB", j, i) if i < S - 1 else ("F", j, i)
            add(node, t_f[i] if kind == "F" else t_b[i], (prev, data_dep))
            prev = node
    for i in range(S - 1):
        for j in range(B):
            add(("CF", j, i), c_links[i],
                (("F", j, i), ("CF", j - 1, i) if j > 0 else None),
                links=(f"{link_ids[i]}/fwd",))
            add(("CB", j, i), cb[i],
                (("B", j, i + 1), ("CB", j - 1, i) if j > 0 else None),
                links=(f"{link_ids[i]}/bwd",))
    for stage, link, secs in (sync_work or ()):
        add(("SYNC", 0, stage), float(secs), (("B", B - 1, stage),),
            links=(f"{link}/fwd", f"{link}/bwd"))

    res = netsim_run(nodes)

    start = dict(res.start)
    dur = {nid: res.end[nid] - res.start[nid] for nid in res.end}
    makespan = res.makespan
    stage_compute = [0.0] * S
    for (kind, j, i), d in dur.items():
        if kind in ("F", "B"):
            stage_compute[i] += d
    comm_total = sum(d for (k, _, _), d in dur.items()
                     if k in ("CF", "CB", "SYNC"))
    comm_exposed = 0.0
    for v, ps in deps_of.items():
        if v[0] not in ("F", "B") or not ps:
            continue
        comm_ends = [res.end[p] for p in ps if p[0] in ("CF", "CB")]
        other_ends = [res.end[p] for p in ps if p[0] in ("F", "B")]
        if comm_ends:
            exposed = max(comm_ends) - max(other_ends, default=0.0)
            if exposed > 1e-12:
                comm_exposed += exposed
    comm_exposed = min(comm_exposed, comm_total)
    stage_comm_blocking = [0.0] * S
    stage_idle = [makespan - stage_compute[i] - stage_comm_blocking[i]
                  for i in range(S)]
    stage_intra = [B * (in_f[i] + in_b[i]) for i in range(S)]
    return SimResult(makespan, start, dur, stage_compute, stage_comm_blocking,
                     stage_idle, comm_total, comm_exposed,
                     list(warmup_counts), stage_intra,
                     link_busy=dict(res.link_busy))


# ---------------------------------------------------------------------------
# Reference graph simulator
# ---------------------------------------------------------------------------


def _simulate_graph(t_f, t_b, c_links, B, warmup_counts, cb, in_f, in_b, *,
                    no_overlap: bool) -> SimResult:
    S = len(t_f)
    dur: Dict[Node, float] = {}
    deps: Dict[Node, List[Node]] = {}

    def add(node: Node, d: float, *pre: Node):
        dur[node] = d
        deps[node] = [p for p in pre if p is not None]

    # compute nodes + stage order edges (comm inserted into stage order when
    # no_overlap: the send occupies the stage)
    for i in range(S):
        order = _stage_order(i, S, B, warmup_counts[i])
        prev: Optional[Node] = None
        for kind, j in order:
            node = (kind, j, i)
            add(node, t_f[i] if kind == "F" else t_b[i], prev)
            prev = node
            if no_overlap:
                if kind == "F" and i < S - 1 and c_links[i] > 0:
                    cf = ("CF", j, i)
                    add(cf, c_links[i], prev)
                    prev = cf
                if kind == "B" and i > 0 and cb[i - 1] > 0:
                    cbn = ("CB", j, i - 1)
                    add(cbn, cb[i - 1], prev)
                    prev = cbn

    # communication nodes (overlapped mode) + link in-order chains
    if not no_overlap:
        for i in range(S - 1):
            prev_cf: Optional[Node] = None
            prev_cb: Optional[Node] = None
            for j in range(B):
                cf = ("CF", j, i)
                add(cf, c_links[i], ("F", j, i), prev_cf)
                prev_cf = cf
                cbn = ("CB", j, i)
                add(cbn, cb[i], ("B", j, i + 1), prev_cb)
                prev_cb = cbn
    else:
        # deps from producer already in stage chains; nothing extra
        pass

    # data dependencies into compute nodes (no_overlap elides zero-cost comm
    # nodes, so fall back to the producing compute op directly)
    for i in range(S):
        for j in range(B):
            if i > 0:
                cf = ("CF", j, i - 1)
                deps[("F", j, i)].append(cf if cf in dur else ("F", j, i - 1))
            if i < S - 1:
                cbn = ("CB", j, i)
                deps[("B", j, i)].append(
                    cbn if cbn in dur else ("B", j, i + 1))
            else:
                deps[("B", j, i)].append(("F", j, i))

    # longest-path start times (Kahn topological order)
    indeg = {v: 0 for v in dur}
    succ: Dict[Node, List[Node]] = {v: [] for v in dur}
    for v, ps in deps.items():
        for p in ps:
            succ[p].append(v)
            indeg[v] += 1
    start: Dict[Node, float] = {}
    ready = [v for v, d in indeg.items() if d == 0]
    order_count = 0
    while ready:
        v = ready.pop()
        order_count += 1
        start[v] = max((start[p] + dur[p] for p in deps[v]), default=0.0)
        for s_ in succ[v]:
            indeg[s_] -= 1
            if indeg[s_] == 0:
                ready.append(s_)
    assert order_count == len(dur), "cycle in pipeline DAG"

    makespan = max(start[v] + dur[v] for v in dur)

    # --- breakdown ---------------------------------------------------------
    stage_compute = [0.0] * S
    stage_comm_blocking = [0.0] * S
    for (kind, j, i), d in dur.items():
        if kind in ("F", "B"):
            stage_compute[i] += d
        elif no_overlap:
            # charged to the sending stage (CF from i, CB from i+1)
            stage_comm_blocking[i if kind == "CF" else i + 1] += d
    stage_idle = [makespan - stage_compute[i] - stage_comm_blocking[i]
                  for i in range(S)]

    comm_total = sum(d for (k, _, _), d in dur.items() if k in ("CF", "CB"))
    # exposed comm: compute ops delayed specifically by their comm dependency
    comm_exposed = 0.0
    for v, ps in deps.items():
        if v[0] not in ("F", "B") or not ps:
            continue
        comm_ends = [start[p] + dur[p] for p in ps if p[0] in ("CF", "CB")]
        other_ends = [start[p] + dur[p] for p in ps if p[0] in ("F", "B")]
        if comm_ends:
            exposed = max(comm_ends) - max(other_ends, default=0.0)
            if exposed > 1e-12:
                comm_exposed += min(exposed, max(comm_ends) - (max(other_ends, default=0.0)))
    comm_exposed = min(comm_exposed, comm_total)

    # per-stage exposed intra-op collective time: every F and B op of stage i
    # carries its stretched share once per microbatch
    stage_intra = [B * (in_f[i] + in_b[i]) for i in range(S)]

    return SimResult(makespan, start, dur, stage_compute, stage_comm_blocking,
                     stage_idle, comm_total, comm_exposed,
                     list(warmup_counts), stage_intra)


# ---------------------------------------------------------------------------
# Memoized front door
# ---------------------------------------------------------------------------


@dataclass
class SimMemoStats:
    """Counters for the simulate() memo + engine dispatch."""
    hits: int = 0
    misses: int = 0
    fast_path: int = 0       # misses solved by the closed-form recurrence
    graph_path: int = 0      # misses solved by the reference graph engine
    contended_path: int = 0  # misses solved by the fair-share netsim engine

    def snapshot(self) -> "SimMemoStats":
        return SimMemoStats(self.hits, self.misses,
                            self.fast_path, self.graph_path,
                            self.contended_path)


SIM_MEMO_MAXSIZE = 64
_SIM_MEMO: "OrderedDict[tuple, SimResult]" = OrderedDict()
_SIM_STATS = SimMemoStats()


def sim_memo_stats() -> SimMemoStats:
    """Live counters of the simulate() memo (shared across all callers)."""
    return _SIM_STATS


def clear_sim_memo() -> None:
    _SIM_MEMO.clear()


def simulate(t_f: Sequence[float], t_b: Sequence[float],
             c_links: Sequence[float], n_microbatches: int,
             warmup_counts: Sequence[int], *,
             no_overlap: bool = False,
             c_links_bwd: Optional[Sequence[float]] = None,
             intra_f: Optional[Sequence[float]] = None,
             intra_b: Optional[Sequence[float]] = None,
             intra_overlap: float = 0.0,
             fast: Optional[bool] = None,
             cache: bool = True,
             contention: bool = False,
             link_ids: Optional[Sequence[str]] = None,
             sync_work: Optional[Sequence[Tuple[int, str, float]]] = None
             ) -> SimResult:
    """Simulate one training step (B microbatches through S stages).

    ``intra_f``/``intra_b`` (optional, per stage, seconds): intra-operator
    collective time (TP all-reduce, amortized DP sync) *not* already folded
    into ``t_f``/``t_b``.  A fraction ``intra_overlap`` in [0, 1] hides under
    compute; the exposed remainder stretches every F/B op of that stage and
    is reported per stage in ``SimResult.stage_intra_comm``.

    ``fast``: None (default) auto-selects the closed-form recurrence when
    :func:`fast_path_eligible`; True forces it (ValueError when ineligible);
    False forces the reference graph engine.  Both engines are bit-identical
    on every eligible schedule.

    ``cache``: serve repeated signatures from a bounded memo (the returned
    SimResult is shared — treat it as immutable).  Pass False to bypass
    (e.g. when benchmarking the engines themselves).

    ``contention=True`` replaces the isolated per-link scalars with the
    fair-share occupancy model (``repro_torch.comm.netsim``): ``link_ids`` names
    each boundary's *physical* link (equal ids contend — e.g. every
    cluster-crossing boundary on the shared ``"wan"``; default: all
    distinct, which reproduces uncontended timing) and ``sync_work``
    injects per-stage gradient syncs ``(stage, link_id, seconds)`` that
    contend with in-flight activation traffic.  ``contention=False``
    (default) leaves the legacy engines untouched — bit-identical results.
    """
    S, B = len(t_f), int(n_microbatches)
    assert len(c_links) == S - 1 and len(warmup_counts) == S
    if contention and no_overlap:
        raise ValueError("contention=True models overlapped sends; "
                         "no_overlap has no contended interpretation")
    if contention and fast is True:
        raise ValueError("contention=True has no closed-form fast path")
    if link_ids is not None and len(link_ids) != S - 1:
        raise ValueError(f"link_ids needs {S - 1} entries, got {len(link_ids)}")
    key = None
    if cache:
        key = (tuple(float(x) for x in t_f), tuple(float(x) for x in t_b),
               tuple(float(x) for x in c_links), B,
               tuple(int(c) for c in warmup_counts), bool(no_overlap),
               None if c_links_bwd is None else
               tuple(float(x) for x in c_links_bwd),
               None if intra_f is None else tuple(float(x) for x in intra_f),
               None if intra_b is None else tuple(float(x) for x in intra_b),
               float(intra_overlap), fast, bool(contention),
               None if link_ids is None else tuple(link_ids),
               None if sync_work is None else
               tuple((int(s), str(l), float(w)) for s, l, w in sync_work))
        hit = _SIM_MEMO.get(key)
        if hit is not None:
            _SIM_STATS.hits += 1
            _SIM_MEMO.move_to_end(key)
            return hit
        _SIM_STATS.misses += 1

    cb = list(c_links_bwd) if c_links_bwd is not None else list(c_links)
    assert 0.0 <= intra_overlap <= 1.0
    exposed_frac = 1.0 - intra_overlap
    in_f = [exposed_frac * x for x in intra_f] if intra_f is not None \
        else [0.0] * S
    in_b = [exposed_frac * x for x in intra_b] if intra_b is not None \
        else [0.0] * S
    tf = [t + x for t, x in zip(t_f, in_f)]
    tb = [t + x for t, x in zip(t_b, in_b)]

    if contention:
        _SIM_STATS.contended_path += 1
        ids = list(link_ids) if link_ids is not None \
            else [f"link{i}" for i in range(S - 1)]
        res = _simulate_contended(tf, tb, list(c_links), B, warmup_counts,
                                  cb, in_f, in_b, ids, sync_work)
        if cache:
            _SIM_MEMO[key] = res
            if len(_SIM_MEMO) > SIM_MEMO_MAXSIZE:
                _SIM_MEMO.popitem(last=False)
        return res

    eligible = fast_path_eligible(warmup_counts, no_overlap)
    if fast is True and not eligible:
        raise ValueError(
            "fast=True but the schedule is not closed-form eligible "
            f"(no_overlap={no_overlap}, counts={list(warmup_counts)})")
    use_fast = eligible if fast is None else fast
    if use_fast:
        _SIM_STATS.fast_path += 1
        res = _fast_result(tf, tb, list(c_links), B, warmup_counts,
                           cb, in_f, in_b)
    else:
        _SIM_STATS.graph_path += 1
        res = _simulate_graph(tf, tb, list(c_links), B, warmup_counts,
                              cb, in_f, in_b, no_overlap=no_overlap)
    if cache:
        _SIM_MEMO[key] = res
        if len(_SIM_MEMO) > SIM_MEMO_MAXSIZE:
            _SIM_MEMO.popitem(last=False)
    return res


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def eta_load_balance(stage_compute: Sequence[float],
                     stage_peak_flops: Sequence[float]) -> float:
    """Eq. 19 with devices grouped per stage: eta = 1 - sum((td_max - td_i)
    * peak_i) / (td_max * sum(peak_i))."""
    td_max = max(stage_compute)
    if td_max <= 0:
        return 1.0
    num = sum((td_max - td) * p for td, p in zip(stage_compute, stage_peak_flops))
    den = td_max * sum(stage_peak_flops)
    return 1.0 - num / den


def ascii_timeline(res: SimResult, width: int = 100) -> str:
    """Paper Fig. 3-style timeline (one row per stage: F#, B#, '.')."""
    S = len(res.stage_compute)
    scale = width / res.makespan
    rows = []
    for i in range(S):
        row = [" "] * (width + 1)
        for (kind, j, st), d in res.dur.items():
            if st != i or kind not in ("F", "B"):
                continue
            s = int(res.start[(kind, j, st)] * scale)
            e = max(s + 1, int((res.start[(kind, j, st)] + d) * scale))
            ch = "f" if kind == "F" else "B"
            for x in range(s, min(e, width)):
                row[x] = ch
        rows.append(f"stage{i}|" + "".join(row))
    return "\n".join(rows)
