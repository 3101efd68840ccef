"""Heterogeneous inter-op parallel strategy search (paper §5.2, Alg. 1).

DP over ``F[k, a_0..a_{C-1}, nc]`` = min pipeline fill cost of partitioning
layers ``k..L`` into stages, with ``a_c`` device *units* of each sub-cluster
remaining and the suffix's first stage placed on cluster ``nc`` (index C =
"end of pipeline").  Objective (Eq. 13):

    T*(t_max) = min F + (B - 1) * t_max,   F = sum_i (t_i + 2 c_i)

subject to t_i <= t_max, c_i <= t_max, and the H-1F1B memory bound (Eq. 18)
with K from Eq. 17.  The warm-up-count table ``N`` is carried through the DP
exactly as the paper's ``N(s, k, d_A, d_B; t_max)``.

Deviation (superset of the paper, flag ``monotone_clusters`` restores the
exact formulation): the paper's Eqs. 14/15 allocate cluster A fully before
cluster B along the pipeline; tracking the next stage's cluster in the state
removes that restriction at 2x state cost and can only find better strategies.

**Joint inter+intra search** (profiler ``intra_op=True``): each table row is
a (submesh, tensor-parallel width) *variant*, so the same DP jointly chooses
the stage slicing, the placement, and the intra-op sharding degree — a
variant's intra-op collective time raises its ``t`` while its leaner
activation footprint relaxes the Eq. 18 bound, and the uneven
efficiency-proportional shard ratios of a mixed sub-cluster lower its
compute time.  The chosen :class:`~repro_torch.core.strategy.IntraOpPlan` rides on
each ``StageAssignment``.

**Two engines** (``SearchConfig.engine``), bit-identical on every shared
input:

- ``"vectorized"`` (the ``"auto"`` default): per ``(k, mesh)`` the whole
  ``(j, nc)`` transition fan-in is evaluated as one stacked masked reduction
  over precomputed per-(mesh, k) candidate rows, and the surviving ``t_max``
  batch is evaluated as a single extra array axis
  (:func:`_dp_eval_batch`) — interpreter cost per candidate vanishes.
  Supports any number of sub-clusters (the device-unit axes generalize).
- ``"oracle"``: the original scalar nested-loop DP, kept as the reference
  the vectorized engine is tested bit-exact against (2 sub-clusters max).

The paper's three search optimizations are implemented:
  - *sparsity index*: per (mesh, k), the feasible j-window under t_max is
    located over the monotone stage-cost row (precomputed cumulative
    structure from the Zero-Redundant Profiler);
  - *bidirectional pruning*: binary-search the smallest feasible t_S; bound
    t_E = T(t_S)/B and drop all candidates outside [t_S, t_E];
  - *batched parallel evaluation*: surviving candidates are evaluated as
    stacked array batches; ``n_workers`` distributes whole batches across
    fork-inherited worker processes (Ray-actor analogue) and falls back to
    serial evaluation cleanly where fork is unavailable.

:func:`instrumented_search` is the public benchmarking/observability hook:
identical result to :func:`search`, plus a :class:`SearchStats` record
(candidate counts, pruning window, engine, per-phase wall clock).
"""
from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.h1f1b import h1f1b_counts
from repro_torch.core.pipesim import eta_load_balance, simulate
from repro_torch.core.profiler import ProfileTables
from repro_torch.core.strategy import ParallelStrategy, StageAssignment

INF = np.inf


class SearchTimeout(RuntimeError):
    """The search exceeded ``SearchConfig.deadline_s`` of wall clock.  A
    RuntimeError subclass so every caller that treats planner failure as
    "no feasible strategy" (e.g. the elastic controller's degraded ladder)
    handles timeouts through the same path."""


@dataclass
class SearchConfig:
    n_microbatches: int = 128
    monotone_clusters: bool = False   # True = paper's exact Eq. 14/15 ordering
    require_all_devices: bool = False
    n_workers: int = 0                # 0 -> serial
    tmax_round_digits: int = 4        # dedupe candidates to this many sig digits
    max_candidates: int = 512
    intra_overlap: float = 0.0        # fraction of intra-op collective time
                                      # hidden under compute in the final
                                      # pipesim validation (0 = fully exposed)
    engine: str = "auto"              # auto | vectorized | oracle (plans are
                                      # bit-identical across engines)
    batch_size: int = 8               # t_max candidates per stacked evaluation
                                      # (vectorized engine; clamped by memory.
                                      # Chunks ascend, so small batches keep
                                      # the low-t_max sparsity window tight)
    deadline_s: float = 0.0           # wall-clock budget for one search;
                                      # exceeded -> SearchTimeout (0 = none).
                                      # Checked between DP solves, so overrun
                                      # is bounded by one candidate evaluation


@dataclass
class SearchStats:
    """Observability record returned by :func:`instrumented_search`.

    Times are seconds of wall clock; counts are t_max candidate evaluations
    (each one full DP solve).  ``engine`` is what actually ran;
    ``oracle_fallbacks`` > 0 means the vectorized engine raised and the
    scalar reference re-ran the search (bit-identical result, none of the
    speedup — CI treats it as a regression on the canonical clusters)."""
    engine: str = "vectorized"
    requested_engine: str = "auto"
    n_subclusters: int = 0
    n_mesh_rows: int = 0
    n_layers: int = 0
    n_tmax_candidates: int = 0        # distinct rounded stage times
    n_pruned: int = 0                 # dropped by the bidirectional window
    n_evaluated: int = 0              # fresh DP solves in the surviving batch
    n_cache_served: int = 0           # surviving candidates whose fill was
                                      # reused from the pruning probes
    prune_evals: int = 0              # DP solves spent on the binary search
    t_S: float = 0.0
    t_E: float = 0.0
    best_t_max: float = 0.0
    fill_cost: float = 0.0
    predicted_T: float = 0.0
    workers_used: int = 0
    oracle_fallbacks: int = 0
    eval_seconds: float = 0.0         # surviving-batch evaluation wall clock
    total_seconds: float = 0.0

    def asdict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class _EdgeGroup:
    """Per (start layer, source cluster) stacked transition fan-in: the
    ``(j, nc)`` candidate axis the vectorized engine reduces over, plus the
    per-mesh rows aligned to it.  ``meshes`` entries are
    ``(mid, units, t_stage, t_stage + 2c, K_threshold)``."""
    jj: np.ndarray          # (n,) next start layer per candidate
    nn: np.ndarray          # (n,) next cluster per candidate (C = pipe end)
    ct: np.ndarray          # (n,) inter-stage comm seconds
    tmin: np.ndarray        # (n,) fastest mesh's stage time (window pruning)
    meshes: List[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray, int]]


_KT_HUGE = np.int64(1) << 40   # "memory never binds": far above any real K


def _k_threshold(mp: np.ndarray, ma: np.ndarray, cap: float) -> np.ndarray:
    """Largest integer K with ``mp + K * ma <= cap`` — evaluated with the
    oracle's exact float expression, which is monotone in K (ma >= 0), so
    the Eq. 18 memory mask collapses to one integer compare per candidate.
    -1 where nothing fits (e.g. infeasible rows carrying inf), ``_KT_HUGE``
    where the bound never binds for any realizable warm-up count."""
    finite = np.isfinite(mp) & np.isfinite(ma)
    pos = finite & (ma > 0.0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        guess = np.floor((cap - mp) / np.where(pos, ma, 1.0))
        g = np.where(pos, np.clip(guess, -1.0, float(_KT_HUGE)), -1.0) \
            .astype(np.int64)
        # correct the float-division guess against the exact expression
        for _ in range(64):
            bad = pos & (g >= 0) & (mp + g * ma > cap)
            if not bad.any():
                break
            g = np.where(bad, g - 1, g)
        for _ in range(64):
            up = pos & (g < _KT_HUGE) & (mp + (g + 1) * ma <= cap)
            if not up.any():
                break
            g = np.where(up, g + 1, g)
        # ma == 0: feasibility is K-independent
        g = np.where(finite & (ma <= 0.0) & (mp <= cap), _KT_HUGE, g)
    return g


class _DPContext:
    """Immutable tables shared by all t_max evaluations (fork-inherited).

    Besides the original scalar-oracle fields, precomputes the vectorized
    engine's per-(mesh, k) candidate rows: the stacked ``(j, nc)`` transition
    fan-in as flat numpy arrays (stage time, doubled comm time, memory
    operands), built once and reused by every ``t_max`` evaluation.
    """

    def __init__(self, cluster: HeteroCluster, tables: ProfileTables,
                 cfg: SearchConfig, comm=None):
        self.cluster = cluster
        self.tables = tables
        self.cfg = cfg
        self.comm = comm
        self.C = len(cluster.subclusters)
        self.L = tables.t_f.shape[1] - 1
        # device units per cluster = smallest submesh size present
        self.unit = []
        for ci in range(self.C):
            sizes = [m.n_devices for m in tables.meshes if m.cluster_idx == ci]
            self.unit.append(min(sizes) if sizes else 1)
        self.units_total = [
            (cluster.subclusters[ci].n_devices // self.unit[ci])
            for ci in range(self.C)]
        self.mesh_units = [m.n_devices // self.unit[m.cluster_idx]
                           for m in tables.meshes]
        self.caps = [s.device.mem_bytes for s in cluster.subclusters]
        self.t_tab = tables.t          # cached f+b table (ProfileTables.t)
        # --- vectorized-engine precomputation ------------------------------
        self.unit_shape = tuple(u + 1 for u in self.units_total)
        self.full_idx = tuple(self.units_total)
        self.mesh_ids_of_cluster: List[List[int]] = [[] for _ in range(self.C)]
        for mid, mesh in enumerate(tables.meshes):
            self.mesh_ids_of_cluster[mesh.cluster_idx].append(mid)
        # ctime[j, c, nc]: cut-at-j transfer seconds from cluster c to nc
        bw = np.array([[cluster.link_bw(c, nc) for nc in range(self.C)]
                       for c in range(self.C)], dtype=np.float64)
        self.ctime = tables.cut_bytes[:, None, None] / bw[None, :, :]
        if comm is not None:
            # comm-aware cut pricing: the WAN link's per-transfer latency is
            # real cost the scalar model drops; both engines read ctime, so
            # they stay bit-identical to each other either way
            lat = np.array(
                [[comm.p2p_latency(c, nc) for nc in range(self.C)]
                 for c in range(self.C)], dtype=np.float64)
            self.ctime = self.ctime + lat[None, :, :]
        self._groups: Dict[Tuple[int, int], Optional[_EdgeGroup]] = {}

    def bw(self, src: int, dst: int) -> float:
        return self.cluster.link_bw(src, dst)

    def p2p(self, j: int, src: int, dst: int) -> float:
        """Cut-at-``j`` transfer seconds from cluster ``src`` to ``dst`` —
        the one expression every scalar path shares with the vectorized
        engine's precomputed ``ctime`` (bit-identical by construction)."""
        return float(self.ctime[j, src, dst])

    def group(self, k: int, c: int) -> Optional["_EdgeGroup"]:
        """Stacked ``(j, nc)`` transition fan-in for (start layer k, source
        cluster c): the union of every cluster-c mesh row's feasible stages,
        as flat arrays in the scalar engine's iteration order (j ascending,
        nc ascending), with per-mesh cost/memory rows aligned to the union
        (infinite where that mesh is infeasible — the masks exclude them
        exactly like the oracle's ``continue``).  t_max-independent; built
        once, shared by every evaluation."""
        key = (k, c)
        hit = self._groups.get(key, False)
        if hit is not False:
            return hit
        tab = self.tables
        mids = [mid for mid in self.mesh_ids_of_cluster[c]
                if tab.feasible[mid, k].any()]
        if not mids:
            self._groups[key] = None
            return None
        any_ok = np.zeros(self.L + 1, dtype=bool)
        for mid in mids:
            any_ok |= tab.feasible[mid, k]
        C, L = self.C, self.L
        mono = self.cfg.monotone_clusters
        jj: List[int] = []
        nn: List[int] = []
        ct: List[float] = []
        for j in np.nonzero(any_ok)[0]:
            if j == L:
                jj.append(j)
                nn.append(C)
                ct.append(0.0)
                continue
            for nc in range(C):
                if mono and nc < c:
                    continue
                jj.append(int(j))
                nn.append(nc)
                ct.append(float(self.ctime[j, c, nc]))
        jj_a = np.asarray(jj, dtype=np.intp)
        nn_a = np.asarray(nn, dtype=np.intp)
        ct_a = np.asarray(ct, dtype=np.float64)
        twoc = 2.0 * ct_a
        cap = self.caps[c]
        meshes = []
        tmin = np.full(len(jj_a), INF)
        for mid in mids:
            t_m = self.t_tab[mid, k, jj_a]
            s_m = t_m + twoc         # the oracle's (t_stage + 2.0 * c_time)
            kt_m = _k_threshold(tab.mem_p[mid, k, jj_a],
                                tab.mem_a[mid, k, jj_a], cap)
            finite = np.isfinite(t_m)
            kt_min = int(kt_m[finite].min()) if finite.any() else -1
            meshes.append((mid, self.mesh_units[mid], t_m, s_m, kt_m, kt_min))
            tmin = np.minimum(tmin, t_m)
        out = _EdgeGroup(jj_a, nn_a, ct_a, tmin, meshes)
        self._groups[key] = out
        return out

    def batch_chunk(self, requested: int) -> int:
        """Clamp the t_max batch so stacked temporaries stay ~<256 MB."""
        cells = int(np.prod(self.unit_shape))
        per_t = (self.L + 2) * cells * (self.C + 1) * 16 \
            + (self.L + 1) * max(1, self.C) * cells * 8 * 8
        return max(1, min(requested, int(2.56e8 // max(per_t, 1))))


def _shift(plane: np.ndarray, u: int, axis: int, fill=INF) -> np.ndarray:
    """out[a] = plane[a - u] along axis (device-consumption shift)."""
    out = np.full_like(plane, fill)
    src = [slice(None)] * plane.ndim
    dst = [slice(None)] * plane.ndim
    dst[axis] = slice(u, None)
    src[axis] = slice(0, plane.shape[axis] - u)
    out[tuple(dst)] = plane[tuple(src)]
    return out


# ---------------------------------------------------------------------------
# Scalar reference engine (the pre-vectorization code, kept as the oracle)
# ---------------------------------------------------------------------------


def _dp_eval(ctx: _DPContext, t_max: float,
             want_tables: bool = False):
    """Scalar-oracle DP under a fixed t_max (2 sub-clusters max).  Returns
    (fill_cost, F, N) where fill_cost = min over nc of F[0, UA, UB, nc]
    (inf if infeasible)."""
    C, L = ctx.C, ctx.L
    assert C <= 2, "oracle engine supports at most 2 sub-clusters"
    UA = ctx.units_total[0]
    UB = ctx.units_total[1] if C > 1 else 0
    tab = ctx.tables

    F = np.full((L + 1, UA + 1, UB + 1, C + 1), INF)
    N = np.zeros((L + 1, UA + 1, UB + 1, C + 1), dtype=np.int64)
    F[L, :, :, C] = 0.0

    for k in range(L - 1, -1, -1):
        for c in range(C):
            axis = 0 if c == 0 else 1
            best = np.full((UA + 1, UB + 1), INF)
            bestK = np.zeros((UA + 1, UB + 1), dtype=np.int64)
            for mid, mesh in enumerate(tab.meshes):
                if mesh.cluster_idx != c:
                    continue
                u = ctx.mesh_units[mid]
                row_t = ctx.t_tab[mid, k]           # (L+1,)
                row_ok = tab.feasible[mid, k]
                # sparsity index: t is monotone in j -> contiguous window
                js = np.nonzero(row_ok & (row_t <= t_max))[0]
                for j in js:
                    t_stage = row_t[j]
                    mp, ma = tab.mem_p[mid, k, j], tab.mem_a[mid, k, j]
                    ncs = (C,) if j == L else tuple(range(C))
                    for nc in ncs:
                        if ctx.cfg.monotone_clusters and j < L and nc < c:
                            continue  # paper: clusters in fixed pipeline order
                        if j == L:
                            c_time = 0.0
                        else:
                            c_time = ctx.p2p(j, c, nc)
                        if c_time > t_max:
                            continue
                        Fn = F[j, :, :, nc]
                        Nn = N[j, :, :, nc]
                        K = math.ceil(2.0 * c_time / t_max) + 1 + Nn
                        val = Fn + (t_stage + 2.0 * c_time)
                        val = np.where(mp + K * ma <= ctx.caps[c], val, INF)
                        val = _shift(val, u, axis)
                        Ksh = _shift(K.astype(np.float64), u, axis, fill=0)
                        upd = val < best
                        best = np.where(upd, val, best)
                        bestK = np.where(upd, Ksh.astype(np.int64), bestK)
            F[k, :, :, c] = best
            N[k, :, :, c] = bestK

    if not ctx.cfg.require_all_devices:
        # idle devices allowed: availability is monotone, take running min
        F_full = np.minimum.accumulate(np.minimum.accumulate(F, axis=1), axis=2)
        fill = float(np.min(F_full[0, UA, UB, :C]))
    else:
        fill = float(np.min(F[0, UA, UB, :C]))
    if want_tables:
        if C == 1:
            # drop the degenerate second unit axis -> the generalized
            # (L+1, *unit_shape, C+1) layout shared with the vectorized engine
            return fill, F[:, :, 0, :], N[:, :, 0, :]
        return fill, F, N
    return fill, None, None


# ---------------------------------------------------------------------------
# Vectorized engine
# ---------------------------------------------------------------------------


def _dp_eval_batch(ctx: _DPContext, ts: np.ndarray,
                   want_tables: bool = False):
    """Run the DP for a whole batch of t_max candidates as one stacked array
    program.  ``ts``: (T,) float64.  Returns fills (T,), or
    (fills, F, N) with F/N shaped ``(T, L+1, *unit_shape, C+1)``.

    Per (k, cluster, mesh row) the whole ``(j, nc)`` fan-in collapses into a
    masked reduction; per-candidate feasibility under each t_max, the Eq. 18
    memory bound, and the warm-up table N are all evaluated elementwise with
    the exact float expressions of the scalar oracle, so results are
    bit-identical (first-minimum tie-breaking matches the scalar engine's
    strict-improvement scan order)."""
    C, L = ctx.C, ctx.L
    dims = ctx.unit_shape
    cells = int(np.prod(dims))
    ts = np.asarray(ts, dtype=np.float64)
    T = len(ts)
    if T == 0:
        return np.zeros(0)
    TC = T * cells
    t_hi = float(ts.max())

    # flat state: row j*(C+1)+nc holds F[j, ·, nc] over the (t_max, *units)
    # grid — row gathers are contiguous memcpys instead of strided fancy
    # indexing, which is where the scalar engine burned its time
    F2 = np.full(((L + 1) * (C + 1), TC), INF)
    N2 = np.zeros(((L + 1) * (C + 1), TC), dtype=np.int32)
    F2[L * (C + 1) + C] = 0.0

    col_t = np.repeat(np.arange(T), cells)      # column -> t index
    col_i = np.arange(TC)
    fbuf = nbuf = vbuf = None                   # grown-on-demand scratch
    nmax = 0         # largest N value written so far (memory-slack test)

    for k in range(L - 1, -1, -1):
        for c in range(C):
            best = np.full(TC, INF)
            bestK = np.zeros(TC, dtype=np.int32)
            grp = ctx.group(k, c)
            if grp is not None:
                # sparsity window: candidates infeasible even at the batch's
                # largest t_max can never contribute — drop them up front
                sel = (grp.tmin <= t_hi) & (grp.ct <= t_hi)
                if sel.all():
                    jj, nn, ct, meshes = grp.jj, grp.nn, grp.ct, grp.meshes
                else:
                    jj, nn, ct = grp.jj[sel], grp.nn[sel], grp.ct[sel]
                    meshes = [(mid, u, t_m[sel], s_m[sel], kt[sel], ktm)
                              for mid, u, t_m, s_m, kt, ktm in grp.meshes]
            else:
                jj = None
            if jj is not None and len(jj):
                n = len(jj)
                if fbuf is None or fbuf.shape[0] < n:
                    fbuf = np.empty((n, TC))
                    vbuf = np.empty((n, TC))
                    nbuf = np.empty((n, TC), dtype=np.int32)
                rows = jj * (C + 1) + nn
                Fn = np.take(F2, rows, axis=0, out=fbuf[:n])
                Nn = None
                val3 = vbuf[:n].reshape(n, T, cells)
                Fn3 = Fn.reshape(n, T, cells)
                ct_ok = ct[:, None] <= ts[None, :]          # (n, T)
                with np.errstate(divide="ignore", invalid="ignore"):
                    Kb = np.where(ct_ok,
                                  np.ceil(2.0 * ct[:, None] / ts[None, :]),
                                  0.0).astype(np.int64)
                kb_max = int(Kb.max()) if n else 0
                for mid, u, t_m, s_m, kt, kt_min in meshes:
                    # t-infeasible candidates are excluded by poisoning the
                    # stage cost itself: INF + anything stays INF, so no big
                    # boolean mask is ever materialized
                    s_okt = np.where(ct_ok & (t_m[:, None] <= ts[None, :]),
                                     s_m[:, None], INF)    # (n, T)
                    np.add(Fn3, s_okt[:, :, None], out=val3)
                    if kt_min - 1 - kb_max < nmax:
                        # Eq. 18 can bind: apply it as an integer compare
                        # K <= kt, i.e. Nn <= kt - 1 - Kb (exactly the
                        # oracle's float mask — see _k_threshold)
                        if Nn is None:
                            Nn = np.take(N2, rows, axis=0, out=nbuf[:n])
                        M = np.minimum(kt[:, None] - 1 - Kb,
                                       np.int64(2**31 - 1)).astype(np.int32)
                        np.copyto(val3, INF,
                                  where=(Nn.reshape(n, T, cells)
                                         > M[:, :, None]))
                    val = vbuf[:n]
                    amin = val.argmin(axis=0)               # first minimum
                    vmin = val[amin, col_i]
                    row_w = rows[amin]
                    Kw = (N2[row_w, col_i].astype(np.int64)
                          + Kb[amin, col_t] + 1)
                    Kw = np.where(np.isinf(vmin), 0, Kw)
                    vsh = _shift(vmin.reshape((T,) + dims), u, 1 + c)
                    Ksh = _shift(Kw.astype(np.float64).reshape((T,) + dims),
                                 u, 1 + c, fill=0.0).astype(np.int32)
                    vsh = vsh.reshape(TC)
                    upd = vsh < best
                    best = np.where(upd, vsh, best)
                    bestK = np.where(upd, Ksh.reshape(TC), bestK)
            F2[k * (C + 1) + c] = best
            N2[k * (C + 1) + c] = bestK
            if jj is not None and len(jj):
                nmax = max(nmax, int(bestK.max()))

    F = F2.reshape((L + 1, C + 1, T) + dims)
    N = N2.reshape((L + 1, C + 1, T) + dims)
    if not ctx.cfg.require_all_devices:
        F_full = F
        for ax in range(3, C + 3):
            F_full = np.minimum.accumulate(F_full, axis=ax)
    else:
        F_full = F
    fills = np.min(
        F_full[(0, slice(0, C), slice(None)) + ctx.full_idx], axis=0)
    if want_tables:
        # rotate to the backtracker's (T, L+1, *unit_shape, C+1) layout
        perm = (2, 0) + tuple(range(3, 3 + C)) + (1,)
        return fills, np.transpose(F, perm), np.transpose(N, perm)
    return fills


def _dp_eval_vec(ctx: _DPContext, t_max: float, want_tables: bool = False):
    """Single-t_max entry point of the vectorized engine (batch of one)."""
    out = _dp_eval_batch(ctx, np.array([t_max]), want_tables=want_tables)
    if want_tables:
        fills, F, N = out
        return float(fills[0]), F[0], N[0]
    return float(out[0]), None, None


# ---------------------------------------------------------------------------
# Backtracking (shared: both engines emit the generalized table layout)
# ---------------------------------------------------------------------------


def _backtrack(ctx: _DPContext, t_max: float, F: np.ndarray, N: np.ndarray
               ) -> List[Tuple[int, int, int, int]]:
    """Extract the argmin stage list [(mid, k, j, K), ...] by re-finding the
    achieving transition at each state along the optimal path.  F/N are the
    generalized ``(L+1, *unit_shape, C+1)`` tables."""
    C, L = ctx.C, ctx.L
    tab = ctx.tables
    units = tuple(ctx.units_total)

    # find start state (allowing idle devices: scan all avail <= units;
    # with require_all_devices, only the full-allocation state qualifies)
    best = (INF, None)
    for c in range(C):
        if ctx.cfg.require_all_devices:
            v = F[(0,) + units + (c,)]
            if v < best[0] - 1e-15:
                best = (v, (0, units, c))
            continue
        for idx in np.ndindex(*ctx.unit_shape):
            v = F[(0,) + idx + (c,)]
            if v < best[0] - 1e-15:
                best = (v, (0, tuple(int(x) for x in idx), c))
    assert best[1] is not None, "infeasible strategy"
    k, avail, c = best[1]
    out = []
    while k < L:
        found = None
        target = F[(k,) + avail + (c,)]
        for mid, mesh in enumerate(tab.meshes):
            if mesh.cluster_idx != c:
                continue
            u = ctx.mesh_units[mid]
            if u > avail[c]:
                continue
            nxt = list(avail)
            nxt[c] -= u
            nxt = tuple(nxt)
            row_t = ctx.t_tab[mid, k]
            row_ok = tab.feasible[mid, k]
            for j in range(k + 1, L + 1):
                if not row_ok[j] or row_t[j] > t_max:
                    continue
                ncs = (C,) if j == L else tuple(range(C))
                for nc in ncs:
                    if ctx.cfg.monotone_clusters and j < L and nc < c:
                        continue
                    c_time = 0.0 if j == L else ctx.p2p(j, c, nc)
                    if c_time > t_max:
                        continue
                    K = math.ceil(2.0 * c_time / t_max) + 1 + N[(j,) + nxt + (nc,)]
                    mp, ma = tab.mem_p[mid, k, j], tab.mem_a[mid, k, j]
                    if mp + K * ma > ctx.caps[c]:
                        continue
                    val = F[(j,) + nxt + (nc,)] + (row_t[j] + 2.0 * c_time)
                    if abs(val - target) <= 1e-9 * max(1.0, abs(target)):
                        found = (mid, k, j, int(K), nxt, nc)
                        break
                if found:
                    break
            if found:
                break
        assert found is not None, "backtrack failed"
        mid, _, j, K, nxt, nc = found
        out.append((mid, k, j, K))
        k, avail, c = j, nxt, nc
    return out


# --- module-level worker state for fork-based parallel evaluation -----------
_WORKER_CTX: Optional[_DPContext] = None
_WORKER_ENGINE: str = "oracle"


def _worker_eval(args):
    t_max_batch = args
    if _WORKER_ENGINE == "vectorized":
        fills = _dp_eval_batch(_WORKER_CTX,
                               np.asarray(t_max_batch, dtype=np.float64))
        return [(float(t), float(f)) for t, f in zip(t_max_batch, fills)]
    return [(t, _dp_eval(_WORKER_CTX, t)[0]) for t in t_max_batch]


def _fork_pool(n_workers: int) -> Optional[ProcessPoolExecutor]:
    """A fork-context process pool, or None where fork is unavailable (the
    module-global ``_WORKER_CTX`` is inherited by forking; spawn/forkserver
    children would see None and crash — fall back to serial instead)."""
    import multiprocessing as mp
    try:
        mp_ctx = mp.get_context("fork")
    except ValueError:
        return None
    try:
        return ProcessPoolExecutor(max_workers=n_workers, mp_context=mp_ctx)
    except (OSError, PermissionError, ValueError):
        return None


def _relaxed_feasible(ctx: _DPContext, tau: float) -> bool:
    """Cheap NECESSARY condition for DP feasibility at ``t_max = tau`` —
    a relaxation that keeps the load-bearing constraints (per-cluster stage
    budgets, per-link cut times, the ``t <= tau`` windows) but drops memory
    coupling, exact unit accounting (every stage is priced at its cluster's
    cheapest unit count), and overlap-free coverage.

    Frontier DP over (stages used per cluster, last cluster) -> farthest
    layer reached, with ``P[c1, c2, r]`` = best stage end on cluster c2
    entered from cluster c1 at any cut <= r whose transfer fits in tau.
    Any true DP solution induces such a chain, so relaxation-infeasible =>
    DP-infeasible — the pruning bisection runs on this (microseconds per
    tau) and the expensive DP probes start at its lower bound, which is
    tight whenever stage times or cut times drive feasibility."""
    tab = ctx.tables
    L, C = ctx.L, ctx.C
    jar = np.arange(L + 1)
    maxj = np.full((C, L + 1), -1)
    budgets = []
    for c in range(C):
        mids = ctx.mesh_ids_of_cluster[c]
        if mids:
            m = tab.feasible[mids] & (ctx.t_tab[mids] <= tau)
            maxj[c] = np.where(m, jar[None, None, :], -1).max(axis=(0, 2))
            budgets.append(ctx.units_total[c]
                           // max(1, min(ctx.mesh_units[i] for i in mids)))
        else:
            budgets.append(0)
    if int(maxj[:, 0].max()) >= L:
        return True          # one stage covers everything
    cut_ok = ctx.ctime <= tau                    # (L+1, C, C)
    P = np.full((C, C, L + 1), -1)
    for c1 in range(C):
        for c2 in range(C):
            v = np.where(cut_ok[:, c1, c2], maxj[c2], -1)
            v[0] = -1                            # q = 0 is the start, not a cut
            P[c1, c2] = np.maximum.accumulate(v)
    shape = tuple(b + 1 for b in budgets)
    R = np.full(shape + (C,), -1, dtype=np.int64)
    for used in np.ndindex(*shape):
        for c2 in range(C):
            if used[c2] == 0:
                continue
            prev = list(used)
            prev[c2] -= 1
            prev = tuple(prev)
            if not any(prev):                    # first stage: no cut
                r2 = int(maxj[c2, 0])
            else:
                r2 = -1
                for c1 in range(C):
                    rp = int(R[prev + (c1,)])
                    if rp > 0:
                        r2 = max(r2, rp, int(P[c1, c2, rp]))
            if r2 > R[used + (c2,)]:
                R[used + (c2,)] = r2
                if r2 >= L:
                    return True
    return False


# ---------------------------------------------------------------------------
# Search driver
# ---------------------------------------------------------------------------


def _check_deadline(deadline: Optional[float]) -> None:
    if deadline is not None and time.perf_counter() > deadline:
        raise SearchTimeout(
            "search exceeded its wall-clock deadline "
            "(SearchConfig.deadline_s)")


def _run_batches(ctx: _DPContext, keep: np.ndarray, engine: str,
                 stats: SearchStats,
                 known: Optional[Dict[float, float]] = None,
                 deadline: Optional[float] = None
                 ) -> List[Tuple[float, float]]:
    """Evaluate the surviving t_max candidates; (t, fill) per candidate.
    ``known`` carries fills already solved during pruning — those
    candidates are served from it instead of re-running the DP."""
    global _WORKER_CTX, _WORKER_ENGINE
    cfg = ctx.cfg
    results: List[Tuple[float, float]] = []
    if known:
        hits = [float(t) for t in keep if float(t) in known]
        results.extend((t, known[t]) for t in hits)
        stats.n_cache_served = len(hits)
        if hits:
            keep = np.array([t for t in keep if float(t) not in known])
    if len(keep) == 0:
        results.sort(key=lambda r: r[0])
        return results
    if engine == "vectorized":
        bs = ctx.batch_chunk(cfg.batch_size)
        batches = [list(map(float, keep[i:i + bs]))
                   for i in range(0, len(keep), bs)]
    else:
        nb = min(max(1, cfg.n_workers) * 4, len(keep)) if cfg.n_workers \
            else 1
        batches = [list(map(float, keep[i::nb])) for i in range(nb)] \
            if cfg.n_workers else [list(map(float, keep))]

    pool = None
    if cfg.n_workers and len(keep) > 8:
        pool = _fork_pool(cfg.n_workers)
    if pool is not None:
        from concurrent.futures.process import BrokenProcessPool
        base = list(results)       # the known-fill hits, kept on failure
        _WORKER_CTX, _WORKER_ENGINE = ctx, engine
        try:
            with pool:
                for out in pool.map(_worker_eval, batches):
                    results.extend(out)
            stats.workers_used = cfg.n_workers
        except (OSError, PermissionError, BrokenProcessPool):
            # pool died mid-flight (sandboxed fork, rlimits, ...): re-run
            # serially — identical math, just slower
            results = base
            pool = None
        finally:
            _WORKER_CTX = None
    if pool is None:
        if engine == "vectorized":
            for batch in batches:
                _check_deadline(deadline)
                fills = _dp_eval_batch(ctx, np.asarray(batch))
                results.extend(
                    (float(t), float(f)) for t, f in zip(batch, fills))
        else:
            for batch in batches:
                for t in batch:
                    _check_deadline(deadline)
                    results.append((float(t), _dp_eval(ctx, float(t))[0]))
    # deterministic selection order regardless of worker scheduling
    results.sort(key=lambda r: r[0])
    return results


def _search_impl(ctx: _DPContext, mb_tokens: int, engine: str,
                 stats: SearchStats, verbose: bool,
                 deadline: Optional[float] = None) -> ParallelStrategy:
    cfg = ctx.cfg
    cluster, tables = ctx.cluster, ctx.tables
    B = cfg.n_microbatches
    eval_one = _dp_eval if engine == "oracle" else _dp_eval_vec

    # ---- candidate t_max values (sorted, dedup'd — Alg. 1 line 2) ----------
    vals = ctx.t_tab[tables.feasible]
    sig = cfg.tmax_round_digits
    cands = np.unique(np.array(
        [float(f"%.{sig}g" % v) for v in vals if np.isfinite(v)]))
    if len(cands) == 0:
        raise RuntimeError("no feasible stage-mesh candidates")
    stats.n_tmax_candidates = len(cands)

    # ---- bidirectional pruning ---------------------------------------------
    # find the smallest feasible t_S (feasibility is monotone in t_max)
    fill_cache: Dict[int, float] = {}

    def probe(i: int) -> float:
        if i not in fill_cache:
            _check_deadline(deadline)
            stats.prune_evals += 1
            fill_cache[i] = float(_dp_eval(ctx, float(cands[i]))[0]) \
                if engine == "oracle" \
                else float(_dp_eval_batch(ctx, cands[i:i + 1])[0])
        return fill_cache[i]

    lo, hi = 0, len(cands) - 1
    if engine != "oracle":
        # pre-bisect on the microsecond-cheap necessary condition: every
        # candidate failing the coverage relaxation is DP-infeasible, so
        # the expensive DP probes start at the relaxation's lower bound
        if not _relaxed_feasible(ctx, float(cands[hi])):
            raise RuntimeError("infeasible even at largest t_max")
        while lo < hi:
            mid = (lo + hi) // 2
            if _relaxed_feasible(ctx, float(cands[mid])):
                hi = mid
            else:
                lo = mid + 1
        hi = len(cands) - 1
        # the relaxation bound is tight when stage/cut times drive
        # feasibility — probing it first usually ends the search in one
        # full DP solve
        if probe(lo) < INF:
            hi = lo
        elif lo < hi:
            lo += 1
    else:
        # pre-vectorization behavior: verify the top candidate up front
        if probe(hi) == INF:
            raise RuntimeError("infeasible even at largest t_max")
    while lo < hi:  # smallest feasible t_S (monotone feasibility)
        mid = (lo + hi) // 2
        if probe(mid) < INF:
            hi = mid
        else:
            lo = mid + 1
    if probe(lo) == INF:
        raise RuntimeError("infeasible even at largest t_max")
    t_S = float(cands[lo])
    fill_S = fill_cache[lo]
    T_S = fill_S + (B - 1) * t_S
    t_E = T_S / max(B - 1, 1)
    keep = cands[(cands >= t_S) & (cands <= t_E)]
    if len(keep) > cfg.max_candidates:
        idx = np.linspace(0, len(keep) - 1, cfg.max_candidates).astype(int)
        keep = keep[np.unique(idx)]
    stats.t_S, stats.t_E = t_S, t_E
    stats.n_pruned = int(stats.n_tmax_candidates - len(keep))
    if verbose:
        print(f"[search] {len(cands)} candidates -> t_S={t_S:.4g}, "
              f"t_E={t_E:.4g}, evaluating {len(keep)} ({engine})")

    # ---- batched (parallel) evaluation --------------------------------------
    t_ev0 = time.perf_counter()
    results = _run_batches(ctx, keep, engine, stats,
                           known={float(cands[i]): f
                                  for i, f in fill_cache.items()},
                           deadline=deadline)
    stats.eval_seconds = time.perf_counter() - t_ev0
    # fresh solves only: cache-served candidates cost nothing here and
    # their solve time is already accounted under prune_evals
    stats.n_evaluated = len(results) - stats.n_cache_served

    best_t, best_T = None, INF
    for t, fill in results:
        if fill == INF:
            continue
        T = fill + (B - 1) * t
        if T < best_T:
            best_T, best_t = T, t
    assert best_t is not None
    stats.best_t_max = float(best_t)
    stats.fill_cost = float(best_T - (B - 1) * best_t)
    stats.predicted_T = float(best_T)

    # ---- extract strategy ----------------------------------------------------
    _, F, N = eval_one(ctx, best_t, want_tables=True)
    picks = _backtrack(ctx, best_t, F, N)
    stages, c_links = [], []
    for si, (mid, k, j, K) in enumerate(picks):
        mesh = tables.meshes[mid]
        sc = tables.stage_costs[(mid, k, j)]
        stages.append(StageAssignment(
            layer_start=k, layer_end=j, cluster_idx=mesh.cluster_idx,
            mesh_n=mesh.n, mesh_m=mesh.m, tp=sc.tp, dp=sc.dp,
            t_f=sc.t_f, t_b=sc.t_b, mem_p=sc.mem_p, mem_a=sc.mem_a,
            intra_op=sc.intra))
        if si < len(picks) - 1:
            nxt_cluster = tables.meshes[picks[si + 1][0]].cluster_idx
            c_links.append(ctx.p2p(j, mesh.cluster_idx, nxt_cluster))

    t_per_stage = [s.t for s in stages]
    counts = h1f1b_counts(t_per_stage, c_links, B)
    if cfg.intra_overlap > 0 and all(s.intra_op is not None for s in stages):
        # validate with the intra-op collectives threaded separately through
        # the simulator so a fraction can overlap with compute (the DP itself
        # prices them fully exposed — a conservative upper bound)
        res = simulate(
            [s.t_f - s.intra_op.comm_time_f for s in stages],
            [s.t_b - s.intra_op.comm_time_b for s in stages],
            c_links, B, counts,
            intra_f=[s.intra_op.comm_time_f for s in stages],
            intra_b=[s.intra_op.comm_time_b for s in stages],
            intra_overlap=cfg.intra_overlap)
    else:
        res = simulate([s.t_f for s in stages], [s.t_b for s in stages],
                       c_links, B, counts)
    eta = eta_load_balance(
        res.stage_compute,
        [s.n_devices * cluster.subclusters[s.cluster_idx].device.peak_flops
         for s in stages])
    return ParallelStrategy(
        stages=stages, c_links=c_links, warmup_counts=counts,
        t_max=float(best_t), n_microbatches=B, mb_tokens=mb_tokens,
        est_step_time=res.makespan, eta=eta,
        planner_meta={
            "fill_cost": best_T - (B - 1) * best_t,
            "predicted_T": best_T,
            "n_tmax_evaluated": len(results),
            "profiler": dataclasses.asdict(tables.stats),
        })


def instrumented_search(cluster: HeteroCluster, tables: ProfileTables,
                        mb_tokens: int, cfg: SearchConfig = SearchConfig(),
                        verbose: bool = False, comm=None
                        ) -> Tuple[ParallelStrategy, SearchStats]:
    """Full HAPT search + observability: candidate t_max generation,
    bidirectional pruning, batched (parallel) evaluation, backtracking,
    H-1F1B scheduling.  Returns the strategy plus a :class:`SearchStats`
    record — the public hook for benchmarks and CI (no private imports
    needed).  The strategy is identical to :func:`search`'s.

    ``comm`` (optional :class:`repro_torch.comm.selector.CommModel`): WAN-latency-
    aware cut pricing — the tables are assumed to have been profiled with
    the same model, so the DP's collective and transfer costs agree."""
    t0 = time.perf_counter()
    ctx = _DPContext(cluster, tables, cfg, comm)
    engine = cfg.engine if cfg.engine != "auto" else "vectorized"
    if engine not in ("vectorized", "oracle"):
        raise ValueError(f"unknown search engine {cfg.engine!r}")
    if engine == "oracle" and ctx.C > 2:
        raise ValueError(
            f"oracle engine supports at most 2 sub-clusters, cluster has "
            f"{ctx.C}; use engine='vectorized'")
    stats = SearchStats(engine=engine, requested_engine=cfg.engine,
                        n_subclusters=ctx.C,
                        n_mesh_rows=len(tables.meshes), n_layers=ctx.L)
    deadline = t0 + cfg.deadline_s if cfg.deadline_s > 0 else None
    try:
        strategy = _search_impl(ctx, mb_tokens, engine, stats, verbose,
                                deadline)
    except RuntimeError:
        raise       # genuine infeasibility (or SearchTimeout) — both engines
        #             agree, no point re-running on the oracle
    except Exception:
        if engine != "vectorized" or ctx.C > 2:
            raise
        # defensive net: the scalar oracle re-runs the search (bit-identical
        # result, none of the speedup).  CI fails when this fires on the
        # canonical clusters — it means the fast path regressed.
        stats.engine = "oracle"
        stats.oracle_fallbacks += 1
        strategy = _search_impl(ctx, mb_tokens, "oracle", stats, verbose,
                                deadline)
    stats.total_seconds = time.perf_counter() - t0
    return strategy, stats


def search(cluster: HeteroCluster, tables: ProfileTables, mb_tokens: int,
           cfg: SearchConfig = SearchConfig(),
           verbose: bool = False, comm=None) -> ParallelStrategy:
    """Full HAPT search (see :func:`instrumented_search` for the stats-
    returning variant used by benchmarks)."""
    return instrumented_search(cluster, tables, mb_tokens, cfg, verbose,
                               comm=comm)[0]
