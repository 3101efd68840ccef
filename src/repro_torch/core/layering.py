"""Structure-preserving fine-grained layer construction (paper §5.1, Fig. 6b).

1. *Repeated-module mining*: iteratively find the most frequent contiguous
   operator sub-sequence containing at least ``z`` heavy ops, designate its
   non-overlapping occurrences as instances of a repeated module, and recurse
   on the remaining non-repeated spans until no repeat exists.
2. *Per-module clustering*: within each module, cluster operators into
   contiguous flops-balanced layers (Alpa-style); every instance of a
   repeated module gets the *same* partition, so layers inherit a structural
   ``class_key`` — the zero-redundant profiler aliases stage-mesh candidates
   whose layer-class sequences match.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.opgraph import Op


@dataclass(frozen=True)
class Module:
    start: int                # op index span [start, end)
    end: int
    class_id: int             # shared across repeated instances
    repeated: bool


@dataclass(frozen=True)
class Layer:
    """One planner layer: a contiguous op range."""
    start: int
    end: int
    flops_per_token: float
    param_bytes: float
    act_out_bytes_per_token: float    # boundary activation (last op's output)
    class_key: Tuple[int, int]        # (module class, position-in-module)
    module_instance: int
    ar_bytes_per_token: float = 0.0   # TP all-reduce payload (Megatron-style)

    @property
    def n_ops(self) -> int:
        return self.end - self.start


_AR_SUFFIXES = (".out", ".down", ".outproj", ".adapt_out")


def _is_ar_op(name: str) -> bool:
    """Ops whose output needs a tensor-parallel all-reduce (row-parallel
    matmul outputs in the Megatron sharding scheme)."""
    return name.endswith(_AR_SUFFIXES) or name == "lm_head" or name.endswith(".experts")


# ---------------------------------------------------------------------------
# Repeated-module mining
# ---------------------------------------------------------------------------


def _find_best_pattern(sigs: Sequence[str], heavy: Sequence[bool],
                       z: int, max_len: int) -> Optional[Tuple[int, int]]:
    """Most frequent (then longest) contiguous pattern with >= z heavy ops and
    >= 2 non-overlapping occurrences.  Returns (start, length) or None."""
    n = len(sigs)
    best: Optional[Tuple[int, int]] = None
    best_rank = (1, 0)  # (count, length)
    for w in range(1, min(max_len, n // 2) + 1):
        windows: Dict[Tuple[str, ...], List[int]] = {}
        for i in range(n - w + 1):
            if sum(heavy[i:i + w]) < z:
                continue
            windows.setdefault(tuple(sigs[i:i + w]), []).append(i)
        for pat, starts in windows.items():
            # greedy non-overlapping count
            count, last_end = 0, -1
            first = starts[0]
            for s in starts:
                if s >= last_end:
                    count += 1
                    last_end = s + w
            if count >= 2 and (count, w) > best_rank:
                best_rank = (count, w)
                best = (first, w)
    return best


def mine_modules(ops: Sequence[Op], z: int = 2, max_pattern_len: int = 64) -> List[Module]:
    """Partition the op sequence into repeated / non-repeated modules."""
    sigs = [o.signature for o in ops]
    heavy = [o.heavy for o in ops]
    n = len(ops)
    assigned = [-1] * n          # module list index per op
    modules: List[Module] = []
    spans = [(0, n)]             # unassigned spans to mine
    class_counter = itertools.count()

    while True:
        # mine within current non-repeated spans only
        found = None
        for (s, e) in spans:
            sub = _find_best_pattern(sigs[s:e], heavy[s:e], z, max_pattern_len)
            if sub is not None:
                cand = (s + sub[0], sub[1])
                if found is None or sub[1] > found[2]:
                    found = (cand[0], cand[0] + cand[1], cand[1])
        if found is None:
            break
        pstart, pend, w = found
        pattern = tuple(sigs[pstart:pend])
        cid = next(class_counter)
        new_spans: List[Tuple[int, int]] = []
        for (s, e) in spans:
            i = s
            while i <= e - w:
                if tuple(sigs[i:i + w]) == pattern:
                    if i > s:
                        new_spans.append((s, i))
                    modules.append(Module(i, i + w, cid, True))
                    i += w
                    s = i
                else:
                    i += 1
            if s < e:
                new_spans.append((s, e))
        spans = new_spans

    nid_base = 10_000
    for idx, (s, e) in enumerate(spans):
        modules.append(Module(s, e, nid_base + idx, False))
    modules.sort(key=lambda m: m.start)
    return modules


# ---------------------------------------------------------------------------
# Balanced contiguous clustering within a module
# ---------------------------------------------------------------------------


def _balanced_partition(costs: Sequence[float], q: int) -> List[int]:
    """Split ``costs`` into q contiguous parts minimizing the max part sum.
    Returns cut indices (part boundaries, length q+1, starts with 0)."""
    n = len(costs)
    q = min(q, n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    # DP over (parts, end): minimize max part
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(q + 1)]
    cut = [[0] * (n + 1) for _ in range(q + 1)]
    dp[0][0] = 0.0
    for p in range(1, q + 1):
        for e in range(p, n + 1):
            for s in range(p - 1, e):
                v = max(dp[p - 1][s], prefix[e] - prefix[s])
                if v < dp[p][e]:
                    dp[p][e] = v
                    cut[p][e] = s
    bounds = [n]
    e = n
    for p in range(q, 0, -1):
        e = cut[p][e]
        bounds.append(e)
    return bounds[::-1]


def build_layers(ops: Sequence[Op], target_layers: int, z: int = 2) -> List[Layer]:
    """Construct the fine-grained structural layer sequence (~target_layers)."""
    modules = mine_modules(ops, z=z)
    total_flops = sum(o.flops_per_token for o in ops) or 1.0

    # allocate layer budget per module CLASS proportional to flop share
    class_spans: Dict[int, List[Module]] = {}
    for m in modules:
        class_spans.setdefault(m.class_id, []).append(m)

    class_layers: Dict[int, int] = {}
    for cid, insts in class_spans.items():
        share = sum(
            sum(ops[i].flops_per_token for i in range(m.start, m.end))
            for m in insts) / total_flops
        per_class_total = max(len(insts), round(share * target_layers))
        class_layers[cid] = max(1, per_class_total // len(insts))

    layers: List[Layer] = []
    for inst_id, m in enumerate(modules):
        costs = [ops[i].flops_per_token for i in range(m.start, m.end)]
        # ensure light-op-only modules still form one layer
        q = class_layers[m.class_id]
        bounds = _balanced_partition([c + 1e-9 for c in costs], q)
        for pos in range(len(bounds) - 1):
            s, e = m.start + bounds[pos], m.start + bounds[pos + 1]
            if s == e:
                continue
            layers.append(Layer(
                start=s, end=e,
                flops_per_token=sum(ops[i].flops_per_token for i in range(s, e)),
                param_bytes=sum(ops[i].param_bytes for i in range(s, e)),
                act_out_bytes_per_token=ops[e - 1].act_bytes_per_token,
                class_key=(m.class_id, pos),
                module_instance=inst_id,
                ar_bytes_per_token=sum(
                    ops[i].act_bytes_per_token for i in range(s, e)
                    if _is_ar_op(ops[i].name)),
            ))
    if target_layers < len(layers):
        # COARSE regime (Alpa-like): merge whole module instances into
        # ~target_layers super-layers balanced by flops; merged layers keep a
        # composite class_key so structural aliasing still applies
        layers = _merge_layers(layers, target_layers)
    return layers


def _merge_layers(layers: List[Layer], target: int) -> List[Layer]:
    bounds = _balanced_partition(
        [l.flops_per_token + 1e-9 for l in layers], target)
    merged: List[Layer] = []
    for pos in range(len(bounds) - 1):
        group = layers[bounds[pos]:bounds[pos + 1]]
        if not group:
            continue
        merged.append(Layer(
            start=group[0].start, end=group[-1].end,
            flops_per_token=sum(l.flops_per_token for l in group),
            param_bytes=sum(l.param_bytes for l in group),
            act_out_bytes_per_token=group[-1].act_out_bytes_per_token,
            class_key=tuple(l.class_key for l in group),
            module_instance=group[0].module_instance,
            ar_bytes_per_token=sum(l.ar_bytes_per_token for l in group),
        ))
    return merged


def layer_class_sequence(layers: Sequence[Layer], start: int, end: int) -> Tuple:
    """Structural identity of the stage spanning layers [start, end)."""
    return tuple(l.class_key for l in layers[start:end])
