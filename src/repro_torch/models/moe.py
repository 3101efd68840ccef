"""Top-k routed mixture-of-experts with capacity-bounded scatter dispatch.

Counterpart of ``repro/models/moe.py``.  Dispatch is the GShard cumsum
algorithm without the dense (T, E, C) one-hot: per-assignment positions
inside each expert come from a cumulative sum of the assignment one-hot,
then tokens are scattered into an (E, C, d) buffer (out-of-capacity
assignments dropped), experts run as batched products, and outputs are
gathered back weighted by the router gate.

Every shape is fixed by (B, T, d, E, C), as in the reference: a dropped
assignment is written to a spare slot ``C`` of its expert's buffer, which
is cut off before the experts run, and reads back a zero row, so the block
has no data-dependent shape and never waits on the host.  Experts are
stacked (E, d, ff) per layer, (L, E, d, ff) in a model's blocks.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import (
    activate, current_rules, dense_init, linear, local_shards, replicate_dims,
    shard_act, shard_index,
)
from repro_torch.models.mlp import GATED
from repro_torch.parallel.sharding import NamedSharding, fit_spec


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             activation: str, dtype=torch.float32,
             stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
    """The router is f32 whatever ``dtype``; expert weights (*stack, E, ...)."""
    p = {
        "router": dense_init(gen, d_model, n_experts, torch.float32, stack),
        "w_up": dense_init(gen, d_model, d_ff, dtype, (*stack, n_experts)),
        "w_down": dense_init(gen, d_ff, d_model, dtype, (*stack, n_experts)),
    }
    if activation in GATED:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, (*stack, n_experts))
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """f32 routing of tokens x (N, d) -> (probs (N, E), gate_vals (N, k),
    expert_ids (N, k)), gates renormalised over the k choices.

    The choices come from a stable descending sort, so among equal
    probabilities the lower expert index comes first (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    logits = linear(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :top_k], ids[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_ids


def positions(expert_ids: torch.Tensor, n_experts: int, capacity: int):
    """Slots inside each expert's buffer, in routing priority: k-major (every
    token's first choice before any second choice), then token id.

    Returns (flat_e (k*N,), pos_c (k*N,), keep (k*N,) bool); a dropped
    assignment has ``pos_c == capacity``, the spare slot.  The one-hot is
    laid out (E, k*N), so the cumsum runs along its inner axis: along the
    outer axis of a (k*N, E) one-hot the card scans each expert's column
    with one thread."""
    flat_e = expert_ids.T.reshape(-1)                              # k-major
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e == experts[:, None]).long()                   # (E, k*N)
    # an assignment's own slot counts itself: exclusive = inclusive - 1
    pos = torch.cumsum(onehot, dim=1).gather(0, flat_e[None])[0] - 1
    keep = pos < capacity
    return flat_e, torch.where(keep, pos, capacity), keep


def moe_block(p: Dict[str, Any], h: torch.Tensor, *, top_k: int,
              capacity_factor: float, activation: str,
              router_aux_coef: float = 0.0):
    """h: (B, T, d) -> (out: (B, T, d), aux_loss: scalar f32).

    A DTensor ``h`` takes the same routing, capacity and drops over the
    whole batch, through the same four steps, each run on every rank's
    local tensors (``local_map``).  Routing and slot positions depend on
    every token (the cumsum runs over all of them; sort, cumsum and gather
    have no DTensor strategy over a sharded dim), so the tokens are
    gathered and every rank routes them all.  Each rank then fills the
    buffers of the experts it holds, the expert dim sharded as the
    ``expert`` rule says, runs them as batched products, and adds its
    experts' share of every token's output: a ``Partial`` sum over the
    expert dims, reduced onto the batch's sharding.  The gradient of the
    gathered tokens is ``Partial`` likewise (each rank's experts read some
    of them).  A plain ``h`` holds every expert (``e_lo = 0``, ``e_n = E``)."""
    B, T, d = h.shape
    E = p["w_up"].shape[0]
    n_tok = B * T
    C = _capacity(n_tok, E, top_k, capacity_factor)
    mesh = h.device_mesh if isinstance(h, DTensor) else None
    if mesh is None:
        x, router = h.reshape(n_tok, d), p["router"]
        e_lo, e_n = 0, E
        rep = buf_pl = part = None
    else:
        rep = [Replicate()] * mesh.ndim
        h_pl = list(h.placements)
        x = h.redistribute(mesh, [Replicate() if isinstance(q, Shard) and q.dim == 0
                                  else q for q in h_pl]).reshape(n_tok, d)
        x = replicate_dims(x, [0, 1])
        router = p["router"].redistribute(mesh, rep)
        # the buffer's placements: experts as the rule says, rows and d whole
        buf_pl = list(NamedSharding(mesh, fit_spec(
            mesh, ((current_rules() or {}).get("expert"), None, None),
            (E, C, d))).placements())
        e_dims = [i for i, q in enumerate(buf_pl) if q == Shard(0)]
        e_n = E // math.prod(mesh.size(i) for i in e_dims)
        e_lo = shard_index(mesh, buf_pl, 0) * e_n
        part = [Partial() if i in e_dims else Replicate() for i in range(mesh.ndim)]

    def per_rank(fn, out_pl, in_pl, grad_pl=None):
        """``fn`` on each rank's local tensors when ``h`` is a DTensor."""
        if mesh is None:
            return fn
        return local_map(local_shards(fn), out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_pl, device_mesh=mesh)

    def local_slots(sl):
        """Rows of the (e_n * (C + 1), d) buffer of experts [e_lo, e_lo +
        e_n); an assignment to another rank's expert takes row C, the
        spare slot of the first, which is cut off and reads zeros."""
        if e_n == E:
            return sl
        lo = e_lo * (C + 1)
        mine = (sl >= lo) & (sl < lo + e_n * (C + 1))
        return torch.where(mine, sl - lo, C)

    # --- routing (f32) -----------------------------------------------------
    def routing(xl, rl):
        probs, gate_vals, expert_ids = route(rl, xl, top_k)
        flat_e, pos_c, keep = positions(expert_ids, E, C)
        w = (gate_vals.T.reshape(-1) * keep).float()
        return probs, expert_ids, flat_e * (C + 1) + pos_c, w

    probs, expert_ids, slot, w = per_rank(routing, (rep,) * 4, (rep, rep))(x, router)

    # --- load-balance auxiliary loss (Switch/GShard form) -------------------
    frac_prob = probs.mean(dim=0)                                  # (E,)
    frac_tok = F.one_hot(expert_ids[:, 0], E).float().mean(dim=0)  # no gradient
    aux = router_aux_coef * E * torch.sum(frac_prob * frac_tok)

    # --- dispatch: scatter tokens into (E, C + 1, d); slot C takes the drops --
    def dispatch(xl, sl):
        rows = xl.expand(top_k, n_tok, d).reshape(-1, d)
        buf = xl.new_zeros((e_n * (C + 1), d)).index_copy(0, local_slots(sl), rows)
        return buf.view(e_n, C + 1, d)[:, :C]

    buf = per_rank(dispatch, buf_pl, (rep, rep), (part, rep))(x, slot)
    buf = shard_act(buf, ("expert", None, "embed"))

    # --- expert computation (batched over experts) ----------------------------
    up = torch.bmm(buf, p["w_up"].to(buf.dtype))
    if activation in GATED:
        gt = torch.bmm(buf, p["w_gate"].to(buf.dtype))
        up = activate(gt, activation) * up
    else:
        up = activate(up, activation)
    up = shard_act(up, ("expert", None, "ff"))
    out_buf = torch.bmm(up, p["w_down"].to(buf.dtype))
    if mesh is not None:
        out_buf = out_buf.redistribute(mesh, buf_pl)

    # --- combine: gather (slot C reads zeros) + gate-weighted sum over k ------
    # index_select's backward is an index_add, without the sort of an
    # advanced index's
    def combine(ol, sl, wl):
        got = F.pad(ol, (0, 0, 0, 1)).reshape(-1, d).index_select(0, local_slots(sl))
        return (got.float() * wl[:, None]).reshape(top_k, n_tok, d).sum(dim=0)

    y = per_rank(combine, part, (buf_pl, rep, rep), (buf_pl, rep, part))(out_buf, slot, w)
    y = y.reshape(B, T, d)
    if mesh is not None:
        y = y.redistribute(mesh, h_pl)
    return y.to(h.dtype), aux
