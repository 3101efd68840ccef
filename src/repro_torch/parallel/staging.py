"""Per-family pipeline stage decompositions.

Counterpart of ``repro/parallel/staging.py``.  ``build_staging(cfg,
n_stages, params)`` restructures a model's parameter tree into (staged,
shared, consts):

  staged — every leaf gains a leading ``S`` dim (one slice per stage);
  shared — embed / head / norms / zamba's shared block (every stage reads
           them; their gradients sum over the stages);
  consts — non-trainable per-layer flag tensors (first-layer injection,
           identity-padding gates for uneven stage splits).

The *first-layer flag* makes the engine family-agnostic: layer ``l`` computes
``x = f_l * io.h_in + (1 - f_l) * h`` before its block, so only the stage
owning the model's first layer consumes fresh microbatches; everyone else
consumes the carry shifted from the stage before.  Uneven splits (zamba2's
81 = 13x6+3) are padded to uniform unit counts with zero gates (identity
layers).

Restructuring is reshape and concatenation only, so it runs on ``meta``
tensors too (a full-width staging without memory); the consts are made on
the params' device.  The stage functions call the port's blocks with
``use_kernels``: with it on, a stage on the card launches the flash and SSD
kernels (the reference's stages run its jnp attention).

As in the reference, ``make_io`` rounds the embedded input (and the VLM's
image embeddings) to bf16 before it casts them to ``act_dtype``, so an f32
pipeline consumes bf16-rounded embeddings (and the embedding gradient that
comes back through them is rounded to bf16).
One departure: the hybrid stage casts its SSD gates to the carry's dtype,
as ``_mix`` does with the first-layer flag, and folds each application's
gate into its ``adapt_out`` (a pad unit's zero ``adapt_out`` adds exactly
0).  The reference multiplies the bf16 carry by f32 gates, which promotes
it to f32, and its ``lax.scan`` then rejects the carry's changed dtype: its
zamba2 staging runs only in f32.

A stage's slot is ``run(layers(staged1, consts1), shared, carry, io_t)``:
``layers`` cuts the stage's stacked leaves into its layers in order (one
flatten and one unbind per leaf), and the pipeline calls it once per step,
so the backward stacks each leaf's gradient once per step, not once per
slot.  ``stage_fn`` is the two in one call.
whisper-medium (the audio family) is not pipelined: the planner places
sub-1B models data-parallel across pods.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid_lm, mamba_lm, moe_lm, vlm
from repro_torch.models import transformer as tf
from repro_torch.models.common import shard_act, softmax_cross_entropy, unstack
from repro_torch.train.optimizer import tree_map

Params = Dict[str, Any]


@dataclass
class Staging:
    cfg: ArchConfig
    n_stages: int
    staged: Params
    shared: Params
    consts: Params
    layers: Callable            # (staged1, consts1) -> the stage's layers
    run: Callable               # (layers, shared, carry, io_t) -> carry
    make_io: Callable           # (shared, batch, n_mb) -> io
    head_loss: Callable         # (shared, carry, io_t) -> (ce_sum, ntok, aux)
    zero_carry: Callable        # (io) -> carry

    def stage_fn(self, staged1, consts1, shared, carry, io_t):
        """One stage's slot: its layers applied to ``carry``."""
        return self.run(self.layers(staged1, consts1), shared, carry, io_t)


def _with_dtype(mk, sh, b, n, dt):
    io = mk(sh, b, n)
    io["h_in"] = io["h_in"].to(dt)
    if "img" in io:
        io["img"] = io["img"].to(dt)
    return io


def _mix(f, io_h, h):
    f = f.to(h.dtype)
    return f * io_h.to(h.dtype) + (1.0 - f) * h


def _reshape_stage(tree, S):
    return tree_map(lambda x: x.reshape(S, x.shape[0] // S, *x.shape[1:]), tree)


def _layers(tree, lead: int) -> List[Params]:
    """A stage's layers in order, from a tree whose leaves stack them over
    ``lead`` leading dims: one flatten and one unbind per leaf."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n = 1
    for d in first.shape[:lead]:
        n *= d
    return unstack(tree_map(lambda x: x.reshape(n, *x.shape[lead:]), tree), n)


def _flags(x: torch.Tensor) -> List[torch.Tensor]:
    """A consts tensor's per-layer 0-d flags, in layer order."""
    return list(torch.unbind(x.reshape(-1), 0))


def _block_layers(staged1, consts1, lead: int = 1):
    """(params, first-layer flag) of each layer of a stage of ``blocks``."""
    return list(zip(_layers(staged1["blocks"], lead), _flags(consts1["first"])))


def _first_flag(shape, device) -> torch.Tensor:
    f = torch.zeros(shape, dtype=torch.float32, device=device)
    f.view(-1)[0] = 1.0
    return f


def _device(params: Params) -> torch.device:
    return params["embed"].device


def _make_io_lm(cfg: ArchConfig, shared, batch, n_mb, act_dtype=torch.bfloat16):
    tokens, labels = batch["tokens"], batch["labels"]
    B, T = tokens.shape
    mb = B // n_mb
    h = tf.embed_tokens(cfg, {"embed": shared["embed"]}, tokens)
    h = h.to(act_dtype).reshape(n_mb, mb, T, -1)
    h = shard_act(h, (None, "batch", "seq", "embed"))
    return {"h_in": h, "labels": labels.reshape(n_mb, mb, T)}


def _head_loss_lm(cfg: ArchConfig, shared, carry, io_t):
    h = torch.nan_to_num(carry["h"])  # pre-warmup garbage on non-last stages
    logits = tf.lm_head(cfg, shared, h)
    per_tok, _ = softmax_cross_entropy(logits, io_t["labels"])
    ntok = torch.full((), float(per_tok.numel()), dtype=torch.float32,
                      device=h.device)
    aux = carry.get("aux")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return torch.sum(per_tok), ntok, aux


def _zero_carry_lm(io, with_aux=True):
    c = {"h": torch.zeros_like(io["h_in"][0])}
    if with_aux:
        c["aux"] = torch.zeros((), dtype=torch.float32, device=c["h"].device)
    return c


def _split_blocks(p, key="blocks"):
    return {k: v for k, v in p.items() if k != key}


# ---------------------------------------------------------------------------
# dense (uniform + gemma3 local:global pattern)
# ---------------------------------------------------------------------------


def _stage_dense(cfg: ArchConfig, S: int, params: Params,
                 use_kernels: bool) -> Staging:
    ratio = cfg.local_global_ratio
    L = cfg.n_layers
    dev = _device(params)
    if ratio:
        gsz = ratio + 1
        G = L // gsz
        first = _first_flag((S, G // S, gsz), dev)
        blocks = tree_map(lambda x: x.reshape(G, gsz, *x.shape[1:]),
                          params["blocks"])
        windows = [cfg.sliding_window if i < ratio else 0
                   for _ in range(G // S) for i in range(gsz)]
        lead = 2
    else:
        first = _first_flag((S, L // S), dev)
        blocks = params["blocks"]
        windows = [cfg.sliding_window] * (L // S)
        lead = 1
    staged = {"blocks": _reshape_stage(blocks, S)}
    shared = _split_blocks(params)

    def run(layers, shared_, carry, io_t):
        h = carry["h"]
        for (p, f), w in zip(layers, windows):
            h = _mix(f, io_t["h_in"], h)
            h = tf._block_apply(cfg, p, h, window=w, use_kernels=use_kernels)
        return {**carry, "h": h}

    return Staging(cfg, S, staged, shared, {"first": first},
                   lambda st, c: _block_layers(st, c, lead), run,
                   lambda sh, b, n: _make_io_lm(cfg, sh, b, n),
                   lambda sh, c, i: _head_loss_lm(cfg, sh, c, i),
                   lambda io: _zero_carry_lm(io, with_aux=False))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _stage_moe(cfg: ArchConfig, S: int, params: Params,
               use_kernels: bool) -> Staging:
    L = cfg.n_layers
    consts = {"first": _first_flag((S, L // S), _device(params))}
    staged = {"blocks": _reshape_stage(params["blocks"], S)}

    def run(layers, shared_, carry, io_t):
        h, aux = carry["h"], carry["aux"]
        for p, f in layers:
            h = _mix(f, io_t["h_in"], h)
            h, a = moe_lm._block_apply(cfg, p, h, use_kernels)
            aux = aux + a
        return {"h": h, "aux": aux}

    return Staging(cfg, S, staged, _split_blocks(params), consts,
                   _block_layers, run,
                   lambda sh, b, n: _make_io_lm(cfg, sh, b, n),
                   lambda sh, c, i: _head_loss_lm(cfg, sh, c, i),
                   _zero_carry_lm)


# ---------------------------------------------------------------------------
# SSM (mamba2)
# ---------------------------------------------------------------------------


def _stage_ssm(cfg: ArchConfig, S: int, params: Params,
               use_kernels: bool) -> Staging:
    L = cfg.n_layers
    consts = {"first": _first_flag((S, L // S), _device(params))}
    staged = {"blocks": _reshape_stage(params["blocks"], S)}

    def run(layers, shared_, carry, io_t):
        h = carry["h"]
        for p, f in layers:
            h = mamba_lm._block_apply(cfg, p, _mix(f, io_t["h_in"], h),
                                      use_kernels)
        return {**carry, "h": h}

    return Staging(cfg, S, staged, _split_blocks(params), consts,
                   _block_layers, run,
                   lambda sh, b, n: _make_io_lm(cfg, sh, b, n),
                   lambda sh, c, i: _head_loss_lm(cfg, sh, c, i),
                   lambda io: _zero_carry_lm(io, with_aux=False))


# ---------------------------------------------------------------------------
# hybrid (zamba2): units of (k SSM layers + shared-block application)
# ---------------------------------------------------------------------------


def _hybrid_dims(cfg: ArchConfig):
    """(k, n_apps, n_tail, U): SSD layers per unit, shared applications,
    tail layers, padded unit count."""
    k = cfg.shared_attn_every
    n_apps = cfg.n_layers // k
    n_tail = cfg.n_layers - n_apps * k
    return k, n_apps, n_tail, n_apps + (1 if n_tail else 0)


def _stage_hybrid(cfg: ArchConfig, S: int, params: Params,
                  use_kernels: bool) -> Staging:
    k, n_apps, n_tail, U = _hybrid_dims(cfg)
    assert U % S == 0, f"zamba2 units {U} not divisible by {S} stages"

    def pad_units(x_groups, x_tail):
        # x_groups: (n_apps, k, ...); x_tail: (n_tail, ...)
        flat = x_groups.reshape(n_apps * k, *x_groups.shape[2:])
        if n_tail:
            pad = torch.zeros((k - n_tail, *x_tail.shape[1:]), dtype=x_tail.dtype,
                              device=x_tail.device)
            flat = torch.cat([flat, x_tail, pad], dim=0)
        return flat.reshape(U, k, *flat.shape[1:])

    def pad_adapters(x):
        pad = torch.zeros((U - n_apps, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, pad], dim=0)

    staged = {"units": _reshape_stage(tree_map(pad_units, params["groups"],
                                               params["tail"]), S),
              "adapt_in": _reshape_stage(pad_adapters(params["adapt_in"]), S),
              "adapt_out": _reshape_stage(pad_adapters(params["adapt_out"]), S)}
    shared = {kk: v for kk, v in params.items()
              if kk in ("embed", "final_norm", "lm_head", "shared")}

    dev = _device(params)
    ssm_gate = torch.ones((U, k), dtype=torch.float32, device=dev)
    app_gate = torch.ones((U,), dtype=torch.float32, device=dev)
    if n_tail:
        ssm_gate[U - 1, n_tail:] = 0.0
        app_gate[U - 1] = 0.0
    consts = {"ssm_gate": ssm_gate.reshape(S, U // S, k),
              "app_gate": app_gate.reshape(S, U // S),
              "first": _first_flag((S, U // S, k), dev)}

    units_per_stage = U // S

    def layers(staged1, consts1):
        ssd = list(zip(_layers(staged1["units"], 2), _flags(consts1["ssm_gate"]),
                       _flags(consts1["first"])))
        apps = zip(unstack(staged1["adapt_in"], units_per_stage),
                   unstack(staged1["adapt_out"], units_per_stage),
                   _flags(consts1["app_gate"]))
        return [(ssd[u * k:(u + 1) * k], *app) for u, app in enumerate(apps)]

    def run(units, shared_, carry, io_t):
        h = carry["h"]
        for ssd, ai, ao, ag in units:
            for p, g, f in ssd:
                h = _mix(f, io_t["h_in"], h)
                delta = mamba_lm._block_apply(cfg, p, h, use_kernels) - h
                h = h + g.to(h.dtype) * delta
            # the shared block through the adapters, its application gate
            # folded into adapt_out
            h = hybrid_lm._shared_apply(cfg, shared_["shared"], ai,
                                        ag.to(ao.dtype) * ao, h, use_kernels)
        return {**carry, "h": h}

    return Staging(cfg, S, staged, shared, consts, layers, run,
                   lambda sh, b, n: _make_io_lm(cfg, sh, b, n),
                   lambda sh, c, i: _head_loss_lm(cfg, sh, c, i),
                   lambda io: _zero_carry_lm(io, with_aux=False))


# ---------------------------------------------------------------------------
# VLM (llama-3.2-vision): groups of (n self blocks + 1 cross block)
# ---------------------------------------------------------------------------


def _stage_vlm(cfg: ArchConfig, S: int, params: Params,
               use_kernels: bool) -> Staging:
    G, n_self = vlm._group_dims(cfg)
    assert G % S == 0
    staged = {"self_blocks": _reshape_stage(params["self_blocks"], S),
              "cross_blocks": _reshape_stage(params["cross_blocks"], S)}
    shared = {k: v for k, v in params.items()
              if k in ("embed", "final_norm", "lm_head")}
    consts = {"first": _first_flag((S, G // S, n_self), _device(params))}

    def make_io(shared_, batch, n_mb):
        io = _make_io_lm(cfg, shared_, batch, n_mb)
        B = batch["tokens"].shape[0]
        mb = B // n_mb
        img = batch["image_embeds"].to(io["h_in"].dtype)
        io["img"] = img.reshape(n_mb, mb, *img.shape[1:])
        return io

    def layers(staged1, consts1):
        selfs = list(zip(_layers(staged1["self_blocks"], 2),
                         _flags(consts1["first"])))
        crosses = unstack(staged1["cross_blocks"], G // S)
        return [(selfs[g * n_self:(g + 1) * n_self], pc)
                for g, pc in enumerate(crosses)]

    def run(groups, shared_, carry, io_t):
        h = carry["h"]
        for selfs, pc in groups:
            for p, f in selfs:
                h = _mix(f, io_t["h_in"], h)
                h = tf._block_apply(cfg, p, h, window=0, use_kernels=use_kernels)
            h = vlm._cross_apply(cfg, pc, h, io_t["img"], use_kernels=use_kernels)
        return {**carry, "h": h}

    return Staging(cfg, S, staged, shared, consts, layers, run, make_io,
                   lambda sh, c, i: _head_loss_lm(cfg, sh, c, i),
                   lambda io: _zero_carry_lm(io, with_aux=False))


# ---------------------------------------------------------------------------


_FAMILIES = {"dense": _stage_dense, "moe": _stage_moe, "ssm": _stage_ssm,
             "hybrid": _stage_hybrid, "vlm": _stage_vlm}


def build_staging(cfg: ArchConfig, n_stages: int, params: Params,
                  act_dtype=torch.bfloat16, use_kernels: bool = True) -> Staging:
    """``params`` in the model's layout (tensors on any device, ``meta``
    included); the staged and shared trees share their storage."""
    stage = _FAMILIES.get(cfg.family)
    if stage is None:
        raise ValueError(
            f"family {cfg.family!r} is not pipelined (audio trains "
            "data-parallel across pods — see DESIGN.md)")
    st = stage(cfg, n_stages, params, use_kernels)
    mk = st.make_io
    st.make_io = lambda sh, b, n: _with_dtype(mk, sh, b, n, act_dtype)
    return st


def unstage(cfg: ArchConfig, staged: Params, shared: Params) -> Params:
    """Inverse of the restructuring: (staged, shared) trees (params or
    their gradients) back in the model's layout.  The hybrid's pad layers
    and adapters are dropped; without a tail its empty ``tail`` comes back
    empty."""
    def lead(x, n, dims):
        """``x`` with its first ``dims`` dims merged into ``n`` rows."""
        return x.reshape(n, *x.shape[dims:])

    fam = cfg.family
    if fam in ("dense", "moe", "ssm"):
        dims = 3 if cfg.local_global_ratio else 2
        return {**shared, "blocks": tree_map(
            lambda x: lead(x, cfg.n_layers, dims), staged["blocks"])}
    if fam == "vlm":
        G = vlm._group_dims(cfg)[0]
        return {**shared,
                "self_blocks": tree_map(lambda x: lead(x, G, 2),
                                        staged["self_blocks"]),
                "cross_blocks": tree_map(lambda x: lead(x, G, 2),
                                         staged["cross_blocks"])}
    if fam == "hybrid":
        k, n_apps, n_tail, U = _hybrid_dims(cfg)
        units = tree_map(lambda x: lead(x, U * k, 3), staged["units"])
        return {**shared,
                "groups": tree_map(lambda x: x[:n_apps * k].reshape(
                    n_apps, k, *x.shape[1:]), units),
                "tail": tree_map(lambda x: x[n_apps * k:n_apps * k + n_tail],
                                 units),
                "adapt_in": lead(staged["adapt_in"], U, 2)[:n_apps],
                "adapt_out": lead(staged["adapt_out"], U, 2)[:n_apps]}
    raise ValueError(f"family {fam!r} is not pipelined")
