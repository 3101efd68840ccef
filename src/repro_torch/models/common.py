"""Shared functional building blocks: norms, linears, embeddings, RoPE, the
activation dtype policy and logical-axis activation sharding.

Counterpart of ``repro/models/common.py``.  Models are plain functions over
explicit parameter dicts of tensors; repeated blocks store parameters
stacked along a leading layer axis, as in the reference, and the forward
pass loops over that axis.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Logical-axis activation sharding context
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(rules: Dict[str, Optional[object]]):
    """Enable :func:`shard_act` placements inside the context.

    ``rules`` maps logical axis names (``'batch'``, ``'embed'``,
    ``'heads'``, ``'ff'``, ``'vocab'``, ``'seq'``, ``'kv_seq'``,
    ``'expert'``, ...) to mesh dim names: a string, a tuple of them (the
    tensor dim split over several mesh dims, major to minor) or None for
    replicated.  Takes effect only under an ambient mesh
    (:func:`ambient_mesh`)."""
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = dict(rules)
    try:
        yield
    finally:
        _CTX.rules = prev


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None for none) the mesh that
    :func:`shard_act` places activations on: the reference's
    ``jax.set_mesh``.  The steps set it from their params' mesh."""
    prev = getattr(_CTX, "mesh", None)
    _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.mesh = prev


def current_mesh():
    return getattr(_CTX, "mesh", None)


def current_rules() -> Optional[Dict[str, Optional[object]]]:
    return getattr(_CTX, "rules", None)


def mesh_of(tree) -> Any:
    """The ``DeviceMesh`` of the first DTensor leaf of a nested dict (or
    tuple) of tensors; None when no leaf is a DTensor."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            m = mesh_of(t)
            if m is not None:
                return m
        return None
    return tree.device_mesh if isinstance(tree, DTensor) else None


@contextlib.contextmanager
def sharded_execution(mesh, rules: Dict[str, Optional[object]]):
    """The context a step runs in when its params are DTensors on ``mesh``:
    ``mesh`` ambient, ``rules`` active, and plain tensors that the model
    code makes (positions, masks, zero scalars) taken as replicated over
    the mesh, as constants are under the reference's jit.  With ``mesh``
    None, nothing changes."""
    if mesh is None:
        yield
        return
    with ambient_mesh(mesh), activation_sharding(rules), implicit_replication():
        yield


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute runs
    with the forward's ambient mesh and activation rules.  The backward of
    a CUDA op runs on autograd's device thread, where this module's
    thread-local context is unset and :func:`shard_act` would place
    nothing.  DTensor's implicit replication is process-wide and still on
    there (the backward runs inside the forward's
    :func:`sharded_execution`), so it is not entered again: leaving it
    would turn it off for the rest of the step."""
    mesh, rules = current_mesh(), current_rules()
    return contextlib.nullcontext(), _forward_context(mesh, rules)


@contextlib.contextmanager
def _forward_context(mesh, rules):
    if rules is None:
        yield
        return
    with ambient_mesh(mesh), activation_sharding(rules):
        yield


def checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint`` of ``fn(*args, **kwargs)``,
    non-reentrant, its recompute in the forward's sharding context
    (:func:`recompute_context`): every checkpoint of the models and the
    pipeline goes through here."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    return _checkpoint(fn, *args, use_reentrant=False,
                       context_fn=recompute_context, **kwargs)


def shard_act(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placements that ``names``
    (one logical axis name or None per dim) map to through the rules:
    ``Shard(d)`` on the mesh dims of dim ``d``, ``Replicate()`` elsewhere
    (``parallel.sharding.NamedSharding``), after ``fit_spec`` replicates a
    dim its mesh dims do not divide.  A no-op outside an
    :func:`activation_sharding` context, without an ambient mesh, or on a
    plain tensor, so every single-device path is unchanged."""
    rules = getattr(_CTX, "rules", None)
    mesh = getattr(_CTX, "mesh", None)
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import NamedSharding, fit_spec

    spec = tuple(rules.get(n) if n is not None else None for n in names)
    placements = NamedSharding(mesh, fit_spec(mesh, spec, x.shape)).placements()
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank: a position, a mask) replicated, a DTensor as it is."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)


def replicate_dims(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """A DTensor ``x`` with tensor dims ``dims`` replicated (every other
    placement kept); ``x`` itself when they are not sharded or ``x`` is a
    plain tensor.  The narrow redistribute before an op that DTensor cannot
    run on those dims sharded."""
    if not isinstance(x, DTensor):
        return x
    dims = [d % x.dim() for d in dims]
    placements = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
                  for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def shards_of(x: torch.Tensor, dim: int) -> int:
    """How many shards a DTensor's tensor dim ``dim`` is split into (1 for
    a plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    dim %= x.dim()
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= size
    return n


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d).  A DTensor whose last dim is split into
    shards that ``n`` does not divide (8 heads over a 16-way ``model``
    dim, say) has that dim replicated first: DTensor cannot unflatten it,
    where the reference's GSPMD pads."""
    if n % shards_of(x, -1):
        x = replicate_dims(x, [-1])
    return x.reshape(*x.shape[:-1], n, d)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shards(fn):
    """``fn`` for ``local_map``: each tensor argument's gradient is made
    contiguous on its way out.  ``local_map`` wraps a local gradient in a
    DTensor whose global strides say contiguous; an einsum's gradient
    comes back permuted, and a later view of the shard (a projection's
    backward flattening batch and sequence) then fails."""
    def wrapped(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
                    and a.requires_grad else a for a in args))
    return wrapped


def shard_index(mesh, placements, dim: int) -> int:
    """This rank's shard number along tensor dim ``dim`` of a DTensor with
    ``placements`` on ``mesh``: its coordinates on the mesh dims that
    shard ``dim``, major to minor.  Times the local size, the offset of the
    local shard in the global dim."""
    coord = mesh.get_coordinate()
    idx = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
    return idx


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """(..., n, d) -> (..., n * d), the inverse of :func:`split_last`.  When
    ``n`` does not divide over some mesh dim, the merged DTensor's
    gradient is brought back to the forward's placements before the
    reshape's backward unflattens it (:func:`pin_grad`): a gradient
    arriving sharded on the merged dim could not be unflattened."""
    y = x.reshape(*x.shape[:-2], -1)
    if _uneven_over_mesh(x, x.shape[-2]):
        y = pin_grad(y)
    return y


def _uneven_over_mesh(x: torch.Tensor, n: int) -> bool:
    return isinstance(x, DTensor) and any(n % m for m in x.device_mesh.shape)


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` as it is, whose gradient is redistributed to
    ``x``'s own placements on its way back (``from_local``'s backward);
    a plain tensor as it is.  Before a reduction to a scalar this keeps the
    backward sharded: the scalar's gradient is replicated, and a
    replicated gradient expanded back over a sharded batch would run the
    rest of the backward on the whole batch on every rank."""
    if not isinstance(x, DTensor):
        return x

    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of an embedding table (V, d).  A DTensor table
    is looked up per vocab shard (``local_map``): each rank gathers the
    ids that fall in its rows (zero elsewhere), ``Partial`` over the
    vocab's mesh dims, with the table's ``d`` whole and the ids placed as
    they come (the batch's sharding).  DTensor's own index op over a
    vocab-sharded table fails in its backward on some torch releases."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    table = replicate_dims(table, [1])
    ids = on_mesh(ids, mesh)
    vdims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    ids = ids.redistribute(mesh, [Replicate() if i in vdims or not isinstance(p, Shard)
                                  else p for i, p in enumerate(ids.placements)])
    rows = table.to_local().shape[0]
    lo = shard_index(mesh, table.placements, 0) * rows
    out_pl = [Partial() if i in vdims else p for i, p in enumerate(ids.placements)]
    grad_pl = [Shard(0) if i in vdims else Partial() if isinstance(p, Shard) else p
               for i, p in enumerate(ids.placements)]

    def lookup(tl, il):
        idx = il.long() - lo
        inside = (idx >= 0) & (idx < rows)
        got = tl[idx.clamp(0, rows - 1)]
        return got * inside[..., None].to(got.dtype)

    return local_map(local_shards(lookup), out_placements=out_pl,
                     in_placements=(table.placements, ids.placements),
                     in_grad_placements=(grad_pl, ids.placements),
                     device_mesh=mesh)(table, ids)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)     # in place: no second f32 copy


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, stack: Tuple[int, ...] = ()) -> torch.Tensor:
    """Fan-in scaled normal init; optional leading stack dims.  Drawn on the
    generator's device."""
    return _normal(gen, (*stack, d_in, d_out), d_in ** -0.5, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, output in x's dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in the compute dtype of x.

    On DTensors, an output that comes out ``Partial`` (a contraction over
    a sharded dim: the row-parallel projections) is reduced right away,
    as a row-parallel layer does: a ``Partial`` residual stream would
    carry the sum into every later op, and DTensor then gathers whole
    weights rather than reduce one activation."""
    y = torch.matmul(x, w.to(x.dtype))
    if isinstance(y, DTensor) and any(p.is_partial() for p in y.placements):
        y = y.redistribute(y.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in y.placements])
    return y


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu" or kind == "silu":
        return F.silu(x)
    if kind == "geglu" or kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# RoPE (split-halves layout)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                       # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activation compute dtype policy
# ---------------------------------------------------------------------------
# Parameters may be stored f32 while compute runs in another dtype: the cast
# happens once at the embedding; ``linear`` casts weights to the activation
# dtype per use.  ``None`` (the default) keeps the parameters' dtype.

_ACT_DTYPE: Optional[torch.dtype] = None


def set_act_dtype(dt: Optional[torch.dtype]) -> None:
    global _ACT_DTYPE
    _ACT_DTYPE = dt


def act_dtype_cast(x: torch.Tensor) -> torch.Tensor:
    if _ACT_DTYPE is not None and x.dtype != _ACT_DTYPE:
        return x.to(_ACT_DTYPE)
    return x


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copies.
    For the serving path, which runs no backward; see :func:`unstack`."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree, from one ``torch.unbind`` per leaf.

    Under autograd this matters: indexing a stacked leaf once per layer
    (:func:`layer`) gives each layer a backward that allocates a zero tensor
    of the whole stacked leaf, while one unbind has a single stacking
    backward for all layers."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level cross entropy with f32 statistics.

    logits: (..., V); labels: (...,) int.  Returns (loss, correct@1), both
    f32: ``loss = lse - logit[label]`` (plus ``z_loss * lse**2``), and the
    argmax with the first index winning ties.  DTensor logits sharded over
    the vocab take :func:`_vocab_parallel_ce`."""
    if isinstance(logits, DTensor):
        lse, ll, acc = _vocab_parallel_ce(logits, labels)
    else:
        lse = torch.logsumexp(logits.float(), dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0].float()
        acc = (torch.argmax(logits, dim=-1) == labels).float()
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss, acc


def _vocab_parallel_ce(logits, labels):
    """(lse, label logit, correct@1) of DTensor logits, each shard
    working on its own slice of the vocab (the whole of it where the vocab
    is not split): the max and
    the sum of exponentials reduce over the vocab's mesh dims (``Partial``
    max and sum), the label's logit is a masked local gather summed over
    them, and the argmax is each shard's first maximum, the lowest index
    among the shards that hold the global maximum.  DTensor's own
    ``gather`` over a sharded dim fails, and replicating the vocab would
    gather every logit onto every rank."""
    mesh = logits.device_mesh
    last = logits.dim() - 1
    vdims = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    rest = [p if i not in vdims else Replicate()
            for i, p in enumerate(logits.placements)]
    if any(not isinstance(p, (Shard, Replicate)) for p in rest):
        raise ValueError(f"logits placements {logits.placements}")
    labels = on_mesh(labels, mesh).redistribute(mesh, rest)
    v_local = logits.to_local().shape[-1]
    lo = shard_index(mesh, logits.placements, last) * v_local
    # mesh dims of size 1 leave the vocab whole: the plain logsumexp
    vdims = [i for i in vdims if mesh.size(i) > 1]

    def over_vocab(op):
        return [Partial(op) if i in vdims else p for i, p in enumerate(rest)]

    lf = logits.float()
    if vdims:
        m = local_map(lambda x: torch.amax(x, dim=-1, keepdim=True),
                      out_placements=over_vocab("max"),
                      in_placements=(logits.placements,),
                      device_mesh=mesh)(lf.detach()).redistribute(mesh, rest)
        lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    else:                           # the whole vocab on every rank
        lse = local_map(local_shards(lambda x: torch.logsumexp(x, dim=-1)),
                        out_placements=rest,
                        in_placements=(logits.placements,), device_mesh=mesh)(lf)

    def label_logit(lg, lb):
        idx = lb.long() - lo
        inside = (idx >= 0) & (idx < v_local)
        got = torch.gather(lg, -1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
        return torch.where(inside, got.float(), torch.zeros_like(got, dtype=torch.float32))

    ll = local_map(local_shards(label_logit), out_placements=over_vocab("sum"),
                   in_placements=(logits.placements, rest),
                   device_mesh=mesh)(logits, labels)

    acc = (argmax_last(logits) == labels.long()).float()
    return lse, ll, acc


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, dim=-1)``, the first index winning ties.  A DTensor
    split over its last dim takes each shard's first maximum and keeps the
    lowest global index among the shards that hold the global maximum
    (``Partial`` max, then ``Partial`` min), where DTensor's own argmax
    over a sharded dim fails."""
    if not isinstance(x, DTensor):
        return torch.argmax(x, dim=-1)
    mesh = x.device_mesh
    last = x.dim() - 1
    vdims = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    rest = [Replicate() if i in vdims else p for i, p in enumerate(x.placements)]
    lo = shard_index(mesh, x.placements, last) * x.to_local().shape[-1]

    def over(op):
        return [Partial(op) if i in vdims else p for i, p in enumerate(rest)]

    def local_max(xl):
        v, i = torch.max(xl, dim=-1)
        return v, i + lo

    with torch.no_grad():
        v, i = local_map(local_max, out_placements=(rest, rest),
                         in_placements=(x.placements,), device_mesh=mesh)(x.detach())
        vmax = DTensor.from_local(v.to_local(), mesh, over("max")).redistribute(mesh, rest)
        cand = torch.where(v == vmax, i, torch.full_like(i, 2 ** 62))
        return DTensor.from_local(cand.to_local(), mesh, over("min")).redistribute(mesh, rest)
