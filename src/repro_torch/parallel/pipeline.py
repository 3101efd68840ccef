"""Microbatch pipeline parallelism over the stages of a :class:`Staging`.

Counterpart of ``repro/parallel/pipeline.py``.  The paper's rule 1 confines
intra-op parallelism (DP/TP) inside a pod; the slow axis between pods
carries only inter-op (pipeline) traffic: microbatch activations sent from
one stage to the next.

Mechanics, as in the reference's ``pipeline_loss_fn``:
  - every stage's parameters are stacked along a leading stage dim;
  - a loop runs ``n_microbatches + S - 1`` slots; each slot every stage
    applies its layers to the carry it holds, then the carries shift one
    stage on (stage 0 receives zeros; the last stage's carry is dropped);
  - the first model layer swaps in the next microbatch's embedded input (a
    per-layer flag, so the mechanism is family-agnostic); the CE loss is
    computed at every stage but masked, by multiplication, to the last
    stage once the pipeline is full;
  - each stage's slot (its layers and its head) is recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant), so live memory is
    the in-flight carries; the shift is never inside the recomputed part.
  - ``loss = sum(ce) / max(sum(tokens), 1) + sum(aux) / n_microbatches``.

One departure from the reference: stage s at slot t reads the inputs of
the microbatch it holds, ``io[clip(t - s)]``, where the reference gives
every stage ``io[clip(t)]``.  Only the first stage consumes ``h_in`` (the
flag is 0 elsewhere, and ``0 * x + 1 * h`` is ``h`` exactly), so the two
agree bit for bit on every family but the VLM, whose cross blocks after the
first stage attend, in the reference, to a later microbatch's image.

Autograd through the slot loop gives the backward in GPipe order: the
shift's transpose is the reverse shift.

Two transports run the same slot loop:

- :class:`LocalTransport`: all S stages in one process on one device; the
  shift is list indexing and autograd flows through it.
- :class:`DistributedTransport`: one stage per rank of a ``torch.distributed``
  group (NCCL between GPUs, gloo on the CPU; :func:`backend_for`), each
  holding a leading stage dim of 1.  The shift is an autograd function
  whose forward sends to stage s+1 and receives from s-1 and whose backward
  sends the cotangent to s-1 and receives from s+1, both through
  ``batch_isend_irecv``.  The loss sums are all-reduced (their backward is
  the identity: every rank holds the same loss).  The train step sums the
  shared parameters' gradients over the ranks
  (:meth:`DistributedTransport.sum_shared_grads`), the transpose of their
  replication, and takes the clipping norm over every rank
  (:meth:`DistributedTransport.grad_norm`).
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import unstack
from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map


def backend_for(device: torch.device) -> str:
    """The ``torch.distributed`` backend for stages on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class LocalTransport:
    """Every stage in this process."""

    def stage_ids(self, n_stages: int) -> List[int]:
        return list(range(n_stages))

    def shift(self, carries: List[Any]) -> List[Any]:
        return [tree_map(torch.zeros_like, carries[0])] + carries[:-1]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def grad_norm(self, grads) -> torch.Tensor:
        """Global norm of ``{"staged": ..., "shared": ...}`` gradients."""
        return global_norm(grads)

    def sum_shared_grads(self, grads) -> None:
        pass


def _square_sum(tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))


class _AllSum(torch.autograd.Function):
    """All-reduce (sum) whose backward is the identity: the summed value is
    the same on every rank, and so is its cotangent."""

    @staticmethod
    def forward(ctx, x, transport):
        out = x.detach().clone()
        transport.dist.all_reduce(out, group=transport.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Shift(torch.autograd.Function):
    """The carry one stage on: sent to s+1, received from s-1 (zeros at
    stage 0).  The backward is the reverse shift."""

    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return transport.permute(x, reverse=False)

    @staticmethod
    def backward(ctx, g):
        return ctx.transport.permute(g, reverse=True), None


class DistributedTransport:
    """One stage per rank of ``group`` (the default group when ``None``):
    rank r of the group runs stage r.  ``torch.distributed`` must be
    initialised by the caller."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised; call "
                               "init_process_group before building a "
                               "DistributedTransport")
        self.dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def _global(self, r: int) -> int:
        return r if self.group is None else self.dist.get_global_rank(self.group, r)

    def stage_ids(self, n_stages: int) -> List[int]:
        if n_stages != self.world:
            raise ValueError(f"{n_stages} stages over {self.world} ranks")
        return [self.rank]

    def permute(self, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        x = x.contiguous()
        send, recv = self.rank + 1, self.rank - 1
        if reverse:
            send, recv = recv, send
        out = torch.zeros_like(x)
        ops = []
        if 0 <= send < self.world:
            ops.append(self.dist.P2POp(self.dist.isend, x, self._global(send),
                                       self.group))
        if 0 <= recv < self.world:
            ops.append(self.dist.P2POp(self.dist.irecv, out, self._global(recv),
                                       self.group))
        for req in self.dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return out

    def shift(self, carries: List[Any]) -> List[Any]:
        return [tree_map(lambda x: _Shift.apply(x, self), carries[0])]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return _AllSum.apply(x, self)

    def grad_norm(self, grads) -> torch.Tensor:
        """Global norm over every rank: each stage's squares are summed over
        the ranks; the shared gradients, already summed, count once."""
        staged = _square_sum(grads["staged"])
        self.dist.all_reduce(staged, group=self.group)
        return torch.sqrt(_square_sum(grads["shared"]) + staged)

    def sum_shared_grads(self, grads) -> None:
        for g in tree_leaves(grads):
            self.dist.all_reduce(g, group=self.group)


def _slot(spec, layers, shared, carry, io_t, io_out):
    carry = spec.run(layers, shared, carry, io_t)
    return carry, spec.head_loss(shared, carry, io_out)


def pipeline_loss_fn(spec, n_microbatches: int, transport=None):
    """Build ``loss(staged, shared, consts, batch) -> (loss, metrics)``.

    ``spec`` is a family staging (see ``parallel/staging.py``) providing
    make_io / layers / run / head_loss / zero_carry; ``transport`` is a
    :class:`LocalTransport` (the default) or a :class:`DistributedTransport`,
    whose ``staged`` / ``consts`` hold this rank's stage only."""
    transport = LocalTransport() if transport is None else transport
    S = spec.n_stages
    n_mb = n_microbatches
    stages = transport.stage_ids(S)

    def loss_fn(staged, shared, consts, batch):
        io = spec.make_io(shared, batch, n_mb)
        # each stage's layers, cut once per step (outside the recomputed
        # slots, so each leaf's gradient is stacked once)
        layers = [spec.layers(st, c) for st, c in
                  zip(unstack(staged, len(stages)), unstack(consts, len(stages)))]
        carries = [spec.zero_carry(io) for _ in stages]
        dev = io["h_in"].device
        sums = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(3)]
        n_slots = n_mb + S - 1

        def io_at(i):
            i = min(max(i, 0), n_mb - 1)
            return {k: v[i] for k, v in io.items()}

        for t in range(n_slots):
            io_out = io_at(t - (S - 1))
            for j, s in enumerate(stages):
                # stage s holds microbatch t - s (see the module docstring)
                carries[j], head = checkpoint(
                    _slot, spec, layers[j], shared, carries[j], io_at(t - s),
                    io_out, use_reentrant=False)
                valid = float(t >= S - 1) * float(s == S - 1)
                sums = [acc + x * valid for acc, x in zip(sums, head)]
            if S > 1 and t < n_slots - 1:   # the last slot's carries are dropped
                carries = transport.shift(carries)
        ce_sum, tok_sum, aux_sum = (transport.total(x) for x in sums)
        tokens = torch.clamp(tok_sum, min=1.0)
        ce = ce_sum / tokens
        aux = aux_sum / n_mb
        return ce + aux, {"loss": ce, "aux_loss": aux, "tokens": tokens}

    return loss_fn


__all__ = ["DistributedTransport", "LocalTransport", "backend_for",
           "pipeline_loss_fn"]
