"""The checkpoints' recompute under sharded execution
(``models.common.checkpoint``), on the CPU.

On a CUDA card the backward runs on autograd's device thread, where the
thread-local ambient mesh and activation rules of ``models.common`` are
unset, so a checkpointed block would recompute without ``shard_act``
placing anything.  On the CPU the backward runs on the caller's thread,
so these tests call ``backward`` from another thread to stand for it.
"""
import importlib
import threading

import pytest
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import common

RULES = {"batch": "data", "embed": None}


def _backward_on_another_thread(loss):
    errors = []

    def run():
        try:
            loss.backward()
        except BaseException as e:          # surfaced in the test's thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if errors:
        raise errors[0]


def test_checkpoint_recomputes_in_the_forwards_context_on_another_thread():
    """The recompute sees the forward's mesh and rules, and leaves DTensor's
    process-wide implicit replication on for the rest of the step."""
    seen = []

    def body(x):
        seen.append((common.current_mesh(), common.current_rules()))
        return (2 * x).sin()

    x = torch.linspace(0, 1, 5, requires_grad=True)
    with common.ambient_mesh("mesh"), common.activation_sharding(RULES), \
            implicit_replication():
        _backward_on_another_thread(common.checkpoint(body, x).sum())
        still_on = DTensor._op_dispatcher._allow_implicit_replication
    assert seen == [("mesh", RULES), ("mesh", RULES)]     # forward, recompute
    assert still_on
    torch.testing.assert_close(x.grad, 2 * (2 * x.detach()).cos())


def test_checkpoint_outside_a_sharded_context_changes_nothing():
    seen = []

    def body(x):
        seen.append((common.current_mesh(), common.current_rules()))
        return x * x

    x = torch.arange(3.0, requires_grad=True)
    _backward_on_another_thread(common.checkpoint(body, x).sum())
    assert seen == [(None, None), (None, None)]
    torch.testing.assert_close(x.grad, 2 * x.detach())


@pytest.mark.parametrize("module", [
    "models.transformer", "models.moe_lm", "models.mamba_lm", "models.hybrid_lm",
    "models.vlm", "models.encdec", "parallel.pipeline"])
def test_every_checkpoint_recomputes_in_the_sharded_context(module):
    """The models' remat checkpoints and the pipeline's slot checkpoint all
    go through ``models.common.checkpoint``."""
    mod = importlib.import_module(f"repro_torch.{module}")
    assert mod.checkpoint is common.checkpoint
