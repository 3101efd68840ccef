"""Sharded execution of the MoE (reduced granite-moe-1b-a400m; the experts over data) on two gloo ranks, on a
``(data=2, model=1)`` and a ``(data=1, model=2)`` mesh: the train step's
loss, grad norm, gradients and AdamW state (2 microbatches of the
reference's rows; the default and the ZeRO-1 layout), the AdamW update
alone from the same gradients, prefill's last logits and cache, and one decode step's
logits, cache and greedy tokens on DTensors placed by the reference's rules
equal the unsharded port's on plain tensors, within f32 1e-5 relative
(``torch_sharded_worker.py``, ``torch_sharded_gloo.py``).  The unsharded
port is held to the reference by the slice and train parity files.
"""
import pytest

from torch_sharded_gloo import hold, run_ranks


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_sharded_steps_match_the_unsharded_port(tmp_path, n_data, n_model):
    hold(run_ranks(tmp_path, "granite-moe-1b-a400m", n_data, n_model))
