"""``make_pipeline_train_step(mesh=...)`` of reduced gpt-2b with each stage
on DTensors over its ``(data, model)`` sub-mesh, on four gloo ranks: a
``(2, 2, 1)`` and a ``(2, 1, 2)`` ``("pod", "data", "model")`` mesh,
against the port's local two-stage pipeline on the same params and batch
(``torch_pipeline_sharded_worker.py``, mode ``local``): every rank's loss,
grad norm and metrics, its staged and shared gradients, its ``mu`` and
``nu`` after the step (the default layout and ZeRO-1) and the AdamW update
alone from the same gradients, each against the same cut of the local
run's, within f32 1e-5 relative; the embedding table's gradient, which
comes back through bf16, within ``BF16_NORM_RTOL`` of its norm; the params
after the step within 2 lr of each element (AdamW); and the placement
exact: every leaf a DTensor on the rank's sub-mesh whose local shape is
the 3-D spec's ``shard_shape`` and whose storage is its own, the staged
bytes the whole over S and each leaf's shard factor
(``torch_pipeline_sharded.hold``).  The same step against the reference's
is ``test_torch_pipeline_sharded_reference.py``.
"""
import pytest

from torch_pipeline_sharded import MESH_IDS, MESHES, hold, inputs, run_ranks


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_pipeline_stages_on_a_sharded_mesh_match_the_local_pipeline(tmp_path, mesh):
    hold(run_ranks(tmp_path, "local", inputs("gpt-2b", mesh)))
