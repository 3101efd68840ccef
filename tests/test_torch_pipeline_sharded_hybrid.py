"""The pipeline's stages on DTensors over their ``(data, model)`` sub-mesh
for zamba2-7b (units of SSD layers and a shared-block application), on four
gloo ranks of a ``(2, 2, 1)`` and a ``(2, 1, 2)`` ``("pod", "data",
"model")`` mesh, reduced (4 layers: one unit per stage; the 7-layer
case with a tail is ``test_torch_pipeline_sharded_hybrid_tail.py``),
against the port's local two-stage pipeline: what and at what
tolerance as in ``test_torch_pipeline_sharded_gpt.py``
(``torch_pipeline_sharded.hold``).
"""
import pytest

from torch_pipeline_sharded import MESH_IDS, MESHES, hold, inputs, run_ranks


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_pipeline_stages_on_a_sharded_mesh_match_the_local_pipeline(tmp_path, mesh):
    hold(run_ranks(tmp_path, "local", inputs("zamba2-7b", mesh)))
