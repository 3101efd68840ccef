"""The port's launcher dry run for the cross-attention families, on reduced
configs in torch's ``fake`` process group, as
``test_torch_dryrun_families.py`` checks the others: VLM
(llama-3.2-vision) decode and multi-pod prefill, and audio (whisper),
whose multi-pod train cell is the reference's single-pod data parallelism
over ``(pod, data)``, not a pipeline.  Train cells run 2 microbatches
(``REPRO_NMB=2``).
"""
import pytest
import torch

from test_torch_dryrun_families import check_cell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", "2")


@pytest.mark.parametrize("arch,shape,mesh_kind", [
    ("llama-3.2-vision-90b", "decode_32k", "single"),
    ("llama-3.2-vision-90b", "prefill_32k", "multi"),
    ("whisper-medium", "prefill_32k", "single"),
    ("whisper-medium", "train_4k", "multi"),
])
def test_cross_family_cells_are_ok_and_hold_their_shards(arch, shape, mesh_kind):
    check_cell(arch, shape, mesh_kind)
