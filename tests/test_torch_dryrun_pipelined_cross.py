"""The port's launcher dry run of the VLM's pipelined multi-pod train cell
(llama-3.2-vision, reduced, its image embeddings in the batch), as
``test_torch_dryrun_pipelined_families.py`` checks the other families':
both stages ``ok`` at ranks 0 and 256, each holding its shard bytes and
sending over ``pod``.  Audio (whisper) has no such cell: its multi-pod
train cell is data parallel (``test_torch_dryrun_cross.py``).
``REPRO_NMB=2`` with ``REPRO_FAST_ANALYSIS=1``, as that file runs.
"""
import pytest
import torch

from test_torch_dryrun_pipelined_families import N_MB, check_pipelined_cell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", str(N_MB))
    monkeypatch.setenv("REPRO_FAST_ANALYSIS", "1")


def test_pipelined_vlm_cell_is_ok_at_both_stages():
    check_pipelined_cell("llama-3.2-vision-90b")
