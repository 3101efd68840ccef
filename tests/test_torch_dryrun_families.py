"""The port's launcher dry run (``repro_torch.launch.dryrun``) for the
non-dense families, on reduced configs in torch's ``fake`` process group
of 256 ranks (``single``) or 512 (``multi``), every step traced under
``FakeTensorMode``.

Each cell comes back ``ok`` with its argument bytes equal to the sum of its
leaves' local shard bytes: MoE (granite-moe, the experts over ``data``),
SSM (mamba2, ``long_500k`` on both meshes) and hybrid (zamba2); VLM and
audio are in ``test_torch_dryrun_cross.py``.  Train cells run 2 microbatches (``REPRO_NMB=2``), and the SSD
layers keep their published chunk of 256 (the reduced config's 32, meant
for arithmetic on the CPU, would loop 1024 times per layer at 32k).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D

from test_torch_dryrun import expected_args

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", "2")


CELLS = [
    ("granite-moe-1b-a400m", "train_4k", "single"),
    ("granite-moe-1b-a400m", "decode_32k", "multi"),
    ("mamba2-2.7b", "train_4k", "single"),
    ("mamba2-2.7b", "long_500k", "single"),
    ("mamba2-2.7b", "long_500k", "multi"),
    ("zamba2-7b", "prefill_32k", "single"),
    ("zamba2-7b", "long_500k", "multi"),
]


@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS)
def test_family_cells_are_ok_and_hold_their_shards(arch, shape, mesh_kind):
    check_cell(arch, shape, mesh_kind)


def check_cell(arch, shape, mesh_kind):
    full = get_config(arch)
    cfg = get_config(arch).reduced()
    if full.ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=full.ssm_chunk)
    rec = D.run_cell(arch, shape, mesh_kind, None, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    mem = rec["memory"]
    assert mem["argument_bytes"] == expected_args(shape, mesh_kind, cfg)
    assert mem["peak_per_device"] >= mem["argument_bytes"] > 0
    assert rec["flops_per_device"] > 0
