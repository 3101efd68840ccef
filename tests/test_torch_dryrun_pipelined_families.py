"""The port's launcher dry run of the pipelined multi-pod train cells of
the non-dense families, on reduced configs with ``REPRO_NMB=2``, each
stage traced at its own rank in a fake world of 512 ranks, as
``test_torch_dryrun_pipelined.py`` checks the dense one: MoE
(granite-moe, whose carry holds the router's ``aux``), SSM (mamba2, its
SSD chunk kept at the published 256, as ``test_torch_dryrun_families.py``
keeps it) and hybrid (zamba2, its stages padded with zero-gated units);
the VLM's cell is in ``test_torch_dryrun_pipelined_cross.py``.

Each cell comes back ``ok`` with both stages, at ranks 0 and 256, each
stage's argument bytes equal to its case's local shard bytes, and the
pipeline's sends counted over ``pod``: ``2 * n_mb`` per carry leaf per
stage.
The cells run under ``REPRO_FAST_ANALYSIS=1`` (one microbatch of half
the batch, its counts scaled by 2) to keep the file's time near a minute;
``test_torch_dryrun_pipelined.py`` (dense) and
``test_torch_dryrun_pipelined_schedule.py`` (MoE and hybrid) run both
microbatches and hold the sends to their exact bytes.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D

torch.set_num_threads(1)

N_MB = 2


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", str(N_MB))
    monkeypatch.setenv("REPRO_FAST_ANALYSIS", "1")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_pipelined_family_cells_are_ok_at_both_stages(arch):
    check_pipelined_cell(arch)


def check_pipelined_cell(arch):
    full = get_config(arch)
    cfg = get_config(arch).reduced()
    if full.ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=full.ssm_chunk)
    rec = D.run_cell(arch, "train_4k", "multi", None, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    assert not dist.is_initialized()
    assert [s["rank"] for s in rec["stages"]] == [0, 256]
    for stage in rec["stages"]:
        with D.fake_world("multi", stage["rank"]):
            want = D.shard_bytes(D.cell_case(arch, "train_4k", "multi", cfg=cfg)[0])
        assert stage["memory"]["argument_bytes"] == want > 0
        assert stage["collectives_by_mesh_dim"]["collective_permute@pod"] > 0
        # one send or receive per carry leaf per shift (MoE's carry adds aux)
        assert stage["collective_counts"]["collective_permute"] % (2 * N_MB) == 0
        assert stage["flops_per_device"] > 0
