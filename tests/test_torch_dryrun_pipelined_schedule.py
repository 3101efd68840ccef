"""The port's launcher dry run of two non-dense pipelined multi-pod train
cells through the whole two-microbatch schedule (``REPRO_NMB=2``, no
``REPRO_FAST_ANALYSIS``), on reduced configs, each stage traced at its own
rank in a fake world of 512 ranks: MoE (granite-moe, whose carry adds the
router's f32 ``aux`` scalar to the residual stream) here, and hybrid
(zamba2, whose stages are padded with zero-gated units that run in every
slot) in ``test_torch_dryrun_pipelined_schedule_hybrid.py``, which runs the
same check.

Each stage sends and receives exactly ``n_mb`` carries forward and
``n_mb`` cotangents back, one ``collective_permute`` per carry leaf each:
the residual stream's local bytes at the stage boundary (its rows over
the 16-way ``data`` dim), and 4 bytes for a replicated scalar.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D

torch.set_num_threads(1)

N_MB = 2


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", str(N_MB))
    monkeypatch.delenv("REPRO_FAST_ANALYSIS", raising=False)


def test_each_microbatch_shifts_every_carry_leaf():
    check_schedule("granite-moe-1b-a400m", scalars=1)


def check_schedule(arch, scalars):
    """``scalars``: the carry's replicated scalar leaves besides the
    residual stream."""
    cfg = get_config(arch).reduced()
    rec = D.run_cell(arch, "train_4k", "multi", None, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    assert rec["analysis_mode"] == "eager-1pass"
    assert not dist.is_initialized()
    shape = get_shape("train_4k")
    rows = shape.global_batch // N_MB // 16
    stream = rows * shape.seq_len * cfg.d_model * 4
    assert [s["rank"] for s in rec["stages"]] == [0, 256]
    for stage in rec["stages"]:
        by_dim = stage["collectives_by_mesh_dim"]
        assert stage["collective_counts"]["collective_permute"] == \
            2 * N_MB * (1 + scalars)
        assert by_dim["collective_permute@pod"] == \
            2 * N_MB * (stream + 4 * scalars)
        assert by_dim["all_reduce@pod"] > 0     # loss sums, shared grads, norm
