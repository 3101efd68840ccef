"""The port's launcher dry run of the hybrid's pipelined multi-pod train
cell (zamba2, reduced: its stages padded with zero-gated units that run in
every slot) through the whole two-microbatch schedule, as
``test_torch_dryrun_pipelined_schedule.py`` checks the MoE's: each stage
shifts exactly ``n_mb`` carries and ``n_mb`` cotangents over ``pod``, its
carry the residual stream alone.
"""
import pytest
import torch

from test_torch_dryrun_pipelined_schedule import N_MB, check_schedule

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", str(N_MB))
    monkeypatch.delenv("REPRO_FAST_ANALYSIS", raising=False)


def test_each_microbatch_shifts_the_hybrid_carry():
    check_schedule("zamba2-7b", scalars=0)
