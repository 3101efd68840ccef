"""``Executable.fit`` of the port against the reference's, on the CPU:
``compile`` full gpt-2b on the paper's case-study cluster, then train the
reduced gpt-2b through the executable (``exe.arch`` set to the reduced
config after ``attach_elastic``, so that the controller keeps pricing the
planned model) on the same JAX-init params, the same synthetic batches and
the same injected trainer clock, with the drift ledger and a JSONL run-log
attached.

Tolerance: losses to 1e-4 relative (tests/test_torch_fit.py's, f32 on both
sides).  The controller's decisions, the drift report and the run-log are
functions of the injected step times and the planner, so they are compared
exactly; the controller's own search clock is the same fake one on both
sides and both pipesim memos start empty (``torch_control_parity.py``).
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import api as R
from repro.core.cluster import paper_case_study_cluster as r_cluster
from repro.core.planner import PlannerConfig as RPlannerConfig
from repro.models import build_model as jax_build
from repro.obs import ObsConfig as RObsConfig
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro_torch import api as T
from repro_torch.convert import params_from_jax
from repro_torch.core.cluster import paper_case_study_cluster as t_cluster
from repro_torch.core.planner import PlannerConfig as TPlannerConfig
from repro_torch.obs import ObsConfig as TObsConfig
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from torch_control_parity import cold_sim_memo, fake_clock  # noqa: F401

torch.set_num_threads(1)

B, T_LEN, STEPS = 4, 48, 4
RTOL = 1e-4


def trainer_clock():
    """0.25 s a read: every step measures the same on both sides."""
    ticks = itertools.count()
    return lambda: next(ticks) * 0.25


def _compile(api, planner_cls, trainer_cls, obs_cls, cluster, tmp_path, side):
    cfg = api.HarpConfig(
        seq_len=T_LEN, global_batch=B,
        planner=planner_cls(granularity=8, n_microbatches=4),
        trainer=trainer_cls(total_steps=STEPS, log_every=1, ckpt_every=100,
                            ckpt_dir=str(tmp_path / f"ckpt_{side}")),
        obs=obs_cls(run_log=str(tmp_path / f"{side}.jsonl")))
    return api.compile("gpt-2b", cluster(), cfg)


def _run(tmp_path, elastic):
    ref = _compile(R, RPlannerConfig, RTrainerConfig, RObsConfig, r_cluster,
                   tmp_path, "ref")
    port = _compile(T, TPlannerConfig, TTrainerConfig, TObsConfig, t_cluster,
                    tmp_path, "port")
    assert port.strategy.to_json().split('"time_')[0] \
        == ref.strategy.to_json().split('"time_')[0]
    if elastic:
        ref.attach_elastic()
        port.attach_elastic()
    ref.arch = ref.arch.reduced()
    port.arch = port.arch.reduced()
    params = jax.tree.map(np.asarray,
                          jax_build(ref.arch).init(jax.random.PRNGKey(0)))
    logs = {"ref": [], "port": []}
    r = ref.fit(seed=0, clock=trainer_clock(), log_fn=logs["ref"].append)
    p = port.fit(seed=0, clock=trainer_clock(), log_fn=logs["port"].append,
                 device="cpu", params=params_from_jax(params))
    return ref, port, r, p, logs


def _assert_same_training(r, p):
    assert p["final_step"] == r["final_step"] == STEPS
    for a, b in zip(p["history"], r["history"]):
        assert a["step"] == b["step"] and a["time_s"] == b["time_s"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL,
                                       err_msg=f"step {a['step']} {k}")


def test_executable_fit_with_controller_and_obs_matches_reference(
        tmp_path, fake_clock):
    ref, port, r, p, logs = _run(tmp_path, elastic=True)
    _assert_same_training(r, p)
    dr = [dataclasses.asdict(d) for d in ref.controller.decisions]
    dp = [dataclasses.asdict(d) for d in port.controller.decisions]
    assert dp == dr
    assert dp[0]["reason"] == "seeded from compiled plan"
    # the measured steps are far off the plan's prediction: the controller
    # reacts after the warm-up step
    assert len(dp) > 1 and all(d["step"] >= 2 for d in dp[1:])
    # telemetry_warmup_steps = 1: the ledger observes steps 2..STEPS
    assert port.drift_ledger is port.controller.drift_ledger
    assert dataclasses.asdict(port.drift_report()) \
        == dataclasses.asdict(ref.drift_report())
    assert port.drift_report().n_observed == STEPS - 1
    run_log = (tmp_path / "port.jsonl").read_text()
    assert run_log == (tmp_path / "ref.jsonl").read_text()
    assert run_log.count('"kind": "step"') == STEPS
    assert len(logs["port"]) == len(logs["ref"])


def test_executable_fit_feeds_the_ledger_without_a_controller(tmp_path):
    ref, port, r, p, _ = _run(tmp_path, elastic=False)
    _assert_same_training(r, p)
    assert port.controller is None
    rep = port.drift_report()
    assert dataclasses.asdict(rep) == dataclasses.asdict(ref.drift_report())
    assert rep.n_observed == STEPS
    assert (tmp_path / "port.jsonl").read_bytes() \
        == (tmp_path / "ref.jsonl").read_bytes()
