"""``repro_torch.api.fit`` on the CPU against the reference's ``fit``:
reduced gpt-2b, the same JAX-init params (converted through numpy), the
same ``make_batch`` data and the default AdamW (warmup min(20, steps)).
5 steps with a checkpoint at step 5, then both resume from their step-5
checkpoints and run to step 7.

Tolerance: per-step loss and grad norm to 1e-4 relative, f32 on both
sides (see torch_train_parity.py for the AdamW amplification bound)."""
import jax
import numpy as np
import pytest
import torch

from repro.api.config import HarpConfig as JaxHarpConfig
from repro.api.facade import fit as jax_fit
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.api import HarpConfig, fit
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.train.trainer import TrainerConfig

torch.set_num_threads(1)

B, T, STEPS, MORE = 4, 48, 5, 7
RTOL = 1e-4


def _run(tmp_path, total_steps):
    cfg_j = jax_config("gpt-2b").reduced()
    cfg_t = get_config("gpt-2b").reduced()
    tr = dict(total_steps=total_steps, ckpt_every=STEPS, log_every=1)
    logs = {"ref": [], "port": []}
    ref = jax_fit(cfg_j, JaxHarpConfig(seq_len=T, global_batch=B, trainer=JaxTrainerConfig(
        ckpt_dir=str(tmp_path / "ref"), **tr)), seed=0, log_fn=logs["ref"].append)
    params = jax.tree.map(np.asarray, jax_build(cfg_j).init(jax.random.PRNGKey(0)))
    port = fit(cfg_t, HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), **tr)), seed=0, device="cpu",
        params=params_from_jax(params), log_fn=logs["port"].append)
    return ref, port, logs


def _assert_same_history(ref, port):
    assert [h["step"] for h in port] == [h["step"] for h in ref]
    for a, b in zip(port, ref):
        for k in ("total_loss", "loss", "accuracy", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {a['step']} {k}")


def test_fit_matches_reference_and_resumes(tmp_path):
    ref, port, _ = _run(tmp_path, STEPS)
    assert port["final_step"] == ref["final_step"] == STEPS
    assert sorted(port["history"][0]) == sorted(ref["history"][0])
    _assert_same_history(ref["history"], port["history"])
    assert int(port["state"]["opt_state"].step) == STEPS

    ref2, port2, logs = _run(tmp_path, MORE)
    assert "[trainer] resumed from step 5" in logs["port"]
    assert "[trainer] resumed from step 5" in logs["ref"]
    assert [h["step"] for h in port2["history"]] == [6, 7]
    _assert_same_history(ref2["history"], port2["history"])


def test_fit_takes_a_custom_step_and_validates_config():
    calls = []

    def step(w, batch):
        calls.append(batch["tokens"].shape)
        return w + 1, {"loss": torch.tensor(0.5)}

    with pytest.raises(TypeError, match="state"):
        fit("gpt-2b", train_step=step, device="cpu")
    cfg = HarpConfig(seq_len=8, global_batch=2, trainer=TrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir="unused-ckpt-dir"))
    out = fit(get_config("gpt-2b").reduced(), cfg, train_step=step,
              state={"w": torch.zeros(())}, log_fn=lambda m: None)
    assert out["final_step"] == 3 and calls == [(2, 8)] * 3
    assert float(out["state"]["w"]) == 3.0
    with pytest.raises(ValueError, match="seq_len must be positive"):
        HarpConfig(seq_len=0).validate()
    assert HarpConfig().validate().global_batch == 1024
