"""The port stands alone: it imports neither jax nor the reference package,
its entry points default to CUDA and raise without a card, and the families
it has not ported yet say where they come."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20   # every module of the package


TRAINING_SLICE = [
    "repro_torch.api.config", "repro_torch.checkpoint.ckpt",
    "repro_torch.data.pipeline", "repro_torch.train.optimizer",
    "repro_torch.train.step", "repro_torch.train.trainer",
    "repro_torch.kernels.flash_attention", "repro_torch.models.api",
]
SSM_SLICE = ["repro_torch.models.ssm", "repro_torch.models.mamba_lm",
             "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ops"]

_IMPORT_ONE = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
importlib.import_module(sys.argv[1])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
assert not leaked, leaked
"""


@pytest.mark.parametrize("module", TRAINING_SLICE + SSM_SLICE)
def test_training_slice_module_imports_without_jax_or_reference(module):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_fit_defaults_to_cuda_and_raises_without_it():
    from repro_torch.api import HarpConfig, fit
    from repro_torch.configs import get_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(get_config("gpt-2b").reduced(), HarpConfig(seq_len=8, global_batch=2))


def test_entry_points_default_to_cuda_and_raise_without_it():
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate("gpt-2b", batch=1, prompt_len=4, gen_tokens=2, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("gpt-2b").reduced())


def test_generate_on_cpu_when_asked():
    from repro_torch.api import generate

    out = generate("gemma-2b", batch=2, prompt_len=8, gen_tokens=4,
                   reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    again = generate("gemma-2b", batch=2, prompt_len=8, gen_tokens=4,
                     reduced=True, device="cpu")
    assert (again["tokens"] == out["tokens"]).all()


def test_generate_takes_injected_params_and_prompt():
    import numpy as np
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init

    cfg = get_config("gpt-2b").reduced()
    params = init(cfg, torch.Generator().manual_seed(5))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 7))
    a = generate(cfg, params=params, prompt=prompt, gen_tokens=3, device="cpu",
                 seed=1)
    b = generate(cfg, params=params, prompt=prompt, gen_tokens=3, device="cpu",
                 seed=2)
    assert a["tokens"].shape == (3, 3)
    assert (a["tokens"] == b["tokens"]).all()   # greedy: the seed is unused


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b",
                                  "llama-3.2-vision-90b", "whisper-medium"])
def test_unported_families_name_their_roadmap_item(arch):
    from repro_torch.api import generate

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        generate(arch, reduced=True, batch=1, prompt_len=4, gen_tokens=2,
                 device="cpu")


def test_generate_and_fit_mamba_on_cpu_when_asked(tmp_path):
    """The SSM family serves and trains through the same entry points."""
    from repro_torch.api import HarpConfig, fit, generate
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainerConfig

    out = generate("mamba2-2.7b", batch=2, prompt_len=40, gen_tokens=4,
                   reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    res = fit(get_config("mamba2-2.7b").reduced(),
              HarpConfig(seq_len=48, global_batch=2, trainer=TrainerConfig(
                  total_steps=2, ckpt_every=1000, ckpt_dir=str(tmp_path))),
              device="cpu", log_fn=lambda m: None)
    assert res["final_step"] == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
