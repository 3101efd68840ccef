"""The port stands alone: it imports neither jax nor the reference package,
its entry points default to CUDA and raise without a card, and every family
(dense, SSM, MoE, hybrid, VLM, audio) serves and trains on the CPU when
asked; the VLM and audio families train through ``fit(train_step=...,
state=...)`` with a step that adds their frontend input, and ``fit``
without one says so."""
import json
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
MOE_SLICE = ["repro_torch.models.moe", "repro_torch.models.moe_lm",
             "repro_torch.models.prefill"]
HYBRID_SLICE = ["repro_torch.models.hybrid_lm"]
CROSS_SLICE = ["repro_torch.models.encdec", "repro_torch.models.vlm",
               "repro_torch.models.attention"]

_IMPORT_ONE = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
importlib.import_module(sys.argv[1])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
assert not leaked, leaked
"""


KBENCH_SLICE = [
    "repro_torch.kernels.rmsnorm", "repro_torch.kbench",
    "repro_torch.kbench.table", "repro_torch.kbench.bridge",
    "repro_torch.kbench.harness", "repro_torch.kbench.autotune",
    "repro_torch.comm", "repro_torch.comm.topology",
    "repro_torch.comm.algorithms", "repro_torch.comm.netsim",
    "repro_torch.comm.selector", "repro_torch.core",
    "repro_torch.core.cluster", "repro_torch.core.strategy",
    "repro_torch.core.opgraph", "repro_torch.core.layering",
    "repro_torch.core.costmodel", "repro_torch.core.profiler",
    "repro_torch.core.h1f1b", "repro_torch.core.pipesim",
    "repro_torch.core.dp_search", "repro_torch.core.planner",
]


CONTROL_PLANE = [
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
    "repro_torch.obs.sink", "repro_torch.obs.drift",
    "repro_torch.serving", "repro_torch.serving.workload",
    "repro_torch.serving.kvplan", "repro_torch.serving.objective",
    "repro_torch.serving.batching", "repro_torch.serving.placement",
    "repro_torch.migrate", "repro_torch.migrate.layout",
    "repro_torch.migrate.differ", "repro_torch.migrate.pricing",
    "repro_torch.migrate.apply",
    "repro_torch.runtime", "repro_torch.runtime.events",
    "repro_torch.runtime.telemetry", "repro_torch.runtime.replay",
    "repro_torch.runtime.controller",
    "repro_torch.chaos", "repro_torch.chaos.faults", "repro_torch.chaos.inject",
    "repro_torch.core.baselines", "repro_torch.api", "repro_torch.api.registry",
    "repro_torch.api.artifacts", "repro_torch.api.facade",
    "repro_torch.api.cli",
]
PIPELINE_SLICE = ["repro_torch.parallel.staging", "repro_torch.parallel.pipeline"]
SHARDED_SLICE = ["repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                 "repro_torch.models.common", "repro_torch.serve.step"]


@pytest.mark.parametrize("module", TRAINING_SLICE + SSM_SLICE + MOE_SLICE
                         + HYBRID_SLICE + CROSS_SLICE + KBENCH_SLICE
                         + CONTROL_PLANE + PIPELINE_SLICE + SHARDED_SLICE)
def test_training_slice_module_imports_without_jax_or_reference(module):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


_IMPORT_WITHOUT_TOOLCHAIN = """
import shutil, sys
sys.modules["triton"] = None
assert shutil.which("nvcc") is None
from repro_torch.kbench import autotune, harness
from repro_torch.core import planner
from repro_torch.kernels import build
assert not build._LOADED, build._LOADED
assert "triton" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
"""


def test_kbench_imports_without_nvcc_or_triton():
    """Kernels build at their first launch, never when a module imports."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               PATH=os.path.dirname(sys.executable))
    res = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_TOOLCHAIN],
                         env=env, capture_output=True, text=True, timeout=120)
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


def _generate_and_fit_with_modality(arch, tmp_path):
    """``generate``, then 2 steps of ``fit`` through ``make_train_step`` and
    a step that adds the family's frontend input to each batch."""
    from repro_torch.api import HarpConfig, fit, generate
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import modality_inputs
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig

    out = generate(arch, batch=2, prompt_len=40, gen_tokens=4, reduced=True,
                   device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    cfg = get_config(arch).reduced()
    step_fn, model, opt_init = make_train_step(
        cfg, OptimizerConfig(warmup_steps=2, total_steps=2), device="cpu")
    gen = generator(model.device, 0)
    params = model.init(gen)
    extra = modality_inputs(cfg, 2, gen)

    def train_step(params, opt_state, batch):
        return step_fn(params, opt_state, {**batch, **extra})
    res = fit(cfg, HarpConfig(seq_len=48, global_batch=2, trainer=TrainerConfig(
        total_steps=2, ckpt_every=1000, log_every=1, ckpt_dir=str(tmp_path))),
        train_step=train_step,
        state={"params": params, "opt_state": opt_init(params)},
        device="cpu", log_fn=lambda m: None)
    assert res["final_step"] == 2
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in res["history"])
    return extra


def test_generate_and_fit_whisper_on_cpu_when_asked(tmp_path):
    """The audio family serves and trains through the same entry points."""
    extra = _generate_and_fit_with_modality("whisper-medium", tmp_path)
    assert tuple(extra["frames"].shape) == (2, 32, 64)


def test_generate_and_fit_llama_vision_on_cpu_when_asked(tmp_path):
    """The VLM family serves and trains through the same entry points."""
    extra = _generate_and_fit_with_modality("llama-3.2-vision-90b", tmp_path)
    assert tuple(extra["image_embeds"].shape) == (2, 16, 64)


@pytest.mark.parametrize("arch,key", [("whisper-medium", "frames"),
                                      ("llama-3.2-vision-90b", "image_embeds")])
def test_fit_without_modality_inputs_raises(arch, key, tmp_path):
    """The synthetic pipeline makes tokens only: ``fit`` without a
    ``train_step`` names the missing input before it builds anything (on a
    machine without a card it would otherwise raise for the device)."""
    from repro_torch.api import HarpConfig, fit
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainerConfig

    with pytest.raises(ValueError, match=key):
        fit(get_config(arch).reduced(),
            HarpConfig(seq_len=8, global_batch=2, trainer=TrainerConfig(
                total_steps=1, ckpt_dir=str(tmp_path))))
    assert not list(tmp_path.iterdir())


def test_every_family_is_ported():
    """No registered arch's family is left for ``check_family`` to refuse;
    a family outside the port still raises ``NotImplementedError``."""
    import dataclasses
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models.api import _FAMILY
    from repro_torch.models.prefill import _FAMILY as PREFILL, check_family

    assert sorted(_FAMILY) == sorted(PREFILL)
    for arch in list_archs():
        check_family(get_config(arch))
    with pytest.raises(NotImplementedError, match="not ported"):
        check_family(dataclasses.replace(get_config("gpt-2b"), family="diffusion"))


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


def test_generate_and_fit_granite_moe_on_cpu_when_asked(tmp_path):
    """The MoE family serves and trains through the same entry points; its
    loss carries the router aux loss."""
    from repro_torch.api import HarpConfig, fit, generate
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainerConfig

    out = generate("granite-moe-1b-a400m", batch=2, prompt_len=40, gen_tokens=4,
                   reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    res = fit(get_config("granite-moe-1b-a400m").reduced(),
              HarpConfig(seq_len=48, global_batch=2, trainer=TrainerConfig(
                  total_steps=2, ckpt_every=1000, log_every=1,
                  ckpt_dir=str(tmp_path))),
              device="cpu", log_fn=lambda m: None)
    assert res["final_step"] == 2
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert all(h["aux_loss"] > 0 for h in res["history"])


def test_generate_and_fit_zamba2_on_cpu_when_asked(tmp_path):
    """The hybrid family serves and trains through the same entry points,
    with and without a tail of SSD layers after the last shared block."""
    import dataclasses
    from repro_torch.api import HarpConfig, fit, generate
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainerConfig

    out = generate("zamba2-7b", batch=2, prompt_len=40, gen_tokens=4,
                   reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    for n_layers in (4, 5):             # 2 applications; tail 0, then 1
        cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                                  n_layers=n_layers)
        res = fit(cfg, HarpConfig(seq_len=48, global_batch=2,
                                  trainer=TrainerConfig(
                                      total_steps=2, ckpt_every=1000, log_every=1,
                                      ckpt_dir=str(tmp_path / str(n_layers)))),
                  device="cpu", log_fn=lambda m: None)
        assert res["final_step"] == 2
        assert len(res["history"]) == 2
        assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                   for h in res["history"])


def test_pipeline_train_step_defaults_to_cuda_and_raises_without_it():
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import make_pipeline_train_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline_train_step(get_config("gpt-2b").reduced(), OptimizerConfig(),
                                 n_stages=2, n_microbatches=2)


def _cli(*args):
    """``python -m repro_torch`` in a fresh interpreter with ``jax`` and
    ``repro`` blocked."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.argv = ['repro_torch', *{list(args)!r}]\n"
            "runpy.run_module('repro_torch', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_help_runs_without_jax_or_reference():
    res = _cli("--help")
    assert res.returncode == 0, res.stderr
    for cmd in ("plan", "simulate", "train", "replay", "trace", "migrate",
                "kbench", "chaos", "dryrun"):
        assert cmd in res.stdout


def test_cli_rejects_dryrun(tmp_path):
    """``dryrun`` forwards to the port's launcher (the name stays from
    when the parser rejected it): a reduced cell in a fake world of 256
    ranks exits 0 and writes its record, with ``jax`` and ``repro``
    blocked."""
    res = _cli("dryrun", "--arch", "gpt-2b", "--shape", "decode_32k",
               "--mesh", "single", "--reduced", "--out", str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[gpt-2b-smoke x decode_32k x single] OK" in res.stdout
    with open(tmp_path / "gpt-2b-smoke_decode_32k_single.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["memory"]["argument_bytes"] > 0


def test_stage_mesh_raises_without_a_process_group():
    """A stage's mesh needs the caller's process group; it never starts
    one itself."""
    import torch.distributed as dist

    from repro_torch.api import HarpConfig, compile
    from repro_torch.core.cluster import A100_40G, GBPS, HeteroCluster, SubCluster

    assert not dist.is_initialized()
    one_card = HeteroCluster(subclusters=(SubCluster(
        "meshA100x1", 1, 1, A100_40G, 300e9, 200 * GBPS),), cross_bw=5 * GBPS)
    exe = compile("granite-moe-1b-a400m", one_card,
                  HarpConfig(seq_len=1024, global_batch=8))
    with pytest.raises(RuntimeError, match="torch.distributed is not initialised"):
        exe.stage_mesh(0, device_type="cpu")
    assert not dist.is_initialized()


def test_no_package_module_imports_torch_testing_internals():
    """The fake process group is a test tool; the package never imports it."""
    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert "torch.testing" not in f.read(), name
