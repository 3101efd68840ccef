"""The port's facade: ``fit``, the training half of the pipeline, and
``generate``, the serving half.

Counterpart of ``repro/api/facade.py:fit`` and ``:generate``, dense and SSM
families.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.api.config import HarpConfig
from repro_torch.configs import ArchConfig, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models.prefill import prefill
from repro_torch.serve.step import (
    greedy_tokens, gumbel_noise, make_serve_step, sample_tokens,
)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer


def _resolve_arch(arch: Union[str, ArchConfig]) -> ArchConfig:
    return get_config(arch) if isinstance(arch, str) else arch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(arch: Union[str, ArchConfig],
        config: Optional[HarpConfig] = None, *,
        train_step: Optional[Callable] = None,
        state: Optional[Dict[str, Any]] = None,
        data_cfg: Optional[DataConfig] = None,
        optimizer: Optional[OptimizerConfig] = None,
        n_microbatches: int = 1,
        on_step_time: Optional[Callable] = None,
        on_straggler: Optional[Callable] = None,
        log_fn: Callable = print,
        clock: Optional[Callable[[], float]] = None,
        start_step: Optional[int] = None,
        seed: int = 0,
        device: DeviceLike = None,
        params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Config -> model -> AdamW -> the fault-tolerant :class:`Trainer` loop.

    Runs on ``cuda`` unless ``device="cpu"``, with the port's kernels on
    (flash attention for the dense family, the SSD intra-chunk kernel for
    the SSM family).
    Pass ``train_step`` + ``state`` to run a custom step function; otherwise
    the arch's model is built, its params drawn from a generator seeded by
    ``seed`` (or taken from ``params``, a dict of tensors on the device), and
    AdamW with ``warmup_steps=min(20, total_steps)``.  ``config.data`` (or a
    ``DataConfig`` derived from the arch) feeds the deterministic synthetic
    pipeline.  Returns ``{"final_step", "history", "state"}``; the state is
    updated in place, step by step."""
    cfg = config if config is not None else HarpConfig()
    arch_cfg = _resolve_arch(arch)
    if train_step is None:
        opt_cfg = optimizer or OptimizerConfig(
            warmup_steps=min(20, cfg.trainer.total_steps),
            total_steps=cfg.trainer.total_steps)
        step_fn, model, opt_init = make_train_step(
            arch_cfg, opt_cfg, n_microbatches=n_microbatches,
            device=resolve_device(device))
        if params is None:
            params = model.init(generator(model.device, seed))
        state = {"params": params, "opt_state": opt_init(params)}
    else:
        if state is None:
            raise TypeError("fit(train_step=...) also needs state=...")
        step_fn = train_step
    data = data_cfg or cfg.data or DataConfig(
        vocab_size=arch_cfg.vocab_size, seq_len=cfg.seq_len,
        global_batch=cfg.global_batch, seed=seed)
    trainer = Trainer(cfg.trainer, data, step_fn, state,
                      on_straggler=on_straggler, on_step_time=on_step_time,
                      log_fn=log_fn,
                      clock=clock if clock is not None else time.perf_counter)
    return trainer.run(start_step)


def generate(arch: Union[str, ArchConfig], *,
             batch: int = 4, prompt_len: int = 32, gen_tokens: int = 32,
             seed: int = 0, greedy: bool = True, temperature: float = 1.0,
             use_kernels: bool = True, reduced: bool = False,
             log_fn: Optional[Callable] = None, device: DeviceLike = None,
             params: Optional[Dict[str, Any]] = None,
             prompt: Optional[Any] = None) -> Dict[str, Any]:
    """Prefill a prompt batch, then batched greedy or temperature decode.

    Runs on ``cuda`` unless ``device="cpu"``.  Params come from the port's
    own init with a generator seeded by ``seed``, unless ``params`` is given
    (a dict of tensors on the device, e.g. from ``convert.params_from_jax``);
    the prompt is drawn from the same generator unless ``prompt`` (B, P)
    integer tokens are given.  The dense family's KV cache is bfloat16, as in
    the reference; the SSM family's decode state is float32 and does not
    grow with the sequence (``pos`` is unused by its decode step).

    Returns ``{"tokens": (B, gen_tokens) int array, "prefill_s",
    "decode_s", "decode_tokens_per_s"}``.  The first generated token comes
    from the prefill logits."""
    cfg = _resolve_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    serve_step, model = make_serve_step(
        cfg, use_kernels=use_kernels, greedy=greedy, temperature=temperature,
        device=dev)
    gen = generator(dev, seed)
    if params is None:
        params = model.init(gen)
    if prompt is None:
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen, device=dev)
    else:
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=dev)
        batch, prompt_len = tokens.shape
    total = prompt_len + gen_tokens

    _sync(dev)
    t0 = time.perf_counter()
    last_logits, cache = prefill(cfg, params, {"tokens": tokens},
                                 cache_len=total, use_kernels=use_kernels)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    if log_fn:
        log_fn(f"[serve] prefill {batch}x{prompt_len} ({cfg.arch_id}): "
               f"{prefill_s * 1e3:.0f} ms")

    if greedy:
        tok = greedy_tokens(last_logits)
    else:
        tok = sample_tokens(last_logits[:, -1], temperature,
                            gumbel_noise(last_logits[:, -1].shape, gen))
    toks = [tok]
    t0 = time.perf_counter()
    # the prefill logits supplied token 1; decode the remaining gen_tokens-1
    for t in range(prompt_len, prompt_len + gen_tokens - 1):
        if greedy:
            tok, cache = serve_step(params, cache, tok, t)
        else:
            tok, cache = serve_step(params, cache, tok, t, gen)
        toks.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    n_decoded = batch * (gen_tokens - 1)
    tps = n_decoded / decode_s if decode_s > 0 else 0.0
    if log_fn:
        log_fn(f"[serve] {gen_tokens} tokens x {batch} seqs in "
               f"{decode_s * 1e3:.0f} ms ({tps:.0f} tok/s "
               f"{'greedy' if greedy else f'T={temperature}'})")
    return {"tokens": torch.cat(toks, dim=1).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tokens_per_s": tps}
