"""Training loop with production fault-tolerance semantics.

Counterpart of ``repro/train/trainer.py``: the same loop, hooks and
checkpoint protocol.  A step is timed up to ``torch.cuda.synchronize`` of
the state's device (the reference's ``jax.block_until_ready``); checkpoints
snapshot the state to host numpy arrays (``convert.to_numpy``), and resume
copies the restored arrays into the live state's tensors in place.

- auto-resume from the newest checkpoint (params + optimizer + data cursor);
- atomic periodic checkpoints (``checkpoint/ckpt.py``);
- straggler watch: per-step wall times feed an EWMA; a sustained skew beyond
  ``replan_threshold`` triggers the ``on_straggler`` hook (on a real cluster:
  update the slow pod's ``DeviceProfile.efficiency`` and re-run the HAPT
  planner — heterogeneity-aware planning doubles as failure adaptation);
- per-step telemetry: every measured step time flows to ``on_step_time`` —
  ``runtime.ElasticController.trainer_hooks()`` provides both hooks, closing
  the loop: telemetry -> EWMA calibration -> amortized replanning;
- preemption-safe: SIGTERM finishes the current step, checkpoints, exits.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.convert import copy_into
from repro_torch.data.pipeline import DataConfig, make_batch


@dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    replan_threshold: float = 1.5   # step time vs EWMA ratio
    ewma_alpha: float = 0.1
    async_ckpt: bool = False        # hand writes to a background thread
    incremental_ckpt: bool = False  # write only leaves changed since last save


def _sync(tree) -> None:
    """Wait for the device that holds the first tensor of ``tree``."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    if isinstance(tree, torch.Tensor) and tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)


class Trainer:
    def __init__(self, cfg: TrainerConfig, data_cfg: DataConfig,
                 train_step: Callable, state: Dict[str, Any],
                 on_straggler: Optional[Callable] = None,
                 on_step_time: Optional[Callable] = None,
                 log_fn: Callable = print,
                 clock: Callable[[], float] = time.perf_counter):
        """``state``: dict of pytrees passed through train_step in order;
        train_step(*state_values, batch) -> (*new_state_values, metrics).
        ``on_step_time(step, dt)`` receives every measured step wall time
        (telemetry feed for the elastic controller); ``on_straggler(step, dt,
        ewma)`` fires only on sustained skew."""
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.train_step = train_step
        self.state = state
        # pin positional arg order NOW, as the reference does
        self._keys = list(state.keys())
        self.on_straggler = on_straggler
        self.on_step_time = on_step_time
        self.log = log_fn
        self.clock = clock
        self._stop = False
        self._ewma = None
        self._ckptr: Optional[ckpt_lib.AsyncCheckpointer] = None
        if cfg.async_ckpt or cfg.incremental_ckpt:
            self._ckptr = ckpt_lib.AsyncCheckpointer(
                cfg.ckpt_dir, keep=cfg.keep_ckpts,
                incremental=cfg.incremental_ckpt,
                background=cfg.async_ckpt)

    def _install_sigterm(self):
        """Install the SIGTERM handler; returns a function that puts the
        previous one back.  (The handler closes over the trainer, and so
        over the whole state on the card: left installed, it would keep
        that memory alive after ``run`` returns.)"""
        def handler(signum, frame):
            self._stop = True
        try:
            prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return lambda: None  # not main thread
        return lambda: signal.signal(
            signal.SIGTERM, signal.SIG_DFL if prev is None else prev)

    def resume(self) -> int:
        restored = ckpt_lib.restore(self.cfg.ckpt_dir, self.state)
        if restored is None:
            return 0
        step, tree, extra = restored
        copy_into(self.state, tree)
        self.log(f"[trainer] resumed from step {step}")
        return step

    def checkpoint(self, step: int):
        host_state = self.state       # ckpt_lib snapshots leaves to host numpy
        extra = {"data_seed": self.data_cfg.seed}
        if self._ckptr is not None:
            self._ckptr.save(step, host_state, extra=extra)
        else:
            ckpt_lib.save(self.cfg.ckpt_dir, step, host_state,
                          extra=extra, keep=self.cfg.keep_ckpts)

    def run(self, start_step: Optional[int] = None) -> Dict[str, Any]:
        restore_sigterm = self._install_sigterm()
        try:
            return self._run(start_step)
        finally:
            restore_sigterm()

    def _run(self, start_step: Optional[int]) -> Dict[str, Any]:
        step = self.resume() if start_step is None else start_step
        history = []
        keys = self._keys
        while step < self.cfg.total_steps and not self._stop:
            batch = make_batch(self.data_cfg, step)
            t0 = self.clock()
            out = self.train_step(*[self.state[k] for k in keys], batch)
            *new_vals, metrics = out
            _sync(new_vals[0])
            dt = self.clock() - t0
            self.state = dict(zip(keys, new_vals))
            step += 1

            if self.on_step_time is not None:
                self.on_step_time(step, dt)

            # straggler watch (EWMA seeded from the 2nd step — the 1st pays
            # jit compilation and would mask every later straggler)
            if self._ewma is None:
                self._ewma = dt
            elif step == 2:
                self._ewma = dt
            else:
                if dt > self.cfg.replan_threshold * self._ewma \
                        and self.on_straggler is not None:
                    self.on_straggler(step, dt, self._ewma)
                a = self.cfg.ewma_alpha
                self._ewma = (1 - a) * self._ewma + a * dt

            if step % self.cfg.log_every == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, "time_s": dt, **m})
                self.log(f"[step {step:5d}] "
                         + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                         + f" ({dt*1e3:.0f} ms)")
            if step % self.cfg.ckpt_every == 0:
                self.checkpoint(step)
        if self._stop:
            self.log("[trainer] SIGTERM — checkpointing and exiting")
            self.checkpoint(step)
        if self._ckptr is not None:
            self._ckptr.close()      # all queued writes durable before exit
        return {"final_step": step, "history": history, "state": self.state}
