"""HarpConfig, partial: the workload and execution-loop fields only.

Counterpart of ``repro/api/config.py:HarpConfig`` for what ``fit`` reads:
``seq_len``, ``global_batch``, ``data`` and ``trainer``, with the
reference's defaults and its validation messages for those fields.  The
planner, chaos, comm, kbench, obs, serving and elastic fields come with the
control-plane slice (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import TrainerConfig


@dataclass
class HarpConfig:
    """Units: ``seq_len`` is tokens per sample, ``global_batch`` is samples
    per step."""
    seq_len: int = 1024
    global_batch: int = 1024
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    data: Optional[DataConfig] = None       # None -> derived from the arch

    def validate(self) -> "HarpConfig":
        """Raise ``ValueError`` on inconsistent knobs; returns self."""
        errs = []
        if self.seq_len <= 0:
            errs.append(f"seq_len must be positive, got {self.seq_len}")
        if self.global_batch <= 0:
            errs.append(f"global_batch must be positive, "
                        f"got {self.global_batch}")
        if self.trainer.total_steps <= 0:
            errs.append(f"trainer.total_steps must be positive, "
                        f"got {self.trainer.total_steps}")
        if self.data is not None and self.data.seq_len != self.seq_len:
            errs.append(f"data.seq_len ({self.data.seq_len}) disagrees with "
                        f"seq_len ({self.seq_len})")
        if errs:
            raise ValueError("invalid HarpConfig: " + "; ".join(errs))
        return self
