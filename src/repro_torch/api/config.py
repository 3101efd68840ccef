"""HarpConfig: the one config object the compile pipeline reads.

Unifies the per-subsystem configs that callers previously wired by hand —
``PlannerConfig`` (search), ``TrainerConfig`` (execution loop), ``DataConfig``
(input pipeline, optional: derived from the arch when absent) and
``ControllerConfig`` (elastic runtime, optional) — plus the workload shape
(``seq_len``/``global_batch``, token/sample counts) and the *names* of
pluggable components (``scheduler``/``cost_model``, resolved through
:mod:`repro_torch.api.registry`).

``validate()`` is called by the facade before planning; ``to_json`` /
``from_json`` round-trip everything except ``planner.measure_fn`` (a
callable — plans built for on-hardware profiling cannot be shipped as JSON,
so serializing one raises).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.chaos.inject import ChaosConfig
from repro_torch.comm.selector import CommConfig
from repro_torch.core.costmodel import CostModelConfig
from repro_torch.kbench.bridge import KBenchConfig
from repro_torch.obs import ObsConfig
from repro_torch.core.dp_search import SearchConfig
from repro_torch.core.planner import PlannerConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.serving.placement import ServingConfig
from repro_torch.train.trainer import TrainerConfig

from repro_torch.api import registry


@dataclass
class HarpConfig:
    """Everything ``api.compile`` reads.  Units: ``seq_len`` is tokens per
    sample, ``global_batch`` is samples per step; all times priced downstream
    are seconds."""
    seq_len: int = 1024
    global_batch: int = 1024
    scheduler: str = "h1f1b"          # registry: warm-up-count policy
    cost_model: str = "analytic"      # registry: CostModelConfig factory
    # (intra-op collective overlap lives in planner.search.intra_overlap —
    # the search's final pipesim validation reads it there)
    planner: PlannerConfig = field(default_factory=PlannerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    data: Optional[DataConfig] = None       # None -> derived from the arch
    elastic: Optional[ControllerConfig] = None  # None -> derived on attach
    serving: Optional[ServingConfig] = None  # None -> training-only plan
    # (the off-state invariant: serving=None leaves every training artifact
    # bit-identical to the pre-serving schema — see DESIGN.md §7)
    kbench: Optional[KBenchConfig] = None  # None -> analytic pricing
    # (convenience alias for planner.kbench; same off-state invariant —
    # kbench=None plans are bit-identical to pre-kbench plans, DESIGN.md §9)
    chaos: Optional[ChaosConfig] = None  # None -> no fault injection
    # (off-state invariant: chaos=None — and all-zero probabilities — leave
    # controller decisions and artifacts bit-identical to schema v6,
    # DESIGN.md §10)
    obs: Optional[ObsConfig] = None  # None -> no tracing/drift accounting
    # (off-state invariant: obs=None leaves every artifact bit-identical to
    # schema v7 apart from the version bump + this null key, DESIGN.md §11;
    # even obs=ObsConfig() never changes planning or runtime decisions —
    # observability only records)

    def __post_init__(self):
        # the top-level kbench knob materializes into the planner config;
        # disagreement between the two is caught by validate()
        if self.kbench is not None and self.planner.kbench is None:
            self.planner = dataclasses.replace(self.planner,
                                               kbench=self.kbench)
        # the named cost model materializes into the planner config unless
        # the caller already customized it away from the default; unknown
        # names are left for validate() to report (uniform ValueError path)
        if self.cost_model != "analytic" \
                and self.cost_model in registry.available("cost_model") \
                and self.planner.cost == CostModelConfig():
            self.planner = dataclasses.replace(
                self.planner, cost=registry.resolve(
                    "cost_model", self.cost_model)())
        # ergonomics: a planner left at the DEFAULT microbatch count follows
        # the workload (`HarpConfig(global_batch=64)` just works — B=64, one
        # sample per microbatch); an explicitly-set count is the caller's
        # contract and validate() enforces divisibility strictly
        if self.planner.n_microbatches == PlannerConfig().n_microbatches \
                and self.global_batch > 0 \
                and self.global_batch % self.planner.n_microbatches != 0:
            self.planner = dataclasses.replace(
                self.planner, n_microbatches=self.global_batch)

    # -- validation ----------------------------------------------------------

    def validate(self) -> "HarpConfig":
        """Raise ``ValueError`` on inconsistent knobs; returns self so the
        facade can chain ``cfg.validate()``."""
        errs = []
        if self.seq_len <= 0:
            errs.append(f"seq_len must be positive, got {self.seq_len}")
        if self.global_batch <= 0:
            errs.append(f"global_batch must be positive, "
                        f"got {self.global_batch}")
        p = self.planner
        if not 0.0 <= p.search.intra_overlap <= 1.0:
            errs.append(f"planner.search.intra_overlap must be in [0, 1], "
                        f"got {p.search.intra_overlap}")
        if self.global_batch % p.n_microbatches != 0:
            errs.append(
                f"global_batch ({self.global_batch}) must be a multiple of "
                f"planner.n_microbatches ({p.n_microbatches}) — otherwise "
                f"the per-microbatch sample apportionment drops samples")
        if p.granularity <= 0:
            errs.append(f"planner.granularity must be positive, "
                        f"got {p.granularity}")
        if p.n_microbatches <= 0:
            errs.append(f"planner.n_microbatches must be positive, "
                        f"got {p.n_microbatches}")
        if p.rho <= 1.0:
            errs.append(f"planner.rho must exceed 1 (imbalance-pruning "
                        f"ratio), got {p.rho}")
        if self.trainer.total_steps <= 0:
            errs.append(f"trainer.total_steps must be positive, "
                        f"got {self.trainer.total_steps}")
        for kind, name in (("scheduler", self.scheduler),
                           ("cost_model", self.cost_model)):
            if name not in registry.available(kind):
                errs.append(f"unknown {kind} {name!r}; available: "
                            f"{registry.available(kind)}")
        if self.kbench is not None and self.planner.kbench is not None \
                and self.kbench != self.planner.kbench:
            errs.append("kbench and planner.kbench disagree — set one "
                        "(the top-level knob materializes into the planner)")
        if self.data is not None and self.data.seq_len != self.seq_len:
            errs.append(f"data.seq_len ({self.data.seq_len}) disagrees with "
                        f"seq_len ({self.seq_len})")
        if self.serving is not None:
            errs.extend(self.serving.validate_errors())
        e = self.elastic
        if e is not None:
            de = ControllerConfig()
            # class-default workload fields count as "unset" (attach_elastic
            # backfills them from this config); explicit disagreement is an
            # error — the controller would replan a different workload
            if e.seq_len not in (de.seq_len, self.seq_len):
                errs.append(f"elastic.seq_len ({e.seq_len}) disagrees with "
                            f"seq_len ({self.seq_len})")
            if e.global_batch not in (de.global_batch, self.global_batch):
                errs.append(f"elastic.global_batch ({e.global_batch}) "
                            f"disagrees with global_batch "
                            f"({self.global_batch})")
        if errs:
            raise ValueError("invalid HarpConfig: " + "; ".join(errs))
        return self

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        if self.planner.measure_fn is not None:
            raise ValueError(
                "HarpConfig with planner.measure_fn (a callable) cannot be "
                "serialized — on-hardware-profiled plans are machine-bound")
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "HarpConfig":
        d = dict(d)
        pd = dict(d.pop("planner"))
        pd.pop("measure_fn", None)
        comm = pd.pop("comm", None)
        # absent key: a pre-v6 artifact — still loads
        pkb = pd.pop("kbench", None)
        planner = PlannerConfig(
            cost=CostModelConfig(**pd.pop("cost")),
            search=SearchConfig(**pd.pop("search")),
            comm=None if comm is None else CommConfig(**comm),
            kbench=None if pkb is None else KBenchConfig.from_dict(pkb), **pd)
        trainer = TrainerConfig(**d.pop("trainer"))
        data = d.pop("data", None)
        elastic = d.pop("elastic", None)
        # absent key: a pre-v4 (training-only) artifact — still loads
        serving = d.pop("serving", None)
        kbench = d.pop("kbench", None)
        # absent key: a pre-v7 artifact — still loads
        chaos = d.pop("chaos", None)
        # absent key: a pre-v8 artifact — still loads
        obs = d.pop("obs", None)
        return HarpConfig(
            planner=planner, trainer=trainer,
            data=None if data is None else DataConfig(**data),
            elastic=None if elastic is None else ControllerConfig(**elastic),
            serving=None if serving is None else ServingConfig(**serving),
            kbench=None if kbench is None else KBenchConfig.from_dict(kbench),
            chaos=None if chaos is None else ChaosConfig.from_dict(chaos),
            obs=None if obs is None else ObsConfig.from_dict(obs),
            **d)

    @staticmethod
    def from_json(s: str) -> "HarpConfig":
        return HarpConfig.from_dict(json.loads(s))
