"""The port's HAPT planner (``repro_torch.core``) against the JAX package's
(``repro.core``), on the CPU: the same strategy JSON, with the ``time_*``
meta keys stripped, for full gpt-2b and mamba2-2.7b, inter-op and joint
search, with measured pricing off, enabled with an empty table, and priced
from a table that covers the A100 profile and an H100 sub-cluster.  The
off-state plan also equals the reference's golden pin.

Also a pin of a fault of the reference that the port copies verbatim:
``tests/test_h1f1b.py::test_h1f1b_never_worse_than_baselines`` draws
(S, seed) at random in every run, and at S = 5, seed = 46 (the one point
of its 404 that fails) H-1F1B's makespan is over 5 % above Eager-1F1B's,
so that test fails on some draws on any tree.
"""
import json
import os

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cluster as jax_cluster
from repro.core.planner import HAPTPlanner as JaxPlanner
from repro.core.planner import PlannerConfig as JaxPlannerConfig
from repro.kbench.bridge import KBenchConfig as JaxKBenchConfig
from repro_torch.configs import get_config
from repro_torch.core import cluster
from repro_torch.core.planner import HAPTPlanner, PlannerConfig
from repro_torch.kbench.bridge import KBenchConfig
from repro_torch.kbench.table import KernelMeasurement, LatencyTable

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "kbench_offstate_strategy.json")
H100_FP = "cuda:NVIDIA H100 80GB HBM3"
SEQ_LEN, GLOBAL_BATCH = 512, 16


def strip_times(strategy_json: str):
    d = json.loads(strategy_json)
    d["planner_meta"] = {k: v for k, v in d["planner_meta"].items()
                         if not k.startswith("time_")}
    return d


def _table_doc():
    """A100 at 45 % of its peak, the H100 fingerprint at 1 % of its own."""
    def meas(device, flops):
        return KernelMeasurement(
            device=device, op="flash_attention", shape=(2, 512, 512, 16, 16, 64),
            median_s=1e-3, trials=5, flops=flops, blocks=(32, 64),
            collected_at=1000.0, host="h1")
    return LatencyTable([meas("A100-40G", 0.45 * 1e-3 * 312e12),
                         meas(H100_FP, 0.01 * 1e-3 * 989e12)]).to_dict()


def _fleet(mod, with_h100):
    """``paper_case_study_cluster`` of package ``mod``, with a 1 x 2 H100
    mesh in front when asked; the H100 profile is built from each package's
    own ``DeviceProfile`` with the same values."""
    base = mod.paper_case_study_cluster()
    if not with_h100:
        return base
    dev = mod.DeviceProfile("H100-80G", 989e12, 80 * mod.GB, 3.35e12)
    h100 = mod.SubCluster("meshH100", 1, 2, dev, 450e9, 200 * mod.GBPS)
    return mod.HeteroCluster(subclusters=(h100,) + base.subclusters,
                             cross_bw=base.cross_bw)


def _kbench(kind, cfg_cls):
    if kind == "off":
        return None
    if kind == "empty":
        return cfg_cls()
    return cfg_cls(table=_table_doc(), device_map={"H100-80G": H100_FP})


def _plan(arch, kind, intra_op, with_h100, port):
    if port:
        pcfg = PlannerConfig(granularity=16, n_microbatches=16, intra_op=intra_op,
                             kbench=_kbench(kind, KBenchConfig))
        planner = HAPTPlanner(_fleet(cluster, with_h100), pcfg)
        arch_cfg = get_config(arch)
    else:
        pcfg = JaxPlannerConfig(granularity=16, n_microbatches=16,
                                intra_op=intra_op,
                                kbench=_kbench(kind, JaxKBenchConfig))
        planner = JaxPlanner(_fleet(jax_cluster, with_h100), pcfg)
        arch_cfg = jax_get_config(arch)
    strategy = planner.plan(arch_cfg, seq_len=SEQ_LEN, global_batch=GLOBAL_BATCH)
    return strip_times(strategy.to_json())


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ["gpt-2b", "mamba2-2.7b"])
@pytest.mark.parametrize("intra_op", [False, True])
@pytest.mark.parametrize("kind", ["off", "empty", "table"])
@pytest.mark.parametrize("with_h100", [False, True])
def test_strategy_equals_the_reference(arch, intra_op, kind, with_h100):
    ours = _plan(arch, kind, intra_op, with_h100, port=True)
    assert ours == _plan(arch, kind, intra_op, with_h100, port=False)
    stamp = ours["planner_meta"].get("kbench")
    if kind == "off":
        assert stamp is None
    elif kind == "empty":
        assert stamp["cells"] == 0
    else:
        covered = sorted([H100_FP, "A100-40G"])
        assert stamp["cells"] == 2 and stamp["covered_devices"] == covered


@pytest.mark.parametrize("intra_op,key", [(False, "inter"), (True, "joint")])
def test_offstate_plan_equals_the_golden_pin(golden, intra_op, key):
    assert _plan("gpt-2b", "off", intra_op, False, port=True) == golden[key]


@pytest.mark.parametrize("arch", ["gpt-2b", "mamba2-2.7b"])
def test_empty_table_prices_exactly_like_no_table(arch):
    off = _plan(arch, "off", False, True, port=True)
    empty = _plan(arch, "empty", False, True, port=True)
    empty["planner_meta"].pop("kbench")
    assert empty == off


def test_h100_table_moves_the_plan():
    """A measured anchor far under the default base_mfu prices the H100
    mesh as slower, so the plan changes."""
    off = _plan("gpt-2b", "off", False, True, port=True)
    measured = _plan("gpt-2b", "table", False, True, port=True)
    assert measured["est_step_time"] != off["est_step_time"]


def _h1f1b_makespans(h1f1b, pipesim, S, seed):
    """The body of ``tests/test_h1f1b.py:72-84`` with one package's
    ``h1f1b`` and ``pipesim``: the three schedules' counts and makespans."""
    import random
    rnd = random.Random(seed)
    t = [1.0] * S
    c = [rnd.uniform(0.0, 1.9) for _ in range(S - 1)]
    B, f, b = 48, [0.4] * S, [0.6] * S
    counts = {"h1f1b": h1f1b.h1f1b_counts(t, c, B),
              "classic": h1f1b.classic_1f1b_counts(S, B),
              "eager": h1f1b.eager_1f1b_counts(S, B)}
    return {k: (list(v), pipesim.simulate(f, b, c, B, v).makespan)
            for k, v in counts.items()}


def test_h1f1b_counterexample_of_the_reference_is_pinned():
    """At S = 5, seed = 46 the port's copy gives the reference's counts and
    makespans exactly, and H-1F1B is worse than Eager-1F1B by more than the
    5 % that test_h1f1b.py allows (104.95 against 98.88)."""
    from repro.core import h1f1b as jax_h1f1b, pipesim as jax_pipesim
    from repro_torch.core import h1f1b, pipesim

    ref = _h1f1b_makespans(jax_h1f1b, jax_pipesim, 5, 46)
    ours = _h1f1b_makespans(h1f1b, pipesim, 5, 46)
    assert ours == ref
    h, eager, classic = (ours[k][1] for k in ("h1f1b", "eager", "classic"))
    assert h <= classic * 1.001
    assert h > eager * 1.05
    assert abs(h - 104.95) < 0.01 and abs(eager - 98.88) < 0.01
