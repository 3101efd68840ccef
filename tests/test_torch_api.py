"""The port's compile pipeline (``repro_torch.api``) against the reference's
(``repro.api``), on the CPU: ``plan`` and ``lower`` give byte-identical JSON
for full gpt-2b and mamba2-2.7b on the paper's case-study cluster and on an
H100 fleet (an H100 1 x 2 mesh in front of it), inter-op and joint search,
analytic and priced from a small kbench table; a Plan written by either
package loads in the other and re-serializes byte-identically; an
Executable compiled from the artifact inspects and simulates alike; the
three golden schema files are reproduced; the full ``HarpConfig`` validates,
backfills and round-trips as the reference's does; and the quickstart flow
runs through the port.

The planner's ``time_*`` meta keys are wall-clock seconds of the search:
they are stripped before two fresh plans are compared, and kept when one
plan's JSON is re-serialized.
"""
import dataclasses
import json
import os

import pytest

from repro import api as R
from repro.core import cluster as rcl
from repro.core.planner import PlannerConfig as RPlannerConfig
from repro_torch import api as T
from repro_torch.core import cluster as tcl
from repro_torch.core.planner import PlannerConfig as TPlannerConfig
from repro_torch.kbench.table import KernelMeasurement, LatencyTable

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
H100_FP = "cuda:NVIDIA H100 80GB HBM3"
ARCHS = ["gpt-2b", "mamba2-2.7b"]
CASES = [(arch, fleet, pricing, intra)
         for arch in ARCHS for fleet in ("paper", "h100")
         for pricing in ("analytic", "kbench") for intra in (False, True)]
IDS = ["-".join([a, f, p, "joint" if i else "inter"]) for a, f, p, i in CASES]


def fleet_of(mod, name):
    """The paper's case-study cluster of package ``mod``, with a 1 x 2 H100
    mesh in front for ``"h100"`` (each package's own DeviceProfile)."""
    base = mod.paper_case_study_cluster()
    if name == "paper":
        return base
    dev = mod.DeviceProfile("H100-80G", 989e12, 80 * mod.GB, 3.35e12)
    h100 = mod.SubCluster("meshH100", 1, 2, dev, 450e9, 200 * mod.GBPS)
    return mod.HeteroCluster(subclusters=(h100,) + base.subclusters,
                             cross_bw=base.cross_bw)


def table_doc():
    """A100 at 45 % of its peak, the H100 fingerprint at 30 % of its own."""
    def meas(device, flops):
        return KernelMeasurement(
            device=device, op="flash_attention",
            shape=(2, 512, 512, 16, 16, 64), median_s=1e-3, trials=5,
            flops=flops, blocks=(32, 64), collected_at=1000.0, host="h1")
    return LatencyTable([meas("A100-40G", 0.45 * 1e-3 * 312e12),
                         meas(H100_FP, 0.30 * 1e-3 * 989e12)]).to_dict()


def harp_config(api, planner_cls, pricing, intra, **kw):
    kb = None
    if pricing == "kbench":
        kb = api.KBenchConfig(table=table_doc(),
                              device_map={"H100-80G": H100_FP})
    return api.HarpConfig(
        seq_len=1024, global_batch=16, kbench=kb,
        planner=planner_cls(granularity=16, n_microbatches=16,
                            intra_op=intra), **kw)


def strip_times(plan_json: str) -> str:
    d = json.loads(plan_json)
    meta = d["strategy"]["planner_meta"]
    d["strategy"]["planner_meta"] = {k: v for k, v in meta.items()
                                     if not k.startswith("time_")}
    return json.dumps(d, indent=2)


@pytest.fixture(scope="module")
def plans():
    """case -> (reference Plan, port Plan), each searched once."""
    out = {}
    for arch, fleet, pricing, intra in CASES:
        ref = R.plan(arch, fleet_of(rcl, fleet),
                     harp_config(R, RPlannerConfig, pricing, intra))
        port = T.plan(arch, fleet_of(tcl, fleet),
                      harp_config(T, TPlannerConfig, pricing, intra))
        out[(arch, fleet, pricing, intra)] = (ref, port)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_and_lowered_json_are_byte_identical(plans, case):
    ref, port = plans[case]
    assert strip_times(port.to_json()) == strip_times(ref.to_json())
    assert T.lower(port).to_json() == R.lower(ref).to_json()
    if case[2] == "kbench":
        stamp = port.strategy.planner_meta["kbench"]
        assert stamp["covered_devices"] == sorted(["A100-40G", H100_FP])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_json_crosses_between_packages(plans, case):
    ref, port = plans[case]
    j_ref, j_port = ref.to_json(), port.to_json()
    assert T.Plan.from_json(j_ref).to_json() == j_ref
    assert R.Plan.from_json(j_port).to_json() == j_port
    assert T.lower(T.Plan.from_json(j_ref)).to_json() \
        == R.lower(ref).to_json()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compiled_artifact_inspects_and_simulates_alike(plans, case):
    ref, _ = plans[case]
    j = ref.to_json()
    er = R.compile(plan_artifact=R.Plan.from_json(j))
    et = T.compile(plan_artifact=T.Plan.from_json(j))
    assert et.plan.to_json() == j
    assert et.lowered.to_json() == er.lowered.to_json()
    assert et.describe() == er.describe()
    assert et.describe(comm=True) == er.describe(comm=True)
    assert et.explain_comm() == er.explain_comm()
    assert et.explain_costs() == er.explain_costs()
    for priced in (True, False):
        a, b = et.simulate(priced=priced), er.simulate(priced=priced)
        assert a.makespan == b.makespan
        assert a.overlap_ratio == b.overlap_ratio
        assert et.throughput(priced=priced) == er.throughput(priced=priced)
    assert [layer.param_bytes for layer in et.layers] \
        == [layer.param_bytes for layer in er.layers]


def test_compile_warns_on_a_different_fleet(plans):
    _, port = plans[("gpt-2b", "paper", "analytic", False)]
    with pytest.warns(UserWarning, match="fingerprint"):
        T.compile(plan_artifact=port,
                  cluster=tcl.paper_case_study_cluster(cross_gbps=10.0))
    with pytest.raises(TypeError, match="arch, cluster"):
        T.compile("gpt-2b")


# ---------------------------------------------------------------------------
# Golden schemas, read the way the reference's tests read them
# ---------------------------------------------------------------------------


def _schema(obj):
    """Key-tree + JSON-type skeleton (tests/test_api.py's)."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_schema(obj[0])] if obj else []
    if isinstance(obj, bool):
        return "bool"
    if isinstance(obj, int):
        return "int"
    if isinstance(obj, float):
        return "float"
    if isinstance(obj, str):
        return "str"
    assert obj is None, f"unexpected JSON type {type(obj)}"
    return "null"


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _small_cfg(api, planner_cls, **kw):
    """tests/test_api.py's and tests/test_obs.py's ``small_cfg``."""
    return api.HarpConfig(
        seq_len=512, global_batch=16,
        planner=planner_cls(granularity=16, n_microbatches=16), **kw)


@pytest.fixture(scope="module")
def exe_case():
    return T.compile("gpt-2b", tcl.paper_case_study_cluster(),
                     _small_cfg(T, TPlannerConfig))


def test_artifact_schema_matches_golden(exe_case):
    got = {"plan": _schema(exe_case.plan.to_dict()),
           "lowered": _schema(exe_case.lowered.to_dict())}
    assert got == _golden("api_artifact_schema.json")


def test_serve_plan_schema_matches_golden():
    """tests/test_serving.py's fig10 case: gemma-2b on 2 x 8 A100 + 2 x 8
    V100, and the same ServePlan as the reference's search."""
    from repro.serving.placement import search_placement as r_search
    from repro_torch.configs import get_config
    from repro_torch.serving.placement import ServingConfig, search_placement
    from repro_torch.serving.workload import poisson_trace

    kw = dict(qps=1600.0, duration_s=1.0, prompt_mean=256, output_mean=64,
              search_sample=400)
    scfg = ServingConfig(**kw)
    trace = poisson_trace(scfg.qps, scfg.duration_s, seed=scfg.seed,
                          prompt_mean=scfg.prompt_mean,
                          output_mean=scfg.output_mean)
    best = search_placement(
        get_config("gemma-2b"),
        tcl.paper_eval_cluster(n_a100_nodes=2, n_v100_nodes=2), scfg,
        trace=trace)
    assert _schema(best.to_dict()) == _golden("serve_plan_schema.json")

    from repro.configs import get_config as r_get_config
    from repro.serving.placement import ServingConfig as RServingConfig
    from repro.serving.workload import poisson_trace as r_poisson
    rcfg = RServingConfig(**kw)
    ref = r_search(r_get_config("gemma-2b"),
                   rcl.paper_eval_cluster(n_a100_nodes=2, n_v100_nodes=2),
                   rcfg, trace=r_poisson(rcfg.qps, rcfg.duration_s,
                                         seed=rcfg.seed,
                                         prompt_mean=rcfg.prompt_mean,
                                         output_mean=rcfg.output_mean))
    assert json.dumps(best.to_dict()) == json.dumps(ref.to_dict())


def _chrome_shape(doc):
    """tests/test_obs.py's structural digest."""
    shapes = {}
    for ev in doc["traceEvents"]:
        shapes.setdefault(ev["ph"], sorted(ev.keys()))
    return {"top": sorted(doc.keys()),
            "otherData": sorted(doc["otherData"].keys()),
            "schema": doc["otherData"]["schema"],
            "event_shapes": {k: shapes[k] for k in sorted(shapes)}}


def test_chrome_schema_matches_golden(exe_case):
    tr = exe_case.trace(contention=True)
    tr.add_span("x", "rel", "release", "drain", 0.0, 1.0,
                flow_id=0, flow_start=True)
    tr.add_span("x", "mig", "flow", "migration", 1.0, 1.0,
                flow_id=0, flow_end=True)
    assert _chrome_shape(tr.to_chrome()) == _golden("obs_trace_schema.json")


# ---------------------------------------------------------------------------
# The full HarpConfig
# ---------------------------------------------------------------------------


def _bad_configs(api, planner_cls, ctrl_cls):
    """Each inconsistent knob the reference's validate() reports."""
    return [
        dict(seq_len=0),
        dict(global_batch=-4),
        dict(global_batch=10, planner=planner_cls(n_microbatches=4)),
        dict(planner=planner_cls(granularity=0)),
        dict(planner=planner_cls(rho=1.0)),
        dict(scheduler="nope"),
        dict(cost_model="nope"),
        dict(elastic=ctrl_cls(seq_len=77)),
        dict(elastic=ctrl_cls(global_batch=3)),
        dict(kbench=api.KBenchConfig(table_path="a.json"),
             planner=planner_cls(kbench=api.KBenchConfig(table_path="b.json"))),
    ]


@pytest.mark.parametrize("i", range(10))
def test_harp_config_validate_messages_match(i):
    from repro.runtime.controller import ControllerConfig as RCtrl
    from repro_torch.runtime.controller import ControllerConfig as TCtrl

    def message(api, planner_cls, ctrl_cls):
        kw = _bad_configs(api, planner_cls, ctrl_cls)[i]
        with pytest.raises(ValueError) as err:
            api.HarpConfig(**kw).validate()
        return str(err.value)

    assert message(T, TPlannerConfig, TCtrl) \
        == message(R, RPlannerConfig, RCtrl)


def test_harp_config_backfill_and_json_round_trip():
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.placement import ServingConfig

    # the default microbatch count follows the workload; an explicit one
    # does not
    assert T.HarpConfig(global_batch=64).planner.n_microbatches \
        == R.HarpConfig(global_batch=64).planner.n_microbatches == 64
    assert T.HarpConfig(global_batch=64, planner=TPlannerConfig(
        n_microbatches=32)).planner.n_microbatches == 32
    cfg = T.HarpConfig(
        seq_len=256, global_batch=8, cost_model="analytic",
        kbench=T.KBenchConfig(table=table_doc(),
                              device_map={"H100-80G": H100_FP}),
        data=DataConfig(vocab_size=512, seq_len=256, global_batch=8),
        serving=ServingConfig(qps=10.0), obs=ObsConfig(run_log="x.jsonl"),
        chaos=T.ChaosConfig(seed=3, p_planner_timeout=0.1))
    assert cfg.planner.kbench == cfg.kbench
    j = cfg.to_json()
    assert T.HarpConfig.from_json(j).to_json() == j
    assert R.HarpConfig.from_json(j).to_json() == j
    assert R.HarpConfig(global_batch=8, seq_len=256).to_json() \
        == T.HarpConfig(global_batch=8, seq_len=256).to_json()
    with pytest.raises(ValueError, match="measure_fn"):
        dataclasses.replace(cfg, planner=dataclasses.replace(
            cfg.planner, measure_fn=lambda *a: 0.0)).to_json()


def test_quickstart_flow_runs_through_the_port(tmp_path):
    """examples/quickstart.py, step for step, through repro_torch.api."""
    from repro_torch.core import ascii_timeline

    cluster = tcl.paper_case_study_cluster(cross_gbps=5.0)
    cfg = T.HarpConfig(seq_len=1024, global_batch=64,
                       planner=TPlannerConfig(granularity=64,
                                              n_microbatches=32))
    exe = T.compile("gpt-2b", cluster, cfg)
    assert "stage" in exe.describe()
    res = exe.simulate()
    assert res.makespan > 0 and 0.0 <= res.overlap_ratio <= 1.0
    assert ascii_timeline(exe.simulate(priced=False), width=96)
    path = tmp_path / "hapt_plan.json"
    path.write_text(exe.plan.to_json())
    reloaded = T.compile(plan_artifact=T.Plan.from_json(path.read_text()))
    assert reloaded.plan.to_json() == exe.plan.to_json()
    ref = R.compile("gpt-2b", rcl.paper_case_study_cluster(cross_gbps=5.0),
                    R.HarpConfig(seq_len=1024, global_batch=64,
                                 planner=RPlannerConfig(granularity=64,
                                                        n_microbatches=32)))
    assert strip_times(exe.plan.to_json()) == strip_times(ref.plan.to_json())
    assert res.makespan == ref.simulate().makespan
