"""The port's control plane against the reference's, on the CPU, on the same
seeded inputs: fleet-dynamics replay (paper, random and chaos traces,
elastic and static), the hardened controller under seeded fault storms, plan
migration (layout diff, the host executor's bit identity, pricing, and
``Executable.migrate_to``), the serving simulator, the Chrome-trace export,
and the checkpoint's obs counters.

The controller charges its plan searches on ``time.perf_counter``; both
packages' controller modules get the same fake clock (one millisecond per
read), and both pipesim memos start empty (``torch_control_parity.py``), so
every decision, downtime and replay wall clock is deterministic and
compared exactly.
"""
import dataclasses
import importlib
import json
import os
import types

import numpy as np
import pytest

from torch_control_parity import cold_sim_memo, fake_clock  # noqa: F401

PKG = {"ref": "repro", "port": "repro_torch"}
SIDES = ("ref", "port")


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def small_exe(side, **kw):
    """tests/test_obs.py's ``small_cfg`` compile on the case-study fleet."""
    api = mod(side, "api")
    pc = mod(side, "core.planner").PlannerConfig
    cfg = api.HarpConfig(seq_len=512, global_batch=16,
                         planner=pc(granularity=16, n_microbatches=16), **kw)
    cluster = mod(side, "core.cluster").paper_case_study_cluster()
    return api.compile("gpt-2b", cluster, cfg)


def strip_times(strategy_json):
    """A strategy without the planner's wall-clock ``time_*`` meta keys."""
    d = json.loads(strategy_json)
    d["planner_meta"] = {k: v for k, v in d["planner_meta"].items()
                         if not k.startswith("time_")}
    return d


def decision_dicts(decisions):
    return [dataclasses.asdict(d) for d in decisions]


def replay_digest(res):
    return {"samples": [dataclasses.asdict(s) for s in res.samples],
            "tokens_total": res.tokens_total,
            "wall_total_s": res.wall_total_s,
            "throughput": res.throughput(),
            "stalled_steps": res.stalled_steps,
            "decisions": decision_dicts(res.decisions),
            "metrics": res.metrics}


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


REPLAYS = [("paper", True, {}), ("paper", False, {}),
           ("random", True, {"seed": 3}), ("random", False, {"seed": 3}),
           ("chaos", True, {"seed": 1})]


@pytest.mark.parametrize("source,elastic,kw", REPLAYS,
                         ids=[f"{s}-{'elastic' if e else 'static'}"
                              for s, e, _ in REPLAYS])
def test_replay_matches_reference(fake_clock, tmp_path, source, elastic, kw):
    out = {}
    for side in SIDES:
        obs = mod(side, "obs").ObsConfig(run_log=str(tmp_path / f"{side}.jsonl"))
        exe = small_exe(side, obs=obs)
        res = exe.replay(source, 120, elastic=elastic,
                         trace_out=str(tmp_path / f"{side}_trace.json"), **kw)
        drift = exe.drift_report() if elastic else None
        out[side] = (replay_digest(res), drift and dataclasses.asdict(drift),
                     exe.controller and decision_dicts(exe.controller.decisions))
    assert out["port"] == out["ref"]
    if elastic:
        assert out["port"][2][0]["reason"] == "seeded from compiled plan"
    for suffix in (".jsonl", "_trace.json"):
        assert (tmp_path / f"port{suffix}").read_bytes() \
            == (tmp_path / f"ref{suffix}").read_bytes()


def test_run_replay_through_a_bootstrapped_controller(fake_clock):
    """runtime.run_replay with a controller that searches its own first
    plan, on the paper trace."""
    out = {}
    for side in SIDES:
        rt = mod(side, "runtime")
        cl = mod(side, "core.cluster").paper_case_study_cluster()
        pcfg = mod(side, "core.planner").PlannerConfig(
            granularity=16, n_microbatches=16)
        ctrl = rt.ElasticController(
            cl, "gpt-2b", planner_cfg=pcfg,
            cfg=rt.ControllerConfig(total_steps=200, seq_len=512,
                                    global_batch=16))
        res = rt.run_replay(rt.paper_trace(cl), 160, controller=ctrl)
        out[side] = replay_digest(res)
    assert out["port"] == out["ref"]
    assert any(d["action"] != "none" for d in out["port"]["decisions"])


# ---------------------------------------------------------------------------
# Chaos: the hardened controller under seeded storms (tests/test_chaos.py)
# ---------------------------------------------------------------------------


def tiny_cluster(side, a_nodes=2, b_nodes=2, cross_gbps=10.0):
    c = mod(side, "core.cluster")
    return c.HeteroCluster(
        subclusters=(
            c.SubCluster("A", a_nodes, 2,
                         c.DeviceProfile("fast", 300e12, 40 * c.GB, 1.5e12),
                         300e9, 25e9),
            c.SubCluster("B", b_nodes, 2,
                         c.DeviceProfile("slow", 120e12, 32 * c.GB, 0.9e12),
                         150e9, 25e9),
        ),
        cross_bw=cross_gbps * c.GBPS)


def storm_run(side, seed):
    rt, chaos = mod(side, "runtime"), mod(side, "chaos")
    cl = tiny_cluster(side)
    pcfg = mod(side, "core.planner").PlannerConfig(
        granularity=8, n_microbatches=8, min_submesh_devices=2)
    pcfg.search.require_all_devices = False
    ctrl = rt.ElasticController(cl, "gpt-2b", planner_cfg=pcfg, cfg=rt.ControllerConfig(
        total_steps=500, seq_len=256, global_batch=32, debounce_steps=2,
        min_steps_between_replans=4, restart_retry_steps=10))
    ctrl.bootstrap()
    ctrl.injector = chaos.FaultInjector(chaos.ChaosConfig(
        seed=seed, p_planner_timeout=0.25, p_planner_infeasible=0.25))
    trace = chaos.chaos_storm(cl, 100, seed=seed, intensity=2.5)
    by_step = {}
    for e in trace.events:
        by_step.setdefault(e.step, []).append(e)
    for step in range(100):
        for ev in by_step.get(step, ()):
            ctrl.handle(ev, step=step)
        ctrl.poll(step)
    return (chaos.trace_to_json(trace), decision_dicts(ctrl.decisions),
            ctrl.injector.stats(), strip_times(ctrl.strategy.to_json()))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hardened_controller_storm_matches_reference(fake_clock, seed):
    ref, port = storm_run("ref", seed), storm_run("port", seed)
    assert port[0] == ref[0]            # the storm trace, as JSON
    assert port[1] == ref[1]            # every decision, field by field
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert any(d["action"] != "none" for d in port[1])


# ---------------------------------------------------------------------------
# Migration (tests/test_migrate.py's seeded cases)
# ---------------------------------------------------------------------------


_TPDP_A = [(1, 4), (2, 2), (4, 1), (1, 2), (2, 1)]
_TPDP_B = [(1, 2), (2, 1), (1, 1)]


def duo(side, n_a=2, n_b=1, dpn=2, cross_gbps=10.0):
    c = mod(side, "core.cluster")
    return c.HeteroCluster(
        subclusters=(
            c.SubCluster("A", n_a, dpn,
                         c.DeviceProfile("fast", 300e12, 40 * c.GB, 1.5e12),
                         300e9, 25e9),
            c.SubCluster("B", n_b, dpn,
                         c.DeviceProfile("slow", 120e12, 32 * c.GB, 0.9e12),
                         150e9, 25e9),
        ),
        cross_bw=cross_gbps * c.GBPS)


def mk_strategy(side, specs, mb=4):
    s = mod(side, "core.strategy")
    stages = [s.StageAssignment(
        layer_start=ls, layer_end=le, cluster_idx=ci, mesh_n=1,
        mesh_m=tp * dp, tp=tp, dp=dp, t_f=0.01, t_b=0.02, mem_p=0, mem_a=0,
        intra_op=s.IntraOpPlan(axis="data", tp=tp, dp=dp,
                               shard_ratios=tuple(ratios), comm_bytes=0.0,
                               comm_time_f=0.0, comm_time_b=0.0))
        for ci, ls, le, tp, dp, ratios in specs]
    return s.ParallelStrategy(
        stages=stages, c_links=[0.001] * (len(stages) - 1),
        warmup_counts=list(range(len(stages), 0, -1)), t_max=0.03,
        n_microbatches=mb, mb_tokens=128, est_step_time=mb * 0.03)


def migration_case(side, seed):
    """tests/test_migrate.py's ``_random_case`` + apply + price, in one
    package; the same numpy draws on both sides."""
    m = mod(side, "migrate")
    rng = np.random.default_rng(seed)
    layers = [types.SimpleNamespace(param_bytes=int(n))
              for n in rng.integers(1, 300, size=3)]

    def pick(pool):
        tp, dp = pool[rng.integers(len(pool))]
        r = rng.random(dp) + 0.1
        return tp, dp, tuple(float(x) for x in r / r.sum())

    old_cl, new_cl = duo(side, n_a=2, n_b=1), duo(side, n_a=1, n_b=1)
    cut = int(rng.integers(1, 3))
    old = mk_strategy(side, [(0, 0, cut) + pick(_TPDP_A),
                             (1, cut, 3) + pick(_TPDP_B)])
    new = mk_strategy(side, [(0, 0, cut) + pick(_TPDP_B),
                             (1, cut, 3) + pick(_TPDP_B)])
    old_lay = m.layout_from_strategy(old, old_cl, layers)
    new_lay = m.layout_from_strategy(new, new_cl, layers)
    lost = m.lost_devices(old_cl, new_cl)
    full = {name: rng.integers(0, 256, size=spec.nbytes).astype(np.uint8)
            for name, spec in old_lay.leaves.items()}
    mplan = m.diff_layouts(old_lay, new_lay, lost=lost)
    st_new, stats = m.apply_migration(m.shard_state(old_lay, full), mplan,
                                      new_lay, lost=lost, ckpt_image=full)
    assert m.states_equal(st_new, m.shard_state(new_lay, full))
    cost = m.price_migration(mplan, old_lay, new_cl, old_strategy=old,
                             old_cluster=old_cl, layers=layers,
                             collect_timeline=True)
    gathered = {n: m.gather_leaf(st_new, n).tobytes() for n in new_lay.leaves}
    return {"transfers": [dataclasses.asdict(t) for t in mplan.transfers],
            "bytes": (mplan.moved_bytes, mplan.ckpt_bytes, mplan.local_bytes,
                      mplan.total_bytes, mplan.n_transfers),
            "stats": dataclasses.asdict(stats), "gathered": gathered,
            "cost": dataclasses.asdict(cost), "downtime": cost.downtime_s}


@pytest.mark.parametrize("seed", range(5))
def test_migration_diff_apply_price_match_reference(seed):
    ref, port = migration_case("ref", seed), migration_case("port", seed)
    assert port == ref
    assert port["stats"]["live_bytes"] == port["bytes"][0]


def test_migrate_to_matches_reference():
    out = {}
    for side in SIDES:
        api = mod(side, "api")
        cfg = api.HarpConfig(
            seq_len=256, global_batch=32,
            planner=mod(side, "core.planner").PlannerConfig(
                granularity=8, n_microbatches=8, min_submesh_devices=2))
        exe = api.compile("gpt-2b", duo(side, n_a=2, n_b=1), cfg)
        shrunk = mod(side, "core.cluster").remove_nodes(
            duo(side, n_a=2, n_b=1), "A", 1)
        new = exe.migrate_to(shrunk)
        d = json.loads(new.plan.to_json())
        d["strategy"] = strip_times(json.dumps(d["strategy"]))
        out[side] = (d, new.lowered.to_json())
    assert out["port"] == out["ref"]
    m = out["port"][0]["migration"]
    assert m["moved_bytes"] + m["ckpt_bytes"] + m["local_bytes"] \
        == m["total_bytes"] > 0


# ---------------------------------------------------------------------------
# Serving simulation and the Chrome trace
# ---------------------------------------------------------------------------


def test_serve_simulate_matches_reference(tmp_path):
    out = {}
    for side in SIDES:
        scfg = mod(side, "serving.placement").ServingConfig(
            qps=32.0, duration_s=1.0, prompt_mean=256, output_mean=32)
        exe = small_exe(side, serving=scfg)
        trace = mod(side, "serving.workload").scripted_trace(
            32.0, 40, prompt_tokens=256, output_tokens=32)
        path = tmp_path / f"{side}.json"
        res = exe.serve_simulate(trace, trace_out=str(path))
        poisson = exe.serve_simulate(qps=48.0, seed=5)
        out[side] = (exe.plan.serve, res.describe(),
                     dataclasses.asdict(res), poisson.describe(),
                     path.read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][2]["n_completed"] > 0


@pytest.mark.parametrize("priced,contention", [(False, False), (True, False),
                                               (False, True)])
def test_executable_trace_chrome_bytes_equal(tmp_path, priced, contention):
    for side in SIDES:
        small_exe(side).trace(out=str(tmp_path / f"{side}.json"),
                              priced=priced, contention=contention)
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "ref.json").read_bytes()


# ---------------------------------------------------------------------------
# Checkpoint counters on the obs registry
# ---------------------------------------------------------------------------


def test_ckpt_saves_count_bytes_on_default_registry(tmp_path):
    """tests/test_obs.py's check, on the port's checkpoint and registry."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.obs.metrics import DEFAULT_REGISTRY

    def counters():
        c = DEFAULT_REGISTRY.snapshot()["counters"]
        return c.get("ckpt.saves", 0), c.get("ckpt.bytes_written", 0)

    saves, written = counters()
    path = ckpt.save(str(tmp_path), 1, {"w": torch.arange(3.0),
                                        "b": np.ones(2, np.float32)})
    assert counters() == (saves + 1, written + os.path.getsize(path))
    ckptr = ckpt.AsyncCheckpointer(str(tmp_path / "async"))
    ckptr.save(2, {"w": torch.arange(3.0)})
    ckptr.wait()
    path2 = os.path.join(str(tmp_path / "async"), "ckpt_0000000002.npz")
    assert counters() == (saves + 2, written + os.path.getsize(path)
                          + os.path.getsize(path2))
