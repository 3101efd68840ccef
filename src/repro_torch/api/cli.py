"""``python -m repro_torch`` — the command-line face of the compile pipeline.

Counterpart of ``python -m repro`` (``repro/api/cli.py``), with the same
subcommands, flags and outputs, apart from two differences:

- ``train`` and ``kbench collect`` run on the card; ``--device cpu`` runs
  the port's plain PyTorch path on the CPU instead (``kbench collect
  --interpret``, the reference's flag, means the same).  ``kbench
  collect``'s table-fingerprint override, the reference's ``--device``, is
  ``--fingerprint`` here.
- ``dryrun`` forwards to ``repro_torch.launch.dryrun`` with its own
  flags, as the reference's forwards to its launcher; the port's adds
  ``--reduced`` (the arch's reduced config) and writes under
  ``results/dryrun_torch/``.

Subcommands round-trip the :class:`~repro_torch.api.artifacts.Plan` JSON artifact:

    python -m repro_torch plan --arch gpt-2b --cluster paper_case_study \\
        --global-batch 64 --microbatches 32 -o plan.json
    python -m repro_torch plan --arch gemma-2b --cluster paper_eval \\
        --serving --qps 1600 --prompt-mean 256 -o plan.json
    python -m repro_torch simulate --plan plan.json --timeline
    python -m repro_torch simulate --plan plan.json --trace poisson --qps 800
    python -m repro_torch train --plan plan.json --smoke --steps 20
    python -m repro_torch replay --plan plan.json --trace paper --steps 120
    python -m repro_torch migrate --plan plan.json --cluster paper_eval \\
        --cluster-kw n_a100_nodes=3 -o migrated.json
    python -m repro_torch chaos replay --plan plan.json --steps 200 --seed 1 \\
        --debounce 3 --deadline 2.0
    python -m repro_torch kbench collect --autotune -o ktable.json
    python -m repro_torch kbench merge hostA.json hostB.json -o ktable.json
    python -m repro_torch kbench show ktable.json
    python -m repro_torch plan --arch gpt-2b --kbench-table ktable.json \\
        --kbench-device-map A100-40G=gpu:A100 -o plan.json
    python -m repro_torch trace --plan plan.json -o trace.json
    python -m repro_torch trace --plan plan.json --replay chaos --steps 200 \\
        -o replay_trace.json
    python -m repro_torch dryrun --arch minitron-8b --shape train_4k --mesh single

``plan`` on a planning box, ``simulate``/``train``/``replay`` anywhere —
the artifact carries the cluster spec and config with it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def _parse_kw(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--cluster-kw expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _load_cluster(args):
    from repro_torch.api import cluster_from_dict, registry
    if args.cluster_file:
        with open(args.cluster_file) as f:
            return cluster_from_dict(json.load(f))
    return registry.resolve("cluster", args.cluster)(
        **_parse_kw(args.cluster_kw))


def _load_plan(path: str):
    from repro_torch.api import Plan
    with open(path) as f:
        return Plan.from_json(f.read())


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------


def cmd_plan(args) -> int:
    import dataclasses

    from repro_torch.api import HarpConfig, plan
    from repro_torch.core.planner import PlannerConfig

    comm_cfg = None
    if args.comm or args.comm_algorithms or args.comm_compressed:
        from repro_torch.comm.selector import CommConfig
        kw: Dict[str, Any] = {"compressed": args.comm_compressed}
        if args.comm_algorithms:
            kw["algorithms"] = tuple(args.comm_algorithms.split(","))
        comm_cfg = CommConfig(**kw)
    kbench_cfg = None
    if args.kbench_table:
        from repro_torch.kbench.bridge import KBenchConfig
        dmap = None
        if args.kbench_device_map:
            dmap = dict(p.split("=", 1) for p in args.kbench_device_map)
        kbench_cfg = KBenchConfig(table_path=args.kbench_table,
                                  device_map=dmap)
    pcfg = PlannerConfig(
        granularity=args.granularity, n_microbatches=args.microbatches,
        min_submesh_devices=args.min_submesh,
        max_submesh_devices=args.max_submesh, intra_op=args.intra_op,
        comm=comm_cfg, kbench=kbench_cfg)
    if args.workers:
        pcfg.search = dataclasses.replace(pcfg.search, n_workers=args.workers)
    serving_cfg = None
    if args.serving:
        from repro_torch.api import ServingConfig
        serving_cfg = ServingConfig(
            qps=args.qps, duration_s=args.serving_duration,
            prompt_mean=args.prompt_mean, output_mean=args.output_mean,
            objective=args.serving_objective,
            slo_ttft_s=args.slo_ttft_ms / 1e3,
            slo_tpot_s=args.slo_tpot_ms / 1e3)
    cfg = HarpConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                     scheduler=args.scheduler, planner=pcfg,
                     serving=serving_cfg)
    cluster = _load_cluster(args)
    artifact = plan(args.arch, cluster, cfg, verbose=args.verbose)
    with open(args.out, "w") as f:
        f.write(artifact.to_json())
    print(artifact.describe())
    if args.explain_comm:
        from repro_torch.api import compile as api_compile
        print()
        print(api_compile(plan_artifact=artifact).explain_comm())
    if args.explain_costs:
        from repro_torch.api import compile as api_compile
        print()
        print(api_compile(plan_artifact=artifact).explain_costs())
    print(f"\nplan written to {args.out}")
    return 0


def cmd_kbench(args) -> int:
    from repro_torch.kbench.table import LatencyTable

    if args.kcmd == "collect":
        from repro_torch.kbench import autotune, harness
        ops_to_run = args.ops.split(",") if args.ops else None
        run_device = "cpu" if args.interpret else args.device
        kw = dict(shapes=args.shapes, trials=args.trials, warmup=args.warmup,
                  run_device=run_device, seed=args.seed,
                  device=args.fingerprint)
        if args.autotune:
            table, sweeps = autotune.collect_autotuned(ops_to_run, **kw)
            for sw in sweeps:
                print(f"{sw.op} {sw.shape}: best={sw.best_blocks} "
                      f"({sw.best_s * 1e6:.1f}us), default="
                      f"{sw.default_blocks} ({sw.default_s * 1e6:.1f}us), "
                      f"speedup {sw.speedup:.2f}x")
        else:
            table = harness.collect(ops_to_run, **kw)
        table.save(args.out)
        print(f"{len(table)} cells ({harness.device_fingerprint(run_device)}) "
              f"written to {args.out}")
        return 0

    if args.kcmd == "merge":
        table = LatencyTable()
        for path in args.tables:
            table = table.merge(LatencyTable.load(path))
        table.save(args.out)
        print(f"merged {len(args.tables)} tables -> {len(table)} cells "
              f"in {args.out}")
        return 0

    # show
    table = LatencyTable.load(args.table)
    entries = table.entries if not args.device \
        else table.for_device(args.device)
    print(f"{args.table}: {len(table)} cells, devices: "
          f"{', '.join(table.devices()) or '(none)'}")
    for e in entries:
        blocks = "default" if e.blocks is None else "x".join(map(str, e.blocks))
        tput = f", {e.flops / e.median_s / 1e12:.3f} TFLOP/s" \
            if e.flops > 0 and e.median_s > 0 else ""
        print(f"  [{e.device}] {e.op} {tuple(e.shape)} blocks={blocks}: "
              f"{e.median_s * 1e6:.1f}us (median of {e.trials}{tput}) "
              f"@{e.host or '?'}")
    return 0


def cmd_simulate(args) -> int:
    from repro_torch.api import compile as api_compile, registry

    exe = api_compile(plan_artifact=_load_plan(args.plan))
    if args.trace:
        if exe.plan.serve is None:
            raise SystemExit(
                "simulate --trace needs a plan built with plan --serving")
        kw: Dict[str, Any] = {}
        if args.qps is not None:
            kw["qps"] = args.qps
        if args.duration is not None:
            kw["duration_s"] = args.duration
        if args.trace_seed is not None:
            kw["seed"] = args.trace_seed
        trace = registry.resolve("serve_trace", args.trace)(
            exe.config.serving, **kw)
        res = exe.serve_simulate(trace, trace_out=args.trace_out)
        print(res.describe())
        if args.trace_out:
            print(f"serving Chrome trace written to {args.trace_out}")
        return 0
    res = exe.simulate(priced=not args.raw, no_overlap=args.no_overlap,
                       contention=args.contention,
                       trace_out=args.trace_out)
    tok = exe.strategy.tokens_per_step()
    print(exe.lowered.describe())
    mode = "contended fair-share" if args.contention else \
        ("referee-priced" if not args.raw else "raw schedule")
    print(f"\nsimulated step: {res.makespan * 1e3:.2f} ms ({mode}), "
          f"{tok / res.makespan:,.0f} tokens/s, "
          f"comm overlap {res.overlap_ratio * 100:.0f}%")
    if args.contention and res.link_busy:
        busy = ", ".join(f"{l}={t * 1e3:.1f}ms"
                         for l, t in sorted(res.link_busy.items()))
        print(f"link busy: {busy}")
    if args.timeline:
        from repro_torch.obs import render_ascii, trace_from_sim
        print(render_ascii(trace_from_sim(res), width=96))
    if args.trace_out:
        print(f"Chrome trace written to {args.trace_out}")
    return 0


def cmd_train(args) -> int:
    from repro_torch.api import HarpConfig, compile as api_compile, fit
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import TrainerConfig

    hooks: Dict[str, Any] = {}
    # CLI flags default to None so a Plan's own workload config wins unless
    # explicitly overridden
    seq, batch, steps = args.seq, args.batch, args.steps
    if args.plan:
        exe = api_compile(plan_artifact=_load_plan(args.plan))
        arch_cfg = exe.arch
        seq = seq if seq is not None else exe.config.seq_len
        batch = batch if batch is not None else exe.config.global_batch
        steps = steps if steps is not None \
            else exe.config.trainer.total_steps
        if args.smoke:
            # the reduced stand-in arch runs nothing like the planned model;
            # anchoring the controller's telemetry to the plan's predictions
            # would produce bogus drift/replan decisions
            print("[train] --smoke: elastic controller NOT attached "
                  "(reduced arch is not the planned workload)")
        elif seq == exe.config.seq_len and batch == exe.config.global_batch:
            from repro_torch.runtime.controller import ControllerConfig
            # the amortization horizon must be the steps actually run, not
            # the plan's default training horizon
            ctrl = exe.attach_elastic(ControllerConfig(
                total_steps=steps, seq_len=seq, global_batch=batch))
            hooks = {"on_step_time": ctrl.on_step_time,
                     "on_straggler": ctrl.on_straggler}
        else:
            print("[train] workload overridden vs. the plan: elastic "
                  "controller NOT attached (telemetry would anchor to the "
                  "wrong prediction)")
    else:
        if not args.arch:
            raise SystemExit("train needs --plan or --arch")
        arch_cfg = get_config(args.arch)
    seq = 128 if seq is None else seq
    batch = 8 if batch is None else batch
    steps = 200 if steps is None else steps
    if args.smoke:
        arch_cfg = arch_cfg.reduced()
    cfg = HarpConfig(
        seq_len=seq, global_batch=batch,
        trainer=TrainerConfig(total_steps=steps, ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every),
        data=DataConfig(vocab_size=arch_cfg.vocab_size, seq_len=seq,
                        global_batch=batch, seed=args.seed,
                        kind=args.data_kind))
    out = fit(arch_cfg, cfg, n_microbatches=args.microbatches,
              seed=args.seed, device=args.device, **hooks)
    hist = out["history"]
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {out['final_step']} steps")
    return 0


def cmd_replay(args) -> int:
    from repro_torch.api import compile as api_compile

    exe = api_compile(plan_artifact=_load_plan(args.plan))
    kw: Dict[str, Any] = {}
    if args.trace == "random":
        kw["seed"] = args.seed
    res = exe.replay(args.trace, args.steps, elastic=not args.static,
                     trace_out=args.trace_out, **kw)
    if args.trace_out:
        print(f"Chrome trace written to {args.trace_out}")
    if exe.controller is not None:
        print("replan decisions:")
        for d in exe.controller.decisions:
            print(f"  {d.describe()}")
    bucket = max(1, args.steps // 12)
    print("\nthroughput timeline (tokens/s):")
    for s0 in range(0, args.steps, bucket):
        tput = res.throughput_between(s0, s0 + bucket)
        print(f"  steps {s0:4d}-{s0 + bucket:4d}: {tput:12,.0f}")
    print(f"\noverall: {res.throughput():,.0f} tokens/s, "
          f"{res.stalled_steps} stalled steps")
    return 0


def cmd_migrate(args) -> int:
    from repro_torch.api import compile as api_compile

    exe = api_compile(plan_artifact=_load_plan(args.plan))
    if args.to:
        target = api_compile(plan_artifact=_load_plan(args.to))
    else:
        if not (args.cluster or args.cluster_file):
            raise SystemExit("migrate needs --to PLAN.json or a new "
                             "--cluster/--cluster-file to replan onto")
        target = _load_cluster(args)
    new_exe = exe.migrate_to(target, overlap=not args.no_overlap,
                             verbose=args.verbose)
    with open(args.out, "w") as f:
        f.write(new_exe.plan.to_json())
    m = new_exe.plan.migration
    print(new_exe.plan.describe())
    print(f"\nmigration: {m['moved_bytes'] / 1e6:.1f} MB moved + "
          f"{m['ckpt_bytes'] / 1e6:.1f} MB from checkpoint "
          f"({m['local_bytes'] / 1e6:.1f} MB already in place) in "
          f"{m['n_transfers']} transfers")
    per_link = ", ".join(f"{l}={b / 1e6:.1f}MB"
                         for l, b in m["link_bytes"].items())
    print(f"link traffic: {per_link or 'none'}")
    print(f"downtime: {m['downtime_s']:.3f}s "
          f"(serial {m['serial_s']:.3f}s, drain {m['drain_s']:.3f}s, "
          f"{'overlapped' if m['overlapped'] else 'stop-the-world'})")
    print(f"\nmigrated plan written to {args.out}")
    return 0


def cmd_chaos(args) -> int:
    from repro_torch.api import compile as api_compile
    from repro_torch.chaos import (
        ChaosConfig, FaultInjector, chaos_storm, trace_from_json,
        trace_to_json,
    )
    from repro_torch.runtime.controller import ControllerConfig
    from repro_torch.runtime.replay import run_replay

    exe = api_compile(plan_artifact=_load_plan(args.plan))
    if args.trace_file:
        with open(args.trace_file) as f:
            trace = trace_from_json(f.read())
    else:
        trace = chaos_storm(exe.cluster, args.steps, seed=args.seed,
                            intensity=args.intensity)
    if args.save_trace:
        with open(args.save_trace, "w") as f:
            f.write(trace_to_json(trace))
        print(f"storm trace written to {args.save_trace}")
    cfg = exe.config
    ccfg = ControllerConfig(
        total_steps=args.steps, seq_len=cfg.seq_len,
        global_batch=cfg.global_batch,
        debounce_steps=args.debounce,
        min_steps_between_replans=args.min_replan_gap,
        replan_deadline_s=args.deadline,
        degraded_ladder=not args.no_ladder)
    ctrl = exe.attach_elastic(ccfg)
    if args.p_planner_timeout > 0 or args.p_planner_infeasible > 0:
        ctrl.injector = FaultInjector(ChaosConfig(
            seed=args.seed,
            p_planner_timeout=args.p_planner_timeout,
            p_planner_infeasible=args.p_planner_infeasible))
    res = run_replay(trace, args.steps, controller=ctrl)
    print("replan decisions:")
    for d in ctrl.decisions:
        print(f"  {d.describe()}")
    replans = sum(1 for d in ctrl.decisions
                  if d.action not in ("none", "deferred", "ignored"))
    print(f"\noverall: {res.throughput():,.0f} tokens/s, "
          f"{res.stalled_steps} stalled steps, {replans} replans, "
          f"{len(trace.events)} storm events")
    if ctrl.injector is not None:
        print(f"injected faults: {ctrl.injector.stats()}")
    return 0


def cmd_trace(args) -> int:
    from repro_torch.api import compile as api_compile

    exe = api_compile(plan_artifact=_load_plan(args.plan))
    if args.replay:
        kw: Dict[str, Any] = {}
        if args.replay == "random" or args.replay == "chaos":
            kw["seed"] = args.seed
        res = exe.replay(args.replay, args.steps, trace_out=args.out, **kw)
        n_dec = len(res.decisions)
        print(f"replayed {args.steps} steps ({args.replay}): "
              f"{res.throughput():,.0f} tokens/s, {n_dec} controller "
              f"decisions traced")
        print(f"Chrome trace written to {args.out} "
              f"(load in Perfetto / chrome://tracing)")
        return 0
    if args.serve:
        if exe.plan.serve is None:
            raise SystemExit(
                "trace --serve needs a plan built with plan --serving")
        res = exe.serve_simulate(trace_out=args.out)
        print(res.describe())
        print(f"serving Chrome trace written to {args.out} "
              f"(load in Perfetto / chrome://tracing)")
        return 0
    tr = exe.trace(out=args.out, priced=args.priced,
                   contention=args.contention)
    print(f"{len(tr.spans)} spans / {len(tr.counters)} counter samples, "
          f"makespan {tr.makespan() * 1e3:.2f} ms")
    if args.timeline:
        from repro_torch.obs import render_ascii
        print(render_ascii(tr, width=96))
    print(f"Chrome trace written to {args.out} "
          f"(load in Perfetto / chrome://tracing)")
    return 0


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="HARP compile pipeline: plan / simulate / train / replay")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="HAPT search -> Plan JSON artifact")
    p.add_argument("--arch", required=True)
    p.add_argument("--cluster", default="paper_case_study",
                   help="registered cluster name (see repro_torch.api.registry)")
    p.add_argument("--cluster-kw", action="append", default=[],
                   metavar="K=V", help="cluster factory kwarg, repeatable "
                   "(e.g. --cluster-kw cross_gbps=10)")
    p.add_argument("--cluster-file",
                   help="cluster spec JSON (api.cluster_to_dict format)")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--global-batch", type=int, default=64)
    p.add_argument("--granularity", type=int, default=64)
    p.add_argument("--microbatches", type=int, default=32)
    p.add_argument("--min-submesh", type=int, default=1)
    p.add_argument("--max-submesh", type=int, default=0)
    p.add_argument("--intra-op", action="store_true",
                   help="joint inter+intra-operator search")
    p.add_argument("--comm", action="store_true",
                   help="heterogeneity-aware collective pricing: the search "
                        "chooses plans under the selected algorithm's cost "
                        "(repro_torch.comm)")
    p.add_argument("--comm-algorithms", default=None, metavar="A,B,...",
                   help="candidate collective set (default "
                        "ring,rhd,hierarchical; implies --comm)")
    p.add_argument("--comm-compressed", action="store_true",
                   help="add int8-compressed candidates for WAN-crossing "
                        "collectives (implies --comm; stage-local TP/DP "
                        "collectives never cross the WAN, so this prices "
                        "the cross-cluster sync surfaces — see docs/comm.md)")
    p.add_argument("--explain-comm", action="store_true",
                   help="print the per-stage collective breakdown "
                        "(algorithm, bytes, priced time, contended links)")
    p.add_argument("--kbench-table", default=None, metavar="TABLE.json",
                   help="measured-kernel latency table (repro_torch kbench "
                        "collect): the DP search prices stages from "
                        "measurements where covered, analytic elsewhere")
    p.add_argument("--kbench-device-map", action="append", default=[],
                   metavar="NAME=FINGERPRINT",
                   help="map a DeviceProfile name to a table device "
                        "fingerprint, repeatable (e.g. "
                        "A100-40G=gpu:NVIDIA_A100)")
    p.add_argument("--explain-costs", action="store_true",
                   help="print the per-stage pricing breakdown (measured vs "
                        "analytic source, MFU anchors)")
    p.add_argument("--scheduler", default="h1f1b")
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--serving", action="store_true",
                   help="also search a serving placement (disaggregated "
                        "prefill/decode over the same fleet); the plan "
                        "artifact grows a ServePlan section")
    p.add_argument("--qps", type=float, default=32.0,
                   help="offered request rate for the serving search")
    p.add_argument("--serving-duration", type=float, default=2.0,
                   help="seconds of Poisson arrivals the search replays")
    p.add_argument("--serving-objective", default="slo",
                   choices=["slo", "throughput"])
    p.add_argument("--prompt-mean", type=int, default=512)
    p.add_argument("--output-mean", type=int, default=64)
    p.add_argument("--slo-ttft-ms", type=float, default=200.0,
                   help="p99 time-to-first-token target")
    p.add_argument("--slo-tpot-ms", type=float, default=20.0,
                   help="p99 time-per-output-token target")
    p.add_argument("-o", "--out", default="plan.json")
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("simulate", help="simulate one step of a Plan")
    p.add_argument("--plan", required=True)
    p.add_argument("--raw", action="store_true",
                   help="raw lowered schedule (default: referee-priced)")
    p.add_argument("--no-overlap", action="store_true")
    p.add_argument("--contention", action="store_true",
                   help="fair-share link-occupancy simulation (comm.netsim):"
                        " shared links and grad syncs contend")
    p.add_argument("--timeline", action="store_true")
    p.add_argument("--trace", default=None,
                   help="serving mode: replay a registered request trace "
                        "(poisson / scripted) through the plan's ServePlan "
                        "section (needs plan --serving)")
    p.add_argument("--qps", type=float, default=None,
                   help="override the trace's request rate")
    p.add_argument("--duration", type=float, default=None,
                   help="override the trace's duration (seconds)")
    p.add_argument("--trace-seed", type=int, default=None)
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="also write the simulation as Chrome-trace JSON "
                        "(Perfetto / chrome://tracing)")

    p = sub.add_parser("train", help="training loop (plan-driven or ad hoc)")
    p.add_argument("--plan", help="Plan JSON (wires the elastic controller)")
    p.add_argument("--arch", help="arch id (when no --plan)")
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config")
    p.add_argument("--steps", type=int, default=None,
                   help="default: plan's total_steps, else 200")
    p.add_argument("--batch", type=int, default=None,
                   help="default: plan's global_batch, else 8")
    p.add_argument("--seq", type=int, default=None,
                   help="default: plan's seq_len, else 128")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--data-kind", default="markov",
                   choices=["markov", "zipf", "uniform"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (cpu: the plain PyTorch path)")

    p = sub.add_parser("replay", help="fleet-dynamics replay of a Plan")
    p.add_argument("--plan", required=True)
    p.add_argument("--trace", default="paper",
                   help="registered event source (paper / random / none)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--static", action="store_true",
                   help="keep the plan fixed (checkpoint-restart baseline)")
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="write the replay (pipeline lanes + controller-"
                        "decision track) as Chrome-trace JSON")

    p = sub.add_parser("trace", help="export a plan's timing as Chrome-"
                       "trace JSON (repro_torch.obs; Perfetto-loadable)")
    p.add_argument("--plan", required=True)
    p.add_argument("-o", "--out", default="trace.json")
    p.add_argument("--priced", action="store_true",
                   help="referee-priced accounting (default: the raw "
                        "lowered schedule — matches describe(timeline))")
    p.add_argument("--contention", action="store_true",
                   help="fair-share link-occupancy engine (adds sync lanes "
                        "+ link-busy counters)")
    p.add_argument("--timeline", action="store_true",
                   help="also print the ASCII rendering of the same spans")
    p.add_argument("--replay", default=None, metavar="SOURCE",
                   help="trace a fleet-dynamics replay instead (event "
                        "source name: paper / random / chaos / none) — "
                        "adds the controller-decision track")
    p.add_argument("--serve", action="store_true",
                   help="trace the serving simulator instead (per-pool "
                        "prefill/decode lanes; needs plan --serving)")
    p.add_argument("--steps", type=int, default=200,
                   help="steps for --replay")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("migrate", help="price moving live state from one "
                       "plan onto another (repro_torch.migrate differ + netsim)")
    p.add_argument("--plan", required=True,
                   help="the currently-running Plan JSON (state source)")
    p.add_argument("--to", default=None,
                   help="target Plan JSON (else replan on --cluster)")
    p.add_argument("--cluster", default=None,
                   help="registered cluster name to replan onto")
    p.add_argument("--cluster-kw", action="append", default=[], metavar="K=V")
    p.add_argument("--cluster-file",
                   help="cluster spec JSON (api.cluster_to_dict format)")
    p.add_argument("--no-overlap", action="store_true",
                   help="price stop-the-world instead of overlapping the "
                        "old plan's drain")
    p.add_argument("-o", "--out", default="migrated_plan.json")
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("kbench", help="measured-kernel latency tables "
                       "(collect / merge / show)")
    ksub = p.add_subparsers(dest="kcmd", required=True)

    k = ksub.add_parser("collect", help="microbenchmark the fused ops on "
                        "this host -> table JSON")
    k.add_argument("--ops", default=None, metavar="A,B,...",
                   help="subset of the op registry (default: all)")
    k.add_argument("--shapes", default="tiny", choices=["tiny", "default"],
                   help="canonical shape set (tiny = CI/interpret-sized)")
    k.add_argument("--autotune", action="store_true",
                   help="sweep each op's block grid and record the winner")
    k.add_argument("--trials", type=int, default=5)
    k.add_argument("--warmup", type=int, default=2)
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to measure (cpu: the plain versions, cells "
                        "stamped cpu:<machine>:plain)")
    k.add_argument("--interpret", action="store_true",
                   help="the reference's flag: same as --device cpu")
    k.add_argument("--fingerprint", default=None,
                   help="override the recorded device fingerprint")
    k.add_argument("-o", "--out", default="ktable.json")

    k = ksub.add_parser("merge", help="deterministic cross-host merge")
    k.add_argument("tables", nargs="+", metavar="TABLE.json")
    k.add_argument("-o", "--out", default="ktable.json")

    k = ksub.add_parser("show", help="dump a table's cells")
    k.add_argument("table", metavar="TABLE.json")
    k.add_argument("--device", default=None,
                   help="only cells for this device fingerprint")

    p = sub.add_parser("chaos", help="chaos-hardening tools (fault-storm "
                       "replay through the hardened controller)")
    csub = p.add_subparsers(dest="chaoscmd", required=True)
    c = csub.add_parser("replay", help="replay a seeded fault storm (or a "
                        "saved trace) against a Plan's elastic controller")
    c.add_argument("--plan", required=True)
    c.add_argument("--steps", type=int, default=200)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--intensity", type=float, default=1.0,
                   help="scales every storm hazard rate")
    c.add_argument("--trace-file", default=None,
                   help="replay a saved storm trace JSON instead of "
                        "generating one")
    c.add_argument("--save-trace", default=None, metavar="TRACE.json",
                   help="write the generated storm trace (fixture-ready)")
    c.add_argument("--debounce", type=int, default=3,
                   help="event-coalescing window (steps); 0 disables")
    c.add_argument("--min-replan-gap", type=int, default=5,
                   help="hysteresis: min steps between voluntary replans")
    c.add_argument("--deadline", type=float, default=0.0,
                   help="replan wall-clock deadline (s); 0 = unbounded")
    c.add_argument("--no-ladder", action="store_true",
                   help="disable the degraded-mode ladder (unhardened "
                        "baseline — planning failures raise)")
    c.add_argument("--p-planner-timeout", type=float, default=0.0)
    c.add_argument("--p-planner-infeasible", type=float, default=0.0)

    sub.add_parser("dryrun", add_help=False,
                   help="forward to repro_torch.launch.dryrun (own flags)")
    return ap


def cmd_dryrun(extra: List[str]) -> int:
    from repro_torch.launch import dryrun
    return dryrun.main(extra)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "dryrun":
        return cmd_dryrun(argv[1:])
    args = build_parser().parse_args(argv)
    return {"plan": cmd_plan, "simulate": cmd_simulate,
            "train": cmd_train, "replay": cmd_replay,
            "migrate": cmd_migrate, "kbench": cmd_kbench,
            "chaos": cmd_chaos, "trace": cmd_trace}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
