"""Multi-pod dry run: build and trace every (architecture x input shape) on
the production meshes, with no allocation, and record per-device memory,
FLOPs and collective bytes.

Counterpart of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell for 512 placeholder devices, the port runs the cell's
step once, eagerly, on DTensors whose local shards are fake tensors
(``FakeTensorMode``, ``cpu``) over torch's in-process ``fake`` process
group of 256 or 512 ranks; this process is rank 0.  The mesh is a ``cpu``
``DeviceMesh``: the fake group moves no data, and a ``cpu`` mesh builds
the same way on a machine with or without a card.  Each step runs the
plain path (``use_kernels=False``), as the reference's ``jnp`` path does.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 4]

Each cell writes ``results/dryrun_torch/<arch>_<shape>_<mesh>.json``:

- ``memory``: ``argument_bytes`` (the local shards of params, optimizer
  state, batch and cache), ``output_bytes``, ``alias_bytes`` (outputs that
  are arguments updated in place: params, optimizer state, the decode
  cache), ``temp_bytes`` and ``peak_per_device``, with the reference's
  identity ``peak = argument + output + temp - alias``.  The peak is the
  most bytes of live fake storages at any point of the step (a storage is
  live from the op that makes it until its last tensor is freed).
- ``flops_per_device``: rank 0's local work, from
  ``torch.utils.flop_counter``'s formulas on each local op;
  ``bytes_per_device``: the bytes each local non-view op reads and writes,
  unfused (XLA's ``bytes accessed`` counts after fusion, so this is higher).
- ``collectives``: output payload bytes per device of each
  ``_c10d_functional`` collective by kind (``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``, ...), ``collective_counts`` the number of each,
  ``collective_bytes_per_device`` their sum, and
  ``collectives_by_mesh_dim`` the bytes by kind and mesh dim
  (``"all_reduce@data"``).  On a ``cpu`` mesh DTensor moves a shard from
  one dim to another by all-gather and chunk, where a ``cuda`` mesh would
  all-to-all: those count as ``all_gather_into_tensor``.
- ``ok``, ``error``, ``traceback``, ``trace_s`` and ``total_s``.

What does not carry over: ``hlo_chars`` (there is no HLO), ``lower_s`` /
``compile_s`` (there is no compile step; ``trace_s`` is the one eager pass)
and ``scanned_flops_per_device`` (eager torch loops in Python, so there is
no scanned program that counts a loop body once).  ``analysis_mode`` is
``"eager-1pass"``: one pass counts every microbatch exactly; under
``REPRO_FAST_ANALYSIS=1`` a train cell runs one microbatch and scales its
counts by ``REPRO_NMB``, as the reference's ``"scaled-1pass"``.  The
reference's linear ``(n_mb = 1, 2)`` decomposition is not needed: one
eager pass counts every microbatch.

The knobs are the reference's, with its names, defaults and effects:
``REPRO_NMB`` (microbatches, 16), ``REPRO_FSDP`` (params sharded over
``data``, 1), ``REPRO_ACT_BF16`` (bf16 activations, 0), ``REPRO_FLATDP``
(batch over every axis, 0), ``REPRO_MASTER`` (bf16 params with an f32
master, 0), ``REPRO_FAST_ANALYSIS`` and ``REPRO_ZERO1`` (1; read and, as
in the reference, used nowhere).

Decode cells run at ``pos = seq_len - 1``, a host int: the port's decode
step takes its position as a Python int, where the reference traces an
int32 scalar, so the argument bytes lack those 4 bytes.  Token batches are
int32, as the reference's ``input_specs``.  The pipelined multi-pod train
cells are not built yet (ROADMAP.md, Queue 1 item 8): they return
``ok: false`` with an error naming that item.  Importing this module
touches no process-group state.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_shape, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import cache_specs, input_specs, param_specs
from repro_torch.models.common import sharded_execution, mesh_of, set_act_dtype
from repro_torch.models.prefill import prefill
from repro_torch.parallel import sharding as shd
from repro_torch.serve.step import make_serve_step
from repro_torch.train.optimizer import (
    OptimizerConfig, OptState, tree_leaves, tree_map,
)
from repro_torch.train.step import layout_specs, make_train_step

OUT_DIR = "results/dryrun_torch"
PIPELINE_ITEM = ("the pipelined multi-pod train cells wait for ROADMAP.md "
                 "Queue 1 item 8 (make_pipeline_train_step(abstract=True), "
                 "a stage over its (data, model) sub-mesh)")


def _knob(name: str, default: str) -> str:
    return os.environ.get(name, default)


def knobs() -> Dict[str, Any]:
    """The reference's environment knobs, read at call time."""
    return {
        "n_microbatches": int(_knob("REPRO_NMB", "16")),
        "zero1": _knob("REPRO_ZERO1", "1") == "1",
        "fsdp_params": _knob("REPRO_FSDP", "1") == "1",
        "act_bf16": _knob("REPRO_ACT_BF16", "0") == "1",
        "flat_dp": _knob("REPRO_FLATDP", "0") == "1",
        "master_weights": _knob("REPRO_MASTER", "0") == "1",
        "fast_analysis": _knob("REPRO_FAST_ANALYSIS", "0") == "1",
    }


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    """A cell ready to trace: ``fn(*placed args)``, the args as ``meta``
    structs and their :class:`~repro_torch.parallel.sharding.NamedSharding`
    trees (same structure), and the mesh."""
    fn: Any
    args: Tuple
    in_sh: Tuple
    mesh: Any


def _opt_struct(opt_cfg: OptimizerConfig, params) -> OptState:
    """The AdamW state of ``params`` as ``meta`` structs."""
    step = torch.empty((), dtype=torch.int32, device="meta")
    like = lambda dt: tree_map(lambda p: torch.empty(p.shape, dtype=dt, device="meta"), params)
    master = like(torch.float32) if opt_cfg.master_weights else None
    return OptState(step, like(opt_cfg.state_dtype), like(opt_cfg.state_dtype), master)


def build_case(arch: str, shape_name: str, multi_pod: bool,
               n_microbatches: Optional[int] = None,
               global_batch_override: int = 0, *,
               cfg: Optional[ArchConfig] = None) -> Case:
    """The cell's step, args and shardings, as the reference's
    ``build_case`` derives them (``dryrun.py:89-234``).  Needs the
    initialised (fake) process group of 256 or 512 ranks; ``cfg``
    replaces ``get_config(arch)`` (a reduced config, say)."""
    k = knobs()
    n_mb = k["n_microbatches"] if n_microbatches is None else n_microbatches
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    if global_batch_override:
        shape = dataclasses.replace(shape, global_batch=global_batch_override)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    opt_cfg = OptimizerConfig(state_dtype=torch.bfloat16,
                              master_weights=k["master_weights"])
    batch_structs = input_specs(cfg, shape)

    if shape.kind == "train":
        if multi_pod and cfg.family != "audio":
            raise NotImplementedError(PIPELINE_ITEM)
        rules = shd.train_act_rules()
        if multi_pod:
            rules = dict(rules, batch=("pod", "data"), expert=("pod", "data"))
        if k["flat_dp"]:
            rules = dict(rules, batch=(("pod", "data", "model") if multi_pod
                                       else ("data", "model")),
                         batch_head=("pod", "data") if multi_pod else "data",
                         heads=None, kv_heads=None, ff=None, vocab="model")
        pdtype = torch.bfloat16 if k["master_weights"] else torch.float32
        train_step, _, _ = make_train_step(
            cfg, opt_cfg, act_rules=rules, n_microbatches=n_mb,
            param_dtype=pdtype, use_kernels=False, device="cpu")
        pstructs = param_specs(cfg, param_dtype=pdtype)
        pspecs, opt_pspecs = layout_specs(shd.param_pspecs(pstructs),
                                          fsdp_params=k["fsdp_params"],
                                          flat_dp=k["flat_dp"])
        pshard = shd.fitted_shardings(mesh, pspecs, pstructs)
        opt_struct = _opt_struct(opt_cfg, pstructs)
        if k["flat_dp"]:
            batch_axis = ("pod", "data", "model") if multi_pod else ("data", "model")
        else:
            batch_axis = ("pod", "data") if multi_pod else "data"
        batch_sh = shd.batch_shardings(mesh, batch_structs, batch_axis)
        fit = lambda tree: shd.fitted_shardings(mesh, opt_pspecs, tree)
        opt_sh = OptState(shd.NamedSharding(mesh, ()), fit(opt_struct.mu),
                          fit(opt_struct.nu),
                          fit(opt_struct.master) if opt_struct.master is not None
                          else None)

        def fn(params, opt_state, batch):
            if k["act_bf16"]:
                set_act_dtype(torch.bfloat16)
            try:
                return train_step(params, opt_state, batch)
            finally:
                if k["act_bf16"]:
                    set_act_dtype(None)

        return Case(fn, (pstructs, opt_struct, batch_structs),
                    (pshard, opt_sh, batch_sh), mesh)

    pstructs = param_specs(cfg)
    pshard = shd.fitted_shardings(mesh, shd.param_pspecs(pstructs), pstructs)

    if shape.kind == "prefill":
        rules = shd.prefill_act_rules(multi_pod=multi_pod)

        def prefill_step(params, batch):
            with sharded_execution(mesh_of(params), rules):
                return prefill(cfg, params, batch)

        batch_sh = shd.batch_shardings(mesh, batch_structs, rules["batch"])
        return Case(prefill_step, (pstructs, batch_structs), (pshard, batch_sh),
                    mesh)

    # decode
    serve_step, _, rules = make_serve_step(cfg, shape=shape, multi_pod=multi_pod,
                                           use_kernels=False, device="cpu")
    cache_structs = cache_specs(cfg, shape)
    cache_sh = shd.fitted_shardings(
        mesh, shd.cache_pspecs(cache_structs, rules), cache_structs)
    tok = batch_structs["tokens"]
    tok_sh = shd.NamedSharding(mesh, (rules["batch"], None))
    pos = shape.seq_len - 1

    def decode_step(params, cache, tokens):
        return serve_step(params, cache, tokens, pos)

    return Case(decode_step, (pstructs, cache_structs, tok),
                (pshard, cache_sh, tok_sh), mesh)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _fake_mode_cls():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry

    class CountingFakeTensorMode(FakeTensorMode):
        """A ``FakeTensorMode`` that counts what every op on its fake
        tensors does: the local ops of a DTensor program, since DTensor
        unwraps to its local shards before they reach this mode."""

        def __init__(self, group_dims: Optional[Dict[str, str]] = None):
            super().__init__()
            self.group_dims = group_dims or {}
            self.reset()

        def reset(self):
            self.flops = 0
            self.bytes = 0
            self.colls: Dict[str, float] = {}
            self.coll_counts: Dict[str, int] = {}
            self.coll_dims: Dict[str, float] = {}
            self.live = 0
            self.peak = 0
            self._storages: Dict[int, int] = {}

        def track(self, t) -> None:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                return
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

        def _free(self, key):
            self.live -= self._storages.pop(key, 0)

        def dispatch(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = super().dispatch(func, types, args, kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return out          # the global op; its local ops come next
            outs = out if isinstance(out, (list, tuple)) else (out,)
            if all(t.device.type == "meta" for t in outs if isinstance(t, torch.Tensor)):
                return out          # structs on ``meta`` (a cache's layout): no device
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if func.namespace == "_c10d_functional" and packet.__name__ != "wait_tensor":
                name = packet.__name__
                n = sum(t.numel() * t.element_size() for t in outs
                        if isinstance(t, torch.Tensor))
                self.colls[name] = self.colls.get(name, 0.0) + float(n)
                self.coll_counts[name] = self.coll_counts.get(name, 0) + 1
                group = kwargs.get("group_name", args[-1])
                group = getattr(group, "group_name", group)
                key = f"{name}@{self.group_dims.get(group, group)}"
                self.coll_dims[key] = self.coll_dims.get(key, 0.0) + float(n)
            if not func.is_view:
                ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                       if isinstance(a, torch.Tensor)]
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in (*ins, *outs) if isinstance(t, torch.Tensor))
            for t in outs:
                if isinstance(t, FakeTensor):
                    self.track(t)
            return out

    return CountingFakeTensorMode


class _HostWorkOutside:
    """Runs DTensor's host-side bookkeeping outside the counting mode:
    its sharding propagation, which runs each new op once on global-shape
    fake tensors to learn its output's metadata, and the index arithmetic
    of a strided shard's local size, which computes on small host tensors.
    Under the counting mode the first would count as rank 0's work and the
    second would meet fake tensors (``.item()`` fails); both run as they do
    without a mode."""

    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        _StridedShard = getattr(placement_types, "_StridedShard", object)
        self._saved = []
        for cls, name in ((ShardingPropagator, "propagate_op_sharding_non_cached"),
                          (_StridedShard, "local_shard_size_and_offset")):
            raw = cls.__dict__.get(name)
            if raw is None:        # another torch release: nothing to wrap
                continue
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw

            def outside(*a, __fn=fn, **kw):
                with unset_fake_temporarily():
                    return __fn(*a, **kw)

            setattr(cls, name, staticmethod(outside)
                    if isinstance(raw, staticmethod) else outside)
            self._saved.append((cls, name, raw))
        return self

    def __exit__(self, *exc):
        for cls, name, raw in self._saved:
            setattr(cls, name, raw)
        return False


def _flat(tree) -> List[Any]:
    if isinstance(tree, OptState):
        return [x for part in tree if part is not None for x in _flat(part)]
    if isinstance(tree, (list, tuple)):
        return [x for part in tree for x in _flat(part)]
    if isinstance(tree, dict):
        return tree_leaves(tree)
    return [tree]


def _place(in_sh, struct):
    """Place ``struct`` (a tree of meta structs) by ``in_sh``: DTensors with
    fake local shards on the CPU."""
    if isinstance(struct, OptState):
        return OptState(*(None if s is None else _place(h, s)
                          for h, s in zip(in_sh, struct)))
    if isinstance(struct, dict):
        return tree_map(lambda h, s: h.place(s, "cpu"), in_sh, struct)
    return in_sh.place(struct, "cpu")


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def trace_case(case: Case) -> Dict[str, Any]:
    """Run the case once under the counting mode: memory, FLOPs, bytes and
    collectives of rank 0."""
    mesh = case.mesh
    dims = {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}
    mode = _fake_mode_cls()(dims)
    with mode:
        args = tuple(_place(h, s) for h, s in zip(case.in_sh, case.args))
    arg_locals = [_local(t) for t in _flat(args)]
    arg_bytes = sum(t.untyped_storage().nbytes() for t in arg_locals)
    arg_keys = {id(t.untyped_storage()) for t in arg_locals}
    mode.reset()
    for t in arg_locals:
        mode.track(t)
    t0 = time.time()
    with mode, _HostWorkOutside():
        out = case.fn(*args)
    trace_s = time.time() - t0
    outs = [_local(t) for t in _flat(out) if isinstance(t, torch.Tensor)]
    seen, out_bytes, alias = set(), 0, 0
    for t in outs:
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        out_bytes += st.nbytes()
        if id(st) in arg_keys:
            alias += st.nbytes()
    peak = mode.peak
    colls = dict(mode.colls)
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "temp_bytes": peak - arg_bytes - out_bytes + alias,
            "peak_per_device": peak,
        },
        "flops": float(mode.flops),
        "bytes": float(mode.bytes),
        "colls": colls,
        "coll_counts": dict(mode.coll_counts),
        "coll_dims": dict(mode.coll_dims),
    }


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def world_size(mesh_kind: str) -> int:
    return 512 if mesh_kind == "multi" else 256


@contextlib.contextmanager
def fake_world(mesh_kind: str):
    """A ``fake`` process group of the mesh's world size for the body, this
    process rank 0; an already initialised group of that size is used as
    it is."""
    import torch.distributed as dist

    n = world_size(mesh_kind)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is initialised; the cell needs {n}")
        yield
        return
    dist.init_process_group("fake", store=_fake_store(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_store():
    """A store for the ``fake`` backend, which never reads it (a
    ``HashStore`` of this process), after registering that backend if
    no one has: torch's ``FakeProcessGroup`` hallucinates every
    collective, so one process stands for every rank."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup

    if "FAKE" not in getattr(dist.Backend, "_plugins", {}):
        def create(common_opts, backend_opts):
            return FakeProcessGroup._create_internal(
                common_opts.group_rank, common_opts.group_size, backend_opts)

        dist.Backend.register_backend(dist.Backend.FAKE, create,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])
    return dist.HashStore()


def cell_case(arch: str, shape_name: str, mesh_kind: str, *,
              cfg: Optional[ArchConfig] = None) -> Tuple[Case, int]:
    """The case :func:`run_cell` traces and the factor its counts are
    scaled by: under ``REPRO_FAST_ANALYSIS=1`` a train cell is one
    microbatch of ``global_batch / REPRO_NMB`` sequences, scaled by
    ``REPRO_NMB``, as the reference's ``"scaled-1pass"``; else the cell
    itself, 1.  Needs the cell's (fake) process group."""
    k = knobs()
    shape = get_shape(shape_name)
    multi_pod = mesh_kind == "multi"
    if shape.kind == "train" and k["fast_analysis"]:
        n_mb = k["n_microbatches"]
        per_mb = max(1, shape.global_batch // n_mb)
        return build_case(arch, shape_name, multi_pod, 1, per_mb, cfg=cfg), n_mb
    return build_case(arch, shape_name, multi_pod, cfg=cfg), 1


def shard_bytes(case: Case) -> int:
    """The sum over a case's args of their local shard bytes, from
    ``NamedSharding.shard_shape``: what its record's ``argument_bytes``
    must be."""
    import math

    return sum(math.prod(sh.shard_shape(tuple(st.shape))) * st.element_size()
               for sh, st in zip(_flat(case.in_sh), _flat(case.args)))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = OUT_DIR, skip_analysis: bool = False, *,
             cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Build and trace one cell in a fake world of 256 (``single``) or 512
    (``multi``) ranks; write and return its record.  ``skip_analysis``
    keeps the memory and drops the counts, as the reference's flag keeps
    the compile and drops the unrolled passes."""
    rec: Dict[str, Any] = {"arch": arch if cfg is None else cfg.arch_id,
                           "shape": shape_name, "mesh": mesh_kind, "ok": False}
    t0 = time.time()
    try:
        with fake_world(mesh_kind):
            case, scale = cell_case(arch, shape_name, mesh_kind, cfg=cfg)
            res = trace_case(case)
        rec["trace_s"] = res["trace_s"]
        rec["memory"] = res["memory"]
        rec["ok"] = True
        if not skip_analysis:
            rec["analysis_mode"] = "scaled-1pass" if scale > 1 else "eager-1pass"
            rec["flops_per_device"] = res["flops"] * scale
            rec["bytes_per_device"] = res["bytes"] * scale
            rec["collectives"] = {c: b * scale for c, b in res["colls"].items()}
            rec["collective_counts"] = {c: n * scale
                                        for c, n in res["coll_counts"].items()}
            rec["collectives_by_mesh_dim"] = {c: b * scale
                                              for c, b in res["coll_dims"].items()}
            rec["collective_bytes_per_device"] = float(
                sum(rec["collectives"].values()))
    except Exception as e:  # noqa: BLE001 -- the record carries the failure
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["ok"] = False
    rec["total_s"] = round(time.time() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{rec['arch']}_{shape_name}_{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def cell_file(arch: str, shape_name: str, mesh_kind: str, *,
              reduced: bool = False) -> str:
    """A cell's record's file name (a reduced config's arch id ends in
    ``-smoke``)."""
    return f"{arch}{'-smoke' if reduced else ''}_{shape_name}_{mesh_kind}.json"


def all_cells(mesh_kinds=("single", "multi")) -> List[Tuple[str, str, str]]:
    cells = []
    for arch in list_archs(assigned_only=True):
        for shape in get_config(arch).shapes():
            for mk in mesh_kinds:
                cells.append((arch, shape.name, mk))
    return cells


def summary(rec: Dict[str, Any]) -> str:
    status = "OK" if rec["ok"] else f"FAIL: {rec.get('error')}"
    line = f"[{rec['arch']} x {rec['shape']} x {rec['mesh']}] {status} ({rec['total_s']}s)"
    if rec.get("ok") and "flops_per_device" in rec:
        line += (f"\n  peak/device: {rec['memory']['peak_per_device'] / 2**30:.2f} GiB, "
                 f"flops/device: {rec['flops_per_device']:.3e}, "
                 f"collective B/device: {rec['collective_bytes_per_device']:.3e}")
    return line


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    add_arguments(ap)
    return run(ap.parse_args(argv))


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-analysis", action="store_true",
                    help="memory only (no FLOP / collective counts)")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (tests, smoke runs)")


def run(args) -> int:
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape, or --all")
        ok = True
        cfg = get_config(args.arch).reduced() if args.reduced else None
        for mk in kinds:
            rec = run_cell(args.arch, args.shape, mk, args.out,
                           skip_analysis=args.skip_analysis, cfg=cfg)
            print(summary(rec), flush=True)
            ok = ok and rec["ok"]
        return 0 if ok else 1

    # orchestrate: one subprocess per cell (each its own fake world)
    cells = all_cells(tuple(kinds))
    if not args.force:
        cells = [c for c in cells if not os.path.exists(
            os.path.join(args.out, cell_file(*c, reduced=args.reduced)))]
    print(f"{len(cells)} cells to run, {args.jobs} parallel jobs", flush=True)
    procs: List[Tuple[subprocess.Popen, Tuple]] = []
    pending = list(cells)
    failures = []
    while pending or procs:
        while pending and len(procs) < args.jobs:
            cell = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                   "--out", args.out]
            cmd += ["--skip-analysis"] * args.skip_analysis + ["--reduced"] * args.reduced
            procs.append((subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL), cell))
        time.sleep(1)
        still = []
        for p, cell in procs:
            if p.poll() is None:
                still.append((p, cell))
                continue
            path = os.path.join(args.out, cell_file(*cell, reduced=args.reduced))
            ok = False
            if os.path.exists(path):
                with open(path) as f:
                    ok = json.load(f).get("ok", False)
            if not ok:
                failures.append(cell)
            print(f"  done {cell} -> {'OK' if ok else 'FAIL'}", flush=True)
        procs = still
    print(f"all cells done, failures={failures}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
