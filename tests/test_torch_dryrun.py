"""The port's launcher dry run (``repro_torch.launch.dryrun``) on reduced
dense configs, in torch's in-process ``fake`` process group of 256 ranks
(the ``single`` mesh, (16, 16)) and 512 (``multi``, (2, 16, 16)), every
step traced under ``FakeTensorMode``: nothing is allocated.

- train, prefill and decode come back ``ok`` on the single mesh, prefill
  and decode on the multi-pod mesh too;
- each record's argument bytes equal the sum of its leaves' local shard
  bytes (``NamedSharding.shard_shape`` of every arg of ``build_case``);
- the train cell records the gradient's collectives over ``data``: a
  reduce-scatter for the FSDP-sharded params and an all-reduce for the
  replicated ones, once per step (``train.step.make_train_step``);
- for a dense config whose widths divide the mesh, the per-device FLOPs of
  the prefill cell times 256 equal the same step's FLOPs on a 1 x 1 mesh
  (the whole step on one rank) within 1 %;
- a pipelined multi-pod train cell comes back ``ok: false`` with an error
  naming ROADMAP.md Queue 1 item 8, and no record of a fallback layout;
- a kernel entry point handed a DTensor raises, where it would otherwise
  take the plain version of a CPU tensor.

Train cells run 2 microbatches (``REPRO_NMB=2``, the reference's knob) to
stay inside the file's time.  The families' cells are in
``test_torch_dryrun_families.py``.
"""
import dataclasses
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.optimizer import OptState

torch.set_num_threads(1)

DENSE = get_config("minitron-8b").reduced()
# widths that divide the 16-way model dim, so every product shards evenly
EVEN = dataclasses.replace(DENSE, n_heads=16, n_kv_heads=16, head_dim=16,
                           d_model=256, d_ff=512, vocab_size=1024)


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", "2")


def expected_args(shape, mesh_kind, cfg):
    """Sum of the local shard bytes of every arg of the cell's case."""
    with D.fake_world(mesh_kind):
        case = D.cell_case(cfg.arch_id, shape, mesh_kind, cfg=cfg)[0]
    total = 0
    for sh, st in zip(D._flat(case.in_sh), D._flat(case.args)):
        total += math.prod(sh.shard_shape(tuple(st.shape))) * st.element_size()
    return total


@pytest.mark.parametrize("shape,mesh_kind", [
    ("train_4k", "single"), ("prefill_32k", "single"), ("decode_32k", "single"),
    ("prefill_32k", "multi"), ("decode_32k", "multi")])
def test_dense_cells_are_ok_and_hold_their_shards(shape, mesh_kind, tmp_path):
    rec = D.run_cell("minitron-8b", shape, mesh_kind, str(tmp_path), cfg=DENSE)
    assert rec["ok"], rec.get("traceback")
    assert (tmp_path / f"minitron-8b-smoke_{shape}_{mesh_kind}.json").exists()
    mem = rec["memory"]
    assert mem["argument_bytes"] == expected_args(shape, mesh_kind, DENSE)
    assert mem["peak_per_device"] == (mem["argument_bytes"] + mem["output_bytes"]
                                      + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["peak_per_device"] >= mem["argument_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["analysis_mode"] == "eager-1pass"
    assert not dist.is_initialized()           # the cell's world is gone
    if shape == "train_4k":
        # params and AdamW state are updated in place: they alias
        assert mem["alias_bytes"] > 0.9 * mem["argument_bytes"] - 2 ** 20
        by_dim = rec["collectives_by_mesh_dim"]
        assert by_dim.get("reduce_scatter_tensor@data", 0) > 0
        assert by_dim.get("all_reduce@data", 0) > 0
    if shape == "decode_32k":
        assert mem["alias_bytes"] > 0           # the cache is written in place


def test_prefill_flops_shard_over_256_ranks(monkeypatch):
    sharded = D.run_cell("minitron-8b", "prefill_32k", "single", None, cfg=EVEN)
    assert sharded["ok"], sharded.get("traceback")

    dist.init_process_group("fake", store=D._fake_store(), rank=0, world_size=1)
    try:
        monkeypatch.setattr(D, "make_production_mesh", lambda **kw: make_mesh(
            (1, 1), ("data", "model"), device_type="cpu"))
        whole = D.trace_case(D.build_case("minitron-8b", "prefill_32k", False,
                                          cfg=EVEN))
    finally:
        dist.destroy_process_group()
    ratio = sharded["flops_per_device"] * 256 / whole["flops"]
    assert abs(ratio - 1) < 0.01, ratio


def test_fast_analysis_scales_one_microbatch(monkeypatch):
    """``REPRO_FAST_ANALYSIS=1``: a train cell traces one microbatch of
    ``global_batch / REPRO_NMB`` sequences and scales its counts by
    ``REPRO_NMB``, as the reference's ``"scaled-1pass"``."""
    monkeypatch.setenv("REPRO_FAST_ANALYSIS", "1")
    rec = D.run_cell("minitron-8b", "train_4k", "single", None, cfg=DENSE)
    assert rec["ok"], rec.get("traceback")
    assert rec["analysis_mode"] == "scaled-1pass"
    assert rec["memory"]["argument_bytes"] == expected_args("train_4k", "single", DENSE)
    assert all(n % 2 == 0 for n in rec["collective_counts"].values())


def test_pipelined_multi_pod_train_cell_names_item_8(tmp_path):
    rec = D.run_cell("minitron-8b", "train_4k", "multi", str(tmp_path), cfg=DENSE)
    assert rec["ok"] is False
    assert "Queue 1 item 8" in rec["error"] and "memory" not in rec


def test_all_cells_are_the_assigned_archs_shapes_and_meshes():
    cells = D.all_cells()
    assert len(cells) == 66 and len(D.all_cells(("single",))) == 33
    assert ("mamba2-2.7b", "long_500k", "multi") in cells
    multi_train = [a for a, s, m in cells if m == "multi" and s == "train_4k"]
    assert len(multi_train) == 10 and "whisper-medium" in multi_train


def test_knobs_keep_the_references_names_and_defaults(monkeypatch):
    for name in ("REPRO_NMB", "REPRO_ZERO1", "REPRO_FSDP", "REPRO_ACT_BF16",
                 "REPRO_FLATDP", "REPRO_MASTER", "REPRO_FAST_ANALYSIS"):
        monkeypatch.delenv(name, raising=False)
    assert D.knobs() == {"n_microbatches": 16, "zero1": True, "fsdp_params": True,
                         "act_bf16": False, "flat_dp": False,
                         "master_weights": False, "fast_analysis": False}


def test_master_weights_knob_places_an_f32_master(monkeypatch):
    monkeypatch.setenv("REPRO_MASTER", "1")
    with D.fake_world("single"):
        case = D.build_case("minitron-8b", "train_4k", False, cfg=DENSE)
    params, opt, _ = case.args
    assert isinstance(opt, OptState) and opt.master is not None
    assert params["embed"].dtype == torch.bfloat16
    assert opt.master["embed"].dtype == torch.float32
    assert opt.mu["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("op", ["flash_attention", "ssd_intra", "rmsnorm"])
def test_kernel_entry_points_refuse_dtensors(op):
    """A kernel handed a DTensor raises: it neither gathers the tensor nor
    takes the plain version, which a CPU tensor would."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import ops as kops

    dist.init_process_group("fake", store=D._fake_store(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device_type="cpu")
        dt = lambda *shape: DTensor.from_local(torch.zeros(shape), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            if op == "flash_attention":
                kops.flash_attention(dt(1, 8, 2, 16), dt(1, 8, 2, 16), dt(1, 8, 2, 16))
            elif op == "ssd_intra":
                kops.ssd_intra(dt(1, 2, 8, 2, 4), dt(1, 2, 8, 2), dt(1, 2, 8, 2),
                               dt(1, 2, 8, 4), dt(1, 2, 8, 4))
            else:
                kops.rmsnorm(dt(4, 16), dt(16))
    finally:
        dist.destroy_process_group()


def test_zero1_state_names_data_once_and_otherwise_follows_the_reference():
    """ZeRO-1's state specs (``layout_specs(fsdp_params=False)``).  The
    reference's launcher puts ``data`` on dim 0 of every state leaf whose
    rule leaves dim 0 whole (``repro/launch/dryrun.py:176-182``), so a
    stacked leaf whose rule names ``data`` on dim 1 names the axis twice,
    which a ``NamedSharding`` refuses wherever ``data`` divides the layer
    count.  The port keeps such a leaf's rule as it is (ROADMAP Queue 3);
    every other leaf's spec is the reference's."""
    from repro_torch.models.api import param_specs
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.step import layout_specs

    pspecs = shd.param_pspecs(param_specs(get_config("gpt-2b")))
    params, ours = layout_specs(pspecs, fsdp_params=False)
    ref = tree_map(lambda sp: tuple(("data" if e is None else e) if i == 0 else e
                                    for i, e in enumerate(sp)), pspecs)
    names = lambda sp: [a for e in sp for a in shd._entry_axes(e)]
    twice = 0
    for p, o, r, rule in zip(*(tree_leaves(t) for t in (params, ours, ref, pspecs))):
        assert "data" not in names(p)
        assert len(names(o)) == len(set(names(o))), o
        if len(names(r)) == len(set(names(r))):
            assert o == r
        else:
            twice += 1
            assert o == rule
    assert twice >= 5          # the stacked projections: wq, wk, wv, wo, mlp

