"""The port's launcher dry run of a pipelined multi-pod train cell on the
reduced dense config (minitron-8b), with ``REPRO_NMB=2``: the reference's
pipeline over ``pod`` (``make_pipeline_train_step(abstract=True)``), two
stages on the ``(2, 16, 16)`` mesh, each traced at its own rank in a fake
world of 512 ranks of its own (rank 0 runs stage 0, rank 256 stage 1),
under ``FakeTensorMode``: nothing is allocated.

- both stages come back ``ok``, at ranks 0 and 256, and no process group
  is left;
- each stage's argument bytes equal the local shard bytes of its case
  (``dryrun.shard_bytes``), and its params and AdamW state, updated in
  place, alias exactly their shard bytes;
- ``collective_permute@pod`` is the pipeline's own traffic, counted from
  its ``torch.distributed`` sends and receives: ``n_mb`` carries forward
  and ``n_mb`` cotangents back, each the carry's local bytes at the stage
  boundary's placements; the loss sums, shared gradients and norm count
  as ``all_reduce@pod``; ``REPRO_FAST_ANALYSIS=1`` scales one microbatch
  to the same permute bytes;
- the record's top-level fields are the larger stage's, taken whole, and
  obey the peak identity;
- a single-pod train cell moves nothing over ``pod`` (the cells that were
  traced before keep their counts);
- ``abstract=True`` builds ``meta`` structs and fits its shardings, where
  the placed mesh path refuses a dim its axes do not divide.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves

torch.set_num_threads(1)

DENSE = get_config("minitron-8b").reduced()
N_MB = 2


@pytest.fixture(autouse=True)
def two_microbatches(monkeypatch):
    monkeypatch.setenv("REPRO_NMB", str(N_MB))


@pytest.fixture(scope="module")
def rec():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_NMB", str(N_MB))
        return D.run_cell("minitron-8b", "train_4k", "multi", None, cfg=DENSE)


def carry_bytes(cfg, global_batch, n_mb):
    """A dense carry's local bytes at the stage boundary: the residual
    stream ``(rows, seq, d_model)`` of one microbatch, f32, its rows over
    the 16-way ``data`` dim (``train_act_rules``' ``batch``)."""
    rows = global_batch // n_mb
    assert rows % 16 == 0
    return rows // 16 * get_shape("train_4k").seq_len * cfg.d_model * 4


def test_both_stages_are_ok_at_their_own_ranks(rec):
    assert rec["ok"], rec.get("traceback")
    assert [(s["stage"], s["rank"]) for s in rec["stages"]] == [(0, 0), (1, 256)]
    assert not dist.is_initialized()            # each stage's world is gone


def test_each_stage_holds_its_shards(rec):
    for stage in rec["stages"]:
        with D.fake_world("multi", stage["rank"]):
            case = D.cell_case("minitron-8b", "train_4k", "multi", cfg=DENSE)[0]
            want = D.shard_bytes(case)
            staged, shared, consts, opt, batch = (
                D.shard_bytes(dataclasses.replace(case, args=(a,), in_sh=(h,)))
                for a, h in zip(case.args, case.in_sh))
        mem = stage["memory"]
        assert mem["argument_bytes"] == want > 0
        assert want == staged + shared + consts + opt + batch
        # params and AdamW state are updated in place; consts and batch not
        assert mem["alias_bytes"] == staged + shared + opt
        assert mem["alias_bytes"] > 0.9 * (want - consts - batch)


def test_the_pod_carries_two_carries_per_microbatch(rec):
    carry = carry_bytes(DENSE, get_shape("train_4k").global_batch, N_MB)
    for stage in rec["stages"]:
        by_dim = stage["collectives_by_mesh_dim"]
        assert by_dim["collective_permute@pod"] == 2 * N_MB * carry
        assert stage["collective_counts"]["collective_permute"] == 2 * N_MB
        assert by_dim["all_reduce@pod"] > 0     # loss sums, shared grads, norm
        assert not [k for k in by_dim if k.endswith("@pod")
                    and not k.startswith(("collective_permute", "all_reduce"))]


def test_top_level_is_the_larger_stage(rec):
    big = max(rec["stages"], key=lambda s: s["memory"]["peak_per_device"])
    for key, value in big.items():
        if key not in ("stage", "rank"):
            assert rec[key] == value, key
    mem = rec["memory"]
    assert mem["peak_per_device"] == (mem["argument_bytes"] + mem["output_bytes"]
                                      + mem["temp_bytes"] - mem["alias_bytes"])
    assert rec["collective_bytes_per_device"] == sum(rec["collectives"].values())


def test_fast_analysis_scales_one_microbatch_to_the_same_sends(monkeypatch, rec):
    monkeypatch.setenv("REPRO_FAST_ANALYSIS", "1")
    fast = D.run_cell("minitron-8b", "train_4k", "multi", None, cfg=DENSE)
    assert fast["ok"], fast.get("traceback")
    assert fast["analysis_mode"] == "scaled-1pass" and len(fast["stages"]) == 2
    for f, s in zip(fast["stages"], rec["stages"]):
        assert f["collectives_by_mesh_dim"]["collective_permute@pod"] == \
            s["collectives_by_mesh_dim"]["collective_permute@pod"]
    assert not dist.is_initialized()


def test_a_single_pod_train_cell_moves_nothing_over_pod():
    rec = D.run_cell("minitron-8b", "train_4k", "single", None, cfg=DENSE)
    assert rec["ok"], rec.get("traceback")
    assert "stages" not in rec
    assert not [k for k in rec["collectives_by_mesh_dim"] if "@pod" in k]
    assert "collective_permute" not in rec["collectives"]


def test_fake_world_refuses_a_group_at_another_rank():
    with D.fake_world("multi", 256):
        with pytest.raises(RuntimeError, match="needs rank 0 of 512"):
            with D.fake_world("multi"):
                pass
        with D.fake_world("multi", 256):    # the same rank: used as it is
            assert dist.get_rank() == 256
    assert not dist.is_initialized()


def test_abstract_staging_is_meta_and_fitted():
    """``abstract=True`` (zamba2 reduced: its padded units' last dim, 296,
    does not divide the 16-way ``model`` dim) gives whole ``meta``
    structs, two stages leading, and the rules' shardings unfitted, as the
    reference's; the dry run's case fits them to the structs (its
    ``in_sh``), where the same specs unfitted are refused, as the placed
    mesh path (``place_stage``) refuses them."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import make_pipeline_train_step

    cfg = get_config("zamba2-7b").reduced()
    with D.fake_world("multi"):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        kw = dict(n_stages=2, n_microbatches=2, use_kernels=False,
                  device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="pass no params"):
            make_pipeline_train_step(cfg, OptimizerConfig(), abstract=True,
                                     params={}, **kw)
        _, staging, _, sh = make_pipeline_train_step(
            cfg, OptimizerConfig(), abstract=True, **kw)
        case, _ = D.cell_case(cfg.arch_id, "train_4k", "multi", cfg=cfg)
        refused = 0
        for i, name in enumerate(("staged", "shared", "consts")):
            structs = tree_leaves(getattr(staging, name))
            assert all(x.is_meta for x in structs), name
            assert [tuple(x.shape) for x in tree_leaves(case.args[i])] == \
                [tuple(x.shape) for x in structs], name
            for x, rule, placed, spec in zip(
                    structs, tree_leaves(sh[name]), tree_leaves(case.in_sh[i]),
                    tree_leaves(sh[f"{name}_specs"])):
                if name != "shared":
                    assert x.shape[0] == 2 and spec[0] == "pod"
                assert rule.spec == shd.NamedSharding(mesh, spec).spec
                assert placed.spec == shd.fit_spec(mesh, spec, x.shape)
                placed.shard_shape(tuple(x.shape))
                try:
                    rule.shard_shape(tuple(x.shape))
                except ValueError:
                    refused += 1
        assert refused > 0
    assert not dist.is_initialized()
