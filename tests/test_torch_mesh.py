"""The port's device meshes and placements (``repro_torch.parallel.sharding``,
``train.step``, ``checkpoint.ckpt.reshard``, ``Executable.stage_mesh``,
``launch.mesh``) against the JAX package's, on the CPU.

The meshes are real ``DeviceMesh`` objects over torch's in-process ``fake``
process group (``FakeStore``, world 256 and 512, destroyed in the fixture's
teardown): the production (16, 16) ``("data", "model")`` and (2, 16, 16)
``("pod", "data", "model")`` meshes, on which DTensors get their local
shapes without a collective moving data.  The reference's side runs on its
tests' ``FakeMesh`` stand-in (``tests/test_substrate.py``) and on jax's
``AbstractMesh`` of the same shape, whose ``NamedSharding.shard_shape`` is
the reference's shard shape.  Every comparison is exact: specs entry by
entry, shapes integer for integer.  The two-rank gloo checks are in
``test_torch_mesh_gloo.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import api as R
from repro.configs import get_config as jax_config
from repro.core import cluster as RC
from repro.core.dp_search import SearchConfig as RSearchConfig
from repro.core.planner import PlannerConfig as RPlannerConfig
from repro.core.strategy import IntraOpPlan as RIntraOpPlan
from repro.models import build_model as jax_build, param_specs
from repro.parallel import sharding as jax_shd
from repro.parallel.staging import build_staging as jax_staging
from repro.train import step as jax_step
from repro.train.optimizer import OptimizerConfig as ROptimizerConfig
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch import api as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, list_archs
from repro_torch.core import cluster as TC
from repro_torch.core.dp_search import SearchConfig as TSearchConfig
from repro_torch.core.planner import PlannerConfig as TPlannerConfig
from repro_torch.core.strategy import IntraOpPlan
from repro_torch.device import generator
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import LocalTransport
from repro_torch.parallel.staging import build_staging
from repro_torch.train import step as port_step
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

import torch_pipeline_parity as pp

torch.set_num_threads(1)

FAMILY_ARCH = {}
for _a in list_archs():
    FAMILY_ARCH.setdefault(get_config(_a).family, _a)


class FakeMesh:
    """The reference's tests' mesh stand-in: axis names and a devices array."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.zeros(shape)


@pytest.fixture(scope="module", params=[256, 512], ids=["16x16", "2x16x16"])
def mesh(request):
    """The production mesh of a fake world of 256 or 512 ranks (this
    process is rank 0)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=request.param)
    try:
        yield make_production_mesh(multi_pod=request.param == 512,
                                   device_type="cpu")
    finally:
        dist.destroy_process_group()


def _ref_meshes(mesh):
    shape, names = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    return FakeMesh(shape, names), AbstractMesh(shape, names)


def _meta(x):
    return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's own full-width param tree, as meta tensors."""
    model = build_model(get_config(arch), device="cpu")
    with FakeTensorMode():
        params = model.init(generator(model.device, 0))
    return port_step.tree_map(_meta, params)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return param_specs(jax_config(arch))


def _spec_items(tree):
    """{"a.b": spec tuple} of a reference spec / sharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, JaxNamedSharding)))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            tuple(v.spec if isinstance(v, JaxNamedSharding) else v)
            for path, v in flat}


def _expected_placements(spec, names):
    """The placements a fitted spec must give: Shard(d) on exactly the mesh
    dims that its entry d names."""
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _hold_fitted(mesh, port_tree, ref_tree, port_specs, ref_specs):
    """Fitted specs, placements and DTensor local shapes of every leaf,
    against the reference's ``fit_spec`` and shard shapes."""
    fake, abstract = _ref_meshes(mesh)
    names = list(mesh.mesh_dim_names)
    shardings = pp.items(shd.fitted_shardings(mesh, port_specs, port_tree))
    leaves, ref_leaves = pp.items(port_tree), pp.items(ref_tree)
    ref_specs = _spec_items(ref_specs)
    assert sorted(shardings) == sorted(ref_specs) == sorted(ref_leaves)
    n_sharded = 0
    for k, s in shardings.items():
        shape = tuple(ref_leaves[k].shape)
        assert tuple(leaves[k].shape) == shape, k
        want = tuple(jax_shd.fit_spec(fake, P(*ref_specs[k]), shape))
        assert s.spec == want, k
        placements = s.placements()
        assert placements == _expected_placements(want, names), k
        local = tuple(s.distribute(leaves[k]).to_local().shape)
        assert local == s.shard_shape(shape) == \
            JaxNamedSharding(abstract, P(*want)).shard_shape(shape), k
        n_sharded += any(isinstance(p, Shard) for p in placements)
    return n_sharded


# --- meshes -----------------------------------------------------------------


def test_production_mesh_shapes(mesh):
    multi = mesh.size() == 512
    assert tuple(mesh.shape) == ((2, 16, 16) if multi else (16, 16))
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi
                                   else ("data", "model"))
    assert mesh.device_type == "cpu"
    np.testing.assert_array_equal(mesh.mesh.numpy(),
                                  np.arange(mesh.size()).reshape(mesh.shape))


PLANS = [dict(tp=1, dp=1, shard_ratios=(1.0,)),
         dict(tp=2, dp=4, shard_ratios=(0.1, 0.2, 0.3, 0.4)),
         dict(tp=8, dp=2, shard_ratios=(0.5, 0.5)),
         dict(tp=16, dp=16, shard_ratios=(1 / 16,) * 16)]


def _plans(kw):
    common = dict(axis="data", comm_bytes=0.0, comm_time_f=0.0, comm_time_b=0.0)
    return IntraOpPlan(**common, **kw), RIntraOpPlan(**common, **kw)


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: f"tp{kw['tp']}dp{kw['dp']}")
def test_mesh_from_intra_op_follows_the_reference_layout(mesh, kw):
    plan, ref = _plans(kw)
    world = mesh.size()
    # an order that is not the identity: data shard i must run on
    # devices[i*tp:(i+1)*tp] whatever the order
    devices = [int(r) for r in np.random.default_rng(kw["tp"]).permutation(world)]
    axes = jax_shd.intra_op_mesh_axes(ref)
    m = shd.mesh_from_intra_op(plan, devices, device_type="cpu")
    assert tuple(m.mesh_dim_names) == tuple(n for n, _ in axes)
    assert tuple(m.shape) == tuple(s for _, s in axes)
    for i in range(plan.dp):
        assert m.mesh[i].tolist() == devices[i * plan.tp:(i + 1) * plan.tp]
    default = shd.mesh_from_intra_op(plan, device_type="cpu")
    np.testing.assert_array_equal(default.mesh.numpy(),
                                  np.arange(plan.n_devices).reshape(m.shape))
    if plan.dp % 2 == 0:
        axes = jax_shd.hierarchical_sync_axes(ref, 2)
        h = shd.mesh_from_intra_op(plan, devices, hierarchy_nodes=2,
                                   device_type="cpu")
        assert tuple(h.mesh_dim_names) == tuple(n for n, _ in axes)
        assert tuple(h.shape) == tuple(s for _, s in axes)
        np.testing.assert_array_equal(
            h.mesh.numpy(),
            np.asarray(devices[:plan.n_devices]).reshape(h.shape))


def test_mesh_from_intra_op_refuses_too_few_ranks_as_the_reference_does(mesh):
    plan, ref = _plans(PLANS[1])
    with pytest.raises(ValueError) as want:
        jax_shd.mesh_from_intra_op(ref)          # jax has one CPU device here
    with pytest.raises(ValueError) as got:
        shd.mesh_from_intra_op(plan, [0], device_type="cpu")
    assert str(got.value) == str(want.value)


# --- partition specs and placements --------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_param_placements_match_reference_shard_shapes(mesh, arch):
    params = _port_params(arch)
    ref = _ref_params(arch)
    n = _hold_fitted(mesh, params, ref, shd.param_pspecs(params),
                     jax_shd.param_pspecs(ref))
    assert n > 0


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_cache_placements_match_reference(mesh, family, batch):
    arch = FAMILY_ARCH[family]
    seq = 1024
    multi = "pod" in mesh.mesh_dim_names
    model = build_model(get_config(arch), device="cpu")
    with FakeTensorMode():
        cache = model.init_cache(batch, seq)
    cache = port_step.tree_map(_meta, cache)
    jmodel = jax_build(jax_config(arch))
    ref = jax.eval_shape(lambda: jmodel.init_cache(batch, seq))
    for rules, ref_rules in (
            (shd.prefill_act_rules(multi), jax_shd.prefill_act_rules(multi)),
            (shd.decode_act_rules(batch, multi),
             jax_shd.decode_act_rules(batch, multi))):
        assert rules == ref_rules
        specs = shd.cache_pspecs(cache, rules)
        ref_specs = jax_shd.cache_pspecs(ref, ref_rules)
        assert pp.items(specs) == _spec_items(ref_specs)
        _hold_fitted(mesh, cache, ref, specs, ref_specs)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_act_rules_equal_reference(multi_pod):
    assert shd.prefill_act_rules(multi_pod) == jax_shd.prefill_act_rules(multi_pod)
    for batch in (1, 8, 15, 16, 64):
        assert shd.decode_act_rules(batch, multi_pod) == \
            jax_shd.decode_act_rules(batch, multi_pod)


def test_fit_spec_on_the_reference_fake_mesh():
    """The reference's own case (tests/test_substrate.py), on the port."""
    fake = FakeMesh((16, 16), ("data", "model"))
    spec = shd.fit_spec(fake, ("model", "data"), (50280, 2560))
    assert spec == (None, "data")      # 50280 % 16 != 0 -> replicated
    assert spec == tuple(jax_shd.fit_spec(fake, P("model", "data"), (50280, 2560)))


def test_an_uneven_split_and_an_out_of_order_entry_raise(mesh):
    names = mesh.mesh_dim_names
    batch_axes = ("pod", "data") if "pod" in names else "data"
    uneven = shd.NamedSharding(mesh, (batch_axes, None))
    with pytest.raises(ValueError, match="does not divide"):
        uneven.shard_shape((8, 1024))
    with pytest.raises(ValueError, match="does not divide"):
        uneven.distribute(torch.empty(8, 1024, device="meta"))
    fitted = shd.NamedSharding(mesh, shd.fit_spec(mesh, (batch_axes, None), (8, 1024)))
    fake, abstract = _ref_meshes(mesh)
    want = tuple(jax_shd.fit_spec(fake, P(batch_axes, None), (8, 1024)))
    assert fitted.spec == want == (("pod", None) if "pod" in names else (None, None))
    local = fitted.distribute(torch.empty(8, 1024, device="meta")).to_local().shape
    assert tuple(local) == JaxNamedSharding(abstract, P(*want)).shard_shape((8, 1024))
    with pytest.raises(ValueError, match="mesh's axis order"):
        shd.NamedSharding(mesh, (("model", "data"), None)).placements()
    with pytest.raises(ValueError, match="not one of the mesh's"):
        shd.NamedSharding(mesh, ("expert", None)).placements()


def test_train_shardings_and_batch_specs_equal_reference(mesh):
    cfg, jcfg = get_config("gpt-2b"), jax_config("gpt-2b")
    _, abstract = _ref_meshes(mesh)
    opt_init, _ = make_optimizer(OptimizerConfig())
    pshard, oshard = port_step.train_shardings(
        cfg, mesh, opt_init, build_model(cfg, device="cpu"))
    jinit, _ = jax_make_optimizer(ROptimizerConfig())
    rp, ro = jax_step.train_shardings(jcfg, abstract, jinit, jax_build(jcfg))
    want = _spec_items(rp)
    assert {k: s.spec for k, s in pp.items(pshard).items()} == want
    assert type(oshard).__name__ == type(ro).__name__ == "OptState"
    assert oshard.step.spec == tuple(ro.step.spec) == ()
    assert oshard.step.placements() == (Replicate(),) * len(mesh.shape)
    for name in ("mu", "nu"):
        assert {k: s.spec for k, s in pp.items(getattr(oshard, name)).items()} == \
            _spec_items(getattr(ro, name)) == want
    assert oshard.master is None and ro.master is None
    batch = {"tokens": np.zeros((8, 1024)), "labels": np.zeros((8, 1024)),
             "frames": np.zeros((8, 1500, 1024))}
    for axes in (("data",), ("pod", "data")):
        assert port_step.batch_pspecs(batch, axes) == {
            k: tuple(v) for k, v in jax_step.batch_pspecs(batch, axes).items()}


def test_pipeline_shardings_on_a_mesh_equal_reference(mesh):
    jcfg, cfg = jax_config("gpt-2b"), get_config("gpt-2b")
    shapes = _ref_params("gpt-2b")
    staging = build_staging(cfg, 2, _port_params("gpt-2b"))
    port = port_step.pipeline_shardings(staging, mesh)
    if "pod" not in mesh.mesh_dim_names:
        with pytest.raises(ValueError, match="not one of the mesh's"):
            next(iter(pp.items(port["staged"]).values())).placements()
        return
    _, abstract = _ref_meshes(mesh)
    ref = jax_step.pipeline_shardings(jax_staging(jcfg, 2, shapes), abstract)
    assert sorted(port) == sorted(ref)
    for name in ("staged", "shared", "consts"):
        want = _spec_items(ref[f"{name}_specs"])
        assert pp.items(port[f"{name}_specs"]) == want, name
        assert {k: s.spec for k, s in pp.items(port[name]).items()} == \
            _spec_items(ref[name]) == want, name
    for k, s in pp.items(port["staged"]).items():
        assert s.placements()[0] == Shard(0), k          # the stage dim on pod


def test_pipeline_step_takes_a_mesh_or_a_transport_not_both(mesh):
    """Also refused: a mesh whose ``data`` or ``model`` dim would shard a
    stage (each rank runs its stage whole until sharded execution lands),
    and one without a ``pod`` dim."""
    kw = dict(n_stages=2, n_microbatches=2, device="cpu")
    cfg = get_config("gpt-2b").reduced()
    with pytest.raises(ValueError, match="a mesh or a transport, not both"):
        port_step.make_pipeline_train_step(
            cfg, OptimizerConfig(), **kw, mesh=mesh, transport=LocalTransport())
    want = ("would shard a stage" if "pod" in mesh.mesh_dim_names
            else "has no 'pod' dim")
    with pytest.raises(ValueError, match=want):
        port_step.make_pipeline_train_step(cfg, OptimizerConfig(), **kw, mesh=mesh)


# --- ckpt.reshard ------------------------------------------------------------------


def test_reshard_to_devices(tmp_path):
    """tests/test_substrate.py's case: save, restore, place on the CPU."""
    tree = {"a": np.arange(8).astype(np.float32)}
    ckpt.save(str(tmp_path), 1, tree)
    _, restored, _ = ckpt.restore(str(tmp_path), tree)
    placed = ckpt.reshard(restored, {"a": torch.device("cpu")})
    np.testing.assert_array_equal(placed["a"].numpy(), tree["a"])


def test_reshard_places_on_new_shardings():
    """tests/test_checkpoint.py's case: a tree with a list and a scalar."""
    t = {"params": {"dense": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                              "b": np.zeros(4, dtype=np.float32)},
                    "scale": np.float32(2.5)},
         "opt": [np.ones(5, dtype=np.float32), np.full(5, 7, dtype=np.int32)]}
    cpu = torch.device("cpu")
    shardings = {"params": {"dense": {"w": cpu, "b": cpu}, "scale": cpu},
                 "opt": [cpu, cpu]}
    placed = ckpt.reshard(t, shardings)
    assert isinstance(placed["opt"], list)
    for (k, got), (_, want) in zip(sorted(pp.items(placed["params"]).items()),
                                   sorted(pp.items(t["params"]).items())):
        assert isinstance(got, torch.Tensor), k
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(placed["opt"], t["opt"]):
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_reshard_onto_a_mesh_gives_rank_zero_its_shard(mesh):
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    n = 32 if "pod" in mesh.mesh_dim_names else 16
    placed = ckpt.reshard({"x": x, "y": x},
                          {"x": shd.NamedSharding(mesh, (axes, None)),
                           "y": shd.NamedSharding(mesh, (None, None))})
    np.testing.assert_array_equal(placed["x"].to_local().numpy(), x[:64 // n])
    np.testing.assert_array_equal(placed["y"].to_local().numpy(), x)
    assert tuple(placed["x"].shape) == (64, 3)
    with pytest.raises(ValueError, match=r"differ at the root: keys \['x', 'z'\]"):
        ckpt.reshard({"x": x, "z": x}, {"x": torch.device("cpu"),
                                        "y": torch.device("cpu")})
    with pytest.raises(ValueError, match="does not divide"):
        ckpt.reshard({"x": x[:3]}, {"x": shd.NamedSharding(mesh, (axes, None))})


# --- Executable.stage_mesh -------------------------------------------------------


def _one_card(C):
    return C.HeteroCluster(subclusters=(C.SubCluster(
        "meshA100x1", 1, 1, C.A100_40G, 300e9, 200 * C.GBPS),), cross_bw=5 * C.GBPS)


@functools.lru_cache(maxsize=None)
def _degree_one_executables():
    """(reference, port) executables of granite-moe on one A100: one stage,
    tp = dp = 1."""
    arch = "granite-moe-1b-a400m"
    return (R.compile(arch, _one_card(RC), R.HarpConfig(seq_len=1024, global_batch=8)),
            T.compile(arch, _one_card(TC), T.HarpConfig(seq_len=1024, global_batch=8)))


def test_stage_mesh_builds_the_reference_mesh_of_a_degree_one_plan(mesh):
    ref, exe = _degree_one_executables()
    rm = ref.stage_mesh(0)
    m = exe.stage_mesh(0, device_type="cpu")
    assert dict(zip(m.mesh_dim_names, m.shape)) == dict(rm.shape) == \
        {"data": 1, "model": 1}
    assert m.mesh.tolist() == [[0]]
    assert exe.stage_mesh(0, [7], device_type="cpu").mesh.tolist() == [[7]]


def test_stage_mesh_raises_on_too_few_ranks_as_the_reference_does(mesh):
    ref, exe = _degree_one_executables()
    with pytest.raises(ValueError) as want:
        ref.stage_mesh(0, [])
    with pytest.raises(ValueError) as got:
        exe.stage_mesh(0, [], device_type="cpu")
    assert str(got.value) == str(want.value) == \
        "plan needs 1 devices (tp=1 x dp=1), got 0"


def test_tmax_rounding_fault_of_the_reference_planner_is_pinned():
    """The reference's HAPT search rounds its t_max candidates to the
    nearest of ``tmax_round_digits`` (4) significant digits, so where the
    only feasible strategy is one stage whose time rounds down, it reports
    the cluster infeasible; 17 digits (exact candidates) find that stage.  The port's planner
    is a verbatim copy and does the same (ROADMAP.md, Queue 3)."""
    arch, cfg = "granite-moe-1b-a400m", dict(seq_len=128, global_batch=8)
    for api, C, planner, search in ((R, RC, RPlannerConfig, RSearchConfig),
                                    (T, TC, TPlannerConfig, TSearchConfig)):
        with pytest.raises(RuntimeError, match="infeasible even at largest t_max"):
            api.compile(arch, _one_card(C), api.HarpConfig(**cfg))
        exe = api.compile(arch, _one_card(C), api.HarpConfig(
            **cfg, planner=planner(search=search(tmax_round_digits=17))))
        assert [(s.tp, s.dp) for s in exe.strategy.stages] == [(1, 1)]
