"""The port's kbench against the JAX package's, on the CPU: the harness's
inputs, FLOP formulas and shapes, the latency table read and written by
both packages, the bridge's measured MFU and fingerprint, and the harness
and autotuner running the plain versions when asked for the CPU.

Tables here are built by hand or collected on the CPU (``cpu:...:plain``):
no time in them is a device time.
"""
import numpy as np
import pytest
import torch

from repro.core import cluster as jax_cluster
from repro.kbench import bridge as jax_bridge
from repro.kbench import harness as jax_harness
from repro.kbench import table as jax_table
from repro_torch.core import cluster
from repro_torch.kbench import autotune, harness
from repro_torch.kbench.bridge import KBenchConfig, KBenchModel
from repro_torch.kbench.table import KernelMeasurement, LatencyTable
from repro_torch.kernels import LAUNCHES, ops

torch.set_num_threads(1)

H100_FP = "cuda:NVIDIA H100 80GB HBM3"


def _meas(device, op, shape, median_s, flops, blocks=None, at=1000.0):
    return KernelMeasurement(device=device, op=op, shape=tuple(shape),
                             median_s=median_s, trials=5, flops=flops,
                             blocks=blocks, collected_at=at, host="h1")


def _table():
    """Cells for a card fingerprint and for the A100 profile name."""
    return LatencyTable([
        _meas(H100_FP, "rmsnorm", (4096, 2048), 2.5e-5, 4.0 * 4096 * 2048, (64,)),
        _meas(H100_FP, "flash_attention", (2, 512, 512, 16, 16, 64), 3e-4,
              4.0 * 2 * 16 * 512 * 512 * 64 * 0.5, (32, 64)),
        _meas(H100_FP, "ssd_intra", (2, 4, 256, 8, 64, 128), 1e-4,
              2.0 * 2 * 4 * 8 * 256 * 256 * 192),
        _meas("A100-40G", "flash_attention", (2, 512, 512, 16, 16, 64), 1e-3,
              0.45 * 1e-3 * 312e12, (128, 128), at=900.0),
    ])


def _h100_subcluster(device_profile_cls, sub_cls, gbps):
    dev = device_profile_cls("H100-80G", 989e12, 80 * cluster.GB, 3.35e12)
    return sub_cls("meshH100", 1, 2, dev, 450e9, 200 * gbps)


# ---------------------------------------------------------------------------
# Harness: the same op registry as the reference
# ---------------------------------------------------------------------------


def test_op_names_shapes_and_flops_equal_the_reference():
    assert sorted(harness.OPS) == sorted(jax_harness.OPS)
    for name, spec in harness.OPS.items():
        ref = jax_harness.OPS[name]
        assert spec.tiny_shape == ref.tiny_shape
        assert spec.default_shape == ref.default_shape
        for shape in (spec.tiny_shape, spec.default_shape):
            assert spec.flops(shape) == ref.flops(shape)


@pytest.mark.parametrize("op", sorted(jax_harness.OPS))
@pytest.mark.parametrize("seed", [0, 3])
def test_input_makers_are_bit_equal_to_the_reference(op, seed):
    shape = harness.OPS[op].tiny_shape
    ours = harness.OPS[op].make_inputs(shape, seed)
    theirs = jax_harness.OPS[op].make_inputs(shape, seed)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_block_grids():
    """rmsnorm's and ssd's grids are the reference's; flash's is the tiles
    K1 takes at the shape, its default among them."""
    for name in ("rmsnorm", "ssd_intra"):
        spec, ref = harness.OPS[name], jax_harness.OPS[name]
        for shape in (spec.tiny_shape, spec.default_shape, (20, 64)):
            assert spec.block_grid(shape) == ref.block_grid(shape)
    assert harness.OPS["rmsnorm"].default_blocks((256, 128)) == (128,)
    assert harness.OPS["ssd_intra"].default_blocks((1, 2, 64, 2, 32, 32)) is None
    spec = harness.OPS["flash_attention"]
    for shape in (spec.tiny_shape, spec.default_shape, (8, 512, 512, 32, 32, 80),
                  (2, 512, 512, 8, 1, 256)):
        grid = spec.block_grid(shape)
        assert spec.default_blocks(shape) in grid
        assert all(bq <= 64 and bq % 4 == 0 and bk % 32 == 0 for bq, bk in grid)
    assert len(spec.block_grid((1, 8, 8, 1, 1, 256))) < 9   # shared memory


def test_a_block_config_k1_refuses_is_an_error():
    with pytest.raises(ValueError, match="block_q"):
        harness.bench_op("flash_attention", harness.OPS["flash_attention"].tiny_shape,
                         blocks=(128, 128), trials=1, warmup=1, run_device="cpu")


# ---------------------------------------------------------------------------
# Harness on the CPU (plain versions, only when asked)
# ---------------------------------------------------------------------------


def test_collect_on_the_cpu_runs_the_plain_versions_and_says_so():
    before = dict(LAUNCHES)
    t = harness.collect(["rmsnorm"], run_device="cpu", trials=3, warmup=1,
                        collected_at=5.0, host="hx")
    assert LAUNCHES == before
    (e,) = t.entries
    assert e.device.startswith("cpu:") and e.device.endswith(":plain")
    assert e.device == harness.device_fingerprint("cpu")
    assert (e.op, e.shape, e.blocks, e.trials) == ("rmsnorm", (256, 128), (128,), 3)
    assert e.median_s > 0 and e.flops == 4.0 * 256 * 128
    assert (e.collected_at, e.host) == (5.0, "hx")


def test_device_keyword_overrides_the_fingerprint_only():
    t = harness.collect(["ssd_intra"], run_device="cpu", trials=1, warmup=1,
                        device="gpu:override")
    assert [e.device for e in t.entries] == ["gpu:override"]


def test_collect_without_a_run_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="run_device='cpu'"):
        harness.collect(["rmsnorm"])
    with pytest.raises(RuntimeError, match="run_device='cpu'"):
        harness.collect(["rmsnorm"], device="cpu")   # a fingerprint, not a place
    with pytest.raises(RuntimeError):
        autotune.install(LatencyTable())


def test_autotune_on_the_cpu_installs_its_winners():
    fp = harness.device_fingerprint("cpu")
    try:
        table, sweeps = autotune.collect_autotuned(
            ["flash_attention", "rmsnorm", "ssd_intra"], run_device="cpu",
            trials=1, warmup=1)
        by_op = {s.op: s for s in sweeps}
        for s in sweeps:
            assert s.device == fp and s.speedup >= 1.0
            assert s.best_s == min(t for _, t in s.sweep)
            assert s.default_blocks in [b for b, _ in s.sweep]
        assert by_op["ssd_intra"].sweep[0][0] is None
        assert autotune.install(table, device=fp) == 2
        for op in ("flash_attention", "rmsnorm"):
            shape = harness.OPS[op].tiny_shape
            assert ops.tuned_blocks(op, shape) == by_op[op].best_blocks
            assert autotune.best_blocks(op, shape, fp, table) == by_op[op].best_blocks
        assert autotune.install(table, device="cuda:another card") == 0
    finally:
        ops.clear_tuned_blocks()


# ---------------------------------------------------------------------------
# Table and bridge: both packages read and price the same document
# ---------------------------------------------------------------------------


def test_port_table_loads_in_the_reference_and_back(tmp_path):
    t = _table().merge(harness.collect(["rmsnorm"], run_device="cpu",
                                       trials=1, warmup=1))
    path = str(tmp_path / "port.json")
    t.save(path)
    theirs = jax_table.LatencyTable.load(path)
    assert theirs.to_dict() == t.to_dict()
    assert theirs.fingerprint() == t.fingerprint()
    back = str(tmp_path / "ref.json")
    theirs.save(back)
    assert LatencyTable.load(back).to_dict() == t.to_dict()
    with open(path) as a, open(back) as b:
        assert a.read() == b.read()


def test_reference_collected_table_loads_in_the_port(tmp_path):
    t = jax_harness.collect(["rmsnorm"], trials=1, warmup=1, collected_at=2.0,
                            host="h")
    path = str(tmp_path / "ref.json")
    t.save(path)
    assert LatencyTable.load(path).to_dict() == t.to_dict()


@pytest.mark.parametrize("device_map", [None, {"H100-80G": H100_FP}])
def test_bridge_prices_the_same_in_both_packages(device_map):
    doc = _table().to_dict()
    ours = KBenchModel(KBenchConfig(table=doc, device_map=device_map))
    theirs = jax_bridge.KBenchModel(jax_bridge.KBenchConfig(
        table=doc, device_map=device_map))
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.covered_devices() == theirs.covered_devices()
    subs = [(a, b) for a, b in zip(cluster.paper_case_study_cluster().subclusters,
                                   jax_cluster.paper_case_study_cluster().subclusters)]
    subs.append((_h100_subcluster(cluster.DeviceProfile, cluster.SubCluster,
                                  cluster.GBPS),
                 _h100_subcluster(jax_cluster.DeviceProfile,
                                  jax_cluster.SubCluster, jax_cluster.GBPS)))
    for a, b in subs:
        assert ours.measured_mfu(a) == theirs.measured_mfu(b)
    h100 = subs[-1][0]
    assert (ours.measured_mfu(h100) is None) == (device_map is None)
    for dev, op, shape in (("H100-80G", "rmsnorm", (8192, 2560)),
                           ("A100-40G", "flash_attention", (8, 512, 512, 32, 32, 80)),
                           ("H100-80G", "ssd_intra", (8, 2, 256, 80, 64, 128))):
        assert ours.estimate_s(dev, op, shape) == theirs.estimate_s(dev, op, shape)


def test_h100_profile_is_the_data_sheet():
    p = cluster.DEVICE_PROFILES["H100-80G"]
    assert p is cluster.H100_80G
    assert (p.peak_flops, p.mem_bytes, p.hbm_bw) == (989e12, 80 * cluster.GB, 3.35e12)
    assert p.base_mfu == cluster.DeviceProfile("x", 1, 1, 1).base_mfu
    assert cluster.DEVICE_LINK_BW["H100-80G"] == 450e9
    # nothing else of the reference's profiles moved
    for name, ref in jax_cluster.DEVICE_PROFILES.items():
        assert cluster.DEVICE_PROFILES[name] == cluster.DeviceProfile(
            **ref.__dict__)
        assert cluster.DEVICE_LINK_BW[name] == jax_cluster.DEVICE_LINK_BW[name]
