"""``python -m repro_torch`` against ``python -m repro``, in process, on the
CPU: the files and the output each subcommand writes for the same
arguments.  ``plan`` (analytic and from a kbench table), ``simulate``,
``replay``, ``trace``, ``migrate`` and ``chaos replay`` give the same
artifacts and text (the controller's search clock is the same fake one on
both sides); ``kbench merge``/``show`` the same table bytes and listing;
``kbench collect --device cpu`` the reference's cells (timed on the plain
versions); ``train --plan ... --smoke --device cpu`` the reference's
checkpoint layout.  ``dryrun`` forwards to the port's launcher
(``test_torch_isolation.py``, ``test_torch_dryrun.py``).
"""
import json
import os

import numpy as np
import pytest

from repro.api.cli import main as ref_main
from repro_torch.api.cli import main as port_main
from torch_control_parity import cold_sim_memo, fake_clock  # noqa: F401

MAINS = {"ref": ref_main, "port": port_main}
PLAN_ARGS = ["--arch", "gpt-2b", "--cluster", "paper_case_study",
             "--seq-len", "512", "--global-batch", "16", "--granularity", "16",
             "--microbatches", "16"]
H100_FP = "cuda:NVIDIA H100 80GB HBM3"


def run_both(capsys, args_of):
    """Run ``args_of(side)`` through each CLI; returns side -> stdout."""
    out = {}
    for side, main in MAINS.items():
        assert main(args_of(side)) == 0
        out[side] = capsys.readouterr().out
    return out


def strip_times(path):
    d = json.loads(path.read_text())
    meta = d["strategy"]["planner_meta"]
    d["strategy"]["planner_meta"] = {k: v for k, v in meta.items()
                                     if not k.startswith("time_")}
    return d


def write_table(path, device, frac, peak):
    from repro_torch.kbench.table import KernelMeasurement, LatencyTable
    LatencyTable([KernelMeasurement(
        device=device, op="flash_attention", shape=(2, 512, 512, 16, 16, 64),
        median_s=1e-3, trials=5, flops=frac * 1e-3 * peak, blocks=(32, 64),
        collected_at=1000.0, host="h1")]).save(str(path))


@pytest.fixture(scope="module")
def plan_file(tmp_path_factory):
    """The reference CLI's plan, the input of every downstream subcommand."""
    path = tmp_path_factory.mktemp("cli") / "plan.json"
    assert ref_main(["plan", *PLAN_ARGS, "-o", str(path)]) == 0
    return path


def test_cli_plan_writes_the_reference_plan(tmp_path, capsys):
    out = run_both(capsys, lambda s: ["plan", *PLAN_ARGS, "--explain-comm",
                                      "-o", str(tmp_path / f"{s}.json")])
    assert strip_times(tmp_path / "port.json") \
        == strip_times(tmp_path / "ref.json")
    # the describe() text carries no wall-clock field apart from the path
    assert out["port"].replace("port.json", "X") \
        == out["ref"].replace("ref.json", "X")


def test_cli_plan_from_a_kbench_table(tmp_path, capsys):
    write_table(tmp_path / "a100.json", "A100-40G", 0.45, 312e12)
    write_table(tmp_path / "h100.json", H100_FP, 0.30, 989e12)
    run_both(capsys, lambda s: ["kbench", "merge", str(tmp_path / "a100.json"),
                                str(tmp_path / "h100.json"),
                                "-o", str(tmp_path / f"{s}_table.json")])
    merged = (tmp_path / "port_table.json").read_bytes()
    assert merged == (tmp_path / "ref_table.json").read_bytes()
    shown = run_both(capsys, lambda s: ["kbench", "show",
                                        str(tmp_path / "port_table.json")])
    assert shown["port"] == shown["ref"] and "2 cells" in shown["port"]
    out = run_both(capsys, lambda s: [
        "plan", *PLAN_ARGS, "--kbench-table", str(tmp_path / "port_table.json"),
        "--kbench-device-map", "A100-40G=A100-40G", "--explain-costs",
        "-o", str(tmp_path / f"{s}.json")])
    plan = strip_times(tmp_path / "port.json")
    assert plan == strip_times(tmp_path / "ref.json")
    assert plan["strategy"]["planner_meta"]["kbench"]["cells"] == 2
    assert "measured" in out["port"]


@pytest.mark.parametrize("flags", [[], ["--raw", "--timeline"],
                                   ["--contention"]])
def test_cli_simulate_matches(plan_file, tmp_path, capsys, flags):
    out = run_both(capsys, lambda s: ["simulate", "--plan", str(plan_file),
                                      *flags, "--trace-out",
                                      str(tmp_path / f"{s}.json")])
    assert out["port"].replace("port.json", "X") \
        == out["ref"].replace("ref.json", "X")
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("argv", [
    ["replay", "--trace", "paper", "--steps", "120"],
    ["replay", "--trace", "random", "--steps", "120", "--seed", "2",
     "--static"],
    ["chaos", "replay", "--steps", "100", "--seed", "1", "--debounce", "2",
     "--p-planner-timeout", "0.2"],
], ids=["replay-paper", "replay-random-static", "chaos"])
def test_cli_replay_and_chaos_match(plan_file, capsys, fake_clock, argv):
    def args(side):
        i = 2 if argv[0] == "chaos" else 1
        return argv[:i] + ["--plan", str(plan_file)] + argv[i:]
    out = run_both(capsys, args)
    assert out["port"] == out["ref"]
    assert "tokens/s" in out["port"]


def test_cli_trace_and_migrate_match(plan_file, tmp_path, capsys):
    run_both(capsys, lambda s: ["trace", "--plan", str(plan_file), "--priced",
                                "-o", str(tmp_path / f"{s}_trace.json")])
    assert (tmp_path / "port_trace.json").read_bytes() \
        == (tmp_path / "ref_trace.json").read_bytes()
    out = run_both(capsys, lambda s: [
        "migrate", "--plan", str(plan_file), "--cluster", "paper_case_study",
        "--cluster-kw", "cross_gbps=10", "-o", str(tmp_path / f"{s}.json")])
    assert strip_times(tmp_path / "port.json") \
        == strip_times(tmp_path / "ref.json")
    assert "downtime" in out["port"]


def test_cli_kbench_collect_on_the_cpu(tmp_path, capsys):
    """The port's plain versions on the CPU give the cells the reference's
    interpret-mode collect gives (op, shape, blocks, flops), stamped
    cpu:<machine>:plain; ``--interpret`` means ``--device cpu``."""
    from repro_torch.kbench.table import LatencyTable as TTable
    from repro.kbench.table import LatencyTable as RTable

    def args(side, flag):
        return ["kbench", "collect", "--ops", "rmsnorm", "--trials", "2",
                "--warmup", "1", flag, "-o", str(tmp_path / f"{side}.json")]
    assert ref_main(args("ref", "--interpret")) == 0
    assert port_main(args("port", "--interpret")) == 0
    assert port_main(["kbench", "collect", "--ops", "rmsnorm", "--trials", "2",
                      "--device", "cpu", "--fingerprint", "cpu:test",
                      "-o", str(tmp_path / "port2.json")]) == 0
    capsys.readouterr()
    (r,), (p,) = (RTable.load(str(tmp_path / "ref.json")).entries,
                  TTable.load(str(tmp_path / "port.json")).entries)
    assert (p.op, p.shape, p.blocks, p.flops) == (r.op, r.shape, r.blocks,
                                                   r.flops)
    assert p.device.startswith("cpu:") and p.device.endswith(":plain")
    assert p.median_s > 0
    assert TTable.load(str(tmp_path / "port2.json")).devices() == ["cpu:test"]


def test_cli_train_smoke_on_the_cpu(plan_file, tmp_path, capsys):
    """Reduced gpt-2b from the plan's workload: two steps, a checkpoint at
    step 2 with the reference's leaf keys and shapes."""
    out = run_both(capsys, lambda s: [
        "train", "--plan", str(plan_file), "--smoke", "--steps", "2",
        "--seq", "32", "--batch", "2", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path / s)]
        + (["--device", "cpu"] if s == "port" else []))
    assert "elastic controller NOT attached" in out["port"]
    assert "over 2 steps" in out["port"] and "over 2 steps" in out["ref"]
    files = {s: sorted(os.listdir(tmp_path / s)) for s in MAINS}
    assert files["port"] == files["ref"] == ["ckpt_0000000002.npz"]
    with np.load(tmp_path / "ref" / files["ref"][0]) as r, \
            np.load(tmp_path / "port" / files["port"][0]) as p:
        assert sorted(p.files) == sorted(r.files)
        assert all(p[k].shape == r[k].shape for k in r.files)


def test_cli_train_defaults_to_the_card(plan_file, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["train", "--plan", str(plan_file), "--smoke", "--steps",
                   "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("name, argv, marker", [
    ("train", ["--steps", "2", "--batch", "4", "--seq", "32", "--ckpt-every", "2"],
     "[train] loss"),
    ("serve", ["--batch", "2", "--prompt-len", "8", "--gen", "4"], "[serve] sample"),
])
def test_launcher_shims_warn_and_run_on_the_cpu(name, argv, marker, tmp_path,
                                                capsys, monkeypatch):
    """``repro_torch.launch.train`` / ``.serve``: the reference's deprecated
    shims over ``api.fit`` / ``api.generate``, same flags plus ``--device``."""
    import importlib

    from repro_torch.api import facade

    monkeypatch.chdir(tmp_path)             # the train shim's checkpoints/
    monkeypatch.setattr(facade, "_DEPRECATION_WARNED", set())
    shim = importlib.import_module(f"repro_torch.launch.{name}")
    with pytest.warns(DeprecationWarning, match=f"repro_torch.launch.{name} is deprecated"):
        shim.main(["--arch", "gpt-2b", "--smoke", "--device", "cpu", *argv])
    assert marker in capsys.readouterr().out
    if name == "train":
        assert os.listdir(tmp_path / "checkpoints") == ["ckpt_0000000002.npz"]
