"""The body shared by ``test_torch_sharded_gloo*.py``: two gloo ranks of
``torch_sharded_worker.py`` meeting through a ``FileStore`` in
``tmp_path`` (no port is opened), and the tolerance every result is held
to.  Both sides are f32; the sharded side sums in other orders (all-reduce
over shards, the softmax combined over a split vocabulary or sequence),
so results agree to f32 rounding, not bit for bit."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RTOL = 1e-5


def run_ranks(tmp_path, arch, n_data, n_model):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), HERE]))
    worker = os.path.join(HERE, "torch_sharded_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", str(tmp_path / "store"), arch,
         str(n_data), str(n_model), str(tmp_path / f"out{r}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    outs = []
    for r in range(2):
        with open(tmp_path / f"out{r}.json") as f:
            outs.append(json.load(f))
    return outs


def hold(outs):
    for res in outs:
        assert res.pop("decode.tokens_equal") is True
        bad = {k: v for k, v in res.items() if not v <= RTOL}
        assert not bad, bad
        assert {k.split(".")[0] for k in res} == {"train", "prefill", "decode"}
