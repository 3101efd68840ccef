"""One rank of the port's pipeline over ``torch.distributed`` (gloo, CPU),
for ``tests/test_torch_pipeline.py``.

    python torch_pipeline_worker.py RANK WORLD STORE_FILE IN_NPZ OUT_NPZ

``IN_NPZ`` holds the config (``arch``, ``n_mb``, ``steps``), the initial
params (``p.<path>``) and each step's batch (``b<step>.tokens`` /
``.labels``).  Rank r runs stage r through ``make_pipeline_train_step`` with
a ``DistributedTransport`` and writes, to ``OUT_NPZ``, each step's metrics
(``m<step>.<name>``) and its final ``staged`` slice and ``shared`` params
(``staged.<path>``, ``shared.<path>``).  The process group meets through a
``FileStore``, so no port is opened.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.parallel.pipeline import DistributedTransport, backend_for
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import make_pipeline_train_step

OPT = dict(lr=1e-3, warmup_steps=3, total_steps=10)


def unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.array(v))
    return tree


def flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = v.detach().numpy()
    return out


def main(rank, world, store_file, in_npz, out_npz):
    torch.set_num_threads(1)
    inp = dict(np.load(in_npz))
    store = dist.FileStore(store_file, world)
    dist.init_process_group(backend_for(torch.device("cpu")), store=store,
                            rank=rank, world_size=world)
    try:
        cfg = get_config(str(inp["arch"])).reduced()
        step, st, opt_init, _ = make_pipeline_train_step(
            cfg, OptimizerConfig(**OPT), n_stages=world,
            n_microbatches=int(inp["n_mb"]), act_dtype=torch.float32,
            params=unflatten(inp, "p."), device="cpu",
            transport=DistributedTransport())
        staged, shared = st.staged, st.shared
        opt = opt_init({"staged": staged, "shared": shared})
        out = {}
        for i in range(int(inp["steps"])):
            batch = {k: inp[f"b{i}.{k}"] for k in ("tokens", "labels")}
            staged, shared, opt, m = step(staged, shared, st.consts, opt, batch)
            for k, v in m.items():
                out[f"m{i}.{k}"] = v.item()
        flatten(staged, "staged.", out)
        flatten(shared, "shared.", out)
        np.savez(out_npz, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
