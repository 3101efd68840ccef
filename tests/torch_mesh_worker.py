"""One rank of the port's device-mesh checks over ``torch.distributed``
(gloo, CPU), for ``tests/test_torch_mesh_gloo.py``.

    python torch_mesh_worker.py RANK WORLD STORE_FILE IN_NPZ OUT_NPZ

``IN_NPZ`` holds the config (``arch``, ``n_mb``), the params
(``p.<path>``) and one batch (``b.tokens`` / ``b.labels``).  Rank r:

- builds ``make_pipeline_train_step(mesh=...)`` on a ``(2, 1, 1)``
  ``("pod", "data", "model")`` mesh and writes its staged and consts trees
  before the step (``st0.<path>``, ``c0.<path>``) beside ``to_local()`` of
  the whole staging resharded onto ``pipeline_shardings(staging, mesh)``
  (``dt.<path>``, ``dc.<path>``), then takes one step and writes its
  metrics (``m.<name>``) and the gradients the optimizer received
  (``g.staged.<path>``, ``g.shared.<path>``);
- reshards a small tree onto a ``(2,)`` ``"data"`` mesh and writes each
  leaf's local tensor (``r.<name>``) and placements (``rp.<name>``);
- compiles gpt-2b on two single-card nodes (two stages, tp = dp = 1),
  builds both stages' meshes (``Executable.stage_mesh(s, [s])``, as every
  rank must: building a mesh is collective) and writes the plan
  (``sm.plan``), each mesh's rank grid (``sm.grids``) and this rank's
  coordinate in it (``sm.coords``, ``[-1, -1]`` where it has none), and
  an all-reduce of ``rank + 1`` over its own stage's ``data`` group
  (``sm.sum``).

The process group meets through a ``FileStore``, so no port is opened.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.train.step as step_mod
from repro_torch.api import HarpConfig, compile as api_compile
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core.cluster import A100_40G, GBPS, HeteroCluster, SubCluster
from repro_torch.core.dp_search import SearchConfig
from repro_torch.core.planner import PlannerConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import NamedSharding
from repro_torch.parallel.staging import build_staging
from repro_torch.train.optimizer import OptimizerConfig, tree_map

from torch_pipeline_worker import flatten, unflatten

OPT = dict(lr=1e-3, warmup_steps=3, total_steps=10)


def capture_grads(sink):
    """``make_optimizer`` whose update records (copies of) the gradients it
    is handed before it consumes them."""
    real = step_mod.make_optimizer

    def make(cfg):
        init, update = real(cfg)

        def recording(grads, state, params, grad_norm=None):
            sink["grads"] = tree_map(lambda g: g.detach().clone(), grads)
            return update(grads, state, params, grad_norm=grad_norm)
        return init, recording
    return make


def main(rank, world, store_file, in_npz, out_npz):
    torch.set_num_threads(1)
    inp = dict(np.load(in_npz))
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        cfg = get_config(str(inp["arch"])).reduced()
        params = unflatten(inp, "p.")
        mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device_type="cpu")
        sink = {}
        step_mod.make_optimizer = capture_grads(sink)
        step, st, opt_init, shardings = step_mod.make_pipeline_train_step(
            cfg, OptimizerConfig(**OPT), n_stages=world,
            n_microbatches=int(inp["n_mb"]), act_dtype=torch.float32,
            params=params, device="cpu", mesh=mesh)
        out = {}
        # copies: the step updates the staged tree in place
        flatten(tree_map(torch.clone, st.staged), "st0.", out)
        flatten(tree_map(torch.clone, st.consts), "c0.", out)
        whole = build_staging(cfg, world, params, act_dtype=torch.float32)
        placed = ckpt.reshard({"staged": whole.staged, "consts": whole.consts},
                              {"staged": shardings["staged"],
                               "consts": shardings["consts"]})
        flatten(tree_map(lambda d: d.to_local(), placed["staged"]), "dt.", out)
        flatten(tree_map(lambda d: d.to_local(), placed["consts"]), "dc.", out)
        out["keys"] = np.array(sorted(shardings))

        batch = {k: inp[f"b.{k}"] for k in ("tokens", "labels")}
        opt = opt_init({"staged": st.staged, "shared": st.shared})
        _, _, _, m = step(st.staged, st.shared, st.consts, opt, batch)
        for k, v in m.items():
            out[f"m.{k}"] = v.item()
        flatten(sink["grads"], "g.", out)

        data = make_mesh((2,), ("data",), device_type="cpu")
        tree = {"rows": torch.arange(24, dtype=torch.float32).reshape(8, 3),
                "rep": np.arange(5, dtype=np.float32),
                "host": np.float32(2.5)}
        res = ckpt.reshard(tree, {"rows": NamedSharding(data, ("data", None)),
                                  "rep": NamedSharding(data, (None,)),
                                  "host": torch.device("cpu")})
        for k, v in res.items():
            local = v.to_local() if hasattr(v, "to_local") else v
            out[f"r.{k}"] = local.numpy()
            out[f"rp.{k}"] = np.array(str(getattr(v, "placements", "device")))

        two_cards = HeteroCluster(subclusters=tuple(
            SubCluster(f"meshA100x1{c}", 1, 1, A100_40G, 300e9, 200 * GBPS)
            for c in "ab"), cross_bw=5 * GBPS)
        exe = api_compile("gpt-2b", two_cards, HarpConfig(
            seq_len=1024, global_batch=8, planner=PlannerConfig(
                search=SearchConfig(tmax_round_digits=17))))
        stages = exe.strategy.stages
        out["sm.plan"] = np.array([(st.tp, st.dp) for st in stages])
        meshes = [exe.stage_mesh(s, [s], device_type="cpu")
                  for s in range(len(stages))]
        out["sm.grids"] = np.array([m.mesh.tolist() for m in meshes])
        out["sm.coords"] = np.array([m.get_coordinate() or [-1, -1]
                                     for m in meshes])
        mine = torch.tensor([rank + 1.0])
        dist.all_reduce(mine, group=meshes[rank].get_group("data"))
        out["sm.sum"] = mine.numpy()
        np.savez(out_npz, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
