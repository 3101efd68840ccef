"""The port's pipelined multi-pod train cells against the reference's,
argument by argument, at full published size: the nine ``train_4k`` cells
of ``all_cells()`` on the multi-pod mesh that the reference builds as a
pipeline over ``pod`` (every family but audio).

The reference's ``build_case(arch, "train_4k", True)`` runs in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=512``
and lowers nothing: for each input leaf of ``(staged, shared, consts,
opt_state, batch)`` it records the global shape, the dtype and its
``in_shardings`` leaf's ``shard_shape``.  The port's ``build_case`` runs
in torch's ``fake`` process group of 512 ranks
(``make_pipeline_train_step(abstract=True)``, so nothing is allocated);
each leaf is placed on the whole ``(2, 16, 16)`` mesh under
``FakeTensorMode`` and its DTensor's global shape, dtype and local shape
must equal the reference's, leaf for leaf.  Single-mesh cells are
``test_torch_dryrun_parity.py``'s.
"""
import json
import os
import subprocess
import sys

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D

from test_torch_dryrun_parity import SRC, flat_with_path, hold

CELLS = [(a, s) for a, s, m in D.all_cells(("multi",))
         if D.pipelined(get_config(a), s, True)]

_REFERENCE = r"""
import json, sys
import jax
from repro.launch import dryrun as R

def key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)

out = {}
for arch, shape in json.loads(sys.argv[1]):
    fn, args, in_sh, mesh, donate = R.build_case(arch, shape, True)
    assert donate == (0, 1, 3), donate
    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    shardings = jax.tree_util.tree_leaves(
        in_sh, is_leaf=lambda x: hasattr(x, "shard_shape"))
    assert len(leaves) == len(shardings)
    out[f"{arch}/{shape}"] = {
        ".".join(key(k) for k in path): [list(a.shape), str(a.dtype),
                                         list(sh.shard_shape(a.shape))]
        for (path, a), sh in zip(leaves, shardings)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_cells():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CELLS)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def port(arch, shape):
    with D.fake_world("multi"):
        case = D.build_case(arch, shape, True)
        with FakeTensorMode():
            placed = tuple(D._place(h, s) for h, s in zip(case.in_sh, case.args))
        out = {}
        for path, t in flat_with_path(placed):
            local = t.to_local()
            out[path] = [list(t.shape), str(t.dtype).replace("torch.", ""),
                         list(local.shape)]
            assert local.dtype == t.dtype
        return out


def test_the_nine_cells_are_every_pipelined_one():
    assert len(CELLS) == 9 and ("whisper-medium", "train_4k") not in CELLS
    assert {s for _, s in CELLS} == {"train_4k"}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_pipelined_cell_arguments_shard_as_the_references(ref_cells, arch, shape):
    hold(ref_cells[f"{arch}/{shape}"], port(arch, shape), (arch, shape))
