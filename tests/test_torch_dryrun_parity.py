"""The port's dry-run cells against the reference's, argument by argument:
every single-mesh cell of ``all_cells()``, at full published size, and
gemma-2b's train cell under ``REPRO_FSDP=0`` (ZeRO-1) and
``REPRO_FLATDP=1`` (flat data parallelism).

The reference's ``build_case`` runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` and lowers
nothing: for each input leaf it records the global shape, the dtype and
its ``in_shardings`` leaf's ``shard_shape``.  The port's ``build_case``
runs in torch's ``fake`` process group of 256 ranks; each leaf is placed
(``NamedSharding.place``) under ``FakeTensorMode`` and its DTensor's global
shape, dtype and local shape must equal the reference's, leaf for leaf.
The one leaf the port lacks is a decode cell's position, a host int in the
port (``launch/dryrun.py``).
"""
import json
import os
import subprocess
import sys

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch import dryrun as D
from repro_torch.train.optimizer import OptState

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

CELLS = [(a, s) for a, s, _ in D.all_cells(("single",))]
VARIANTS = [("REPRO_FSDP", "0"), ("REPRO_FLATDP", "1")]

_REFERENCE = r"""
import json, os, sys
import jax
from repro.launch import dryrun as R

def key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)

out = {}
for arch, shape in json.loads(sys.argv[1]):
    fn, args, in_sh, mesh, donate = R.build_case(arch, shape, False)
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


def reference(cells, env_extra=()):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    env.update(env_extra)
    res = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(cells)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def flat_with_path(tree, path=()):
    if isinstance(tree, OptState):
        for name, part in zip(tree._fields, tree):
            if part is not None:
                yield from flat_with_path(part, path + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, part in enumerate(tree):
            yield from flat_with_path(part, path + (str(i),))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_with_path(tree[k], path + (str(k),))
    else:
        yield ".".join(path), tree


def port(arch, shape):
    with D.fake_world("single"):
        case = D.build_case(arch, shape, False)
        with FakeTensorMode():
            placed = tuple(D._place(h, s) for h, s in zip(case.in_sh, case.args))
        out = {}
        for path, t in flat_with_path(placed):
            local = t.to_local()
            out[path] = [list(t.shape), str(t.dtype).replace("torch.", ""),
                         list(local.shape)]
            assert local.dtype == t.dtype
        return out


def hold(ref, got, cell):
    missing = set(ref) - set(got)
    if cell[1] in ("decode_32k", "long_500k"):
        assert missing == {"3"}, missing          # the position: a host int
    else:
        assert not missing, missing
    assert not set(got) - set(ref), set(got) - set(ref)
    for path, leaf in got.items():
        assert leaf == ref[path], (cell, path, leaf, ref[path])


@pytest.fixture(scope="module")
def ref_cells():
    return reference(CELLS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_arguments_shard_as_the_references(ref_cells, arch, shape):
    hold(ref_cells[f"{arch}/{shape}"], port(arch, shape), (arch, shape))


@pytest.mark.parametrize("knob,value", VARIANTS)
def test_layout_knobs_shard_as_the_references(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    ref = reference([("gemma-2b", "train_4k")], {knob: value})
    hold(ref["gemma-2b/train_4k"], port("gemma-2b", "train_4k"),
         ("gemma-2b", "train_4k"))
