"""Fault-tolerant checkpointing: atomic, resumable, incremental.

Counterpart of ``repro/checkpoint/ckpt.py`` with the same on-disk format, so
a checkpoint crosses between the two packages in both directions: ``.npz``
with a ``__meta__`` entry, leaf keys joined by ``|``, dict keys as they are,
sequence entries by index and NamedTuple fields as ``.<field>`` (the
reference writes ``opt_state|.step``, ``opt_state|.mu|blocks|w``, ...).
Trees are nested dicts, lists, tuples and NamedTuples of tensors or numpy
arrays; ``None`` holds no leaf.  Tensors are copied to host numpy arrays on
save; ``restore`` returns numpy leaves, as the reference does, and
``reshard`` places them on a device or, as DTensors, on a ``DeviceMesh``.

- ``save``: flatten the pytree to path-keyed arrays, write ``.npz`` to a temp
  file, fsync, atomic rename -> a crash mid-write never corrupts the latest
  checkpoint.  A rolling window of checkpoints is kept.
- ``restore``: load the newest (or a specific) step; missing -> None.
  Incremental checkpoints are resolved transparently: each file's manifest
  maps every leaf to the step whose file owns its newest bytes.
- :class:`AsyncCheckpointer`: delta-since-last-save (unchanged leaves are
  *referenced*, not rewritten) with the write handed to a background thread
  — the training step only pays for the host snapshot.  The manifest rides
  inside the atomically-renamed file, so a preemption mid-write (or
  mid-migration) always falls back to the newest *consistent* state.

Leaf keys are joined with ``SEP``; a key containing the separator, or named
like the metadata entry, would silently corrupt the flat namespace — both
are rejected at save time (regression-tested in ``tests/test_checkpoint.py``).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy

SEP = "|"
META_KEY = "__meta__"


def _key_str(parts: List[str]) -> str:
    for p in parts:
        if SEP in p:
            raise ValueError(
                f"checkpoint leaf key {p!r} contains the path separator "
                f"{SEP!r} — it would corrupt the flat key namespace; "
                f"rename the pytree key")
    key = SEP.join(parts)
    if key == META_KEY:
        raise ValueError(
            f"checkpoint leaf key {META_KEY!r} collides with the metadata "
            f"entry; rename the pytree key")
    return key


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_path(tree, path=()) -> List[Tuple[List[str], Any]]:
    """(key parts, leaf) in the reference's flattening order: dict keys
    sorted, sequences by index, NamedTuple fields in order as ``.<name>``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [x for f in tree._fields
                for x in _leaves_with_path(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_path(v, path + (str(i),))]
    return [(list(path), tree)]


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_key_str(kp): to_numpy(leaf) for kp, leaf in _leaves_with_path(tree)}


def _unflatten_into(template, flat: Dict[str, np.ndarray], path=()):
    """``template``'s structure with the arrays of ``flat`` as leaves."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, path + (str(k),))
                for k in template}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten_into(getattr(template, f), flat, path + ("." + f,))
            for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten_into(v, flat, path + (str(i),))
                              for i, v in enumerate(template))
    key = _key_str(list(path))
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(template.shape)}")
    return arr


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:010d}.npz")


# chaos seam: fn(step) -> None | "partial" | "fsync".  "partial" dies
# mid-stream (half the payload written), "fsync" dies after the payload but
# before the atomic rename.  Either way the destination path is never
# touched — the previous checkpoint stays readable, which is what the
# atomic-rename protocol promises and the chaos tests verify.
_WRITE_FAULT = None


def set_write_fault(fn):
    """Install (or clear, with None) the checkpoint write-fault hook.
    Returns the previous hook so tests can restore it."""
    global _WRITE_FAULT
    prev = _WRITE_FAULT
    _WRITE_FAULT = fn
    return prev


def _write_atomic(ckpt_dir: str, step: int, meta: Dict,
                  flat: Dict[str, np.ndarray]) -> str:
    path = _path(ckpt_dir, step)
    fault = _WRITE_FAULT(step) if _WRITE_FAULT is not None else None
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            if fault == "partial":
                # serialize to memory, write only half, then die — the torn
                # tmp file must never reach ``path``
                import io
                buf = io.BytesIO()
                np.savez(buf, **{META_KEY: json.dumps(meta)}, **flat)
                payload = buf.getvalue()
                f.write(payload[:len(payload) // 2])
                f.flush()
                raise IOError(f"injected partial write at step {step}")
            np.savez(f, **{META_KEY: json.dumps(meta)}, **flat)
            f.flush()
            os.fsync(f.fileno())
            if fault == "fsync":
                raise IOError(f"injected fsync failure at step {step}")
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # observability: every durable save counts its bytes on the default
    # obs registry (record-only; the write path above is unchanged)
    from repro_torch.obs.metrics import DEFAULT_REGISTRY
    DEFAULT_REGISTRY.inc("ckpt.saves")
    DEFAULT_REGISTRY.inc("ckpt.bytes_written", os.path.getsize(path))
    return path


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Full (self-contained) checkpoint of ``tree`` at ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    meta = {"step": step, "extra": extra or {}}
    path = _write_atomic(ckpt_dir, step, meta, flat)
    _gc(ckpt_dir, keep)
    return path


def _read_meta(ckpt_dir: str, step: int) -> Dict:
    with np.load(_path(ckpt_dir, step), allow_pickle=False) as z:
        return json.loads(str(z[META_KEY]))


def _gc(ckpt_dir: str, keep: int):
    """Drop all but the newest ``keep`` steps (``keep=0``/falsy keeps
    everything) — but never a step an incremental manifest in the kept
    window still references as a leaf owner."""
    ckpts = sorted(list_steps(ckpt_dir))
    if not keep:
        return
    kept, drop = ckpts[-keep:], ckpts[:-keep]
    if not drop:
        return
    referenced = set()
    for step in kept:
        meta = _read_meta(ckpt_dir, step)
        leaves = meta.get("leaves")
        if leaves:
            referenced.update(int(s) for s in leaves.values())
    for step in drop:
        if step not in referenced:
            os.unlink(_path(ckpt_dir, step))


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d{10})\.npz", fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def restore(ckpt_dir: str, template, step: Optional[int] = None
            ) -> Optional[Tuple[int, Any, Dict]]:
    """Load the newest (or a specific) step into ``template``'s structure.
    Incremental checkpoints resolve each leaf from the step that owns its
    newest bytes (the file's ``leaves`` manifest)."""
    steps = list_steps(ckpt_dir)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    with np.load(_path(ckpt_dir, step), allow_pickle=False) as z:
        meta = json.loads(str(z[META_KEY]))
        flat = {k: z[k] for k in z.files if k != META_KEY}
    leaves = meta.get("leaves")
    if leaves:
        by_owner: Dict[int, List[str]] = {}
        for key, owner in leaves.items():
            if key not in flat:
                by_owner.setdefault(int(owner), []).append(key)
        for owner, keys in sorted(by_owner.items()):
            with np.load(_path(ckpt_dir, owner), allow_pickle=False) as z:
                for k in keys:
                    if k not in z.files:
                        raise KeyError(
                            f"incremental checkpoint {step} references leaf "
                            f"{k} in step {owner}, which lacks it")
                    flat[k] = z[k]
    tree = _unflatten_into(template, flat)
    return meta["step"], tree, meta.get("extra", {})


def reshard(tree, shardings):
    """Place (host or differently-placed) arrays onto new shardings —
    elastic scaling after a replan.  ``shardings`` has ``tree``'s structure,
    matched by path (a mismatch raises); a leaf's sharding is a
    ``torch.device`` (the leaf moved there whole, the reference's
    ``SingleDeviceSharding``) or a
    :class:`~repro_torch.parallel.sharding.NamedSharding` (a DTensor holding
    this rank's shard on its mesh; every rank passes the same tree, as each
    restores the same checkpoint).  Leaves are numpy arrays or tensors; a
    placed leaf never shares memory with ``tree``'s (the steps update their
    state in place)."""
    def place(x, s, path):
        t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        if isinstance(s, torch.device):
            return t.to(s, copy=True)
        if hasattr(s, "distribute"):
            return s.distribute(t.clone() if t.device.type == s.mesh.device_type else t)
        raise TypeError(f"reshard: {SEP.join(path) or 'the root'} has sharding "
                        f"{s!r}, neither a torch.device nor a NamedSharding")

    def walk(x, s, path):
        where = SEP.join(path) or "the root"
        if x is None or s is None:
            if x is not None or s is not None:
                raise ValueError(f"reshard: tree and shardings differ at {where}")
            return None
        if isinstance(x, dict):
            if not isinstance(s, dict) or sorted(x) != sorted(s):
                theirs = sorted(s) if isinstance(s, dict) else type(s).__name__
                raise ValueError(f"reshard: tree and shardings differ at {where}: "
                                 f"keys {sorted(x)} against {theirs}")
            return {k: walk(x[k], s[k], path + (str(k),)) for k in x}
        if _is_namedtuple(x):
            if type(s) is not type(x):
                raise ValueError(f"reshard: tree and shardings differ at {where}")
            return type(x)(*(walk(getattr(x, f), getattr(s, f), path + ("." + f,))
                             for f in x._fields))
        if isinstance(x, (tuple, list)):
            if type(s) is not type(x) or len(s) != len(x):
                raise ValueError(f"reshard: tree and shardings differ at {where}")
            return type(x)(walk(v, w, path + (str(i),))
                           for i, (v, w) in enumerate(zip(x, s)))
        return place(x, s, path)

    return walk(tree, shardings, ())


# ---------------------------------------------------------------------------
# Async + incremental
# ---------------------------------------------------------------------------


class AsyncCheckpointer:
    """Delta checkpoints with the write off the training thread.

    ``save`` snapshots the pytree to host *synchronously* (the consistency
    point), diffs it against the last saved snapshot, and hands the write
    of only the *changed* leaves to a single background worker.  The file's
    manifest (inside the same atomic rename) maps every leaf to the step
    whose file owns its newest bytes, so ``restore`` — and therefore a
    preemption at any instant — always resolves a complete, consistent
    tree: either this step's (rename landed) or the previous one's.

    ``wait()`` blocks until all queued writes are durable (call before a
    migration cutover or on SIGTERM); errors in the worker re-raise there
    and on the next ``save``.  Not thread-safe across concurrent ``save``
    callers (one trainer loop is the intended writer).
    """

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 incremental: bool = True, background: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.incremental = incremental
        self.background = background
        self._last_flat: Dict[str, np.ndarray] = {}
        self._owner: Dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- internals -----------------------------------------------------------

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               changed: Dict[str, np.ndarray], extra: Optional[Dict]):
        try:
            meta: Dict[str, Any] = {"step": step, "extra": extra or {}}
            if self.incremental:
                meta["leaves"] = {k: self._owner[k] for k in flat}
            _write_atomic(self.ckpt_dir, step, meta,
                          changed if self.incremental else flat)
            _gc(self.ckpt_dir, self.keep)
        except BaseException as e:          # surfaced on wait()/next save()
            self._error = e

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from e

    # -- api -----------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        """Snapshot now, write (possibly) later.  The snapshot is the
        consistency point: mutating ``tree`` after ``save`` returns never
        affects the bytes on disk."""
        self.wait()
        self._raise_pending()
        os.makedirs(self.ckpt_dir, exist_ok=True)
        flat = _flatten(tree)
        changed: Dict[str, np.ndarray] = {}
        for k, v in flat.items():
            prev = self._last_flat.get(k)
            if prev is None or prev.shape != v.shape or \
                    prev.dtype != v.dtype or not np.array_equal(prev, v):
                changed[k] = np.array(v, copy=True)
                self._owner[k] = step
        # leaves that vanished from the tree drop out of the manifest
        gone = set(self._last_flat) - set(flat)
        for k in gone:
            self._owner.pop(k, None)
            self._last_flat.pop(k, None)
        self._last_flat.update(changed)
        snap = {k: self._last_flat[k] for k in flat}
        if self.background:
            self._thread = threading.Thread(
                target=self._write, args=(step, snap, changed, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, snap, changed, extra)
            self._raise_pending()

    def wait(self) -> None:
        """Block until the in-flight write (if any) is durable."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        self.wait()
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
