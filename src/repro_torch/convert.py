"""Parameter trees between the reference and the port, through numpy.

``params_from_jax`` takes the reference's parameter pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``) and returns the
same nested dict of tensors; ``params_to_numpy`` is its inverse.  Paths and
the stacked layout (leading layer axis on ``blocks``) are the reference's,
so checkpoints and migration layouts line up.  ``to_numpy`` and
``copy_into`` serve the checkpoints: a leaf to a host array, and restored
host arrays into the tensors of a live state.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _to_tensor(a: Any, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a copy: jax arrays are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Any, *, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = "cpu") -> Any:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (cast to ``dtype`` when given, else each leaf's own)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype=dtype, device=device)
                for k, v in tree.items()}
    return _to_tensor(tree, dtype, device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only bfloat16 leaves need numpy's bfloat16 type
        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_jax`: tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _to_numpy(tree)


def to_numpy(leaf: Any) -> np.ndarray:
    """A tensor (on any device) or array-like leaf -> a host numpy array.
    A CPU tensor's array shares its memory."""
    if isinstance(leaf, torch.Tensor):
        return _to_numpy(leaf)
    return np.asarray(leaf)


@torch.no_grad()
def copy_into(dst: Any, src: Any) -> Any:
    """Copy the numpy leaves of ``src`` into the tensors of ``dst``, a tree
    of the same structure (dicts, lists, tuples, NamedTuples, ``None``), in
    place on their devices and dtypes.  Returns ``dst``."""
    if dst is None:
        return None
    if isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_into(d, s)
    else:
        dst.copy_(_to_tensor(src, None, "cpu"))
    return dst
