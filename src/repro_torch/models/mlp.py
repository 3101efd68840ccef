"""Feed-forward blocks: gated (swiglu/geglu) and plain (gelu/relu^2)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import activate, dense_init, linear, shard_act

GATED = ("swiglu", "geglu")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32, stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, stack),
         "w_down": dense_init(gen, d_ff, d_model, dtype, stack)}
    if activation in GATED:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, stack)
    return p


def mlp(p: Dict[str, Any], h: torch.Tensor, activation: str) -> torch.Tensor:
    up = linear(h, p["w_up"])
    if activation in GATED:
        up = activate(linear(h, p["w_gate"]), activation) * up
    else:
        up = activate(up, activation)
    up = shard_act(up, ("batch", "seq", "ff"))
    return linear(up, p["w_down"])
