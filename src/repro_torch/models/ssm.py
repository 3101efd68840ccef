"""Mamba-2 (SSD: state-space duality) block.

Counterpart of ``repro/models/ssm.py``: the chunked SSD algorithm (an
intra-chunk quadratic term plus an inter-chunk linear state recurrence) in
plain PyTorch.  The intra-chunk term is the hot spot; with ``use_kernels``
it runs through the Hopper kernel K5 (``repro_torch.kernels.ops.ssd_intra``),
else through :func:`ssd_intra_ref`.  ``ssd_naive`` is the sequential oracle
of the tests.  The reference's ``0.0 * x`` terms, which only carry JAX
sharding annotations, are plain zeros here.

Unlike the reference, :func:`ssd_intra_ref` masks the decay exponents
*before* ``exp``: above the diagonal ``cum_q - cum_j`` is a positive sum of
``dt``'s that overflows ``exp`` at mamba2's chunk of 256, and the
reference's ``where(mask, exp(.), 0)`` turns that ``inf`` into a NaN
gradient.  The forward values are the same.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, linear, rms_norm, shard_act

Params = Dict[str, Any]


def ssm_init(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
             n_heads: int, d_conv: int, dtype=torch.float32,
             stack: Tuple[int, ...] = ()) -> Params:
    """Parameters on the generator's device; ``A = -exp(A_log) = -1``."""
    dev = gen.device
    d_proj = 2 * d_inner + 2 * d_state + n_heads   # z, xBC, dt
    d_xbc = d_inner + 2 * d_state

    def full(shape, value, dt):
        return torch.full((*stack, *shape), value, dtype=dt, device=dev)

    conv_w = 0.1 * torch.randn((*stack, d_conv, d_xbc), generator=gen,
                               device=dev, dtype=torch.float32)
    return {
        "in_proj": dense_init(gen, d_model, d_proj, dtype, stack),
        "conv_w": conv_w.to(dtype),
        "conv_b": full((d_xbc,), 0.0, dtype),
        "A_log": full((n_heads,), 0.0, torch.float32),
        "D": full((n_heads,), 1.0, torch.float32),
        "dt_bias": full((n_heads,), 0.0, torch.float32),
        "norm_w": full((d_inner,), 1.0, dtype),
        "out_proj": dense_init(gen, d_inner, d_model, dtype, stack),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, T, C); w: (K, C); b: (C,)."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):  # K is tiny (4): unrolled taps
        out = out + pad[:, k:k + T].float() * w[k].float()
    return (out + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_naive(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None):
    """Sequential oracle.  x: (B,T,H,P); dt: (B,T,H); A: (H,) (negative);
    Bm, Cm: (B,T,N).  Returns (y: (B,T,H,P), final_state: (B,H,P,N))."""
    Bsz, T, H, Pd = x.shape
    N = Bm.shape[-1]
    s = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(T):
        decay = torch.exp(A[None] * dtf[:, t])                       # (B,H)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :]
        s = s * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                use_kernels: bool = False):
    """Chunked SSD (Mamba-2 alg. 1). Shapes as :func:`ssd_naive`.

    ``Q = min(chunk, T)``; T is padded to a multiple of Q.  Without padding
    the chunked views of x, B and C keep the caller's strides (no copy)."""
    Bsz, T, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        pad = Q - T % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Tp = x.shape[1]
    nc = Tp // Q
    xc = x.reshape(Bsz, nc, Q, H, Pd).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    a = A[None, None, None, :] * dtc                       # (B,nc,Q,H) log-decays (<=0)
    cum = torch.cumsum(a, dim=2)                           # inclusive cumsum
    total = cum[:, :, -1]                                  # (B,nc,H)

    # ---- chunk input states: S_c = sum_q exp(total - cum_q) dt_q x_q B_q^T
    w_in = torch.exp(total[:, :, None] - cum) * dtc        # (B,nc,Q,H)
    S_in = torch.einsum("bcqhp,bcqn->bchpn", w_in[..., None] * xc, Bc)

    # ---- inter-chunk recurrence over the chunk axis
    s = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    dec_tot = torch.exp(total)                             # (B,nc,H)
    S_prev = []
    for c in range(nc):
        S_prev.append(s)
        s = s * dec_tot[:, c, :, None, None] + S_in[:, c]
    S_prev = torch.stack(S_prev, dim=1)                    # (B,nc,H,P,N)

    # ---- inter-chunk output: C_q . (exp(cum_q) * S_prev)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, S_prev) * torch.exp(cum)[..., None]

    # ---- intra-chunk (quadratic) part: the kernel hot spot
    if use_kernels:
        from repro_torch.kernels import ops as kops
        y_intra = kops.ssd_intra(xc, dtc, cum, Bc, Cc)
    else:
        y_intra = ssd_intra_ref(xc, dtc, cum, Bc, Cc)

    y = (y_intra + y_inter).reshape(Bsz, Tp, H, Pd)[:, :T]
    return y.to(x.dtype), s


def ssd_intra_ref(xc, dtc, cum, Bc, Cc):
    """Intra-chunk quadratic term, the plain version of kernel K5.

    xc: (B,nc,Q,H,P); dtc: (B,nc,Q,H); cum: (B,nc,Q,H) inclusive log-decay
    cumsum; Bc, Cc: (B,nc,Q,N).  Output (B,nc,Q,H,P) float32::

        y[q] = sum_{j<=q} (C_q . B_j) * exp(cum_q - cum_j) * dt_j * x_j

    The exponent is set to ``-inf`` above the diagonal before ``exp``, so
    no ``inf`` is formed there and the gradient stays finite."""
    Q = xc.shape[2]
    xc, dtc, cum, Bc, Cc = (t.float() for t in (xc, dtc, cum, Bc, Cc))
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)           # (B,nc,Q,Q)
    # decay from step k (exclusive) to q (inclusive): exp(cum_q - cum_k)
    ldec = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    L = torch.exp(ldec.masked_fill(~mask[:, :, None], float("-inf")))
    M = CB[..., None] * L * dtc[:, :, None, :, :]          # (B,nc,Q,K,H)
    return torch.einsum("bcqkh,bckhp->bcqhp", M, xc)


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------


def ssm_block(p: Params, h: torch.Tensor, *, d_inner: int, d_state: int,
              n_heads: int, head_dim: int, chunk: int,
              use_kernels: bool = False, norm_eps: float = 1e-6,
              return_state: bool = False):
    """Mamba-2 mixer over a full sequence. h: (B, T, d_model).

    ``return_state`` additionally returns the decode state (final SSD state
    and the conv tail, both f32) for prefill."""
    B, T, _ = h.shape
    zxbcdt = linear(h, p["in_proj"])
    z = zxbcdt[..., :d_inner]
    xBC_raw = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., -n_heads:].float()
    xBC = F.silu(causal_conv1d(xBC_raw, p["conv_w"], p["conv_b"]))
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + d_state]
    Cm = xBC[..., d_inner + d_state:]
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = shard_act(x.reshape(B, T, n_heads, head_dim), ("batch", "seq", "heads", None))
    y, s_fin = ssd_chunked(xh, dt, A, Bm, Cm, chunk, use_kernels=use_kernels)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, T, d_inner).to(h.dtype)
    y = rms_norm(y * F.silu(z.float()).to(h.dtype), p["norm_w"], norm_eps)
    out = linear(y, p["out_proj"])
    if return_state:
        K = p["conv_w"].shape[0]
        tail = xBC_raw[:, max(T - (K - 1), 0):].float()
        if T < K - 1:
            tail = F.pad(tail, (0, 0, K - 1 - T, 0))
        return out, {"s": s_fin, "conv": tail}
    return out


def ssm_init_state(batch: int, d_inner: int, d_state: int, n_heads: int,
                   head_dim: int, d_conv: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "s": torch.zeros((batch, n_heads, head_dim, d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, d_conv - 1, d_inner + 2 * d_state),
                            dtype=torch.float32, device=device),
    }


def ssm_decode_step(p: Params, h: torch.Tensor, state: Dict[str, torch.Tensor], *,
                    d_inner: int, d_state: int, n_heads: int, head_dim: int,
                    norm_eps: float = 1e-6):
    """One-token SSM step. h: (B, 1, d_model). Returns (out, new_state)."""
    B = h.shape[0]
    zxbcdt = linear(h[:, 0], p["in_proj"])                  # (B, d_proj)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., -n_heads:].float()

    # conv ring: state['conv'] holds the previous K-1 inputs
    win = torch.cat([state["conv"], xBC[:, None, :].float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"].float())
    xBC = F.silu(conv_out + p["conv_b"].float())
    new_conv = win[:, 1:]

    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + d_state]
    Cm = xBC[..., d_inner + d_state:]
    dt = F.softplus(dt + p["dt_bias"].float())                       # (B,H)
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(B, n_heads, head_dim).float()

    decay = torch.exp(A[None] * dt)                                  # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
    s = state["s"] * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", s, Cm)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, d_inner).to(h.dtype)
    y = rms_norm(y * F.silu(z.float()).to(h.dtype), p["norm_w"], norm_eps)
    out = linear(y, p["out_proj"])[:, None, :]
    return out, {"s": s, "conv": new_conv}
