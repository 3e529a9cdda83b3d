"""RecurrentGemma / Griffin recurrent block: Conv1D + RG-LRU.

RG-LRU (real-gated linear recurrent unit):

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Over a whole sequence the diagonal recurrence goes through
``kernels.ops.lru_scan``: the hand-written scan kernel for a tensor on
the card (``impl="pallas"``), its plain sequential version on the CPU
or with ``impl="xla"`` (the reference uses jax.lax.associative_scan,
the same function). One decode step stays elementwise torch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers.mlp import gelu
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import constrain, rule_axes


def init_recurrent_block(ini, pfx: str, cfg, stack: int = 0) -> None:
    d, dr, cw = cfg.d_model, cfg.d_rnn, cfg.conv_width

    def mk(name, shape, names, **kw):
        if stack:
            shape, names = (stack,) + shape, ("layers",) + names
        ini.make(f"{pfx}/{name}", shape, names, **kw)

    mk("w_x", (d, dr), ("embed", "rnn"))
    mk("w_gate_branch", (d, dr), ("embed", "rnn"))
    mk("conv_w", (cw, dr), ("conv", "rnn"))
    mk("conv_b", (dr,), ("rnn",), init="zeros")
    mk("w_a", (dr, dr), ("rnn", "rnn"))
    mk("b_a", (dr,), ("rnn",), init="zeros")
    mk("w_i", (dr, dr), ("rnn", "rnn"))
    mk("b_i", (dr,), ("rnn",), init="zeros")
    # Lambda init so a ~ uniform(0.9, 0.999)^(c*r): standard Griffin init
    mk("lam", (dr,), ("rnn",), init="uniform", scale=1.0)
    mk("w_out", (dr, d), ("rnn", "embed"))


def _causal_conv1d(x, w, b, conv_state=None):
    """Depthwise causal conv. x (B,S,dr), w (cw,dr). conv_state (B,cw-1,dr)
    carries the last cw-1 inputs for decode."""
    cw = w.shape[0]
    if conv_state is None:
        pad = sdt.replicate_like(x, torch.zeros(
            (x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
            device=x.device))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(cw))
    # a copy, so the state does not hold the whole padded sequence alive
    new_state = xp[:, -(cw - 1):].clone() if cw > 1 else pad
    return out + b.to(x.dtype), new_state


def _gate_product(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x32 @ w, fp32. DTensors outside the decode's rule override take the
    reference's layout, pinned rather than left to DTensor's strategy
    (which gathers some row-sharded weights whole for the backward):
    x32 on (act_batch, act_seq, act_rnn), each model rank contracting its
    rows of w (the rules give w_a / w_i (model, None)), the partial sums
    reduce-scattered onto the rnn dim; x's gradient keeps its shard and
    w's its rows. The decode's products are DTensor's, as its traced hand
    count has them."""
    if sdt.is_dtensor(x32) and rule_axes("act_batch"):
        x32 = constrain(x32, "act_batch", "act_seq", "act_rnn")
        return sdt.settled(sdt.contract(torch.matmul, x32, w), -1)
    return sdt.settled(x32 @ w, -1)


def _rg_lru(p, x, cfg, h0: Optional[torch.Tensor] = None,
            impl: str = "pallas"):
    """x (B,S,dr) -> (y, h_last), all gate math in fp32."""
    x32 = x.float()
    r = torch.sigmoid(_gate_product(x32, p["w_a"].float()) + p["b_a"].float())
    i = torch.sigmoid(_gate_product(x32, p["w_i"].float()) + p["b_i"].float())
    # Lambda parametrized so softplus gives a stable positive rate
    log_a = -cfg.rg_lru_c * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    # 1 - a^2 cancels as a -> 1 (r ~ 0), so the gate takes its value from
    # the last bit of a^2: round exp once, from fp64, to the nearest fp32
    a_sq = torch.exp(2.0 * log_a.double()).float()
    gated = torch.sqrt(torch.clamp(1.0 - a_sq, min=1e-12)) * (i * x32)

    if x.shape[1] == 1 and h0 is not None:  # decode
        h = a[:, 0] * h0 + gated[:, 0]
        return h.to(x.dtype)[:, None], h

    h_seq = ops.lru_scan(a.contiguous(), gated.contiguous(), impl=impl)
    if h0 is not None:
        h_seq = h_seq + torch.cumprod(a, dim=1) * h0[:, None]
    return h_seq.to(x.dtype), h_seq[:, -1].clone()


def recurrent_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                    state: Optional[Tuple] = None, impl: str = "pallas"
                    ) -> Tuple[torch.Tensor, Tuple]:
    """Griffin recurrent mixer. state = (conv_state, h_state) for decode."""
    dt = x.dtype
    gate = gelu(sdt.dense(x, p["w_gate_branch"].to(dt)))
    xr = constrain(sdt.dense(x, p["w_x"].to(dt)), "act_batch", "act_seq",
                   "act_rnn")
    conv_state = state[0] if state is not None else None
    h_state = state[1] if state is not None else None
    xr, new_conv = _causal_conv1d(xr, p["conv_w"], p["conv_b"], conv_state)
    y, new_h = _rg_lru(p, xr, cfg, h_state, impl=impl)
    y = y * gate
    out = constrain(sdt.dense(y, p["w_out"].to(dt)), "act_batch", "act_seq",
                    "act_embed")
    return out, (new_conv, new_h.float())
