"""Dense feed-forward blocks (gated SwiGLU / GeGLU or plain)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import constrain


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu}[name]


def init_mlp(ini, pfx: str, cfg, stack: int = 0, d_ff: int = 0) -> None:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)

    def mk(name, shape, names, **kw):
        if stack:
            shape, names = (stack,) + shape, ("layers",) + names
        ini.make(f"{pfx}/{name}", shape, names, **kw)

    mk("w_in", (d, f), ("embed", "mlp"))
    if cfg.mlp_gated:
        mk("w_gate", (d, f), ("embed", "mlp"))
    mk("w_out", (f, d), ("mlp", "embed"))


def mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = x.dtype
    h = sdt.dense(x, p["w_in"].to(dt))
    if cfg.mlp_gated:
        g = sdt.dense(x, p["w_gate"].to(dt))
        h = _act(cfg.act)(g) * h
    else:
        h = _act(cfg.act)(h)
    h = constrain(h, "act_batch", "act_seq", "act_mlp")
    return constrain(sdt.dense(h, p["w_out"].to(dt)), "act_batch",
                     "act_seq", "act_embed")
