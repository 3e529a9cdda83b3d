"""RecurrentGemma-2B's recurrent block on the production mesh: every
product whose weight the rules shard by rows over 'model' runs on each
rank's rows.

A reduced RecurrentGemma-2B (d_model = d_rnn = 256, four heads, one kv
head) takes a train step (loss, grads, AdamW) of B = 32 rows of S = 64
tokens, traced by ``roofline.step_trace.trace_step`` on the fake
2x16x16 ('pod', 'data', 'model') mesh and on one fake device. The rules
give the RG-LRU gates ``w_a`` / ``w_i`` (rnn, rnn) and ``w_out`` (rnn,
embed) as (model, None): each model rank contracts its 16 rows, each
device its one row of 64 tokens, so their weight gradients are local
products (16, 64) x (64, 256), three a layer, and no product takes a
whole 256 x 256 weight or gives a whole weight's gradient (the parent
gathered ``w_out`` for its backward, and projected the queries on every
model rank: four heads on 16 run context parallel). Per device the dot
FLOPs times the 512 devices over one device's are 1 plus the k and v
projections, which every model rank computes whole (one kv head).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.roofline import step_trace  # noqa: E402

B, S = 32, 64


def trace(cfg, mesh_fn):
    mesh = mesh_fn()
    try:
        return step_trace.trace_step(lambda: steps.sharded_artifacts(
            cfg, InputShape("t", S, B, "train"), mesh), mesh)
    finally:
        mesh_lib.close()


def one_device():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    mesh_lib.close()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def test_recurrent_products_run_on_each_model_ranks_rows():
    cfg = get_config("recurrentgemma-2b").reduced()
    d, dr = cfg.d_model, cfg.d_rnn
    assert d == dr == 256 and cfg.n_kv_heads == 1
    tr = trace(cfg, lambda: mesh_lib.make_production_mesh(multi_pod=True))
    n, m = 2 * 16 * 16, 16
    rows = B * S // (n // m)                 # a device's tokens
    by_op = tr.dot_flops_by_op
    whole = [k for k in by_op
             if k in (f"mm ({rows}, {dr}) ({dr}, {dr})",
                      f"mm ({dr}, {rows}) ({rows}, {dr})")]
    assert not whole, whole
    n_rec = cfg.block_pattern.count("rec") * cfg.n_cycles
    assert by_op[f"mm ({dr // m}, {rows}) ({rows}, {d})"] == (
        3 * n_rec * 2 * (dr // m) * rows * d)
    one = trace(cfg, one_device)
    params = Model(cfg).abstract_params()
    kv = sum(v.numel() for k, v in params.items()
             if k.endswith(("attn/wk", "attn/wv")))
    extra = (m - 1) * 6 * B * S * kv
    assert n * tr.dot_flops / one.dot_flops == pytest.approx(
        1 + extra / one.dot_flops, rel=1e-2)
