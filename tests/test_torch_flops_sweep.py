"""The sharded train step's dot FLOPs against one device's, for the six
configs of ``tests/test_torch_sharded_step.py``.

Each config, reduced, takes a train step (loss, grads, AdamW) traced by
``roofline.step_trace.trace_step`` on a fake 2x2 ('data', 'model') mesh
and on one fake device, B = 4 rows of S = 128 tokens (more tokens than
any width, where DTensor's own strategy gathered row-sharded weights
for the backward). Per device the mesh's FLOPs times its 4 devices over
the one device's FLOPs is 1 plus what the rules leave unsharded, each
product counted 6 T x its weight's size a step (forward, dx, dw), T
the step's tokens, repeated by the ranks it is not split over:

* k and v projected whole on every model rank where the kv heads do not
  divide the model axis (RecurrentGemma's one kv head; qwen-cp's three,
  under context parallelism, whose q is projected on each rank's query
  rows);
* RWKV6's LoRA weights (token shift and decay), which the rules leave
  whole over 'model'.

Anything else (the MoE router too: each rank routes its own tokens on
its own expert columns) is split over all four devices, so a product
that runs whole where the rules shard its weight (the parent's recurrent
``w_out`` and attention ``wo`` in the backward, and the query projection
under context parallelism) moves the ratio off its factor.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.roofline import step_trace  # noqa: E402
from repro_torch.sharding.rules import spec_for  # noqa: E402

B, S, MESH = 4, 128, (2, 2)
CASES = {
    "qwen-heads": ("qwen1.5-4b", {"n_heads": 4, "n_kv_heads": 4}),
    "qwen-cp": ("qwen1.5-4b", {"n_heads": 3, "n_kv_heads": 3}),
    "recurrentgemma": ("recurrentgemma-2b", {"microbatch": 2}),
    "rwkv": ("rwkv6-7b", {}),
    "moe": ("llama4-scout-17b-a16e", {}),
    "moe-mb": ("llama4-scout-17b-a16e", {"microbatch": 2}),
}
# per config, (param name suffix, how many of the 4 devices repeat its
# products, why) of the products not split over 'model': "kv" kv heads
# the model axis does not divide, "rules" a weight the rules leave
# whole over 'model'
MODEL, ALL = MESH[1], MESH[0] * MESH[1]
WHOLE = {
    "qwen-heads": (),
    "qwen-cp": (("attn/wk", MODEL, "kv"), ("attn/wv", MODEL, "kv")),
    "recurrentgemma": (("attn/wk", MODEL, "kv"), ("attn/wv", MODEL, "kv")),
    "rwkv": tuple((f"tm/{w}", MODEL, "rules") for w in (
        "ts_lora_a", "ts_lora_b", "w_lora_a", "w_lora_b")),
    "moe": (),
    "moe-mb": (),
}


def traced_flops(cfg, shape):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    mesh_lib.close()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        return step_trace.trace_step(lambda: steps.sharded_artifacts(
            cfg, InputShape("t", S, B, "train"), mesh), mesh).dot_flops
    finally:
        mesh_lib.close()


def split_over_model(shape, axes) -> bool:
    """Whether the rules split a weight of ``shape`` over 'model'."""
    spec = spec_for(shape, axes, {"data": MESH[0], "model": MESH[1]})
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_flops_are_one_devices_over_the_mesh(name):
    arch, over = CASES[name]
    cfg = get_config(arch).reduced(**over)
    model = Model(cfg)
    params, axes = model.abstract_params(), model.param_axes()
    tokens = B * S
    extra = 0.0
    for suffix, ranks, why in WHOLE[name]:
        keys = [k for k in params if k.endswith(suffix)]
        assert keys, suffix
        for k in keys:
            if why == "kv":
                assert cfg.n_kv_heads % MODEL, k
            elif why == "rules":
                assert not split_over_model(params[k].shape, axes[k]), k
            extra += (ranks - 1) * 6 * tokens * params[k].numel()
    one = traced_flops(cfg, (1, 1))
    ratio = ALL * traced_flops(cfg, MESH) / one
    assert ratio == pytest.approx(1 + extra / one, rel=1e-3), (ratio, name)
