"""Llama-4-Scout's routed experts on the production mesh: each rank
routes, dispatches and combines its own tokens.

A one-layer llama4-scout-17b-a16e at published width (d 5120, 16
experts top-1, a shared expert; remat off) takes the loss and grads of
one microbatch of B = 32 rows of S = 4096 tokens, traced by
``roofline.step_trace.trace_step`` on the fake 2x16x16 ('pod', 'data',
'model') mesh, once as it is and once with its MoE FFN cut to the
shared expert. The difference is what the routed experts add a device,
forward and backward. Each device holds one row of 4,096 tokens and one
expert's (1, 640, 5120) tile of the (16, 10240, 5120) buffers.

Its collective bytes by mesh axis are held within 10% of the hand
count in PERF.md (the MoE dispatch's predictions), and to at most 1.0e9
B in all: the router's logits and the per-expert counts gathered, each
rank's rows reduce-scattered onto the tiles over 'data' and summed over
'pod', the out tile gathered over 'data' for the combine, the
gate-weighted partials summed over 'model', those moves again in the
backward, and the expert weights' gradients, which DTensor all-reduces
whole over 'data'. Routing every token on every rank gathered the
microbatch's whole tokens (1,342,177,280 B) over 'pod' and 'data' and
the whole expert output over 'model' and 'data' on every device,
8,095,170,560 B; no collective the routed experts add may carry the
whole tokens, and they add under 1 GB to the traced peak (4.37 GB that
way). The router's products, traced the same way on one fake device,
run at 1/512 of one device's on each: its tokens (1/32) on its expert
column (1/16).
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.models.layers.mlp import mlp  # noqa: E402
from repro_torch.roofline import step_trace  # noqa: E402
from repro_torch.sharding import collectives  # noqa: E402
from repro_torch.sharding.rules import constrain  # noqa: E402

B, S, MESH = 32, 4096, (2, 16, 16)
# PERF.md's hand count of what the routed experts add a device
HAND = {"data": 726_160_648, "pod": 26_221_832, "model": 84_180_992}
LIMIT = 1.0e9
TOKENS = B * S * 5120 * 2          # the microbatch's bf16 tokens


def shared_only(p, x, cfg):
    """``moe.moe_ffn`` with the routed experts cut: the shared expert
    alone, zero aux losses."""
    y = mlp({k[len("shared/"):]: v for k, v in p.items()
             if k.startswith("shared/")}, x, cfg)
    zero = (x.sum() * 0).float()
    return (constrain(y, "act_batch", "act_seq", "act_embed"),
            {"load_balance": zero, "router_z": zero})


def trace(cfg, shape, routed):
    """The traced loss and grads, and every collective call's (axis, op,
    bytes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    calls = []
    add = collectives.Tally.add

    def logged(self, axis, op, nbytes):
        calls.append((axis, op, nbytes))
        add(self, axis, op, nbytes)
    mesh_lib.close()
    n = shape[0] * shape[1] * shape[2]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    ffn = moe.moe_ffn
    collectives.Tally.add = logged
    if not routed:
        moe.moe_ffn = shared_only
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("pod", "data", "model"))

        def build():
            _, args = steps.sharded_artifacts(
                cfg, InputShape("t", S, B, "train"), mesh)
            return (lambda p, b: steps.loss_and_grads(Model(cfg), p, b),
                    (args[0], args[2]))
        return step_trace.trace_step(build, mesh), calls
    finally:
        moe.moe_ffn = ffn
        collectives.Tally.add = add
        mesh_lib.close()


@pytest.fixture(scope="module")
def traces():
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=1, remat=False)
    assert cfg.microbatch == B and cfg.n_experts == 16 and cfg.top_k == 1
    return {(shape, routed): trace(cfg, shape, routed)
            for shape in (MESH, (1, 1, 1)) for routed in (True, False)}


def added(traces, shape):
    (full, calls), (cut, cut_calls) = (traces[(shape, True)],
                                       traces[(shape, False)])
    return full, cut, collections.Counter(calls), \
        collections.Counter(cut_calls)


def test_routed_experts_collectives_meet_the_hand_count(traces):
    full, cut, calls, cut_calls = added(traces, MESH)
    by_axis = {a: full.tally.bytes_by_axis[a] - cut.tally.bytes_by_axis[a]
               for a in ("pod", "data", "model")}
    for axis, want in HAND.items():
        assert abs(by_axis[axis] - want) <= 0.1 * want, (axis, by_axis)
    assert sum(by_axis.values()) <= LIMIT, by_axis
    # the routed experts only add calls: the cut step's are all there
    extra = calls - cut_calls
    assert not cut_calls - calls
    assert sum(n * k for (_, _, n), k in extra.items()) == sum(
        by_axis.values())


def test_no_routed_collective_carries_the_whole_tokens(traces):
    _, _, calls, cut_calls = added(traces, MESH)
    extra = calls - cut_calls
    assert extra
    biggest = max(n for _, _, n in extra)
    assert biggest < TOKENS, biggest
    assert not any(axis == "pod" and op == "all-gather" and n >= TOKENS
                   for axis, op, n in extra)


def test_router_runs_at_one_512th_of_one_devices_flops(traces):
    def router(shape):
        full, cut = traces[(shape, True)][0], traces[(shape, False)][0]

        def mm(tr):
            return sum(v for k, v in tr.dot_flops_by_op.items()
                       if k.startswith("mm "))
        return mm(full) - mm(cut)
    one = router((1, 1, 1))
    assert one == 3 * 2 * B * S * 5120 * 16
    assert router(MESH) * 512 == one


def test_routed_experts_add_under_1gb_at_peak(traces):
    full, cut = traces[(MESH, True)][0], traces[(MESH, False)][0]
    assert full.peak_bytes - cut.peak_bytes < 1e9
