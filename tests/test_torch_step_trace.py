"""The traced sharded step (``repro_torch.roofline.step_trace``) on the
CPU, and the query offset of the plain attention.

* A one-layer MLP train step, data parallel on a fake 2x2 ('data',
  'model') mesh: the traced collectives and peak bytes equal a count made
  by hand.
* The collectives traced on a fake 2x2 mesh equal those counted on the
  real 4-rank gloo run of the same step (reduced Qwen1.5-4B).
* All ten archs, reduced, run a train forward on a fake 2x16x16 mesh
  under ``FakeTensorMode`` with DTensor params and batch: no mixed
  Tensor / DTensor op, logits of the global shape.
* The kernel route traced through the registered ops on fake ``cuda``
  tensors: each fake's outputs have the shapes and dtypes of the
  wrapper's allocations (the outputs, attention's fp32 LSE, the
  backward's D_i and dK/dV partials, the GLA backward's workspaces),
  the attention's in both dtypes at a query offset.
* ``ref.attention_ref`` / ``attention_bwd_ref`` with ``q_offset``: a
  query shard's rows equal the full call's.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import gla_chunked as kgla  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.roofline import step_trace  # noqa: E402

F32 = 4


@pytest.fixture
def fake_mesh_2x2():
    """A ('data', 'model') 2x2 mesh on torch's fake backend (this process
    plays rank 0), closed at teardown."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    mesh_lib.close()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh_lib.close()


# ------------------------------------------------------- a hand count
B, D, FF = 8, 16, 32


def mlp_loss(p, batch):
    y = torch.relu(batch["x"] @ p["w1"]) @ p["w2"]
    loss = (y * y).sum()
    return loss, {"loss": loss}


def test_one_layer_mlp_step_traces_as_counted_by_hand(fake_mesh_2x2):
    """Data parallel: x's rows over 'data', w1 (D, F) and w2 (F, D)
    replicated. Forward and backward are local; the grads come back as
    partial sums over 'data' and are all-reduced onto the params'
    replicated layout, an all-reduce counted twice its tensor. The peak
    is at the last all-reduce: the arguments, both partial grads, both
    reduced grads and the fp32 loss."""
    mesh = fake_mesh_2x2
    rep, rows = [Replicate(), Replicate()], [Shard(0), Replicate()]

    def placed(x, pls):             # rank 0's shard of x, a copy
        loc = x[:x.shape[0] // 2] if pls[0] == Shard(0) else x
        return DTensor.from_local(loc.clone(), mesh, pls, run_check=False,
                                  shape=x.shape, stride=x.stride())

    def build():
        p = {"w1": placed(torch.empty(D, FF), rep),
             "w2": placed(torch.empty(FF, D), rep)}
        batch = {"x": placed(torch.empty(B, D), rows)}
        return (lambda p, b: steps.value_and_grad(mlp_loss, p, b)), (p, batch)

    tr = step_trace.trace_step(build, mesh)
    w_bytes = D * FF * F32
    args = B // 2 * D * F32 + 2 * w_bytes
    assert tr.argument_bytes == args
    assert tr.peak_bytes == args + 2 * (2 * w_bytes) + F32
    rec = tr.collective_record()
    assert rec["collective_count"] == {"all-reduce": 2}
    assert rec["collective_bytes_by_axis"] == {"data": 2 * 2 * w_bytes}
    assert rec["collective_bytes_total"] == 2 * 2 * w_bytes
    # x @ w1, h @ w2; dh, dw2, dw1 (x takes no gradient): 2 M N K each
    assert tr.dot_flops == 5 * 2 * (B // 2) * D * FF


# -------------------------------------- traced against a real gloo run
STEP_ON_RANKS = """
import json
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models.config import InputShape
from repro_torch.roofline import step_trace
cfg = get_config("qwen1.5-4b").reduced()
mesh = host_mesh((2, 2), ("data", "model"))
step, args = steps.sharded_artifacts(cfg, InputShape("t", 16, 4, "train"),
                                     mesh, seed=0)
_, rec = step_trace.count_collectives(lambda: step(*args), mesh)
if RANK == 0:
    print(json.dumps(rec))
mesh_lib.close()
"""


def test_traced_collectives_equal_a_real_gloo_runs(fake_mesh_2x2, tmp_path):
    from torch_ranks import run_ranks
    cfg = get_config("qwen1.5-4b").reduced()
    mesh = fake_mesh_2x2
    tr = step_trace.trace_step(lambda: steps.sharded_artifacts(
        cfg, InputShape("t", 16, 4, "train"), mesh), mesh)
    mesh_lib.close()
    out = run_ranks(STEP_ON_RANKS, 4, tmp_path)[0]
    real = json.loads(out.strip().splitlines()[-1])
    traced = tr.collective_record()
    del traced["dot_flops"]
    assert traced["collective_count"] and traced == real


# ------------------------------------ ten archs on the production mesh
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_arch_runs_a_train_forward_on_the_fake_production_mesh(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    try:
        with FakeTensorMode():
            _, args = steps.sharded_artifacts(
                cfg, InputShape("t", 16, 32, "train"), mesh)
            params, _, batch, _ = args
            with mesh:
                logits, _ = model.forward_train(params, batch)
                loss, _ = model.loss_fn(params, batch)
        assert isinstance(logits, DTensor) and isinstance(loss, DTensor)
        assert tuple(logits.shape) == (32, 16, cfg.vocab_size)
    finally:
        mesh_lib.close()


# ------------------------------------------- the kernels' registered ops
def test_kernel_route_traces_through_the_registered_ops():
    """Fake ``cuda`` tensors (no card needed): the model's entries take
    the kernels' route and each op's fake gives what its wrapper
    allocates."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    bf16, f32 = torch.bfloat16, torch.float32
    with FakeTensorMode():
        def t(*shape, dtype=bf16):
            return torch.empty(shape, device="cuda", dtype=dtype)
        q, k = t(2, 256, 4, 128), t(2, 256, 2, 128)
        out = ops.attention(q, k, k, q_offset=256)
        assert (out.shape, out.dtype, out.device.type) == (q.shape, bf16,
                                                           "cuda")
        qf, kf = t(8, 256, 128), t(4, 256, 128)
        o, lse = kfa.flash_attention(qf, kf, kf, return_lse=True)
        assert (o.shape, lse.shape, lse.dtype) == (qf.shape, (8, 256), f32)
        dq, dk, dv, dd, part = torch.ops.repro_torch.flash_attention_bwd(
            qf, kf, kf, o, o, lse, True, 0, 0)
        splits = kfa.bwd_splits(8, 4, 256, kfa.H100_SMS)
        assert [(tuple(x.shape), x.dtype) for x in (dq, dk, dv, dd, part)] \
            == [((8, 256, 128), bf16), ((4, 256, 128), bf16),
                ((4, 256, 128), bf16), ((8, 256), f32),
                ((splits, 2, 4, 256, 128), f32)]
        a = t(2, 64, 32, dtype=f32)
        h = ops.lru_scan(a, a)
        assert (h.shape, h.dtype) == (a.shape, f32)
        r, w, u = t(1, 48, 2, 64), t(1, 48, 2, 64, dtype=f32), t(2, 64,
                                                                 dtype=f32)
        y, state = ops.gla_chunked(r, r, r, w, u, chunk=16)
        assert (y.shape, y.dtype) == (r.shape, bf16)
        assert (state.shape, state.dtype) == ((1, 2, 64, 64), f32)
        outs = torch.ops.repro_torch.gla_chunked_bwd(r, r, r, w, u, r, None,
                                                     16)
        assert [(tuple(x.shape), x.dtype) for x in outs[:5]] == [
            (tuple(r.shape), bf16)] * 3 + [(tuple(w.shape), f32),
                                           ((2, 64), f32)]
        assert [x.numel() for x in outs[5:]] == [
            kgla.bwd_workspace_floats(1, 48, 2, part) for part in range(3)]
        assert kgla.bwd_workspace_floats(1, 48, 2, 0) == 2 * 3 * 64 * 64
        assert kgla.bwd_workspace_floats(1, 48, 2, 2) == 2 * 3 * 64
        # fp32 takes a query offset too (context parallelism's shards)
        q32, k32 = qf.float(), kf.float()
        o32, lse32 = kfa.flash_attention(q32, k32, k32, return_lse=True,
                                         q_offset=128)
        assert [(tuple(x.shape), x.dtype) for x in (o32, lse32)] == [
            ((8, 256, 128), f32), ((8, 256), f32)]
        outs = torch.ops.repro_torch.flash_attention_bwd(
            q32, k32, k32, o32, o32, lse32, True, 0, 128)
        assert [(tuple(x.shape), x.dtype) for x in outs] == [
            ((8, 256, 128), f32), ((4, 256, 128), f32), ((4, 256, 128), f32),
            ((8, 256), f32), ((splits, 2, 4, 256, 128), f32)]


# ---------------------------------------------------- the query offset
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_attention_ref_rows_at_an_offset_are_the_full_calls(causal, window):
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                   for s in ((6, 96, 32), (3, 96, 32), (3, 96, 32),
                             (6, 96, 32)))
    kw = dict(causal=causal, window=window)
    full, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    off = 40
    part, lse_o = ref.attention_ref(q[:, off:], k, v, return_lse=True,
                                    q_offset=off, **kw)
    assert torch.equal(part, full[:, off:]) and torch.equal(lse_o,
                                                            lse[:, off:])
    dq = ref.attention_bwd_ref(q, k, v, full, do, lse=lse, **kw)[0]
    dq_o = ref.attention_bwd_ref(q[:, off:], k, v, part, do[:, off:],
                                 lse=lse_o, q_offset=off, **kw)[0]
    assert torch.allclose(dq_o, dq[:, off:], rtol=0, atol=1e-6)


def test_constrain_takes_a_dtensors_own_mesh_off_the_mesh_thread(
        fake_mesh_2x2):
    """The ambient mesh (``with mesh:``) is thread-local: the autograd
    engine's device threads, which recompute remat cycles on the card,
    do not see it. ``constrain`` places a DTensor on its own mesh all
    the same, so a recompute pins the layouts its forward pinned."""
    import threading
    from repro_torch.sharding import rules
    mesh = fake_mesh_2x2
    x = DTensor.from_local(torch.zeros(4, 8), mesh,
                           [Replicate(), Replicate()], run_check=False)
    seen = {}

    def worker():
        seen["mesh"] = rules.current_mesh()
        seen["y"] = rules.constrain(x, "act_batch", None)
    with mesh:
        assert rules.current_mesh() is mesh
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert seen["mesh"] is None
    assert tuple(seen["y"].placements) == (Shard(0), Replicate())
