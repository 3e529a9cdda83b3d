"""The seven architectures of tests/test_torch_archs.py (the ``moe``
kind, M-RoPE, cross-attention and embedding inputs) through the port's
serving and training paths on the CPU, each at its ``reduced()`` config
(fp32): decode against the port's own full forward, a train step, the
microbatched loss against the reference's, the serve and train CLIs,
and the conversion of stacked and unstacked params of the new kinds.

Tolerances:

- decode against the full forward: the reference's gate of
  tests/test_decode_consistency.py (2e-3 abs and rel), on the port's
  init (seed 0) and batch, as that test runs on the reference's;
- a train step: the reference's gate of tests/test_models_smoke.py (a
  finite loss in (0, 20), finite gradients, and a step down at some lr);
- the microbatched loss: 1e-5 of the reference's (tests/test_torch_archs
  .py's loss tolerance); conversions exact.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import concrete_batch as jconcrete_batch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import concrete_batch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = ["arctic-480b", "command-r-35b", "gemma3-27b", "llama3-405b",
         "llama4-scout-17b-a16e", "musicgen-large", "qwen2-vl-72b"]
LOSS_TOL = 1e-5
B, T = 2, 80         # past gemma3's reduced window of 64
T_DECODE = 16        # tests/test_decode_consistency.py's T


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, cfg, model, the port's init (seed 0), the port's batch of B
    x T with labels)."""
    arch = request.param
    cfg = get_config(arch).reduced()
    m = Model(cfg)
    batch = concrete_batch(cfg, B, T, torch.Generator().manual_seed(1),
                           kind="train", device="cpu")
    return arch, cfg, m, m.init(seed=0, device="cpu"), batch


def inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def decode_all(m, tp, batch, n):
    """Token-by-token decode of the batch's first n positions from an
    empty cache, the reference's tests/test_decode_consistency.py loop."""
    cache = m.init_cache(B, n, device="cpu")
    steps = []
    for i in range(n):
        db = {}
        if "tokens" in batch:
            db["tokens"] = batch["tokens"][:, i:i + 1]
        else:
            db["embeddings"] = batch["embeddings"][:, i:i + 1]
        if "cond" in batch:
            db["cond"] = batch["cond"]
        if "mrope_positions" in batch:
            db["mrope_positions"] = batch["mrope_positions"][:, :, i:i + 1]
        logits, cache = m.decode_step(tp, db, cache, i)
        steps.append(logits)
    return torch.stack(steps, 1), cache


def test_decode_matches_forward(case):
    """The reference's case: T = 16, cond and M-RoPE positions handed to
    every step. gemma3 also decodes 80 positions (past its window)."""
    arch, cfg, m, tp, batch = case
    n = T if arch == "gemma3-27b" else T_DECODE
    part = {k: (v[:, :, :n] if k == "mrope_positions" else
                v if k == "cond" else v[:, :n])
            for k, v in inputs(batch).items()}
    full, _ = m.forward_train(tp, part)
    dec, _ = decode_all(m, tp, part, n)
    np.testing.assert_allclose(dec.numpy(), full.detach().numpy(),
                               atol=2e-3, rtol=2e-3)


def test_decode_after_prefill_reads_the_cached_conditioning(case):
    """Prefill, then decode steps without cond and without M-RoPE
    positions (the forward derives them from cur_len): equal to the full
    forward's logits at those positions."""
    arch, cfg, m, tp, batch = case
    p, n = 40, 8
    first = {k: (v[:, :, :p] if k == "mrope_positions" else
                 v if k == "cond" else v[:, :p])
             for k, v in inputs(batch).items()}
    both = {k: (v[:, :, :p + n] if k == "mrope_positions" else
                v if k == "cond" else v[:, :p + n])
            for k, v in inputs(batch).items()}
    full, _ = m.forward_train(tp, both)
    _, cache = m.prefill(tp, first)
    cache = m.extend_cache(cache, p + n)
    for i in range(p, p + n):
        db = ({"tokens": batch["tokens"][:, i:i + 1]} if "tokens" in batch
              else {"embeddings": batch["embeddings"][:, i:i + 1]})
        logits, cache = m.decode_step(tp, db, cache, i)
        if cfg.n_experts:   # capacity differs from the full forward's
            continue
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, i].detach().numpy(),
                                   atol=2e-3, rtol=2e-3)
    assert bool(torch.isfinite(logits).all())


def test_train_step_descends(case):
    """tests/test_models_smoke.py's train-step case on the port: its batch
    of 2 x 32 (at the reference init the loss is rough at the step sizes
    it tries; the gradient itself is autograd's)."""
    arch, cfg, m, params, _ = case
    pb = concrete_batch(cfg, 2, 32, torch.Generator().manual_seed(1),
                        kind="train", device="cpu")
    loss, _, grads = value_and_grad(m.loss_fn, params, pb)
    assert np.isfinite(float(loss)) and 0.0 < float(loss) < 20.0
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
    descended = False
    for lr in (0.5, 0.2, 0.05, 0.01):
        stepped = {k: v - lr * grads[k] for k, v in params.items()}
        if float(m.loss_fn(stepped, pb)[0]) < float(loss):
            descended = True
            break
    assert descended, f"no descent at any lr for {arch}"


def test_microbatched_loss_splits_mrope_positions():
    """qwen2-vl at microbatch 1: M-RoPE positions (3, B, S) split on axis
    1; the mean of the microbatch losses equals the reference's."""
    arch = "qwen2-vl-72b"
    cfg = get_config(arch).reduced(microbatch=1)
    jcfg = jget_config(arch).reduced(microbatch=1)
    jm, m = JModel(jcfg), Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.model_params_to_torch({k: np.asarray(v) for k, v in
                                        jp.items()}, cfg, device="cpu")
    jb = jconcrete_batch(jcfg, B, 24, jax.random.PRNGKey(3), kind="train")
    pb = port_batch({k: np.asarray(v) for k, v in jb.items()})
    pb["mrope_positions"][1] += 5         # streams differ
    jb["mrope_positions"] = jb["mrope_positions"].at[1].add(5)
    mbs = m.microbatches(pb)
    assert [tuple(x["mrope_positions"].shape) for x in mbs] == [(3, 1, 24)] * 2
    assert torch.equal(mbs[1]["mrope_positions"], pb["mrope_positions"][:, 1:])
    loss, _ = m.loss_fn(tp, pb)
    jloss, _ = jm.loss_fn(jp, jb)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b",
                                  "llama4-scout-17b-a16e"])
def test_serve_and_train_drivers_on_the_cpu(arch, capsys):
    """launch/serve.py (embedding inputs, cond, M-RoPE) and launch/train.py
    at smoke scale take the new archs."""
    gen = serve_cli.main(["--arch", arch, "--batch", "2", "--prompt-len",
                          "6", "--gen", "4", "--device", "cpu"])
    assert gen.shape == (2, 4)
    loss = train_cli.main(["--arch", arch, "--steps", "2", "--batch", "2",
                           "--seq", "16", "--log-every", "1", "--device",
                           "cpu"])
    assert np.isfinite(loss)
    assert f"arch={arch}-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("arch,pattern", [
    ("arctic-480b", ("moe", "attn")),
    ("llama4-scout-17b-a16e", ("moe", "attn")),
    ("musicgen-large", ("attn", "local"))])
def test_convert_stacked_and_unstacked_new_paths(arch, pattern):
    """Expert stacks (E, d, f), router, dense / shared FFNs, xattn and
    ln_x with the layer axis (stack/) and without it (rem/)."""
    over = dict(block_pattern=pattern, n_layers=3)
    cfg, jcfg = get_config(arch).reduced(**over), jget_config(arch).reduced(
        **over)
    jp = {k: np.asarray(v) for k, v in
          JModel(jcfg).init(jax.random.PRNGKey(2)).items()}
    tp = convert.model_params_to_torch(jp, cfg, device="cpu")
    rem = [k for k in tp if k.startswith("rem/0/")]
    new = ("moe/w_in", "moe/router", "moe/dense/w_in", "moe/shared/w_out",
           "xattn/wq", "ln_x")
    assert any(n in k for k in rem for n in new)
    for k, v in convert.model_params_to_numpy(tp).items():
        np.testing.assert_array_equal(v, jp[k], err_msg=k)
    if cfg.n_experts:
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert tuple(tp["stack/0/moe/moe/w_in"].shape) == (1, e, d, f)
        assert tuple(tp["rem/0/moe/moe/w_in"].shape) == (e, d, f)
