"""End-to-end system tests of the PyTorch port on the CPU: train →
checkpoint → restore → serve, and the CLIs (the port of
tests/test_system.py).

The five cases of the reference's file are marked ``slow`` as the
reference's are (the shared fixture trains for 40 steps and the CLIs
run real training loops), so tier-1 skips them (pytest.ini); run them
with ``pytest -m slow``. One fast case runs in tier-1: launch/train.py
at a tiny size with ``--ckpt``, then ``--restore``, the checkpoint read
back bit for bit, and the continuous batcher on the restored params
against the batcher on the params in memory."""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_serve_step, make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402

# the harness's per-step logits (one copy, in chip_smoke.py)
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tiny models; see tests/test_torch_serving.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_requests(cfg, params):
    """Three requests through a 2-slot batcher on the CPU; each request's
    tokens and per-step logits."""
    model = Model(cfg)
    rng = np.random.default_rng(3)
    b = ContinuousBatcher(model, params, n_slots=2, max_len=32, device="cpu")
    kept = chip_smoke.keep_logits(b)
    for uid, (n, m) in enumerate([(5, 4), (3, 6), (7, 3)]):
        b.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=m))
    b.run_until_drained()
    return {uid: (r.generated, torch.stack(kept[uid]))
            for uid, r in b.completed.items()}


def test_train_ckpt_restore_then_serve(tmp_path, monkeypatch):
    """``launch/train.py`` with ``--ckpt A`` for 4 steps, then ``--restore
    A --steps 6 --ckpt B``: A and B read back bit for bit as the params
    ``main`` held when it saved them, the second run starts at step 4
    from A's params, and the batcher serves the restored B exactly as the
    params in memory."""
    saved, restored = [], []
    save, restore = ckpt.save, ckpt.restore

    def saving(path, params, **kw):
        saved.append((path, kw["step"], {k: v.clone()
                                         for k, v in params.items()}))
        return save(path, params, **kw)

    def restoring(path, device="cuda"):
        params, meta = restore(path, device=device)
        # a copy: the optimizer in ``main`` then updates params in place
        restored.append(({k: v.clone() for k, v in params.items()}, meta))
        return params, meta

    monkeypatch.setattr(train.ckpt, "save", saving)
    monkeypatch.setattr(train.ckpt, "restore", restoring)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    common = ["--arch", "recurrentgemma-2b", "--scale", "smoke", "--batch",
              "2", "--seq", "16", "--log-every", "1", "--device", "cpu"]
    loss_a = train.main(common + ["--steps", "4", "--ckpt", a])
    loss_b = train.main(common + ["--steps", "6", "--restore", a,
                                  "--ckpt", b])
    assert np.isfinite(loss_a) and np.isfinite(loss_b)
    assert [(p, s) for p, s, _ in saved] == [(a, 4), (b, 6)]
    (got_a, meta_a), = restored
    assert meta_a["step"] == 4
    assert meta_a["extra"] == {"arch": "recurrentgemma-2b-smoke"}
    for path, _, held in saved:
        back, _ = restore(path, device="cpu")
        assert sorted(back) == sorted(held)
        for k in held:
            assert back[k].dtype == held[k].dtype
            assert torch.equal(back[k], held[k]), (path, k)
    held_a, held_b = saved[0][2], saved[1][2]
    assert all(torch.equal(got_a[k], held_a[k]) for k in held_a)
    assert any(not torch.equal(held_a[k], held_b[k]) for k in held_a)

    cfg = get_config("recurrentgemma-2b").reduced()
    from_disk = serve_requests(cfg, restore(b, device="cpu")[0])
    in_memory = serve_requests(cfg, held_b)
    assert from_disk.keys() == in_memory.keys() == {0, 1, 2}
    for uid, (toks, logits) in in_memory.items():
        assert from_disk[uid][0] == toks
        assert torch.equal(from_disk[uid][1], logits)


# ------------------------------------- tests/test_system.py on the port
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    torch.set_num_threads(1)
    cfg = get_config("qwen1.5-4b").reduced(n_layers=2)
    model = Model(cfg)
    opt = AdamW(weight_decay=0.0)
    params = model.init(0, device="cpu")
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    data = token_batches(cfg, 8, 64, seed=0, device="cpu")
    losses = []
    for _ in range(40):
        params, opt_state, metrics = step(params, opt_state, next(data),
                                          3e-3)
        losses.append(float(metrics["loss"]))
    path = str(tmp_path_factory.mktemp("ck") / "model.npz")
    ckpt.save(path, params, step=40, extra={"arch": cfg.name})
    return cfg, model, params, losses, path


@pytest.mark.slow
def test_training_reduces_loss(trained):
    _, _, _, losses, _ = trained
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)
    assert np.isfinite(losses).all()


@pytest.mark.slow
def test_checkpoint_restore_identical_loss(trained):
    cfg, model, params, _, path = trained
    restored, meta = ckpt.restore(path, device="cpu")
    assert meta["step"] == 40
    batch = next(token_batches(cfg, 4, 64, seed=7, device="cpu"))
    with torch.no_grad():
        l1 = float(model.loss_fn(params, batch)[0])
        l2 = float(model.loss_fn(restored, batch)[0])
    np.testing.assert_allclose(l1, l2, rtol=1e-6)


@pytest.mark.slow
def test_serve_after_training(trained):
    cfg, model, params, _, _ = trained
    serve = make_serve_step(model)
    cache = model.init_cache(2, 24, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    toks = []
    with torch.no_grad():
        for t in range(8):
            nxt, logits, cache = serve(params, cache, {"tokens": tok}, t)
            assert tuple(logits.shape) == (2, cfg.vocab_size)
            assert bool(torch.isfinite(logits).all())
            tok = nxt[:, None]
            toks.append(nxt)
    # trained-on-bigram model should not emit all-identical garbage
    assert len({int(x) for x in torch.stack(toks).ravel()}) > 1


@pytest.mark.slow
def test_fed_driver_runs():
    from repro_torch.launch import fed_train
    params = fed_train.main(["--arch", "qwen1.5-4b", "--rounds", "2",
                             "--interval", "2", "--nodes", "4",
                             "--nodes-per-round", "2", "--node-batch",
                             "4", "--seq", "32", "--device", "cpu"])
    assert params is not None


@pytest.mark.slow
def test_train_driver_runs(tmp_path):
    loss = train.main(["--arch", "rwkv6-7b", "--scale", "smoke",
                       "--steps", "6", "--batch", "4", "--seq", "32",
                       "--log-every", "3", "--device", "cpu",
                       "--ckpt", str(tmp_path / "r.npz")])
    assert np.isfinite(loss)
    assert os.path.exists(tmp_path / "r.npz")
