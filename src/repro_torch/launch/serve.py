"""Batched serving CLI: prefill + decode loop with a KV cache.

Greedy-decodes continuations for a batch of synthetic prompts on one
device (smoke scale: the arch's ``reduced()`` config), like the
reference's ``repro.launch.serve``: the prompt is fed through the
decode step token by token (its conditioning sequence with every
prompt step, for cross-attention archs), then ``--gen`` tokens are
generated (embedding-input archs get each generated token back through
the frontend stub, M-RoPE archs its position on all three streams).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import concrete_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Model


def frame_stub(tok: torch.Tensor, cfg) -> torch.Tensor:
    """The reference's frontend stub for embedding-input archs: a
    generated token id as the frame 0.02 · one_hot(id mod d_model)."""
    return torch.nn.functional.one_hot(
        tok.long() % cfg.d_model, cfg.d_model).to(cfg.torch_dtype) * 0.02


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    params = model.init(args.seed, device=dev)
    max_len = args.prompt_len + args.gen

    prompt = concrete_batch(cfg, args.batch, args.prompt_len,
                            torch.Generator().manual_seed(args.seed + 1),
                            kind="prefill", device=dev)

    cache = model.init_cache(args.batch, max_len, device=dev)
    serve_step = make_serve_step(model)

    t0 = time.time()
    # simple prefill-by-decode (teacher-forcing the prompt) keeps one
    # step function; a full prompt goes through model.prefill instead
    tok = None
    for t in range(args.prompt_len):
        db = {}
        if "tokens" in prompt:
            db["tokens"] = prompt["tokens"][:, t:t + 1]
        else:
            db["embeddings"] = prompt["embeddings"][:, t:t + 1]
        if "cond" in prompt:
            db["cond"] = prompt["cond"]
        if "mrope_positions" in prompt:
            db["mrope_positions"] = prompt["mrope_positions"][:, :, t:t + 1]
        tok, logits, cache = serve_step(params, cache, db, t)
    _sync(dev)
    prefill_s = time.time() - t0

    generated = []
    t0 = time.time()
    for t in range(args.prompt_len, max_len):
        db = {"tokens": tok[:, None]}
        if cfg.input_kind == "embeddings":
            # frontend stub: embed the generated token id as a frame
            db = {"embeddings": frame_stub(tok, cfg)[:, None]}
        if "mrope_positions" in prompt:
            db["mrope_positions"] = torch.full((3, args.batch, 1), t,
                                               dtype=torch.int32, device=dev)
        tok, logits, cache = serve_step(params, cache, db, t)
        generated.append(tok)
    _sync(dev)
    decode_s = time.time() - t0
    gen = torch.stack(generated, dim=1)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill {prefill_s:.2f}s | decode {decode_s:.2f}s "
          f"({args.gen*args.batch/decode_s:.1f} tok/s)")
    print("sample token ids:", [int(x) for x in gen[0][:12]])
    return gen


if __name__ == "__main__":
    main()
