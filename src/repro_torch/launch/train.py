"""End-to-end training driver (the port of ``repro.launch.train``).

Builds the model from --arch (``.reduced()`` under --scale smoke),
streams the synthetic bigram data, runs ``make_train_step`` (AdamW,
linear warmup then cosine) on one device, logs loss and throughput, and
saves / restores params in the reference's npz checkpoint format. Runs
on the card unless ``--device cpu`` is asked for.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --scale smoke --steps 200 --batch 16 \\
        --seq 128
"""
from __future__ import annotations

import argparse
import time

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamW, linear_warmup_cosine


def optimizer(cfg) -> AdamW:
    """The optimizer ``main`` trains with: AdamW with the config's state
    dtype, weight decay 0.01 and the default clip of the global norm to
    1."""
    return AdamW(state_dtype=cfg.opt_state_dtype, weight_decay=0.01)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--restore", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="override layer count (smoke scale)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        over = {"n_layers": args.n_layers} if args.n_layers else {}
        cfg = cfg.reduced(**over)
    model = Model(cfg)
    opt = optimizer(cfg)
    schedule = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    print(f"arch={cfg.name} params≈{model.num_params()/1e6:.1f}M "
          f"device={dev}")

    params = model.init(args.seed, device=dev)
    opt_state = opt.init(params)
    step0 = 0
    if args.restore:
        params, meta = ckpt.restore(args.restore, device=dev)
        step0 = meta["step"]
        print(f"restored step {step0} from {args.restore}")

    train_step = make_train_step(model, opt)
    data = token_batches(cfg, args.batch, args.seq, seed=args.seed,
                         device=dev)

    t0 = time.time()
    tokens_done = 0
    metrics = None
    for step in range(step0, args.steps):
        batch = next(data)
        lr = schedule(step)
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                lr)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == step0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step+1:5d}  loss {loss:.4f}  "
                  f"lr {float(lr):.2e}  tok/s {tokens_done/dt:,.0f}")
    if args.ckpt:
        ckpt.save(args.ckpt, params, step=args.steps,
                  extra={"arch": cfg.name})
        print(f"saved {args.ckpt}")
    if metrics is None:
        raise ValueError(f"no step to run: restored step {step0} of "
                         f"{args.steps}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
