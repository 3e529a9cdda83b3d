"""Print the top rows of a profiled call (``trace_parse.profile``): the
port's counterpart of ``repro.roofline.breakdown``, which ranks an HLO
module's collectives and dots.

    PYTHONPATH=src python -m repro_torch.roofline.breakdown \
        --arch recurrentgemma-2b --batch 4 --seq 4096

profiles one prefill at published width with random weights on the card
(``--device cpu --reduced --seq 64`` for a small CPU run: ops counted,
no time) and prints the device time by family and the top kernels.
"""
from __future__ import annotations

import argparse
from typing import Callable

from repro_torch.roofline.trace_parse import Trace


def lines(trace: Trace, label: str, top: int = 8):
    """The header line (wall, busy share, device ops) and the top ops by
    device time (by count without a card)."""
    if trace.busy_us is None:
        out = [f"profile {label}: wall {trace.wall_us / 1e3:.3f} ms (host, "
               f"CPU run: no device time), {trace.launches} CPU ops"]
        rows = sorted(trace.by_op.items(), key=lambda kv: -kv[1][1])[:top]
        return out + [f"  {'':>9s}     x{n:5d}  {name[:70]}"
                      for name, (_, n) in rows]
    out = [f"profile {label}: wall {trace.wall_us / 1e3:.3f} ms, device "
           f"busy {trace.busy_us / 1e3:.3f} ms "
           f"({100 * trace.busy_share:.1f}%), {trace.launches} device ops"]
    rows = sorted(trace.by_op.items(), key=lambda kv: -kv[1][0])[:top]
    return out + [f"  {us / 1e3:9.3f} ms  x{n:5d}  {name[:70]}"
                  for name, (us, n) in rows]


def family_lines(trace: Trace):
    rows = sorted(trace.by_family.items(),
                  key=lambda kv: (-(kv[1][0] or 0.0), -kv[1][1]))
    return [f"  {fam:26s} "
            + ("" if us is None else f"{us / 1e3:9.3f} ms ")
            + f"x{n:5d}" for fam, (us, n) in rows]


def show(trace: Trace, label: str, say: Callable = print, top: int = 8):
    for line in lines(trace, label, top):
        say(line)


def main():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    from repro_torch.roofline.trace_parse import profile
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() smoke widths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    params = model.init(seed=0, device=args.device)
    batch = concrete_batch(cfg, args.batch, args.seq,
                           torch.Generator().manual_seed(0), kind="prefill",
                           device=args.device)
    step = make_prefill_step(model)
    with torch.no_grad():
        step(params, batch)
        trace = profile(lambda: step(params, batch))
    show(trace, f"{args.arch} prefill B={args.batch} S={args.seq}",
         top=args.top)
    for line in family_lines(trace):
        print(line)


if __name__ == "__main__":
    main()
