"""Continuous-batching serving example on the PyTorch port: requests of
different lengths stream through a fixed 2-slot grid; finished sequences
free their slot immediately for queued requests (vLLM-style scheduling at
smoke scale). The port of examples/continuous_batching.py; runs on the
card unless ``--device cpu`` is asked for.

    PYTHONPATH=src python examples/torch_continuous_batching.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("qwen1.5-4b").reduced(n_layers=2)
    model = Model(cfg)
    params = model.init(0, device=args.device)

    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=int(n)).astype(np.int32),
                max_new_tokens=int(m))
        for i, (n, m) in enumerate([(6, 4), (3, 12), (8, 6), (4, 3),
                                    (5, 8)])
    ]

    batcher = ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                device=args.device)
    for r in requests:
        batcher.submit(r)
    t0 = time.time()
    batcher.run_until_drained()
    dt = time.time() - t0

    total_new = sum(len(r.generated) for r in batcher.completed.values())
    print(f"served {len(requests)} requests through 2 slots in "
          f"{batcher.steps_run} steps ({dt:.1f}s, {total_new} new tokens)")
    for uid in sorted(batcher.completed):
        r = batcher.completed[uid]
        print(f"  req {uid}: prompt {len(r.prompt):2d} tok -> "
              f"generated {r.generated}")
    return batcher


if __name__ == "__main__":
    main()
