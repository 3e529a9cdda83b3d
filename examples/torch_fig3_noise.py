"""Paper Fig. 3 through the PyTorch port: robustness to noisy training
data. The 2-3-2 QNN trained on data with 10%..90% of its pairs replaced
by random ones (the port's ``data.pollute``), evaluated on the noisy
train data and on CLEAN test data. The paper's claim: the final test
performance is unharmed up to ~50% noise, acceptable at 70%, degraded
at 90%.

Each run is the ``FedSpec`` of ``benchmarks/fig3_noise.py`` (the JAX
script; ``data_noise`` is the ratio), driven through the port's
``FederationSession``; its trajectories are the port's own.

    PYTHONPATH=src python examples/torch_fig3_noise.py \
        [--iters 50] [--impl pallas|xla] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import time

from repro_torch.configs import qnn_232
from repro_torch.core.fed import api

N_PER_NODE = 4
ITERS = 50
RATIOS = (0.1, 0.3, 0.5, 0.7, 0.9)


def make_spec(noise: float, seed: int = 42,
              impl: str = "xla") -> api.FedSpec:
    """The JAX script's spec for one noise ratio (its impl is "xla")."""
    spec = api.FedSpec.from_quantum_config(
        qnn_232.config(interval_length=2), n_per_node=N_PER_NODE,
        n_test=32, data_seed=seed, data_noise=noise)
    return dataclasses.replace(spec, impl=impl)


def run(spec: api.FedSpec, iters: int = ITERS, device="cuda"):
    sess = api.FederationSession.create(spec, 7, rounds=iters, device=device)
    t0 = time.perf_counter()
    hist = sess.run(iters, callbacks=[api.EvalEvery(iters)])
    return hist, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--impl", default="pallas", choices=("pallas", "xla"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("# Fig.3: noise robustness (noisy train data, clean test data)")
    out = {}
    for ratio in RATIOS:
        hist, secs = run(make_spec(ratio, impl=args.impl), args.iters,
                         args.device)
        tf, xf = hist["train_fidelity"][-1], hist["test_fidelity"][-1]
        print(f"  noise={int(ratio * 100):2d}%  iter{args.iters}: "
              f"train_fid={tf:.4f} (noisy) test_fid={xf:.4f} (clean) "
              f"({secs:.1f}s)")
        out[ratio] = hist
    return out


if __name__ == "__main__":
    main()
