"""Paper Fig. 2 through the PyTorch port: the 2-3-2 QNN under QuantumFed
with interval lengths 1, 2 and 4, and 2 with SGD (mini-batch 2).
Reports fidelity and MSE on train and test after 50 rounds; the paper's
claim: all reach fidelity ~1, a longer interval converges faster per
round, SGD a little slower to the same quality.

Each run is the ``FedSpec`` of ``benchmarks/fig2_interval.py`` (the JAX
script), driven through the port's ``FederationSession`` with the
pre-split round-key plan (``create(..., rounds=iters)``). The port's
data and draws come from its own seeded streams, so its trajectories
are its own, not the JAX run's.

    PYTHONPATH=src python examples/torch_fig2_interval.py \
        [--iters 50] [--impl pallas|xla] [--device cpu]

It runs on the card unless ``--device cpu`` is given; ``--impl pallas``
(the default) runs the port's CUDA kernels.
"""
import argparse
import dataclasses
import time

from repro_torch.configs import qnn_232
from repro_torch.core.fed import api

N_NODES, N_PER_ROUND, N_PER_NODE = 100, 10, 4
ITERS = 50
RUNS = (("I_l=1", 1, None), ("I_l=2", 2, None), ("I_l=4", 4, None),
        ("I_l=2_SGD(mb=2)", 2, 2))


def make_spec(interval: int, minibatch=None, seed: int = 42,
              impl: str = "xla") -> api.FedSpec:
    """The JAX script's spec for one run (its impl is "xla"); ``impl``
    picks the port's route."""
    spec = api.FedSpec.from_quantum_config(
        qnn_232.config(interval_length=interval, minibatch=minibatch),
        n_per_node=N_PER_NODE, n_test=32, data_seed=seed)
    return dataclasses.replace(spec, impl=impl)


def run(spec: api.FedSpec, iters: int = ITERS, device="cuda"):
    sess = api.FederationSession.create(spec, 7, rounds=iters, device=device)
    t0 = time.perf_counter()
    hist = sess.run(iters, callbacks=[api.EvalEvery(max(iters // 5, 1))])
    return hist, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--impl", default="pallas", choices=("pallas", "xla"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("# Fig.2: interval lengths (2-3-2 QNN, N=100, N_p=10, eps=0.1)")
    out = {}
    for label, interval, mb in RUNS:
        hist, secs = run(make_spec(interval, mb, impl=args.impl),
                         args.iters, args.device)
        tf, xf = hist["train_fidelity"][-1], hist["test_fidelity"][-1]
        tm, xm = hist["train_mse"][-1], hist["test_mse"][-1]
        # fidelity at the mid-point shows convergence speed
        mid = hist["train_fidelity"][len(hist["train_fidelity"]) // 2]
        print(f"  {label:16s} iter{args.iters}: train_fid={tf:.4f} "
              f"test_fid={xf:.4f} train_mse={tm:.4f} test_mse={xm:.4f} "
              f"mid_fid={mid:.4f} ({secs:.1f}s)")
        out[label] = hist
    return out


if __name__ == "__main__":
    main()
