"""Paper Fig. 3 at example scale, PyTorch port: QuantumFed robustness
to polluted training data. Trains with 30% and 70% random pairs and
evaluates on clean test data. The run config comes from the
strategy-driven ``repro_torch.configs.qnn_232.config`` helper
(registry-validated) rather than raw aggregation strings. The port
draws its data and cohorts from its own seeded streams, so its
trajectories are its own, not the JAX example's.

    PYTHONPATH=src python examples/torch_noise_robustness.py [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch.configs import qnn_232
from repro_torch.core.quantum import data as qdata
from repro_torch.core.quantum import federated as fed


def run(noise, device="cuda", n_iterations=40):
    _, dataset, test = qdata.make_federated_dataset(
        torch.Generator().manual_seed(42), n_qubits=2, num_nodes=50,
        n_per_node=4, noise_ratio=noise, n_test=32, device=device)
    cfg = qnn_232.config(num_nodes=50, nodes_per_round=10,
                         interval_length=2)
    _, hist = fed.train(7, cfg, dataset, test, n_iterations=n_iterations,
                        eval_every=n_iterations)
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    clean = run(0.0, args.device, args.iters)["test_fidelity"][-1]
    out = {0.0: clean}
    for noise in (0.3, 0.7):
        h = run(noise, args.device, args.iters)
        out[noise] = h["test_fidelity"][-1]
        print(f"noise {int(noise*100)}%: clean-test fidelity "
              f"{out[noise]:.4f} (clean baseline {clean:.4f})")
    print("paper's claim: performance stays acceptable up to ~70% noise")
    return out


if __name__ == "__main__":
    main()
