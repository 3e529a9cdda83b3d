"""Beyond the paper's Fig. 2, through the PyTorch port: QuantumFed on
networks wider than the paper attempted. §IV-A caps the width at 3;
the port trains (3,3,3) and (3,4,3) (256-dim perceptron unitaries,
3-qubit data) under the same federated protocol, beside (2,3,2).

Each run is the ``FedSpec`` of ``benchmarks/fig2_wider.py`` (the JAX
script): N = 20 nodes, 5 a round, I_l = 2, 6 pairs a node, 40 rounds,
driven through the port's ``FederationSession``; its trajectories are
the port's own.

    PYTHONPATH=src python examples/torch_fig2_wider.py \
        [--iters 40] [--impl pallas|xla] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import time

from repro_torch.configs import qnn_232
from repro_torch.core.fed import api

ITERS = 40
WIDTHS = ((2, 3, 2), (3, 3, 3), (3, 4, 3))


def make_spec(widths, n_nodes=20, n_per_round=5, n_per_node=6, seed=42,
              impl: str = "xla") -> api.FedSpec:
    """The JAX script's spec for one width (its impl is "xla")."""
    spec = api.FedSpec.from_quantum_config(
        qnn_232.config(widths=widths, num_nodes=n_nodes,
                       nodes_per_round=n_per_round, interval_length=2),
        n_per_node=n_per_node, n_test=24, data_seed=seed)
    return dataclasses.replace(spec, impl=impl)


def run(spec: api.FedSpec, iters: int = ITERS, device="cuda"):
    sess = api.FederationSession.create(spec, 7, rounds=iters, device=device)
    t0 = time.perf_counter()
    hist = sess.run(iters, callbacks=[api.EvalEvery(max(iters // 4, 1))])
    return hist, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--impl", default="pallas", choices=("pallas", "xla"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("# QuantumFed beyond the paper's width limit")
    out = {}
    for widths in WIDTHS:
        hist, secs = run(make_spec(widths, impl=args.impl), args.iters,
                         args.device)
        xf = hist["test_fidelity"][-1]
        mid = hist["test_fidelity"][len(hist["test_fidelity"]) // 2]
        print(f"  {str(widths):12s} iter{args.iters}: test_fid={xf:.4f} "
              f"(mid {mid:.4f})  ({secs:.1f}s)")
        out[widths] = hist
    return out


if __name__ == "__main__":
    main()
