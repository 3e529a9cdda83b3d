"""Quickstart, PyTorch port: train a 2-3-2 quantum neural network with
QuantumFed through the port's federation front door
(``repro_torch.core.fed.api``), on the GPU.

Reproduces the paper's core experiment at small scale: 100 quantum
nodes with non-iid local data, 10 sampled per iteration, interval
length 2, fidelity cost driven to ~1. The whole experiment — data
recipe included — is ONE declarative ``FedSpec`` (the same spec the JAX
quickstart runs); the session adds eval streaming, early stop at the
fidelity target, and (optionally) kill-and-resume checkpointing.

    PYTHONPATH=src python examples/torch_quickstart.py [--iters 50] \
        [--ckpt fed.npz] [--impl pallas|xla] [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given. With
``--impl pallas`` (the default here) the round runs the port's CUDA
kernels; on the CPU they fall back to their plain versions. The port
draws its data, initial params and cohorts from its own seeded streams,
so its trajectory is its own, not the JAX run's.
"""
import argparse

from repro_torch.core.fed import api

WIDTHS = (2, 3, 2)          # the paper's network


def make_spec(impl: str = "pallas") -> api.FedSpec:
    """The paper's experiment, declaratively: clean pairs (|phi>,
    U_g|phi>) for a hidden target unitary, split non-iid (sorted)
    across 100 nodes."""
    return api.FedSpec.quantum(
        widths=WIDTHS,
        num_nodes=100,          # N
        nodes_per_round=10,     # N_p
        interval_length=2,      # I_l (local steps per round)
        eta=1.0, eps=0.1,       # paper's hyperparameters
        aggregation="product",  # Eq. 6 (exact unitary products)
        impl=impl,
        n_per_node=4, n_test=32, data_seed=42,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ckpt", help="checkpoint path (enables resume)")
    ap.add_argument("--impl", default="pallas", choices=("pallas", "xla"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = make_spec(args.impl)
    print(spec.to_json(indent=1))

    sess = api.FederationSession.create(spec, 7, rounds=args.iters,
                                        device=args.device)
    callbacks = [api.EvalEvery(10, verbose=True),
                 api.EarlyStop("test_fidelity", target=0.9999)]
    if args.ckpt:
        callbacks.append(api.Checkpointer(args.ckpt, every=10))
    hist = sess.run(args.iters, callbacks=callbacks)

    print(f"\nfinal: train fidelity {hist['train_fidelity'][-1]:.4f}, "
          f"test fidelity {hist['test_fidelity'][-1]:.4f} "
          f"(paper: ~1.0 after 50 iterations)")
    if args.iters >= 50 or hist["iteration"][-1] < args.iters:
        if not hist["test_fidelity"][-1] > 0.95:
            raise RuntimeError("test fidelity did not reach 0.95")
    return hist


if __name__ == "__main__":
    main()
