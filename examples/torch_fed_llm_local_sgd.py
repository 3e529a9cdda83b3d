"""QuantumFed's technique on a classical LM, PyTorch port:
interval-length local updates + weighted delta aggregation (the
Lemma-1 additive form) — i.e. local-SGD / DiLoCo — through the port's
federation front door (``repro_torch.core.fed.api``), on the GPU.

The same ``FedSpec`` the JAX example runs, with the ``"full"``
participation schedule (every node, every round, identity order) so
per-node optimizer state stays aligned with its node. It shows the
communication/interval trade-off the paper's §III-D.2 claims: larger
I_l means fewer synchronizations for the same number of local steps,
at (near) equal loss.

    PYTHONPATH=src python examples/torch_fed_llm_local_sgd.py [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given. The
port draws its initial params from its own seeded stream (the data are
the reference's tokens), so its losses are its own, not the JAX run's.
"""
import argparse

from repro_torch.core.fed import api

NODES = 4
TOTAL_LOCAL_STEPS = 8


def make_spec(interval: int) -> api.FedSpec:
    return api.FedSpec.classical(
        arch="qwen1.5-4b", n_layers=2,
        num_nodes=NODES, nodes_per_round=NODES,
        interval_length=interval, participation="full",
        lr=3e-3, node_batch=4, node_pool_seqs=4 * interval,
        seq_len=64, data_seed=1)


def run(interval: int, device: str = "cuda"):
    sess = api.FederationSession.create(make_spec(interval), 0,
                                        device=device)
    rounds = TOTAL_LOCAL_STEPS // interval
    hist = sess.run(rounds, callbacks=[api.EvalEvery(rounds)])
    return hist["eval_loss"][-1], rounds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"{NODES} federated nodes, {TOTAL_LOCAL_STEPS} local steps total")
    for interval in (1, 2, 4):
        loss, rounds = run(interval, args.device)
        print(f"  I_l={interval}: {rounds} synchronizations -> "
              f"eval loss {loss:.4f}")
    print("larger interval = fewer cross-node all-reduces, similar loss")


if __name__ == "__main__":
    main()
