"""Federated training driver — QuantumFed's Alg. 1/2 on classical
models, driven through the federation front door
(``repro_torch.core.fed.api``): build or load a ``FedSpec``, open a
``FederationSession``, run rounds with checkpoint/resume (the port of
``repro.launch.fed_train``, with its flags and round lines). Single-host
simulation: N nodes, node subsampling (Alg. 2 step 3), non-iid
sort-based partitioning. Runs on the card unless ``--device cpu`` is
asked for.

    PYTHONPATH=src python -m repro_torch.launch.fed_train \\
        --arch qwen1.5-4b --rounds 10 --interval 4 --nodes 8 \\
        --nodes-per-round 4 --ckpt fed.npz --ckpt-every 5

    # later, continue bit-exactly where the killed run stopped:
    PYTHONPATH=src python -m repro_torch.launch.fed_train \\
        --resume fed.npz --rounds 5

    # or drive everything from a declarative spec file:
    PYTHONPATH=src python -m repro_torch.launch.fed_train \\
        --spec spec.json --rounds 10

The port's keys are ints (``api/rng.py``): params come from the model
seed ``data_seed`` and round keys from the sequential split of
``data_seed + 7``, the reference's conventions on the port's own
streams.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.fed import api, participation


class _RoundLog(api.Callback):
    """Legacy driver output: per-round eval + train loss + wall time."""

    def __init__(self):
        self.t0 = time.time()

    def on_run_begin(self, session):
        if session.round == 0:
            l0 = session.evaluate()["eval_loss"]
            print(f"round  0  eval loss {l0:.4f}")

    def on_round_end(self, session, metrics):
        m = session.record_eval()
        train = metrics.get("loss")
        # an async commit may consume only buffered uploads — no fresh
        # local pass, hence no train loss for that round
        ts = f"{float(train):.4f}" if train is not None else "(buffered)"
        print(f"round {session.round:2d}  eval loss {m['eval_loss']:.4f}  "
              f"train loss {ts}  ({time.time()-self.t0:.0f}s)")


def _extend_key_plan(sess, rounds: int) -> None:
    """Resuming past the stored round-key plan: the sequential-split
    stream is prefix-stable, so regrow the plan from the driver's seed
    convention (``data_seed + 7``) — the 2-round-then-resume run and the
    uninterrupted longer run then use identical keys. A plan this driver
    did not produce is left alone (fold_in fallback)."""
    need = sess.round + rounds
    plan = sess.round_keys
    if plan is None or len(plan) >= need:
        return
    grown = api.sequential_split_plan(sess.spec.data_seed + 7, need)
    if grown[:len(plan)] == list(plan):
        sess.round_keys = grown
    else:
        print(f"warning: stored round-key plan ({len(plan)} keys) is "
              f"not this driver's; rounds past it use the fold_in "
              "schedule")


def build_spec(args) -> api.FedSpec:
    if args.spec:
        with open(args.spec) as f:
            return api.FedSpec.from_json(f.read())
    if not args.arch:
        raise SystemExit("need --arch (or --spec / --resume)")
    sizes = (tuple(int(x) for x in args.node_sizes.split(","))
             if args.node_sizes else None)
    return api.FedSpec.classical(
        arch=args.arch, num_nodes=args.nodes,
        nodes_per_round=args.nodes_per_round,
        interval_length=args.interval, lr=args.lr, outer_lr=args.outer_lr,
        participation=args.participation, dropout_rate=args.dropout,
        participation_method=args.participation_method,
        node_batch=args.node_batch, seq_len=args.seq, node_sizes=sizes,
        data_iid=args.iid, data_seed=args.seed,
        schedule=args.schedule, async_commit=args.async_commit,
        server_opt=args.server_opt, server_momentum=args.server_momentum)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--spec", help="path to a FedSpec JSON file "
                    "(overrides the per-field flags)")
    ap.add_argument("--resume", help="continue a checkpointed session "
                    "bit-exactly")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--interval", type=int, default=2,
                    help="I_l: local steps per round")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--nodes-per-round", type=int, default=4)
    ap.add_argument("--node-batch", type=int, default=4)
    ap.add_argument("--node-sizes", help="comma-separated per-node "
                    "sequence counts (unequal data volumes, e.g. 2,4,8)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--outer-lr", type=float, default=1.0)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--participation", default="uniform",
                    choices=participation.SCHEDULES,
                    help="node-selection schedule (shared registry)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="straggler rate for --participation dropout")
    ap.add_argument("--participation-method", default="auto",
                    choices=participation.METHODS,
                    help="uniform-draw cost policy: dense full "
                    "permutation, Floyd's O(sampled) subset sampler, or "
                    "auto thresholding on cohort size")
    ap.add_argument("--schedule", default="sync",
                    choices=sorted(api.SCHEDULERS),
                    help="round scheduler (sync lock-step, async "
                    "staleness-weighted buffer, overlapped pipeline)")
    ap.add_argument("--async-commit", type=int, default=None,
                    help="async: commit when K uploads land "
                    "(default N_p//2)")
    ap.add_argument("--server-opt", default="none",
                    choices=["none", "momentum", "nesterov"],
                    help="server-side outer optimizer on the "
                    "aggregated delta")
    ap.add_argument("--server-momentum", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", help="session checkpoint path")
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--dump-spec", help="write the resolved FedSpec "
                    "JSON here and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.resume:
        sess = api.FederationSession.resume(args.resume, device=args.device)
        spec = sess.spec
        if spec.substrate != "classical":
            raise SystemExit(
                f"{args.resume} is a {spec.substrate!r} session — this "
                "driver runs classical federations; resume it with "
                "api.FederationSession.resume(...)")
        _extend_key_plan(sess, args.rounds)
        print(f"resumed {args.resume} at round {sess.round} "
              f"(arch={spec.arch})")
    else:
        spec = build_spec(args)
        if args.dump_spec:
            with open(args.dump_spec, "w") as f:
                f.write(spec.to_json(indent=1))
            print(f"wrote {args.dump_spec}")
            return None
        sub = api.ClassicalSubstrate(spec, device=args.device)
        # the reference's seed conventions on the port's int keys:
        # params from data_seed, round keys from the sequential split
        # of data_seed + 7
        params = sub.model.init(seed=spec.data_seed, device=sub.device)
        plan = api.sequential_split_plan(spec.data_seed + 7, args.rounds)
        sess = api.FederationSession.create(
            spec, spec.data_seed, substrate=sub, params=params,
            round_keys=plan)
        print(f"fed arch={sub.cfg.name} N={spec.num_nodes} "
              f"N_p={spec.nodes_per_round} I_l={spec.interval_length} "
              f"non-iid={not spec.data_iid}")

    callbacks = [_RoundLog()]
    if args.ckpt:
        callbacks.append(api.Checkpointer(args.ckpt, every=args.ckpt_every))
    sess.run(args.rounds, callbacks=callbacks)
    return sess.state["params"]


if __name__ == "__main__":
    main()
