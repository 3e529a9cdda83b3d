"""Federated multi-pod dry run: the paper's technique on the production
mesh, pods as nodes (the port of ``repro.launch.dryrun_fed``).

Runs one ``fed_train_round`` (I_l local AdamW steps a pod, then the
data-volume-weighted cross-pod delta sum) on the 2x16x16 mesh of torch's
``fake`` backend, where this process plays rank 0: pod 0's node trains
for real (on the card by default), and every collective the round
makes is counted by mesh axis (``sharding.collectives``). The paper's
§III-D.2 claim, that the interval length amortises synchronisation,
becomes measurable: cross-pod bytes a round stay fixed, so cross-pod
bytes per local step fall as 1/I_l.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_fed \
        --arch qwen1.5-4b --intervals 1,4 --layers 8 --batch 2

``--quantum`` runs one QUANTUM server round instead, with
``fanout="shard_map"``: each pod runs the node pass of its block of the
round's nodes, and the uploads are gathered in node order over 'pod'.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_fed --quantum

On the fake backend no collective moves data: the all-reduce leaves pod
0's own partial sum and a gather leaves the other pods' parts zero, so
the round's values are not the federation's; the records report the
byte counts (and the round's time on the card) only. The in-pod bytes a
local step adds are read from a trace of that step sharded within a pod
(``roofline.step_trace``: the node's params, moments and batch as
DTensors of fake tensors on pod 0's ('data', 'model') sub-mesh, placed
by the rules, whose 'embed' rule leaves 'pod' out there): the
collectives DTensor issues, by axis, the port's eager step and not an
SPMD pass's. A round then moves its cross-pod bytes once and a local
step's in-pod bytes I_l times. Records go to
experiments/dryrun_fed_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import collectives, rules

OUT_DIR = "experiments/dryrun_fed_torch"
LR = 3e-3  # the local AdamW rate of chip_smoke.py's phase 12a
FAKE_NOTE = ("fake backend: no collective moved data (pod 0's own partial "
             "sum, the other pods' gathered parts zero); only the byte "
             "counts and the time are reported")
IN_POD_NOTE = ("a local step's collectives within a pod, traced on pod 0's "
               "(data, model) sub-mesh (roofline.step_trace); a round "
               "counts them I_l times")


def _bytes_record(tally: collectives.Tally, interval: int,
                  in_pod: Optional[collectives.Tally] = None) -> dict:
    """The round's collectives (``tally``) and, I_l times, one local
    step's in-pod ones (``in_pod``; none where the round makes none
    within a pod)."""
    by_axis = dict(tally.bytes_by_axis)
    count = dict(tally.count_by_op)
    cross_pod = sum(v for k, v in by_axis.items() if "pod" in k)
    in_step = (sum(v for k, v in by_axis.items() if "pod" not in k)
               / interval)
    if in_pod is not None:
        for axis, n in in_pod.bytes_by_axis.items():
            by_axis[axis] = by_axis.get(axis, 0.0) + interval * n
        for op, n in in_pod.count_by_op.items():
            count[op] = count.get(op, 0) + interval * n
        in_step += in_pod.total
    return {"collective_bytes_total": cross_pod + interval * in_step,
            "collective_bytes_by_axis": by_axis,
            "collective_count": count,
            "cross_pod_bytes": cross_pod,
            "cross_pod_bytes_per_local_step": cross_pod / interval,
            "in_pod_bytes_per_local_step": in_step,
            "in_pod_step": None if in_pod is None else in_pod.as_dict(),
            "in_pod": IN_POD_NOTE,
            "values": FAKE_NOTE}


def _timed(fn, device: torch.device):
    """(fn(), its ms on the card or None): host clock around the work,
    ending in a synchronize."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _save(rec: dict, fname: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)


_LOCAL_STEPS: Dict[tuple, collectives.Tally] = {}


def trace_local_step(cfg, batch: int, seq: int, mesh
                     ) -> collectives.Tally:
    """The collectives of one local train step (loss, grads, AdamW) of
    ``batch`` x ``seq`` tokens sharded on pod 0's ('data', 'model')
    sub-mesh of ``mesh``, traced on fake tensors (on the card where
    there is one). They do not depend on I_l: a step is traced once a
    process for each config, size and mesh shape."""
    key = (cfg, batch, seq, tuple(mesh.shape))
    if key not in _LOCAL_STEPS:
        from repro_torch.launch.steps import sharded_artifacts
        from repro_torch.models.config import InputShape
        from repro_torch.roofline.step_trace import trace_step
        pod = mesh["data", "model"]
        shape = InputShape("local_step", seq, batch, "train")
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        _LOCAL_STEPS[key] = trace_step(
            lambda: sharded_artifacts(cfg, shape, pod, device=dev), pod).tally
    return _LOCAL_STEPS[key]


def run(arch: str, interval: int, *, layers: int = 0, batch: int = 2,
        seq: int = 4096, delta_dtype: str = "float32", device="cuda",
        out_dir: str = OUT_DIR, cfg=None) -> dict:
    """One classical round on the 2-pod fake mesh; ``batch`` x ``seq``
    tokens a local step of pod 0's node, ``layers`` (0: published) cuts
    the depth; ``cfg`` overrides the arch's config. A local step's
    in-pod collectives come from ``trace_local_step``."""
    from repro_torch.configs import get_config
    from repro_torch.core.fed import api
    from repro_torch.core.fed.fed_step import fed_train_round, node_shard
    from repro_torch.core.fed.fed_step import replicate_for_pods
    from repro_torch.data import token_batches
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.optim import AdamW

    dev = resolve_device(device)
    cfg = cfg or get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg)
    opt = AdamW(state_dtype=cfg.opt_state_dtype)
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    try:
        n_pods = rules.axis_size(mesh, "pod")
        spec = api.FedSpec.classical(arch=arch, num_nodes=n_pods,
                                     nodes_per_round=n_pods,
                                     interval_length=interval,
                                     participation="full",
                                     delta_dtype=delta_dtype)
        fed_cfg = spec.to_classical_config()
        _, ranks, _ = node_shard(mesh)
        per = n_pods // ranks
        params = model.init(seed=0, device=dev)
        opt_nodes = replicate_for_pods(opt.init(params), per)
        data = token_batches(cfg, batch, seq, seed=0, device=dev)
        steps = [next(data) for _ in range(per * interval)]
        node_batches = {k: torch.stack([s[k] for s in steps]).reshape(
            (per, interval) + tuple(steps[0][k].shape)) for k in steps[0]}
        with collectives.record() as tally:
            (_, _, metrics), ms = _timed(lambda: fed_train_round(
                model.loss_fn, opt, params, opt_nodes, node_batches, LR,
                fed_cfg, mesh=mesh), dev)
        del params, opt_nodes, node_batches
        in_pod = trace_local_step(cfg, batch, seq, mesh)
        n_dev = mesh.size()
    finally:
        mesh_lib.close()
    rec = {"arch": arch, "layers": cfg.n_layers,
           "local_batch": [batch, seq], "interval_length": interval,
           "delta_dtype": delta_dtype, "mesh": "multi", "n_devices": n_dev,
           "backend": "fake", "device": (torch.cuda.get_device_name(0)
                                         if dev.type == "cuda" else "cpu"),
           "round_ms": ms, "loss": float(metrics["loss"]),
           **_bytes_record(tally, interval, in_pod)}
    _save(rec, f"{arch}__fed_I{interval}_{delta_dtype}.json", out_dir)
    return rec


def run_quantum(interval: int, num_nodes: int = 8, nodes_per_round: int = 4,
                device="cuda", out_dir: str = OUT_DIR) -> dict:
    """One pod-sharded QUANTUM server round on the 2-pod fake mesh."""
    from repro_torch.configs import qnn_232
    from repro_torch.core.fed import api
    from repro_torch.core.quantum import data as qdata
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    spec = api.FedSpec.from_quantum_config(
        qnn_232.config(num_nodes=num_nodes, nodes_per_round=nodes_per_round,
                       interval_length=interval, fanout="shard_map"))
    cfg = spec.to_quantum_config()
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(0), qnn_232.WIDTHS[0],
        num_nodes=num_nodes, n_per_node=4, n_test=4, device=dev)
    params = qnn.init_params(torch.Generator().manual_seed(1),
                             qnn_232.WIDTHS, device=dev)
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    try:
        with mesh, collectives.record() as tally:
            _, ms = _timed(lambda: fed.server_round(
                params, ds, torch.Generator().manual_seed(2), cfg), dev)
        n_dev = mesh.size()
    finally:
        mesh_lib.close()
    rec = {"arch": f"qnn_{'-'.join(map(str, qnn_232.WIDTHS))}",
           "mode": "quantum_shard_map", "impl": cfg.impl,
           "interval_length": interval, "num_nodes": num_nodes,
           "nodes_per_round": nodes_per_round, "mesh": "multi",
           "n_devices": n_dev, "backend": "fake", "round_ms": ms,
           **_bytes_record(tally, interval)}
    _save(rec, f"quantum__fed_I{interval}.json", out_dir)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--intervals", default="1,4")
    ap.add_argument("--layers", type=int, default=8,
                    help="depth (0: published); pod 0's node trains for "
                         "real, so the default fits one card")
    ap.add_argument("--batch", type=int, default=2,
                    help="sequences a local step of pod 0's node")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--delta-dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantum", action="store_true",
                    help="run the pod-sharded quantum round instead")
    args = ap.parse_args()
    for interval in [int(x) for x in args.intervals.split(",")]:
        if args.quantum:
            rec = run_quantum(interval, device=args.device)
        else:
            rec = run(args.arch, interval, layers=args.layers,
                      batch=args.batch, seq=args.seq,
                      delta_dtype=args.delta_dtype, device=args.device)
        ms = ("" if rec["round_ms"] is None
              else f", round {rec['round_ms']:.1f} ms on the card")
        print(f"I_l={interval}: cross-pod {rec['cross_pod_bytes'] / 1e9:.4f}"
              f" GB/round ({rec['cross_pod_bytes_per_local_step'] / 1e9:.4f}"
              f" GB/local-step), collectives "
              f"{rec['collective_bytes_total'] / 1e9:.4f} GB{ms} "
              f"[{FAKE_NOTE}]")


if __name__ == "__main__":
    main()
