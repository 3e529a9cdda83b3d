"""Multi-pod dry run of the port (the port of ``repro.launch.dryrun``).

For every (architecture x input shape) pair of ``configs.all_pairs()``,
build the step the port would run (train_step / prefill / serve_step)
with meta-device arguments (shapes and dtypes, no memory) against the
production meshes, 16x16 single-pod and 2x16x16 multi-pod, and record
per device:

  * the bytes of each argument's local shard by the logical-axis rules
    (``argument_bytes``, split into params, opt_state, batch, cache and
    scalars), and of the outputs whose layout the step fixes
    (``output_bytes``: new params and optimizer state; logits, cache and
    tokens by the activation rules);
  * the model FLOPs: 6ND for training, 2ND for inference, N the active
    params (``roofline.analysis.model_flops``).

and, from one traced run of the sharded step (``roofline.step_trace``:
the step's arguments as DTensors of fake tensors on the production mesh
of torch's ``fake`` backend, the card's route through the kernels'
registered ops):

  * ``temp_bytes`` and ``peak_bytes_per_device``: the most live local
    bytes during the step, less the arguments' (the trace's own count
    of the arguments is ``traced_argument_bytes``);
  * ``hlo``: ``parse_hlo``'s collective keys (bytes and counts by op,
    bytes by mesh axis, all-reduces counted twice, and each op's largest
    single call) of the collectives DTensor issues, and the ATen product
    FLOPs, in all and by op and operand shapes (``dot_flops_by_op``).

Those are the port's eager step, op by op, not XLA's fused program, and
are not compared with the reference's. ``argument_bytes`` comes from the
meshes' mapping form, with no process group. ``run_one(...,
trace=False)`` skips the trace (``null``, the reason under
``not_measured``). The trace needs no card: without one its fake tensors
are CPU tensors, which take the kernels' route all the same.

Results go to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json, one
file a pair (resumable; --force recomputes); without --inline each pair
runs in a subprocess.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --inline
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import (all_pairs, get_config, supports_shape,
                                 variant_for_shape)
from repro_torch.launch.steps import artifacts_for
from repro_torch.models import Model
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.roofline.analysis import OUT_DIR, active_params, model_flops
from repro_torch.sharding.rules import local_shape, spec_for

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}

NOT_TRACED = "not traced: run_one(..., trace=False) reads the footprint only"
TRACED = ("temp_bytes", "peak_bytes_per_device", "hlo")


def local_bytes(tensors, specs, mesh) -> int:
    """Per-device bytes of a flat dict of tensors under their specs."""
    return sum(math.prod(local_shape(t.shape, specs[k], mesh))
               * t.element_size() for k, t in tensors.items())


def _scalar_bytes(*xs: torch.Tensor) -> int:
    return sum(x.element_size() for x in xs)


def _footprint(cfg, shape, mesh):
    """({argument part: bytes}, output bytes) per device."""
    _, args, specs = artifacts_for(cfg, shape, mesh)
    params, p_spec = args[0], specs[0]
    split = {"params": local_bytes(params, p_spec, mesh)}
    vocab_logits = torch.empty((shape.global_batch, cfg.vocab_size),
                               dtype=torch.float32, device="meta")
    logits = local_bytes({"x": vocab_logits}, {"x": spec_for(
        vocab_logits.shape, ("act_batch", "act_vocab"), mesh)}, mesh)
    if shape.kind == "train":
        opt, batch, lr = args[1:]
        o_spec, b_spec = specs[1], specs[2]
        split["opt_state"] = (local_bytes(opt.m, o_spec.m, mesh)
                              + local_bytes(opt.v, o_spec.v, mesh)
                              + _scalar_bytes(opt.step))
        split["batch"] = local_bytes(batch, b_spec, mesh)
        split["scalars"] = _scalar_bytes(lr)
        # metrics (a few fp32 scalars) left out
        out = split["params"] + split["opt_state"]
    elif shape.kind == "prefill":
        batch = args[1]
        split["batch"] = local_bytes(batch, specs[1], mesh)
        model = Model(cfg)
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 device="meta")
        c_spec = {k: spec_for(v.shape, model.cache_axes()[k], mesh)
                  for k, v in cache.items()}
        out = logits + local_bytes(cache, c_spec, mesh)
    else:
        cache, batch, cur = args[1:]
        split["cache"] = local_bytes(cache, specs[1], mesh)
        split["batch"] = local_bytes(batch, specs[2], mesh)
        split["scalars"] = _scalar_bytes(cur)
        tok = math.prod(local_shape((shape.global_batch,), spec_for(
            (shape.global_batch,), ("act_batch",), mesh), mesh)) * 4
        out = tok + logits + split["cache"]
    return split, out


def _write(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)


def trace(cfg, shape, multi_pod: bool):
    """``step_trace.trace_step`` of the (cfg, shape) step on a production
    mesh of the ``fake`` backend (closed after), its fake tensors on the
    card when there is one."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import sharded_artifacts
    from repro_torch.roofline.step_trace import trace_step
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device=dev)
    try:
        return trace_step(lambda: sharded_artifacts(cfg, shape, mesh,
                                                    device=dev), mesh)
    finally:
        mesh_lib.close()


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str = OUT_DIR, trace_step: bool = True) -> dict:
    shape = INPUT_SHAPES[shape_name]
    base = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    if not supports_shape(base, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped",
               "reason": "full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md)"}
        _write(rec, out_dir)
        return rec
    cfg = variant_for_shape(base, shape)
    mesh = MESHES[mesh_name]
    t0 = time.time()
    split, out = _footprint(cfg, shape, mesh)
    seconds = {"build": round(time.time() - t0, 2)}
    traced = None
    if trace_step:
        t0 = time.time()
        traced = trace(cfg, shape, multi_pod)
        seconds["trace"] = round(time.time() - t0, 2)
    n_dev = math.prod(mesh.values())
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_devices": n_dev,
        "mesh_shape": dict(mesh),
        "seconds": seconds,
        "memory_analysis": {
            "argument_bytes": sum(split.values()),
            "argument_split": split,
            "output_bytes": out,
            "temp_bytes": None if traced is None else traced.temp_bytes,
            "peak_bytes_per_device": (None if traced is None
                                      else traced.peak_bytes),
        },
        "model_flops_per_device": model_flops(
            {"active_params": active_params(cfg)},
            {"kind": shape.kind, "global_batch": shape.global_batch,
             "seq_len": shape.seq_len}, n_dev),
        "hlo": None if traced is None else traced.collective_record(),
    }
    if traced is None:
        rec["not_measured"] = {k: NOT_TRACED for k in TRACED}
    else:
        rec["memory_analysis"]["traced_argument_bytes"] = \
            traced.argument_bytes
        rec["hlo"]["dot_flops_by_op"] = traced.dot_flops_by_op
    _write(rec, out_dir)
    return rec


def combo_done(arch, shape_name, mesh_name, out_dir=OUT_DIR):
    return os.path.exists(
        os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="input-shape id or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--inline", action="store_true",
                    help="run pairs in-process (default: subprocesses)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-trace", action="store_true",
                    help="read the footprint only (no traced step)")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    combos = [(arch, shape.name, m) for arch, _, shape, _ in all_pairs()
              if args.arch in ("all", arch)
              and args.shape in ("all", shape.name) for m in meshes]
    if not combos:
        ap.error(f"no pair for --arch {args.arch} --shape {args.shape}")
    single_combo = len(combos) == 1

    failures = []
    for arch, shape_name, mesh_name in combos:
        if not args.force and combo_done(arch, shape_name, mesh_name,
                                         args.out):
            print(f"[skip] {arch} {shape_name} {mesh_name} (done)")
            continue
        tag = f"{arch} {shape_name} {mesh_name}"
        if single_combo or args.inline:
            try:
                rec = run_one(arch, shape_name, mesh_name == "multi",
                              args.out, trace_step=not args.no_trace)
                print(f"[{rec['status']}] {tag}")
            except Exception:       # one pair's failure ends no sweep
                traceback.print_exc()
                failures.append(tag)
        else:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", mesh_name, "--out", args.out]
            if args.force:
                cmd.append("--force")
            if args.no_trace:
                cmd.append("--no-trace")
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True)
            ok = r.returncode == 0
            print(f"[{'ok' if ok else 'FAIL'}] {tag} "
                  f"({time.time() - t0:.0f}s)")
            if not ok:
                print(r.stdout[-2000:])
                print(r.stderr[-4000:])
                failures.append(tag)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
