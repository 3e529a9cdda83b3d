"""Roofline terms of the port's dry-run records and profiled calls (the
port of ``repro.roofline.analysis``).

    compute term    = FLOPs / peak FLOP/s           (per device)
    memory term     = bytes / HBM bytes/s           (per device)
    collective term = collective bytes / link bytes/s (per device)

A dry-run record's FLOPs are the model FLOPs (6ND training, 2ND
inference), its bytes the step's arguments read once and outputs
written once, its collective bytes those of the traced sharded step
(``roofline.step_trace``: the collectives DTensor issues in the port's
eager step, under ``hlo``) or, for a ``dryrun_fed`` record, the round's.
The collective term takes them at ``LINK_BW``, the H100 SXM data
sheet's NVLink rate: no run here measures a link. A term whose input
the record does not hold (an untraced record) is None, never zero. A
profiled call's terms
(``trace_terms``) come from ``trace_parse``'s counts and are set beside
its measured device time.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.roofline.costs import BF16_FLOPS, HBM_BYTES_PER_S

# H100 SXM (NVIDIA H100 Tensor Core GPU data sheet, dense, 700 W): the
# bf16 tensor-core FLOP/s and HBM3 bytes/s of roofline.costs, and NVLink
# 4 at 900 GB/s, 450 GB/s each way (the data sheet's rate: no multi-card
# run measures it here).
PEAK_FLOPS = BF16_FLOPS
HBM_BW = HBM_BYTES_PER_S
LINK_BW = 450e9

MODEL_FLOPS_FACTOR = {"train": 6.0, "prefill": 2.0, "decode": 2.0}

OUT_DIR = "experiments/dryrun_torch"


def model_flops(arch_params: Dict, shape: Dict, n_devices: int) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active params, per
    device."""
    n_active = arch_params["active_params"]
    if shape["kind"] == "decode":
        tokens = shape["global_batch"]          # one token per sequence
    else:
        tokens = shape["global_batch"] * shape["seq_len"]
    f = MODEL_FLOPS_FACTOR[shape["kind"]]
    return f * n_active * tokens / n_devices


def _div(x: Optional[float], rate: float) -> Optional[float]:
    return None if x is None else x / rate


def _dominant(terms: Dict[str, Optional[float]]) -> Optional[str]:
    known = {k: v for k, v in terms.items() if v is not None}
    return max(known, key=known.get) if known else None


def analyze_record(rec: Dict) -> Dict:
    """The three terms of one ``launch.dryrun`` (or ``dryrun_fed``)
    record; a term without its input stays None."""
    mem = rec.get("memory_analysis", {})
    flops = rec.get("model_flops_per_device")
    nbytes = (None if mem.get("argument_bytes") is None
              or mem.get("output_bytes") is None
              else mem["argument_bytes"] + mem["output_bytes"])
    hlo = rec.get("hlo") or {}
    coll = hlo.get("collective_bytes_total",
                   rec.get("collective_bytes_total"))
    terms = {"compute": _div(flops, PEAK_FLOPS),
             "memory": _div(nbytes, HBM_BW),
             "collective": _div(coll, LINK_BW)}
    return {
        "arch": rec["arch"],
        "shape": rec.get("shape"),
        "mesh": rec.get("mesh"),
        "flops_per_dev": flops,
        "hbm_bytes_per_dev": nbytes,
        "collective_bytes_per_dev": coll,
        "collective_bytes_by_axis": hlo.get(
            "collective_bytes_by_axis", rec.get("collective_bytes_by_axis")),
        "link_bw": "H100 SXM data sheet NVLink 4, 450 GB/s each way (not "
                   "measured)",
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": _dominant(terms),
        "arg_mem_gb": (None if mem.get("argument_bytes") is None
                       else mem["argument_bytes"] / 1e9),
        "peak_mem_gb": (None if mem.get("peak_bytes_per_device") is None
                        else mem["peak_bytes_per_device"] / 1e9),
        "temp_mem_gb": (None if mem.get("temp_bytes") is None
                        else mem["temp_bytes"] / 1e9),
    }


def active_params(cfg) -> int:
    """The params a token meets: MoE layers' experts counted at top_k
    instead of E, every other param once."""
    from repro_torch.models import Model
    total = Model(cfg).num_params()
    if not cfg.n_experts:
        return total
    per_expert = ((2 if cfg.mlp_gated else 1) + 1) * cfg.d_model * cfg.d_ff
    return total - (cfg.n_experts - cfg.top_k) * per_expert * cfg.n_layers


def arch_param_info() -> Dict[str, Dict]:
    """Total and ACTIVE parameter counts per arch."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import Model
    return {name: {"total_params": Model(cfg).num_params(),
                   "active_params": active_params(cfg),
                   "param_dtype": cfg.param_dtype}
            for name, cfg in REGISTRY.items()}


def load_records(dry_dir: str = OUT_DIR) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def analyze_all(dry_dir: str = OUT_DIR) -> List[Dict]:
    """``analyze_record`` of every ok record; skipped records as they are."""
    return [analyze_record(r) if r.get("status") == "ok" else r
            for r in load_records(dry_dir)]


def trace_terms(work, trace, arg_bytes: int, out_bytes: int,
                measured_ms: float) -> Dict:
    """The roofline of one profiled call on the card: compute term = the
    ATen dot FLOPs at the bf16 peak plus the hand-written kernels' FLOPs
    at the peaks for their types (``trace_parse.Work``); memory
    term = the call's arguments read once and outputs written once at
    HBM rate; each with its share of ``measured_ms`` (the call's time on
    the card). ``trace`` (``trace_parse.Trace``) gives the device time
    by family and the busy share beside them."""
    t_compute = work.dot_flops / PEAK_FLOPS * 1e3 + work.kernel_ops_ms
    t_memory = (arg_bytes + out_bytes) / HBM_BW * 1e3
    return {
        "dot_flops": work.dot_flops,
        "kernel_flops": work.kernel_flops,
        "kernel_bytes": work.kernel_bytes,
        "kernels": {k: {"launches": v[0], "flops": v[1], "bytes": v[2],
                        "ops_ms": v[3]} for k, v in work.kernels.items()},
        "arg_bytes": arg_bytes,
        "out_bytes": out_bytes,
        "t_compute_ms": t_compute,
        "t_memory_ms": t_memory,
        "measured_ms": measured_ms,
        "compute_share": t_compute / measured_ms,
        "memory_share": t_memory / measured_ms,
        "bound_by": "operations" if t_compute >= t_memory else "bytes",
        "device_ms_by_family": {f: us / 1e3 for f, (us, _)
                                in trace.by_family.items()},
        "busy_share": trace.busy_share,
    }
