"""Write the dry-run and roofline markdown of the port's dry-run records
(the port of ``repro.roofline.make_report``) to a file under
``experiments/``; no tracked file is written.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --inline
    PYTHONPATH=src python -m repro_torch.roofline.make_report
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.roofline.analysis import OUT_DIR, analyze_all, load_records
from repro_torch.roofline.report import dryrun_table, roofline_table

MOVERS = {
    "compute": "more chips / lower-precision matmuls",
    "memory": "fewer bytes a step: shard the optimizer state further, "
              "larger microbatches to amortise weight reads",
    "collective": "interval-length fed sync (the paper's own lever), "
                  "bf16 deltas on the wire",
}


def report(rows, recs) -> str:
    out = ["# Dry run of the PyTorch port (per device)", "",
           "Temporaries and collectives come from one traced run of the "
           "port's sharded eager step (roofline.step_trace), not from an "
           "XLA partitioner; n/m: a record made without the trace. The "
           "collective term is at the H100 SXM data sheet's NVLink rate "
           "(not measured).", ""]
    for mesh, title in (("single", "Single-pod (16x16)"),
                        ("multi", "Multi-pod (2x16x16)")):
        out += [f"## {title} dry run", "", dryrun_table(recs, mesh),
                f"## {title} roofline", "", roofline_table(rows, mesh)]
    ok = [r for r in rows if r.get("dominant")]
    out += ["**What would move each dominant term:**", ""]
    for term, fix in MOVERS.items():
        pairs = sorted({f"{r['arch']}x{r['shape']}" for r in ok
                        if r["dominant"] == term})
        if pairs:
            out.append(f"* **{term}** ({len(pairs)} pairs): {fix}.")
    return "\n".join(out) + "\n"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--out", default="experiments/dryrun_torch_report.md")
    args = ap.parse_args()
    rows, recs = analyze_all(args.dir), load_records(args.dir)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(rows, f, indent=1, default=str)
    with open(args.out, "w") as f:
        f.write(report(rows, recs))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
