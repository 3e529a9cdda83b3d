"""Markdown tables of the port's dry-run records and their rooflines
(the port of ``repro.roofline.report``). A value a record does not hold
prints as "n/m" (not measured), a part a step does not take as "–"."""
from __future__ import annotations

from typing import Dict, List, Optional

NOT_MEASURED = "n/m"


def fmt_bytes(b: Optional[float]) -> str:
    if b is None:
        return NOT_MEASURED
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(b) >= div:
            return f"{b / div:.1f}{unit}"
    return f"{b:.0f}B"


def fmt_s(t: Optional[float]) -> str:
    if t is None:
        return NOT_MEASURED
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.1f}ms"
    return f"{t * 1e6:.0f}us"


def roofline_table(rows: List[Dict], mesh: str = "single") -> str:
    """One markdown row per (arch x shape) of ``analysis.analyze_record``
    rows on the given mesh."""
    hdr = ("| arch | shape | compute | memory | collective | dominant | "
           "bytes/dev |\n|---|---|---|---|---|---|---|\n")
    lines = [
        f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute_s'])} | "
        f"{fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | "
        f"**{r['dominant']}** | {fmt_bytes(r['hbm_bytes_per_dev'])} |"
        for r in rows if r.get("dominant") and r["mesh"] == mesh]
    return hdr + "\n".join(lines) + "\n"


def dryrun_table(recs: List[Dict], mesh: str = "single") -> str:
    hdr = ("| arch | shape | status | devices | params/dev | opt/dev | "
           "batch/dev | cache/dev | args/dev | outputs/dev | temps/dev | "
           "model FLOPs/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP "
                         "(sub-quadratic rule) |" + " – |" * 9)
            continue
        m = r["memory_analysis"]
        split = m["argument_split"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['n_devices']} | "
            + " | ".join(fmt_bytes(split[k]) if k in split else "–"
                         for k in ("params", "opt_state", "batch", "cache"))
            + f" | {fmt_bytes(m['argument_bytes'])} | "
            f"{fmt_bytes(m['output_bytes'])} | {fmt_bytes(m['temp_bytes'])}"
            f" | {r['model_flops_per_device']:.4g} |")
    return hdr + "\n".join(lines) + "\n"
