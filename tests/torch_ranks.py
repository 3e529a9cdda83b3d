"""Run a script as the ranks of a CPU ``gloo`` world, one process each,
so no process group is ever opened in the test process (pytest's
workers run other files in the same process afterwards).

``run_ranks(script, world, tmp_path)`` starts ``world`` interpreters on
``script`` with ``sys.argv[1:] = [rank, world, store_file, tmp_path]``
and PYTHONPATH=src; each builds its mesh from a ``FileStore`` on
``store_file`` and writes its results under ``tmp_path``.
``start_ranks`` / ``wait_ranks`` are its two halves, so a test can work
while the ranks run."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """
import sys, torch, torch.distributed as dist
from repro_torch.launch import mesh as mesh_lib
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
STORE, OUT = sys.argv[3], sys.argv[4]
torch.set_num_threads(1)

def host_mesh(shape, axes):
    return mesh_lib.make_host_mesh(shape, axes, device="cpu",
                                   store=dist.FileStore(STORE, WORLD),
                                   rank=RANK)
"""


def run_ranks(script: str, world: int, tmp_path, timeout: float = 240):
    return wait_ranks(start_ranks(script, world, tmp_path), timeout)


def start_ranks(script: str, world: int, tmp_path):
    """``run_ranks``'s processes, started (each one's output to files
    under ``tmp_path``, so no pipe fills while nobody reads it);
    ``wait_ranks`` ends them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    store = str(Path(tmp_path) / "store")
    procs = []
    for r in range(world):
        logs = [open(Path(tmp_path) / f"rank{r}.{ext}", "w")
                for ext in ("out", "err")]
        procs.append((subprocess.Popen(
            [sys.executable, "-c", PRELUDE + script, str(r), str(world),
             store, str(tmp_path)], env=env, cwd=ROOT, stdout=logs[0],
            stderr=logs[1], text=True), logs))
    return procs


def wait_ranks(procs, timeout: float = 240):
    """Wait for ``start_ranks``'s processes (each at most ``timeout``
    seconds more), kill any left; raise if one failed; their outputs."""
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, logs in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
    outs = [tuple(Path(f.name).read_text() for f in logs)
            for _, logs in procs]
    for r, ((p, _), (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out}\n"
                               f"{err[-4000:]}")
    return [out for out, _ in outs]
