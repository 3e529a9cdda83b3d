"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points default to the card and never fall back to the CPU,
and ``chip_smoke.py`` fails without a card or outside a checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
import torch.distributed as dist
print(json.dumps({"modules": names, "bad": bad,
                  "process_group": dist.is_initialized()}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    import json
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.quantum.federated" in res["modules"]
    assert "repro_torch.kernels.build" in res["modules"]
    assert "repro_torch.models.model" in res["modules"]
    assert "repro_torch.launch.serve" in res["modules"]
    assert "repro_torch.models.layers.rwkv" in res["modules"]
    assert "repro_torch.kernels.gla_chunked" in res["modules"]
    for name in ("faults", "server_opt", "channel", "config",
                 "cohort.latency", "cohort.topology", "api.spec",
                 "api.phases", "api.substrate", "api.scheduler",
                 "api.session", "cohort.hierarchy", "serve",
                 "serve.admission", "serve.store", "serve.groups",
                 "serve.server"):
        assert f"repro_torch.core.fed.{name}" in res["modules"]
    assert "repro_torch.checkpoint.checkpoint" in res["modules"]
    for name in ("serving", "serving.sampling", "serving.scheduler"):
        assert f"repro_torch.{name}" in res["modules"]
    for name in ("sharding.rules", "sharding.collectives", "launch.mesh",
                 "launch.dryrun", "launch.dryrun_fed", "roofline.analysis",
                 "roofline.breakdown", "roofline.costs",
                 "roofline.trace_parse", "roofline.report",
                 "roofline.make_report", "sharding.dtensor",
                 "roofline.step_trace"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["bad"] == []
    assert res["process_group"] is False


FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                       r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s))", re.M)


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card():
    from repro_torch import convert
    from repro_torch.core.quantum import data, linalg, qnn
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.data import token_batches
    from repro_torch.models import Model
    cfg = get_config("recurrentgemma-2b").reduced(n_layers=3, vocab_size=64)
    model = Model(cfg)
    small = {k: v.numpy() for k, v in model.init(device="cpu").items()}
    calls = [lambda: qnn.init_params(torch.Generator(), (2, 3, 2)),
             lambda: data.make_federated_dataset(torch.Generator(), 2, 2, 2),
             lambda: linalg.zero_state(2),
             lambda: convert.params_to_torch([[[1.0]]]),
             lambda: model.init(),
             lambda: model.init_cache(1, 4),
             lambda: concrete_batch(cfg, 1, 4, torch.Generator()),
             lambda: next(token_batches(cfg, 1, 4)),
             lambda: convert.model_params_to_torch(small, cfg)]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            out = next(iter(out.values())) if isinstance(out, dict) else out
            first = out[0] if isinstance(out, list) else out
            first = first[0] if isinstance(first, tuple) else first
            assert first.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


def test_chip_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        return  # with a card the script is the full on-chip run
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
