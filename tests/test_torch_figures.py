"""The paper's figure experiments through the port (``examples/
torch_fig2_interval.py``, ``torch_fig2_wider.py``, ``torch_fig3_noise.py``):
each run's ``FedSpec`` equals, as JSON, the one the JAX script
(``benchmarks/fig2_interval.py``, ``fig2_wider.py``, ``fig3_noise.py``)
builds for the same run, and each script runs two rounds of every run on
the CPU."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FIGURES = {
    "fig2_interval": [(i, mb) for _, i, mb in (
        ("I_l=1", 1, None), ("I_l=2", 2, None), ("I_l=4", 4, None),
        ("I_l=2_SGD(mb=2)", 2, 2))],
    "fig2_wider": [((2, 3, 2),), ((3, 3, 3),), ((3, 4, 3),)],
    "fig3_noise": [(r,) for r in (0.1, 0.3, 0.5, 0.7, 0.9)],
}
CASES = [(name, args) for name, runs in FIGURES.items() for args in runs]


def load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "fig_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def reference_spec(name, args, monkeypatch):
    """The spec the JAX script's ``run`` builds, caught where it would
    create its session."""
    mod = load(ROOT / "benchmarks" / f"{name}.py")

    def create(spec, *a, **kw):
        raise _Captured(spec)
    monkeypatch.setattr(mod.api.FederationSession, "create", create)
    with pytest.raises(_Captured) as caught:
        mod.run(*args)
    return caught.value.args[0]


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}-{a}" for n, a in CASES])
def test_figure_spec_equals_the_reference_scripts(name, args, monkeypatch):
    port = load(ROOT / "examples" / f"torch_{name}.py")
    want = reference_spec(name, args, monkeypatch)
    got = port.make_spec(*args)
    assert got.to_json() == want.to_json()
    assert port.make_spec(*args, impl="pallas").impl == "pallas"


@pytest.mark.parametrize("name", list(FIGURES))
def test_figure_script_runs_two_rounds_on_the_cpu(name, capsys):
    port = load(ROOT / "examples" / f"torch_{name}.py")
    out = port.main(["--iters", "2", "--device", "cpu", "--impl", "xla"])
    assert len(out) == len(FIGURES[name])
    for hist in out.values():
        assert hist["iteration"][-1] == 2
        fid = hist["test_fidelity"][-1]
        assert 0.0 <= fid <= 1.0 + 1e-9
    assert "iter2" in capsys.readouterr().out
