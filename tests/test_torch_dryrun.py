"""The port's dry runs (``repro_torch.launch.dryrun`` / ``dryrun_fed``)
and the classical round's mesh path, on the CPU.

* Per architecture, every record's per-device argument bytes (each input
  shape, both production meshes) equal EXACTLY the sum the reference's
  own ``spec_for`` gives on a FakeMesh over the reference's abstract
  params, AdamW states, batch, cache and scalars; the train step's
  outputs are its params and optimizer state.
* Those per-arch records are made without the traced step (the trace
  of a 126-layer step is minutes); on two small pairs the traced
  record's temporaries, peak and collectives are present and agree with
  each other and with the footprint (peak >= arguments; the trace's
  argument bytes are the footprint's less the scalars the step takes
  as Python numbers). On the multi-pod mesh the decode moves no weight
  and no cache, and each axis's bytes are within 10% of a hand count.
* The skipped pairs keep the reference's record; the CLI writes one
  file a pair and resumes; the report goes to the file it is given.
* The classical round on two gloo ranks (``fed_train_round`` on a 'pod'
  mesh, each rank one node) equals the one-process round within 1e-6;
  the fake-mesh dry run's cross-pod bytes a round are fixed, so per
  local step they halve from I_l = 1 to 2; a local step's in-pod bytes
  (traced on pod 0's ('data', 'model') sub-mesh) are the same at both,
  and a round's total is its cross-pod bytes plus I_l local steps'
  in-pod bytes.
"""
import json
import math
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs import supports_shape as jsupports  # noqa: E402
from repro.configs import variant_for_shape as jvariant  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis, make_report  # noqa: E402


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def ref_bytes(tree, axes, mesh) -> int:
    """Per-device bytes of a reference tree of ShapeDtypeStructs under
    the reference's specs."""
    total = 0
    for k, sds in tree.items():
        n = 1
        for i, d in enumerate(sds.shape):
            entry = (tuple(jrules.spec_for(sds.shape, axes[k], mesh)) +
                     (None,) * len(sds.shape))[i]
            axes_i = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= d // math.prod(mesh.shape[a] for a in axes_i)
        total += n * sds.dtype.itemsize
    return total


def ref_argument_bytes(arch, shape_name, mesh_shape) -> int:
    shape = INPUT_SHAPES[shape_name]
    cfg = jvariant(jget_config(arch), shape)
    mesh = FakeMesh(mesh_shape)
    model = JModel(cfg)
    specs, axes = model.abstract_params()
    total = ref_bytes(specs, axes, mesh)
    batch = jshapes.batch_specs(cfg, shape)
    total += ref_bytes(batch, jshapes.batch_axes(batch), mesh)
    if shape.kind == "train":
        opt = JAdamW(state_dtype=cfg.opt_state_dtype).init_abstract(specs)
        total += (ref_bytes(opt.m, axes, mesh) + ref_bytes(opt.v, axes, mesh)
                  + opt.step.dtype.itemsize + 4)          # step, lr
    elif shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 abstract=True)
        total += ref_bytes(cache, model.cache_axes(), mesh) + 4   # cur_len
    return total


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_argument_bytes_equal_the_reference(arch, tmp_path):
    for shape_name in INPUT_SHAPES:
        if not jsupports(jget_config(arch), INPUT_SHAPES[shape_name]):
            continue
        for mesh_name, mesh in dryrun.MESHES.items():
            rec = dryrun.run_one(arch, shape_name, mesh_name == "multi",
                                 str(tmp_path), trace_step=False)
            mem = rec["memory_analysis"]
            assert mem["argument_bytes"] == ref_argument_bytes(
                arch, shape_name, mesh), (shape_name, mesh_name)
            assert mem["argument_bytes"] == sum(
                mem["argument_split"].values())
            # untraced: the traced fields are absent, each with its reason
            assert rec["not_measured"] == {k: dryrun.NOT_TRACED
                                           for k in dryrun.TRACED}
            assert mem["temp_bytes"] is None and rec["hlo"] is None
            if INPUT_SHAPES[shape_name].kind == "train":
                split = mem["argument_split"]
                assert mem["output_bytes"] == (split["params"]
                                               + split["opt_state"])
            assert rec["n_devices"] == math.prod(mesh.values())
            assert rec["model_flops_per_device"] > 0


# RecurrentGemma-2B decode_32k's collective bytes a device by mesh axis
# on the 2x16x16 mesh, counted by hand from the decode's layout (PERF.md)
DECODE_HAND_COUNT = {"model": 9_247_744, "pod": 73_614_336,
                     "data": 53_256_704}


@pytest.mark.parametrize("arch,shape_name,multi", [
    ("recurrentgemma-2b", "decode_32k", False),
    ("recurrentgemma-2b", "decode_32k", True)])
def test_traced_record_holds_temporaries_and_collectives(arch, shape_name,
                                                         multi, tmp_path):
    rec = dryrun.run_one(arch, shape_name, multi, str(tmp_path))
    mem, hlo = rec["memory_analysis"], rec["hlo"]
    assert "not_measured" not in rec
    assert mem["temp_bytes"] is not None and mem["temp_bytes"] > 0
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"]
    assert mem["peak_bytes_per_device"] == (mem["traced_argument_bytes"]
                                            + mem["temp_bytes"])
    # cur_len is a Python int to the traced step, 4 bytes in the footprint
    assert mem["traced_argument_bytes"] + 4 == mem["argument_bytes"]
    assert hlo["collective_bytes_total"] > 0
    assert hlo["collective_bytes_total"] == sum(
        hlo["collective_bytes"].values()) == sum(
        hlo["collective_bytes_by_axis"].values())
    assert set(hlo["collective_bytes_by_axis"]) <= set(
        dryrun.MESHES["multi" if multi else "single"])
    assert set(hlo["collective_count"]) == set(hlo["collective_bytes"])
    assert hlo["dot_flops"] > 0
    assert hlo["dot_flops"] == pytest.approx(sum(
        hlo["dot_flops_by_op"].values()))
    assert rec["seconds"]["trace"] > 0
    if multi:
        # the reference's decode layout: weight-stationary, the cache's
        # sequence shards attended in place; no collective moves a
        # weight (13.1 MB wq / wo, 81.9 MB the table) or the cache
        # (67.1 MB a layer), each axis within 10% of the hand count
        by_axis = hlo["collective_bytes_by_axis"]
        assert max(hlo["collective_largest"].values()) < 17e6
        assert by_axis["model"] <= 0.25e9
        assert by_axis["pod"] + by_axis["data"] <= 0.15e9
        for axis, want in DECODE_HAND_COUNT.items():
            assert abs(by_axis[axis] - want) <= 0.10 * want, axis


def test_skipped_pairs_keep_the_reference_record(tmp_path):
    rec = dryrun.run_one("llama3-405b", "long_500k", True, str(tmp_path))
    assert rec == {"arch": "llama3-405b", "shape": "long_500k",
                   "mesh": "multi", "status": "skipped",
                   "reason": "full-attention arch: long_500k requires "
                             "sub-quadratic attention (DESIGN.md)"}
    with open(tmp_path / "llama3-405b__long_500k__multi.json") as f:
        assert json.load(f) == rec


def test_cli_writes_a_file_a_pair_and_resumes(tmp_path, monkeypatch,
                                              capsys):
    argv = ["dryrun", "--arch", "qwen1.5-4b", "--mesh", "single",
            "--inline", "--no-trace", "--out", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", argv)
    dryrun.main()
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(f"qwen1.5-4b__{s}__single.json"
                           for s in INPUT_SHAPES)
    dryrun.main()
    assert capsys.readouterr().out.count("(done)") == len(INPUT_SHAPES)
    # one pair traced (the CLI's default)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "recurrentgemma-2b", "--shape", "decode_32k",
        "--mesh", "single", "--inline", "--out", str(tmp_path)])
    dryrun.main()
    out = tmp_path / "report" / "dryrun.md"
    monkeypatch.setattr(sys, "argv", ["make_report", "--dir", str(tmp_path),
                                      "--out", str(out)])
    make_report.main()
    text = out.read_text()
    assert "| qwen1.5-4b | train_4k | ok | 256 |" in text
    assert "SKIP" in text and "n/m" in text
    rows = json.loads((tmp_path / "report" / "dryrun.json").read_text())
    decode = {r["arch"]: r for r in rows if r.get("shape") == "decode_32k"}
    traced = decode["recurrentgemma-2b"]
    assert traced["t_collective_s"] > 0 and traced["dominant"]
    assert traced["t_collective_s"] == (traced["collective_bytes_per_dev"]
                                        / analysis.LINK_BW)
    assert traced["peak_mem_gb"] > traced["arg_mem_gb"]
    assert decode["qwen1.5-4b"]["t_collective_s"] is None


# ------------------------------------------------ the classical mesh path
CLASSICAL = """
from repro_torch.configs import get_config
from repro_torch.core.fed.config import FederatedConfig
from repro_torch.core.fed.fed_step import fed_train_round, replicate_for_pods
from repro_torch.data import token_batches
from repro_torch.models import Model
from repro_torch.optim import AdamW

def setup():
    cfg = get_config("qwen1.5-4b").reduced(n_layers=1)
    model, opt = Model(cfg), AdamW(state_dtype=cfg.opt_state_dtype)
    params = model.init(seed=0, device="cpu")
    data = token_batches(cfg, 2, 16, seed=0, device="cpu")
    steps = [next(data) for _ in range(4)]
    batches = {k: torch.stack([s[k] for s in steps]).reshape(
        (2, 2) + tuple(steps[0][k].shape)) for k in steps[0]}
    fed_cfg = FederatedConfig(num_nodes=2, nodes_per_round=2,
                              interval_length=2, participation="full")
    return model, opt, params, batches, fed_cfg

if RANK >= 0:
    model, opt, params, batches, fed_cfg = setup()
    mesh = host_mesh((WORLD,), ("pod",))
    mine = {k: v[RANK:RANK + 1] for k, v in batches.items()}
    counts = torch.tensor([3.0, 1.0])
    new, _, metrics = fed_train_round(
        model.loss_fn, opt, params, replicate_for_pods(opt.init(params), 1),
        mine, 1e-3, fed_cfg, token_counts=counts, mesh=mesh)
    torch.save((new, {k: float(v) for k, v in metrics.items()}),
               f"{OUT}/rank{RANK}.pt")
    mesh_lib.close()
"""


def test_classical_round_on_two_ranks_equals_one_process(tmp_path):
    from torch_ranks import run_ranks
    from repro_torch.core.fed.fed_step import (fed_train_round,
                                               replicate_for_pods)
    run_ranks(CLASSICAL, 2, tmp_path)
    scope = {"RANK": -1, "torch": torch}
    exec(CLASSICAL, scope)              # the ranks' setup, in this process
    model, opt, params, batches, fed_cfg = scope["setup"]()
    want, _, metrics = fed_train_round(
        model.loss_fn, opt, params, replicate_for_pods(opt.init(params), 2),
        batches, 1e-3, fed_cfg, token_counts=torch.tensor([3.0, 1.0]))
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for new, got_metrics in outs:
        assert max(float((new[k] - want[k]).abs().max()) for k in want) \
            <= 1e-6
        assert got_metrics["loss"] == pytest.approx(float(metrics["loss"]),
                                                    abs=1e-6)
    assert all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in want)


DRYRUN_FED = """
from repro_torch.configs import get_config
from repro_torch.launch import dryrun_fed
cfg = get_config("qwen1.5-4b").reduced(n_layers=1)
recs = [dryrun_fed.run("qwen1.5-4b", il, batch=2, seq=16, device="cpu",
                       cfg=cfg, out_dir=OUT) for il in (1, 2)]
recs += [dryrun_fed.run_quantum(i, device="cpu", out_dir=OUT)
         for i in (1, 2)]
import json
print(json.dumps(recs))
"""


def test_dryrun_fed_cross_pod_bytes_per_local_step_halve(tmp_path):
    from torch_ranks import run_ranks
    out, = run_ranks(DRYRUN_FED, 1, tmp_path)
    one, two, q1, q2 = json.loads(out.strip().splitlines()[-1])
    assert one["n_devices"] == two["n_devices"] == 512
    assert one["cross_pod_bytes"] == two["cross_pod_bytes"] > 0
    assert two["cross_pod_bytes_per_local_step"] == \
        one["cross_pod_bytes_per_local_step"] / 2
    # a local step's in-pod collectives, traced once: the same at both
    # intervals, on the pod's own axes, I_l of them in a round
    assert set(one["collective_bytes_by_axis"]) == {"pod", "data", "model"}
    assert one["in_pod_bytes_per_local_step"] > 0
    assert one["in_pod_bytes_per_local_step"] == \
        two["in_pod_bytes_per_local_step"]
    for rec, il in ((one, 1), (two, 2)):
        assert rec["cross_pod_bytes"] + il * rec[
            "in_pod_bytes_per_local_step"] == rec["collective_bytes_total"]
        in_pod = rec["in_pod_step"]
        assert sum(in_pod["bytes_by_op"].values()) == \
            rec["in_pod_bytes_per_local_step"]
        assert set(in_pod["bytes_by_axis"]) <= {"data", "model"}
    assert one["round_ms"] is None and "fake" in one["values"]
    # the uploads of both pods' nodes, gathered over 'pod' in node order;
    # the quantum node pass makes no collective within a pod
    assert set(q1["collective_bytes_by_axis"]) == {"pod"}
    assert q1["in_pod_bytes_per_local_step"] == 0.0
    assert q2["cross_pod_bytes"] == 2 * q1["cross_pod_bytes"]
    assert q1["collective_count"] == {"all-gather": 1}
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == sorted(["qwen1.5-4b__fed_I1_float32.json",
                            "qwen1.5-4b__fed_I2_float32.json",
                            "quantum__fed_I1.json", "quantum__fed_I2.json"])
