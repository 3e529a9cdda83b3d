"""The port's roofline tooling (``repro_torch.roofline``) on the CPU.

* ``analysis``: the model FLOPs and active-parameter counts equal the
  reference's; the three terms of a hand-made record, a missing term
  staying None; a profiled call's terms from hand-made counts.
* ``trace_parse`` on a CPU profiler run: families and counts only, no
  time reported as a device number; ``count``'s dot FLOPs from the flop
  counter; the kernel wrappers counted (stubbed here: no card) and put
  back; device kernel names sorted into families.
* ``costs``: the operations and bytes of each hand-written kernel at a
  known shape, and the least times ``chip_smoke.py`` reports.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch.roofline import (analysis, breakdown, costs,  # noqa: E402
                                  trace_parse)


def test_model_flops_and_params_equal_the_reference():
    shape = {"kind": "train", "global_batch": 256, "seq_len": 4096}
    for kind in ("train", "prefill", "decode"):
        s = dict(shape, kind=kind)
        assert analysis.model_flops({"active_params": 7e9}, s, 256) == \
            janalysis.model_flops({"active_params": 7e9}, s, 256)
    assert analysis.arch_param_info() == janalysis.arch_param_info()


def test_terms_of_a_hand_made_record():
    rec = {"arch": "a", "shape": "train_4k", "mesh": "single",
           "memory_analysis": {"argument_bytes": 6.7e9, "output_bytes": 0,
                               "peak_bytes_per_device": None},
           "model_flops_per_device": 989e12 * 2}
    row = analysis.analyze_record(rec)
    assert row["t_compute_s"] == pytest.approx(2.0)
    assert row["t_memory_s"] == pytest.approx(2e-3)
    assert row["t_collective_s"] is None and row["peak_mem_gb"] is None
    assert row["dominant"] == "compute"
    row = analysis.analyze_record(dict(rec, collective_bytes_total=4.5e12))
    assert row["t_collective_s"] == pytest.approx(10.0)
    assert row["dominant"] == "collective"
    empty = analysis.analyze_record({"arch": "b", "memory_analysis": {}})
    assert empty["dominant"] is None and empty["t_memory_s"] is None


def test_trace_terms_of_hand_made_counts():
    work = trace_parse.Work(dot_flops=int(989e9),
                            kernels={"rglru_scan": [18, 67e9, 1e6, 1.0]})
    trace = trace_parse.Trace("cuda", 4000.0, 3000.0,
                              {"k": (3000.0, 2)}, {"gemm": (3000.0, 2)})
    t = analysis.trace_terms(work, trace, arg_bytes=int(3.35e9),
                             out_bytes=0, measured_ms=4.0)
    assert t["t_compute_ms"] == pytest.approx(2.0)     # 1 ms GEMM + 1 ms scan
    assert t["t_memory_ms"] == pytest.approx(1.0)
    assert t["compute_share"] == pytest.approx(0.5)
    assert t["bound_by"] == "operations"
    assert t["busy_share"] == pytest.approx(0.75)
    assert t["device_ms_by_family"] == {"gemm": 3.0}


def test_a_cpu_profile_counts_families_without_device_time():
    a, b = torch.ones(64, 32), torch.ones(32, 16)

    def call():
        c = a @ b
        c = c + 1.0
        torch.zeros(8)
        return c.clone()
    trace = trace_parse.profile(call)
    assert trace.device == "cpu" and trace.busy_us is None
    assert trace.busy_share is None
    assert all(t is None for t, _ in trace.by_op.values())
    fam = {k: n for k, (_, n) in trace.by_family.items()}
    assert fam["gemm"] == 1 and fam["copy"] == 1 and fam["fill"] == 1
    assert fam["elementwise"] >= 1
    text = "\n".join(breakdown.lines(trace, "cpu call"))
    assert "no device time" in text and "device busy" not in text


def test_count_reads_dot_flops_and_the_kernel_wrappers(monkeypatch):
    from repro_torch.kernels import zgemm as kz
    a = torch.ones(3, 4, 5, dtype=torch.complex128)
    b = torch.ones(3, 5, 6, dtype=torch.complex128)
    monkeypatch.setattr(kz, "zgemm", lambda x, y: x @ y)   # no card here
    stub = kz.zgemm

    def call():
        torch.ones(8, 16) @ torch.ones(16, 4)
        kz.zgemm(a, b)
        kz.zgemm(a, b)
    work = trace_parse.count(call)
    assert kz.zgemm is stub                          # the wrapper put back
    assert work.kernels["zgemm"][:3] == [2, 2 * 8 * 3 * 4 * 5 * 6,
                                         2 * 16 * 3 * (20 + 30 + 24)]
    # the matmul (8 x 16 x 4) and the stub's complex bmm
    assert work.dot_flops >= 2 * 8 * 16 * 4


@pytest.mark.parametrize("name,family", [
    ("void zgemm_kernel<64, 4>(double2 const*, ...)", "zgemm"),
    ("ect_partial_kernel", "ensemble_commutator_trace"),
    ("void state_kernel<true>(...)", "fidelity/mse"),
    ("void flash_wgmma_kernel<128, 64>(...)", "flash_attention"),
    ("attn_bwd_dkdv_wgmma_kernel", "flash_attention_bwd"),
    ("void rglru_kernel<float>(...)", "rglru_scan"),
    ("gla_bwd_stage", "gla_chunked_bwd"),
    ("void gla_kernel<16>(...)", "gla_chunked"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8", "gemm"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", "gemm"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "fill"),
    ("ncclDevKernel_AllGather_RING_LL(...)", "collective"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
])
def test_device_kernel_families(name, family):
    assert trace_parse.family(name) == family


def test_kernel_costs_at_known_shapes():
    meta = dict(device="meta")
    a = torch.empty(2, 3, 4, dtype=torch.complex128, **meta)
    b = torch.empty(2, 4, 5, dtype=torch.complex128, **meta)
    assert costs.quantum_work("zgemm", (a, b)) == (
        16 * (24 + 40 + 30), 8 * 2 * 3 * 5 * 4)
    q = torch.empty(1, 128, 2, 64, dtype=torch.bfloat16, **meta)
    kv = torch.empty(1, 128, 1, 64, dtype=torch.bfloat16, **meta)
    nbytes, flops, peak = costs.attention_work(q, kv, kv, {"causal": True})
    assert flops == 4 * 64 * (128 * 129 // 2) * 2 and peak == 989e12
    assert nbytes == 2 * (2 * q.numel() + 2 * kv.numel())
    # the wrapper's heads-major operands count the same work
    hm = costs.kernel_work("flash_attention",
                           (q.transpose(1, 2).reshape(2, 128, 64),
                            kv.transpose(1, 2).reshape(1, 128, 64),
                            kv.transpose(1, 2).reshape(1, 128, 64)), {})
    assert hm[:2] == (nbytes, flops)
    r = torch.empty(1, 32, 2, 8, dtype=torch.float32, **meta)
    u = torch.empty(2, 8, dtype=torch.float32, **meta)
    nb, fl, ops_ms = costs.kernel_work("gla_chunked", (r, r, r, r, u),
                                       {"chunk": 16})
    assert fl == sum(costs.gla_flops(1, 32, 2, 8, 16))
    assert ops_ms == costs.gla_least_ms(1, 32, 2, 8)
    least, by = costs.seq_bound_ms("gla_chunked", (r, r, r, r, u), {})
    assert least == max(nb / costs.HBM_BYTES_PER_S * 1e3, ops_ms)
    scan = torch.empty(4, 4096, 2560, dtype=torch.float32, **meta)
    assert costs.seq_bound_ms("rglru_scan", (scan, scan), {}) == \
        (3 * 4 * scan.numel() / costs.HBM_BYTES_PER_S * 1e3, "bytes")
