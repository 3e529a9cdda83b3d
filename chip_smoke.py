#!/usr/bin/env python3
"""Drive the PyTorch port of QuantumFed on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-quantum [--src DIR]

Runs on cuda:0 only; without a CUDA device, or outside a checkout of the
repository, it exits non-zero before printing any result. Phases:

1. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (nvcc, sm_90a) and print the card, its power limit and the
   toolchain versions;
2. kernels: record the inputs the main path hands each kernel (one probe
   round of phase 3's configuration), then hold every kernel against its
   plain PyTorch version on those inputs and on ragged shapes (the trace
   twice, bit for bit), and time kernel, plain version and (where one
   PyTorch call computes the same function) that library call with CUDA
   events, and the kernel's device time per launch with torch.profiler;
3. main path: the paper's experiment (examples/quickstart.py): widths
   (2,3,2), N=100, N_p=10, I_l=2, eta=1, eps=0.1, Eq. 6 product, 50
   rounds with impl="pallas", evaluated every 10 rounds. The launch
   counts are zeroed just before and read just after; every kernel must
   have run, and the final test fidelity must exceed 0.95;
4. wide cell: widths (4,5,4), N=20, N_p=10, I_l=2: one round with the
   kernels (launches counted) against one in complex128 PyTorch from the
   same params and selection, the kernels checked and timed as in phase 2
   at every shape of that round (zgemm's and the trace's rows join the
   result), then ms/round of both impls for both cells, and a profiler
   breakdown of one kernel round of each cell with the trace kernels'
   device time;
5. serving: RecurrentGemma-2B at full width (26 layers, d_model 2560,
   bf16, random weights from a seed) prefills B=4 prompts of S=4096
   tokens through ``make_prefill_step`` (launch counts zeroed before,
   read after: 8 flash_attention, 18 rglru_scan), moves the cache into a
   4096+32 decode cache and greedy-decodes 32 tokens through
   ``make_serve_step``. The same prefill through the plain versions
   (``impl="xla"``) must agree with it within the bf16 budget (the plain
   bf16 prefill's deviation from the plain fp32 one, measured in the
   run), the fp32 prefill through the kernels within the plain fp32
   prefill's deviation when every weight moves one ulp, and the first
   decode step with a prefill of S+1 tokens. Each sequence kernel is
   held against its plain version on the path's inputs and on ragged
   shapes, then timed (attention also element by element, with the
   design its machine code shows and the fp32-storage kernel's time);
   then profiler breakdowns of one prefill and one decode step, and
   ``python -m repro_torch.launch.serve`` as a smoke;
6. RWKV6 serving: RWKV6-7B at full width (32 layers, d_model 4096, 64
   heads of 64, bf16, 7,576,752,128 params) with the reference init's
   zero decay, bonus and mixing tensors redrawn from a seed, the same
   steps as phase 5: one prefill of B=4 x S=4096 with exactly 32
   gla_chunked launches (w handed over in fp32), the same budgets, 32
   decode tokens, the first of them against a prefill of S+1 tokens
   (the kernel at chunk 1), the kernel against its plain version on the
   path's inputs and ragged shapes, profiles and the serve CLI.

The second-to-last line is a JSON object with one entry per kernel and
shape: each kernel at the main path's most frequent shape (launches of
phase 3, or of one prefill), then zgemm and the trace at each shape of
the (4,5,4) round (launches in one round, ``"cell"`` set); the quantum
rows carry ``device_us``. The last line is ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero and never
prints that line.

``--time-quantum`` runs none of that: it times the quantum path of the
checkout whose ``src`` is DIR (this one by default) and prints one JSON
line (see ``time_quantum``), so that two checkouts can be compared on
one card, in turns, each in its own process.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the port that runs: this checkout's, or another's under --src
SRC = (Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
       if "--src" in sys.argv[:-1] else ROOT / "src")
sys.path.insert(0, str(SRC))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores, which is what these fp32 CUDA-core kernels use.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Kernels compute in fp32 on complex128 storage. Their sums run in
# another order than the plain versions', so each is held to 1e-5 times
# the scale of the plain result: fp32 keeps ~7 digits, and the longest
# reduction (K = 512 terms of the wide cell's trace) costs about two.
KERNEL_RTOL = 1e-5
# Deviation of one round with the kernels from one in complex128, both
# from the same params and selection. The kernels' fp32 rounding enters
# K at ~1e-6 of its scale; eps * 2^m_in * that is far below 1e-5 at the
# widths here, the same budget the reference's own round gate uses.
ROUND_TOL = 1e-5
MAIN_FIDELITY = 0.95
# bf16 outputs of a sequence kernel and of its plain version are both one
# rounding of nearly the same fp32 value, so they differ by at most one
# bf16 ulp: 2^-7 of the value at worst (8 significand bits).
BF16_RTOL = 2.0 ** -7
# the bf16 tensor-core peak: the least time for bf16 work on this card
BF16_FLOPS = 989e12
# SDPA as a yardstick computes the same attention in its own bf16 way;
# it is checked against the plain version first, at the reference's own
# bf16 gate (tests/test_kernels.py), relative to the output's scale.
YARDSTICK_RTOL = 2e-2
SERVE_B, SERVE_S, SERVE_GEN = 4, 4096, 32

KERNELS = {
    "zgemm": dict(
        source="src/repro_torch/kernels/csrc/zgemm.cu",
        replaces="src/repro/kernels/zgemm.py:52"),
    "ensemble_commutator_trace": dict(
        source="src/repro_torch/kernels/csrc/ect.cu",
        replaces="src/repro/kernels/zgemm.py:166"),
    "fidelity": dict(
        source="src/repro_torch/kernels/csrc/fidelity.cu",
        replaces="src/repro/kernels/fidelity.py:75"),
    "mse": dict(
        source="src/repro_torch/kernels/csrc/fidelity.cu",
        replaces="src/repro/kernels/fidelity.py:81"),
}
SEQ_KERNELS = {
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:82"),
    "rglru_scan": dict(
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:48"),
    "gla_chunked": dict(
        source="src/repro_torch/kernels/csrc/gla_chunked.cu",
        replaces="src/repro/kernels/gla_chunked.py:73"),
}

def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------- timing
def cuda_ms(fn, *args, reps=100, warmup=10):
    import torch
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(name, args):
    """Least time for the work on an H100: each input read once, each
    output written once, at HBM rate, against the fp32 operations at the
    fp32 peak; the larger of the two, and which one it is."""
    if name == "zgemm":
        a, b = args
        bsz, m, k = a.shape
        n = b.shape[2]
        nbytes = 16 * (bsz * m * k + bsz * k * n + bsz * m * n)
        flops = 8 * bsz * m * n * k            # 4 mul + 4 add per complex MAC
    elif name == "ensemble_commutator_trace":
        a, b = args
        j, n, ea, dk, dr = a.shape
        eb, k = b.shape[2], dk * dr
        nbytes = 16 * (a.numel() + b.numel() + j * dk * dk)
        flops = 8 * j * n * (2 * ea * eb * k + dk * dk * eb * dr)
    else:
        phi, rho = args
        n, d = phi.shape
        nbytes = 16 * (phi.numel() + rho.numel()) + 8 * n
        flops = (10 if name == "fidelity" else 12) * n * d * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phases
def phase_build():
    import torch
    from repro_torch.kernels import build
    say("== phase 1: build")
    t0 = time.time()
    lib = build.build()
    say(f"built {lib.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    log = lib.with_suffix(".log").read_text().splitlines()
    for line in log:
        if line.startswith("==") or "registers" in line or "spill" in line:
            say("  " + line.strip())
    build.load()
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True, timeout=60).stdout
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc_v.strip().splitlines()[-1]}")
    say(f"card: {smi('name,power.limit')}")
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 plain GEMMs
    torch.backends.cudnn.allow_tf32 = False


def layout(x):
    """"dense", or what the kernel's wrapper would refuse in ``x`` as it
    is: a strided layout, a lazy conjugate or negative bit."""
    tags = [tag for tag, on in (("strided", not x.is_contiguous()),
                                ("conj", x.is_conj()), ("neg", x.is_neg()))
            if on]
    return "+".join(tags) or "dense"


class Recorder:
    """Wraps ``ops`` dispatch functions to keep the first inputs of every
    distinct shape (and keyword set, and layout where an operand is not
    dense) the main path hands each kernel."""
    NAMES = {"complex_matmul": "zgemm", "fidelity": "fidelity",
             "mse": "mse",
             "ensemble_commutator_trace": "ensemble_commutator_trace"}

    def __init__(self, names=None, observe=None):
        from repro_torch.kernels import ops
        self.ops = ops
        self.names = names or self.NAMES
        self.observe = observe      # called as observe(kernel, args, kw)
        self.calls = {k: {} for k in self.names.values()}
        self.saved = {}

    def __enter__(self):
        for fn, kernel in self.names.items():
            orig = getattr(self.ops, fn)
            self.saved[fn] = orig

            def wrapped(*args, _orig=orig, _k=kernel, **kw):
                key = (tuple(tuple(a.shape) for a in args)
                       + tuple(sorted(kw.items())))
                lay = tuple(layout(a) for a in args)
                if any(t != "dense" for t in lay):
                    key += (("layout", lay),)
                # the tensors themselves, lazy conjugate views included
                seen = self.calls[_k].setdefault(
                    key, [0, tuple(a.detach() for a in args), kw])
                seen[0] += 1
                if self.observe is not None:
                    self.observe(_k, args, kw)
                return _orig(*args, **kw)
            setattr(self.ops, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for fn, orig in self.saved.items():
            setattr(self.ops, fn, orig)


def main_cell(widths=(2, 3, 2), num_nodes=100, impl="pallas", device="cuda"):
    """The quickstart experiment's config, data and initial params."""
    import torch
    from repro_torch.core.quantum import data as qdata
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    cfg = fed.QuantumFedConfig(widths=widths, num_nodes=num_nodes,
                               nodes_per_round=10, interval_length=2,
                               eta=1.0, eps=0.1, aggregation="product",
                               impl=impl)
    gen = torch.Generator(device="cpu").manual_seed(42)
    _, ds, test = qdata.make_federated_dataset(
        gen, widths[0], num_nodes, n_per_node=4, n_test=32, device=device)
    params = qnn.init_params(torch.Generator().manual_seed(7), widths,
                             device=device)
    return cfg, ds, test, params


def train_set(ds):
    return (ds.phi_in.reshape(-1, ds.phi_in.shape[-1]),
            ds.phi_out.reshape(-1, ds.phi_out.shape[-1]))


def ragged_cases():
    """Edge shapes the kernels mask rather than pad, seeded."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(3)

    def rc(*shape):
        re = torch.randn(shape, generator=g, dtype=torch.float64)
        im = torch.randn(shape, generator=g, dtype=torch.float64)
        return torch.complex(re, im).cuda()

    return {"zgemm": [(rc(3, 7, 9), rc(3, 9, 5)),
                      (rc(2, 33, 17), rc(2, 17, 40))],
            "fidelity": [(rc(13, 4), rc(13, 4, 4)), (rc(5, 3), rc(5, 3, 3))],
            "mse": [(rc(13, 4), rc(13, 4, 4)), (rc(5, 3), rc(5, 3, 3))],
            "ensemble_commutator_trace": [
                (rc(2, 3, 5, 4, 3), rc(2, 3, 3, 4, 3)),
                (rc(2, 2, 7, 8, 3), rc(2, 2, 7, 8, 3)),
                # rows of 19,200 bytes: one a row a tile, b in two chunks
                (rc(1, 2, 2, 8, 300), rc(1, 2, 7, 8, 300)),
                # a split into row ranges with a short last one, odd
                # dk * dr
                (rc(2, 2, 300, 5, 3), rc(2, 2, 3, 5, 3)),
                (rc(3, 2, 77, 6, 5), rc(3, 2, 9, 6, 5)),
                # b's 12 rows padded to the register tile of 8: in row
                # ranges, then in one launch over n
                (rc(70, 4, 300, 4, 3), rc(70, 4, 12, 4, 3)),
                (rc(70, 4, 20, 4, 3), rc(70, 4, 12, 4, 3))]}


def device_us(fn, args, n=5):
    """Device time per call of ``fn(*args)``, summed over every kernel it
    launches (torch.profiler over ``n`` calls after one warm-up), in
    microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        raise RuntimeError("the profiler saw no device time")
    return sum(spans) / n


def check_and_time(rec, ragged):
    """Hold each kernel against its plain version on every recorded input
    (and the ragged cases; the trace twice, bit for bit), then time
    kernel, plain version and library call at every recorded shape.
    Returns {kernel: [row per shape, most frequent first]}, each row with
    the largest error on the path's own inputs, and the device time per
    launch (profiler) of the kernel alone. Raises on a disagreement."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import fidelity as kfid
    from repro_torch.kernels import zgemm as kz
    op = {"zgemm": ops.complex_matmul, "fidelity": ops.fidelity,
          "mse": ops.mse,
          "ensemble_commutator_trace": ops.ensemble_commutator_trace}
    wrapper = {"zgemm": kz.zgemm, "fidelity": kfid.fidelity_batch,
               "mse": kfid.mse_batch,
               "ensemble_commutator_trace": kz.ensemble_commutator_trace}
    plain = {"zgemm": ref.zgemm_ref, "fidelity": ref.fidelity_ref,
             "mse": ref.mse_ref,
             "ensemble_commutator_trace": ref.ensemble_commutator_trace_ref}
    # one PyTorch call computing the same function in complex64, timed as
    # a yardstick only (the port never calls it); mse has no single call.
    # The trace: T[j,al,be] = sum over n, e, f, s of
    # G[e,f] a[e,(al,s)] conj(b[f,(be,s)]), with G[e,f] = <a_e|b_f>.
    library = {
        "zgemm": torch.matmul,
        "fidelity": lambda x, r: torch.einsum(
            "na,nab,nb->n", x.conj(), r, x).real,
        "ensemble_commutator_trace": lambda a, b: torch.einsum(
            "jnekr,jnfkr,jneas,jnfbs->jab", a.conj(), b, a, b.conj()),
    }
    results = {}
    for name in KERNELS:
        calls = rec.calls[name]
        if not calls:
            raise RuntimeError(f"the path never called {name}")
        worst = 0.0
        cases = [(f"path {list(key)} x{cnt}", args)
                 for key, (cnt, args, _) in calls.items()]
        cases += [(f"ragged {[list(a.shape) for a in args]}", args)
                  for args in ragged.get(name, [])]
        for label, args in cases:
            got = op[name](*args)
            want = plain[name](*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            ok = err <= KERNEL_RTOL * scale
            same = ""
            if name == "ensemble_commutator_trace":
                # no atomics: the same inputs give the same bits
                again = op[name](*args)
                ok = ok and torch.equal(got, again)
                same = ", repeat bit-identical" if torch.equal(
                    got, again) else ", repeat DIFFERS"
            say(f"  {name:26s} {label}: max_abs_err {err:.3e} "
                f"(tol {KERNEL_RTOL:.0e} x scale {scale:.3g}){same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version "
                                   "or with itself")
            if label.startswith("path"):
                worst = max(worst, err)
        # every recorded shape is timed, the most frequent one first (of
        # equally frequent ones, the last recorded)
        rows = results[name] = []
        for key, (cnt, args, _) in reversed(sorted(calls.items(),
                                                   key=lambda kv: kv[1][0])):
            k_ms = cuda_ms(op[name], *args)
            p_ms = cuda_ms(plain[name], *args)
            lib_ms = None
            if name in library:
                args64 = tuple(x.to(torch.complex64) for x in args)
                want = plain[name](*args)
                lib_err = float((library[name](*args64) - want).abs().max())
                if lib_err > KERNEL_RTOL * max(1.0, float(want.abs().max())):
                    raise RuntimeError(f"{name}: the library yardstick "
                                       f"disagrees ({lib_err:.3e})")
                lib_ms = cuda_ms(library[name], *args64)
            b_ms, b_by = bound_ms(name, args)
            dev_us = device_us(wrapper[name], [ops._dense(x) for x in args])
            plan = ""
            if name == "ensemble_commutator_trace":
                j, n, ea, dk, dr = args[0].shape
                parts = kz._TRACE_PARTS[(j, n, ea, args[1].shape[2], dk, dr,
                                         args[0].get_device())]
                plan = (f", {parts} partial traces a j" if parts
                        else ", one launch over n")
            say(f"  {name:26s} timed at {list(key)} x{cnt}: kernel "
                f"{k_ms:.4f} ms (device {dev_us:.2f} us a launch{plan}), "
                f"plain {p_ms:.4f} ms, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.6f} ms ({b_by})")
            rows.append(dict(name=name, route="cuda", **KERNELS[name],
                             shape=[list(x.shape) for x in args],
                             max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             device_us=dev_us, calls=cnt, key=key))
            lay = [layout(x) for x in args]
            if any(t != "dense" for t in lay):
                rows[-1]["layout"] = lay
    return results


def phase_kernels():
    import torch
    from repro_torch.core.quantum import federated as fed
    say("== phase 2: kernels against their plain versions, at the inputs "
        "of one probe round + evaluation of phase 3's configuration")
    cfg, ds, test, params = main_cell()
    with Recorder() as rec:
        p = fed.server_round(params, ds, torch.Generator().manual_seed(1), cfg)
        fed.evaluate(p, *test, cfg.widths, impl=cfg.impl)
        torch.cuda.synchronize()
    # the most frequent shape of each kernel reports
    return {name: rows[0]
            for name, rows in check_and_time(rec, ragged_cases()).items()}


def evaluate_all(params, ds, test, cfg):
    from repro_torch.core.quantum import federated as fed
    tr = fed.evaluate(params, *train_set(ds), cfg.widths, impl=cfg.impl)
    te = fed.evaluate(params, *test, cfg.widths, impl=cfg.impl)
    return float(tr["fidelity"]), float(te["fidelity"]), float(te["mse"])


def unitarity_err(params):
    import torch
    worst = 0.0
    for u in params:
        eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        worst = max(worst, float((u @ u.mH - eye).abs().max()))
    return worst


def phase_main():
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    say("== phase 3: main path, widths (2,3,2), N=100, N_p=10, I_l=2, "
        "50 rounds, impl=pallas")
    cfg, ds, test, params = main_cell()
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.time()
    for it in range(1, 51):
        params = fed.server_round(params, ds, gen, cfg)
        if it % 10 == 0:
            tr, te, mse = evaluate_all(params, ds, test, cfg)
            say(f"  round {it:3d}: train fidelity {tr:.6f}, test fidelity "
                f"{te:.6f}, test mse {mse:.3e}")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(build.LAUNCHES)
    say(f"  launches in this phase: {launches}")
    say(f"  host wall {wall:.3f} s for 50 rounds + 5 evaluations")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"main path never launched {missing}")
    for p in params:
        if not bool(torch.isfinite(p.abs()).all()):
            raise RuntimeError("non-finite params after training")
    u_err = unitarity_err(params)
    say(f"  final unitarity error {u_err:.3e}")
    if u_err > 1e-4:
        raise RuntimeError("params drifted from unitary")
    if not te > MAIN_FIDELITY:
        raise RuntimeError(f"final test fidelity {te} <= {MAIN_FIDELITY}")
    say(f"  final test fidelity {te:.6f} > {MAIN_FIDELITY}: ok")
    return launches


def round_ms(cfg, ds, params, reps):
    import torch
    from repro_torch.core.quantum import federated as fed
    gen = torch.Generator().manual_seed(5)
    fed.server_round(params, ds, gen, cfg)          # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fed.server_round(params, ds, gen, cfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(label, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    the busy share is the union of the device's kernel and copy intervals
    over the call's wall time (both under the profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "Buffer" not in e.name)
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for t_start, t_end, name in spans:
        busy_us += max(0.0, t_end - max(t_start, end_us))
        end_us = max(end_us, t_end)
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + t_end - t_start, cnt + 1)
    busy_ms = busy_us / 1e3
    say(f"  profile {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{len(spans)} device ops")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (tot, cnt) in top:
        say(f"    {tot / 1e3:9.3f} ms  x{cnt:5d}  {name[:70]}")
    return by_name


def profile_round(cfg, ds, params, label):
    """Profile one round; prints the trace kernels' device time in it
    (the partial and the reduction kernel) and their launches."""
    import torch
    from repro_torch.core.quantum import federated as fed
    gen = torch.Generator().manual_seed(6)
    fed.server_round(params, ds, gen, cfg)
    by_name = profile_device(label, lambda: fed.server_round(params, ds, gen,
                                                             cfg))
    ect = [v for k, v in by_name.items()
           if "ect_partial_kernel" in k or "ect_reduce_kernel" in k]
    ect_ms, ect_n = sum(t for t, _ in ect) / 1e3, sum(c for _, c in ect)
    say(f"    trace kernels: {ect_ms:.3f} ms device time in this round "
        f"over {ect_n} device launches")


def phase_wide():
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    say("== phase 4: wide cell (4,5,4), N=20, N_p=10, I_l=2")
    cfg_p, ds, test, params = main_cell(widths=(4, 5, 4), num_nodes=20)
    cfg_x = cfg_p._replace(impl="xla")
    with Recorder() as rec:
        torch.cuda.synchronize()
        build.reset_launches()
        p_k = fed.server_round(params, ds, torch.Generator().manual_seed(9),
                               cfg_p)
        torch.cuda.synchronize()
        round_launches = dict(build.LAUNCHES)
        per_shape = {name: {key: seen[0] for key, seen in calls.items()}
                     for name, calls in rec.calls.items()}
        fed.evaluate(p_k, *test, cfg_p.widths, impl=cfg_p.impl)
    say(f"  launches in one kernel round: {round_launches}")
    p_x = fed.server_round(params, ds, torch.Generator().manual_seed(9), cfg_x)
    torch.cuda.synchronize()
    dev = max(float((a - b).abs().max()) for a, b in zip(p_k, p_x))
    ok = dev <= ROUND_TOL
    say(f"  one round, kernels vs complex128: max param deviation {dev:.3e} "
        f"(tol {ROUND_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("wide cell: kernels disagree with complex128")
    say("  kernels at the wide cell's shapes:")
    timed = check_and_time(rec, {})
    # zgemm and the trace at every shape of the round join the result,
    # with their launches in one round
    rows = []
    for name in ("zgemm", "ensemble_commutator_trace"):
        if sum(per_shape[name].values()) != round_launches.get(name, 0):
            raise RuntimeError(f"{name}: the round's calls and launches "
                               "disagree")
        for row in timed[name]:
            n_round = per_shape[name].get(row["key"], 0)
            if n_round:
                rows.append(dict(row, launches=n_round, cell="(4,5,4) N=20"))
    cells = [("(2,3,2) N=100", main_cell()), ("(4,5,4) N=20",
                                              (cfg_p, ds, None, params))]
    timing = {}
    for label, (cfg, cds, _, cparams) in cells:
        for impl in ("pallas", "xla"):
            c = cfg._replace(impl=impl)
            ms = round_ms(c, cds, cparams, reps=10)
            timing[f"{label} {impl}"] = ms
            say(f"  {label} impl={impl}: {ms:.3f} ms/round (CUDA events, "
                f"10 rounds after warm-up)")
    for label, (cfg, cds, _, cparams) in cells:
        profile_round(cfg, cds, cparams, f"{label} impl=pallas")
    say(f"  card during timing: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return rows


# ------------------------------------------------------- phase 5: serving
def allowed_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask allows for one head: positions from 0,
    j < sk, j <= i when causal, j > i - window when window > 0."""
    n = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def gla_flops(b, s, h, dh, chunk):
    """fp32 operations of the chunked GLA form at these inputs: per
    (b, h, chunk) of L tokens, the inter term and the state update
    (2 L dh^2 each), the decayed scores of the L(L-1)/2 strictly lower
    pairs (subtract, exp, two multiplies and an add per channel), the
    bonus (3 per token-channel), scores @ v over the L(L+1)/2 pairs
    (2 per value column), the per-element log-decay, its cumulative sum
    and the decayed q and k (9 per token-channel), and the state's decay
    (2 per entry)."""
    el = chunk * dh
    per_chunk = (4 * chunk * dh * dh + 5 * dh * chunk * (chunk - 1) // 2
                 + 3 * el + dh * chunk * (chunk + 1) + 9 * el + 2 * dh * dh)
    return per_chunk * b * h * (s // chunk)


def seq_bound_ms(name, args, kw):
    """Least time on an H100 for the function at these inputs: bytes
    (inputs once, outputs once) at HBM rate against the operations at the
    peak for their type (bf16 tensor cores for bf16 attention, fp32 CUDA
    cores otherwise: GLA's arithmetic is fp32 by contract), the larger of
    the two."""
    if name == "flash_attention":
        q, k, v = args                          # (B, Sq, H, dh), (B, Sk, K, dh)
        b, sq, h, dh = q.shape
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        pairs = allowed_pairs(sq, k.shape[1], kw.get("causal", True),
                              kw.get("window", 0))
        flops = 4 * dh * pairs * b * h          # QK^T and PV, 2 each per MAC
        peak = BF16_FLOPS if q.element_size() == 2 else FP32_FLOPS
    elif name == "gla_chunked":
        from repro_torch.kernels.gla_chunked import kernel_chunk
        r, k, v, w, u = args                    # (B, S, H, dh); u (H, dh)
        b, s, h, dh = r.shape
        nbytes = (r.element_size() * 4 * r.numel()      # r, k, v, out
                  + w.element_size() * w.numel() + 4 * u.numel()
                  + 4 * b * h * dh * dh)                 # the final state
        flops = gla_flops(b, s, h, dh, kernel_chunk(kw["chunk"]))
        peak = FP32_FLOPS
    else:
        a, b_ = args
        nbytes = a.element_size() * 3 * a.numel()
        flops = 2 * a.numel()
        peak = BF16_FLOPS if a.element_size() == 2 else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def seq_ragged_cases(device):
    """Edge shapes, seeded. Attention: Sq != Sk, S not a multiple of the
    64-row tile, a window below the tile, rows left with no allowed key,
    GQA 10:1. GLA: S = 1, S = 17 at chunk 1, 48 at chunk 16, a chunk of
    128 (run as two of 64), dh 8 and 64, odd H, w at the RWKV6 clip's
    ends (1.9e-24, below the 1e-20 clamp, and 1 - 6.1e-6), fp32 and bf16
    r/k/v, w fp32 and bf16."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(11)

    def r(dtype, *shape):
        return torch.randn(shape, generator=g).to(device, dtype)

    def u(dtype, *shape):
        return torch.rand(shape, generator=g).to(device, dtype)

    def gla(dtype, b, s, h, dh, chunk, ends=False, w_dtype=torch.float32):
        w = torch.rand((b, s, h, dh), generator=g) * 0.5 + 0.45
        if ends:
            w = torch.tensor([1.9e-24, 1.0 - 6.1e-6])[
                torch.randint(0, 2, w.shape, generator=g)]
        return ((r(dtype, b, s, h, dh), r(dtype, b, s, h, dh),
                 r(dtype, b, s, h, dh), w.to(device, w_dtype),
                 r(torch.float32, h, dh)), dict(chunk=chunk))

    bf, f32 = torch.bfloat16, torch.float32
    attn = [((r(bf, 1, 100, 10, 256), r(bf, 1, 37, 1, 256),
              r(bf, 1, 37, 1, 256)), dict(causal=True, window=0)),
            ((r(bf, 1, 37, 10, 256), r(bf, 1, 100, 1, 256),
              r(bf, 1, 100, 1, 256)), dict(causal=True, window=16)),
            ((r(f32, 2, 130, 4, 64), r(f32, 2, 130, 2, 64),
              r(f32, 2, 130, 2, 64)), dict(causal=True, window=20)),
            ((r(f32, 1, 100, 2, 64), r(f32, 1, 37, 1, 64),
              r(f32, 1, 37, 1, 64)), dict(causal=True, window=16)),
            ((r(f32, 2, 65, 2, 128), r(f32, 2, 65, 2, 128),
              r(f32, 2, 65, 2, 128)), dict(causal=False, window=0))]
    scan = [((u(f32, 3, 77, 300), r(f32, 3, 77, 300)), {}),
            ((u(bf, 3, 77, 300), r(bf, 3, 77, 300)), {}),
            ((u(f32, 1, 5, 2560), r(f32, 1, 5, 2560)), {})]
    glas = [gla(bf, 2, 1, 3, 64, 1), gla(f32, 2, 17, 3, 8, 1, ends=True),
            gla(bf, 2, 17, 5, 64, 1, ends=True),
            gla(f32, 2, 48, 5, 64, 16, ends=True),
            gla(bf, 1, 48, 3, 8, 16, ends=True),
            gla(f32, 1, 48, 3, 64, 16, w_dtype=bf),
            gla(f32, 1, 128, 3, 64, 128)]
    return {"flash_attention": attn, "rglru_scan": scan, "gla_chunked": glas}


def no_impl(kw):
    return {k: v for k, v in kw.items() if k != "impl"}


def check_and_time_seq(rec, ragged):
    """Hold each sequence kernel the phase recorded against its plain
    version on the path's recorded inputs and on ragged shapes, every
    output (GLA: out and the final state) to its own tolerance: fp32 to
    KERNEL_RTOL of the plain result's scale (GLA's longest reduction, the
    state's sum over S tokens, runs chunk by chunk in the same order in
    both; each chunk's add rounds at 6e-8 of the state's scale, and 256
    such roundings of either sign add to ~1e-6), bf16 to one bf16 ulp of
    it. Then time kernel, plain version and (attention only) SDPA at the
    path's shape. Raises on a disagreement."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as krg
    op = {"flash_attention": ops.attention, "rglru_scan": ops.lru_scan,
          "gla_chunked": ops.gla_chunked}
    results = {}
    for name, calls in rec.calls.items():
        if not calls:
            raise RuntimeError(f"the path never called {name}")
        worst = 0.0
        cases = [(f"path {list(key)} x{cnt}", args, no_impl(kw))
                 for key, (cnt, args, kw) in calls.items()]
        cases += [(f"ragged {[list(a.shape) for a in args]} "
                   f"{[str(a.dtype)[6:] for a in args]} {kw}", args, kw)
                  for args, kw in ragged[name]]
        for label, args, kw in cases:
            got = op[name](*args, **kw)
            want = op[name](*args, **dict(kw, impl="xla"))
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            ok, parts = True, []
            for g_, w_ in zip(got, want):
                err = float((g_.float() - w_.float()).abs().max())
                scale = max(1.0, float(w_.float().abs().max()))
                rtol = BF16_RTOL if w_.dtype == torch.bfloat16 else KERNEL_RTOL
                ok = ok and err <= rtol * scale
                parts.append(f"max_abs_err {err:.3e} (tol {rtol:.2e} x "
                             f"scale {scale:.3g})")
                if label.startswith("path"):
                    worst = max(worst, err)
            say(f"  {name:16s} {label}: {'; '.join(parts)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version")
        (cnt, args, kw), = calls.values()      # one shape on the path
        kw = no_impl(kw)
        b_ms, b_by = seq_bound_ms(name, args, kw)
        if name == "flash_attention":
            q, k, v = args

            def heads_major(x):                 # the layout ops hands over
                bx, sx, hx, dx = x.shape
                return ops._dense(x.transpose(1, 2).reshape(bx * hx, sx, dx))
            qf, kf, vf = (heads_major(x) for x in (q, k, v))
            k_ms = cuda_ms(lambda: kfa.flash_attention(qf, kf, vf, **kw),
                           reps=5, warmup=1)
            p_ms = cuda_ms(lambda: ref.attention_ref(qf, kf, vf, **kw),
                           reps=3, warmup=1)
            i = torch.arange(q.shape[1], device=q.device)[:, None]
            j = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = j <= i if kw["causal"] else torch.ones_like(j > i)
            if kw["window"] > 0:
                mask &= j > i - kw["window"]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
            want = ops.attention(q, k, v, **dict(kw, impl="xla"))
            lib_err = float((lib().transpose(1, 2).float()
                             - want.float()).abs().max())
            lib_scale = float(want.float().abs().max())
            say(f"  {name:16s} SDPA yardstick: max_abs_err {lib_err:.3e} "
                f"(tol {YARDSTICK_RTOL:.0e} x scale {lib_scale:.3g})")
            if lib_err > YARDSTICK_RTOL * lib_scale:
                raise RuntimeError("SDPA yardstick disagrees with the plain "
                                   "attention")
            lib_ms = cuda_ms(lib, reps=5, warmup=1)
            got = kfa.flash_attention(qf, kf, vf, **kw).float()
            want = ref.attention_ref(qf, kf, vf, **kw).float()
            terms = ref.attention_ref(qf.float(), kf.float(), vf.float().abs(),
                                      **kw)
            excess = (((got - want).abs() - bf16_ulp(want)).clamp_min(0)
                      / terms.clamp_min(1e-30))
            say(f"  {name:16s} path, element by element: "
                f"{float((got != want).float().mean()):.4%} differ, the "
                f"largest excess over one bf16 ulp {float(excess.max()):.3e} "
                f"of (P |V|) / l")
            del got, want, terms, excess
            b, sq, h, dh = q.shape
            flops = 4 * dh * b * h * allowed_pairs(sq, k.shape[1], **kw)
            q32, k32, v32 = (x.float() for x in (qf, kf, vf))
            f32_ms = cuda_ms(lambda: kfa.flash_attention(q32, k32, v32, **kw),
                             reps=2, warmup=1)
            del q32, k32, v32
            say(f"  {name:16s} {kfa.bf16_design()} design: "
                f"{flops / k_ms / 1e9:.1f} TFLOP/s on allowed pairs, "
                f"{100 * b_ms / k_ms:.1f}% of the bound, {k_ms / lib_ms:.3f}x "
                f"SDPA's time; the fp32-storage kernel (CUDA cores) "
                f"{f32_ms:.4f} ms at this shape")
        elif name == "gla_chunked":
            r, k, v, w, u = args
            dense = [ops._dense(x) for x in (r, k, v, w)] + [
                ops._dense(u.float())]      # what ops hands the kernel
            k_ms = cuda_ms(lambda: kgla.gla_chunked(*dense, **kw), reps=10,
                           warmup=2)
            p_ms = cuda_ms(lambda: ref.gla_chunked_ref(r, k, v, w, u,
                                                       kw["chunk"]),
                           reps=3, warmup=1)
            lib_ms = None   # no single PyTorch call computes chunked GLA
        else:
            a, b = args
            k_ms = cuda_ms(lambda: krg.rglru_scan(a, b), reps=20, warmup=2)
            p_ms = cuda_ms(lambda: ref.rglru_scan_ref(a, b), reps=2,
                           warmup=1)
            lib_ms = None          # no single PyTorch call is a linear scan
        say(f"  {name:16s} timed at {[list(x.shape) for x in args]} "
            f"{[str(x.dtype)[6:] for x in args]} {kw} x{cnt}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.6f} ms ({b_by}), kernel/bound {k_ms / b_ms:.1f}x")
        results[name] = dict(name=name, route="cuda", **SEQ_KERNELS[name],
                             shape=[list(x.shape) for x in args],
                             max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return results


def bf16_ulp(x):
    """Spacing of bf16 at |x| (0 at 0): 2^(e - 7) for |x| in [2^e, 2^(e+1))."""
    import torch
    mant, exp = torch.frexp(x.float())
    return torch.where(mant == 0, torch.zeros_like(mant),
                       torch.ldexp(torch.ones_like(mant), exp - 8))


def logit_dev(got, want):
    """Max abs deviation relative to the scale (max |logit|) of ``want``."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def nudge_(p32, device, slab=1 << 26):
    """Move every fp32 weight one ulp, up or down at random (seeded), in
    place, ``slab`` elements at a time (no full-size temporaries)."""
    import torch
    g = torch.Generator(device=device).manual_seed(2)
    for v in p32.values():
        up = torch.randint(0, 2, v.shape, generator=g, device=device,
                           dtype=torch.bool).view(-1)
        flat = v.view(-1)
        for i in range(0, flat.numel(), slab):
            part = flat[i:i + slab]
            part.copy_(torch.nextafter(part, torch.where(
                up[i:i + slab], float("inf"), float("-inf"))))
        del up


def check_prefill_budgets(cfg, params, batch, logits, cache):
    """The kernel prefill (``logits``, ``cache``) against the same prefill
    through the plain versions: bf16 logits within the bf16 budget (the
    plain bf16 prefill's deviation from the plain fp32 one, same weights
    and tokens), and the fp32 kernel prefill within the plain fp32
    prefill's deviation when every weight moves one ulp. Prints each cache
    entry's deviation; returns the bf16 budget."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    plain_logits, plain_cache = make_prefill_step(Model(cfg, impl="xla"))(
        params, batch)
    dev = logit_dev(logits, plain_logits)
    for key in sorted(cache):
        say(f"    cache {key} {tuple(cache[key].shape)} {cache[key].dtype}: "
            f"kernel vs plain {logit_dev(cache[key], plain_cache[key]):.3e} "
            f"of its scale")
    del plain_cache
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    plain_step32 = make_prefill_step(Model(cfg32, impl="xla"))
    plain32, _ = plain_step32(p32, batch)
    kern32, _ = make_prefill_step(Model(cfg32))(p32, batch)
    # the model's own fp32 noise floor: every weight one ulp off, plain
    nudge_(p32, logits.device)
    nudged32, _ = plain_step32(p32, batch)
    del p32
    torch.cuda.empty_cache()
    budget = logit_dev(plain_logits, plain32)
    dev32, floor32 = logit_dev(kern32, plain32), logit_dev(nudged32, plain32)
    ok = dev <= budget and dev32 <= floor32
    say(f"  last-position logits, kernels vs plain: bf16 {dev:.3e} of the "
        f"scale {float(plain_logits.abs().max()):.4g}, bf16 budget "
        f"{budget:.3e} (plain bf16 vs plain fp32, same weights and tokens); "
        f"fp32 {dev32:.3e}, fp32 budget {floor32:.3e} (plain fp32 with "
        f"every weight one ulp off) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the kernel prefill deviates from the plain one "
                           "beyond its budget")
    return budget


def decode_and_check(cfg, model, params, batch, logits, cache, budget,
                     n_gen):
    """Move the prefill cache into a S + n_gen cache and greedy-decode
    n_gen tokens through ``make_serve_step`` (ms/token by CUDA events);
    then hold the first decode step against a prefill of the prompt and
    its token (S + 1) within the bf16 budget. Returns that prefill's
    launch counts."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    b, s = batch["tokens"].shape
    serve = make_serve_step(model)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    warm = model.extend_cache(cache, s + n_gen)
    serve(params, warm, {"tokens": tok[:, None]}, s)     # warm-up
    del warm
    dcache = model.extend_cache(cache, s + n_gen)
    first, tokens = None, []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_gen):
        tok, step_logits, dcache = serve(params, dcache,
                                         {"tokens": tok[:, None]}, s + i)
        tokens.append(tok)
        if i == 0:
            first = step_logits.clone()
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / n_gen
    gen = torch.stack(tokens, 1)
    say(f"  decode {decode_ms:.3f} ms/token over {n_gen} steps (CUDA "
        f"events, batch {b}: {b / decode_ms * 1e3:,.0f} tokens/s); sample "
        f"{gen[0, :8].tolist()}")
    if not (bool(torch.isfinite(step_logits).all())
            and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise RuntimeError("decode gave non-finite logits or bad tokens")
    del dcache
    longer = {"tokens": torch.cat([batch["tokens"],
                                   torch.argmax(logits, -1).int()[:, None]],
                                  1)}
    build.reset_launches()
    ext_logits, _ = make_prefill_step(model)(params, longer)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    dev_dec = logit_dev(first, ext_logits)
    ok = dev_dec <= budget
    say(f"  first decode step vs prefill of S+1 = {s + 1} tokens "
        f"(launches {launches}): {dev_dec:.3e} of the scale (budget "
        f"{budget:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("decode disagrees with prefill")
    return launches


def prefill_main_path(prefill, params, batch, want):
    """The main path: one prefill with the launch counts zeroed just
    before and read just after (they must be ``want``), timed by CUDA
    events, then twice more; prints ms, tokens/s and peak memory."""
    import torch
    from repro_torch.kernels import build
    b, s = batch["tokens"].shape
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = prefill(params, batch)
    end.record()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    prefill_ms = start.elapsed_time(end)
    say(f"  launches in one prefill: {launches}")
    if launches != want:
        raise RuntimeError(f"prefill launched {launches}, expected {want}")
    more = [cuda_ms(lambda: prefill(params, batch), reps=1, warmup=0)
            for _ in range(2)]
    say(f"  prefill {prefill_ms:.3f} ms (then {more[0]:.3f}, {more[1]:.3f}; "
        f"CUDA events), peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB, {b * s / prefill_ms * 1e3:,.0f} prompt tokens/s")
    return logits, cache, launches


def profile_serving(model, params, batch, logits, cache, n_gen):
    """Profiler breakdowns of one prefill and one decode step."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    b, s = batch["tokens"].shape
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    profile_device(f"prefill B={b} S={s}", lambda: prefill(params, batch))
    dcache = model.extend_cache(cache, s + n_gen)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    profile_device(f"one decode step at position {s}", lambda: serve(
        params, dcache, {"tokens": tok[:, None]}, s))


def serve_cli(arch):
    say(f"  python -m repro_torch.launch.serve --arch {arch}:")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", arch], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    for line in (out.stdout + out.stderr).strip().splitlines()[-4:]:
        say("    " + line)
    if out.returncode != 0:
        raise RuntimeError("the serve CLI failed")


def phase_serve(device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    b, s, n_gen = SERVE_B, SERVE_S, SERVE_GEN
    cfg = get_config("recurrentgemma-2b")
    say(f"== phase 5: {cfg.name} serving at full width ({cfg.n_layers} "
        f"layers {cfg.block_pattern}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, window "
        f"{cfg.window}, {cfg.dtype}): B={b}, S={s}, {n_gen} decode tokens")
    model = Model(cfg)
    t0 = time.time()
    params = model.init(seed=0, device=device)
    torch.cuda.synchronize()
    say(f"  init {model.num_params():,} params in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    batch = concrete_batch(cfg, b, s, torch.Generator().manual_seed(1),
                           kind="prefill", device=device)
    prefill = make_prefill_step(model)
    with Recorder({"attention": "flash_attention",
                   "lru_scan": "rglru_scan"}) as rec:
        prefill(params, batch)                  # warm-up, inputs recorded
        torch.cuda.synchronize()
    logits, cache, launches = prefill_main_path(
        prefill, params, batch, {"flash_attention": 8, "rglru_scan": 18})
    if tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite")
    budget = check_prefill_budgets(cfg, params, batch, logits, cache)
    decode_and_check(cfg, model, params, batch, logits, cache, budget, n_gen)

    say("  sequence kernels against their plain versions, at the prefill's "
        "inputs and ragged shapes:")
    results = check_and_time_seq(rec, seq_ragged_cases(device))
    del rec
    torch.cuda.empty_cache()
    profile_serving(model, params, batch, logits, cache, n_gen)
    say(f"  card during phase 5: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del params, cache
    torch.cuda.empty_cache()
    serve_cli("recurrentgemma-2b")
    for name, row in results.items():
        row["launches"] = launches[name]
    return results


# ------------------------------------------------- phase 6: RWKV6 serving
def redraw_rwkv(params, seed):
    """Draw the reference init's zero tensors of the RWKV6 block anew
    (seeded), in place: w0 uniform in [-8, 1], w_lora_b and ts_lora_b
    N(0, 0.1), u N(0, 0.5), the mixing coefficients uniform in [0, 1].
    At the reference's init w is exp(-1) in every channel at every token,
    the bonus is 0 and the token shift does nothing, so the kernel would
    never meet a data-dependent decay."""
    import torch
    dev = next(iter(params.values())).device
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, kind):
        if kind == "uniform":
            return torch.rand(shape, generator=g, device=dev)
        return torch.randn(shape, generator=g, device=dev)
    for key, val in params.items():
        name = key.rsplit("/", 1)[-1]
        if name == "w0":
            val.copy_(draw(val.shape, "uniform") * 9.0 - 8.0)
        elif name in ("w_lora_b", "ts_lora_b"):
            val.copy_(0.1 * draw(val.shape, "normal"))
        elif name == "u":
            val.copy_(0.5 * draw(val.shape, "normal"))
        elif name in ("mu", "mu_base", "mu_k", "mu_r"):
            val.copy_(draw(val.shape, "uniform"))


def phase_rwkv(device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    b, s, n_gen = SERVE_B, SERVE_S, SERVE_GEN
    cfg = get_config("rwkv6-7b")
    say(f"== phase 6: {cfg.name} serving at full width ({cfg.n_layers} "
        f"layers {cfg.block_pattern}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, gla_chunk {cfg.gla_chunk}, {cfg.dtype}): B={b}, "
        f"S={s}, {n_gen} decode tokens")
    model = Model(cfg)
    t0 = time.time()
    params = model.init(seed=0, device=device)
    redraw_rwkv(params, seed=1)
    torch.cuda.synchronize()
    say(f"  init {model.num_params():,} params in {time.time() - t0:.1f} s "
        f"(decay, bonus and mixing tensors redrawn), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    batch = concrete_batch(cfg, b, s, torch.Generator().manual_seed(1),
                           kind="prefill", device=device)
    prefill = make_prefill_step(model)
    w_seen = {"low": 0, "high": 0, "all": 0, "dtypes": set()}

    def w_share(kernel, args, kw):
        w = args[3]
        w_seen["low"] += int((w < 1e-3).sum())
        w_seen["high"] += int((w > 0.999).sum())
        w_seen["all"] += w.numel()
        w_seen["dtypes"].add((str(args[0].dtype), str(w.dtype)))
    with Recorder({"gla_chunked": "gla_chunked"}, observe=w_share) as rec:
        prefill(params, batch)                  # warm-up, inputs recorded
        torch.cuda.synchronize()
    say(f"  w on the path: {w_seen['low'] / w_seen['all']:.4f} below 1e-3, "
        f"{w_seen['high'] / w_seen['all']:.4f} above 0.999 over "
        f"{w_seen['all']:,} decays; (r, w) dtypes {sorted(w_seen['dtypes'])}")
    if w_seen["dtypes"] != {("torch.bfloat16", "torch.float32")}:
        raise RuntimeError("the RWKV layer must hand w to the kernel in fp32")
    logits, cache, launches = prefill_main_path(
        prefill, params, batch, {"gla_chunked": cfg.n_layers})
    if tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite")
    budget = check_prefill_budgets(cfg, params, batch, logits, cache)
    s1 = decode_and_check(cfg, model, params, batch, logits, cache, budget,
                          n_gen)
    if s1 != {"gla_chunked": cfg.n_layers}:
        raise RuntimeError(f"the S+1 prefill (chunk 1) launched {s1}")

    say("  gla_chunked against its plain version, at the prefill's inputs "
        "and ragged shapes:")
    results = check_and_time_seq(rec, seq_ragged_cases(device))
    del rec
    torch.cuda.empty_cache()
    profile_serving(model, params, batch, logits, cache, n_gen)
    say(f"  card during phase 6: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    say(f"  peak memory since the timed prefill "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, cache
    torch.cuda.empty_cache()
    serve_cli("rwkv6-7b")
    for name, row in results.items():
        row["launches"] = launches[name]
    return results


# ------------------------------------------------- --time-quantum (A/B)
def time_quantum(trials=3):
    """ms/round of both quantum cells (phase 4's ``round_ms``, 10 rounds
    after a warm-up, ``trials`` times), and ms per call through ``ops``
    (``cuda_ms``, ``trials`` times) of zgemm at the (2,3,2) chain's and
    the (4,5,4) density build's shapes, dense and with the second operand
    column-major as QR returns it, beside ``torch.matmul`` on complex64 of
    the same operands, and of the trace at the three shapes of those
    cells. Seeded inputs; one JSON line of medians and trials."""
    import statistics
    import torch
    from repro_torch.core.quantum import qnn
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(3)

    def rc(*shape):
        return torch.complex(torch.randn(shape, generator=gen,
                                         dtype=torch.float64),
                             torch.randn(shape, generator=gen,
                                         dtype=torch.float64)).cuda()

    def col_major(x):
        return x.mT.contiguous().mT

    cases = {}
    for bsz, d in ((2, 16), (40, 64)):
        a, b = rc(bsz, d, d), rc(bsz, d, d)
        for lay, bb in (("dense", b), ("strided", col_major(b))):
            cases[f"zgemm ({bsz},{d},{d}) {lay}"] = (ops.complex_matmul,
                                                     (a, bb))
            cases[f"torch.matmul ({bsz},{d},{d}) {lay}"] = (
                torch.matmul, (a.to(torch.complex64),
                               bb.to(torch.complex64)))
    for label, sa, sb in (("(2,3,2)", (30, 4, 32, 8, 4), (30, 4, 1, 8, 4)),
                          ("S1", (40, 4, 32, 64, 8), (40, 4, 16, 64, 8)),
                          ("S2", (50, 4, 512, 32, 16), (50, 4, 1, 32, 16))):
        cases[f"trace {label}"] = (ops.ensemble_commutator_trace,
                                   (rc(*sa), rc(*sb)))
    result = {"src": str(qnn.__file__).rsplit("/repro_torch/", 1)[0],
              "card": smi("name,power.limit")}
    for label, kw in (("(2,3,2) N=100", {}),
                      ("(4,5,4) N=20", dict(widths=(4, 5, 4),
                                            num_nodes=20))):
        cfg, ds, _, params = main_cell(**kw)
        ms = [round_ms(cfg, ds, params, reps=10) for _ in range(trials)]
        result[f"round {label}"] = {"median": statistics.median(ms),
                                    "trials": ms}
    for label, (fn, args) in cases.items():
        ms = [cuda_ms(fn, *args) for _ in range(trials)]
        result[label] = {"median": statistics.median(ms), "trials": ms}
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the card only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch in {SRC}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    if "--time-quantum" in sys.argv:
        return time_quantum()
    t0 = time.time()
    phase_build()
    results = phase_kernels()
    launches = phase_main()
    for name, row in results.items():
        row["launches"] = launches[name]
    rows = list(results.values()) + phase_wide()
    rows += list(phase_serve().values())
    rows += list(phase_rwkv().values())
    say(f"total {time.time() - t0:.1f} s")
    say(smi("name,power.limit"))
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape"]
    extra = ["device_us", "cell", "layout"]
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + [k for k in extra if k in r]}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
