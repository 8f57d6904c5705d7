"""Where kernel B5 in f32 on the tensor cores
(ti_torch/csrc/fused_edge_mlp_jvp_tf32x3.cu) spends its launch at the
``dense_fused`` exact node of 32 chains (K = 57, R = 11,552):

1. a ``clock64`` breakdown of one CTA between its barriers: a copy of the
   kernel with a stamp after every ``__syncthreads()`` of its body and one
   at its end, each stamp adding the cycles since the previous one to its
   site (thread 0, in 512 bytes of static shared memory, so the kernel's
   registers do not change; summed over the CTA's units, mean of the CTAs).
   The first site holds the previous lane's 5F chunks (they end at the top
   of the loop), the last one the last lane's;
2. timing diagnostics in turns against the kernel as built from the tree,
   each from a copy of the sources with one change: one TF32 product
   instead of three (wrong results on purpose: it bounds what the tensor
   pipe costs); the weight fragments read from the first two k-steps only,
   so they stay in L1 (wrong results: it bounds their trip from L2); p and
   q taken as ones instead of read from the L2 scratch (wrong results: the
   scratch reads' cost); no output stores (the stores' cost).

The copies and their libraries go to build/probe_b5/. Needs a card and nvcc:

    python3 tools/b5_tc_probe.py
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ti_torch.ops import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "probe_b5")
KERNEL = os.path.join(str(_build.CSRC), "fused_edge_mlp_jvp_tf32x3.cu")
COMMON = os.path.join(str(_build.CSRC), "tf32_common.cuh")
N_ATOMS, F, CHAINS = 19, 128, 32
K, ROWS = 3 * N_ATOMS, CHAINS * N_ATOMS ** 2
DIAGNOSTICS = {  # name: (file, its text, the replacement)
    "one_pass": (COMMON, """        mma_tf32(z[p], lo, b[h][p].x, b[h][p].y);  // a_lo b_hi
        mma_tf32(z[p], hi, b[h][p].z, b[h][p].w);  // a_hi b_lo
""", ""),
    "l1_weights": (COMMON, "b[h][p] = __ldg(wp + (kw * NTM + p) * 32);",
                   "b[h][p] = __ldg(wp + ((size_t)h * NTM + p) * 32);"),
    "no_scratch_reads": (KERNEL, "v[s] = __ldcg(sp + s * NT + threadIdx.x);",
                         "v[s] = make_float4(1.f, 1.f, 1.f, 1.f);"),
    "no_out_stores": (KERNEL, "if (r < nrows)\n          __stcs(", "if (r < nrows - TR)\n          __stcs("),
}


def nvcc(src: str, lib: str, include_first: str) -> subprocess.Popen:
    return subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", include_first, "-I", str(_build.CSRC), "-o",
         lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def stamped_source() -> tuple:
    """The kernel with a stamp after every barrier of its body and at its
    end, a prof argument, and each stamp's lines and the first code line
    after the previous stamp in the source."""
    lines = open(KERNEL).read().split("\n")
    start = next(i for i, ln in enumerate(lines) if "edge_jvp_tf32x3_kernel(" in ln)
    body = next(i for i in range(start, len(lines)) if lines[i].endswith(") {"))
    end = next(i for i in range(body, len(lines)) if lines[i] == "}")
    out, labels, prev = [], [], body

    def stamp(i):
        nonlocal prev
        code = next((c.strip() for c in lines[prev + 1:i + 1]
                     if c.strip() not in ("", "{", "}") and not c.strip().startswith(("//", "#"))), "")
        out.append(f"  if (threadIdx.x == 0) {{ const long long pk_now = clock64(); "
                   f"pk_t[{len(labels)}] += pk_now - pk_last; pk_last = pk_now; }}")
        labels.append((prev + 2, i + 1, code[:70]))
        prev = i

    for i, ln in enumerate(lines):
        if i == body:
            ln = ln.replace(") {", ", long long* prof) {\n  __shared__ long long pk_t[64];\n"
                            "  if (threadIdx.x < 64) pk_t[threadIdx.x] = 0;\n"
                            "  long long pk_last = clock64();")
        if i == end:
            stamp(i - 1)
            out.append("  if (threadIdx.x == 0) for (int q = 0; q < 64; ++q) "
                       "prof[(size_t)blockIdx.x * 64 + q] = pk_t[q];")
        out.append(ln)
        if body < i < end and "__syncthreads();" in ln:
            stamp(i)
    src = "\n".join(out)
    src = re.sub(r"int ctas,\s*void\* stream\)", "int ctas, void* prof, void* stream)", src)
    src = src.replace("rows, K, ctas);", "rows, K, ctas, (long long*)prof);")
    assert len(labels) <= 64 and "(long long*)prof" in src
    return src, labels


def main() -> int:
    if not torch.cuda.is_available():
        print("b5_tc_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import pallas_kernels as pk
    from ti_torch.ops.pair_layer_kernel import pack_layer, with_tf32_weights

    os.makedirs(OUT, exist_ok=True)
    _build.build_all(("fused_edge_mlp_jvp_tf32x3",))
    src, labels = stamped_source()
    open(os.path.join(OUT, "stamped.cu"), "w").write(src)
    procs = {"stamped": nvcc(os.path.join(OUT, "stamped.cu"), os.path.join(OUT, "libstamped.so"), OUT)}
    for name, (path, old, new) in DIAGNOSTICS.items():
        where = os.path.join(OUT, name)  # both sources beside each other: a quoted include looks there first
        os.makedirs(where, exist_ok=True)
        for f in (KERNEL, COMMON):
            text = open(f).read()
            if f == path:
                assert old in text, name
                text = text.replace(old, new)
            open(os.path.join(where, os.path.basename(f)), "w").write(text)
        procs[name] = nvcc(os.path.join(where, os.path.basename(KERNEL)),
                           os.path.join(where, "lib.so"), where)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {regs}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, "libstamped.so") if name == "stamped"
                                 else os.path.join(OUT, name, "lib.so"))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    params = {k: t.detach() for k, t in CPaiNN(F, 1, n_atoms=N_ATOMS).state_dict().items()}
    w = with_tf32_weights(pack_layer(params, 0, F, torch.float32, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    args = [rnd(ROWS, 2 * F), rnd(ROWS, F), rnd(K, ROWS, 2 * F), rnd(K, ROWS, F)]
    plan = pk.jvp_plan(ROWS, K, torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty((K, ROWS, 5 * F), device="cuda")
    scratch = torch.empty(plan.ctas * pk.TC_JVP_SCRATCH, device="cuda")
    prof = torch.zeros((plan.ctas, 64), dtype=torch.int64, device="cuda")
    ptrs = [t.data_ptr() for t in args + [w.mma, w.vecs, out, scratch]]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name):
        if name == "tree":
            return pk.fused_edge_mlp_jvp(*args, w)
        fn = libs[name].fused_edge_mlp_jvp_tf32x3
        extra = [prof.data_ptr()] if name == "stamped" else []
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * (1 + len(extra))
        rc = fn(*ptrs, ROWS, K, plan.ctas, *extra, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: {rc}")
        return out

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    ref = pk.edge_mlp_jvp_reference(*args, w.phi, w.w)
    names = ["tree"] + list(DIAGNOSTICS)
    for name in names:
        got = launch(name)
        torch.cuda.synchronize()
        print(f"[{name}] max err / max |plain| {((got - ref).abs().max() / ref.abs().max()).item():.3e}")
    del ref

    launch("stamped")
    torch.cuda.synchronize()
    cycles = prof.double().mean(0)
    total = cycles.sum().item()
    print(f"[breakdown] one CTA: {total / 1e3:.1f} kcycles from its start to its end (thread 0's "
          f"clock64, mean of {plan.ctas} CTAs of {plan.units / plan.ctas:.2f} units; {card})")
    for q, (lo, hi, code) in enumerate(labels):
        print(f"[breakdown] lines {lo}-{hi}: {cycles[q].item() / 1e3:9.1f} kcycles "
              f"{100 * cycles[q].item() / total:5.1f}%  ({code})")

    times = {name: [] for name in names}
    for order in (names, names[::-1]):  # in turns, two readings each
        for name in order:
            launch(name)
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                launch(name)
            stop.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(stop) / 3)
    for name in names:
        print(f"[diagnostic] {name}: {' and '.join(f'{t:.3f}' for t in times[name])} ms a launch "
              f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
