"""Where kernel B6 in f32 on the tensor cores (ti_torch/csrc/fused_mlp_tf32x3.cu)
spends its launch, at the node rows of 128 chains (R = 2432) and the widths
of ``fused_velocity_fn``'s MLPs (combine 4F -> F, update 2F -> 3F, readout
F -> 2):

1. the wrapper's time a launch three ways, in turns for ``"tc"`` and
   ``"fma"``: launches back to back timed by CUDA events (what
   ``chip_smoke.py`` reads; the host's enqueue time is in it where it is
   longer than the kernel), the host's time to enqueue one launch, and the
   device's time alone (the same launches captured in a CUDA graph and
   replayed);
2. a ``clock64`` breakdown of the CTAs between the barriers of the kernel
   (thread 0 of every CTA stamps after each ``__syncthreads()`` of the
   body and at its end; mean cycles a CTA at each site);
3. timing diagnostics in turns against the kernel as built from the tree,
   each from a copy of the source with one change: the weight fragments
   read from the first two k-steps only, so they stay in L1
   (``l1_weights``: their trip from L2; wrong results on purpose); one TF32
   product instead of three (``one_pass``) or none (``no_mma``: what the
   products cost, their weight loads with them; wrong results); SiLU with
   ``__expf`` and ``__fdividef`` (``fast_silu``); the k-step loop not
   unrolled (``unroll1``).

The layouts the tree was chosen against (64-row tiles over thread-block
clusters of 4 CTAs, 32-row tiles over 2, 16 warps a CTA) were built by this
script from the cluster-generic source of commit 9611b93; the fresh
accumulator for each k-step it was chosen against, at commit 2a21bb6.

The copies and their libraries go to build/probe_b6/. Needs a card and nvcc:

    python3 tools/b6_tc_probe.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ti_torch.ops import _build  # noqa: E402
from ti_torch.ops import pallas_kernels as pk  # noqa: E402

OUT = os.path.join(ROOT, "build", "probe_b6")
KERNEL = os.path.join(str(_build.CSRC), "fused_mlp_tf32x3.cu")
N_ATOMS, F, CHAINS = 19, 128, 128
ROWS = CHAINS * N_ATOMS
LOAD = "b[h][p] = __ldg(wp + ((size_t)(ks + h) * ntm + p) * 32);"
MMA = ("mma_tf32(z[p], lo[h], b[h][p].x, b[h][p].y);",
       "mma_tf32(z[p], hi[h], b[h][p].z, b[h][p].w);",
       "mma_tf32(z[p], hi[h], b[h][p].x, b[h][p].y);")
UNROLL = ("#pragma unroll 2\n  for (int ks = 0; ks < ksteps; ks += 2) {",
          "#pragma unroll 1\n  for (int ks = 0; ks < ksteps; ks += 2) {")
BUILDS = {  # name: [(its text, the replacement)]
    "l1_weights": [(LOAD, "b[h][p] = __ldg(wp + ((size_t)h * ntm + p) * 32);")],
    "one_pass": [(MMA[0], ";"), (MMA[1], ";")],
    "no_mma": [(m, ";") for m in MMA],
    "fast_silu": [("constexpr int TM = 16;",
                   "__device__ __forceinline__ float fsilu(float v) "
                   "{ return __fdividef(v, 1.f + __expf(-v)); }\nconstexpr int TM = 16;"),
                  ("make_float4(silu(d0 * rstd * sc.x + bi.x), silu(d1 * rstd * sc.y + bi.y),\n"
                   "                    silu(d2 * rstd * sc.z + bi.z), silu(d3 * rstd * sc.w + bi.w));",
                   "make_float4(fsilu(d0 * rstd * sc.x + bi.x), fsilu(d1 * rstd * sc.y + bi.y),\n"
                   "                    fsilu(d2 * rstd * sc.z + bi.z), fsilu(d3 * rstd * sc.w + bi.w));")],
    "unroll1": [UNROLL],
}
RIGHT = ("tree", "fast_silu", "unroll1")


def nvcc(src: str, lib: str) -> subprocess.Popen:
    return subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def stamped_source() -> tuple:
    """The kernel with a stamp after every barrier of its body and at its
    end, a prof argument, and each stamp's site."""
    lines = open(KERNEL).read().split("\n")
    start = next(i for i, ln in enumerate(lines) if "fused_mlp_tf32x3_kernel(" in ln)
    body = next(i for i in range(start, len(lines)) if lines[i].endswith(") {"))
    end = next(i for i in range(body, len(lines)) if lines[i] == "}")
    out, labels = lines[:body + 1], []
    assert out[body].endswith("int f_out) {"), out[body]
    out[body] = out[body].replace("int f_out) {", "int f_out, long long* prof) {")
    out.append("  long long pk_prev = clock64();")
    for i in range(body + 1, end):
        out.append(lines[i])
        s = lines[i].strip()
        if s.startswith("__syncthreads();"):
            out.append(f"  if (threadIdx.x == 0) {{ const long long pk_now = clock64(); "
                       f"atomicAdd((unsigned long long*)&prof[{len(labels)}], "
                       f"(unsigned long long)(pk_now - pk_prev)); pk_prev = pk_now; }}")
            labels.append(f"line {i + 1}: {s}")
    out.append(f"  if (threadIdx.x == 0) atomicAdd((unsigned long long*)&prof[{len(labels)}], "
               f"(unsigned long long)(clock64() - pk_prev));")
    labels.append("the end: the last Dense and its stores")
    out += lines[end:]
    text = "\n".join(out)
    for old, new in (("k_pad,\n      f_out);", "k_pad,\n      f_out, (long long*)prof);"),
                     ("int rows, int f_in, int f_out, void* stream) {",
                      "int rows, int f_in, int f_out, void* stream, void* prof) {")):
        assert old in text, old
        text = text.replace(old, new)
    return text, labels


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    base = open(KERNEL).read()
    sources = {"tree": base}
    for name, edits in BUILDS.items():
        text = base
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        sources[name] = text
    stamped, labels = stamped_source()
    sources["stamped"] = stamped
    procs = {}
    for name, text in sources.items():
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        procs[name] = nvcc(src, os.path.join(OUT, f"lib{name}.so"))
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build {name}] rc {proc.returncode}; {' | '.join(regs)}", flush=True)
        if proc.returncode:
            print(log)
            raise SystemExit(1)
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    return libs, labels


def launcher(lib, x, pack, out, extra=()):
    fn = lib.fused_mlp_tf32x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * (1 + len(extra))
    fn.restype = ctypes.c_int
    args = (x.data_ptr(), pack.tc.data_ptr(), pack.vecs.data_ptr(), out.data_ptr(), x.shape[0],
            pack.f_in, pack.f_out)

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream, *extra)
        assert rc == 0, rc

    return run


def event_ms(fn, n: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def enqueue_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / n


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device time a call: n calls captured in a CUDA graph, replayed."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * replays)


def main() -> int:
    if not torch.cuda.is_available():
        print("b6_tc_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops.mlp_block import _mlp_block, mlp_weights

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, labels = build()
    torch.manual_seed(0)
    params = {k: t.detach() for k, t in CPaiNN(F, 5, n_atoms=N_ATOMS).state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 50
    for name, f_in in (("combine", 4 * F), ("update_0.mlp", 2 * F), ("readout.mlp", F)):
        pack = pk.pack_mlp(mlp_weights(params, name), "cuda")
        x = torch.randn(ROWS, f_in, generator=g, device="cuda")
        ref = _mlp_block(x, pack.w)
        tag = f"{name} {f_in}->{pack.f_out} R={ROWS}"
        # 1. the wrapper, three ways
        res = {v: {"events": [], "enqueue": [], "graph": []} for v in ("tc", "fma")}
        for v in ("tc", "fma", "fma", "tc"):
            fn = lambda: pk.fused_mlp(x, pack, variant=v)  # noqa: E731
            res[v]["events"].append(event_ms(fn, n))
            res[v]["enqueue"].append(enqueue_ms(fn, n))
            res[v]["graph"].append(graph_ms(fn, n))
        for v, r in res.items():
            print(f"[B6 {tag} {v}] wrapper back to back {r['events']} ms; host enqueue "
                  f"{r['enqueue']} ms; device alone (CUDA graph) {r['graph']} ms", flush=True)
        # 2. the cycle breakdown
        prof = torch.zeros(64, dtype=torch.int64, device="cuda")
        out = torch.empty(ROWS, pack.f_out, device="cuda")
        launcher(libs["stamped"], x, pack, out, (prof.data_ptr(),))()
        torch.cuda.synchronize()
        ctas = pk.mlp_plan(ROWS, f_in, pack.f_out).ctas
        cyc = (prof[:len(labels)].double() / ctas).tolist()
        total = sum(cyc)
        print(f"[B6 {tag} cycles] {total:.0f} cycles a CTA (mean of {ctas}); by site:", flush=True)
        for lab, c in zip(labels, cyc):
            print(f"    {c:9.0f} ({100 * c / total:5.1f}%)  {lab}", flush=True)
        # 3. diagnostics in turns (device time, CUDA graph)
        times = {k: [] for k in ("tree", *BUILDS)}
        for k in list(times) + list(reversed(times)):
            o = torch.empty(ROWS, pack.f_out, device="cuda")
            times[k].append(graph_ms(launcher(libs[k], x, pack, o), n))
            if k in RIGHT:
                err = ((o - ref).abs().max() / ref.abs().max()).item()
                assert err <= 2e-5, (k, err)
        print(f"[B6 {tag} builds, device ms in turns] "
              + "; ".join(f"{k} {v}" for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
