"""Where kernel B7 on the tensor cores (ti_torch/csrc/div_kernel_tf32x3.cu)
spends its launch at the exact-divergence node of 128 chains (N = 19,
F = 128, 5 layers, L = 4, the plan's chunks a CTA):

1. a ``clock64`` breakdown of one CTA: a copy of the kernel with a stamp
   after every ``__syncthreads()`` of its body and after its update block,
   each stamp adding the cycles since the previous one to its site (thread
   0, in 512 bytes of static shared memory, so the kernel's registers do
   not change; summed over layers, dst atoms, lane tiles and chunks, mean
   of the CTAs). The site that closes the per-lane sums is split by chunk:
   chunk 3 is the d_e store. Sites are grouped into the phases: primal,
   d_e and d_s loads with the row geometry, phi's tangent front, w's
   tangent front (with dPE), the 5F chunks' products, the per-lane sums,
   the d_e store and the update block;
2. timing diagnostics in turns against the kernel as built from the tree,
   each from a copy of the sources with one change: one TF32 product
   instead of three (wrong results on purpose: it bounds what the tensor
   pipe costs); no d_e traffic (the d_e tile read as zeros and never
   stored: wrong results, its cost); no update block (wrong results, its
   cost); the weight fragments read from the first two k-steps only, so
   they stay in L1 (wrong results: it bounds their trip from L2).

The copies and their libraries go to build/probe_b7/. Needs a card and nvcc:

    python3 tools/b7_tc_probe.py
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ti_torch.ops import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "probe_b7")
KERNEL = os.path.join(str(_build.CSRC), "div_kernel_tf32x3.cu")
COMMON = os.path.join(str(_build.CSRC), "tf32_common.cuh")
N_ATOMS, F, LAYERS, CHAINS, LANES = 19, 128, 5, 128, 4
DIAGNOSTICS = {  # name: [(file, its text, the replacement)]
    "one_pass": [(COMMON, """        mma_tf32(z[p], lo, b[h][p].x, b[h][p].y);  // a_lo b_hi
        mma_tf32(z[p], hi, b[h][p].z, b[h][p].w);  // a_hi b_lo
""", "")],
    "no_de_traffic": [
        (KERNEL, "cp_async16(xe, DE(lc) + (size_t)j * F + f);",
         "*reinterpret_cast<float4*>(xe) = make_float4(0.f, 0.f, 0.f, 0.f);"),
        (KERNEL, "if (k == 3) {  // d_e += dde, in place on the tile's real rows",
         "if (k == 3) {\n          } else if (k == 3) {")],
    "no_update": [(KERNEL, "    update_block_tc(smem, stat,", "    if (SL < 0) update_block_tc(smem, stat,")],
    "l1_weights": [(COMMON, "b[h][p] = __ldg(wp + (kw * NTM + p) * 32);",
                    "b[h][p] = __ldg(wp + ((size_t)h * NTM + p) * 32);")],
}
# phases: (name, marker of the source line where the phase starts)
PHASES = [("primal", "// ---- the primal of"),
          ("d_e, d_s loads + row geometry", "// ---- the CTA's real lanes"),
          ("phi tangent front", "if (!first) {  // phi's tangent front"),
          ("w tangent front (with dPE)", "// dPE = dPE/ddist * ddist into X1"),
          ("5F chunks: products", "// the 5F chunks: dh = (dp q + p dq)"),
          ("per-lane sums", "__syncthreads();  // dh is in"),
          ("update block", "// every dst atom of the layer is written")]
SUMS_END = "__syncthreads();  // DH, SP, SQ are free for the next chunk"


def nvcc(src: str, lib: str, include_first: str) -> subprocess.Popen:
    return subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", include_first, "-I", str(_build.CSRC), "-o",
         lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def stamped_source() -> tuple:
    """The kernel with a stamp after every barrier of its body and after its
    update block, a prof argument, and per site: its source line and phase
    (the d_e store gets a site of its own: chunk 3 of the sums)."""
    lines = open(KERNEL).read().split("\n")
    start = next(i for i, ln in enumerate(lines) if "div_tf32x3_kernel(DivTcArgs a)" in ln)
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    marks = [(next(i for i in range(start, end) if m in lines[i]), name) for name, m in PHASES]
    out, sites = [], []

    def phase(i):  # of the code the stamp after line i closes
        return [name for at, name in marks if at < i][-1]

    def stamp(i, index="{q}"):
        q = len(sites)
        out.append(f"  if (threadIdx.x == 0) {{ const long long pk_now = clock64(); "
                   f"pk_t[{index.format(q=q)}] += pk_now - pk_last; pk_last = pk_now; }}")

    for i, ln in enumerate(lines):
        if i == start:
            ln = ln.replace("(DivTcArgs a) {", "(DivTcArgs a, long long* prof) {\n"
                            "  __shared__ long long pk_t[64];\n"
                            "  if (threadIdx.x < 64) pk_t[threadIdx.x] = 0;\n"
                            "  long long pk_last = clock64();")
        if i == end:
            out.append("  if (threadIdx.x == 0) for (int q = 0; q < 64; ++q) "
                       "prof[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 64 + q] = pk_t[q];")
        out.append(ln)
        if start < i < end and SUMS_END in ln:
            stamp(i, "{q} + (k == 3)")
            sites += [(i + 1, "per-lane sums"), (i + 1, "d_e store (chunk 3)")]
        elif start < i < end and ("__syncthreads();" in ln or ln.rstrip().endswith("N, nreal);")):
            stamp(i)
            sites.append((i + 1, phase(i)))
    src = "\n".join(out)
    src = src.replace("<<<dim3((n_chunks + G - 1) / G, C), pk::NT, DIV_SMEM, (cudaStream_t)stream>>>(a);",
                      "<<<dim3((n_chunks + G - 1) / G, C), pk::NT, DIV_SMEM, (cudaStream_t)stream>>>("
                      "a, (long long*)prof);")
    src = re.sub(r"int G,\s*void\* stream\)", "int G, void* prof, void* stream)", src)
    assert len(sites) <= 64 and "(long long*)prof" in src and "void* prof" in src
    return src, sites


def inputs():
    """B7's packed inputs, stacks and 3xTF32 packing at the node's shape."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.models.cpainn_dense import dense_edge_type_matrix
    from ti_torch.ops import div_kernel as dk

    torch.manual_seed(0)
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    p = {k: w.detach().to("cuda") for k, w in model.state_dict().items()}
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    x = 0.1 * np.random.default_rng(4).standard_normal((CHAINS, N_ATOMS, 3))
    xs = torch.as_tensor(x - x.mean(axis=1, keepdims=True), dtype=torch.float32, device="cuda")
    temps = torch.tensor([[1000.0, 300.0]], device="cuda").expand(CHAINS, 2)
    etype = torch.as_tensor(dense_edge_type_matrix(template.edges), device="cuda").long()
    with torch.no_grad():
        st = dk._primal_layer_states(model, p, xs, 0.5, temps,
                                     torch.as_tensor(template.atom_ids, device="cuda"), etype)
    stacks = dk._pack_mlp_stacks(p, LAYERS)
    return dk.pack_inputs(st, LANES), stacks, dk.pack_tf32_stacks(stacks)


def main() -> int:
    if not torch.cuda.is_available():
        print("b7_tc_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from ti_torch.ops import div_kernel as dk

    os.makedirs(OUT, exist_ok=True)
    _build.build_all(("div_kernel_tf32x3",))
    src, sites = stamped_source()
    open(os.path.join(OUT, "stamped.cu"), "w").write(src)
    procs = {"stamped": nvcc(os.path.join(OUT, "stamped.cu"), os.path.join(OUT, "libstamped.so"), OUT)}
    for name, edits in DIAGNOSTICS.items():
        where = os.path.join(OUT, name)  # the sources beside each other: a quoted include looks there first
        os.makedirs(where, exist_ok=True)
        for f in (KERNEL, COMMON):
            text = open(f).read()
            for path, old, new in edits:
                if path == f:
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
    inp, stacks, tf32 = inputs()
    c, sl, n, _ = inp.s.shape
    n_chunks = inp.geom.shape[1] // LANES
    plan = dk.div_tc_plan(c, n, LANES, n_chunks, torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty((c, n_chunks, LANES, 4, n, F), device="cuda")
    nodes, d_e = torch.empty_like(out), torch.empty((c, n_chunks, LANES, n * n, F), device="cuda")
    scratch = torch.empty(plan.ctas * 10 * n * F, device="cuda")
    prof = torch.zeros((plan.ctas, 64), dtype=torch.int64, device="cuda")
    ptrs = [t.data_ptr() for t in (*inp, tf32, stacks.vecs, stacks.b3, out, nodes, d_e, scratch)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name):
        if name == "tree":
            return dk.div_kernel(inp, stacks, LANES, tf32=tf32)
        fn = getattr(libs[name], "div_kernel_tf32x3")
        extra = [prof.data_ptr()] if name == "stamped" else []
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * (1 + len(extra))
        rc = fn(*ptrs, c, n, sl, LANES, n_chunks, plan.chunks, *extra, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: {rc}")
        return out

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    with torch.no_grad():
        ref = dk.div_kernel_plain(inp, stacks, LANES)
        names = ["tree"] + list(DIAGNOSTICS)
        for name in names + ["stamped"]:
            got = launch(name)
            torch.cuda.synchronize()
            print(f"[{name}] max err / max |plain| "
                  f"{((got - ref).abs().max() / ref.abs().max()).item():.3e}")
        del ref

        launch("stamped")
        torch.cuda.synchronize()
        cycles = prof.double().mean(0)
        total = cycles.sum().item()
        print(f"[breakdown] one CTA: {total / 1e6:.2f} Mcycles from its start to its end (thread 0's "
              f"clock64, mean of {plan.ctas} CTAs of {plan.chunks} chunks; {card})")
        by_phase = {}
        for q, (line, ph) in enumerate(sites):
            by_phase[ph] = by_phase.get(ph, 0.0) + cycles[q].item()
            print(f"[breakdown] line {line} ({ph}): {cycles[q].item() / 1e6:8.3f} Mcycles "
                  f"{100 * cycles[q].item() / total:5.1f}%")
        for ph, cyc in by_phase.items():
            print(f"[phase] {ph}: {cyc / 1e6:.3f} Mcycles, {100 * cyc / total:.1f}%")

        times = {name: [] for name in names}
        for order in (names, names[::-1]):  # in turns, two readings each
            for name in order:
                launch(name)
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(2):
                    launch(name)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / 2)
    for name in names:
        print(f"[diagnostic] {name}: {' and '.join(f'{t:.3f}' for t in times[name])} ms a launch "
              f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
