"""Where kernel B3 in f32 (ti_torch/csrc/pair_tangent_tf32x3.cu) spends its
time on one NVIDIA H100, at the exact slice's shape (128 chains, N = 19,
K = 57, F = 128):

1. a breakdown of one CTA's cycles between consecutive barriers of the
   kernel (thread 0's ``clock64``, summed over the lane tiles and averaged
   over the 2,432 CTAs), from a copy of the source with a time stamp after
   every ``__syncthreads()``;
2. timing diagnostics in turns against the kernel as built from the tree,
   each from a copy of tf32_common.cuh with one change: the A operand split
   by truncation (``hi = a & ~0x1fff``, ``lo = a - hi``, no ``cvt``); the
   weight fragments read from the first two k-steps only, so they stay in
   L1 (wrong results on purpose: it bounds what their trip from L2 costs);
   one TF32 product instead of three (wrong results: it bounds what the
   tensor pipe costs); the last two together.

The copies and their libraries go to build/probe/. Needs a card and nvcc:

    python3 tools/b3_f32_probe.py
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

OUT = os.path.join(ROOT, "build", "probe")
KERNEL = os.path.join(str(_build.CSRC), "pair_tangent_tf32x3.cu")
COMMON = os.path.join(str(_build.CSRC), "tf32_common.cuh")
N_ATOMS, F, K, CHAINS = 19, 128, 57, 128
DIAGNOSTICS = {  # name: (text of tf32_common.cuh, its replacement)
    "trunc_split": ("""        hi[c] = to_tf32(a[c]);
        lo[c] = to_tf32(a[c] - __uint_as_float(hi[c]));""",
                    """        hi[c] = __float_as_uint(a[c]) & 0xffffe000u;
        lo[c] = __float_as_uint(a[c] - __uint_as_float(hi[c]));"""),
    "l1_weights": ("b[h][p] = __ldg(wp + (kw * NTM + p) * 32);",
                   "b[h][p] = __ldg(wp + ((size_t)h * NTM + p) * 32);"),
    "one_pass": ("""        mma_tf32(z[p], lo, b[h][p].x, b[h][p].y);  // a_lo b_hi
        mma_tf32(z[p], hi, b[h][p].z, b[h][p].w);  // a_hi b_lo
""", ""),
}


def nvcc(src: str, lib: str, include_first: str) -> subprocess.Popen:
    return subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", include_first, "-I", str(_build.CSRC), "-o",
         lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def stamped_source() -> tuple:
    """The kernel with a stamp after every barrier of its body, a prof
    argument, and each stamp's line and the first code line it closes."""
    lines = open(KERNEL).read().split("\n")
    start = next(i for i, ln in enumerate(lines) if "pair_tangent_tf32x3_kernel(" in ln)
    body = next(i for i in range(start, len(lines)) if lines[i].endswith(") {"))
    end = next(i for i in range(body, len(lines)) if lines[i] == "}")
    out, labels, prev = [], [], body
    for i, ln in enumerate(lines):
        if i == body:
            ln = ln.replace(") {", ", long long* prof) {\n  long long pk_t[64] = {};\n"
                            "  long long pk_last = clock64();")
        out.append(ln)
        if body < i < end and "__syncthreads();" in ln:
            code = next((c.strip() for c in lines[prev + 1:i + 1]
                         if c.strip() not in ("", "{", "}") and not c.strip().startswith(("//", "#"))),
                        "")
            out.append(f"  {{ const long long pk_now = clock64(); pk_t[{len(labels)}] += "
                       f"pk_now - pk_last; pk_last = pk_now; }}")
            labels.append((prev + 2, i + 1, code[:70]))
            prev = i
        if i == end - 1:
            out.append("  if (threadIdx.x == 0) for (int q = 0; q < 64; ++q) "
                       "prof[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 64 + q] = pk_t[q];")
    src = "\n".join(out)
    src = re.sub(r"float pe_scale, void\* stream\)", "float pe_scale, void* prof, void* stream)", src)
    src = src.replace("N, K, pe_scale);", "N, K, pe_scale, (long long*)prof);")
    assert len(labels) <= 64 and "(long long*)prof" in src
    return src, labels


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_f32_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops.pair_layer_kernel import pack_layer, pe_scale, with_tf32_weights
    from ti_torch.ops.pair_tangent_kernel import pair_tangent, pair_tangent_plain

    os.makedirs(OUT, exist_ok=True)
    _build.build_all(("pair_tangent_tf32x3",))
    src, labels = stamped_source()
    open(os.path.join(OUT, "stamped.cu"), "w").write(src)
    procs = {"stamped": nvcc(os.path.join(OUT, "stamped.cu"), os.path.join(OUT, "libstamped.so"), OUT)}
    common, kernel = open(COMMON).read(), open(KERNEL).read()
    for name, parts in [(d, [d]) for d in DIAGNOSTICS] + [("l1_weights+one_pass",
                                                          ["l1_weights", "one_pass"])]:
        text = common
        for part in parts:
            assert DIAGNOSTICS[part][0] in text, part
            text = text.replace(*DIAGNOSTICS[part])
        where = os.path.join(OUT, name)  # the kernel beside its header: a quoted include looks there first
        os.makedirs(where, exist_ok=True)
        open(os.path.join(where, "tf32_common.cuh"), "w").write(text)
        open(os.path.join(where, "pair_tangent_tf32x3.cu"), "w").write(kernel)
        procs[name] = nvcc(os.path.join(where, "pair_tangent_tf32x3.cu"),
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
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda")

    b, n = CHAINS, N_ATOMS
    base = [0.3 * rnd(b, n, 3), rnd(b, n, F), rnd(b, 3, n, F, scale=0.3), rnd(b, n * n, F)]
    lanes = [rnd(b, K, n, 3), rnd(b, K, n, F, scale=0.1), rnd(b, K, 3, n, F, scale=0.1),
             rnd(b, K, n * n, F, scale=0.1)]
    outs = [torch.empty((b, 3, n, F), device="cuda"), torch.empty((b, n, F), device="cuda"),
            torch.empty_like(base[3]), torch.empty((b, K, 3, n, F), device="cuda"),
            torch.empty((b, K, n, F), device="cuda"), torch.empty_like(lanes[3])]
    scratch = torch.empty((b * n, 10 * n * F), device="cuda")
    prof = torch.zeros((b * n, 64), dtype=torch.int64, device="cuda")
    ptrs = [t.data_ptr() for t in base + lanes + [w.mma, w.vecs] + outs + [scratch]]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name):
        if name == "tree":
            return pair_tangent(*base, *lanes, w, 10.0)
        fn = libs[name].pair_tangent_tf32x3
        extra = [prof.data_ptr()] if name == "stamped" else []
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_void_p] * (1 + len(extra)))
        rc = fn(*ptrs, b, n, K, pe_scale(10.0), *extra, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: {rc}")
        return outs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    ref = pair_tangent_plain(*base, *lanes, w, 10.0, 1)
    for name in ["tree"] + list(DIAGNOSTICS) + ["l1_weights+one_pass"]:
        got = launch(name)
        torch.cuda.synchronize()
        err = max(((a - q).abs().max() / q.abs().max()).item() for a, q in zip(got, ref))
        print(f"[{name}] max err / max |plain| {err:.3e}")

    launch("stamped")
    torch.cuda.synchronize()
    cycles = prof.double().mean(0)
    total = cycles.sum().item()
    print(f"[breakdown] one CTA: {total / 1e3:.1f} kcycles between its first and last barrier "
          f"(thread 0's clock64, mean of {b * n} CTAs; {card})")
    for q, (lo, hi, code) in enumerate(labels):
        print(f"[breakdown] lines {lo}-{hi}: {cycles[q].item() / 1e3:9.1f} kcycles "
              f"{100 * cycles[q].item() / total:5.1f}%  ({code})")

    names = ["tree"] + list(DIAGNOSTICS) + ["l1_weights+one_pass"]
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
