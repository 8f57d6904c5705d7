"""Build and load the hand-written CUDA kernels (ti_torch/csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use into ``build/kernels/`` at the root of the checkout (listed
in .gitignore) and is reused while it is newer than its sources.
``build_all`` starts one ``nvcc`` per source at once.

Every wrapper counts its launches in ``LAUNCHES``, under its kernel's own
name: one per kernel launch and nowhere else, so a run can show that its
path went through the kernels. B1 (``pair_layer``) has seven libraries:
``pair_layer_tf32x3`` (f32 on the tensor cores), ``pair_layer_tf32x3_f64``
and ``pair_layer_tf32x3_f256`` (the same source built at F = 64 and 256),
``pair_layer_mma`` (bf16_agg on the tensor cores), ``pair_layer_mma_f64``
and ``pair_layer_mma_f256`` (the same source at F = 64 and 256) and
``pair_layer`` (the f32-FMA kernels of both types, kept for timing); B2
(``pair_layer_cb``, chain_block > 1) has the same seven. B3
(``pair_tangent``) has seven: ``pair_tangent_mma`` (bf16_agg on the tensor
cores), ``pair_tangent_mma_f64`` and ``pair_tangent_mma_f256`` (the same
source at F = 64 and 256), ``pair_tangent_tf32x3`` (f32 on the tensor
cores), ``pair_tangent_tf32x3_f64`` and ``pair_tangent_tf32x3_f256`` (the
same source at F = 64 and 256) and ``pair_tangent`` (the f32-FMA kernel,
kept for timing). Every library but the four ``_f64`` and the four
``_f256`` ones is built at F = 128. B4
(``fused_edge_mlp``) has two: ``fused_edge_mlp_tf32x3`` (on the tensor
cores) and ``fused_edge_mlp`` (the f32-FMA kernel, kept for timing); B5
(``fused_edge_mlp_jvp``) has two: ``fused_edge_mlp_jvp_tf32x3`` (on the
tensor cores) and ``fused_edge_mlp_jvp`` (the f32-FMA kernel, kept for
timing); B6 (``fused_mlp``) has two: ``fused_mlp_tf32x3`` (on the tensor
cores) and ``fused_mlp`` (the f32-FMA kernel, kept for timing). B7
(``div_kernel``) has two: ``div_kernel_tf32x3`` (on the tensor
cores) and ``div_kernel`` (the f32-FMA kernel, kept for timing). ``ROUTES``
says which library a kernel's last launch came from,
and ``ROUTE_LAUNCHES`` counts the launches of each (kernel, library) pair,
so a run can show that all of a kernel's launches took one library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("pair_layer", "pair_layer_tf32x3", "pair_layer_tf32x3_f64", "pair_layer_tf32x3_f256",
           "pair_layer_mma", "pair_layer_mma_f64", "pair_layer_mma_f256", "pair_tangent",
           "pair_tangent_mma", "pair_tangent_mma_f64", "pair_tangent_mma_f256",
           "pair_tangent_tf32x3", "pair_tangent_tf32x3_f64", "pair_tangent_tf32x3_f256",
           "fused_edge_mlp", "fused_edge_mlp_tf32x3", "fused_edge_mlp_jvp",
           "fused_edge_mlp_jvp_tf32x3", "fused_mlp", "fused_mlp_tf32x3", "div_kernel",
           "div_kernel_tf32x3")
# libraries built from another library's source: name -> (source, nvcc defines);
# the source's C functions keep their names in each build
BUILT_FROM = {f"{src}_f{f}": (src, (f"-DPK_F={f}",))
              for src in ("pair_layer_mma", "pair_layer_tf32x3", "pair_tangent_mma",
                          "pair_tangent_tf32x3")
              for f in (64, 256)}


def source_of(name: str) -> str:
    """The source (and C function prefix) library ``name`` is built from."""
    return BUILT_FROM.get(name, (name, ()))[0]

LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "pair_layer", "pair_layer_cb", "pair_tangent", "fused_edge_mlp", "fused_edge_mlp_jvp",
    "fused_mlp", "div_kernel")}
ROUTES: Dict[str, str] = {}  # kernel name -> the library its last launch came from
ROUTE_LAUNCHES: Dict[Tuple[str, str], int] = {}  # (kernel name, library) -> launches
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def count_launch(kernel: str, library: str) -> None:
    """Record one launch of ``kernel`` from ``library``; wrappers with more
    than one library call it where they launch."""
    LAUNCHES[kernel] += 1
    ROUTES[kernel] = library
    ROUTE_LAUNCHES[kernel, library] = ROUTE_LAUNCHES.get((kernel, library), 0) + 1


def route_counts() -> Dict[str, int]:
    """The launches since the last ``reset_launches()`` as
    ``{"kernel:library": n}``, the libraries that launched only."""
    return {f"{k}:{lib}": n for (k, lib), n in ROUTE_LAUNCHES.items() if n}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def _command(name: str, out: Path) -> list:
    source, defines = BUILT_FROM.get(name, (name, ()))
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *defines,
        "-I", str(CSRC), "-o", str(out), str(CSRC / f"{source}.cu"),
    ]


def build_all(names=KERNELS, force: bool = False) -> Dict[str, dict]:
    """Compile the named kernels in parallel; returns, per kernel, the
    build seconds and what ``-Xptxas -v`` reported. Raises on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        procs[n] = (tmp, subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    report = {n: {"seconds": 0.0, "ptxas": "(up to date)"} for n in names}
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        report[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    if name not in _LIBS:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.pk_error_string.restype = ctypes.c_char_p
        lib.pk_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.pk_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
