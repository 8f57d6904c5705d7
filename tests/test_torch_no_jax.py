"""The PyTorch port stands alone: ``ti_torch``, its measurement scripts in
``tools/`` and ``chip_smoke.py`` import neither ``jax`` nor ``ti_tpu``."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import ti_torch

ROOT = Path(__file__).resolve().parents[1]


def _port_sources():
    yield from sorted((ROOT / "ti_torch").rglob("*.py"))
    yield from sorted((ROOT / "tools").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


def test_imports_with_jax_blocked():
    mods = ["ti_torch"] + [m.name for m in pkgutil.walk_packages(ti_torch.__path__, "ti_torch.")]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ti_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert len(mods) >= 17
    assert {"ti_torch.ops.pallas_kernels", "ti_torch.models.cpainn_fused",
            "ti_torch.ops.div_kernel", "ti_torch.ops.dense_divergence",
            "ti_torch.interpolants", "ti_torch.losses", "ti_torch.train.common",
            "ti_torch.train.ambient", "ti_torch.utils.logging", "ti_torch.ops.kabsch",
            "ti_torch.train.latent", "ti_torch.analysis.potentials", "ti_torch.models.mlp",
            "ti_torch.models.convert", "ti_torch.data.adw", "ti_torch.train.adw",
            "ti_torch.sampling.drivers", "ti_torch.gedmd", "ti_torch.gedmd.rff",
            "ti_torch.analysis.reweight"} <= set(mods)


def test_no_source_imports_jax_or_ti_tpu():
    assert {ROOT / "tools" / name for name in (
        "torch_ambient_oracle.py", "torch_latent_oracle.py", "latent_memory_probe.py",
        "torch_adw_oracle.py")} <= set(
        _port_sources())
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "ti_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
