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
    yield ROOT / "chip_smoke_parallel.py"
    yield ROOT / "chip_smoke_cli.py"
    yield ROOT / "chip_smoke_studies.py"
    yield ROOT / "chip_smoke_validate.py"
    yield ROOT / "chip_smoke_b3_f256.py"
    yield ROOT / "chip_smoke_f64.py"


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
            "ti_torch.analysis.reweight", "ti_torch.analysis.sort_atoms",
            "ti_torch.analysis.zmatrix", "ti_torch.analysis.results",
            "ti_torch.analysis.kinetics", "ti_torch.analysis.plots",
            "ti_torch.analysis.energy", "ti_torch.data.eval_dataset",
            "ti_torch.gedmd.symbolic", "ti_torch.parallel", "ti_torch.parallel.mesh",
            "ti_torch.parallel.fanout", "ti_torch.parallel.collectives",
            "ti_torch.parallel.launch", "ti_torch.cli.mdqm9_train_ambient",
            "ti_torch.cli.mdqm9_sample_ambient", "ti_torch.cli.merge_shards",
            "ti_torch.cli.fanout_driver", "ti_torch.utils.timing", "ti_torch.utils.profiling",
            "ti_torch.utils.torch_import", "ti_torch.cli.profile_summary",
            "ti_torch.cli.mdqm9_train_latent", "ti_torch.cli.mdqm9_sample_latent",
            "ti_torch.cli.mdqm9_sample_sde", "ti_torch.cli.mdqm9_results",
            "ti_torch.cli.mdqm9_plots", "ti_torch.cli.mdqm9_gedmd", "ti_torch.cli.adw_train",
            "ti_torch.cli.adw_sample", "ti_torch.cli.adw_reweight_gedmd",
            "ti_torch.cli.model_selection", "ti_torch.cli.eval_energy",
            "ti_torch.cli.adw_plots", "ti_torch.cli.step_count_study",
            "ti_torch.cli.adw_f64_study", "ti_torch.cli.probe_mode_study",
            "ti_torch.cli.sde_scan", "ti_torch.cli.large_scale_scan",
            "ti_torch.cli.profile_divergence"} <= set(mods)


def test_analysis_imports_without_its_optional_libraries():
    """The card's machine has no sympy, matplotlib, h5py or OpenMM: the
    analysis layer, the gEDMD package and the eval dataset import without
    them (each is imported where it is used), and the parts that need none
    run."""
    code = (
        "import sys\n"
        "for m in ('jax', 'ti_tpu', 'sympy', 'matplotlib', 'h5py', 'openmm'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import ti_torch.analysis as a, ti_torch.gedmd, ti_torch.data.eval_dataset\n"
        "from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule\n"
        "mol = make_synthetic_molecule(7)\n"
        "adj = a.adjacency_from_bonds(mol.n_atoms, mol.bond_index)\n"
        "r = a.generate_report(adj, make_synthetic_frames(mol, 8, 300), device='cpu')\n"
        "assert r['torsions'].shape == (8, 4) and not a.openmm_available()\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_source_imports_jax_or_ti_tpu():
    assert {ROOT / "tools" / name for name in (
        "torch_ambient_oracle.py", "torch_latent_oracle.py", "latent_memory_probe.py",
        "torch_adw_oracle.py")} | {ROOT / "ti_torch" / "cli" / "mdqm9_sample_sde.py",
                                   ROOT / "ti_torch" / "utils" / "torch_import.py",
                                   ROOT / "chip_smoke_cli.py",
                                   ROOT / "chip_smoke_studies.py",
                                   ROOT / "chip_smoke_validate.py",
                                   ROOT / "chip_smoke_b3_f256.py",
                                   ROOT / "chip_smoke_f64.py",
                                   ROOT / "ti_torch" / "analysis" / "oracles.py"} | {
        ROOT / "ti_torch" / "cli" / f"validate_{name}_physics.py"
        for name in ("mdqm9", "latent", "bg_ti")} <= set(_port_sources())
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
