"""Potential-energy evaluation stage (OpenMM, gated; a copy of
ti_tpu/analysis/energy.py).

The reference evaluates GAFF-2 energies with OpenMM + openff in a SEPARATE
conda environment (mdqm9/analysis/eval_energy.py:18-25 — 'make sure to use
the designated environment', ti_energy_env.yml), writing E0s_*/E1s_*.npy
artifacts consumed by the results pipelines. We keep exactly that
decoupling: this module is the host-side CPU stage, it is import-gated on
OpenMM (not present on the card's machine), and it reads/writes the same
artifact shapes. Reduced energies are E / (kB T) like the reference
(eval_energy.py:44-53).
"""

from __future__ import annotations

import numpy as np

KB_KJ_PER_MOL_K = 0.008314462618


def reduced_energies(energies_kj_per_mol: np.ndarray, T: float) -> np.ndarray:
    """E / (kB T) — dimensionless reduced energies."""
    return np.asarray(energies_kj_per_mol) / (KB_KJ_PER_MOL_K * T)


def openmm_available() -> bool:
    try:
        import openmm  # noqa: F401

        return True
    except ImportError:
        return False


def eval_energy_openmm(
    mol_sdf_path: str,
    mol_index: int,
    partial_charges: np.ndarray,
    conformations: np.ndarray,
    T: float,
    forcefield_xml: str = "amber/protein.ff14SB.xml",
) -> np.ndarray:
    """Reduced GAFF-2 energies of conformations (n, N, 3) at temperature T.

    Mirrors reference eval_energy (mdqm9/analysis/eval_energy.py:28-53):
    GAFF-2.11 template from openff, ff14SB base, Langevin context, one
    energy per conformation. Requires the dedicated OpenMM environment —
    raises ImportError with instructions otherwise.
    """
    try:
        import openmm
        import openmm.app as app
        import openmm.unit as unit
        from openff.toolkit.topology import Molecule as OFFMolecule
        from openmmforcefields.generators import GAFFTemplateGenerator
    except ImportError as e:  # pragma: no cover - not in the main environment
        raise ImportError(
            "OpenMM/openff stack not available. Energy evaluation is a "
            "separate CPU stage (as in the reference, ti_energy_env.yml); "
            "run it in the dedicated environment and pass the resulting "
            "E0s_*.npy / E1s_*.npy artifacts to the results pipeline."
        ) from e

    from rdkit import Chem  # the energy env ships rdkit

    suppl = Chem.SDMolSupplier(mol_sdf_path, removeHs=False, sanitize=True)
    rdmol = suppl[mol_index]
    offmol = OFFMolecule.from_rdkit(rdmol, allow_undefined_stereo=True)
    offmol.partial_charges = np.asarray(partial_charges) * unit.elementary_charge

    gaff = GAFFTemplateGenerator(molecules=offmol, forcefield="gaff-2.11")
    ff = app.ForceField(forcefield_xml)
    ff.registerTemplateGenerator(gaff.generator)

    topology = offmol.to_topology().to_openmm()
    system = ff.createSystem(topology)
    integrator = openmm.LangevinIntegrator(
        T * unit.kelvin, 1.0 / unit.picosecond, 2.0 * unit.femtosecond
    )
    context = openmm.Context(system, integrator)

    energies = np.empty(len(conformations))
    for i, x in enumerate(np.asarray(conformations)):
        context.setPositions(x * unit.nanometer)
        state = context.getState(getEnergy=True)
        energies[i] = state.getPotentialEnergy().value_in_unit(unit.kilojoule_per_mole)
    return reduced_energies(energies, T)


def save_energy_artifacts(out_dir: str, tag: str, E0s: np.ndarray, E1s: np.ndarray) -> None:
    """Write the E0s_*/E1s_* artifacts the results pipelines consume
    (reference eval_energy.py:86-87)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"E0s_{tag}.npy"), E0s)
    np.save(os.path.join(out_dir, f"E1s_{tag}.npy"), E1s)
