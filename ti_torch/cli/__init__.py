"""Command-line entry points of the port, each run as ``python -m
ti_torch.cli.<name>`` from the repository root, with a ``main(argv)`` the
tests call in-process (ports of the scripts of the same names in
``scripts/``).

On the card unless given ``--device cpu`` (with no card and no
``--device`` they raise): the MDQM9 ambient and latent trainers and
samplers (``mdqm9_{train,sample}_{ambient,latent}``), the SDE sampler
(``mdqm9_sample_sde``), the results report (``mdqm9_results``: its
z-matrices), the ADW trainer and sampler (``adw_train``,
``adw_sample``) and the studies: ``step_count_study`` (RK4 against
dopri5@1e-5), ``adw_f64_study`` (ADW in f32 against f64),
``probe_mode_study`` (Hutchinson probe modes against the exact trace),
``sde_scan`` and ``large_scale_scan`` (SDE and 10506-profile throughput
over chains, dtypes and kernel routes) and ``profile_divergence`` (the
forward and one divergence node, unfused against fused). On the host, as
in ``scripts/``, with no ``--device``: the figures (``mdqm9_plots``,
``adw_plots``: matplotlib), the kinetics and model selection
(``mdqm9_gedmd``, ``model_selection``, ``adw_reweight_gedmd``: the gEDMD
eigensolves are float64 numpy), the OpenMM energy stage (``eval_energy``),
the trace summary (``profile_summary``), the shard merge
(``merge_shards``) and the local fan-out driver (``fanout_driver``)."""
