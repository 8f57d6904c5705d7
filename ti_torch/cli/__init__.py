"""Command-line entry points of the port, each run as ``python -m
ti_torch.cli.<name>`` from the repository root, with a ``main(argv)`` the
tests call in-process: the MDQM9 ambient trainer and sampler, the merge of
sharded sampling artifacts and the local fan-out driver (ports of the
scripts of the same names in ``scripts/``)."""
