"""The JAX package's example drivers, on the port (``examples/`` there).

    python -m repro_torch.examples.quickstart [--backend multiverse]
    python -m repro_torch.examples.bakeoff [--seconds 1.0] [--quick]
    python -m repro_torch.examples.serve_snapshots [--steps 30]
    python -m repro_torch.examples.train_lm [--full] [--steps 100]

Each takes the reference's flags plus ``--device``: ``cuda`` by default,
which raises without a card; ``--device cpu`` runs the same code on the
CPU, with each kernel's plain PyTorch version.
"""
