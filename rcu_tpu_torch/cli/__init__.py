"""Command-line entry points (``python -m rcu_tpu_torch.cli.<name>``)."""
