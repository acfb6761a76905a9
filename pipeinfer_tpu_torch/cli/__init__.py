"""Command-line entry points: ``python -m pipeinfer_tpu_torch.cli.main``
and ``python -m pipeinfer_tpu_torch.cli.speculative``."""
