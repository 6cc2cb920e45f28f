"""Example programs of the port, each run as
``python -m supersonic_tpu_torch.examples.<name>``."""
