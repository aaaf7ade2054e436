"""Host utilities of the port: crash-restart checkpoints
(:mod:`~hyperdrive_tpu_torch.utils.checkpoint`)."""
