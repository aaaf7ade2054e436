"""Host utilities of the port: crash-restart checkpoints
(:mod:`~hyperdrive_tpu_torch.utils.checkpoint`) and the tracer with its
profiler hook (:mod:`~hyperdrive_tpu_torch.utils.trace`)."""
