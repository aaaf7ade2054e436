"""Source annotations and the runtime consensus sanitizer of the port.

- :mod:`~hyperdrive_tpu_torch.analysis.annotations`: the device-fetch tap
  and the ``@wire_codec`` registry of frame families and byte budgets.
- :mod:`~hyperdrive_tpu_torch.analysis.sanitizer`: the runtime checks
  HDS001–HDS005 on the replicas' commit and broadcast seams, the tally
  flusher's device counts and every decode at a wire seam, armed by
  ``HD_SANITIZE``.

The reference's hdlint static checker (``engine``, ``rules``,
``wireflow``, ``__main__``) reads source and never runs on a device; it
is not ported yet (ROADMAP Queue A).
"""
