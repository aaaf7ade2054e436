"""Source annotations of the port: for now only the device-fetch tap
(:mod:`~hyperdrive_tpu_torch.analysis.annotations`). The reference's lint
engine, rules, sanitizer and wire-flow checker wait for ROADMAP Queue A
item 6."""
