"""The one blessed device-to-host copy point and its two taps.

``device_fetch`` is where the port copies a device tensor to the host on
purpose: a verify mask the host automaton must branch on, a warmup
result that forces the first launch, a tally read. Keeping every
deliberate copy behind one name makes the cost grep-able
(``grep -rn device_fetch hyperdrive_tpu_torch`` is the sync budget) and
gives observability one place to tap:

- the **observer** (``set_fetch_observer``) hears the ``why`` string of
  every fetch: an observed simulation journals each as a ``fetch.sync``
  event;
- the **probe** (``set_fetch_probe``) brackets the copy itself: the
  device-launch telemetry (:mod:`~hyperdrive_tpu_torch.obs.devtel`)
  installs it for one coalesced launch, so the launch's wall time splits
  into a sync share.

Port copy of three names of ``hyperdrive_tpu/analysis/annotations.py``
(``set_fetch_observer``, ``set_fetch_probe``, ``device_fetch``). The
lint markers (``hot_path``, ``async_scope``, ``drain_point``) and the
wire-codec registry (``wire_codec``, ``wire_entry``, the budgets) wait
for ROADMAP Queue A item 6, with the rest of ``analysis/``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_fetch", "set_fetch_observer", "set_fetch_probe"]

#: Optional callback invoked with the ``why`` string on every
#: device_fetch: the flight recorder's tap. Module global, not
#: thread-local: the simulator installs it for the duration of an
#: observed run and removes it in a finally.
_fetch_observer = None

#: Optional timing probe bracketing the copy itself: the device-telemetry
#: tap installs it for the duration of one coalesced launch so the
#: launch's wall time decomposes into a sync share.
_fetch_probe = None

#: True while either tap is installed: the untapped path pays one global
#: load and one check beyond the copy.
_tapped = False


def set_fetch_observer(cb) -> None:
    """Install (or, with None, remove) the device_fetch observer."""
    global _fetch_observer, _tapped
    _fetch_observer = cb
    _tapped = _fetch_observer is not None or _fetch_probe is not None


def set_fetch_probe(probe) -> None:
    """Install (or, with None, remove) the device_fetch timing probe: an
    object with ``fetch_begin(why)`` / ``fetch_end(why)`` hooks."""
    global _fetch_probe, _tapped
    _fetch_probe = probe
    _tapped = _fetch_observer is not None or _fetch_probe is not None


def device_fetch(x, *, why: str = ""):
    """THE annotated device-to-host copy.

    Returns ``x`` on the host as a numpy array: ``x.cpu().numpy()`` for a
    tensor (on the card this waits for the work that produces it),
    ``np.asarray(x)`` for anything else. ``why`` names the decision at the
    call site; the observer hears it, nothing interprets it.
    """
    if not _tapped:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    if _fetch_observer is not None:
        _fetch_observer(why)
    probe = _fetch_probe
    if probe is not None:
        probe.fetch_begin(why)
        try:
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().numpy()
            return np.asarray(x)
        finally:
            probe.fetch_end(why)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
