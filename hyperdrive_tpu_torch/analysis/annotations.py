"""The one blessed device-to-host copy point, its two taps, and the wire
registry.

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

The **wire registry** is the runtime half of the reference's
``@wire_codec`` doctrine: every encoder or decoder of bytes a Byzantine
peer can author registers under a frame-family ``tag`` with a declared
``max_bytes`` decode budget (``wire_codec``, or ``declare_wire_budget``
for an object-frame seam with no byte codec). The HDS005 budget reader
of :mod:`~hyperdrive_tpu_torch.analysis.sanitizer` charges every decode
at a wire seam against it (``wire_budget_for``).

Port copy of ``hyperdrive_tpu/analysis/annotations.py``: the fetch taps
(``set_fetch_observer``, ``set_fetch_probe``, ``device_fetch``) and the
wire registry (``WireCodecSpec``, ``wire_codec``, ``declare_wire_budget``,
``wire_budget_for``, ``WIRE_CODECS``, ``WIRE_BUDGETS``), with the
reference's tags, budgets and versions. Dropped: the markers only the
hdlint static checker reads (``hot_path``, ``async_scope``,
``drain_point``, ``wire_entry``). The module imports no torch: a tensor
can only reach ``device_fetch`` once torch is loaded, so the registry
costs the codec modules nothing at import.
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = [
    "device_fetch",
    "set_fetch_observer",
    "set_fetch_probe",
    "wire_codec",
    "declare_wire_budget",
    "wire_budget_for",
    "WIRE_CODECS",
    "WIRE_BUDGETS",
    "WireCodecSpec",
]

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


def _to_host(x):
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_fetch(x, *, why: str = ""):
    """THE annotated device-to-host copy.

    Returns ``x`` on the host as a numpy array: ``x.cpu().numpy()`` for a
    tensor (on the card this waits for the work that produces it),
    ``np.asarray(x)`` for anything else. ``why`` names the decision at the
    call site; the observer hears it, nothing interprets it.
    """
    if not _tapped:
        return _to_host(x)
    if _fetch_observer is not None:
        _fetch_observer(why)
    probe = _fetch_probe
    if probe is not None:
        probe.fetch_begin(why)
        try:
            return _to_host(x)
        finally:
            probe.fetch_end(why)
    return _to_host(x)


class WireCodecSpec:
    """One registered codec endpoint: ``tag`` names the frame family,
    ``max_bytes`` is its per-frame decode byte budget, ``role`` is
    ``encode`` / ``decode`` / ``both`` (a class carrying a
    marshal/unmarshal pair registers once as ``both``)."""

    __slots__ = ("tag", "max_bytes", "version", "role", "name", "module")

    def __init__(self, tag, max_bytes, version, role, name, module):
        self.tag = tag
        self.max_bytes = max_bytes
        self.version = version
        self.role = role
        self.name = name
        self.module = module

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"WireCodecSpec(tag={self.tag!r}, role={self.role!r}, "
                f"max_bytes={self.max_bytes}, v{self.version}, "
                f"{self.module}.{self.name})")


#: tag -> list[WireCodecSpec], filled at import time by ``wire_codec``.
#: Read by the HDS005 budget reader (budget lookup by tag) and by the
#: wire-audit tests (closure against the reference's registry).
WIRE_CODECS: dict = {}

#: tag -> max_bytes for budget-only entries: object-frame seams with no
#: byte codec of their own (the overlay's partial-aggregate frames, whose
#: wire size is estimated and charged at ingress).
WIRE_BUDGETS: dict = {}

_ENCODE_PREFIXES = ("encode", "marshal")
_DECODE_PREFIXES = ("decode", "unmarshal")


def _infer_role(obj) -> str:
    if isinstance(obj, type):
        return "both"
    leaf = getattr(obj, "__name__", "").lstrip("_")
    if any(leaf.startswith(p) for p in _DECODE_PREFIXES):
        return "decode"
    if any(leaf.startswith(p) for p in _ENCODE_PREFIXES):
        return "encode"
    return "both"


def wire_codec(*, tag: str, max_bytes: int, version: int = 1,
               role: str = None):
    """Register a wire codec endpoint under the frame family ``tag``.

    Apply to an ``encode_*`` / ``marshal_*`` function, its matching
    ``decode_*`` / ``unmarshal_*``, or once to a class that carries the
    ``marshal``/``unmarshal`` pair. ``max_bytes`` is the decode byte
    budget HDS005 enforces per frame of this family; ``role`` is inferred
    from the name when omitted. Returns the object unchanged apart from
    an ``__hd_wire_codec__`` attribute.
    """
    if max_bytes <= 0:
        raise ValueError(f"wire_codec max_bytes must be positive: {max_bytes}")

    def deco(obj):
        spec = WireCodecSpec(
            tag=str(tag),
            max_bytes=int(max_bytes),
            version=int(version),
            role=role if role is not None else _infer_role(obj),
            name=getattr(obj, "__name__", "?"),
            module=getattr(obj, "__module__", "?"),
        )
        try:
            obj.__hd_wire_codec__ = spec
        except (AttributeError, TypeError):  # slotted callables
            pass
        WIRE_CODECS.setdefault(spec.tag, []).append(spec)
        return obj

    return deco


def declare_wire_budget(tag: str, max_bytes: int) -> None:
    """Declare a decode budget for a frame family with no byte codec of
    its own (object-frame seams: the ingress handler estimates the wire
    size and charges it with the sanitizer's ``wire_charge``)."""
    if max_bytes <= 0:
        raise ValueError(f"wire budget must be positive: {max_bytes}")
    WIRE_BUDGETS[str(tag)] = int(max_bytes)


def wire_budget_for(tag: str):
    """The declared ``max_bytes`` for ``tag`` (codec registrations win
    over budget-only declarations; a tag's tightest registration counts),
    or None when the tag is unknown."""
    specs = WIRE_CODECS.get(tag)
    if specs:
        return min(s.max_bytes for s in specs)
    return WIRE_BUDGETS.get(tag)
