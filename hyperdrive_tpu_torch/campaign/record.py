"""CampaignRecord: the replayable dump of one attack campaign.

Port copy of the JAX package's ``campaign/record.py``; the file format is
byte for byte the same. Same contract as the harness ScenarioRecord: the
record carries the full :class:`~hyperdrive_tpu_torch.campaign.
CampaignConfig` (as its u64 trailer), the outcome digest the live run
produced, and the canonical summary blob: everything
:func:`~hyperdrive_tpu_torch.campaign.runner.replay_campaign` needs to
re-derive the identical trajectory and prove it.

The record registers as the ``campaign.record`` wire family (1 MiB), and
:meth:`CampaignRecord.load` reads through the sanitizer's budget reader
(``maybe_wire_reader``), as the reference does: under ``HD_SANITIZE`` a
decode past the budget raises HDS005 and emits
``wire.budget.exceeded`` on ``load(obs=)``'s recorder; otherwise a plain
``Reader`` with the same 1 MiB budget. Dropped: the ``wire_entry`` lint
marker.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.analysis.sanitizer import maybe_wire_reader
from hyperdrive_tpu_torch.campaign import CampaignConfig
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer

__all__ = ["CampaignRecord", "summary_digest", "MAGIC", "VERSION"]

#: "HYDC" — distinct from ScenarioRecord's magic so a mixed-up file
#: fails loudly at the first u32, not at trailer parse.
MAGIC = 0x48594443
VERSION = 1

_MAX_RECORD = 1 << 20


def _canonical(summary: dict) -> bytes:
    return json.dumps(summary, sort_keys=True, separators=(",", ":")).encode()


def summary_digest(summary: dict) -> bytes:
    """Digest of a campaign summary: sha256 of its canonical JSON.

    Canonical = sorted keys, no whitespace — the same dict always maps
    to the same bytes, so live-vs-replay digest equality is exactly
    trajectory equality (seat trajectories, shed counts, reputation
    state, per-epoch roots all live in the summary).
    """
    return hashlib.sha256(_canonical(summary)).digest()


@wire_codec(tag="campaign.record", max_bytes=_MAX_RECORD)
@dataclass(frozen=True)
class CampaignRecord:
    config: CampaignConfig
    digest: bytes
    summary: dict

    # -- wire ---------------------------------------------------------

    def marshal(self, w: Writer) -> None:
        w.u32(MAGIC)
        w.u16(VERSION)
        ints = self.config.as_ints()
        w.u16(len(ints))
        for v in ints:
            w.u64(int(v))
        w.bytes32(self.digest)
        w.raw(_canonical(self.summary))

    @classmethod
    def unmarshal(cls, r: Reader) -> "CampaignRecord":
        if r.u32() != MAGIC:
            raise SerdeError("not a campaign record (bad magic)")
        version = r.u16()
        if version != VERSION:
            raise SerdeError(f"unsupported campaign record v{version}")
        n = r.u16()
        ints = tuple(r.u64() for _ in range(n))
        config = CampaignConfig.from_ints(ints)
        digest = r.bytes32()
        summary = json.loads(r.raw().decode())
        if not isinstance(summary, dict):
            raise SerdeError("campaign summary must be a JSON object")
        rec = cls(config=config, digest=digest, summary=summary)
        if summary_digest(summary) != digest:
            raise SerdeError(
                "campaign record digest does not match its summary"
            )
        return rec

    # -- files --------------------------------------------------------

    def dump(self, path) -> None:
        w = Writer(rem=_MAX_RECORD)
        self.marshal(w)
        with open(path, "wb") as f:
            f.write(w.data())

    @classmethod
    def load(cls, payload: bytes, *, obs=None) -> "CampaignRecord":
        r = maybe_wire_reader(
            "campaign.record", payload, obs=obs, rem=_MAX_RECORD
        )
        return cls.unmarshal(r)

    @classmethod
    def load_file(cls, path, *, obs=None) -> "CampaignRecord":
        with open(path, "rb") as f:
            payload = f.read()
        return cls.load(payload, obs=obs)

    # -- convenience --------------------------------------------------

    @classmethod
    def capture(
        cls, config: CampaignConfig, summary: dict
    ) -> "CampaignRecord":
        return cls(
            config=config,
            digest=summary_digest(summary),
            summary=summary,
        )
