"""The port's attack campaigns against the JAX package's.

At ``tests/test_campaign.py``'s test scale (64 validators, committee 16):
the config's wire round trip and validation messages, the
``CampaignRecord`` bytes in both directions and its tamper rejection, and
every family's summary and digest, each held to the JAX run of the same
config with exact equality. The port's storm and coincidence engines
verify on ``device``; here ``device="cpu"`` gives the reference's
``HostVerifier``, and one storm wave runs through
``TorchBatchVerifier(device="cpu")`` (the plain ladder) to the same
digest.
"""

import dataclasses

import pytest
import torch

from hyperdrive_tpu.campaign import CampaignConfig as RefCampaignConfig
from hyperdrive_tpu.campaign.record import CampaignRecord as RefCampaignRecord
from hyperdrive_tpu.campaign.runner import run_campaign as ref_run_campaign
from hyperdrive_tpu.codec import SerdeError as RefSerdeError
from hyperdrive_tpu.codec import Writer as RefWriter
from hyperdrive_tpu.obs.metrics import Registry as RefRegistry
from hyperdrive_tpu.obs.recorder import Recorder as RefRecorder
from hyperdrive_tpu_torch import campaign
from hyperdrive_tpu_torch.campaign import FAMILIES, CampaignConfig
from hyperdrive_tpu_torch.campaign.families import batch_verifier
from hyperdrive_tpu_torch.campaign.record import CampaignRecord, summary_digest
from hyperdrive_tpu_torch.campaign.runner import replay_campaign, run_campaign
from hyperdrive_tpu_torch.codec import SerdeError, Writer
from hyperdrive_tpu_torch.obs.metrics import Registry
from hyperdrive_tpu_torch.obs.recorder import Recorder
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.verifier import HostVerifier

torch.set_num_threads(1)


def _zero():
    return 0.0

_BASE = dict(
    seed=7,
    validators=64,
    committee_size=16,
    epochs=4,
    epoch_length=2,
    attackers=4,
    waves=3,
    wave_votes=2,
    attack_rate=4,
    sybils=8,
    budget_milli=200,
    grind_width=2,
)


def _cfgs(family="storm", **kw):
    """The same config in both packages."""
    fields = dict(_BASE, family=family, **kw)
    return CampaignConfig(**fields), RefCampaignConfig(**fields)


def _marshal(rec, writer=Writer):
    w = writer(rem=1 << 20)
    rec.marshal(w)
    return w.data()


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("family", FAMILIES)
def test_config_ints_round_trip_and_equal_the_reference(family):
    cfg, ref = _cfgs(family, seed=11, reputation=(family != "capture"))
    assert cfg.as_ints() == ref.as_ints()
    assert CampaignConfig.from_ints(ref.as_ints()) == cfg
    # Trailing ints from a future config version are ignored, not fatal.
    assert CampaignConfig.from_ints(cfg.as_ints() + (99, 99)) == cfg
    assert cfg.with_family("capture").as_ints() == ref.with_family("capture").as_ints()


@pytest.mark.parametrize("bad", [
    dict(attackers=16),
    dict(sybils=40),
    dict(budget_milli=400),
    dict(family="meteor"),
    dict(validators=3),
    dict(committee_size=2),
    dict(epochs=0),
    dict(wave_votes=0),
    dict(grind_width=0),
])
def test_validation_messages_equal_the_reference(bad):
    cfg, ref = _cfgs(**bad)
    with pytest.raises(ValueError) as want:
        ref.validate()
    with pytest.raises(ValueError) as got:
        cfg.validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ints", [(0,) * 13, (7,) + (1,) * 13])
def test_from_ints_errors_equal_the_reference(ints):
    with pytest.raises(ValueError) as want:
        RefCampaignConfig.from_ints(ints)
    with pytest.raises(ValueError) as got:
        CampaignConfig.from_ints(ints)
    assert str(got.value) == str(want.value)


def test_lazy_exports_resolve_to_the_runner():
    assert campaign.run_campaign is run_campaign
    assert campaign.CampaignRecord is CampaignRecord
    with pytest.raises(AttributeError):
        campaign.meteor


# ------------------------------------------------------------------ record


def test_record_bytes_equal_the_reference_and_cross_load(tmp_path):
    summary = {"family": "storm", "waves": [{"wave": 0, "failed_rows": 3}],
               "gate": {"shed": {"reputation": 2}}}
    cfg, ref_cfg = _cfgs()
    rec = CampaignRecord.capture(cfg, summary)
    ref = RefCampaignRecord.capture(ref_cfg, summary)
    assert rec.digest == ref.digest == summary_digest(summary)
    blob = _marshal(rec)
    assert blob == _marshal(ref, RefWriter)
    assert CampaignRecord.load(blob) == rec
    assert RefCampaignRecord.load(blob) == ref
    path = tmp_path / "storm.bin"
    rec.dump(str(path))
    assert path.read_bytes() == blob
    assert CampaignRecord.load_file(str(path)) == rec


@pytest.mark.parametrize("tamper", ["summary", "magic", "version", "family"])
def test_tampered_record_raises_as_the_reference(tamper):
    cfg, _ = _cfgs()
    blob = bytearray(_marshal(CampaignRecord.capture(cfg, {"family": "storm", "n": 1})))
    if tamper == "summary":
        blob[-2] ^= 0x01  # inside the JSON tail: the digest check fires
    elif tamper == "magic":
        blob[0] ^= 0x01
    elif tamper == "version":
        blob[4] = 9
    else:
        blob[8] = 9  # the family index, first int of the trailer
    with pytest.raises((RefSerdeError, ValueError)) as want:
        RefCampaignRecord.load(bytes(blob))
    with pytest.raises((SerdeError, ValueError)) as got:
        CampaignRecord.load(bytes(blob))
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- families


@pytest.mark.parametrize("family,kw", [
    ("storm", {}),
    ("storm", dict(reputation=False)),
    ("capture", {}),
    ("coincidence", {}),
    ("capture", dict(seed=2)),
])
def test_family_summary_and_digest_equal_the_reference(family, kw):
    # Observed in both packages: the recorder's journal (every campaign.*
    # and admission.* event) and the registry's counters are the JAX
    # run's too, and observing never feeds the summary.
    cfg, ref_cfg = _cfgs(family, **kw)
    rec, ref_rec = Recorder(time_fn=_zero), RefRecorder(time_fn=_zero)
    reg, ref_reg = Registry(time_fn=_zero), RefRegistry(time_fn=_zero)
    out = run_campaign(cfg, device="cpu", registry=reg, obs=rec.scoped(-1))
    want = ref_run_campaign(ref_cfg, registry=ref_reg, obs=ref_rec.scoped(-1))
    assert out.summary == want.summary
    assert out.digest == want.digest
    assert out.violations == want.violations == []
    assert _marshal(out.record) == _marshal(want.record, RefWriter)
    assert rec.snapshot() == ref_rec.snapshot() and rec.digest() == ref_rec.digest()
    assert reg.snapshot() == ref_reg.snapshot() and reg.digest() == ref_reg.digest()
    kinds = {e.kind for e in rec.snapshot()}
    assert {"campaign.family", "campaign.done"} <= kinds
    assert reg.snapshot()["counters"]["campaign.runs"] == {family: 1}


@pytest.mark.parametrize("family", FAMILIES)
def test_replay_is_digest_identical(family, tmp_path):
    cfg, _ = _cfgs(family)
    out = run_campaign(cfg, device="cpu")
    path = tmp_path / (family + ".bin")
    out.record.dump(str(path))
    rec = Recorder(time_fn=_zero)
    same, fresh = replay_campaign(CampaignRecord.load_file(str(path), obs=rec.scoped(-1)),
                                  device="cpu", obs=rec.scoped(-1))
    assert same and fresh.summary == out.summary
    done = [e for e in rec.snapshot() if e.kind == "campaign.done"]
    assert [e.detail for e in done] == [f"{family} {out.digest[:8].hex()} violations=0"]


def test_storm_wave_on_the_plain_ladder_equals_the_reference():
    """One wave through ``TorchBatchVerifier`` on the CPU (the plain
    ladder): the same summary as the JAX run's ``HostVerifier``; the
    plain version counts no kernel launch."""
    cfg, ref_cfg = _cfgs("storm", waves=1)
    ed25519_cuda.reset_stats()
    out = run_campaign(cfg, verifier=TorchBatchVerifier(device="cpu"))
    assert ed25519_cuda.stats["ed25519_verify"].launches == 0
    want = ref_run_campaign(ref_cfg)
    assert out.summary == want.summary and out.digest == want.digest
    assert out.summary["waves"][0]["failed_rows"] > 0


def test_device_choice_and_dropped_hooks():
    assert isinstance(batch_verifier("cpu"), HostVerifier)
    cfg, _ = _cfgs("capture")
    # Capture verifies nothing, so it builds no verifier on any device;
    # the registry and obs hooks (refused until ROADMAP item 4b) run on it.
    reg, rec = Registry(time_fn=_zero), Recorder(time_fn=_zero)
    assert run_campaign(cfg, registry=reg, obs=rec.scoped(-1)).ok
    counters = reg.snapshot()["counters"]
    assert counters["campaign.runs"] == {"capture": 1}
    assert counters["campaign.epochs"] == _BASE["epochs"]
    assert [e.detail for e in rec.snapshot()][0] == "capture"
    storm, _ = _cfgs("storm")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_campaign(storm)
    bad = dataclasses.replace(storm, attackers=16)
    with pytest.raises(ValueError, match="honest signer"):
        run_campaign(bad, device="cpu")
