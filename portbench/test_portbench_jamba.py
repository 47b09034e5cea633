"""The Jamba2-Mini cell (`kinds/lm_embed.py`) on the CPU at its test size:
faults of the model planted under the timed path fail the check; the
frozen costs are pinned; each of the cell's five readers on records
built by hand. The cell's sound, control and session faults run in
`test_portbench_checks.py` with the other cells."""

import math
from pathlib import Path

import pytest
import torch

from portbench import costs, costs_jamba, harness

ROOT = Path(__file__).resolve().parents[1]
CELL = "jamba2-mini-yelp.reviews32"
SEED = 3_000_000_061


def _cell():
    r = harness.resolve(harness.load_spec(ROOT), CELL, ROOT)
    r["config"] = dict(r["config"], n=4096)
    return r


def _no_lengths(orig):
    def embed(self, params, batch):  # pooled over padding as well
        return orig(self, params, {"tokens": batch["tokens"].clamp_min(0)})
    return embed


def _longest_zeroed(orig):
    def embed(self, params, batch):  # each step's longest review zeroed
        e = orig(self, params, batch).clone()
        e[int(torch.argmax(batch["lengths"]))] = 0.0
        return e
    return embed


@pytest.mark.parametrize("fault", ["pooled_over_padding", "rope_on",
                                   "one_review_zeroed"])
def test_a_model_fault_under_the_timed_path_fails_the_check(fault,
                                                            monkeypatch):
    from repro_torch.models.model import Model

    r = _cell()
    kind = harness.kind(r["config"], ROOT)
    if fault == "pooled_over_padding":
        monkeypatch.setattr(Model, "embed", _no_lengths(Model.embed))
    elif fault == "one_review_zeroed":
        # the longest review: the one the check samples in every run
        monkeypatch.setattr(Model, "embed", _longest_zeroed(Model.embed))
    else:
        orig = kind.port_config
        monkeypatch.setattr(kind, "port_config",
                            lambda sizes: orig(sizes).replace(rope=True))
    out = harness.run_cell(r, SEED, 0.3, False, device="cpu")
    assert not out["line"]["correct"], out["line"]["checks"]


def test_the_frozen_costs_are_pinned():
    assert costs_jamba.flops_per_token() == 5_783_945_216.0
    assert costs_jamba.expert_flops_per_pair() == 352_321_536.0
    assert costs_jamba.routed_pairs(6400) == 6400 * 2 * 4
    assert costs_jamba.period_flops(1, 2) == 5_783_945_216.0 + 2 * 4096 * 2
    sc = costs_jamba.scan_cost(6400)
    assert sc.ops == 6 * 6400 * 8192 * 16 * 7
    assert sc.bytes == 6400 * (6 * 8192 + 8 * 16 + 2 * 8192) * 7
    assert sc.bound_by() == "operations"
    assert sc.bound_ms() == pytest.approx(1.0517060776)
    assert costs_jamba.period_bound_ms(6400) == pytest.approx(
        1e3 * 6400 * 5_783_945_216.0 / costs.BF16_FLOP_PER_S)


def _span(device_s):
    return {"count": 1, "host_s": 0.0, "self_s": 0.0, "device_s": device_s,
            "idle_s": 0.0, "blocking": {}, "ops": {}}


RECORDS = {
    "steps": 4, "window_s": 2.0, "window_tokens": 25_600.0,
    "window_pairs": 0.0,
    "spans": {"embed.forward": _span(0.1), "embed.pool": _span(0.01),
              "lm.attn": _span(0.05), "lm.mamba": _span(0.1),
              "lm.scan": _span(0.02), "lm.mlp": _span(0.1),
              "lm.moe": _span(0.4), "session.update": _span(0.03),
              "step.rank": _span(0.04)},
    "counters": {"lm.tokens": 25_600, "lm.positions": 80_000,
                 "lm.routed": [12_800] * 16},
}


def test_the_five_readers_on_hand_built_records():
    def read(name, rec=RECORDS):
        return harness.reader(name, ROOT)(rec)

    # every embed.* and lm.* span, nothing else: 0.78 s over 4 steps
    assert read("embed.ms") == pytest.approx(195.0)
    scan_ms = costs_jamba.scan_cost(25_600).bound_ms()
    assert read("scan.roofline") == pytest.approx(100 * scan_ms / 20.0)
    # 25,600 tokens, each to 2 experts in each of 4 MoE layers
    assert read("moe.mfu") == pytest.approx(
        100 * 352_321_536.0 * 204_800 / 0.4 / costs.BF16_FLOP_PER_S)
    assert read("mfu.jamba_step") == pytest.approx(
        100 * costs_jamba.period_bound_ms(25_600) / 2000.0)
    assert read("embed.pad_share") == pytest.approx(68.0)
    for name in ("embed.ms", "scan.roofline", "moe.mfu", "mfu.jamba_step",
                 "embed.pad_share"):
        assert read(name, {"steps": 4, "window_s": 2.0}) is None
        assert math.isfinite(read(name))
