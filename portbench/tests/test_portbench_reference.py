"""``correct`` on the CPU at a small size: the reference agrees with the
port, a lower-precision run of the port fails the comparison, and so does
each fault a cell can have, planted under a run that goes through the
harness (all but its look for a card)."""

import pytest
import torch

from defslam_tpu_torch.tracking import tracker
from portbench import bench
from portbench.tests.conftest import SEED

# compared exactly with the float32 reference; the others are the
# solvers' numbers against the float64 judge, and the ground truth's
EXACT = ("init", "features", "match", "commit")


def _run(cell, tiny, seconds=6.0, **kw):
    out, samples = bench.run_cell(cell, SEED, seconds, False, **tiny, **kw)
    return out, samples


def _values(out):
    return {k: v["value"] for k, v in out["compared"].items()}


@pytest.mark.parametrize("cell", ["stereo0_stream", "rigid_stream", "stereo0_localize"])
def test_reference_agrees_with_the_port(cell, tiny):
    """The exact numbers read 0, and the solvers' numbers sit under the
    cell's limits (the ground truth's are the full-size cell's, and not
    held here)."""
    out, samples = _run(cell, tiny)
    exact = {k: v for k, v in _values(out).items() if k in EXACT}
    assert exact and all(v == 0.0 for v in exact.values()), exact
    judged = {k: n for k, n in out["compared"].items() if k not in EXACT + ("ate",)}
    assert judged and all(n["value"] <= n["limit"] for n in judged.values()), judged
    counts = {k: samples["checked"].get(k + "_n") for k in out["compared"]}
    assert all(n is None or n > 0 for n in counts.values()), counts


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def test_a_bfloat16_sft_fails(tiny, monkeypatch):
    """The port's SfT answer rounded to bfloat16, the precision below the
    configuration's float32: the comparison must fail."""
    orig = tracker.sft_track

    def low(*a, **k):
        res = orig(*a, **k)
        return res._replace(T=_bf16(res.T), nodes=_bf16(res.nodes))

    monkeypatch.setattr(tracker, "sft_track", low)
    out, _ = _run("stereo0_stream", tiny)
    assert not out["correct"]
    assert out["compared"]["sft"]["value"] > out["compared"]["sft"]["limit"]


def _unchanged(orig):
    def call(points, matches, feats, tmpl, pose0, K, cfg, reg_temp=None):
        res = orig(points, matches, feats, tmpl, pose0, K, cfg, reg_temp=reg_temp)
        return res._replace(T=pose0, nodes=tmpl.nodes)
    return call


def _half_batch(orig):
    def call(points, matches, feats, tmpl, pose0, K, cfg, reg_temp=None):
        kp = matches.kp_of_point.clone()
        kp[1::2] = -1
        return orig(points, matches._replace(kp_of_point=kp), feats, tmpl, pose0, K, cfg,
                    reg_temp=reg_temp)
    return call


def _altered(orig):
    def call(*a, **k):
        res = orig(*a, **k)
        T = res.T.clone()
        T[0, 3] += 1e-2
        return res._replace(T=T)
    return call


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_in_the_timed_path_fails(fault, tiny, monkeypatch):
    monkeypatch.setattr(tracker, "sft_track", fault(tracker.sft_track))
    out, _ = _run("stereo0_stream", tiny)
    assert not out["correct"], out["compared"]


@pytest.mark.cuda
def test_on_the_card_the_reference_agrees_and_the_tf32_control_fails(card, tiny):
    """The control at a size a test holds: the program with TF32 allowed
    (the precision below the configuration's float32) against the
    references.  The sound run beside it is correct, its exact numbers 0."""
    kw = {k: v for k, v in tiny.items() if k != "device"}
    sound, _ = bench.run_cell("stereo0_stream", SEED, 6.0, False, **kw)
    exact = {k: v for k, v in _values(sound).items() if k in EXACT}
    assert all(v == 0.0 for v in exact.values()), exact
    assert sound["correct"], sound["compared"]
    ctl, _ = bench.run_cell("stereo0_stream", SEED, 6.0, False, control="tf32", **kw)
    assert not ctl["correct"], ctl["compared"]
