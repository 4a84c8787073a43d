"""The "distill" traffic kind end to end on the CPU at a tiny size (8 envs
on 2 courses), below its look for a chip: the program's run agrees with
the plain reference exactly, runs with the timed path broken underneath
come out not correct, and the run writes nothing into the repo's logs.
Also the kind's own arithmetic: its per-layer readers on synthetic
readings and its FLOP count of the depth networks."""
import json
import os

import pytest
import torch

from benchmark.harness import distill, distill_readers, main, vision_flops
from benchmark.harness import yardstick as ys

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "vision_train"
SEED = 2**31 + 77   # wider than 32 signed bits


def limits():
    return json.load(open(os.path.join(main.BENCH_DIR, "limits", CELL + ".json")))["limits"]


def run(fault=None, control=False):
    cfg = json.load(open(os.path.join(HERE, "vision_tiny.json")))
    tr = json.load(open(os.path.join(main.BENCH_DIR, "traffic", "distill.json")))
    return distill.run(cfg, tr, SEED, 0.5, False, "cpu", control=control, fault=fault)


def correct(numbers):
    return all(c["ok"] for c in main.checks(numbers, limits()).values())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _logs():
    root = os.path.join(main.ROOT, "logs")
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs)


def test_distill_matches_the_reference_on_the_cpu():
    before = _logs()
    res = run(control=True)
    assert res["numbers"] == {k: 0 for k in res["numbers"]}    # the same plain path
    assert set(res["numbers"]) == set(limits())
    assert correct(res["numbers"])
    assert res["end_to_end"]["train_env_steps_per_s"] > 0 and res["attempted"] >= 1
    assert res["readings"]["counters"]["render.samples"] == \
        5 * res["attempted"] * 8 * 58 * 87 * 32
    assert _logs() == before                    # nothing written under logs/
    ctrl = res["judged"]["control"]
    assert ctrl["unchanged"]["change_gap"] == 1.0 and not correct(ctrl["unchanged"])
    for fault in ("altered", "one_env"):
        assert not correct(ctrl[fault])
    assert ctrl["one_env"]["depth_outliers"] >= 5 and ctrl["one_env"]["env_outliers"] >= 5


def _one_env_render(orig):
    """Env 0's depth taken from env 1's: a render altered in one env."""
    def render_depth(*a, **k):
        d = orig(*a, **k).clone()
        d[0] = d[1]
        return d
    return render_depth


def _skip_updates(runner):
    """No optimiser moves: the update skipped."""
    ts = runner.train_state
    for attr in ("enc_opt", "actor_opt", "byol_opt"):
        opt = getattr(ts, attr)
        opt.__class__ = type("Frozen", (opt.__class__,), {"step": lambda self, *a, **k: None})


def test_distill_faults_come_out_not_correct(monkeypatch):
    from agility_tpu_torch.render import raycast

    monkeypatch.setattr(raycast, "render_depth", _one_env_render(raycast.render_depth))
    res = run()
    chk = main.checks(res["numbers"], limits())
    assert not chk["depth_outliers"]["ok"] and chk["env_step_gap"]["ok"]
    monkeypatch.undo()

    res = run(fault=_skip_updates)
    chk = main.checks(res["numbers"], limits())
    assert not chk["change_gap"]["ok"] and not correct(res["numbers"])


def test_readers_on_synthetic_readings():
    spans = {"render.march": dict(count=10, ms=300.0), "render.crossing": dict(count=10, ms=100.0),
             "vision.losses": dict(count=2, ms=50.0), "vision.backward": dict(count=2, ms=30.0),
             "vision.optim": dict(count=2, ms=20.0), "byol.step": dict(count=12, ms=60.0)}
    r = dict(program_spans=spans, iterations=2, steps_per_iteration=24,
             stages=[{"env": 240.0, "act": 10.0}, {"env": 480.0}])
    assert distill_readers.render_ms(r) == 40.0
    assert distill_readers.update_ms(r) == 50.0
    assert distill_readers.byol_ms(r) == 30.0
    assert distill_readers.env_step_ms(r) == 15.0
    empty = dict(program_spans={}, iterations=2, steps_per_iteration=24, stages=[])
    for read in (distill_readers.render_ms, distill_readers.update_ms, distill_readers.byol_ms,
                 distill_readers.env_step_ms):
        assert read(empty) is None and read({}) is None


def test_flops_of_the_depth_networks():
    """The counter against a hand count: the backbone's two convolutions and
    two dense layers, the GRU cell's two products, forward only under
    no_grad and with a backward of twice the forward under grad."""
    from agility_tpu_torch.learn import depth

    enc = depth.RecurrentDepthEncoder()
    B = 3
    img, prop, h = torch.zeros(B, 58, 87), torch.zeros(B, 65), torch.zeros(B, 512)
    conv = (vision_flops.conv2d_flops(B, 1, 32, 5, 5, 54, 83)
            + vision_flops.conv2d_flops(B, 32, 64, 3, 3, 25, 39))
    dense = (ys.linear_flops(B, 25 * 39 * 64, 128) + ys.linear_flops(B, 128, 32)
             + ys.linear_flops(B, 97, 128) + ys.linear_flops(B, 128, 32)
             + ys.linear_flops(B, 512, 40))
    gru = ys.linear_flops(B, 32, 1536) + ys.linear_flops(B, 512, 1536)
    fc = vision_flops.FlopCounter()
    fc.start()
    try:
        with torch.no_grad():
            enc(img, prop, h)
        assert fc.forward == conv + dense + gru and fc.forward_with_grad == 0
        enc(img, prop, h)
    finally:
        fc.stop()
    assert fc.forward_with_grad == conv + dense + gru
    assert fc.total() == 4 * (conv + dense + gru)
    assert conv > dense + gru                    # the convolutions dominate
