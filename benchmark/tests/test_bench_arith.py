"""The benchmark's arithmetic against hand-worked cases, and the harness's
lookup of every file a cell names."""
import json
import math
import os
import re

import pytest
import torch
from torch import nn

from benchmark.harness import main, readers
from benchmark.harness import trace as tr
from benchmark.harness import yardstick as ys

SPEC = json.load(open(os.path.join(main.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 90, 5.0),
    (list(range(1, 11)), 90, 9),          # ceil(0.9 * 10) = 9th value
    (list(range(1, 12)), 90, 10),         # ceil(9.9) = 10th
    ([3, 1, 2], 50, 2),
    (list(range(100, 0, -1)), 90, 90),
])
def test_percentile_nearest_rank(values, q, want):
    assert ys.percentile_nearest_rank(values, q) == want


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),               # overlap counted once
    ([(0, 4), (1, 2), (3, 3.5)], 4.0),     # nested
    ([(5, 6), (0, 1), (1, 2)], 3.0),       # unsorted, touching
])
def test_union_length(intervals, want):
    assert ys.union_length(intervals) == pytest.approx(want)


def test_gaps_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert ys.gaps(iv) == [(2.0, 3.0)]
    r = {"slice": {"wall_s": 5.0, "busy_s": ys.union_length(iv), "device_ops": 3, "steps": 1,
                   "k1_s": [], "k1_shape": None}}
    assert readers.device_idle(r) == pytest.approx(100.0 * (1 - 3.0 / 5.0))
    assert readers.device_ops_per_step(r) == 3
    assert readers.k1_roofline(r) is None


@pytest.mark.parametrize("N,S,want", [(4096, 24, 95_158_272), (6144, 28, 191_299_584),
                                      (32768, 24, 761_266_176)])
def test_k1_bytes_match_the_kernel_table(N, S, want):
    assert ys.k1_bytes(N, S) == want


def test_k1_roofline_share():
    N, S = 4096, 24
    t = 0.0542e-3
    r = {"slice": {"wall_s": 1.0, "busy_s": 0.1, "device_ops": 10, "steps": 2,
                   "k1_s": [t, t], "k1_shape": (N, S)}}
    want = 100 * (95_158_272 / 3.35e12) / t        # PERF.md's 52.5% flushed
    assert readers.k1_roofline(r) == pytest.approx(want)
    assert 52 < want < 53


def test_network_flops_by_hand():
    assert ys.linear_flops(10, 3, 4) == 240
    assert ys.conv1d_flops(2, 30, 20, 4, 4) == 2 * 2 * 20 * 4 * 30 * 4
    assert ys.train_flops(100, 10) == 130


def test_flop_counter_counts_forward_and_backward():
    net = nn.Sequential(nn.Linear(8, 16), nn.ELU(), nn.Linear(16, 2))
    conv = nn.Conv1d(3, 5, kernel_size=2)
    fc = tr.FlopCounter()
    fc.start()
    try:
        net(torch.zeros(4, 8))                       # with grad: backward counted twice
        with torch.no_grad():
            net(torch.zeros(6, 8))
            conv(torch.zeros(7, 3, 10))
    finally:
        fc.stop()
    net(torch.zeros(4, 8))                           # after stop: not counted
    with_grad = 2 * 4 * (8 * 16 + 16 * 2)
    fwd = 2 * 6 * (8 * 16 + 16 * 2) + 2 * 7 * 5 * 9 * 3 * 2
    assert fc.forward_with_grad == with_grad and fc.forward == fwd
    assert fc.total() == fwd + 3 * with_grad


def test_stage_readers():
    st = {"draw": 1.0, "rollout": 240.0, "gae": 2.0, "ppo": 200.0, "disc": 700.0, "end": 5.0,
          "_order": ["start", "draw", "rollout", "gae", "ppo", "disc", "end"]}
    r = {"stages": [st, dict(st, ppo=300.0)], "steps_per_iteration": 24}
    assert readers.update_ms(r) == pytest.approx((902 + 1002) / 2)
    assert readers.rollout_step_ms(r) == pytest.approx(10.0)
    assert readers.mfu({"flops": 67e12, "window_s": 100.0}) == pytest.approx(1.0)
    assert readers.mfu({}) is None


def test_harness_finds_every_file_by_name():
    for w in SPEC["workloads"]:
        cell = main.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert main.kind_module(cell.traffic["kind"]).run
        assert set(cell.limits["limits"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(main.Cell.reader(m["name"]))
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(main.ROOT, c["file"]))


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = {w["name"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s
    # of compiling a cell and 1200 s spare fit into 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_checks_read_a_missing_number_as_failed():
    out = main.checks({"a": 0.5}, {"a": 1.0, "b": 1.0})
    assert out["a"]["ok"] and not out["b"]["ok"] and math.isinf(out["b"]["value"])


def test_outlying_envs_are_counted_where_the_trim_leaves_them_out():
    from benchmark.reference import core

    g = torch.Generator().manual_seed(3)
    r = torch.randn(4096, 12, generator=g)
    p = r * (1 + 1e-6 * torch.randn(4096, 12, generator=g))
    p[[5, 900, 4000]] = r[[6, 901, 4001]]          # three envs answer wrong
    assert core.trimmed_rel_gap(p, r) < 1e-5        # the trim leaves them out
    per = core.env_rel_gaps(p, r)
    assert int((per > core.OUTLIER).sum()) == 3 and float(per.max()) > 0.1
    assert int((core.env_rel_gaps(r * (1 + 1e-6), r) > core.OUTLIER).sum()) == 0
    gaps = [dict(gap=1e-6, outliers=1), dict(gap=2e-6, outliers=0), dict(gap=1e-6, outliers=2)]
    assert core.env_numbers(gaps) == {"env_step_gap": 2e-6, "env_outliers": 3}
    assert core.env_numbers([]) == {"env_step_gap": math.inf, "env_outliers": math.inf}


def test_each_training_family_records_through_its_reference_module():
    from benchmark.harness import train

    for c in SPEC["configs"]:
        cfg = json.load(open(os.path.join(main.ROOT, c["file"])))
        if "train" in cfg:
            ref = train.family(cfg)
            assert callable(ref.record) and callable(ref.fault_gaps) and ref.make_trainer
