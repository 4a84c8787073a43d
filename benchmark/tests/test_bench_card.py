"""The control on the card at a tiny size: the reference computed with TF32,
in the program's place, has to come out as not correct against the
float32 reference under each cell's limits; the program itself, on the
card with its kernels, has to come out correct."""
import json
import os

import pytest

from benchmark.harness import main, play, train

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = [("bbc_train", "bbc_tiny.json", "train", train),
         ("tsc_train", "tsc_tiny.json", "train", train),
         ("bbc_play", "bbc_tiny.json", "play_trot", play)]


def _load(cell, cfg_file, traffic):
    cfg = json.load(open(os.path.join(HERE, cfg_file)))
    tr = json.load(open(os.path.join(main.BENCH_DIR, "traffic", traffic + ".json")))
    tr.update(check_range=4)
    lim = json.load(open(os.path.join(main.BENCH_DIR, "limits", cell + ".json")))["limits"]
    return cfg, tr, lim


@pytest.mark.card
@pytest.mark.parametrize("cell,cfg_file,traffic,kind", CASES, ids=[c[0] for c in CASES])
def test_control_fails_and_program_passes_on_the_card(card, cell, cfg_file, traffic, kind):
    cfg, tr, lim = _load(cell, cfg_file, traffic)
    res = kind.run(cfg, tr, 2**31 + 5, 1.0, False, card, control=True)
    assert all(c["ok"] for c in main.checks(res["numbers"], lim).values()), res["numbers"]
    ctrl = res["judged"]["control"]
    ctrl = ctrl.get("tf32", ctrl)
    assert not all(c["ok"] for c in main.checks(ctrl, lim).values()), ctrl
