"""The depth-student cell's control on the card at a tiny size: the
reference computed with TF32, in the program's place, has to come out as
not correct against the float32 reference under `vision_train`'s limits;
the program itself, on the card, has to come out correct."""
import json
import os

import pytest

from benchmark.harness import distill, main

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.card
def test_control_fails_and_program_passes_on_the_card(card):
    cfg = json.load(open(os.path.join(HERE, "vision_tiny.json")))
    tr = json.load(open(os.path.join(main.BENCH_DIR, "traffic", "distill.json")))
    lim = json.load(open(os.path.join(main.BENCH_DIR, "limits", "vision_train.json")))["limits"]
    res = distill.run(cfg, tr, 2**31 + 5, 1.0, False, card, control=True)
    assert all(c["ok"] for c in main.checks(res["numbers"], lim).values()), res["numbers"]
    ctrl = res["judged"]["control"]
    for reading in ("tf32", "unchanged", "altered", "one_env"):
        assert not all(c["ok"] for c in main.checks(ctrl[reading], lim).values()), \
            (reading, ctrl[reading])
