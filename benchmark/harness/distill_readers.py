"""The per-layer readers of the depth-student cell that harness/readers.py
does not hold: each takes a traced `distill` run's readings and returns the
metric, or None where the run holds nothing to read (a program without
the student's spans)."""
from __future__ import annotations

from statistics import mean
from typing import Dict, Optional, Sequence

RENDER = ("render.march", "render.crossing")
UPDATE = ("vision.losses", "vision.backward", "vision.optim")
BYOL = ("byol.augment", "byol.step", "byol.ema")


def _spans_ms(r: Dict, names: Sequence[str]) -> Optional[float]:
    """The window's ms in the program's spans `names` (CUDA-event ms, host
    ms off CUDA), or None where none of them was recorded."""
    spans = r.get("program_spans") or {}
    found = [spans[n]["ms"] for n in names if n in spans]
    return sum(found) if found else None


def render_ms(r: Dict) -> Optional[float]:
    """ms a camera refresh in `raycast.render_depth`'s spans (the march, then
    the first crossing and its secant step)."""
    ms = _spans_ms(r, RENDER)
    return ms / r["program_spans"][RENDER[0]]["count"] if ms is not None else None


def update_ms(r: Dict) -> Optional[float]:
    """ms an iteration in the distillation update's spans: the losses (the
    encoder chain and the heads under grad), the backward, both clips and
    Adam steps."""
    ms = _spans_ms(r, UPDATE)
    return ms / r["iterations"] if ms is not None else None


def byol_ms(r: Dict) -> Optional[float]:
    """ms an iteration in the BYOL minibatches' spans: augment, step, EMA."""
    ms = _spans_ms(r, BYOL)
    return ms / r["iterations"] if ms is not None else None


def env_step_ms(r: Dict) -> Optional[float]:
    """Mean ms of the trainer's "env" stages (from the "act" mark to the env
    step's), per control step."""
    vals = [st["env"] for st in r.get("stages", []) if "env" in st]
    return mean(vals) / r["steps_per_iteration"] if vals else None
