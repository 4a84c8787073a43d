"""One run of one cell: find the cell's configuration, traffic mix, limits
and per-layer readers by the names in BENCHMARK.json, look for the chips,
run the traffic kind's module, judge its output against the limits, and
print the result as the last line of standard output."""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "agility_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its files: configs/<config>.json,
    traffic/<traffic>.json, limits/<cell>.json, and the readers
    metrics/<metric>.py of the per-layer metrics that list it."""

    def __init__(self, name: str, spec_path: Optional[str] = None):
        spec = load_json(spec_path or os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r}; known: {sorted(cells)}")
        self.name, self.spec, self.workload = name, spec, cells[name]
        cfg = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = load_json(os.path.join(ROOT, cfg["file"]))
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                              self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"] if self._lists(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._lists(m)]

    def _lists(self, metric: Dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    @staticmethod
    def reader(metric: str):
        path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def kind_module(kind: str):
    """The traffic kind's module, benchmark/harness/<kind>.py."""
    return importlib.import_module(f"benchmark.harness.{kind}")


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number beside its limit; a number the run did not give
    reads as infinite."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v, "limit": limit, "ok": bool(math.isfinite(v) and v <= limit)}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(chips: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def result_line(cell: Cell, res: Dict, traced: bool, chips: int) -> Dict:
    """The result object: correct, attempted, failed, metrics, device,
    (traced) breakdown, and the checks last."""
    chk = checks(res["numbers"], cell.limits["limits"])
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(res["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(device_info(chips), memory_peak_bytes=res["memory_peak"])
    line = {"correct": all(c["ok"] for c in chk.values()), "attempted": res["attempted"],
            "failed": 0, "metrics": metrics, "device": device}
    sl = res["readings"].get("slice")
    if traced and sl:
        device.update(busy_s=sl["busy_s"], window_s=sl["wall_s"])
        line["breakdown"] = sl["breakdown"]
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in chk.items()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="also compute the control (the reference with TF32 in the "
                        "program's place) and print its numbers on standard error")
    args = p.parse_args(argv)

    cell = Cell(args.workload)
    chips = cell.workload["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed
    res = kind_module(cell.traffic["kind"]).run(cell.config, cell.traffic, seed, args.seconds,
                                            bool(args.trace), "cuda", control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, res, bool(args.trace), chips)
    if args.control:
        print("CONTROL " + json.dumps(res["judged"].get("control")), file=sys.stderr)
    print("DETAIL " + json.dumps(_detail(res), default=str), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _detail(res: Dict) -> Dict:
    """What a reader of the log wants beside the result: the end-to-end
    numbers, the env-step gaps field by field."""
    r = res["readings"]
    return {"end_to_end": res["end_to_end"], "judge_s": res["judged"]["seconds"],
            "iteration_s": r.get("iteration_s"), "window_s": r.get("window_s"),
            "env_gaps": res["judged"].get("env_gaps"), "numbers": res["numbers"],
            "host": r.get("host")}
