"""Env-axis data parallelism over the cards of one host: the 32k tasks
trained by W ranks, one per card, against the same tasks on one card.

    python3 multi_card.py            # W = every CUDA card the host shows
    python3 multi_card.py --cards 1 --iters 1   # a quick check of the script on one card

For each task, go2_locomotion_32k through cli/train_bbc and go2_32k through
cli/train_tsc (the teacher flags, the frozen logs/bbc_r5/bbc_final.msgpack),
`python -m torch.distributed.run --standalone --nproc_per_node W` starts W
ranks of this script's worker (--shard: NCCL, rank r on cuda:r, 32768 / W
envs each) for --iters iterations, then one rank on one card for one
iteration.  The worker builds and trains through the CLI's own build and
train, timed as chip_smoke.timed_training times them (CUDA events at each
stage, the host clock synchronised at each iteration's start and end,
every all-reduce timed by CUDA events); rank 0 writes its readings to a
JSON file.  Prints per task the W-card rate in total and per card (host
clock, iterations 1 to the last), the collectives' share of those
iterations, and the first iteration's metrics of the W-card run against
the one-card run's; the line before the last gives the cards' name and
power limit, the last a JSON record.  Exits nonzero without a card or
when a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TSC_BBC = os.path.join(ROOT, "logs", "bbc_r5", "bbc_final.msgpack")
TASKS = ("go2_locomotion_32k", "go2_32k")


def cli_argv(task, iters, log_root):
    """The training CLI's module and flags for `task`."""
    common = ["--shard", "--max_iterations", str(iters), "--device", "cuda", "--log_root",
              log_root, "--log_every", "1"]
    if task == "go2_locomotion_32k":
        return "train_bbc", ["--task", task] + common
    return "train_tsc", ["--task", task, "--bbc_path", TSC_BBC, "--randomize_start",
                         "--randomize_base_mass", "--randomize_base_com",
                         "--push_robots"] + common


def worker(args):
    """One rank: build and train `args.task` through its CLI, timed; rank 0
    writes the readings to `args.out`."""
    import importlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ.get("RANK", "0"))
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    name, argv = cli_argv(args.task, args.iters, args.log_root)
    cli = importlib.import_module(f"agility_tpu_torch.cli.{name}")
    try:
        res = chip_smoke.timed_training(f"{args.task} x{os.environ.get('WORLD_SIZE', '1')}", cli,
                                        argv, chip_smoke.BIG_ENVS, probe_steps=0)
        world = dist.get_world_size()
    finally:
        from agility_tpu_torch.dist import mesh

        mesh.close()
    if rank == 0:
        keys = ("rate", "it_ms", "its", "wall_ms", "metrics", "peak", "build_s", "collectives",
                "collective_ms", "launches")
        with open(args.out, "w") as f:
            json.dump(dict(world=world, device=torch.cuda.get_device_name(0),
                           **{k: res[k] for k in keys}), f)


def run(task, cards, iters, tmp):
    """torch.distributed.run of the worker on `cards` cards; its readings."""
    out = os.path.join(tmp, f"{task}_{cards}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(cards), os.path.abspath(__file__), "--worker", "--task", task, "--iters",
           str(iters), "--log_root", os.path.join(tmp, f"logs_{task}_{cards}"), "--out", out]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, timeout=1500)
    if res.returncode != 0:
        raise SystemExit(f"multi_card: {task} on {cards} card(s) exited {res.returncode}")
    with open(out) as f:
        rec = json.load(f)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worker", action="store_true", help="one rank (torchrun starts these)")
    p.add_argument("--task", default=None)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--cards", type=int, default=None, help="W (default: every card)")
    p.add_argument("--log_root", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if args.worker:
        worker(args)
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("multi_card: torch sees no CUDA card")
    cards = args.cards or torch.cuda.device_count()
    if cards > torch.cuda.device_count():
        sys.exit(f"multi_card: {cards} cards asked for, {torch.cuda.device_count()} present")
    summary = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for task in TASKS:
            many, one = run(task, cards, args.iters, tmp), run(task, 1, 1, tmp)
            m0, m1 = many["metrics"][0], one["metrics"][0]
            rel = {k: abs(m0[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in m1}
            rollout = {k: v for k, v in rel.items() if k.startswith("rollout/")}
            share = many["collective_ms"] / sum(many["wall_ms"])
            first = 1 if len(many["wall_ms"]) > 1 else 0
            print(f"{task}: {cards} card(s) x {args.iters} iterations: {many['rate']:.1f} "
                  f"env-steps/s in total over iterations {first}-{len(many['wall_ms']) - 1}, "
                  f"{many['rate'] / cards:.1f} per card; "
                  f"iterations {', '.join(f'{x:.1f}' for x in many['wall_ms'])} ms; "
                  f"collectives {many['collectives']} all-reduces, "
                  f"{many['collective_ms']:.1f} ms, {100 * share:.2f}% of the iterations' host "
                  f"time; peak {many['peak'] / 2**30:.3f} GiB on rank 0; one card, iteration 0: "
                  f"{one['wall_ms'][0]:.1f} ms, {one['rate']:.1f} env-steps/s, collectives "
                  f"{one['collective_ms']:.1f} ms", flush=True)
            print(f"{task}: iteration 0, {cards} cards vs one card, relative: rollout "
                  + ", ".join(f"{k[8:]} {v:.3e}" for k, v in rollout.items())
                  + f"; every metric at most {max(rel.values()):.3e} "
                  f"({max(rel, key=rel.get)})", flush=True)
            summary[task] = dict(cards=cards, rate=many["rate"], rate_per_card=many["rate"] / cards,
                                 wall_ms=many["wall_ms"], collectives=many["collectives"],
                                 collective_ms=many["collective_ms"], collective_share=share,
                                 one_card_it0_ms=one["wall_ms"][0], one_card_rate=one["rate"],
                                 it0_rel=rel, stages=many["its"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().replace("\n", "; "), flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
