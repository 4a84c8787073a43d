"""Count the operations one BBC play control step issues on each engine
path: the SoA substep (`sim.solver="jacobi"`), the per-env engine with
`"pgs"` and `"soft"`, and the contact-frame PGS (`EngineConfig(solver=
"pgs", fast=False)`).

On the card it counts device kernels (copies and fills included), as
profile_slice.py and chip_smoke.py count them; on the CPU, the leaf aten
operations that compute (views and metadata operations left out), a count
of what the host issues and not a device metric:

    python -m agility_tpu_torch.tools.count_ops                      # one CUDA card
    python -m agility_tpu_torch.tools.count_ops --device cpu --num_envs 16

Prints one JSON object {path: operations per control step}.
"""
import argparse
import dataclasses
import json
import os

import torch

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "..", "logs", "bbc_r5",
                          "bbc_15k.msgpack")
# aten operations that launch no compute: views, reshapes, metadata
NO_COMPUTE = frozenset(
    "aten::" + n for n in (
        "view", "as_strided", "reshape", "_reshape_alias", "_unsafe_view", "expand", "expand_as",
        "permute", "transpose", "t", "select", "slice", "narrow", "unsqueeze", "squeeze",
        "alias", "detach", "resolve_conj", "resolve_neg", "lift_fresh", "unbind", "split",
        "split_with_sizes", "unsafe_split", "chunk", "diagonal", "movedim", "flatten",
        "unflatten", "view_as", "contiguous", "broadcast_tensors", "empty", "empty_like",
        "empty_strided", "result_type", "item", "_local_scalar_dense", "is_nonzero", "size",
        "stride"))
PATHS = {"soa": ({}, {}), "pgs": ({"sim.solver": "pgs"}, {}),
         "soft": ({"sim.solver": "soft"}, {}),
         "pgs_contact_frames": ({}, dict(solver="pgs", fast=False))}


def ops_of(fn, device="cuda") -> int:
    """The operations fn() issues: on the card the device kernels (copies
    and fills included; the device activity alone is traced, and its raw
    events counted, since building the host-side event tree of a ~63k-op
    step takes seconds), on the CPU the leaf aten operations that compute."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.device_type() == torch.autograd.DeviceType.CUDA
                   for e in prof.profiler.kineto_results.events())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name.startswith("aten::") and e.name not in NO_COMPUTE
               and not any(c.name.startswith("aten::") for c in e.cpu_children)
               for e in prof.events())


def count(device="cuda", num_envs=4096, checkpoint=CHECKPOINT):
    """{path: operations of one control step} of play_bbc's env and policy
    (trot at vx 1.0), each path one step after init_state and a warm step."""
    from agility_tpu_torch.cli import play_bbc

    args = play_bbc.get_args(["--device", device, "--num_envs", str(num_envs), "--checkpoint",
                              checkpoint, "--mode", "trot", "--vx", "1.0"])
    out = {}
    for path, (overrides, engine) in PATHS.items():
        env, policy, _, hold = play_bbc.build(args, overrides)
        env.engine_cfg = dataclasses.replace(env.engine_cfg, **engine)
        s = env.init_state()
        s, _ = env.step(hold(s), policy(s.obs_buf))
        out[path] = ops_of(lambda: env.step(hold(s), policy(s.obs_buf)), device)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--checkpoint", default=CHECKPOINT)
    a = p.parse_args(argv)
    print(json.dumps(count(a.device, a.num_envs, a.checkpoint)))


if __name__ == "__main__":
    main()
