"""Derive per-mode gait acceptance bands from labelled mocap clips
(counterpart of tools/make_gait_bands.py).

A trained BBC should reproduce the mocap gaits (duty factor, stride
frequency, diagonal phase sync) within tolerance; the expert data defines
the bands: for every labelled clip under <mocap_dir>/mocap_all_lb (read by
envs/mocap.load_dir), gait stats from its toe-height trace, then [min - tol,
max + tol] over the clips of each mode (io/gait.bands_from_clips).  Writes
a bands JSON, by default the port's assets/gait_bands_real.json, which
`play_bbc --gait_bands` reads; on the same clips it is byte-identical to
the JAX tool's.

    python -m agility_tpu_torch.tools.make_gait_bands --mocap_dir D [--out F] [--device cuda]
"""
import argparse
import json
import os

from agility_tpu_torch.envs import mocap
from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
from agility_tpu_torch.io import gait

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "gait_bands_real.json")


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mocap_dir", required=True,
                   help="mocap dataset root (its labelled clips in mocap_all_lb/)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda", help="where the clips are loaded")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    motion = mocap.load_dir(os.path.join(args.mocap_dir, "mocap_all_lb"), None,
                            MOCAP_CATEGORIES, args.device).host()
    out = {}
    for mi, mode in enumerate(MOCAP_CATEGORIES):
        bands = gait.bands_from_motion(motion, mi)
        n = int((motion.label == mi).sum())
        out[mode] = {"clips": n, **{k: list(v) for k, v in bands.items()}}
        print(f"{mode:>8} ({n} clips): " + "  ".join(
            f"{k}=[{lo:.3f},{hi:.3f}]" for k, (lo, hi) in bands.items()))
    with open(os.path.abspath(args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {os.path.abspath(args.out)}")
    return out


if __name__ == "__main__":
    main()
