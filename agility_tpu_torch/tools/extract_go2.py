"""Distil a Go2 robot description from a URDF into the plain-JSON model
asset that core/urdf.build_go2_model reads (counterpart of
tools/extract_go2.py).  It writes only the path it is given:

    python -m agility_tpu_torch.tools.extract_go2 path/to/go2.urdf out/go2_model.json

The packaged asset is agility_tpu_torch/assets/go2_model.json, a byte copy
of the JAX package's; pass its path to replace it.
"""
import argparse
import json
import os

from agility_tpu_torch.core.urdf import load_urdf, parsed_to_json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("urdf", help="the robot's .urdf")
    p.add_argument("out", help="the .json asset to write")
    a = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(parsed_to_json(load_urdf(a.urdf)), f, indent=1)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
