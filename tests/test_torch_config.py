"""The port's own copies of the JAX package's jax-free modules: the config
dataclasses, the numpy terrain and course generators and the Go2 model
asset equal the JAX package's; and every public `device` parameter of the
port defaults to the card.

The port imports nothing of agility_tpu (tests/test_torch_no_jax.py), so it
keeps copies; these tests hold the copies to the originals.
"""
import dataclasses
import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest

import agility_tpu
import agility_tpu_torch
from agility_tpu.cli import registry as jreg
from agility_tpu.envs import config as jcfg
from agility_tpu.envs import tsc_config as jtsc
from agility_tpu.learn import ppo_tsc as jppo
from agility_tpu.learn import ssinfogail as jgail
from agility_tpu.learn import vision_tsc as jvis
from agility_tpu.terrain import generator as jgen
from agility_tpu.terrain import obstacle as jobst
from agility_tpu_torch.cli import registry as treg
from agility_tpu_torch.core import urdf as turdf
from agility_tpu_torch.envs import config as tcfg
from agility_tpu_torch.envs import tsc_config as ttsc
from agility_tpu_torch.learn import ppo_tsc as tppo
from agility_tpu_torch.learn import ssinfogail as tgail
from agility_tpu_torch.learn import vision_tsc as tvis
from agility_tpu_torch.terrain import generator as tgen
from agility_tpu_torch.terrain import obstacle as tobst

# the port's task names -> the JAX registry's ("go2" is the TSC task there)
TASKS = {"go2_locomotion": "go2_locomotion", "go2_locomotion_smoke": "go2_locomotion_smoke",
         "go2_locomotion_32k": "go2_locomotion_32k", "go2_agility": "go2", "go2": "go2",
         "go2_32k": "go2_32k"}


def _dataclasses(mod):
    return sorted(n for n, v in vars(mod).items()
                  if dataclasses.is_dataclass(v) and v.__module__ == mod.__name__)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_registry_configs_equal(task):
    """Each task of the port's registry builds the same config as the JAX
    registry's, field for field."""
    got, want = treg.get(task)[0](), jreg.get(TASKS[task])[0]()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__module__.startswith("agility_tpu_torch.")


def test_algo_cfg_equal():
    """The port's AlgoCfg and TscAlgoCfg have the JAX package's fields and
    defaults, and the registry's algo half builds them for every task: the
    BBC's for both BBC tasks, the TSC teacher's for "go2" (the JAX name)
    and "go2_agility"."""
    for t, j in ((tgail.AlgoCfg, jgail.AlgoCfg), (tppo.TscAlgoCfg, jppo.TscAlgoCfg)):
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        assert dataclasses.asdict(t()) == dataclasses.asdict(j())
    for task, kind in (("go2_locomotion", tgail.AlgoCfg), ("go2_locomotion_smoke", tgail.AlgoCfg),
                       ("go2_locomotion_32k", tgail.AlgoCfg), ("go2", tppo.TscAlgoCfg),
                       ("go2_agility", tppo.TscAlgoCfg), ("go2_32k", tppo.TscAlgoCfg)):
        got, want = treg.get(task)[1](), jreg.get(TASKS[task])[1]()
        assert type(got) is kind
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_vision_cfg_equal():
    """The port's VisionCfg (the depth student's trainer) has the JAX
    package's fields and defaults, and the camera config it reads
    (DepthCfg) equals JAX's."""
    assert ([f.name for f in dataclasses.fields(tvis.VisionCfg)]
            == [f.name for f in dataclasses.fields(jvis.VisionCfg)])
    assert dataclasses.asdict(tvis.VisionCfg()) == dataclasses.asdict(jvis.VisionCfg())
    assert dataclasses.asdict(ttsc.DepthCfg()) == dataclasses.asdict(jtsc.DepthCfg())


def test_metric_writer_is_byte_identical():
    """io/metrics.py (the TensorBoard event writer, no JAX) is a copy."""
    with open(os.path.join(os.path.dirname(agility_tpu_torch.__file__), "io", "metrics.py"),
              "rb") as f, open(os.path.join(os.path.dirname(agility_tpu.__file__), "io",
                                            "metrics.py"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("pair", ["config", "tsc_config", "obstacle"])
def test_config_dataclasses_equal(pair):
    """Every config dataclass of the copied modules has the JAX package's
    fields and defaults; so do the smoke configs."""
    t, j = dict(config=(tcfg, jcfg), tsc_config=(ttsc, jtsc), obstacle=(tobst, jobst))[pair]
    names = _dataclasses(j)
    assert names and _dataclasses(t) == names
    for n in names:
        tc, jc = getattr(t, n), getattr(j, n)
        assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
        assert dataclasses.asdict(tc()) == dataclasses.asdict(jc()), n
    assert dataclasses.asdict(tcfg.smoke_cfg(16)) == dataclasses.asdict(jcfg.smoke_cfg(16))
    assert (dataclasses.asdict(ttsc.tsc_smoke_cfg(4, 3))
            == dataclasses.asdict(jtsc.tsc_smoke_cfg(4, 3)))
    assert tcfg.MOCAP_CATEGORIES == jcfg.MOCAP_CATEGORIES


def _assert_same(got, want):
    assert type(got)._fields == type(want)._fields
    for f, a, b in zip(type(got)._fields, got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("seed", [0, 1])
def test_terrain_generator_equal(seed):
    """The rough-terrain generator at a small size (2 x 3 cells of 4 m)."""
    kw = dict(terrain_length=4.0, terrain_width=4.0, num_rows=2, num_cols=3, border_size=2.0,
              terrain_proportions=(0.2, 0.3, 0.2, 0.2, 0.1))
    tc, jc = tcfg.TerrainCfg(**kw), jcfg.TerrainCfg(**kw)
    got, want = tgen.generate(tc, seed=seed), jgen.generate(jc, seed=seed)
    _assert_same(got, want)
    np.testing.assert_array_equal(tgen.assign_env_origins(got, 7, tc, seed=seed),
                                  jgen.assign_env_origins(want, 7, jc, seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_obstacle_generator_equal(seed):
    """The obstacle-course generator at a small size (2 courses), and the
    per-env obstacle heights it draws."""
    tc, jc = tobst.ObstacleCfg(courses=2), jobst.ObstacleCfg(courses=2)
    _assert_same(tobst.generate(tc, seed=seed), jobst.generate(jc, seed=seed))
    got = tobst.sample_obstacle_heights(tc, np.random.default_rng(seed), 5)
    want = jobst.sample_obstacle_heights(jc, np.random.default_rng(seed), 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for n in ("OBST_TYPES", "LAYER_BAR", "LAYER_TIRE", "NO_CEILING", "SEESAW_PIVOT_H",
              "SEESAW_HALF_LEN", "SEESAW_WIDTH", "SEESAW_THETA_MAX", "SEESAW_THETA_REST",
              "SEESAW_INERTIA"):
        assert getattr(tobst, n) == getattr(jobst, n), n


def test_asset_is_byte_identical():
    path = turdf.default_asset_path()
    assert os.path.dirname(os.path.dirname(path)) == os.path.dirname(agility_tpu_torch.__file__)
    with open(path, "rb") as f, open(os.path.join(os.path.dirname(agility_tpu.__file__),
                                                  "assets", "go2_model.json"), "rb") as g:
        assert f.read() == g.read()


def _device_defaults():
    """(qualified name, default) of every function or method defined in the
    port with a parameter named `device` that has a default, from the
    signatures alone."""
    found = []
    for m in pkgutil.walk_packages(agility_tpu_torch.__path__, "agility_tpu_torch."):
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns += [(f"{name}.{k}", v.__func__ if isinstance(v, (staticmethod, classmethod))
                         else v) for k, v in vars(obj).items()]
            for qual, fn in fns:
                if not inspect.isfunction(fn):
                    continue
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not inspect.Parameter.empty:
                    found.append((f"{mod.__name__}.{qual}", p.default))
    return found


def test_public_device_defaults_are_cuda():
    """Every `device` parameter in the port defaults to "cuda": its entry
    points run on the card unless the caller asks for the CPU."""
    found = dict(_device_defaults())
    assert {k: v for k, v in found.items() if v != "cuda"} == {}
    for want in ("envs.go2_locomotion.Go2LocomotionEnv.__init__",
                 "envs.go2_agility.Go2AgilityEnv.__init__", "learn.policy.build_policy",
                 "learn.policy_tsc.build_tsc_policy", "physics.heightfield.from_numpy",
                 "physics.constants.ModelConsts.from_model",
                 "envs.go2_locomotion.state_from_jax", "envs.go2_agility.state_from_jax",
                 "envs.mocap.synthetic", "envs.mocap.load_dir",
                 "learn.networks.RunningNormalizer.__init__",
                 "learn.replay.Ring.__init__", "render.raycast.make_camera"):
        assert f"agility_tpu_torch.{want}" in found, want
