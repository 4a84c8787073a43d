"""Inputs shared by the per-env engine's parity tests: numpy batches of Go2
states, controls, randomized parameters and terrain, handed to the JAX
package and to the port alike (as float32, or float64 where a test runs
both sides in double precision)."""
import numpy as np
import jax.numpy as jnp
import torch

from agility_tpu.core.urdf import build_go2_model as j_build
from agility_tpu.physics import engine as jeng
from agility_tpu.physics import heightfield as jhf
from agility_tpu.physics.constants import ModelConsts as JMC
from agility_tpu_torch.core.urdf import build_go2_model
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics.constants import ModelConsts

N = 4
GRAV = (0.0, 0.0, -9.81)
DEFAULT_DOF = build_go2_model().default_dof_pos


def consts(dtype=np.float32):
    """(JAX ModelConsts, port ModelConsts on the CPU) in `dtype`."""
    jd, td = (jnp.float64, torch.float64) if dtype == np.float64 else (jnp.float32,
                                                                        torch.float32)
    return (JMC.from_model(j_build(), dtype=jd),
            ModelConsts.from_model(build_go2_model(), "cpu", dtype=td))


def np_state(rng, n=N, z=0.30, spread=0.3):
    """base_pos, base_quat, dof_pos, u of n random states low over the terrain."""
    bp = np.concatenate([rng.normal(0, 0.2, (n, 2)), np.full((n, 1), z)], -1)
    q = rng.normal(0, 0.1, (n, 4)) + np.array([0, 0, 0, 1.0])
    qj = DEFAULT_DOF + rng.uniform(-spread, spread, (n, 12))
    return [bp, q / np.linalg.norm(q, axis=-1, keepdims=True), qj, rng.normal(0, 0.3, (n, 18))]


def np_step_inputs(rng, n=N, weights=False):
    """(state, control, params) numpy lists: PD targets near the default
    pose, randomized friction, motor strengths, payload and CoM shift, and
    per-env heightfield weights (two movable layers and the seesaw tilt)
    when `weights`."""
    tgt = DEFAULT_DOF + rng.uniform(-0.2, 0.2, (n, 12))
    ctl = [tgt, np.full((n, 12), 40.0), np.full((n, 12), 1.0)]
    prm = [rng.uniform(0.6, 1.2, n), rng.uniform(0.8, 1.2, (n, 12)),
           rng.uniform(0.8, 1.2, (n, 12)), rng.uniform(0, 1.5, n),
           rng.uniform(-0.05, 0.05, (n, 3))]
    if weights:
        prm.append(np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(0.0, 0.15, n),
                             rng.uniform(-0.2, 0.2, n)], -1))
    return np_state(rng, n), ctl, prm


def np_grid(rng, layered=False, roof=False):
    """A 48 x 48 rough grid at 0.05 m around the origin.  `layered` adds two
    movable layers (tags 1 and 2) and a seesaw lever; `roof` adds a ceiling
    at 0.36 m over the middle (tagged layer 1 on one side), low enough that
    the trunk spheres of a base at 0.30 m press into it."""
    H = W = 48
    g = dict(height=0.08 * rng.normal(size=(H, W)), hscale=0.05, origin=(-1.2, -1.2))
    if layered or roof:
        tags = np.zeros((H, W), np.int8)
        tags[10:30, 5:25], tags[28:40, 20:44] = 1, 2
        lever = np.zeros((H, W))
        lever[15:35, 24:40] = np.linspace(-0.4, 0.4, 16)[None, :]
        g.update(layer_id=tags, lever=lever)
    if roof:
        ceil = np.full((H, W), thf.NO_CEILING)
        ceil[8:40, 8:40] = 0.36 + 0.02 * rng.normal(size=(32, 32))
        cl = np.zeros((H, W), np.int8)
        cl[8:40, 8:20] = 1
        g.update(ceiling=ceil, ceiling_layer=cl)
    return g


def grids(g, dtype=np.float32):
    """(JAX HeightGrid, port HeightGrid on the CPU) of np_grid's dict; the
    float surfaces in `dtype` (JAX's from_numpy would round them to float32)."""
    jf = lambda k, dt: None if g.get(k) is None else jnp.asarray(g[k], dt)
    tf = lambda k, dt: None if g.get(k) is None else torch.as_tensor(np.asarray(g[k], dt))
    o = np.asarray(g["origin"], np.float32)
    jg = jhf.HeightGrid(height=jf("height", dtype), hscale=g["hscale"],
                        origin=jnp.asarray(o, dtype), layer_id=jf("layer_id", jnp.int8),
                        lever=jf("lever", dtype), ceiling=jf("ceiling", dtype),
                        ceiling_layer=jf("ceiling_layer", jnp.int8))
    tg = thf.HeightGrid(height=tf("height", dtype), hscale=g["hscale"],
                        origin=(float(o[0]), float(o[1])), layer_id=tf("layer_id", np.int8),
                        lever=tf("lever", dtype), ceiling=tf("ceiling", dtype),
                        ceiling_layer=tf("ceiling_layer", np.int8))
    return jg, tg


def engine_inputs(state, ctl, prm, dtype=np.float32):
    """((EnvState, Control, EnvParams) for JAX, the same for the port)."""
    j = lambda xs: [jnp.asarray(np.asarray(x, dtype)) for x in xs]
    t = lambda xs: [torch.as_tensor(np.asarray(x, dtype)) for x in xs]
    return ((jeng.EnvState(*j(state)), jeng.Control(*j(ctl)), jeng.EnvParams(*j(prm))),
            (teng.EnvState(*t(state)), teng.Control(*t(ctl)), teng.EnvParams(*t(prm))))


def close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    """Compare (nested tuples of) port tensors against JAX arrays."""
    if isinstance(got, (list, tuple)):
        assert len(got) == len(ref), msg
        for i, (a, b) in enumerate(zip(got, ref)):
            close(a, b, rtol, atol, f"{msg}[{i}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)
