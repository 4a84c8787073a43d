"""PyTorch port vs the JAX package: robot model, model constants, quaternion
helpers, heightfield queries and terrain-patch extraction.

Same numpy inputs through both; float32 on both sides.  Model tables are
built from the same JSON asset by the same arithmetic, so they must match
exactly; the float32 formulas, atan2/asin/acos included, match to a few
ulps (atol 2e-6 on unit-scale values).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.core import quat as jq
from agility_tpu.core.urdf import build_go2_model as j_build
from agility_tpu.physics import heightfield as jhf
from agility_tpu.physics import patch as jpt
from agility_tpu.physics import soa as jsoa
from agility_tpu.physics.constants import ModelConsts as JMC
from agility_tpu_torch.core import quat as tq
from agility_tpu_torch.core.urdf import build_go2_model
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics import patch as tpt
from agility_tpu_torch.physics import soa as tsoa
from agility_tpu_torch.physics.constants import ModelConsts, consts_of

J_MODEL, T_MODEL = j_build(), build_go2_model()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_go2_model_matches():
    for f in ("parent", "joint_pos", "joint_rot", "joint_axis", "link_mass", "link_com",
              "link_inertia", "dof_link", "dof_limit_lower", "dof_limit_upper",
              "dof_effort_limit", "dof_velocity_limit", "default_dof_pos", "body_link",
              "body_offset", "ancestors"):
        np.testing.assert_array_equal(getattr(T_MODEL, f), getattr(J_MODEL, f), err_msg=f)
    assert T_MODEL.link_names == J_MODEL.link_names
    assert T_MODEL.dof_names == J_MODEL.dof_names
    assert T_MODEL.body_names == J_MODEL.body_names
    for a, b in zip(T_MODEL.sphere_arrays(), J_MODEL.sphere_arrays()):
        np.testing.assert_array_equal(a, b)


def test_model_consts_match():
    jm, tm = JMC.from_model(J_MODEL), ModelConsts.from_model(T_MODEL, "cpu")
    for f in ("parent", "joint_pos", "joint_quat", "joint_axis", "link_mass", "link_com",
              "link_inertia", "dof_link", "dof_limit_lower", "dof_limit_upper",
              "dof_effort_limit", "dof_velocity_limit", "default_dof_pos", "body_link",
              "body_offset", "sph_link", "sph_body", "sph_offset", "sph_radius", "ancestors"):
        a, b = _np(getattr(tm, f)), np.asarray(getattr(jm, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    jc, tc = jsoa.consts_of(jm), consts_of(tm)
    assert tc.legs == jc.legs and (tc.S, tc.L, tc.nu) == (jc.S, jc.L, jc.nu)
    np.testing.assert_array_equal(tc.body_mat.numpy(), jc.body_mat)
    np.testing.assert_array_equal(tc.lever_mask.numpy(), jc.ancestors[jc.sph_link])


def _quats(rng, n=16):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


QUAT_CASES = {
    "quat_mul": lambda m, q, q2, v, e: m.quat_mul(q, q2),
    "quat_rotate": lambda m, q, q2, v, e: m.quat_rotate(q, v),
    "quat_rotate_inverse": lambda m, q, q2, v, e: m.quat_rotate_inverse(q, v),
    "quat_apply_yaw": lambda m, q, q2, v, e: m.quat_apply_yaw(q, v),
    "quat_to_tan_norm": lambda m, q, q2, v, e: m.quat_to_tan_norm(q),
    "heading_quat_inv": lambda m, q, q2, v, e: m.heading_quat_inv(q),
    "quat_standardize": lambda m, q, q2, v, e: m.quat_standardize(q),
    "quat_from_euler_xyz": lambda m, q, q2, v, e: m.quat_from_euler_xyz(e[:, 0], e[:, 1], e[:, 2]),
    "euler_from_quat": lambda m, q, q2, v, e: m.euler_from_quat(q),
    "slerp": lambda m, q, q2, v, e: m.slerp(q, q2, e[:, :1] / 6.3 + 0.5),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_helpers_match(rng, name):
    q, q2, v = _quats(rng), _quats(rng), rng.normal(size=(16, 3)).astype(np.float32)
    e = rng.uniform(-3.1, 3.1, (16, 3)).astype(np.float32)
    fn = QUAT_CASES[name]
    ref = fn(jq, *(jnp.asarray(x) for x in (q, q2, v, e)))
    got = fn(tq, *(torch.as_tensor(x) for x in (q, q2, v, e)))
    np.testing.assert_allclose(np.stack([x.numpy() for x in got]) if name == "euler_from_quat"
                               else got.numpy(), np.asarray(ref), atol=2e-6)


SOA_Q_CASES = ("q_mul", "q_rot", "q_rotmat", "q_integrate")


@pytest.mark.parametrize("name", SOA_Q_CASES)
def test_soa_quat_helpers_match(rng, name):
    q, w = _quats(rng).T, rng.normal(0, 3, (3, 16)).astype(np.float32)
    q2 = _quats(rng).T
    args = {"q_mul": lambda m, T: m.q_mul(tuple(T(q)), tuple(T(q2))),
            "q_rot": lambda m, T: m.q_rot(tuple(T(q)), tuple(T(w))),
            "q_rotmat": lambda m, T: [x for row in m.q_rotmat(tuple(T(q))) for x in row],
            "q_integrate": lambda m, T: m.q_integrate(tuple(T(q)), tuple(T(w)), 0.005)}[name]
    ref = np.stack([np.asarray(x) for x in args(jsoa, jnp.asarray)])
    got = np.stack([x.numpy() for x in args(tsoa, torch.as_tensor)])
    np.testing.assert_allclose(got, ref, atol=2e-6)


def _grids(rng):
    h = (0.08 * rng.normal(size=(48, 40))).astype(np.float32)
    return (jhf.from_numpy(h, 0.05, origin_xy=(-1.2, -1.0)),
            thf.from_numpy(h, 0.05, origin_xy=(-1.2, -1.0), device="cpu"))


@pytest.mark.parametrize("fn", ["sample_height", "sample_height_min3", "sample_normal"])
def test_heightfield_queries_match(rng, fn):
    jg, tg = _grids(rng)
    # includes points off the grid on every side (clamped coordinates)
    x = rng.uniform(-1.5, 1.4, (7, 5)).astype(np.float32)
    y = rng.uniform(-1.3, 1.2, (7, 5)).astype(np.float32)
    ref = np.asarray(getattr(jhf, fn)(jg, jnp.asarray(x), jnp.asarray(y)))
    got = getattr(thf, fn)(tg, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_extract_batch_matches(rng):
    jg, tg = _grids(rng)
    c = rng.uniform(-1.6, 1.6, (9, 2)).astype(np.float32)   # some clamp at the edges
    ref = jpt.extract_batch(jg, jnp.asarray(c), 24)
    got = tpt.extract_batch(tg, torch.as_tensor(c), 24)
    for f in ("values", "x0", "y0"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    # JAX's min3 field, min(node, +x, +y) with the edge rows repeated, is a
    # function of the window the port returns
    v = got.values
    m = torch.minimum(v, torch.cat([v[:, 1:], v[:, -1:]], 1))
    m = torch.minimum(m, torch.cat([v[:, :, 1:], v[:, :, -1:]], 2))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref.min3), err_msg="min3")
