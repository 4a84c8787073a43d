"""The port's TSC serving slice vs agility_tpu: the agility env's per-env
constants, the TSC networks and checkpoint reader, set_commands, one env
step, the ceiling contact rows, the hierarchical action, and play_tsc.

The env step starts both packages from one JAX state with command noise and
action delay off; env 0 stands in the tunnel under its roof (the ceiling
contact rows are in the solve) and env 1 on the seesaw plank (its angle
moves).  The compared step resets no env (the two packages draw resets from
different random streams).  The JAX side runs the SoA engine
(AGILITY_ENGINE=soa) eagerly (jax.disable_jit), as tests/test_torch_env.py
does.

Tolerances: states to the SoA step's 1e-5 / 1e-3 (u), the seesaw angle
and its rate to 1e-6; observations, which are affine in the state, and the
smooth rewards to 1e-4; the networks to 1e-5 absolute or relative (float32,
other summation orders through a 5-layer network, logits up to ~50 on
random observations).
"""
import os

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agility_tpu.envs import go2_agility as jenv
from agility_tpu.envs import tsc_config as jcfg
from agility_tpu.core import quat as jqm
from agility_tpu.learn import networks as jnets
from agility_tpu.learn import networks_tsc as jtnets
from agility_tpu.physics import engine as jeng
from agility_tpu.physics import heightfield as jhf
from agility_tpu.terrain import obstacle as jobst
from agility_tpu_torch.envs import tsc_config as tcfg
from agility_tpu_torch.cli import play_tsc
from agility_tpu_torch.envs import go2_agility as tenv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.policy_tsc import build_tsc_policy
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.terrain import obstacle as tobst
from torch_cases import TMC

LOGS = os.path.join(os.path.dirname(__file__), "..", "logs")
TSC_CKPT = os.path.join(LOGS, "agility", "r5", "model_12000.msgpack")
BBC_CKPT = os.path.join(LOGS, "bbc_r5", "bbc_final.msgpack")
N = 4
# friction, command noise and delay off; the JAX package's config and the port's
CFG, TCFG = jcfg.tsc_smoke_cfg(num_envs=N, courses=2), tcfg.tsc_smoke_cfg(num_envs=N, courses=2)
TUNNEL, SEESAW = jobst.OBST_TYPES.index("tunnel"), jobst.OBST_TYPES.index("seesaw")


def _flax(path):
    with open(path, "rb") as f:
        return ser.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def envs():
    return jenv.Go2AgilityEnv(CFG), tenv.Go2AgilityEnv(TCFG, "cpu")


@pytest.fixture(scope="module")
def jstate(envs):
    """The JAX env's initial state with env 0 moved into the tunnel and env 1
    onto the seesaw pivot, each facing along its station, goals re-aimed."""
    je, _ = envs
    mp = pytest.MonkeyPatch()
    mp.setenv("AGILITY_ENGINE", "soa")
    try:
        with jax.disable_jit():
            s = je.init_state(jax.random.PRNGKey(3))
    finally:
        mp.undo()
    types, yaws = np.asarray(je.obst_types), np.asarray(je.obst_yaws)
    goals = np.asarray(je.env_goals)
    pos, quat = np.array(s.sim.base_pos), np.array(s.sim.base_quat)
    gidx = np.array(s.cur_goal_idx)
    for e, kind, z in ((0, TUNNEL, 0.32), (1, SEESAW, jobst.SEESAW_PIVOT_H + 0.32)):
        st = int(np.nonzero(types[e] == kind)[0][0])
        gidx[e] = st * CFG.obstacle.num_goals + 2          # the station's middle goal
        pos[e] = [goals[e, gidx[e], 0], goals[e, gidx[e], 1], z]
        quat[e] = np.asarray(jqm.quat_from_euler_xyz(0.0, 0.0, float(yaws[e, st])))
    s = s._replace(sim=s.sim._replace(base_pos=jnp.asarray(pos), base_quat=jnp.asarray(quat)),
                   cur_goal_idx=jnp.asarray(gidx, jnp.int32))
    return s._replace(cur_goals=je._gather_goals(s, s.cur_goal_idx),
                      next_goals=je._gather_goals(s, s.cur_goal_idx + 1))


def test_env_constants_match():
    """Per-env constants drawn from default_rng(cfg.seed) equal the JAX
    env's, with every randomization that draws on; the default scan window
    is 34 cells."""
    def cfg(m, obst):
        return m.Go2AgilityCfg(
            env=m.TscEnvCfg(num_envs=6),
            obstacle=obst.ObstacleCfg(courses=2, measure_horizontal_noise=0.02),
            domain_rand=m.TscDomainRandCfg(randomize_base_mass=True, randomize_base_com=True,
                                           randomize_motor=True))

    for jc, tc in ((cfg(jcfg, jobst), cfg(tcfg, tobst)), (CFG, TCFG)):
        je, te = jenv.Go2AgilityEnv(jc), tenv.Go2AgilityEnv(tc, "cpu")
        for f in ("friction", "kp_scale", "kd_scale", "added_base_mass", "base_com_shift"):
            np.testing.assert_array_equal(getattr(te.base_params, f).numpy(),
                                          np.asarray(getattr(je.base_params, f)), err_msg=f)
        for f in ("bar_h", "tire_h", "seesaw_damping", "seesaw_pose", "height_points",
                  "scan_center_local", "env_goals", "goal_layer", "obst_types", "obst_yaws",
                  "robot_org", "mass_params", "reward_scales", "x_edge"):
            np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)),
                                          err_msg=f)
        for f in ("height", "layer_id", "lever", "ceiling", "ceiling_layer"):
            np.testing.assert_array_equal(getattr(te.grid, f).numpy(),
                                          np.asarray(getattr(je.grid, f)), err_msg=f)
        assert te.scan_size == je.scan_size
        assert (te.reward_names, te.termination_scale) == (je.reward_names, je.termination_scale)
    assert te.scan_size == 34 and te.engine_cfg.patch_size == 32


def test_networks_match_flax(rng):
    ref = _flax(TSC_CKPT)
    sl = jtnets.TscObsSlices()
    ac = jtnets.ActorCriticTSC(num_actions_d=3, num_actions_c=6, slices=sl)
    pol = build_tsc_policy(TCFG, ckpt.params_from_jax_tsc(ckpt.read_msgpack(TSC_CKPT)),
                           device="cpu")
    obs = rng.normal(0, 1.0, (16, sl.total)).astype(np.float32)
    o, t = jnp.asarray(obs), torch.as_tensor(obs)
    with torch.no_grad():
        for hist in (True, False):
            want = ac.apply(ref["ac_params"], o, method="heads", hist_encoding=hist)
            got = pol.ac.heads(t, hist_encoding=hist)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        for name in ("value", "scan_latent"):
            np.testing.assert_allclose(getattr(pol.ac, name)(t).numpy(),
                                       np.asarray(ac.apply(ref["ac_params"], o, method=name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        est = jnets.Estimator(output_dim=4).apply(ref["est_params"], o[:, :57])
        np.testing.assert_allclose(pol.est(t[:, :57]).numpy(), np.asarray(est), rtol=1e-5,
                                   atol=1e-5)


def _hl_actions(rng):
    d = rng.integers(0, 3, (N, 1)).astype(np.float32)
    return np.concatenate([d, rng.normal(0, 0.8, (N, 18))], -1).astype(np.float32)


def test_set_commands_matches(envs, jstate, rng):
    je, te = envs
    hl = _hl_actions(rng)
    with jax.disable_jit():
        js, jnc = je.set_commands(jstate, jnp.asarray(hl))
    ts, tnc = te.set_commands(tenv.state_from_jax(jstate, "cpu"), torch.as_tensor(hl))
    np.testing.assert_allclose(tnc.numpy(), np.asarray(jnc), atol=1e-6)
    for f in ("commands", "latent_c", "latent_eps", "action_hl_history"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-6, err_msg=f)


def test_env_step_matches(envs, jstate):
    je, te = envs
    acts = np.random.default_rng(0).normal(0, 0.3, (N, 12)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setenv("AGILITY_ENGINE", "soa")
    try:
        with jax.disable_jit():
            s1, out = je.step(jstate, jnp.asarray(acts))
    finally:
        mp.undo()
    t0 = tenv.state_from_jax(jstate, "cpu")
    t1, tout = te.step(t0, torch.as_tensor(acts))

    # env 0 is under the tunnel roof, env 1's feet on the seesaw plank
    p = t0.sim.base_pos
    assert float(thf.sample_ceiling(te.grid, p[0, 0], p[0, 1])) < 1.0
    assert not bool(out.reset.any()) and not bool(tout.reset.any())
    for k, atol in dict(base_pos=1e-5, base_quat=1e-5, dof_pos=1e-5, u=1e-3).items():
        np.testing.assert_allclose(getattr(t1.sim, k).numpy(), np.asarray(getattr(s1.sim, k)),
                                   atol=atol, err_msg=k)
    assert abs(float(t1.seesaw_theta[1]) - jobst.SEESAW_THETA_REST) > 1e-5
    for k in ("seesaw_theta", "seesaw_theta_d"):
        np.testing.assert_allclose(getattr(t1, k).numpy(), np.asarray(getattr(s1, k)),
                                   atol=1e-6, err_msg=k)
    for k in ("reach_goal_timer", "target_yaw", "next_target_yaw", "delta_yaw",
              "delta_next_yaw", "obs_history"):
        np.testing.assert_allclose(getattr(t1, k).numpy(), np.asarray(getattr(s1, k)),
                                   atol=1e-4, err_msg=k)
    for k in ("obs", "obs_bbc", "disc_obs", "terminal_disc_obs"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(out, k)),
                                   atol=1e-4, err_msg=k)
    scan = slice(65, 65 + 132)                            # the scandots: clip(z - 0.3 - h)
    assert float(tout.obs[:, scan].std()) > 0.01          # the scans see obstacles
    np.testing.assert_allclose(tout.reward_terms.numpy(), np.asarray(out.reward_terms),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tout.rew.numpy(), np.asarray(out.rew), rtol=1e-4, atol=1e-6)
    for k in ("contact_filt", "episode_length", "cur_goal_idx", "reached_goal", "leave_goal"):
        np.testing.assert_array_equal(getattr(t1, k).numpy(), np.asarray(getattr(s1, k)),
                                      err_msg=k)
    for k in ("cur_goals", "next_goals", "success_rate", "goal_progress"):
        np.testing.assert_allclose(getattr(t1, k).numpy(), np.asarray(getattr(s1, k)),
                                   atol=1e-6, err_msg=k)


def _flat(ceiling_z, n=64):
    h = np.zeros((n, n), np.float32)
    ceil = np.full((n, n), ceiling_z, np.float32)
    kw = dict(hscale=0.05, origin_xy=(-n * 0.05 / 2, -n * 0.05 / 2), ceiling=ceil)
    return jhf.from_numpy(h, **kw), thf.from_numpy(h, device="cpu", **kw)


def test_ceiling_rows_match_and_push_down(envs):
    """The ceiling contact rows (tests/test_overhang.py in the port): robots
    standing at 0.42 m under a 0.26 m roof.  One control step at the agility
    env's engine settings matches the JAX SoA step; held there, the trunk
    is pressed below the 0.24 m it stands at without a roof."""
    from agility_tpu.physics import soa as jsoa
    from agility_tpu_torch.physics import soa as tsoa

    je, te = envs
    ctl = teng.Control(TMC.default_dof_pos.repeat(N, 1), torch.full((N, 12), 40.0),
                       torch.full((N, 12), 1.0))
    prm = teng.EnvParams(torch.ones(N), torch.ones(N, 12), torch.ones(N, 12), torch.zeros(N),
                         torch.zeros(N, 3))
    s0 = teng.EnvState(torch.tensor([[0.0, 0.0, 0.42]]).repeat(N, 1),
                       torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(N, 1),
                       TMC.default_dof_pos.repeat(N, 1), torch.zeros((N, 18)))
    jg, tg = _flat(0.26)
    got = tsoa.control_step_batched(TMC, te.engine_cfg, tg, s0, ctl, prm)
    j = lambda x: None if x is None else jnp.asarray(x.numpy())
    with jax.disable_jit():
        ref = jsoa.control_step_batched(je.mc, je.engine_cfg, jg, jeng.EnvState(*map(j, s0)),
                                        jeng.Control(*map(j, ctl)),
                                        jeng.EnvParams(*map(j, prm)))
    for k, atol in dict(base_pos=1e-5, base_quat=1e-5, dof_pos=1e-5, u=1e-3).items():
        np.testing.assert_allclose(getattr(got[0], k).numpy(), np.asarray(getattr(ref[0], k)),
                                   atol=atol, err_msg=k)
    for a, b in zip(got[2:4], ref[2:4]):                 # body forces, max body forces
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=2e-2)
    assert float(got[3][:, 0, 2].min()) > 100.0          # the roof pushes on the trunk
    s = got[0]
    for _ in range(30):
        s = tsoa.control_step_batched(TMC, te.engine_cfg, tg, s, ctl, prm)[0]
    assert bool(torch.isfinite(s.base_pos).all()) and float(s.base_pos[:, 2].max()) < 0.22


def test_hierarchical_action_matches(envs, jstate):
    """[argmax mode | means] from the TSC teacher, set_commands, then the
    frozen BBC on obs_bbc with the fresh commands (play_tsc's act and
    ppo_tsc's bbc_act)."""
    je, te = envs
    ref, bref = _flax(TSC_CKPT), _flax(BBC_CKPT)
    sl = jtnets.TscObsSlices()
    ac = jtnets.ActorCriticTSC(num_actions_d=3, num_actions_c=6, slices=sl)
    est = jnets.Estimator(output_dim=4)
    bbc = jnets.ActorCritic(num_actions=12, slices=jnets.ObsSlices(57, 4, 29, 10, 11))
    with jax.disable_jit():
        obs = jstate.obs_buf
        o = obs.at[:, sl.explicit].set(est.apply(ref["est_params"], obs[:, :57]))
        logits_d, mean_c, _ = ac.apply(ref["ac_params"], o, method="heads", hist_encoding=True)
        hl = jnp.concatenate([jnp.argmax(logits_d, -1)[:, None].astype(jnp.float32), mean_c], -1)
        js, nc = je.set_commands(jstate, hl)
        ob = js.obs_bbc_buf.at[:, -nc.shape[1]:].set(nc)
        want = bbc.apply(bref["ac_params"], ob, method="action_mean", hist_encoding=True)

    pol = build_tsc_policy(TCFG, ckpt.params_from_jax_tsc(ckpt.read_msgpack(TSC_CKPT)),
                           ckpt.load_bbc_frozen(BBC_CKPT), "cpu")
    ts = tenv.state_from_jax(jstate, "cpu")
    thl = pol.act(ts.obs_buf)
    np.testing.assert_array_equal(thl[:, 0].numpy(), np.asarray(hl[:, 0]))
    np.testing.assert_allclose(thl.numpy(), np.asarray(hl), atol=1e-5)
    ts, tnc = te.set_commands(ts, thl)
    got = pol.bbc_act(ts.obs_bbc_buf, tnc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_play_tsc_runs_on_cpu(capsys):
    args = play_tsc.get_args(["--device", "cpu", "--num_envs", "4", "--courses", "2",
                              "--steps", "5", "--checkpoint", TSC_CKPT, "--bbc_path", BBC_CKPT])
    res = play_tsc.run(args)
    s = res["state"]
    assert res["steps"] == 6 and res["env_steps_per_s"] > 0
    assert all(bool(torch.isfinite(t).all()) for t in (*s.sim, s.obs_buf, s.obs_bbc_buf))
    assert s.obs_buf.shape == (4, 800) and s.obs_bbc_buf.shape == (4, 671)
    text = capsys.readouterr().out
    assert "course completions" in text and "mean goal index at end" in text
    # --use_camera: the depth student (untrained without --vision_checkpoint)
    env, pol, _ = play_tsc.build(play_tsc.get_args(["--device", "cpu", "--use_camera",
                                                    "--num_envs", "4", "--courses", "2"]))
    assert type(pol).__name__ == "StudentPolicy" and pol.interval == env.cfg.depth.update_interval
    s, _ = pol.step(env, env.init_state())
    assert pol.t == 1 and bool(torch.isfinite(s.obs_buf).all())
    assert "no vision checkpoint" in capsys.readouterr().out
