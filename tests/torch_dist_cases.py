"""Work that tests/test_torch_dist.py (and chip_smoke.py's DDP parity
phase) runs in each rank of a process group started by
agility_tpu_torch.dist.mesh.launch, and the same work in one process
without a group.  Imports no jax: the ranks start from a fresh interpreter
and import this module by name.

Every case builds its env on `device` with the rank's EnvShard (none in the
one-process run) and returns host tensors: the rank's rows of per-env
results, replicated results whole.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from agility_tpu_torch.dist import mesh
from agility_tpu_torch.envs import config as bbc_config
from agility_tpu_torch.envs import tsc_config
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn import ppo_tsc, ssinfogail
from agility_tpu_torch.learn.runner import OnPolicyRunner

# tests/test_dist.py's configuration of the JAX package's sharded iteration
BBC_ENVS = 16
BBC_KW = dict(num_steps_per_env=4, num_preload_transitions=128, disc_replay_buffer_size=256,
              num_learning_epochs=1, num_mini_batches=2)
TSC_ENVS, TSC_COURSES = 16, 2
TSC_KW = dict(num_steps_per_env=4, num_learning_epochs=1, num_mini_batches=2)


def shard_of(num_envs):
    """This process's EnvShard in the current group, or None outside one."""
    if not dist.is_initialized():
        return None
    return mesh.EnvShard(dist.get_rank(), dist.get_world_size(), num_envs)


def host(x):
    """Tensors (nested in dicts, lists, NamedTuples) moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: host(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    return x


def params(*modules):
    """Every parameter of the modules, flattened into one host vector."""
    return torch.cat([p.detach().reshape(-1).cpu() for m in modules for p in m.parameters()])


def param_groups(ts, names):
    """{network: its parameters flattened} of a train state."""
    return {k: params(getattr(ts, k)) for k in names}


def launches():
    """The kernels' launch counts."""
    from agility_tpu_torch.kernels import contact_lcp, scandots, terrain_window

    return dict(contact_lcp=contact_lcp.contact_lcp.launches,
                terrain_window=terrain_window.terrain_window.launches,
                scandots=scandots.scandots.launches)


def shard_round_trip(num_envs=12):
    """EnvShard.take of a global tensor and gather_rows back; each
    minibatch's rows of a permutation over (3 x num_envs), as global
    indices; a module's weights after broadcast_module_ from rank 0."""
    shard = shard_of(num_envs)
    g = torch.arange(num_envs * 5, dtype=torch.float32).reshape(num_envs, 5)
    flags = torch.arange(num_envs) % 3 == 0
    mine, back = shard.take(g), mesh.gather_rows(shard.take(g), shard)
    perm = torch.randperm(3 * num_envs, generator=torch.Generator().manual_seed(0))
    rows = mesh.minibatch_rows(perm, 4, 9, shard)
    # local flat index t * local + (e - offset) -> global t * num_envs + e
    glob = [(r // shard.local) * num_envs + r % shard.local + shard.offset for r in rows]
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(float(shard.rank))
    mesh.broadcast_module_(net)
    return dict(mine=mine, back=back, flags=mesh.gather_rows(shard.take(flags), shard),
                perm=perm, rows=glob, weight=net.weight.detach())


def bbc_iteration(device="cpu", it=0, cfg=None, kw=BBC_KW):
    """One SSInfoGAIL iteration (iteration `it`; 0 runs DAgger) from a fresh
    env (`cfg`, smoke_cfg(BBC_ENVS) by default) and train state, seeds 0 and
    1: the metrics, the parameters, the ring, the end state's rows and the
    kernels' launches."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or bbc_config.smoke_cfg(BBC_ENVS)
    env = Go2LocomotionEnv(cfg, device, seed=1, shard=shard_of(cfg.env.num_envs))
    alg = ssinfogail.SSInfoGAIL(env, ssinfogail.AlgoCfg(**kw), seed=0)
    ts = alg.init_train_state()
    es = env.init_state()
    dh = es.disc_obs[:, None].repeat(1, env.cfg.env.disc_obs_len, 1)
    before = launches()
    ts, es, dh, m = alg.train_iteration(ts, es, dh, it)
    after = launches()
    return dict(metrics=ssinfogail.metrics_to_host(m), params=params(ts.ac, ts.est, ts.disc),
                groups=param_groups(ts, ("ac", "est", "disc")),
                ring=host(ts.ring.data[:ts.ring.size]), sim=host(es.sim), obs=host(es.obs_buf),
                launches={k: after[k] - before[k] for k in after})


def bbc_env_step(device="cpu", cfg=None):
    """One BBC env step from the initial state with actions of unit
    normals x 0.1 (numpy seed 1, one global (N, 12) array), as
    tests/test_dist.py steps the JAX env: the obs, reward and base
    position rows."""
    torch.set_num_threads(1)
    cfg = cfg or bbc_config.smoke_cfg(BBC_ENVS)
    env = Go2LocomotionEnv(cfg, device, seed=1, shard=shard_of(cfg.env.num_envs))
    take = env.shard.take if env.shard else (lambda x: x)
    acts = np.random.default_rng(1).normal(size=(env.num_envs_global, 12)).astype(np.float32)
    s, out = env.step(env.init_state(), take(torch.as_tensor(acts * 0.1, device=env.device)))
    return dict(obs=host(out.obs), rew=host(out.rew), base_pos=host(s.sim.base_pos))


def tsc_env(num_envs=TSC_ENVS, courses=TSC_COURSES, device="cpu", curriculum=True):
    cfg = tsc_config.tsc_smoke_cfg(num_envs, courses)
    if curriculum:
        cfg = dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle,
                                                                     curriculum=True))
    return Go2AgilityEnv(cfg, device, seed=0, shard=shard_of(num_envs))


def tsc_env_steps(steps=3, device="cpu", cfg=None):
    """TSC env steps (set_commands then step) from the initial state with
    the JAX suite's high-level actions (unit normals x 0.1 from numpy seed
    1, as one global (N, 19) array), a quarter of the envs one goal short
    of the course's end (they finish and reset in the first step), the
    success EMA at 0.9 and the curriculum due at the first step: each
    step's obs, reward and base position rows, the EMAs and the curriculum
    count.  `cfg` replaces tsc_env's config."""
    torch.set_num_threads(1)
    env = (Go2AgilityEnv(cfg, device, seed=0, shard=shard_of(cfg.env.num_envs)) if cfg
           else tsc_env(device=device))
    shard = env.shard
    take = shard.take if shard else (lambda x: x)
    N = env.num_envs_global
    s = env.init_state()
    near_end = take(torch.arange(N, device=env.device) % 4 == 0)
    goal = torch.where(near_end, env.n_goals_total - env.last_goal_repeat - 1, s.cur_goal_idx)
    timer = torch.where(near_end, 1e3, s.reach_goal_timer)
    s = s._replace(cur_goal_idx=goal, reach_goal_timer=timer,
                   success_rate=torch.tensor(0.9, device=env.device),
                   global_counter=env.max_episode_length * 2 - 1)
    hl = np.random.default_rng(1).normal(size=(steps, N, 19)).astype(np.float32) * 0.1
    out = []
    for t in range(steps):
        s, _ = env.set_commands(s, take(torch.as_tensor(hl[t], device=env.device)))
        s, o = env.step(s, torch.zeros(env.num_envs, 12, device=env.device))
        out.append(dict(obs=host(o.obs), rew=host(o.rew), reset=host(o.reset),
                        base_pos=host(s.sim.base_pos), success_rate=float(s.success_rate),
                        success_rate_s0=float(s.success_rate_s0),
                        goal_progress=float(s.goal_progress), curr_count=int(s.curr_count)))
    return out


def tsc_iteration(device="cpu", it=0, cfg=None, kw=TSC_KW, bbc_path=None):
    """One TscPPO iteration (0 runs DAgger) on `cfg`'s world (tsc_env's by
    default) under the frozen BBC of `bbc_path` (fresh, seed 0, without
    one): metrics, parameters, the end state's rows, the EMAs and the
    kernels' launches."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    env = (Go2AgilityEnv(cfg, device, seed=0, shard=shard_of(cfg.env.num_envs)) if cfg
           else tsc_env(device=device, curriculum=False))
    alg = ppo_tsc.TscPPO(env, ckpt.load_bbc_frozen(bbc_path, seed=0), ppo_tsc.TscAlgoCfg(**kw),
                         seed=0)
    ts = alg.init_train_state()
    es = env.init_state()
    dh = es.disc_obs[:, None].repeat(1, env.cfg.env.disc_obs_len, 1)
    before = launches()
    ts, es, dh, m = alg.train_iteration(ts, es, dh, it)
    after = launches()
    return dict(metrics=ssinfogail.metrics_to_host(m), params=params(ts.ac, ts.est),
                groups=param_groups(ts, ("ac", "est")),
                sim=host(es.sim), success_rate=float(es.success_rate),
                curr_count=int(es.curr_count), lr=float(ts.lr),
                launches={k: after[k] - before[k] for k in after})


def gae_and_ppo(inputs):
    """The port's GAE (normalised over every rank) and PPO update on the
    rank's envs of a global rollout: `inputs` holds the smoke_cfg(N)
    trainer's config, its start parameters (state dicts), lr and priv-reg
    counter, and global numpy arrays (T, N, ...) of the Transition, the
    last values and the permutation.  Returns the rank's advantages and
    returns, the metrics, lr and the parameters' state dicts."""
    torch.set_num_threads(1)
    n = inputs["num_envs"]
    env = Go2LocomotionEnv(bbc_config.smoke_cfg(n), "cpu", shard=shard_of(n))
    alg = ssinfogail.SSInfoGAIL(env, ssinfogail.AlgoCfg(**inputs["kw"]), seed=0)
    ts = alg.init_train_state()
    ts.ac.load_state_dict(inputs["ac"])
    ts.est.load_state_dict(inputs["est"])
    ts.lr_ac = np.float32(inputs["lr"])
    ts.priv_reg_counter = inputs["priv_reg_counter"]
    take = (lambda x: env.shard.take(x, 1)) if env.shard else (lambda x: x)
    trs = ssinfogail.Transition(*(take(torch.as_tensor(x)) for x in inputs["trs"]))
    last = torch.as_tensor(inputs["last"])
    adv, ret = alg.compute_gae(trs, env.shard.take(last) if env.shard else last)
    m = alg.ppo_update(ts, trs, take(torch.as_tensor(inputs["adv"])),
                       take(torch.as_tensor(inputs["ret"])), torch.as_tensor(inputs["perm"]))
    return dict(adv=adv, ret=ret, metrics=ssinfogail.metrics_to_host(m), lr=float(ts.lr_ac),
                ac=host(ts.ac.state_dict()), est=host(ts.est.state_dict()),
                disc=host(ts.disc.state_dict()))


def bbc_runner(log_dir, kw=BBC_KW, num_envs=BBC_ENVS):
    env = Go2LocomotionEnv(bbc_config.smoke_cfg(num_envs), "cpu", seed=1,
                           shard=shard_of(num_envs))
    return OnPolicyRunner(env, ssinfogail.AlgoCfg(**kw), log_dir=log_dir, seed=0)


def runner_state(r):
    """A BBC runner's resumable state as host tensors: the rank's env rows,
    the replicated parameters, ring, generator states and iteration."""
    return dict(sim=host(r.env_state.sim), episode_length=host(r.env_state.episode_length),
                disc_hist=host(r.disc_hist), params=params(r.train_state.ac, r.train_state.est,
                                                           r.train_state.disc),
                ring=host(r.train_state.ring.data), ring_size=r.train_state.ring.size,
                gen=(host(r.alg.gen.get_state()), host(r.env.gen.get_state())),
                iteration=r.current_iteration)


def train_and_save(log_dir, iters=1):
    """A BBC runner that learns `iters` iterations and saves its exact-resume
    state into `log_dir`; returns its state."""
    torch.set_num_threads(1)
    r = bbc_runner(log_dir)
    r.learn(iters, log_every=1)
    return runner_state(r)


def load_from(log_dir, path_dir):
    """A fresh BBC runner (logging into `log_dir`) resumed from the newest
    checkpoint of `path_dir`; returns its state."""
    torch.set_num_threads(1)
    r = bbc_runner(log_dir)
    r.load(ckpt.latest(path_dir))
    return runner_state(r)


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _stage_inputs(alg, ts, es):
    """(transitions, last values) of iteration 0's rollout from `es`, and
    the draws of its stages."""
    dh = es.disc_obs[:, None].repeat(1, alg.env.cfg.env.disc_obs_len, 1)
    if isinstance(alg, ssinfogail.SSInfoGAIL):
        draws = alg.draw(ts)
        es = es._replace(prior_parameters=ts.prior_parameters)
        es, _, trs, _ = alg.rollout(ts, es, dh, True, draws.action_noise)
    else:
        draws = alg.draw()
        es, _, trs, _ = alg.rollout(ts, es, dh, True, draws.gumbel, draws.normal)
    with torch.no_grad():
        last = ts.ac.value(es.obs_buf)
    return dict(trs=host(trs), last=host(last), draws=host(draws))


def stages(device, cfg, kw, bbc_path=None, inputs=None):
    """Iteration 0's update stages on one rollout: GAE, PPO, (the BBC's)
    disc update, DAgger.  Without `inputs` (one process) the rollout runs
    here, from a fresh env and train state of `cfg` (a Go2LocomotionCfg or
    a Go2AgilityCfg, the TSC's under the frozen BBC of `bbc_path`), and is
    returned as `inputs` with the ring it filled and the draws; with them
    (a rank of a group) the stages run on the rank's envs of those inputs
    from the same fresh train state.  Returns (the normalised advantages'
    rows, the parameter groups after each stage, the metrics), inputs."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    shard = shard_of(cfg.env.num_envs)
    if isinstance(cfg, tsc_config.Go2AgilityCfg):
        env = Go2AgilityEnv(cfg, device, seed=0, shard=shard)
        alg = ppo_tsc.TscPPO(env, ckpt.load_bbc_frozen(bbc_path, seed=0),
                             ppo_tsc.TscAlgoCfg(**kw), seed=0)
        nets = ("ac", "est")
    else:
        env = Go2LocomotionEnv(cfg, device, seed=1, shard=shard)
        alg = ssinfogail.SSInfoGAIL(env, ssinfogail.AlgoCfg(**kw), seed=0)
        nets = ("ac", "est", "disc")
    ts = alg.init_train_state()
    if inputs is None:
        inputs = _stage_inputs(alg, ts, env.init_state())
        if "disc" in nets:
            inputs["ring"] = host(ts.ring.state_dict())
    if "disc" in nets:
        ts.ring.load_state_dict(inputs["ring"])
    take = (lambda x, dim=0: shard.take(x, dim)) if shard else (lambda x, dim=0: x)
    trs = (ssinfogail.Transition if "disc" in nets else ppo_tsc.TscTransition)(
        **{k: take(_to(v, device), 1) for k, v in inputs["trs"].items()})
    draws = {k: _to(v, device) for k, v in inputs["draws"].items()}
    adv, ret = alg.compute_gae(trs, take(_to(inputs["last"], device)))
    after, metrics = {}, {}
    metrics.update(alg.ppo_update(ts, trs, adv, ret, draws["ppo_perm"]))
    after["ppo"] = param_groups(ts, nets)
    if "disc" in nets:
        metrics.update(alg.disc_update(ts, draws["disc_idx"]))
        after["disc"] = param_groups(ts, nets)
    alg.dagger_update(ts, trs, draws["dagger_perm"])
    after["dagger"] = param_groups(ts, nets)
    return dict(adv=host(adv), after=after, metrics=ssinfogail.metrics_to_host(metrics)), inputs
