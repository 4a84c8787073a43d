"""SSInfoGAIL: PPO with semi-supervised InfoGAIL mocap imitation, in
PyTorch (counterpart of agility_tpu/learn/ssinfogail.py).

One `train_iteration` runs a T-step rollout through the env with the
discriminator reward, GAE, the PPO minibatch updates with the adaptive-KL
learning rate, the discriminator's minibatch updates over the policy replay
ring and the labelled / unlabelled expert tables, and, every
`dagger_update_freq` iterations, the DAgger update of the history encoder.

The JAX package threads parameter trees through pure functions; here the
`TrainState` holds the modules, their optimisers and the device tensors, and
the updates change it in place.  Every random draw comes from the trainer's
own generator on the device: `draw` makes one iteration's draws (`Draws`)
up front, and `train_iteration` and each stage also take them as an
argument, so that a test can feed the JAX package's draws.

The optimisers follow optax: the gradients are clipped to a global norm
(scaled by max / norm only where the norm exceeds max) before Adam; the
discriminator's three AdamW optimisers (decoupled decay on every parameter
of their subsets, biases included) share its trunk and step in turn on one
set of gradients, each on the parameters the previous one left.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from agility_tpu_torch.dist import mesh
from agility_tpu_torch.envs import mocap as mocap_mod
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv, LocoState
from agility_tpu_torch.learn import networks as nets
from agility_tpu_torch.learn.replay import Ring


@dataclasses.dataclass(frozen=True)
class AlgoCfg:
    # go2_locomotion_config.py:196-225 + base LeggedRobotCfgAlgo
    lr_ac: float = 1e-3
    lr_disc: float = 5e-4
    lr_q: float = 1e-3
    lr_estimator: float = 1e-4
    surrogate_loss_coef: float = 2.0
    value_loss_coef: float = 5.0
    entropy_coef: float = 0.01
    bounds_loss_coef: float = 0.0
    disc_coef: float = 1.0
    disc_logit_reg: float = 0.05
    disc_grad_penalty: float = 0.1
    disc_weight_decay: float = 0.0001
    disc_adam_weight_decay: float = 1e-3
    disc_replay_buffer_size: int = 1_000_000
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    clip_param: float = 0.2
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    lr_schedule: str = "adaptive"   # "adaptive" (KL-tracking LR, gail.py:367-379);
    #                                 the JAX package's "fixed" is not ported
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True
    us_coef: float = 1.0
    ss_coef: float = 1.0
    prior_soft_coef: float = 1e-3
    info_max_coef: float = 1.0
    begin_rim: int = 200
    disc_loss_function: str = "MSELoss"   # the only one ported
    priv_reg_coef_schedule: Tuple[float, float, float, float] = (0, 0.1, 1000, 2000)
    num_steps_per_env: int = 24
    dagger_update_freq: int = 20
    num_preload_transitions: int = 200_000
    # reward mix (runner cfg :238-241)
    reward_i_coef: float = 1.0
    reward_us_coef: float = 0.01
    reward_ss_coef: float = 0.2
    reward_t_coef: float = 0.2
    min_normalized_std: Tuple[float, ...] = (0.05, 0.02, 0.05) * 4


@dataclasses.dataclass
class TrainState:
    ac: nets.ActorCritic
    est: nets.Estimator
    disc: nets.Discriminator
    ac_opt: torch.optim.Adam        # the actor-critic, lr set per minibatch
    hist_opt: torch.optim.Adam      # the history encoder only (DAgger)
    est_opt: torch.optim.Adam
    disc_opt_d: torch.optim.AdamW   # trunk + logit head
    disc_opt_qe: torch.optim.AdamW  # trunk + eps head
    disc_opt_qc: torch.optim.AdamW  # trunk + classifier head
    disc_norm: nets.RunningNormalizer
    ring: Ring
    prior_parameters: torch.Tensor  # (C,)
    lr_ac: np.float32               # the adaptive-KL learning rate, carried
    task_obs_weight: np.float32     # decays 1 -> 0
    learning_steps: int             # disc updates done
    priv_reg_counter: int           # disc + DAgger updates done


class Transition(NamedTuple):
    """One rollout, (T, N, ...) tensors; critic_obs is obs (one tensor)."""
    obs: torch.Tensor
    critic_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_prob: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor


class Draws(NamedTuple):
    """One iteration's random draws."""
    action_noise: torch.Tensor   # (T, N, A) unit normals, one per rollout step
    ppo_perm: torch.Tensor       # (T * N,) minibatch permutation, reused every epoch
    disc_idx: torch.Tensor       # (n_mb, 3, mb): ring rows, labelled, unlabelled expert rows
    dagger_perm: torch.Tensor    # (T * N,)


def clip_grad_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the parameters' gradients, in place:
    g -> (g / norm) * max_norm where norm >= max_norm, else g."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@torch.no_grad()
def compute_gae(rewards, dones, values, last_values, gamma: float, lam: float,
                shard: Optional[mesh.EnvShard] = None):
    """(normalised advantages, returns) of a (T, N) rollout
    (rollout_storage.py:97-111); the advantages' std is the population one.
    With `shard` the rollout is the rank's envs, and the mean and the std
    (two passes) are those of every rank's advantages."""
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    advantages = torch.empty_like(values)
    adv = torch.zeros_like(last_values)
    for t in reversed(range(values.shape[0])):
        not_done = 1.0 - dones[t].float()
        delta = rewards[t] + not_done * gamma * next_values[t] - values[t]
        adv = delta + not_done * gamma * lam * adv
        advantages[t] = adv
    returns = advantages + values
    if shard is None:
        mean, std = advantages.mean(), advantages.std(correction=0)
    else:
        n = advantages.numel() * shard.world
        mean = mesh.all_reduce_(advantages.sum()[None])[0] / n
        std = torch.sqrt(mesh.all_reduce_(torch.square(advantages - mean).sum()[None])[0] / n)
    advantages = (advantages - mean) / (std + 1e-8)
    return advantages, returns


def adapt_lr(lr: np.float32, kl_mean: float, desired_kl: float) -> np.float32:
    """The adaptive-KL learning rate (gail.py:367-379), in float32: /1.5
    above twice the target KL (not below 1e-5), x1.5 below half of it (not
    above 1e-2)."""
    if kl_mean > desired_kl * 2.0:
        lr = max(np.float32(1e-5), lr / np.float32(1.5))
    if desired_kl / 2.0 > kl_mean > 0.0:
        lr = min(np.float32(1e-2), lr * np.float32(1.5))
    return np.float32(lr)


def priv_reg_coef(schedule, counter: int) -> float:
    """The priv-reg coefficient (gail.py:350-357) of schedule (begin, end,
    start, span): clamp((counter - start) / span, 0, 1) x (end - begin) +
    begin, in float32."""
    stage = min(max(np.float32(counter) - np.float32(schedule[2]), np.float32(0.0))
                / np.float32(schedule[3]), np.float32(1.0))
    return float(np.float32(stage * np.float32(schedule[1] - schedule[0])
                            + np.float32(schedule[0])))


class SSInfoGAIL:
    def __init__(self, env: Go2LocomotionEnv, cfg: AlgoCfg = AlgoCfg(), seed: int = 1):
        # the JAX trainer's other loss functions and its fixed learning rate
        # are not ported: no configuration of the repo selects them
        if cfg.disc_loss_function != "MSELoss" or cfg.lr_schedule != "adaptive":
            raise NotImplementedError(
                f"disc_loss_function={cfg.disc_loss_function!r}, "
                f"lr_schedule={cfg.lr_schedule!r}: the port trains with MSELoss and the "
                "adaptive-KL learning rate only")
        self.env = env
        self.cfg = cfg
        self.device = env.device
        # env.shard (dist/mesh.py): this rank's envs of the global batch
        self.shard = env.shard
        ecfg = env.cfg.env
        self.slices = nets.ObsSlices(ecfg.num_prop, ecfg.num_explicit, ecfg.num_latent,
                                     ecfg.history_len, ecfg.num_command)
        self.dim_c = env.dim_c
        self.num_actions = ecfg.num_actions
        self.num_disc_obs = ecfg.num_obs_disc
        self.disc_obs_len = ecfg.disc_obs_len
        self.disc_in = self.num_disc_obs * self.disc_obs_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # called with a stage's name after it is enqueued (a timer may record
        # CUDA events there; the runner adds "end" after an iteration's
        # logging and saves); None does nothing
        self.timer = None

        # initial parameters, drawn from the trainer's generator
        self._ac0 = nets.flax_init_(
            nets.ActorCritic(self.slices, num_actions=ecfg.num_actions).to(self.device), self.gen)
        self._est0 = nets.flax_init_(
            nets.Estimator(ecfg.num_prop, ecfg.num_explicit).to(self.device), self.gen)
        self._disc0 = nets.flax_init_(
            nets.Discriminator(self.disc_in, self.dim_c).to(self.device), self.gen)

        # min-std clamp vector (runner :99-101)
        self.min_std = (torch.tensor(cfg.min_normalized_std, device=self.device)
                        * torch.abs(env.soft_dof_upper - env.soft_dof_lower))

        # expert preload tables (runner MotionLoader(num_preload=200k))
        self.expert_lb, self.expert_labels = self._preload(True)
        self.expert_ulb, _ = self._preload(False)

    def _preload(self, labeled: bool):
        env = self.env
        frames, labels = env.motion.sample_transition_frames(
            self.gen, self.cfg.num_preload_transitions, env.dt, labeled, self.disc_obs_len)
        return self.expert_features(frames), labels

    def expert_features(self, frames):
        """(L, n, 49) expert frame stacks -> (n, L * 49) disc features."""
        env = self.env
        osc = env.cfg.normalization.obs_scales
        return torch.cat([mocap_mod.disc_obs_from_frames(f, env.mc.default_dof_pos, osc)
                          for f in frames], dim=-1)

    # ------------------------------------------------------------------

    def init_train_state(self) -> TrainState:
        cfg = self.cfg
        N = self.env.num_envs_global    # the ring is replicated: every rank's rows
        ac, est, disc = (copy.deepcopy(m) for m in (self._ac0, self._est0, self._disc0))
        awd = cfg.disc_adam_weight_decay

        def disc_opt(lr, head):
            return torch.optim.AdamW([*disc.trunk.parameters(), *head.parameters()], lr=lr,
                                     weight_decay=awd)

        return TrainState(
            ac=ac, est=est, disc=disc,
            ac_opt=torch.optim.Adam(ac.parameters(), lr=cfg.lr_ac),
            hist_opt=torch.optim.Adam(ac.history_encoder.parameters(), lr=cfg.lr_estimator),
            est_opt=torch.optim.Adam(est.parameters(), lr=cfg.lr_estimator),
            disc_opt_d=disc_opt(cfg.lr_disc, disc.head_logit),
            disc_opt_qe=disc_opt(cfg.lr_q, disc.head_eps),
            disc_opt_qc=disc_opt(cfg.lr_q, disc.head_classifier),
            disc_norm=nets.RunningNormalizer(self.disc_in, self.device),
            ring=Ring((cfg.disc_replay_buffer_size // N) * N, self.disc_in + 1 + self.dim_c,
                      self.device),
            prior_parameters=torch.full((self.dim_c,), 1.0 / self.dim_c, device=self.device),
            task_obs_weight=np.float32(1.0), lr_ac=np.float32(cfg.lr_ac),
            learning_steps=0, priv_reg_counter=0)

    def disc_sizes(self) -> Tuple[int, int]:
        """(minibatches, rows a minibatch) of one discriminator update."""
        cfg = self.cfg
        n_mb = cfg.num_learning_epochs * cfg.num_mini_batches * 4
        return n_mb, max(1, cfg.num_steps_per_env * self.env.num_envs_global // n_mb)

    def draw(self, ts: TrainState) -> Draws:
        """One iteration's draws from the trainer's generator; the ring rows
        are uniform over the rows it will hold after the rollout.  The
        permutations run over the global (T x N) rollout."""
        T, N = self.cfg.num_steps_per_env, self.env.num_envs_global
        return Draws(self._noise(), self._perm(T * N),
                     self._disc_idx(min(ts.ring.size + T * N, ts.ring.capacity)),
                     self._perm(T * N))

    def _noise(self):
        """(T, N, A) unit normals, drawn at the global N, the rank's envs taken."""
        shape = (self.cfg.num_steps_per_env, self.env.num_envs_global, self.num_actions)
        noise = torch.randn(shape, generator=self.gen, device=self.device)
        return self.shard.take(noise, 1) if self.shard else noise

    def _perm(self, n: int):
        return torch.randperm(n, generator=self.gen, device=self.device)

    def _disc_idx(self, ring_size: int):
        """(n_mb, 3, mb) rows of the ring (uniform over max(size, 1)), the
        labelled and the unlabelled expert tables."""
        n_mb, mb = self.disc_sizes()
        return torch.stack([torch.randint(0, hi, (n_mb, mb), generator=self.gen,
                                          device=self.device)
                            for hi in (max(ring_size, 1), self.expert_lb.shape[0],
                                       self.expert_ulb.shape[0])], dim=1)

    # ------------------------------------------------------------------
    # discriminator reward (reference discriminator.py:71-118)
    # ------------------------------------------------------------------

    def _apply_task_weight(self, x_frames, w):
        """Scale disc-obs columns 3:9 and 33: of every frame by the task-obs
        weight.  x_frames: (B, L, 49)."""
        if not self.env.cfg.normalization.task_obs_weight_decay:
            return x_frames
        scale = torch.ones(self.num_disc_obs, device=x_frames.device)
        scale[3:9] = float(w)
        scale[33:] = float(w)
        return x_frames * scale

    def _disc_input(self, ts: TrainState, x):
        """(B, L*49) raw features -> task-weighted features."""
        B = x.shape[0]
        return self._apply_task_weight(
            x.reshape(B, self.disc_obs_len, self.num_disc_obs), ts.task_obs_weight).reshape(B, -1)

    def disc_reward(self, ts: TrainState, obs, disc_hist, task_reward):
        """(total, r_i, r_us, r_ss) of a step, from the disc window (N, L, 49)."""
        cfg = self.cfg
        C = self.dim_c
        label_eps = obs[:, -C - 1:-C]
        label_c = F.one_hot(torch.argmax(obs[:, -C:], dim=-1), C).to(obs.dtype)
        x = self._apply_task_weight(disc_hist, ts.task_obs_weight).reshape(disc_hist.shape[0], -1)
        d, eps, c = ts.disc(ts.disc_norm.normalize(x))
        r_i = torch.clamp(1.0 - 0.25 * torch.square(d[:, 0] - 1.0), min=0.0)   # MSELoss
        r_us = -torch.abs(eps[:, 0] - label_eps[:, 0])
        r_ss = torch.sum(label_c * torch.log(c), dim=-1)   # -CE
        dt = self.env.dt
        r_i, r_us, r_ss = r_i * dt, r_us * dt, r_ss * dt
        total = (cfg.reward_i_coef * r_i + cfg.reward_us_coef * r_us
                 + cfg.reward_ss_coef * r_ss + cfg.reward_t_coef * task_reward)
        return total, r_i, r_us, r_ss

    # ------------------------------------------------------------------
    # rollout
    # ------------------------------------------------------------------

    @torch.no_grad()
    def rollout(self, ts: TrainState, es: LocoState, disc_hist, hist_encoding: bool,
                action_noise=None):
        """T-step on-policy rollout; inserts the policy side's disc rows into
        the ring (every rank's, under a shard).  Returns (env state, disc
        window, Transition, metrics); the metrics are over every rank's
        envs."""
        cfg = self.cfg
        s = self.slices
        T, N = cfg.num_steps_per_env, self.env.num_envs
        if action_noise is None:
            action_noise = self._noise()
        dev = self.device
        obs_all = torch.empty((T, N, s.total), device=dev)
        acts_all = torch.empty((T, N, self.num_actions), device=dev)
        mean_all = torch.empty_like(acts_all)
        rew_all, val_all, logp_all = (torch.empty((T, N), device=dev) for _ in range(3))
        done_all = torch.empty((T, N), dtype=torch.bool, device=dev)
        steps = []
        std = ts.ac.std.detach().clone()   # the PPO update changes the parameter in place
        for t in range(T):
            obs = es.obs_buf
            # estimator swap-in for acting (gail.py:182-186)
            obs_est = obs.clone()
            obs_est[:, s.explicit] = ts.est(obs[:, s.prop])
            mean = ts.ac.action_mean(obs_est, hist_encoding)
            actions = mean + std * action_noise[t]
            logp = nets.gaussian_log_prob(mean, std, actions)
            values = ts.ac.value(obs)

            es2, out = self.env.step(es, actions)

            # disc-obs window with terminal patching (runner :166-181)
            patched = torch.where(out.reset[:, None], out.terminal_disc_obs, out.disc_obs)
            disc_hist2 = torch.cat([disc_hist[:, 1:], patched[:, None]], dim=1)
            total_r, r_i, r_us, r_ss = self.disc_reward(ts, obs, disc_hist2, out.rew)
            # time-out bootstrap (gail.py:203-205)
            total_r = total_r + cfg.gamma * values * out.time_out

            rows = torch.cat([disc_hist2.reshape(N, -1), es2.latent_eps, es2.latent_c], dim=-1)
            ts.ring.insert(mesh.gather_rows(rows, self.shard) if self.shard else rows)
            # after the insert, reset envs restart the window from the fresh obs
            disc_hist = torch.where(out.reset[:, None, None],
                                    out.disc_obs[:, None].expand(-1, self.disc_obs_len, -1),
                                    disc_hist2)

            obs_all[t], acts_all[t], mean_all[t] = obs, actions, mean
            rew_all[t], val_all[t], logp_all[t], done_all[t] = total_r, values, logp, out.reset
            # exploit detector (physics/debug.py speed_gate): sustained
            # overspeed means an energy leak, not locomotion
            speed = torch.linalg.vector_norm(es2.sim.u[:, :3], dim=-1)
            steps.append(torch.stack([r_i.sum(), r_us.sum(), r_ss.sum(), out.rew.sum(),
                                      total_r.sum(), out.reset.sum().float(),
                                      (speed > 8.0).float().sum(), speed.max()]))
            es = es2
        per_step = env_reduce(torch.stack(steps), self.shard)
        names = ("r_i", "r_us", "r_ss", "r_t", "r_total", "ep_done", "overspeed", "max_speed")
        metrics = dict(zip(names, per_step.mean(dim=0) / self.env.num_envs_global))
        metrics["ep_done"] = per_step[:, 5].sum()
        metrics["max_speed"] = per_step[:, 7].max()
        trs = Transition(obs=obs_all, critic_obs=obs_all, actions=acts_all, rewards=rew_all,
                         dones=done_all, values=val_all, log_prob=logp_all, mean=mean_all,
                         std=std.expand_as(mean_all))
        return es, disc_hist, trs, metrics

    # ------------------------------------------------------------------
    # GAE (rollout_storage.py:97-111)
    # ------------------------------------------------------------------

    def compute_gae(self, trs: Transition, last_values):
        return compute_gae(trs.rewards, trs.dones, trs.values, last_values, self.cfg.gamma,
                           self.cfg.lam, self.shard)

    # ------------------------------------------------------------------
    # PPO update (gail.py:328-413)
    # ------------------------------------------------------------------

    def ppo_update(self, ts: TrainState, trs: Transition, advantages, returns, perm=None):
        """The PPO minibatch updates.  `perm` runs over the global (T x N)
        rollout; under a shard each rank takes the minibatch's rows it holds,
        every loss is its rows' sum over the global minibatch size, and the
        gradients, the KL and the metrics are summed across ranks before
        each step."""
        cfg = self.cfg
        s = self.slices
        T, N = trs.rewards.shape
        n_mb = cfg.num_mini_batches
        mb = T * self.env.num_envs_global // n_mb
        if perm is None:
            perm = self._perm(T * self.env.num_envs_global)
        flat = Transition(*(x.reshape((T * N,) + x.shape[2:]) for x in trs))
        adv_f, ret_f = advantages.reshape(-1), returns.reshape(-1)
        rows = mesh.minibatch_rows(perm, n_mb, mb, self.shard)

        coef = priv_reg_coef(cfg.priv_reg_coef_schedule, ts.priv_reg_counter)

        ac, est = ts.ac, ts.est
        ac_params = list(ac.parameters())
        est_params = list(est.parameters())
        lr = ts.lr_ac
        outs = []
        for i in range(cfg.num_learning_epochs * n_mb):
            idx = rows[i % n_mb]
            obs, actions = flat.obs[idx], flat.actions[idx]
            old_values, old_logp = flat.values[idx], flat.log_prob[idx]
            old_mean, old_std = flat.mean[idx], flat.std[idx]
            mb_adv, mb_ret = adv_f[idx], ret_f[idx]

            # estimator loss (its own Adam)
            ts.est_opt.zero_grad(set_to_none=True)
            el = torch.sum(torch.square(est(obs[:, s.prop]) - obs[:, s.explicit])) / (
                mb * s.num_explicit)
            el.backward()

            ts.ac_opt.zero_grad(set_to_none=True)
            mean = ac.action_mean(obs, hist_encoding=False)
            std = ac.std
            logp = nets.gaussian_log_prob(mean, std, actions)
            value = ac.value(obs)
            entropy = torch.sum(nets.gaussian_entropy(std.expand_as(mean))) / mb

            ratio = torch.exp(logp - old_logp)
            surr = -mb_adv * ratio
            surr_cl = -mb_adv * torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param)
            surrogate_loss = torch.sum(torch.maximum(surr, surr_cl)) / mb
            if cfg.use_clipped_value_loss:
                v_cl = old_values + torch.clamp(value - old_values, -cfg.clip_param,
                                                cfg.clip_param)
                value_loss = torch.sum(torch.maximum(torch.square(value - mb_ret),
                                                     torch.square(v_cl - mb_ret))) / mb
            else:
                value_loss = torch.sum(torch.square(mb_ret - value)) / mb
            # bound loss (soft bound 1.0)
            b_loss = torch.sum(torch.square(torch.clamp(mean - 1.0, min=0.0))
                               + torch.square(torch.clamp(mean + 1.0, max=0.0))) / mb
            # priv-reg latent regularisation
            priv_lat = ac.priv_latent(obs)
            with torch.no_grad():
                hist_lat = ac.hist_latent(obs)
            priv_reg_loss = torch.sum(torch.linalg.vector_norm(priv_lat - hist_lat, dim=-1)) / mb
            loss = (cfg.surrogate_loss_coef * surrogate_loss
                    + cfg.value_loss_coef * value_loss
                    + cfg.bounds_loss_coef * b_loss
                    - cfg.entropy_coef * entropy
                    + coef * priv_reg_loss)
            loss.backward()

            # adaptive KL LR (gail.py:367-379): the pre-update policy of this
            # minibatch against the rollout's, set before this step
            with torch.no_grad():
                m, sd = mean.detach(), std.detach()
                kl = torch.sum(torch.log(sd / old_std + 1e-5)
                               + (torch.square(old_std) + torch.square(old_mean - m))
                               / (2.0 * torch.square(sd)) - 0.5, dim=-1)
                stats = torch.stack([loss, el, torch.sum(kl) / mb, surrogate_loss, value_loss,
                                     entropy, priv_reg_loss]).detach()
            if self.shard is not None:
                stats = mesh.all_reduce_grads_(est_params + ac_params, stats)
            clip_grad_global_norm_(est_params, cfg.max_grad_norm)
            ts.est_opt.step()
            lr = adapt_lr(lr, float(stats[2]), cfg.desired_kl)
            for group in ts.ac_opt.param_groups:
                group["lr"] = float(lr)
            clip_grad_global_norm_(ac_params, cfg.max_grad_norm)
            ts.ac_opt.step()
            outs.append(stats)
        ts.lr_ac = lr
        names = ("loss", "est", "kl", "surrogate", "value", "entropy", "priv_reg")
        metrics = {f"ppo/{k}": v for k, v in zip(names, torch.stack(outs).mean(dim=0))}
        metrics["ppo/lr"] = torch.tensor(float(lr), device=self.device)
        return metrics

    # ------------------------------------------------------------------
    # discriminator update (gail.py:415-541)
    # ------------------------------------------------------------------

    def disc_update(self, ts: TrainState, idx=None):
        """`idx`: (n_mb, 3, mb) rows of the ring, the labelled and the
        unlabelled expert tables for each minibatch."""
        cfg = self.cfg
        C = self.dim_c
        n_mb, mb = self.disc_sizes()
        if idx is None:
            idx = self._disc_idx(ts.ring.size)
        info_max_on = float(min(
            np.float32(cfg.info_max_coef)
            * max(np.float32(ts.learning_steps) + np.float32(1) - np.float32(cfg.begin_rim),
                  np.float32(0.0)) / np.float32(10000.0),
            np.float32(cfg.info_max_coef)))
        disc, norm = ts.disc, ts.disc_norm
        opts = (ts.disc_opt_d, ts.disc_opt_qe, ts.disc_opt_qc)
        prior = ts.prior_parameters
        outs = []
        for i in range(n_mb):
            pol_rows = ts.ring.sample(idx[i, 0])
            pol_x = pol_rows[:, :self.disc_in]
            pol_eps = pol_rows[:, self.disc_in:self.disc_in + 1]
            pol_c = pol_rows[:, self.disc_in + 1:]
            exp_lb_label = self.expert_labels[idx[i, 1]]
            pol_x, exp_lb_x, exp_ulb_x = (
                self._disc_input(ts, x) for x in (pol_x, self.expert_lb[idx[i, 1]],
                                                  self.expert_ulb[idx[i, 2]]))
            pol_xn, exp_lb_xn = norm.normalize(pol_x), norm.normalize(exp_lb_x)
            exp_ulb_xn = norm.normalize(exp_ulb_x).requires_grad_(True)

            for opt in opts:
                opt.zero_grad(set_to_none=True)
            _, _, pred_c_lb = disc(exp_lb_xn)
            ss_loss = -torch.mean(torch.sum(F.one_hot(exp_lb_label, C) * torch.log(pred_c_lb),
                                            dim=-1))
            logits_pi, eps, pred_c = disc(pol_xn)
            logits_exp, _, pred_c_ulb = disc(exp_ulb_xn)
            info_max_loss = torch.mean(-torch.sum(pred_c_ulb * torch.log(pred_c_ulb + 1e-20),
                                                  dim=-1))
            disc_exp_loss = torch.mean(torch.square(logits_exp - 1.0))   # MSELoss
            disc_pi_loss = torch.mean(torch.square(logits_pi + 1.0))
            disc_loss = 0.5 * (disc_pi_loss + disc_exp_loss)
            us_loss = torch.mean(torch.abs(eps - pol_eps))
            logit_w = disc.head_logit.weight
            disc_logit_loss = torch.sum(torch.square(logit_w))
            # R1-style gradient penalty on the unlabelled expert samples, a
            # second-order gradient through the normalised input
            g, = torch.autograd.grad(logits_exp.sum(), exp_ulb_xn, create_graph=True)
            grad_pen = torch.mean(torch.sum(torch.square(g), dim=-1))
            weight_decay = sum(torch.sum(torch.square(w))
                               for w in (disc.trunk[0].weight, disc.trunk[1].weight, logit_w))
            loss = (cfg.ss_coef * ss_loss + info_max_on * info_max_loss
                    + cfg.disc_coef * disc_loss + cfg.us_coef * us_loss
                    + cfg.disc_grad_penalty * grad_pen
                    + cfg.disc_logit_reg * disc_logit_loss
                    + cfg.disc_weight_decay * weight_decay)
            loss.backward()
            # three optimisers in turn on the same gradients
            for opt in opts:
                opt.step()

            with torch.no_grad():
                prior = (pred_c_ulb.mean(dim=0) * cfg.prior_soft_coef
                         + prior * (1 - cfg.prior_soft_coef))
                # running statistics of the raw (pre-normalised) features
                for x in (pol_x, exp_lb_x, exp_ulb_x):
                    norm.update(x)
                outs.append(torch.stack([
                    ss_loss, info_max_loss, disc_loss, us_loss, grad_pen, disc_logit_loss,
                    weight_decay,
                    (torch.argmax(pred_c_lb, -1) == exp_lb_label).float().mean(),
                    (logits_pi < 0).float().mean(), (logits_exp > 0).float().mean(),
                    (torch.argmax(pred_c, -1) == torch.argmax(pol_c, -1)).float().mean(),
                    loss]).detach())

        # min-std clamp (gail.py:522-523)
        with torch.no_grad():
            ts.ac.std.copy_(torch.maximum(ts.ac.std, self.min_std))
        ts.prior_parameters = prior
        ts.learning_steps += 1
        ts.priv_reg_counter += 1
        names = ("ss", "info_max", "disc", "us", "grad_pen", "logit", "wd", "acc_lb", "acc_pi",
                 "acc_exp", "acc_ulb", "loss")
        return {f"disc/{k}": v for k, v in zip(names, torch.stack(outs).mean(dim=0))}

    # ------------------------------------------------------------------
    # DAgger history-encoder update (gail.py:543-575)
    # ------------------------------------------------------------------

    def dagger_update(self, ts: TrainState, trs: Transition, perm=None):
        """The history encoder toward the privileged latent, over the
        minibatches of `perm` (global, as in ppo_update)."""
        cfg = self.cfg
        T, N = trs.rewards.shape
        n_mb = cfg.num_mini_batches
        mb = T * self.env.num_envs_global // n_mb
        if perm is None:
            perm = self._perm(T * self.env.num_envs_global)
        rows = mesh.minibatch_rows(perm, n_mb, mb, self.shard)
        losses = dagger_minibatches(ts.ac, ts.hist_opt, trs.obs.reshape(T * N, -1), rows, mb,
                                    cfg.num_learning_epochs, cfg.max_grad_norm, self.shard)
        ts.priv_reg_counter += 1
        return {"dagger/hist_latent": losses.mean()}

    # ------------------------------------------------------------------
    # one full training iteration
    # ------------------------------------------------------------------

    def mark(self, stage: str) -> None:
        """Hand the timer a stage's name, once its work is enqueued."""
        if self.timer is not None:
            self.timer(stage)

    def train_iteration(self, ts: TrainState, es: LocoState, disc_hist, it: int,
                        draws: Optional[Draws] = None):
        """One iteration: rollout -> GAE -> PPO -> disc -> (DAgger) -> the
        task-obs weight decay.  Returns (ts, env state, disc window, metrics);
        `ts` is updated in place."""
        hist_encoding = it % self.cfg.dagger_update_freq == 0
        self.mark("start")
        if draws is None:
            draws = self.draw(ts)
            self.mark("draw")
        # the env's prior follows the learner's EMA
        es = es._replace(prior_parameters=ts.prior_parameters)
        es, disc_hist, trs, roll_m = self.rollout(ts, es, disc_hist, hist_encoding,
                                                  draws.action_noise)
        self.mark("rollout")
        with torch.no_grad():
            last_values = ts.ac.value(es.obs_buf)
        advantages, returns = self.compute_gae(trs, last_values)
        self.mark("gae")
        ppo_m = self.ppo_update(ts, trs, advantages, returns, draws.ppo_perm)
        self.mark("ppo")
        disc_m = self.disc_update(ts, draws.disc_idx)
        self.mark("disc")
        if hist_encoding:
            self.dagger_update(ts, trs, draws.dagger_perm)
            self.mark("dagger")
        # task-obs weight decay (runner :224-225)
        ncfg = self.env.cfg.normalization
        if ncfg.task_obs_weight_decay and ncfg.task_obs_weight_decay_steps:
            ts.task_obs_weight = np.float32(max(
                np.float32(0.0),
                ts.task_obs_weight - np.float32(1.0 / ncfg.task_obs_weight_decay_steps)))
        metrics = {**{f"rollout/{k}": v for k, v in roll_m.items()}, **ppo_m, **disc_m}
        return ts, es, disc_hist, metrics


def env_reduce(per_step: torch.Tensor, shard: Optional[mesh.EnvShard]) -> torch.Tensor:
    """A rollout's (T, k) per-step reductions over the rank's envs, the
    last column a max and the others sums, reduced over every rank's
    envs (unchanged without a shard)."""
    if shard is None:
        return per_step
    sums, mx = per_step[:, :-1].contiguous(), per_step[:, -1].contiguous()
    mesh.all_reduce_(sums)
    mesh.all_reduce_(mx, "max")
    return torch.cat([sums, mx[:, None]], dim=1)


def dagger_minibatches(ac, opt, obs_flat, rows, mb: int, epochs: int, max_grad_norm: float,
                       shard: Optional[mesh.EnvShard]) -> torch.Tensor:
    """DAgger's minibatch steps (gail.py:543-575): each of `epochs` passes
    over the minibatches' `rows` of obs_flat moves the history encoder
    toward the privileged latent (the mean norm of their difference over
    the global minibatch of `mb` rows; gradients summed across ranks under
    a shard).  Returns each step's loss."""
    params = list(ac.history_encoder.parameters())
    losses = []
    for i in range(epochs * len(rows)):
        obs = obs_flat[rows[i % len(rows)]]
        opt.zero_grad(set_to_none=True)
        hist_lat = ac.hist_latent(obs)
        with torch.no_grad():
            priv_lat = ac.priv_latent(obs)
        loss = torch.sum(torch.linalg.vector_norm(priv_lat - hist_lat, dim=-1)) / mb
        loss.backward()
        total = loss.detach()[None]
        if shard is not None:
            total = mesh.all_reduce_grads_(params, total)
        clip_grad_global_norm_(params, max_grad_norm)
        opt.step()
        losses.append(total[0])
    return torch.stack(losses)


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as Python floats, with one device-to-host copy."""
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))
