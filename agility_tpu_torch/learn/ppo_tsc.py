"""TSC teacher training in PyTorch (counterpart of
agility_tpu/learn/ppo_tsc.py): hybrid-action PPO over the hierarchical env,
with the frozen BBC as the low level and the frozen BBC discriminator's
style reward.

One `train_iteration` runs a T-step rollout — the TSC estimator writes its
prediction into obs[:, explicit], the hybrid heads act on that observation
(through the history latent on DAgger iterations), env.set_commands turns
the action into BBC commands, the frozen BBC acts on the state's obs_bbc
with the fresh commands, env.step, and the reward mix 0.05 r_i + 2.0 r_t of
the frozen discriminator — then GAE, the PPO minibatch updates (in each
minibatch the estimator's Adam step first, then the actor-critic's, with
separate discrete and continuous clipped surrogates and the adaptive-KL
learning rate set from the continuous head's KL before the step), the
min-std clamp and, every `dagger_update_freq` iterations, the DAgger update
of the history encoder.

As in learn/ssinfogail.py the TscTrainState holds the modules and their
optimisers and the updates change it in place; every draw comes from the
trainer's generator (`draw`) or is handed in (`TscDraws`), so that a test
can feed the JAX package's draws.

The rollout stores the raw observation, not the one it acted on: PPO
recomputes the log-probs on the raw obs through the privileged latent, so
the first minibatch's ratio is not 1.  That is the reference's behaviour,
and it is kept.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from agility_tpu_torch import trace
from agility_tpu_torch.dist import mesh
from agility_tpu_torch.envs.go2_agility import AgilityState, Go2AgilityEnv
from agility_tpu_torch.learn import networks as nets
from agility_tpu_torch.learn import networks_tsc as tnets
from agility_tpu_torch.learn.policy_tsc import bbc_act
from agility_tpu_torch.learn.ssinfogail import (adapt_lr, clip_grad_global_norm_, compute_gae,
                                                 dagger_minibatches, env_reduce, priv_reg_coef)


@dataclasses.dataclass(frozen=True)
class TscAlgoCfg:
    # tsc config LeggedRobotCfgPPO :388-449
    learning_rate: float = 5e-4
    lr_estimator: float = 1e-4
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    clip_param: float = 0.2
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    num_steps_per_env: int = 24
    dagger_update_freq: int = 20
    priv_reg_coef_schedule: Tuple[float, float, float, float] = (0, 0.1, 500, 1000)
    # continuous-head exploration floor: the hybrid policy's learned std
    # collapses under the course's harshly negative advantage tail
    # (termination -50, collision -20 — observed round 4: entropy 2.1 ->
    # negative within 6k iterations, success EMA 0.055 -> 0.008).  The
    # reference manages this manually via reset_std on resume
    # (tsc task_registry.py:130, policy.continue_from_last_std); the BBC
    # stack's min-std clamp (gail.py:522-523) is the same mechanism —
    # applied here after each PPO update.  0 disables.
    min_std: float = 0.15
    # frozen-disc reward mix (runner cfg :443-449)
    reward_i_coef: float = 0.05
    reward_t_coef: float = 2.0
    disc_loss_function: str = "MSELoss"


class BBCFrozen(NamedTuple):
    """The frozen BBC's host state dicts (io/checkpoint.load_bbc_frozen):
    the BBC -> TSC weight handoff."""
    ac: Dict[str, torch.Tensor]          # networks.ActorCritic
    est: Dict[str, torch.Tensor]         # networks.Estimator, the TSC estimator's start
    disc: Dict[str, torch.Tensor]        # networks.Discriminator (98 in, 5 modes)
    disc_norm: Dict[str, torch.Tensor]   # its RunningNormalizer: mean, var, count


@dataclasses.dataclass
class TscTrainState:
    ac: tnets.ActorCriticTSC
    ac_opt: torch.optim.Adam        # the actor-critic, lr set per minibatch
    lr: np.float32                  # the adaptive-KL learning rate, carried
    hist_opt: torch.optim.Adam      # the history encoder only (DAgger)
    est: nets.Estimator
    est_opt: torch.optim.Adam
    priv_reg_counter: int           # PPO + DAgger updates done


class TscTransition(NamedTuple):
    """One rollout, (T, N, ...) tensors."""
    obs: torch.Tensor
    actions: torch.Tensor         # (T, N, 1 + D*C)
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    logp_d: torch.Tensor
    logp_c: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor


class TscDraws(NamedTuple):
    """One iteration's random draws."""
    gumbel: torch.Tensor        # (T, N, D) the discrete head's Gumbel noise, per rollout step
    normal: torch.Tensor        # (T, N, D*C) unit normals of the continuous head
    ppo_perm: torch.Tensor      # (T * N,) minibatch permutation, reused every epoch
    dagger_perm: torch.Tensor   # (T * N,)


class TscPPO:
    def __init__(self, env: Go2AgilityEnv, bbc: BBCFrozen, cfg: TscAlgoCfg = TscAlgoCfg(),
                 seed: int = 1):
        if cfg.disc_loss_function != "MSELoss":
            raise NotImplementedError(
                f"disc_loss_function={cfg.disc_loss_function!r}: the port's frozen-disc reward "
                "is the MSELoss one only")
        self.env = env
        self.cfg = cfg
        self.device = dev = env.device
        # env.shard (dist/mesh.py): this rank's envs of the global batch
        self.shard = env.shard
        e = env.cfg.env
        self.slices = tnets.TscObsSlices(e.n_proprio, e.n_scan, e.n_priv, e.n_priv_latent,
                                         e.history_len, e.n_auxiliary)
        self.num_d, self.num_c = e.num_actions_d, e.num_actions_d * e.num_actions_c
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        # called with a stage's name after it is enqueued (a timer may record
        # CUDA events there; the runner adds "end" after an iteration's
        # logging and saves); None does nothing
        self.timer = None

        self._ac0 = nets.flax_init_(
            tnets.ActorCriticTSC(self.slices, e.num_actions_d, e.num_actions_c).to(dev), self.gen)
        # the estimator starts from the BBC's (load_estimator_bbc=True)
        self._est0 = nets.Estimator(self.slices.n_prop_hist, e.n_priv)
        self._est0.load_state_dict(bbc.est)
        self._est0.to(dev)

        # the frozen BBC: its actor reads the 671-column obs_bbc layout
        self.bbc_ac = nets.ActorCritic(nets.ObsSlices(57, 4, 29, 10, 11), num_actions=12)
        self.bbc_ac.load_state_dict(bbc.ac)
        self.bbc_disc = nets.Discriminator(e.num_obs_disc * e.disc_obs_len, env.dim_c)
        self.bbc_disc.load_state_dict(bbc.disc)
        for m in (self.bbc_ac, self.bbc_disc):
            m.to(dev).eval().requires_grad_(False)
        self.bbc_norm = nets.RunningNormalizer(e.num_obs_disc * e.disc_obs_len, dev)
        self.bbc_norm.load_state_dict(bbc.disc_norm)

    def init_train_state(self) -> TscTrainState:
        cfg = self.cfg
        ac, est = copy.deepcopy(self._ac0), copy.deepcopy(self._est0)
        return TscTrainState(
            ac=ac, ac_opt=torch.optim.Adam(ac.parameters(), lr=cfg.learning_rate),
            lr=np.float32(cfg.learning_rate),
            hist_opt=torch.optim.Adam(ac.history_encoder.parameters(), lr=cfg.lr_estimator),
            est=est, est_opt=torch.optim.Adam(est.parameters(), lr=cfg.lr_estimator),
            priv_reg_counter=0)

    def draw(self) -> TscDraws:
        """One iteration's draws from the trainer's generator, at the global
        N (the rank's envs taken); the permutations run over the global
        (T x N) rollout."""
        T, N = self.cfg.num_steps_per_env, self.env.num_envs_global
        take = (lambda x: self.shard.take(x, 1)) if self.shard else (lambda x: x)
        u = torch.rand((T, N, self.num_d), generator=self.gen, device=self.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        normal = torch.randn((T, N, self.num_c), generator=self.gen, device=self.device)
        return TscDraws(take(gumbel), take(normal), self._perm(T * N), self._perm(T * N))

    def _perm(self, n: int):
        return torch.randperm(n, generator=self.gen, device=self.device)

    # ------------------------------------------------------------------

    @torch.no_grad()
    @trace.spanned("rollout.disc_reward")
    def disc_reward(self, disc_hist, task_reward):
        """The frozen-disc style reward mix (tsc discriminator.py:13-108):
        (0.05 r_i + 2.0 r_t, r_i) from the disc window (N, L, 49)."""
        cfg = self.cfg
        x = self.bbc_norm.normalize(disc_hist.reshape(disc_hist.shape[0], -1))
        d, _, _ = self.bbc_disc(x)
        r_i = torch.clamp(1.0 - 0.25 * torch.square(d[:, 0] - 1.0), min=0.0) * self.env.dt
        return cfg.reward_i_coef * r_i + cfg.reward_t_coef * task_reward, r_i

    @torch.no_grad()
    def rollout(self, ts: TscTrainState, es: AgilityState, disc_hist, hist_encoding: bool,
                gumbel=None, normal=None):
        """T-step on-policy rollout.  Returns (env state, disc window,
        TscTransition, metrics); the metrics are over every rank's envs."""
        cfg = self.cfg
        s = self.slices
        T, N = cfg.num_steps_per_env, self.env.num_envs
        if gumbel is None:
            d = self.draw()
            gumbel, normal = d.gumbel, d.normal
        dev = self.device
        obs_all = torch.empty((T, N, s.total), device=dev)
        acts_all = torch.empty((T, N, 1 + self.num_c), device=dev)
        mean_all = torch.empty((T, N, self.num_c), device=dev)
        rew_all, val_all, logpd_all, logpc_all = (torch.empty((T, N), device=dev)
                                                  for _ in range(4))
        done_all = torch.empty((T, N), dtype=torch.bool, device=dev)
        steps = []
        std = ts.ac.std.detach().clone()   # the PPO update changes the parameter in place
        L = disc_hist.shape[1]
        for t in range(T):
            obs, obs_bbc = es.obs_buf, es.obs_bbc_buf
            with trace.span("rollout.act"):
                obs_est = obs.clone()
                obs_est[:, s.explicit] = ts.est(obs[:, :s.n_prop_hist])
                logits_d, mean_c, _ = ts.ac.heads(obs_est, hist_encoding)
                actions = tnets.hybrid_sample(logits_d, mean_c, std, gumbel[t], normal[t])
                logp_d, logp_c = tnets.hybrid_log_prob(logits_d, mean_c, std, actions)
                values = ts.ac.value(obs)
                with trace.span("rollout.set_commands"):
                    es2, next_commands = self.env.set_commands(es, actions)
                # the frozen BBC acts on this state's obs_bbc with the fresh commands
                with trace.span("rollout.bbc_act"):
                    actions_bbc = bbc_act(self.bbc_ac, obs_bbc, next_commands)
            es3, out = self.env.step(es2, actions_bbc)

            # disc window with terminal patching, restarted after the reward
            patched = torch.where(out.reset[:, None], out.terminal_disc_obs, out.disc_obs)
            disc_hist2 = torch.cat([disc_hist[:, 1:], patched[:, None]], dim=1)
            total_r, r_i = self.disc_reward(disc_hist2, out.rew)
            # time-out bootstrap on the pre-step value
            total_r = total_r + cfg.gamma * values * out.time_out
            disc_hist = torch.where(out.reset[:, None, None],
                                    out.disc_obs[:, None].expand(-1, L, -1), disc_hist2)

            obs_all[t], acts_all[t], mean_all[t] = obs, actions, mean_c
            rew_all[t], val_all[t], done_all[t] = total_r, values, out.reset
            logpd_all[t], logpc_all[t] = logp_d, logp_c
            speed = torch.linalg.vector_norm(es3.sim.u[:, :3], dim=-1)
            steps.append(torch.stack([total_r.sum(), out.rew.sum(), r_i.sum(),
                                      out.reset.sum().float(),
                                      out.reach_goal_cutoff.sum().float(),
                                      es3.cur_goal_idx.float().sum(),
                                      (speed > 8.0).float().sum(), speed.max()]))
            es = es3
        per_step = env_reduce(torch.stack(steps), self.shard)[:, :-1]
        names = ("r_total", "r_t", "r_i", "done", "success", "goal_idx", "overspeed")
        metrics = dict(zip(names, per_step.mean(dim=0) / self.env.num_envs_global))
        metrics["done"], metrics["success"] = per_step[:, 3].sum(), per_step[:, 4].sum()
        trs = TscTransition(obs=obs_all, actions=acts_all, rewards=rew_all, dones=done_all,
                            values=val_all, logp_d=logpd_all, logp_c=logpc_all, mean=mean_all,
                            std=std.expand_as(mean_all))
        return es, disc_hist, trs, metrics

    def compute_gae(self, trs: TscTransition, last_values):
        return compute_gae(trs.rewards, trs.dones, trs.values, last_values, self.cfg.gamma,
                           self.cfg.lam, self.shard)

    # ------------------------------------------------------------------

    def ppo_update(self, ts: TscTrainState, trs: TscTransition, advantages, returns, perm=None):
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
        flat = TscTransition(*(x.reshape((T * N,) + x.shape[2:]) for x in trs))
        adv_f, ret_f = advantages.reshape(-1), returns.reshape(-1)
        rows = mesh.minibatch_rows(perm, n_mb, mb, self.shard)
        coef = priv_reg_coef(cfg.priv_reg_coef_schedule, ts.priv_reg_counter)

        ac, est = ts.ac, ts.est
        ac_params, est_params = list(ac.parameters()), list(est.parameters())
        lr = ts.lr
        outs = []
        for i in range(cfg.num_learning_epochs * n_mb):
            idx = rows[i % n_mb]
            obs, actions = flat.obs[idx], flat.actions[idx]
            old_values, old_mean, old_std = flat.values[idx], flat.mean[idx], flat.std[idx]
            mb_adv, mb_ret = adv_f[idx], ret_f[idx]

            # the estimator's loss (its own Adam, stepped first)
            ts.est_opt.zero_grad(set_to_none=True)
            err = torch.square(est(obs[:, :s.n_prop_hist]) - obs[:, s.explicit])
            el = torch.sum(err) / (mb * err.shape[1])
            el.backward()

            ts.ac_opt.zero_grad(set_to_none=True)
            logits_d, mean_c, std = ac.heads(obs, hist_encoding=False)
            logp_d, logp_c = tnets.hybrid_log_prob(logits_d, mean_c, std, actions)
            value = ac.value(obs)
            ent_d, ent_c = tnets.hybrid_entropy(logits_d, std, mean_c.shape)
            surr = 0.0
            for ratio in (torch.exp(logp_d - flat.logp_d[idx]),
                          torch.exp(logp_c - flat.logp_c[idx])):
                clipped = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param)
                surr = surr + torch.sum(torch.maximum(-mb_adv * ratio, -mb_adv * clipped)) / mb
            if cfg.use_clipped_value_loss:
                v_cl = old_values + torch.clamp(value - old_values, -cfg.clip_param,
                                                cfg.clip_param)
                value_loss = torch.sum(torch.maximum(torch.square(value - mb_ret),
                                                     torch.square(v_cl - mb_ret))) / mb
            else:
                value_loss = torch.sum(torch.square(mb_ret - value)) / mb
            priv_lat = ac.priv_latent(obs)
            with torch.no_grad():
                hist_lat = ac.hist_latent(obs)
            priv_reg = torch.sum(torch.linalg.vector_norm(priv_lat - hist_lat, dim=-1)) / mb
            entropy = torch.sum(ent_d + ent_c) / mb
            loss = (surr + cfg.value_loss_coef * value_loss - cfg.entropy_coef * entropy
                    + coef * priv_reg)
            loss.backward()

            # adaptive KL LR on the continuous head: this minibatch's
            # pre-update policy against the rollout's, set before the step
            with torch.no_grad():
                m, sd = mean_c.detach(), std.detach()
                kl = torch.sum(torch.sum(
                    torch.log(sd / old_std + 1e-5)
                    + (torch.square(old_std) + torch.square(old_mean - m))
                    / (2.0 * torch.square(sd)) - 0.5, dim=-1)) / mb
                stats = torch.stack([loss, el, kl, surr, value_loss, entropy, priv_reg]).detach()
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
        if cfg.min_std > 0:
            with torch.no_grad():
                ac.std.clamp_(min=cfg.min_std)
        ts.lr = lr
        ts.priv_reg_counter += 1
        names = ("loss", "est", "kl", "surrogate", "value", "entropy", "priv_reg")
        return {f"ppo/{k}": v for k, v in zip(names, torch.stack(outs).mean(dim=0))}

    def dagger_update(self, ts: TscTrainState, trs: TscTransition, perm=None) -> torch.Tensor:
        """The history encoder toward the privileged latent; returns the
        mean loss.  `perm` is global, as in ppo_update."""
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
        return losses.mean()

    # ------------------------------------------------------------------

    def mark(self, stage: str) -> None:
        """Hand the timer a stage's name, once its work is enqueued (a span
        boundary with tracing on: trace.mark)."""
        trace.mark(self.timer, stage)

    def train_iteration(self, ts: TscTrainState, es: AgilityState, disc_hist, it: int,
                        draws: Optional[TscDraws] = None):
        """One iteration: rollout -> GAE -> PPO -> (DAgger).  Returns (ts,
        env state, disc window, metrics); `ts` is updated in place."""
        hist_encoding = it % self.cfg.dagger_update_freq == 0
        self.mark("start")
        if draws is None:
            draws = self.draw()
            self.mark("draw")
        es, disc_hist, trs, roll_m = self.rollout(ts, es, disc_hist, hist_encoding,
                                                  draws.gumbel, draws.normal)
        self.mark("rollout")
        with torch.no_grad():
            last_values = ts.ac.value(es.obs_buf)
        advantages, returns = self.compute_gae(trs, last_values)
        self.mark("gae")
        ppo_m = self.ppo_update(ts, trs, advantages, returns, draws.ppo_perm)
        self.mark("ppo")
        if hist_encoding:
            self.dagger_update(ts, trs, draws.dagger_perm)
            self.mark("dagger")
        metrics = {**{f"rollout/{k}": v for k, v in roll_m.items()}, **ppo_m}
        return ts, es, disc_hist, metrics
