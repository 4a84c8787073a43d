"""TSC student distillation in PyTorch (counterpart of
agility_tpu/learn/vision_tsc.py): the depth-camera student.

Per iteration the *student* (depth encoder + a copy of the teacher's
actor-critic) rolls through the env with the frozen BBC underneath.  The
camera refreshes every `depth.update_interval` control steps: the
ray-caster renders the depth images, the GRU encoder steps once, and its
outputs (scan latent, delta-yaw, obstacle type) are HELD for the chunk's
steps while only the action heads run.  The rollout runs under no_grad and
stores the refresh images and masked proprio, and per step the observation
(the estimator's output written in) the teacher acted on, the dyaw-ok mask
and the teacher's action (argmax mode, mean commands).

The update recomputes the encoder chain from the iteration-start GRU state
and the heads of every stored step under grad from those stored inputs,
as the JAX update does: the env path is detached in the reference, so the
recomputation is exact, and the rollout keeps no graph alive across its T
steps (the peak memory of the choice is in PERF.md).  The losses are the
action cross-entropy and L2, the weighted yaw L2 and the obstacle-type
cross-entropy; the encoder and the student each take optax's global-norm
clip and then Adam, at a rate that decays linearly with the iteration.
Then BYOL minibatches train their own backbone on augmented refresh images
(a backbone apart from the encoder's, as in the reference: BYOL never
changes the student).

Every draw (the depth noise of each refresh, BYOL's minibatch indices and
augmentations) comes from the trainer's generator (`draw`) or is handed in
(`VisionDraws`), so that a test can feed the JAX key chain's values.

A frozen plain-torch copy of agility_tpu_torch/learn/vision_tsc.py for the
benchmark's reference (it imports nothing of the program): the trainer
alone, without the runner's logging and checkpoints or the evaluation
policy.  Departure from the source (on_policy_runner.py:278-441,
ppo.py:327-358): the update recomputes the encoder chain under grad from
the stored refresh inputs and the iteration-start GRU state, where the
source backpropagates through the rollout's own graph; the env path is
detached there, so the values are the same.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from benchmark.reference.plain.envs.go2_agility import AgilityState, Go2AgilityEnv
from benchmark.reference.plain.learn import depth as dm
from benchmark.reference.plain.learn import networks as nets
from benchmark.reference.plain.learn import networks_tsc as tnets
from benchmark.reference.plain.learn.policy_tsc import bbc_act
from benchmark.reference.plain.learn.ssinfogail import clip_grad_global_norm_
from benchmark.reference.plain.render import raycast


@dataclasses.dataclass(frozen=True)
class VisionCfg:
    # tsc depth_encoder cfg :406-414
    num_steps_per_env: int = 24
    learning_rate: float = 1e-3
    learning_rate_byol: float = 3e-4
    learning_rate_min: float = 1e-5
    lr_decay_iters: int = 20000
    byol_minibatches: int = 6
    yaw_scale: float = 1.5            # student yaw output scale (runner :334)
    delta_yaw_ok_thresh: float = 0.6  # env extras threshold (:144)
    max_grad_norm: float = 1.0


@dataclasses.dataclass
class VisionTrainState:
    enc: dm.RecurrentDepthEncoder
    enc_opt: torch.optim.Adam
    actor: tnets.ActorCriticTSC     # the student: a copy of the teacher's actor-critic
    actor_opt: torch.optim.Adam
    byol: dm.BYOLNets               # online
    byol_target: dm.BYOLNets        # EMA copy
    byol_opt: torch.optim.Adam
    ema_decay: torch.Tensor         # () float32
    hidden: torch.Tensor            # (N, 512) GRU state, detached between iterations
    it: int


class VisionDraws(NamedTuple):
    """One iteration's draws: the depth noise of R refreshes and, for M BYOL
    minibatches of mb images, the indices and both augmentations."""
    depth: raycast.DepthNoise       # (R, N), (R, N), (R, N, H, W)
    byol_idx: torch.Tensor          # (M, mb) int64 into the R * N refresh images
    aug1: dm.AugmentDraws           # each field (M, mb, ...)
    aug2: dm.AugmentDraws


class VisionData(NamedTuple):
    """What the rollout stores for the update."""
    depth: torch.Tensor             # (R, N, H, W) processed refresh images
    prop_masked: torch.Tensor       # (R, N, n_prop) the encoder's proprio at refreshes
    obs: torch.Tensor               # (T, N, obs) the observation, estimator written in
    dyaw_ok: torch.Tensor           # (T, N) bool
    actions_teacher: torch.Tensor   # (T, N, 1 + D*C) [argmax mode | mean commands]
    chunks: Tuple[Tuple[int, int], ...]   # (first step, steps) of each refresh


def decayed_lr(lr0: float, lr_min: float, it: int, decay_iters: int) -> float:
    """max(lr0 - (lr0 - lr_min) * it / decay_iters, lr_min) in float32, as
    the JAX update computes it."""
    f = np.float32
    lr = f(lr0) - f(lr0 - lr_min) * f(it) / f(decay_iters)
    return float(np.maximum(lr, f(lr_min)))


class TscVision:
    def __init__(self, env: Go2AgilityEnv, teacher_ac: tnets.ActorCriticTSC,
                 teacher_est: nets.Estimator, bbc_ac: nets.ActorCritic,
                 cfg: VisionCfg = VisionCfg(), seed: int = 1):
        """The teacher's actor-critic and estimator (frozen: the student
        starts from a copy) and the frozen BBC actor, on the env's device."""
        self.env = env
        self.cfg = cfg
        self.device = dev = env.device
        self.teacher_ac, self.teacher_est, self.bbc_ac = teacher_ac, teacher_est, bbc_ac
        e, dc = env.cfg.env, env.cfg.depth
        self.n_prop, self.n_aux = e.n_proprio, e.n_auxiliary
        self.slices = teacher_ac.slices
        self.cam = raycast.make_camera(
            width=dc.resized[0], height=dc.resized[1], horizontal_fov_deg=dc.horizontal_fov,
            position=dc.position, near=dc.near_clip, far=dc.far_clip, device=dev)
        self.image_shape = (dc.resized[1], dc.resized[0])
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        # called with a stage's name after it is enqueued (a timer may record
        # CUDA events there; the runner adds "end"); None does nothing
        self.timer = None

        self._enc0 = dm.flax_init_(dm.RecurrentDepthEncoder(
            32, e.n_delta_yaw, e.n_obst_type, e.n_proprio,
            image_shape=self.image_shape).to(dev), self.gen)
        self._byol0 = dm.flax_init_(dm.BYOLNets(image_shape=self.image_shape).to(dev), self.gen)
        # per-env camera pitch [rad] (the reference's depth.angle randomization)
        lo, hi = dc.angle_range
        u = torch.rand(env.num_envs, generator=self.gen, device=dev)
        self.cam_pitch = torch.deg2rad(lo + (hi - lo) * u)

    def init_train_state(self) -> VisionTrainState:
        cfg = self.cfg
        enc, actor = copy.deepcopy(self._enc0), copy.deepcopy(self.teacher_ac)
        byol, target = copy.deepcopy(self._byol0), copy.deepcopy(self._byol0)
        actor.requires_grad_(True)
        target.requires_grad_(False)
        return VisionTrainState(
            enc=enc, enc_opt=torch.optim.Adam(enc.parameters(), lr=cfg.learning_rate),
            actor=actor, actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.learning_rate),
            byol=byol, byol_target=target,
            byol_opt=torch.optim.Adam(byol.parameters(), lr=cfg.learning_rate_byol),
            ema_decay=torch.tensor(0.99, dtype=torch.float32, device=self.device),
            hidden=enc.init_hidden(self.env.num_envs), it=0)

    def mark(self, stage: str) -> None:
        """Hand the timer a stage's name, once its work is enqueued."""
        if self.timer is not None:
            self.timer(stage)

    def n_refresh(self) -> int:
        return math.ceil(self.cfg.num_steps_per_env / self.env.cfg.depth.update_interval)

    def draw(self) -> VisionDraws:
        """One iteration's draws from the trainer's generator."""
        N, (H, W), g = self.env.num_envs, self.image_shape, self.gen
        R, M = self.n_refresh(), self.cfg.byol_minibatches
        noise = [raycast.draw_depth_noise(g, N, H, W) for _ in range(R)]
        depth = raycast.DepthNoise(*(torch.stack(x) for x in zip(*noise)))
        n = R * N
        mb = max(1, n // M)
        idx = torch.randint(0, n, (M, mb), generator=g, device=self.device)
        aug = [dm.AugmentDraws(*(x.reshape((M, mb) + x.shape[1:])
                                 for x in dm.draw_augment(g, M * mb, H, W))) for _ in range(2)]
        return VisionDraws(depth, idx, *aug)

    # ------------------------------------------------------------------

    def render(self, es: AgilityState, noise: raycast.DepthNoise):
        """(N, H, W) processed depth images of state `es`."""
        depth = raycast.render_depth(self.cam, self.env.grid, es.sim.base_pos, es.sim.base_quat,
                                     self.cam_pitch, self.env._weights(es))
        self.mark("render")
        out = raycast.process_depth(depth, self.cam.near, self.cam.far, noise,
                                    self.env.cfg.depth.depth_noise)
        self.mark("process")
        return out

    def _encode(self, enc, depth, prop_masked, hidden):
        """One encoder step (camera refreshes only): (latent, scaled dyaw,
        obstacle-type softmax, hidden)."""
        out, hidden = enc(depth, prop_masked, hidden)
        return out[:, :32], self.cfg.yaw_scale * out[:, 32:34], out[:, 34:], hidden

    def _act(self, actor, obs, lat, dyaw, types, dyaw_ok):
        """The student's heads (every control step) with the held encoder
        outputs swapped into the observation: dyaw where the env's delta
        yaw is small, the one-hot argmax obstacle type (no gradient), the
        latent in place of the scan encoder's."""
        a0 = self.n_prop - self.n_aux
        one_hot = F.one_hot(torch.argmax(types, dim=-1), types.shape[-1]).to(obs.dtype)
        dyaw = torch.where(dyaw_ok[:, None], dyaw, obs[:, a0:a0 + 2])
        obs_student = torch.cat([obs[:, :a0], dyaw, one_hot, obs[:, self.n_prop:]], dim=-1)
        logits_d, mean_c, _ = actor.heads(obs_student, hist_encoding=True, scandots_latent=lat)
        return logits_d, mean_c

    def _prep_obs(self, es: AgilityState):
        """(obs with the estimator's prediction written in, the encoder's
        proprio with the auxiliary columns zeroed)."""
        s = self.slices
        obs = es.obs_buf.clone()
        obs[:, s.explicit] = self.teacher_est(obs[:, :s.n_prop_hist])
        prop_masked = obs[:, :self.n_prop].clone()
        prop_masked[:, self.n_prop - self.n_aux:] = 0.0
        return obs, prop_masked

    @torch.no_grad()
    def rollout(self, ts: VisionTrainState, es: AgilityState, noise: raycast.DepthNoise):
        """A T-step student rollout with teacher supervision.  Returns (env
        state, VisionData, the final GRU state, metrics)."""
        T, N = self.cfg.num_steps_per_env, self.env.num_envs
        interval = self.env.cfg.depth.update_interval
        dev = self.device
        obs_all = torch.empty((T, N, self.slices.total), device=dev)
        ok_all = torch.empty((T, N), dtype=torch.bool, device=dev)
        at_all = torch.empty((T, N, 1 + self.teacher_ac.actor_c.out_features), device=dev)
        hidden = ts.hidden
        frames, props, chunks, steps_m = [], [], [], []
        for r, t0 in enumerate(range(0, T, interval)):
            steps = min(interval, T - t0)
            _, prop_masked = self._prep_obs(es)
            self.mark("prep")
            depth = self.render(es, raycast.DepthNoise(*(x[r] for x in noise)))
            lat, dyaw, types, hidden = self._encode(ts.enc, depth, prop_masked, hidden)
            self.mark("encode")
            frames.append(depth)
            props.append(prop_masked)
            chunks.append((t0, steps))
            for t in range(t0, t0 + steps):
                obs, _ = self._prep_obs(es)
                dyaw_ok = torch.abs(es.delta_yaw) < self.cfg.delta_yaw_ok_thresh
                t_logits, t_mean, _ = self.teacher_ac.heads(obs, hist_encoding=True)
                s_logits, s_mean = self._act(ts.actor, obs, lat, dyaw, types, dyaw_ok)
                student = torch.cat([torch.argmax(s_logits, -1)[:, None].float(), s_mean], -1)
                es2, next_commands = self.env.set_commands(es, student)
                actions_bbc = bbc_act(self.bbc_ac, es.obs_bbc_buf, next_commands)
                self.mark("act")
                es, out = self.env.step(es2, actions_bbc)
                obs_all[t], ok_all[t] = obs, dyaw_ok
                at_all[t] = torch.cat([torch.argmax(t_logits, -1)[:, None].float(), t_mean], -1)
                steps_m.append(torch.stack([out.rew.mean(), out.reset.sum().float(),
                                            out.reach_goal_cutoff.sum().float()]))
                self.mark("env")
        per_step = torch.stack(steps_m)
        metrics = {"rew": per_step[:, 0].mean(), "done": per_step[:, 1].sum(),
                   "success": per_step[:, 2].sum()}
        data = VisionData(depth=torch.stack(frames), prop_masked=torch.stack(props), obs=obs_all,
                          dyaw_ok=ok_all, actions_teacher=at_all, chunks=tuple(chunks))
        return es, data, hidden, metrics

    # ------------------------------------------------------------------

    def losses(self, ts: VisionTrainState, data: VisionData) -> Dict[str, torch.Tensor]:
        """The four distillation losses, recomputed under grad: the encoder
        at each refresh from the iteration-start GRU state, the heads at
        every stored step with their chunk's encoder outputs."""
        N = data.obs.shape[1]
        a0 = self.n_prop - self.n_aux
        yaw_w = torch.tensor([2.0, 0.5], device=self.device)
        hidden = ts.hidden
        d_l, c_l, yaw_l, type_l = [], [], [], []
        for r, (t0, steps) in enumerate(data.chunks):
            lat, dyaw, types, hidden = self._encode(ts.enc, data.depth[r], data.prop_masked[r],
                                                    hidden)
            flat = lambda x: x[t0:t0 + steps].reshape((steps * N,) + x.shape[2:])
            rep = lambda x: x.repeat(steps, 1)                       # step-major, as flat
            obs, at = flat(data.obs), flat(data.actions_teacher)
            logits_d, mean_c = self._act(ts.actor, obs, rep(lat), rep(dyaw), rep(types),
                                         flat(data.dyaw_ok))
            d_l.append(-torch.gather(F.log_softmax(logits_d, -1), 1, at[:, :1].long())[:, 0])
            c_l.append(torch.linalg.vector_norm(at[:, 1:] - mean_c, dim=-1))
            yaw_l.append(torch.linalg.vector_norm((obs[:, a0:a0 + 2] - rep(dyaw)) * yaw_w, dim=-1))
            teacher_type = torch.argmax(obs[:, a0 + 2:self.n_prop], -1)[:, None]
            type_l.append(-torch.log(torch.gather(rep(types) + 1e-20, 1, teacher_type))[:, 0])
        return {k: torch.cat(v).mean() for k, v in
                (("d", d_l), ("c", c_l), ("yaw", yaw_l), ("types", type_l))}

    def update(self, ts: VisionTrainState, data: VisionData, draws: VisionDraws):
        """The distillation step, then the BYOL minibatches; `ts` is updated
        in place.  Returns the metrics."""
        cfg = self.cfg
        lr = decayed_lr(cfg.learning_rate, cfg.learning_rate_min, ts.it, cfg.lr_decay_iters)
        lr_byol = decayed_lr(cfg.learning_rate_byol, cfg.learning_rate_min, ts.it,
                             cfg.lr_decay_iters)
        for opt in (ts.enc_opt, ts.actor_opt):
            opt.zero_grad(set_to_none=True)
        loss = self.losses(ts, data)
        (loss["d"] + loss["c"] + loss["yaw"] + loss["types"]).backward()
        for module, opt in ((ts.enc, ts.enc_opt), (ts.actor, ts.actor_opt)):
            params = list(module.parameters())
            # the JAX gradient is zero, not absent, for a parameter the loss
            # does not reach (the critic, the scan encoder): the clip's norm
            # and Adam's state cover every parameter
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            clip_grad_global_norm_(params, cfg.max_grad_norm)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        self.mark("update")

        H, W = self.image_shape
        imgs = data.depth.reshape(-1, H, W)
        for group in ts.byol_opt.param_groups:
            group["lr"] = lr_byol
        byol_losses = []
        for m in range(cfg.byol_minibatches):
            batch = imgs[draws.byol_idx[m]]
            a1, a2 = (dm.augment_depth(batch, dm.AugmentDraws(*(x[m] for x in aug)))
                      for aug in (draws.aug1, draws.aug2))
            ts.byol_opt.zero_grad(set_to_none=True)
            bl = dm.byol_loss(ts.byol, ts.byol_target, a1, a2)
            bl.backward()
            ts.byol_opt.step()
            dm.byol_ema_update(ts.byol, ts.byol_target, ts.ema_decay)
            byol_losses.append(bl.detach())
        self.mark("byol")
        ts.it += 1
        return {"vision/actor": (loss["d"] + loss["c"]).detach(),
                "vision/yaw": loss["yaw"].detach(), "vision/types": loss["types"].detach(),
                "vision/byol": torch.stack(byol_losses).mean(),
                "vision/lr": torch.tensor(lr, dtype=torch.float32, device=self.device)}

    def train_iteration(self, ts: VisionTrainState, es: AgilityState,
                        draws: Optional[VisionDraws] = None):
        """One iteration: rollout -> distillation update -> BYOL.  Returns
        (ts, env state, metrics); `ts` is updated in place, its GRU state
        set to the rollout's final one."""
        self.mark("start")
        if draws is None:
            draws = self.draw()
            self.mark("draw")
        es, data, hidden, roll_m = self.rollout(ts, es, draws.depth)
        up_m = self.update(ts, data, draws)
        ts.hidden = hidden
        return ts, es, {**{f"rollout/{k}": v for k, v in roll_m.items()}, **up_m}
