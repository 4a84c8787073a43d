"""Mocap reference-motion data (counterpart of agility_tpu/envs/mocap.py).

Clips live in flat device tables; state-init frames and the discriminator's
expert transitions are sampled on the device (clip by weight, time
uniform, lerp + slerp) from an explicit torch.Generator.  The deterministic
halves (`frames_at`, `transition_frames`) take the draws as arguments.
`load_dir` reads the reference's JSON clips ({FrameDuration, MotionWeight,
Frames[(n, 61)]}, PyBullet leg order, the category in the file name) from a
labelled and an optional unlabelled directory; without a dataset,
`synthetic()` makes procedural CPG gait clips.

Frame layout (49 columns):
  [0:3]   root position (world)          [3:7]   root quaternion xyzw
  [7:19]  joint positions (12)           [19:31] toe positions (world, 4x3)
  [31:34] root linear velocity           [34:37] root angular velocity
  [37:49] joint velocities (12)
"""
from __future__ import annotations

import glob
import json
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from agility_tpu_torch.core import quat as qm

ROOT_POS = slice(0, 3)
ROOT_ROT = slice(3, 7)
JOINT_POS = slice(7, 19)
TOE_POS = slice(19, 31)
LIN_VEL = slice(31, 34)
ANG_VEL = slice(34, 37)
JOINT_VEL = slice(37, 49)
FRAME_DIM = 49


def _reorder_pb_to_fk(frames: np.ndarray) -> np.ndarray:
    """PyBullet [FR, FL, RR, RL] -> [FL, FR, RL, RR] with hip sign flips, the
    per-leg foot-to-ground shift and the root quaternion normalised with
    w >= 0 (reference motion_loader.py:251-302), in the frames' own dtype."""
    out = frames.copy()

    def swap_legs(block):   # (F, 12) ordered FR FL RR RL -> FL FR RL RR
        fr, fl, rr, rl = np.split(block, 4, axis=1)
        return np.hstack([fl, fr, rl, rr])

    jp = swap_legs(frames[:, JOINT_POS])
    jp[:, [0, 3, 6, 9]] *= -1.0     # hip sign flip (all legs)
    jv = swap_legs(frames[:, JOINT_VEL])
    jv[:, [0, 3, 6, 9]] *= -1.0

    toes = swap_legs(frames[:, TOE_POS]).reshape(-1, 4, 3)
    mins = toes[:, :, 2].min(axis=0)                 # per-leg min height
    out[:, 2] -= float(mins.mean())                  # shift root down
    toes[:, :, 2] -= mins[None, :]                   # feet touch ground
    out[:, JOINT_POS] = jp
    out[:, JOINT_VEL] = jv
    out[:, TOE_POS] = toes.reshape(-1, 12)

    q = out[:, ROOT_ROT]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    out[:, ROOT_ROT] = np.where(q[:, 3:4] < 0, -q, q)
    return out


def categorical(gen: torch.Generator, probs: torch.Tensor, shard=None) -> torch.Tensor:
    """One draw from each row of `probs` (n, K), as torch.multinomial(probs,
    1) makes it: argmax(probs / q), q ~ Exp(1) of probs' shape.  With `shard`
    (an EnvShard, probs its envs' rows) q is drawn for all of its global envs
    and the rank's rows taken, so every rank's generator stays in step and
    each env draws what it draws in a one-rank run."""
    n, k = probs.shape
    q = torch.empty((shard.num_envs if shard else n, k), device=probs.device)
    q = q.exponential_(1, generator=gen)
    return torch.argmax(probs / (shard.take(q) if shard else q), dim=-1)


class MotionData(NamedTuple):
    categories: tuple
    frames: torch.Tensor        # (F, 49) on the device
    clip_start: torch.Tensor    # (K,) int64 first frame index
    clip_frames: torch.Tensor   # (K,) int64 frame count
    clip_dur: torch.Tensor      # (K,) frame duration [s]
    clip_len: torch.Tensor      # (K,) trajectory length [s]
    cat_logits: torch.Tensor    # (C, K) per-mode clip log-weights (-1e9 off-mode)
    weights: torch.Tensor       # (K,) sampling weights, normalised over all clips
    label: torch.Tensor         # (K,) int64 category index
    ulb_frames: torch.Tensor    # (F2, 49) the unlabelled trajectory
    ulb_dur: float              # its frame duration [s]

    def host(self) -> "MotionData":
        """The same tables as numpy arrays (for io/gait.py, which reads
        them on the host)."""
        return self._replace(**{k: v.cpu().numpy() for k, v in self._asdict().items()
                                if isinstance(v, torch.Tensor)})

    def sample_frames(self, gen: torch.Generator, c_idx: torch.Tensor, dt: float,
                      disc_obs_len: int = 2, shard=None) -> torch.Tensor:
        """(N, 49) interpolated frames: clip drawn within each env's mode by
        motion weight, time uniform over the clip.  With `shard` (an
        EnvShard, c_idx its envs' modes) the draws are the global ones, the
        rank's envs taken."""
        probs = torch.softmax(self.cat_logits[c_idx], dim=-1)
        clip = categorical(gen, probs, shard)
        lens, durs = self.clip_len[clip], self.clip_dur[clip]
        u = torch.rand(shard.num_envs if shard else c_idx.shape[0], generator=gen,
                       device=c_idx.device)
        u = shard.take(u) if shard else u
        t = torch.clamp((lens - (dt * disc_obs_len + durs)) * u, min=1e-7)
        return self.frames_at(clip, t)

    def frames_at(self, clip, t) -> torch.Tensor:
        """Frames at times t within clips (lerp, slerp on the root quaternion)."""
        n = self.clip_frames[clip].to(t.dtype)
        p = t / self.clip_len[clip]
        nmax = self.clip_frames[clip] - 1
        lo = torch.minimum(torch.clamp(torch.floor(p * n).long(), min=0), nmax)
        hi = torch.minimum(torch.clamp(torch.ceil(p * n).long(), min=0), nmax)
        start = self.clip_start[clip]
        f0, f1 = self.frames[start + lo], self.frames[start + hi]
        blend = (p * n - lo)[:, None]
        out = f0 + blend * (f1 - f0)
        out[:, ROOT_ROT] = qm.quat_standardize(qm.slerp(f0[:, ROOT_ROT], f1[:, ROOT_ROT], blend))
        return out

    def sample_transition_frames(self, gen: torch.Generator, n: int, dt: float, labeled: bool,
                                 disc_obs_len: int = 2):
        """n expert transitions: (disc_obs_len, n, 49) frame stacks dt apart
        and (n,) labels (zeros on the unlabelled side).  Labelled clips are
        drawn by weight; times uniform."""
        dev = self.frames.device
        clip = (torch.multinomial(self.weights, n, replacement=True, generator=gen) if labeled
                else torch.zeros(n, dtype=torch.long, device=dev))
        u = torch.rand(n, generator=gen, device=dev)
        return self.transition_frames(clip, u, dt, labeled, disc_obs_len)

    def transition_frames(self, clip, u, dt: float, labeled: bool, disc_obs_len: int = 2):
        """sample_transition_frames at drawn clips and uniforms u in [0, 1)."""
        if labeled:
            lens, durs, labels = self.clip_len[clip], self.clip_dur[clip], self.label[clip]
        else:
            n = u.shape[0]
            lens = torch.full((n,), (self.ulb_frames.shape[0] - 1) * self.ulb_dur, device=u.device)
            durs = torch.full((n,), self.ulb_dur, device=u.device)
            labels = torch.zeros(n, dtype=torch.long, device=u.device)
        t0 = torch.clamp((lens - (dt * disc_obs_len + durs)) * u, min=1e-7)
        at = (lambda t: self.frames_at(clip, t)) if labeled else self._ulb_frames_at
        return torch.stack([at(t0 + i * dt) for i in range(disc_obs_len)]), labels

    def _ulb_frames_at(self, t) -> torch.Tensor:
        """Frames at times t along the unlabelled trajectory."""
        F2 = self.ulb_frames.shape[0]
        p = torch.clamp(t / ((F2 - 1) * self.ulb_dur), 0.0, 1.0)
        lo = torch.clamp(torch.floor(p * F2).long(), 0, F2 - 1)
        hi = torch.clamp(torch.ceil(p * F2).long(), 0, F2 - 1)
        f0, f1 = self.ulb_frames[lo], self.ulb_frames[hi]
        blend = (p * F2 - lo)[:, None]
        out = f0 + blend * (f1 - f0)
        out[:, ROOT_ROT] = qm.quat_standardize(qm.slerp(f0[:, ROOT_ROT], f1[:, ROOT_ROT], blend))
        return out


def disc_obs_from_frames(frames: torch.Tensor, default_dof_pos, obs_scales) -> torch.Tensor:
    """49-d discriminator features of full frames, in the base frame (the
    same formula as the env's disc observation).  Foot contact is toe
    height < 0.025 m."""
    q = frames[:, ROOT_ROT]
    roll, pitch, _ = qm.euler_from_quat(q)
    lin = qm.quat_rotate_inverse(q, frames[:, LIN_VEL]) * obs_scales.lin_vel_dist
    ang = qm.quat_rotate_inverse(q, frames[:, ANG_VEL]) * obs_scales.ang_vel_dist
    jp = (frames[:, JOINT_POS] - default_dof_pos) * obs_scales.dof_pos
    jv = frames[:, JOINT_VEL] * obs_scales.dof_vel
    toes = frames[:, TOE_POS].reshape(-1, 4, 3)
    local = qm.quat_rotate(qm.heading_quat_inv(q)[:, None, :], toes - frames[:, None, 0:3])
    key_pos = local.reshape(-1, 12) * obs_scales.key_pos
    contact = (toes[:, :, 2] < 0.025).to(frames.dtype) * obs_scales.foot_contact
    return torch.cat([torch.stack([roll, pitch], -1), frames[:, 2:3], lin, ang, jp, jv,
                      key_pos, contact], dim=-1)


def load_dir(lb_dir: str, ulb_dir: Optional[str], categories: Sequence[str],
             device="cuda") -> MotionData:
    """Mocap JSON clips ({FrameDuration, MotionWeight, Frames[(n, 61)]}) from a
    labelled directory (each clip's category from its file name) and an
    optional unlabelled one, whose files are concatenated into the
    unlabelled trajectory; a missing or empty unlabelled directory leaves
    the labelled frames in its place."""
    def read(path):
        with open(path) as f:
            d = json.load(f)
        return d, _reorder_pb_to_fk(np.asarray(d["Frames"], np.float64)[:, :FRAME_DIM])

    clips, labels, weights, durs = [], [], [], []
    for path in sorted(glob.glob(os.path.join(lb_dir, "*"))):
        name = os.path.basename(path)
        label = next((i for i, c in enumerate(categories) if c in name), None)
        if label is None:
            raise ValueError(f"no category of {categories} in {name}")
        d, frames = read(path)
        clips.append(frames)
        labels.append(label)
        weights.append(float(d["MotionWeight"]))
        durs.append(float(d["FrameDuration"]))
    ulb = []
    ulb_dur = durs[0]
    if ulb_dir:
        for path in sorted(glob.glob(os.path.join(ulb_dir, "*"))):
            d, frames = read(path)
            ulb.append(frames)
            ulb_dur = float(d["FrameDuration"])
    return _build(clips, labels, weights, durs, ulb, ulb_dur, categories, device)


def _build(clips, labels, weights, durs, ulb, ulb_dur, categories, device) -> MotionData:
    """The flat tables; with no unlabelled clips the labelled frames serve
    as the unlabelled trajectory, as in the JAX package."""
    starts = np.cumsum([0] + [len(c) for c in clips[:-1]])
    nframes = np.asarray([len(c) for c in clips])
    w = np.asarray(weights, np.float64)
    w = (w / w.sum()).astype(np.float32)
    lab = np.asarray(labels)
    logits = np.full((len(categories), len(clips)), -1e9, np.float32)
    for c in range(len(categories)):
        m = lab == c
        if m.any():
            logits[c, m] = np.log(w[m] / w[m].sum())
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    frames = t(np.concatenate(clips).astype(np.float32), torch.float32)
    return MotionData(
        categories=tuple(categories),
        frames=frames,
        clip_start=t(starts, torch.int64), clip_frames=t(nframes, torch.int64),
        clip_dur=t(durs, torch.float32),
        clip_len=t(((nframes - 1) * np.asarray(durs)).astype(np.float32), torch.float32),
        cat_logits=t(logits, torch.float32), weights=t(w, torch.float32),
        label=t(lab, torch.int64),
        ulb_frames=t(np.concatenate(ulb).astype(np.float32), torch.float32) if ulb else frames,
        ulb_dur=float(ulb_dur))


_GAIT_PHASES = {
    # per-leg phase offsets [FL, FR, RL, RR] (fractions of a cycle)
    "walk": (0.0, 0.5, 0.75, 0.25),
    "pace": (0.0, 0.5, 0.0, 0.5),
    "trot": (0.0, 0.5, 0.5, 0.0),
    "canter": (0.0, 0.3, 0.6, 0.7),
    "jump": (0.0, 0.0, 0.0, 0.0),
}
_GAIT_FREQ = {"walk": 1.2, "pace": 1.8, "trot": 2.0, "canter": 2.4, "jump": 1.2}
_GAIT_SPEED = {"walk": 0.4, "pace": 1.0, "trot": 1.0, "canter": 1.6, "jump": 1.2}


def synthetic(model, categories: Sequence[str], n_frames: int = 120,
              frame_dur: float = 1 / 30.0, clips_per_cat: int = 2, seed: int = 0,
              active: Optional[Sequence[str]] = None, device="cuda") -> MotionData:
    """Procedural CPG gait clips with FK-consistent toe positions (the same
    clips as the JAX package's `synthetic` for the same seed)."""
    from agility_tpu_torch.physics import soa
    from agility_tpu_torch.physics.constants import ModelConsts

    # the clips' FK precompute runs on the host, whatever `device` holds them
    c = soa.consts_of(ModelConsts.from_model(model, "cpu"))
    rng = np.random.default_rng(seed)
    default = np.asarray(model.default_dof_pos)
    clips, labels, weights, durs = [], [], [], []
    t = np.arange(n_frames) * frame_dur
    feet_links = [model.link_names.index(f"{l}_calf") for l in ("FL", "FR", "RL", "RR")]
    active = set(active) if active is not None else set(categories)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    for label, cat in enumerate(categories):
        if cat not in active:
            continue
        for _ in range(clips_per_cat):
            f = _GAIT_FREQ[cat] * (1.0 + 0.1 * rng.standard_normal())
            amp = 0.35 + 0.1 * rng.random()
            speed = _GAIT_SPEED[cat] * (1.0 + 0.15 * rng.standard_normal())
            jp = np.tile(default, (n_frames, 1))
            for leg in range(4):
                ph = 2 * np.pi * (f * t + _GAIT_PHASES[cat][leg])
                jp[:, 3 * leg + 1] += amp * 0.5 * np.sin(ph)            # thigh
                jp[:, 3 * leg + 2] += amp * np.clip(np.sin(ph), 0, 1)   # calf swing
            z0 = (0.30 + 0.06 * np.maximum(np.sin(2 * np.pi * f * t), 0)
                  if cat == "jump" else np.full_like(t, 0.30))
            root_pos = np.stack([speed * t, np.zeros_like(t), z0], -1)
            quat = np.tile([0.0, 0.0, 0.0, 1.0], (n_frames, 1))
            pos, _ = soa.fk_pose(c, tuple(f32(root_pos).unbind(1)), tuple(f32(quat).unbind(1)),
                                 f32(jp).T)
            toe = np.stack([torch.stack(pos[l], -1).numpy() for l in feet_links], 1)
            toe = toe + np.array([0.0, 0.0, -0.213])                      # foot frame offset
            toe[:, :, 2] -= toe[:, :, 2].min(axis=0, keepdims=True)
            jv = np.gradient(jp, frame_dur, axis=0)
            lin = np.gradient(root_pos, frame_dur, axis=0)               # world == local (yaw 0)
            frames = np.concatenate([root_pos, quat, jp, toe.reshape(n_frames, 12), lin,
                                     np.zeros_like(lin), jv], axis=-1)
            clips.append(frames)
            labels.append(label)
            weights.append(1.0)
            durs.append(frame_dur)
    return _build(clips, labels, weights, durs, [], frame_dur, categories, device)
