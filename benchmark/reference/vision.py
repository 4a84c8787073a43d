"""The plain reference of the depth-student cell: the ray-marched refresh
images, the hierarchical env step (as the TSC teacher's reference,
reference/tsc.py) and the student's distillation iteration (rollout on the
program's recorded env results, the four losses, both networks' clip and
Adam, BYOL) of the frozen plain copy (`reference/plain`), which imports
nothing of the program and runs no hand-written kernel.

As the other references: its own env from the configuration and the seed,
its own trainer from the seed (its own initial weights, camera pitches and
draws), the teacher and the frozen BBC read from their files here; from
the program it takes the inputs and outputs of the timed path, read only
to judge them.  Its rollout is fed the program's refresh images, as it is
fed the program's env results; the images are judged apart, rendered here
from the recorded states in blocks of envs so that the march fits beside
the program's data, over the pixels `crossing_mask` keeps.  It computes in
float32 with TF32 off for matmuls and cuDNN (the judge sets it; the
control turns it on)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.harness import common
from benchmark.reference import core, tsc
from benchmark.reference.plain import checkpoint as ckpt
from benchmark.reference.plain.learn import networks as nets
from benchmark.reference.plain.learn import networks_tsc as tnets
from benchmark.reference.plain.learn import vision_tsc as vt
from benchmark.reference.plain.render import raycast

ACTION_KEYS = ("hl_actions", "teacher_actions", "bbc_actions")
MODULES = ("enc", "actor", "byol")
OPTIMISERS = ("enc_opt", "actor_opt", "byol_opt")
LOSS_KEYS = ("d", "c", "yaw", "types", "vision/byol")
BLOCK = 512     # envs the reference renders at a time

# the env step is the teacher's, judged as reference/tsc.py judges it
make_env, env_gap, control_env_gap, fault_gaps = (tsc.make_env, tsc.env_gap, tsc.control_env_gap,
                                                  tsc.fault_gaps)


# ----------------------------------------------------------------------------
# the teacher and the frozen BBC, from their files
# ----------------------------------------------------------------------------

def _tsc_ac(ac) -> Dict[str, torch.Tensor]:
    """ActorCriticTSC's state dict from a teacher checkpoint's flax params."""
    sd = {"std": torch.as_tensor(np.asarray(ac["std"]))}
    for m in ("priv_encoder", "scan_encoder", "actor_trunk", "critic_trunk"):
        sd.update(ckpt._mlp(ac[m], m))
    sd.update(ckpt._history_encoder(ac["history_encoder"], "history_encoder"))
    for h in ("actor_d", "actor_c", "critic_head"):
        sd.update(ckpt._dense(ac[h], h))
    return sd


def load_teacher(path: str, env):
    """The teacher's actor-critic and estimator, on the env's device."""
    tree = ckpt.read_msgpack(path)
    e = env.cfg.env
    slices = tnets.TscObsSlices(e.n_proprio, e.n_scan, e.n_priv, e.n_priv_latent,
                                e.history_len, e.n_auxiliary)
    ac = tnets.ActorCriticTSC(slices, e.num_actions_d, e.num_actions_c)
    ac.load_state_dict(_tsc_ac(tree["ac_params"]["params"]))
    est = nets.Estimator(slices.n_prop_hist, e.n_priv)
    est.load_state_dict(ckpt._mlp(tree["est_params"]["params"]["MLP_0"], "mlp"))
    return ac.to(env.device), est.to(env.device)


def load_bbc_actor(path: str, device):
    """The frozen BBC's actor-critic (its actor acts under the student)."""
    ac = nets.ActorCritic(nets.ObsSlices(57, 4, 29, 10, 11), num_actions=12)
    ac.load_state_dict(ckpt.params_from_jax(ckpt.read_msgpack(path))["actor_critic"])
    return ac.to(device).eval().requires_grad_(False)


# ----------------------------------------------------------------------------
# what the program's iteration is recorded as
# ----------------------------------------------------------------------------

def light_state(s) -> Dict[str, torch.Tensor]:
    """What the student's rollout reads of an env state (copies)."""
    return dict(obs_buf=s.obs_buf.clone(), obs_bbc_buf=s.obs_bbc_buf.clone(),
                delta_yaw=s.delta_yaw.clone())


def render_inputs(s) -> Dict[str, torch.Tensor]:
    """What a render reads of an env state (copies): the base pose and the
    surfaces' weights' inputs."""
    return dict(base_pos=s.sim.base_pos.clone(), base_quat=s.sim.base_quat.clone(),
                bar_h=s.bar_h.clone(), tire_h=s.tire_h.clone(),
                seesaw_theta=s.seesaw_theta.clone())


def record(env, alg, sampled, rec: Dict) -> List:
    """Wrap the program's env set_commands and step, and its trainer's
    render, losses and update, for one check iteration: into `rec`, every
    step's actions and results ("steps"), whole env steps at the `sampled`
    positions ("full", as reference/tsc.py judges them), each refresh's
    render inputs and processed image ("renders"), the four losses
    ("losses") and the teacher's actions ("teacher_actions"); returns the
    wrapped (object, attribute) pairs."""
    steps, full, renders = rec.setdefault("steps", []), rec.setdefault("full", []), \
        rec.setdefault("renders", [])
    pending = {}

    def set_commands(state, hl_actions, noise=None):
        if (0, len(steps)) in sampled:
            pending.update(gen=env.gen.get_state(), state_in=common.clone_state(state))
        s2, nc = type(env).set_commands(env, state, hl_actions, noise)
        pending.update(hl_actions=hl_actions.clone(), next_commands=nc.clone())
        return s2, nc

    def step(state, actions_bbc):
        pos = (0, len(steps))
        new, out = type(env).step(env, state, actions_bbc)
        steps.append(dict(light_state(new), rew=out.rew.clone(), reset=out.reset.clone(),
                          reach_goal_cutoff=out.reach_goal_cutoff.clone(),
                          hl_actions=pending["hl_actions"],
                          next_commands=pending["next_commands"], bbc_actions=actions_bbc.clone()))
        if pos in sampled:
            full.append(common.host(dict(
                pos=pos, state_in=pending["state_in"], gen=pending["gen"],
                hl_actions=pending["hl_actions"], next_commands=pending["next_commands"],
                bbc_actions=actions_bbc.clone(), state_out=common.clone_state(new),
                rew=out.rew.clone())))
        return new, out

    def render(es, noise):
        img = type(alg).render(alg, es, noise)
        renders.append(common.host(dict(render_inputs(es), image=img)))
        return img

    def losses(ts, data):
        out = type(alg).losses(alg, ts, data)
        rec["losses"] = {k: v.detach().clone() for k, v in out.items()}
        return out

    def update(ts, data, draws):
        rec["teacher_actions"] = common.host(data.actions_teacher)
        return type(alg).update(alg, ts, data, draws)

    env.set_commands, env.step = set_commands, step
    alg.render, alg.losses, alg.update = render, losses, update
    return [(env, "set_commands"), (env, "step"), (alg, "render"), (alg, "losses"),
            (alg, "update")]


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

class ReplayState(NamedTuple):
    """What the student's rollout reads of an env state."""
    obs_buf: torch.Tensor
    obs_bbc_buf: torch.Tensor
    delta_yaw: torch.Tensor


class ReplayOut(NamedTuple):
    rew: torch.Tensor
    reset: torch.Tensor
    reach_goal_cutoff: torch.Tensor


def _replay_state(rec: Dict, dev) -> ReplayState:
    return ReplayState(*(rec[k].to(dev) for k in ReplayState._fields))


class ReplayEnv:
    """The reference env with set_commands and step replaced by the program's
    recorded results, in order; the reference's student and frozen-BBC
    actions are kept for the comparison."""

    def __init__(self, env, steps: List[Dict]):
        self._env, self._steps, self.t = env, steps, 0
        self.hl_actions: List[torch.Tensor] = []
        self.bbc_actions: List[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def set_commands(self, state, hl_actions, noise=None):
        self.hl_actions.append(hl_actions)
        return state, self._steps[self.t]["next_commands"].to(hl_actions.device)

    def step(self, state, actions_bbc):
        rec = self._steps[self.t]
        self.t += 1
        self.bbc_actions.append(actions_bbc)
        dev = actions_bbc.device
        return _replay_state(rec, dev), ReplayOut(*(rec[k].to(dev) for k in ReplayOut._fields))


def watch_first_steps(ts, store: Dict[str, torch.Tensor]) -> None:
    core.watch_first_steps(ts, store, MODULES, OPTIMISERS)


def snapshot_params(ts) -> Dict[str, torch.Tensor]:
    return core.snapshot_params(ts, MODULES)


class VisionReplay(vt.TscVision):
    """The reference student trainer from its own initial state, teacher and
    frozen BBC, through a recorded iteration: its rollout fed the program's
    env results and refresh images, its draws its own (kept in `draws`)."""

    def __init__(self, env, seed: int, cfg: Dict):
        ref = cfg["reference"]
        teacher, est = load_teacher(ref["teacher_path"], env)
        super().__init__(env, teacher, est, load_bbc_actor(ref["bbc_path"], env.device),
                         vt.VisionCfg(), seed=seed)
        self.ts = self.init_train_state()
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.params0 = snapshot_params(self.ts)
        watch_first_steps(self.ts, self.first_grad)

    def render(self, es, noise):
        img = self._images[self._refresh]
        self._refresh += 1
        return img

    def losses(self, ts, data):
        out = super().losses(ts, data)
        self._losses = {k: v.detach() for k, v in out.items()}
        return out

    def update(self, ts, data, draws):
        self._teacher_actions = data.actions_teacher
        return super().update(ts, data, draws)

    def iteration(self, rec: Dict) -> Dict:
        """One iteration on the record of the program's: {metrics (on the
        host), losses, hl/teacher/bbc actions (T, N, ...)}."""
        dev, env = self.device, self.env
        self._images = [r["image"].to(dev) for r in rec["renders"]]
        self._refresh = 0
        self.ts.hidden = rec["hidden"].to(dev)
        self.draws = self.draw()
        self.env = ReplayEnv(env, rec["steps"])
        try:
            self.ts, _, metrics = self.train_iteration(self.ts, _replay_state(rec["start"], dev),
                                                       self.draws)
            out = dict(hl_actions=torch.stack(self.env.hl_actions),
                       bbc_actions=torch.stack(self.env.bbc_actions))
        finally:
            self.env = env
        m = {k: float(v) for k, v in metrics.items()}
        m.update({k: float(v) for k, v in self._losses.items()})
        return dict(out, metrics=m, teacher_actions=self._teacher_actions)


def make_trainer(env, seed: int, cfg: Dict) -> VisionReplay:
    return VisionReplay(env, seed, cfg)


# ----------------------------------------------------------------------------
# the refresh images
# ----------------------------------------------------------------------------

def render_reference(trainer: VisionReplay, renders: List[Dict], with_tf32: bool = False):
    """The reference's processed image and crossing mask of every recorded
    refresh, [(image, keep)] (N, H, W), each rendered from the recorded
    state with the reference's own camera pitches and depth noise, BLOCK
    envs at a time."""
    env, cam, dev = trainer.env, trainer.cam, trainer.device
    noise = trainer.draws.depth
    old = core.tf32(with_tf32)
    out = []
    try:
        with torch.no_grad():
            for r, rec in enumerate(renders):
                g = {k: v.to(dev) for k, v in rec.items() if k != "image"}
                w = env._weights(SimpleNamespace(**g))
                imgs, keeps = [], []
                for b in range(0, env.num_envs, BLOCK):
                    sl = slice(b, b + BLOCK)
                    args = (cam, env.grid, g["base_pos"][sl], g["base_quat"][sl],
                            trainer.cam_pitch[sl], w[sl])
                    depth = raycast.render_depth(*args)
                    nz = raycast.DepthNoise(*(x[r][sl] for x in noise))
                    imgs.append(raycast.process_depth(depth, cam.near, cam.far, nz,
                                                      env.cfg.depth.depth_noise))
                    keeps.append(raycast.crossing_mask(*args))
                out.append((torch.cat(imgs), torch.cat(keeps)))
    finally:
        core.tf32(old)
    return out


def image_numbers(images: List[torch.Tensor], ref: List) -> Dict[str, float]:
    """The images' gap over the kept pixels (the widest refresh's relative
    gap), the envs whose own gap there passes core.OUTLIER (summed over the
    refreshes), and, for the log, the share of pixels the crossing rule
    leaves out."""
    gaps, outliers, left = [], 0, 0.0
    for img, (r, keep) in zip(images, ref):
        k = keep.to(r.dtype)
        p = img.to(r.device) * k
        gaps.append(core.rel_gap(p, r * k))
        outliers += int((core.env_rel_gaps(p, r * k) > core.OUTLIER).sum())
        left += float((~keep).sum()) / keep.numel()
    if not gaps:
        return dict(depth_gap=float("inf"), depth_outliers=float("inf"), depth_left_out=1.0)
    return dict(depth_gap=max(gaps), depth_outliers=outliers, depth_left_out=left / len(ref))


def image_faults(ref: List) -> Dict[str, Dict[str, float]]:
    """The image faults read by `image_numbers` against the reference's
    images: each env's image taken from the next env (every env altered)
    and env 0's taken from env 1 (one env altered)."""
    def one(x):
        x = x.clone()
        x[0] = x[1]
        return x
    return dict(altered=image_numbers([torch.roll(r, 1, dims=0) for r, _ in ref], ref),
                one_env=image_numbers([one(r) for r, _ in ref], ref))
