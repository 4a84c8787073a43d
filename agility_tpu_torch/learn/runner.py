"""On-policy training runner for the BBC (counterpart of
agility_tpu/learn/runner.py): the Python loop around
`SSInfoGAIL.train_iteration`, with its log line, TensorBoard scalars and
checkpoints.

Checkpoints (io/checkpoint.py): every save writes the slim tree
(`checkpoint_tree`) in the flax msgpack layout as model_<step>.msgpack; a
full save also writes the exact-resume state (`full_state_tree`) with
torch.save as state_<step>.pt beside it.

Under env.shard (dist/mesh.py) rank 0 alone prints, writes metrics and
writes checkpoints; the exact-resume state gathers every rank's envs, so
its file is the one-rank run's, and a run of any world size resumes from
it, each rank taking its envs.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from agility_tpu_torch.dist import mesh
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv, LocoState
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.io.metrics import MetricWriter
from agility_tpu_torch.learn.policy import InferencePolicy
from agility_tpu_torch.learn.ssinfogail import AlgoCfg, SSInfoGAIL, metrics_to_host
from agility_tpu_torch.physics import engine as eng


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tree_shapes(tree, prefix=""):
    """{path: shape} of the tensors of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_shapes(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + str(k)] = tuple(v.shape)
    return out


# env-state fields that are not per env: the same on every rank
REPLICATED_FIELDS = ("prior_parameters",)


def map_env_leaves(tree, fn):
    """The env-state tree ({field: value}, sim a nested dict) with `fn`
    applied to each per-env tensor."""
    return {k: map_env_leaves(v, fn) if isinstance(v, dict)
            else fn(v) if isinstance(v, torch.Tensor) and v.ndim >= 1
            and k not in REPLICATED_FIELDS else v for k, v in tree.items()}


def env_state_tree(runner):
    """The runner's env state and disc window as one-rank tensors:
    gathered from every rank under a shard."""
    es, shard = runner.env_state, runner.env.shard
    tree = {"env_state": {**es._asdict(), "sim": es.sim._asdict()},
            "disc_hist": runner.disc_hist}
    if shard is None:
        return tree
    gather = lambda x: mesh.gather_rows(x, shard)
    return {"env_state": map_env_leaves(tree["env_state"], gather),
            "disc_hist": gather(runner.disc_hist)}


def restore_env_state(runner, saved, state_cls) -> None:
    """The env state and disc window of a one-rank exact-resume state,
    the rank's envs taken under a shard, into the runner."""
    shard, dev = runner.env.shard, runner.env.device
    take = (lambda x: shard.take(x).to(dev)) if shard else (lambda x: x.to(dev))
    es = map_env_leaves(dict(saved["env_state"]), take)
    sim = eng.EnvState(**{k: v.to(dev) for k, v in es.pop("sim").items()})
    runner.env_state = state_cls(
        sim=sim, **{k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in es.items()})
    runner.disc_hist = take(saved["disc_hist"])


def is_writer(runner) -> bool:
    """Whether this process writes logs and checkpoints: rank 0's."""
    return runner.env.shard is None or runner.env.shard.rank == 0


def save_checkpoints(runner, step: int, full: bool) -> str:
    """A runner's slim tree (`checkpoint_tree`) as model_<step>.msgpack in
    its log directory and, when `full`, its exact-resume state
    (`full_state_tree`, gathered from every rank) beside it, each pruned to
    the runner's rotation; rank 0 writes.  Returns the slim checkpoint's
    path."""
    state = runner.full_state_tree() if full else None
    path = os.path.join(runner.log_dir, f"model_{step}.msgpack")
    if not is_writer(runner):
        return path
    ckpt.save(path, runner.checkpoint_tree())
    ckpt.prune(runner.log_dir, "model", keep_latest=runner.keep_latest_slim,
               keep_every=runner.keep_every_slim)
    if full:
        torch.save(state, ckpt.state_path(path))
        ckpt.prune(runner.log_dir, "state", keep_latest=runner.keep_latest_full, ext=".pt")
    return path


def read_full_state(runner, path: str):
    """The exact-resume state beside slim checkpoint `path`, where there is
    one and its shapes match the runner's own; else None."""
    state_path = ckpt.sibling_state(path)
    if not state_path:
        return None
    saved = torch.load(state_path, map_location="cpu")
    want, got = tree_shapes(runner.full_state_tree()), tree_shapes(saved)
    bad = sorted(k for k in want if want[k] != got.get(k))
    if bad:
        print(f"full-state restore mismatch ({bad[:3]}); loading weights only")
        return None
    return saved


class OnPolicyRunner:
    def __init__(self, env: Go2LocomotionEnv, algo_cfg: AlgoCfg = AlgoCfg(),
                 log_dir: Optional[str] = None, seed: int = 1):
        self.env = env
        self.alg = SSInfoGAIL(env, algo_cfg, seed=seed)
        self.cfg = algo_cfg
        self.log_dir = log_dir
        self.writer = MetricWriter(log_dir) if log_dir and is_writer(self) else None
        self.save_interval = 100        # slim model checkpoint (reference cadence)
        self.full_save_interval = 1000  # full exact-resume state (big: ring + env)
        # rotation for long campaigns: the newest few of each artifact, plus
        # slim milestones every keep_every steps
        self.keep_latest_slim = 5
        self.keep_every_slim = 5000
        self.keep_latest_full = 2
        self.current_iteration = 0
        self.last_metrics = None        # the last iteration's metrics (device tensors)

        self.env_state = env.init_state()
        self.train_state = self.alg.init_train_state()
        self.disc_hist = self.env_state.disc_obs[:, None].repeat(1, env.cfg.env.disc_obs_len, 1)

    def learn(self, num_iterations: int, init_at_random_ep_len: bool = True,
              log_every: int = 10):
        env = self.env
        say = print if is_writer(self) else (lambda *a, **k: None)
        if init_at_random_ep_len:
            g = torch.Generator(device=env.device).manual_seed(0)
            ep = torch.randint(0, env.max_episode_length, (env.num_envs_global,), generator=g,
                               device=env.device)
            self.env_state = self.env_state._replace(
                episode_length=env.shard.take(ep) if env.shard else ep)

        t_start = time.time()
        steps_per_iter = self.cfg.num_steps_per_env * env.num_envs_global
        t_window = time.time()
        start_iter = self.current_iteration
        it_window = start_iter
        for it in range(start_iter, start_iter + num_iterations):
            self.train_state, self.env_state, self.disc_hist, metrics = self.alg.train_iteration(
                self.train_state, self.env_state, self.disc_hist, it)
            # mid-run checkpoints carry the true iteration
            self.current_iteration = it + 1
            self.last_metrics = metrics
            if (it + 1) % log_every == 0 or it == start_iter:
                m = metrics_to_host(metrics)   # waits for the device
                now = time.time()
                fps = (it + 1 - it_window) * steps_per_iter / max(now - t_window, 1e-9)
                t_window, it_window = now, it + 1
                if self.writer:
                    self.writer.scalars(m, it)
                    self.writer.scalar("perf/fps", fps, it)
                    self.writer.flush()
                say(f"it {it:6d} | r_total {m['rollout/r_total']:+.4f} "
                      f"| r_t {m['rollout/r_t']:+.4f} "
                      f"| surr {m['ppo/surrogate']:+.4f} "
                      f"| disc {m['disc/disc']:.4f} "
                      f"| fps {fps:,.0f}", flush=True)
            if self.log_dir and (it + 1) % self.save_interval == 0:
                self.save(it + 1, full=(it + 1) % self.full_save_interval == 0)
            self.alg.mark("end")
        if self.log_dir:
            self.save(self.current_iteration)   # final save: exact-resume
        sync(env.device)
        total = time.time() - t_start
        say(f"trained {num_iterations} iters in {total:.1f}s "
            f"({num_iterations * steps_per_iter / total:,.0f} env-steps/s)")

    # ------------------------------------------------------------------

    def checkpoint_tree(self):
        """The slim artifact, in the flax layout: what play and the BBC ->
        TSC frozen-weight handoff read."""
        ts = self.train_state
        tree = ckpt.params_to_jax(ts.ac.state_dict(), ts.est.state_dict(), ts.disc.state_dict())
        cpu = lambda t: t.detach().cpu().numpy()
        tree.update(
            disc_norm={k: cpu(v) for k, v in ts.disc_norm.state_dict().items()},
            prior_parameters=cpu(ts.prior_parameters),
            lr_ac=np.asarray(ts.lr_ac, np.float32),
            iteration=np.asarray(self.current_iteration, np.int32))
        return tree

    def full_state_tree(self):
        """Everything an exact resume needs: the modules, the six optimisers,
        the ring, the normaliser, the counters, task_obs_weight, the trainer's
        and the env's generator states, the env state and the disc window
        (every rank's envs: the one-rank layout)."""
        ts = self.train_state
        return {
            "modules": {"ac": ts.ac.state_dict(), "est": ts.est.state_dict(),
                        "disc": ts.disc.state_dict()},
            "optimisers": {k: getattr(ts, k).state_dict() for k in (
                "ac_opt", "hist_opt", "est_opt", "disc_opt_d", "disc_opt_qe", "disc_opt_qc")},
            "disc_norm": ts.disc_norm.state_dict(),
            "ring": ts.ring.state_dict(),
            "prior_parameters": ts.prior_parameters,
            "lr_ac": float(ts.lr_ac), "task_obs_weight": float(ts.task_obs_weight),
            "learning_steps": ts.learning_steps, "priv_reg_counter": ts.priv_reg_counter,
            "generators": {"trainer": self.alg.gen.get_state(), "env": self.env.gen.get_state()},
            **env_state_tree(self),
            "iteration": self.current_iteration,
        }

    def save(self, step: int, full: bool = True) -> str:
        """The slim checkpoint every call; the exact-resume state beside it
        when `full`."""
        return save_checkpoints(self, step, full)

    def load(self, path: str):
        """Restore from a slim checkpoint path: exactly from the state file
        beside it where there is one and its shapes match this run's, else
        the weights, the normaliser, the prior and the learning rate."""
        saved = read_full_state(self, path)
        if saved is not None:
            self._restore(saved)
            self.current_iteration = max(int(saved["iteration"]), ckpt.step_of(path) or 0)
            return
        tree = ckpt.read_msgpack(path)
        sd = ckpt.params_from_jax(tree)
        ts = self.train_state
        dev = self.env.device
        ts.ac.load_state_dict(sd["actor_critic"])
        ts.est.load_state_dict(sd["estimator"])
        ts.disc.load_state_dict(sd["discriminator"])
        ts.disc_norm.load_state_dict(tree["disc_norm"])
        ts.prior_parameters = torch.as_tensor(tree["prior_parameters"]).to(dev)
        ts.lr_ac = np.float32(tree["lr_ac"])
        self.current_iteration = max(int(tree["iteration"]), ckpt.step_of(path) or 0)
        # a slim checkpoint carries no task_obs_weight: it is a function of
        # the iteration (1 -> 0 over task_obs_weight_decay_steps)
        ncfg = self.env.cfg.normalization
        if ncfg.task_obs_weight_decay and ncfg.task_obs_weight_decay_steps:
            ts.task_obs_weight = np.float32(
                max(0.0, 1.0 - self.current_iteration / ncfg.task_obs_weight_decay_steps))

    def _restore(self, saved) -> None:
        ts = self.train_state
        dev = self.env.device
        for k, m in (("ac", ts.ac), ("est", ts.est), ("disc", ts.disc)):
            m.load_state_dict(saved["modules"][k])
        for k, sd in saved["optimisers"].items():
            getattr(ts, k).load_state_dict(sd)
        ts.disc_norm.load_state_dict(saved["disc_norm"])
        ts.ring.load_state_dict(saved["ring"])
        ts.prior_parameters = saved["prior_parameters"].to(dev)
        ts.lr_ac = np.float32(saved["lr_ac"])
        ts.task_obs_weight = np.float32(saved["task_obs_weight"])
        ts.learning_steps = int(saved["learning_steps"])
        ts.priv_reg_counter = int(saved["priv_reg_counter"])
        self.alg.gen.set_state(saved["generators"]["trainer"])
        self.env.gen.set_state(saved["generators"]["env"])
        restore_env_state(self, saved, LocoState)

    def get_inference_policy(self) -> InferencePolicy:
        """The deterministic policy (estimator swap-in, history-encoded
        latent) on the current weights."""
        return InferencePolicy(self.train_state.ac, self.train_state.est)
