"""TSC teacher training runner (counterpart of
agility_tpu/learn/runner_tsc.py): the Python loop around
`TscPPO.train_iteration`, with its log line, TensorBoard scalars and
checkpoints.  The frozen BBC comes from io/checkpoint.load_bbc_frozen.

Checkpoints (io/checkpoint.py): every save writes the slim tree
(`checkpoint_tree`: ac_params, est_params, lr, iteration) in the flax
msgpack layout as model_<step>.msgpack, which the port's play_tsc and the
JAX package's checkpoint.load_into read; a full save also writes the
exact-resume state (`full_state_tree`) with torch.save as state_<step>.pt
beside it.  Under env.shard rank 0 alone prints and writes, as in
learn/runner.py.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from agility_tpu_torch.envs.go2_agility import AgilityState, Go2AgilityEnv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.io.metrics import MetricWriter
from agility_tpu_torch.learn.ppo_tsc import BBCFrozen, TscAlgoCfg, TscPPO
from agility_tpu_torch.learn.runner import (env_state_tree, is_writer, read_full_state,
                                            restore_env_state, save_checkpoints, sync,
                                            write_spans)
from agility_tpu_torch.learn.ssinfogail import metrics_to_host


class TscOnPolicyRunner:
    def __init__(self, env: Go2AgilityEnv, bbc: BBCFrozen, algo_cfg: TscAlgoCfg = TscAlgoCfg(),
                 log_dir: Optional[str] = None, seed: int = 1):
        self.env = env
        self.alg = TscPPO(env, bbc, algo_cfg, seed=seed)
        self.cfg = algo_cfg
        self.log_dir = log_dir
        self.writer = MetricWriter(log_dir) if log_dir and is_writer(self) else None
        self.save_interval = 100        # slim model checkpoint
        self.full_save_interval = 1000  # full exact-resume state (big: env state)
        self.keep_latest_slim = 5
        self.keep_every_slim = 5000
        self.keep_latest_full = 2
        self.current_iteration = 0
        self.last_metrics = None        # the last iteration's metrics (device tensors)

        self.env_state = env.init_state()
        self.train_state = self.alg.init_train_state()
        self.disc_hist = self.env_state.disc_obs[:, None].repeat(1, env.cfg.env.disc_obs_len, 1)

    def learn(self, num_iterations: int, log_every: int = 10):
        env = self.env
        say = print if is_writer(self) else (lambda *a, **k: None)
        steps_per_iter = self.cfg.num_steps_per_env * env.num_envs_global
        t_start = t_window = time.time()
        start_iter = it_window = self.current_iteration
        for it in range(start_iter, start_iter + num_iterations):
            self.train_state, self.env_state, self.disc_hist, metrics = self.alg.train_iteration(
                self.train_state, self.env_state, self.disc_hist, it)
            # mid-run checkpoints carry the true iteration
            self.current_iteration = it + 1
            self.last_metrics = metrics
            if (it + 1) % log_every == 0 or it == start_iter:
                es = self.env_state
                m = metrics_to_host({**metrics, "Train/mean_success_rate": es.success_rate,
                                     "Train/success_rate_from_start": es.success_rate_s0,
                                     "Train/goal_progress": es.goal_progress})
                train = {k: m.pop(k) for k in list(m) if k.startswith("Train/")}
                now = time.time()
                n = it + 1 - it_window
                fps = n * steps_per_iter / max(now - t_window, 1e-9)
                t_window, it_window = now, it + 1
                if self.writer:
                    self.writer.scalars(m, it)
                    self.writer.scalar("perf/fps", fps, it)
                    for k, v in train.items():
                        self.writer.scalar(k, v, it)
                    write_spans(self.writer, it, n)
                    self.writer.flush()
                say(f"it {it:6d} | r {m['rollout/r_total']:+.4f} "
                      f"| r_t {m['rollout/r_t']:+.4f} "
                      f"| goal {m['rollout/goal_idx']:.2f} "
                      f"| succ {train['Train/mean_success_rate']:.3f} "
                      f"| succ0 {train['Train/success_rate_from_start']:.3f} "
                      f"| prog {train['Train/goal_progress']:.2f} "
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
        """The slim artifact, the JAX TSC runner's layout: the teacher
        policy and its estimator."""
        ts = self.train_state
        tree = ckpt.params_to_jax_tsc(ts.ac.state_dict(), ts.est.state_dict())
        tree.update(lr=np.asarray(ts.lr, np.float32),
                    iteration=np.asarray(self.current_iteration, np.int32))
        return tree

    def full_state_tree(self):
        """Everything an exact resume needs: the modules, the three
        optimisers, the learning rate, the priv-reg counter, the trainer's
        and the env's generator states, the env state and the disc window
        (every rank's envs: the one-rank layout)."""
        ts = self.train_state
        return {
            "modules": {"ac": ts.ac.state_dict(), "est": ts.est.state_dict()},
            "optimisers": {k: getattr(ts, k).state_dict()
                           for k in ("ac_opt", "hist_opt", "est_opt")},
            "lr": float(ts.lr), "priv_reg_counter": ts.priv_reg_counter,
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
        the weights and the learning rate."""
        saved = read_full_state(self, path)
        if saved is not None:
            self._restore(saved)
            self.current_iteration = max(int(saved["iteration"]), ckpt.step_of(path) or 0)
            return
        tree = ckpt.read_msgpack(path)
        sd = ckpt.params_from_jax_tsc(tree)
        self.train_state.ac.load_state_dict(sd["actor_critic"])
        self.train_state.est.load_state_dict(sd["estimator"])
        self.train_state.lr = np.float32(tree["lr"])
        self.current_iteration = max(int(tree["iteration"]), ckpt.step_of(path) or 0)

    def _restore(self, saved) -> None:
        ts = self.train_state
        ts.ac.load_state_dict(saved["modules"]["ac"])
        ts.est.load_state_dict(saved["modules"]["est"])
        for k, sd in saved["optimisers"].items():
            getattr(ts, k).load_state_dict(sd)
        ts.lr = np.float32(saved["lr"])
        ts.priv_reg_counter = int(saved["priv_reg_counter"])
        self.alg.gen.set_state(saved["generators"]["trainer"])
        self.env.gen.set_state(saved["generators"]["env"])
        restore_env_state(self, saved, AgilityState)
