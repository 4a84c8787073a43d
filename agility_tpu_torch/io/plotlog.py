"""Play-time state logger with matplotlib plots (counterpart of
agility_tpu/io/plotlog.py; reference bbc/legged_gym/utils/logger.py):
accumulates per-step state dicts during evaluation and renders
velocity-tracking / torque / contact panels plus mean episode reward
contributions.  Values may be tensors on any device; each is copied to the
host as it is logged.  matplotlib is imported only by `plot_states`."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class Logger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key: str, value):
        self.state_log[key].append(_host(value))

    def log_states(self, d: Dict):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: Dict, num_episodes: int):
        for k, v in d.items():
            self.rew_log[k].append(float(np.sum(_host(v))))
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()
        self.num_episodes = 0

    def plot_states(self, save_path: Optional[str] = None):
        """Velocity tracking / base height / torques / contacts panels
        (reference logger.py:32-124).  Saves to file when given a path (we
        run headless); otherwise shows interactively."""
        import matplotlib

        if save_path:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        log = {k: np.stack(v) for k, v in self.state_log.items() if v}
        t = np.arange(len(next(iter(log.values())))) * self.dt
        fig, axs = plt.subplots(2, 3, figsize=(15, 8))

        def panel(ax, keys, title, ylabel):
            for k in keys:
                if k in log:
                    ax.plot(t[: len(log[k])], log[k], label=k)
            ax.set(title=title, xlabel="time [s]", ylabel=ylabel)
            ax.legend(fontsize=7)

        panel(axs[0, 0], ["base_vel_x", "command_x"], "Base velocity x", "m/s")
        panel(axs[0, 1], ["base_vel_y", "command_y"], "Base velocity y", "m/s")
        panel(axs[0, 2], ["base_vel_yaw", "command_yaw"], "Yaw rate", "rad/s")
        panel(axs[1, 0], ["base_height"], "Base height", "m")
        panel(axs[1, 1], ["dof_torque"], "Joint torque", "Nm")
        panel(axs[1, 2], ["contact_forces_z"], "Foot contact force", "N")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=120)
            print(f"state plots written to {save_path}")
        else:
            plt.show()
        return fig

    def print_rewards(self):
        print("Average rewards per second:")
        for k, v in self.rew_log.items():
            mean = np.sum(np.array(v)) / max(1, self.num_episodes)
            print(f"  {k}: {mean:.4f}")
