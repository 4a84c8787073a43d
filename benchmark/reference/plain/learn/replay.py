"""Fixed-capacity device ring of the discriminator's policy transitions
(counterpart of agility_tpu/learn/replay.py): rows of disc_obs_len x 49
features, eps and c.  The cursor and size are host integers: every insert
has the same, static number of rows."""
from __future__ import annotations

import torch


class Ring:
    def __init__(self, capacity: int, dim: int, device="cuda"):
        self.data = torch.zeros((capacity, dim), device=device)
        self.cursor = 0
        self.size = 0

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def insert(self, rows: torch.Tensor) -> None:
        """Write a block of rows at the cursor; the capacity must be a
        multiple of the block size, so a block never straddles the end."""
        n = rows.shape[0]
        if self.capacity % n:
            raise ValueError(f"ring capacity {self.capacity} is not a multiple of {n} rows")
        self.data[self.cursor:self.cursor + n] = rows
        self.cursor = (self.cursor + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def sample(self, idx: torch.Tensor) -> torch.Tensor:
        """The rows at `idx`, drawn uniform over max(size, 1) rows by the
        trainer (learn/ssinfogail.py)."""
        return self.data[idx]

    def state_dict(self):
        return {"data": self.data, "cursor": self.cursor, "size": self.size}

    def load_state_dict(self, sd) -> None:
        if sd["data"].shape != self.data.shape:
            raise ValueError(f"ring shape {tuple(sd['data'].shape)} != {tuple(self.data.shape)}")
        self.data.copy_(sd["data"])
        self.cursor, self.size = int(sd["cursor"]), int(sd["size"])
