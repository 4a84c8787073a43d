"""The flax msgpack checkpoint read in plain Python and numpy, and the BBC's
state dicts from its tree: a frozen copy of the reader of the port's
io/checkpoint.py (read_msgpack, params_from_jax), so the reference loads
the played weights from the file itself."""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        b = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode()
            if b in (0xDC, 0xDD):
                return [self.obj() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (1, 3):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, raw = _Reader(data).obj()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == 1 else arr[()]


def read_msgpack(path: str) -> Any:
    """The nested dict of numpy arrays a flax msgpack checkpoint holds."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes in {path}")
    return tree


def _dense(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": torch.as_tensor(np.asarray(p["kernel"]).T.copy()),
            f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"]))}


def _conv(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": torch.as_tensor(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)).copy()),
            f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"]))}


def _mlp(p, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(len(p)):
        out.update(_dense(p[f"Dense_{i}"], f"{prefix}.layers.{i}"))
    return out


def _history_encoder(he, prefix: str) -> Dict[str, torch.Tensor]:
    out = _dense(he["Dense_0"], f"{prefix}.proj")
    out.update(_conv(he["Conv_0"], f"{prefix}.conv0"))
    out.update(_conv(he["Conv_1"], f"{prefix}.conv1"))
    out.update(_dense(he["Dense_1"], f"{prefix}.out"))
    return out


def _disc(p, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(2):
        out.update(_dense(p[f"Dense_{i}"], f"{prefix}trunk.{i}"))
    for h in ("head_logit", "head_eps", "head_classifier"):
        out.update(_dense(p[h], prefix + h))
    return out


def params_from_jax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """State dicts {"actor_critic": ..., "estimator": ...} for
    networks.ActorCritic / networks.Estimator from a flax checkpoint tree
    (`ac_params`, `est_params`), and "discriminator" for
    networks.Discriminator where the tree has `disc_params`."""
    ac = tree["ac_params"]["params"]
    sd = {"std": torch.as_tensor(np.asarray(ac["std"]))}
    sd.update(_mlp(ac["priv_encoder"], "priv_encoder"))
    sd.update(_history_encoder(ac["history_encoder"], "history_encoder"))
    sd.update(_mlp(ac["actor_trunk"], "actor_trunk"))
    sd.update(_dense(ac["actor_head"], "actor_head"))
    sd.update(_mlp(ac["critic_trunk"], "critic_trunk"))
    sd.update(_dense(ac["critic_head"], "critic_head"))
    est = _mlp(tree["est_params"]["params"]["MLP_0"], "mlp")
    out = {"actor_critic": sd, "estimator": est}
    if "disc_params" in tree:
        out["discriminator"] = _disc(tree["disc_params"]["params"])
    return out
