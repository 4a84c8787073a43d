"""Checkpoints in the JAX package's flax msgpack layout, read and written
without flax or msgpack (counterpart of agility_tpu/io/checkpoint.py).

`read_msgpack` decodes the msgpack subset flax writes: maps, arrays, str,
bin, nil/bool, ints, floats, and flax's ext types 1 (ndarray) and 3 (numpy
scalar), whose payload is a msgpack (shape, dtype name, raw bytes) triple;
`write_msgpack` encodes the same subset, byte for byte as flax's
`serialization.to_bytes` does for a tree of dicts, arrays and scalars.
`params_from_jax` (BBC) and `params_from_jax_tsc` (TSC teacher) carry the
flax parameter trees across to the port's modules, and `params_to_jax` and
`params_to_jax_tsc` carry them back:
  * a flax Dense kernel is (in, out); nn.Linear.weight is (out, in);
  * a flax Conv kernel is (k, in, out) over (..., T, C) input; nn.Conv1d's
    weight is (out, in, k) over (B, C, T).

A BBC training run writes two artifacts (learn/runner.py):
  * model_<step>.msgpack, the slim tree (ac_params, est_params, disc_params,
    disc_norm, prior_parameters, lr_ac, iteration) in the flax layout, which
    the port's play_bbc and load_bbc_frozen and the JAX package's
    `checkpoint.load_into` all read;
  * state_<step>.pt beside it, the port's own exact-resume state written
    with torch.save: the optimisers, the replay ring and the normaliser, the
    counters, task_obs_weight, the generators' states, the env state and
    the disc window.  The JAX package does not read it.
A TSC teacher run (learn/runner_tsc.py) writes the same two kinds: the
slim tree is the JAX TSC runner's (ac_params, est_params, lr, iteration).
A depth-student run (learn/vision_tsc.py) writes vision_<step>.msgpack,
{enc_params, actor_params} in the JAX train_tsc --use_camera layout;
`params_from_jax_vision` and `params_to_jax_vision` carry the encoder, the
student actor-critic and the BYOL nets across.
"""
from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from agility_tpu_torch.learn import networks as nets
from agility_tpu_torch.learn.ppo_tsc import BBCFrozen


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


def _pack(obj, out: list) -> None:
    """msgpack encoding of `obj` into the byte chunks `out`, smallest form
    first, as msgpack-python packs it."""
    def head(n, small, fixbase, codes):
        if n < small:
            out.append(bytes([fixbase | n]))
            return
        for limit, code, fmt in codes:
            if n < limit:
                out.append(struct.pack(">B" + fmt, code, n))
                return
        raise ValueError(f"msgpack: length {n} too large")

    big = ((1 << 16, 0xDC, "H"), (1 << 32, 0xDD, "I"))
    if obj is None or isinstance(obj, bool):
        out.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[obj]]))
    elif isinstance(obj, int):
        if -32 <= obj < 128:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
            return
        ranges = ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16), (0xCE, ">I", 0, 1 << 32),
                  (0xCF, ">Q", 0, 1 << 64)) if obj >= 0 else (
            (0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
            (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0))
        code, fmt, _, _ = next(r for r in ranges if r[2] <= obj < r[3])
        out.append(bytes([code]) + struct.pack(fmt, obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode()
        head(len(b), 32, 0xA0, ((1 << 8, 0xD9, "B"), (1 << 16, 0xDA, "H"), (1 << 32, 0xDB, "I")))
        out.append(b)
    elif isinstance(obj, bytes):
        head(len(obj), 0, 0, ((1 << 8, 0xC4, "B"), (1 << 16, 0xC5, "H"), (1 << 32, 0xC6, "I")))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        head(len(obj), 16, 0x90, big)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        head(len(obj), 16, 0x80, ((1 << 16, 0xDE, "H"), (1 << 32, 0xDF, "I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        # flax's ext 1 (ndarray) / 3 (numpy scalar): packed (shape, dtype, bytes)
        code = 3 if isinstance(obj, np.generic) else 1
        arr = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)
        payload = []
        _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), payload)
        data = b"".join(payload)
        fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fix:
            out.append(struct.pack(">Bb", fix[len(data)], code))
        else:
            head(len(data), 0, 0, ((1 << 8, 0xC7, "B"), (1 << 16, 0xC8, "H"), (1 << 32, 0xC9, "I")))
            out.append(struct.pack(">b", code))
        out.append(data)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def write_msgpack(path: str, tree: Any) -> None:
    """Write a nested dict of arrays (numpy or torch) and scalars as flax's
    msgpack checkpoint bytes."""
    out = []
    _pack(tree, out)
    with open(path, "wb") as f:
        f.write(b"".join(out))


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


def _to_dense(sd, prefix: str) -> Dict[str, np.ndarray]:
    w = sd[f"{prefix}.weight"].detach().cpu().numpy()
    return {"kernel": np.ascontiguousarray(w.T), "bias": sd[f"{prefix}.bias"].detach().cpu().numpy()}


def _to_conv(sd, prefix: str) -> Dict[str, np.ndarray]:
    w = sd[f"{prefix}.weight"].detach().cpu().numpy()
    return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0))),
            "bias": sd[f"{prefix}.bias"].detach().cpu().numpy()}


def _to_mlp(sd, prefix: str) -> Dict[str, Dict[str, np.ndarray]]:
    n = len({k.split(".")[2] for k in sd if k.startswith(prefix + ".layers.")})
    return {f"Dense_{i}": _to_dense(sd, f"{prefix}.layers.{i}") for i in range(n)}


def params_to_jax(ac_sd, est_sd, disc_sd) -> Dict[str, Any]:
    """The flax parameter trees {"ac_params", "est_params", "disc_params"}
    of the BBC's state dicts (the inverse of params_from_jax)."""
    ac = {"std": ac_sd["std"].detach().cpu().numpy()}
    for m in ("priv_encoder", "actor_trunk", "critic_trunk"):
        ac[m] = _to_mlp(ac_sd, m)
    ac["history_encoder"] = {"Dense_0": _to_dense(ac_sd, "history_encoder.proj"),
                             "Conv_0": _to_conv(ac_sd, "history_encoder.conv0"),
                             "Conv_1": _to_conv(ac_sd, "history_encoder.conv1"),
                             "Dense_1": _to_dense(ac_sd, "history_encoder.out")}
    for h in ("actor_head", "critic_head"):
        ac[h] = _to_dense(ac_sd, h)
    disc = {f"Dense_{i}": _to_dense(disc_sd, f"trunk.{i}") for i in range(2)}
    for h in ("head_logit", "head_eps", "head_classifier"):
        disc[h] = _to_dense(disc_sd, h)
    return {"ac_params": {"params": ac},
            "est_params": {"params": {"MLP_0": _to_mlp(est_sd, "mlp")}},
            "disc_params": {"params": disc}}


def _tsc_ac(ac) -> Dict[str, torch.Tensor]:
    """networks_tsc.ActorCriticTSC's state dict from its flax params."""
    sd = {"std": torch.as_tensor(np.asarray(ac["std"]))}
    sd.update(_mlp(ac["priv_encoder"], "priv_encoder"))
    sd.update(_history_encoder(ac["history_encoder"], "history_encoder"))
    sd.update(_mlp(ac["scan_encoder"], "scan_encoder"))
    sd.update(_mlp(ac["actor_trunk"], "actor_trunk"))
    sd.update(_dense(ac["actor_d"], "actor_d"))
    sd.update(_dense(ac["actor_c"], "actor_c"))
    sd.update(_mlp(ac["critic_trunk"], "critic_trunk"))
    sd.update(_dense(ac["critic_head"], "critic_head"))
    return sd


def params_from_jax_tsc(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """State dicts {"actor_critic": ..., "estimator": ...} for
    networks_tsc.ActorCriticTSC / networks.Estimator from a TSC teacher's
    flax checkpoint tree (`ac_params`, `est_params`)."""
    est = _mlp(tree["est_params"]["params"]["MLP_0"], "mlp")
    return {"actor_critic": _tsc_ac(tree["ac_params"]["params"]), "estimator": est}


def _to_tsc_ac(ac_sd) -> Dict[str, Any]:
    """ActorCriticTSC's flax params from its state dict."""
    ac = {"std": ac_sd["std"].detach().cpu().numpy()}
    for m in ("priv_encoder", "scan_encoder", "actor_trunk", "critic_trunk"):
        ac[m] = _to_mlp(ac_sd, m)
    ac["history_encoder"] = {"Dense_0": _to_dense(ac_sd, "history_encoder.proj"),
                             "Conv_0": _to_conv(ac_sd, "history_encoder.conv0"),
                             "Conv_1": _to_conv(ac_sd, "history_encoder.conv1"),
                             "Dense_1": _to_dense(ac_sd, "history_encoder.out")}
    for h in ("actor_d", "actor_c", "critic_head"):
        ac[h] = _to_dense(ac_sd, h)
    return ac


def params_to_jax_tsc(ac_sd, est_sd) -> Dict[str, Any]:
    """The flax parameter trees {"ac_params", "est_params"} of a TSC
    teacher's state dicts (the inverse of params_from_jax_tsc)."""
    return {"ac_params": {"params": _to_tsc_ac(ac_sd)},
            "est_params": {"params": {"MLP_0": _to_mlp(est_sd, "mlp")}}}


# ---------------------------------------------------------------------------
# the depth student (learn/depth.py): flax Conv kernels are HWIO over NHWC
# input, nn.Conv2d weights OIHW; the GRU's (r, z, n) kernels are stacked
# ---------------------------------------------------------------------------

_GATES = ("r", "z", "n")


def _conv2d(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": torch.as_tensor(
                np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)).copy()),
            f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"]))}


def _backbone(p, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(2):
        out.update(_conv2d(p[f"Conv_{i}"], f"{prefix}.conv{i}"))
        out.update(_dense(p[f"Dense_{i}"], f"{prefix}.fc{i}"))
    return out


def _encoder(p) -> Dict[str, torch.Tensor]:
    """RecurrentDepthEncoder's state dict from its flax params."""
    sd = _backbone(p["backbone"], "backbone")
    sd.update(_dense(p["combine"]["layers_0"], "combine.layers.0"))
    sd.update(_dense(p["combine"]["layers_2"], "combine.layers.1"))
    g = p["gru"]
    stack = lambda side, k, t=lambda a: a: torch.as_tensor(np.concatenate(
        [t(np.asarray(g[side + gate][k])) for gate in _GATES]))
    sd.update({"gru.w_i": stack("i", "kernel", np.transpose), "gru.b_i": stack("i", "bias"),
               "gru.w_h": stack("h", "kernel", np.transpose),
               "gru.b_hn": torch.as_tensor(np.asarray(g["hn"]["bias"]))})
    sd.update(_dense(p["out"], "out"))
    return sd


def _byol(v) -> Dict[str, torch.Tensor]:
    """BYOLNets' state dict from its flax variables {"params", "batch_stats"}."""
    p, stats = v["params"], v["batch_stats"]
    sd = _backbone(p["backbone"], "backbone")
    for head in ("projector", "predictor"):
        sd.update(_dense(p[head]["Dense_0"], f"{head}.fc0"))
        sd.update(_dense(p[head]["Dense_1"], f"{head}.fc1"))
        for k, src in (("scale", p), ("bias", p), ("mean", stats), ("var", stats)):
            sd[f"{head}.bn.{k}"] = torch.as_tensor(np.asarray(src[head]["BatchNorm_0"][k]))
    return sd


def params_from_jax_vision(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """State dicts for the depth student from flax trees: "encoder"
    (learn/depth.RecurrentDepthEncoder) from `enc_params` and
    "actor_critic" (the student's ActorCriticTSC) from `actor_params`, the
    two a vision_<step>.msgpack checkpoint holds; and, where the tree has
    them, "byol_online" / "byol_target" (learn/depth.BYOLNets) from the
    BYOL variables `byol_online` / `byol_target`."""
    out = {"encoder": _encoder(tree["enc_params"]["params"]),
           "actor_critic": _tsc_ac(tree["actor_params"]["params"])}
    for k in ("byol_online", "byol_target"):
        if k in tree:
            out[k] = _byol(tree[k])
    return out


def _to_conv2d(sd, prefix: str) -> Dict[str, np.ndarray]:
    w = sd[f"{prefix}.weight"].detach().cpu().numpy()
    return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
            "bias": sd[f"{prefix}.bias"].detach().cpu().numpy()}


def _to_backbone(sd, prefix: str) -> Dict[str, Dict[str, np.ndarray]]:
    out = {}
    for i in range(2):
        out[f"Conv_{i}"] = _to_conv2d(sd, f"{prefix}.conv{i}")
        out[f"Dense_{i}"] = _to_dense(sd, f"{prefix}.fc{i}")
    return out


def _to_encoder(sd) -> Dict[str, Any]:
    np_ = lambda k: sd[k].detach().cpu().numpy()
    w_i, b_i, w_h = np_("gru.w_i"), np_("gru.b_i"), np_("gru.w_h")
    H = w_h.shape[1]
    gru = {}
    for j, g in enumerate(_GATES):
        rows = slice(j * H, (j + 1) * H)
        gru[f"i{g}"] = {"kernel": np.ascontiguousarray(w_i[rows].T), "bias": b_i[rows]}
        gru[f"h{g}"] = {"kernel": np.ascontiguousarray(w_h[rows].T)}
    gru["hn"]["bias"] = np_("gru.b_hn")
    return {"backbone": _to_backbone(sd, "backbone"),
            "combine": {"layers_0": _to_dense(sd, "combine.layers.0"),
                        "layers_2": _to_dense(sd, "combine.layers.1")},
            "gru": gru, "out": _to_dense(sd, "out")}


def _to_byol(sd) -> Dict[str, Any]:
    params, stats = {"backbone": _to_backbone(sd, "backbone")}, {}
    for head in ("projector", "predictor"):
        bn = lambda k: sd[f"{head}.bn.{k}"].detach().cpu().numpy()
        params[head] = {"Dense_0": _to_dense(sd, f"{head}.fc0"),
                        "BatchNorm_0": {"scale": bn("scale"), "bias": bn("bias")},
                        "Dense_1": _to_dense(sd, f"{head}.fc1")}
        stats[head] = {"BatchNorm_0": {"mean": bn("mean"), "var": bn("var")}}
    return {"params": params, "batch_stats": stats}


def params_to_jax_vision(enc_sd, actor_sd, byol_online_sd=None, byol_target_sd=None
                         ) -> Dict[str, Any]:
    """The flax trees {"enc_params", "actor_params"} of the depth student's
    state dicts (a vision_<step>.msgpack checkpoint's content), plus
    "byol_online" / "byol_target" where given (the inverse of
    params_from_jax_vision)."""
    tree = {"enc_params": {"params": _to_encoder(enc_sd)},
            "actor_params": {"params": _to_tsc_ac(actor_sd)}}
    for k, sd in (("byol_online", byol_online_sd), ("byol_target", byol_target_sd)):
        if sd is not None:
            tree[k] = _to_byol(sd)
    return tree


def load_bbc_frozen(path: Optional[str], seed: int = 0) -> BBCFrozen:
    """The frozen BBC (actor-critic, estimator, discriminator and its
    normaliser) as host state dicts, from a BBC checkpoint file
    (counterpart of agility_tpu/learn/runner_tsc.load_bbc_frozen).  With no
    path, flax-style initial values drawn from `seed` and a fresh
    normaliser (an untrained low level, for smoke runs and the bench)."""
    if path:
        tree = read_msgpack(path)
        sd = params_from_jax(tree)
        norm = {k: torch.as_tensor(np.asarray(tree["disc_norm"][k], np.float32))
                for k in ("mean", "var", "count")}
        return BBCFrozen(sd["actor_critic"], sd["estimator"], sd["discriminator"], norm)
    g = torch.Generator().manual_seed(seed)
    ac, est, disc = (nets.flax_init_(m, g).state_dict() for m in (
        nets.ActorCritic(nets.ObsSlices(57, 4, 29, 10, 11), num_actions=12),
        nets.Estimator(57, 4), nets.Discriminator(98, dim_c=5)))
    norm = {"mean": torch.zeros(98), "var": torch.ones(98), "count": torch.tensor(1e-4)}
    return BBCFrozen(ac, est, disc, norm)


# ---------------------------------------------------------------------------
# files: <prefix>_<step><ext> in a run's log directory
# ---------------------------------------------------------------------------


def save(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Write a slim tree in the flax msgpack layout; with `step`, as
    <base>_<step>.msgpack.  Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if step is not None:
        base, ext = os.path.splitext(path)
        path = f"{base}_{step}{ext or '.msgpack'}"
    write_msgpack(path, tree)
    return path


def step_of(path: str) -> Optional[int]:
    """The step of a <prefix>_<step>.msgpack file name (None without one)."""
    m = re.search(r"_(\d+)\.msgpack$", os.path.basename(path))
    return int(m.group(1)) if m else None


def state_path(model_path: str) -> str:
    """The exact-resume file beside a slim checkpoint:
    model_<step>.msgpack -> state_<step>.pt."""
    d, name = os.path.split(model_path)
    return os.path.join(d, "state" + os.path.splitext(name[len("model"):])[0] + ".pt")


def sibling_state(model_path: str) -> Optional[str]:
    """The exact-resume file beside a slim checkpoint, if it exists."""
    if not os.path.basename(model_path).startswith("model"):
        return None
    p = state_path(model_path)
    return p if os.path.exists(p) else None


def prune(log_dir: str, prefix: str = "model", keep_latest: int = 5,
          keep_every: int = 0, ext: str = ".msgpack") -> int:
    """Delete old <prefix>_<step><ext> files, keeping the newest
    `keep_latest` and (keep_every > 0) every multiple of `keep_every`.
    Returns the number removed."""
    if not os.path.isdir(log_dir):
        return 0
    pat = re.compile(rf"{re.escape(prefix)}_(\d+){re.escape(ext)}$")
    steps = sorted((int(m.group(1)), m.group(0))
                   for m in (pat.match(n) for n in os.listdir(log_dir)) if m)
    removed = 0
    for step, name in steps[:-keep_latest] if keep_latest else steps:
        if keep_every and step % keep_every == 0:
            continue
        os.remove(os.path.join(log_dir, name))
        removed += 1
    return removed


def latest(log_dir: str, prefix: str = "model") -> Optional[str]:
    """The newest <prefix>[_<step>].msgpack in `log_dir`, or None."""
    if not os.path.isdir(log_dir):
        return None
    best, best_step = None, -1
    pat = re.compile(rf"{re.escape(prefix)}(?:_(\d+))?\.msgpack$")
    for name in os.listdir(log_dir):
        m = pat.match(name)
        if m:
            step = int(m.group(1) or 0)
            if step > best_step:
                best, best_step = os.path.join(log_dir, name), step
    return best
