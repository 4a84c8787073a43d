"""Inputs shared by the port's kernel tests (imports no jax, so the
card-only tests can run where jax is not installed)."""
import numpy as np
import torch

from agility_tpu_torch.core.urdf import build_go2_model
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics import soa as tsoa
from agility_tpu_torch.physics.constants import ModelConsts

TMC = ModelConsts.from_model(build_go2_model(), "cpu")
N, S = 8, 24
CFG = teng.EngineConfig()


def batch_case(seed=0, device="cpu"):
    """(EnvState, Control, EnvParams, HeightGrid) of N random Go2 states
    low over a rough grid, so that some spheres are in contact."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    bp = np.concatenate([rng.normal(0, 0.2, (N, 2)), np.full((N, 1), 0.29)], -1)
    q = rng.normal(0, 0.1, (N, 4)) + np.array([0, 0, 0, 1.0])
    s = teng.EnvState(f32(bp), f32(q / np.linalg.norm(q, axis=-1, keepdims=True)),
                      f32(TMC.default_dof_pos.numpy() + rng.uniform(-0.3, 0.3, (N, 12))),
                      f32(rng.normal(0, 0.3, (N, 18))))
    ctl = teng.Control(f32(np.tile(TMC.default_dof_pos.numpy(), (N, 1))),
                       f32(np.full((N, 12), 40.0)), f32(np.full((N, 12), 1.0)))
    prm = teng.EnvParams(f32(rng.uniform(0.6, 1.2, N)), f32(np.ones((N, 12))),
                         f32(np.ones((N, 12))), f32(np.zeros(N)), f32(np.zeros((N, 3))))
    grid = thf.from_numpy((0.08 * rng.normal(size=(48, 48))), 0.05, (-1.2, -1.2), device)
    return s, ctl, prm, grid


def model_consts(device="cpu"):
    return TMC if device == "cpu" else ModelConsts.from_model(build_go2_model(), device)


def contact_case(seed=0, device="cpu"):
    """soa.pre_contact's quantities (plus mu) for one substep of a random batch."""
    s, ctl, prm, grid = batch_case(seed, device)
    sd, (target, kp, kd, p, sampler, _), _ = tsoa.batch_inputs(CFG, grid, s, ctl, prm)
    pre = tsoa.pre_contact(model_consts(device), CFG, sd, target, kp, kd, p, sampler)
    pre["mu"] = p["friction"]
    return pre


def k1_args(pre, lam0=None):
    return tsoa.contact_problem(pre["phi"], pre["n"], pre["r"], pre["lever"], pre["f"],
                                pre["u_free"], pre["mu"], CFG.dt, lam0=lam0,
                                **tsoa.contact_kwargs(CFG))


def layered_case(seed=0, device="cpu", n=64, k=132):
    """A rough world with two movable layers, a lever field and a ceiling with
    its own layer tags (as tests/test_torch_terrain.py), window centres over
    it and off its edges, per-env weights, and k scan points per env."""
    rng = np.random.default_rng(seed)
    H, W = 96, 128
    layer_id = np.zeros((H, W), np.int8)
    layer_id[20:30, 40:60], layer_id[50:60, 70:90] = 1, 2
    lever = np.zeros((H, W), np.float32)
    lever[70:80, 30:50] = np.linspace(-0.5, 0.5, 20)[None, :]
    ceil = np.full((H, W), thf.NO_CEILING, np.float32)
    ceil[30:40, 20:40] = 0.45
    ceil_layer = np.zeros((H, W), np.int8)
    ceil_layer[30:40, 30:40] = 1
    grid = thf.from_numpy((0.2 * rng.normal(size=(H, W))).astype(np.float32), 0.05, (-1.0, -1.0),
                          device, layer_id=layer_id, lever=lever, ceiling=ceil,
                          ceiling_layer=ceil_layer)
    c = np.stack([rng.uniform(-1.5, 4.0, n), rng.uniform(-1.5, 6.0, n)], -1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    px = c[:, 0:1] + rng.uniform(-0.8, 0.8, (n, k))
    py = c[:, 1:2] + rng.uniform(-0.8, 0.8, (n, k))
    return grid, f32(c), f32(rng.uniform(-0.3, 0.3, (n, 3))), f32(px), f32(py)


def random_contact_problem(n, s, seed=0, warm=True):
    """K1's eight inputs for n envs of s contacts, from numpy: G = A A^T + I
    (a Delassus-like SPD matrix), unit normals, free velocities that mostly
    approach along them, about 70% of contacts active (the first always),
    dinv the inverses of G's 3x3 diagonal blocks, and lam0 > 0 when `warm`
    (zeros otherwise: a cold solve)."""
    rng = np.random.default_rng(seed)
    M = 3 * s
    A = rng.normal(0.0, 0.1, (n, M, M))
    G = A @ A.transpose(0, 2, 1) + np.eye(M)
    nv = rng.normal(size=(n, s, 3))
    nv /= np.linalg.norm(nv, axis=-1, keepdims=True)
    blocks = G.reshape(n, s, 3, s, 3)[:, np.arange(s), :, np.arange(s), :]   # (s, n, 3, 3)
    dinv = np.linalg.inv(blocks).transpose(1, 0, 2, 3).reshape(n, s, 9)
    lam0 = np.abs(rng.normal(0.0, 0.1, (n, M))) if warm else np.zeros((n, M))
    act = rng.uniform(size=(n, s)) > 0.3
    act[:, 0] = True
    nrm = nv.reshape(n, M)
    arrs = (G, rng.normal(size=(n, M)) - 2.0 * nrm, rng.normal(size=(n, M)), nrm, act,
            rng.uniform(0.3, 1.0, (n, s)), dinv, lam0)
    G, vf, bias, nrm, act, mu, dinv, lam0 = (np.ascontiguousarray(a, np.float32) for a in arrs)
    return G, vf, bias, nrm, act, dinv, mu, lam0


def window_case(n, W, seed=0, device="cpu", k=132):
    """layered_case's surfaces on a 96 x W grid (W = 128: the float32 rows
    are whole 16-byte multiples, TMA copies; W = 130: they are not, plain
    loads), n window centres over the grid with the first eight off each of
    its edges and corners (origins clamp there), per-env weights and k scan
    points per env around each centre."""
    rng = np.random.default_rng(seed)
    H = 96
    layer_id = np.zeros((H, W), np.int8)
    layer_id[:30, 40:60], layer_id[50:60, W - 40:] = 1, 2
    lever = np.zeros((H, W), np.float32)
    lever[70:, :20] = np.linspace(-0.5, 0.5, 20)[None, :]
    ceil = np.full((H, W), thf.NO_CEILING, np.float32)
    ceil[30:40, W - 30:] = 0.45
    ceil_layer = np.zeros((H, W), np.int8)
    ceil_layer[30:40, W - 20:] = 1
    grid = thf.from_numpy((0.2 * rng.normal(size=(H, W))).astype(np.float32), 0.05, (-1.0, -1.0),
                          device, layer_id=layer_id, lever=lever, ceiling=ceil,
                          ceiling_layer=ceil_layer)
    lo, hi = np.array([-1.0, -1.0]), np.array([-1.0 + 0.05 * (H - 1), -1.0 + 0.05 * (W - 1)])
    c = lo + (hi - lo) * rng.uniform(0, 1, (n, 2))
    off = np.array([[-1, 0.5], [2, 0.5], [0.5, -1], [0.5, 2], [-1, -1], [2, 2], [-1, 2], [2, -1]])
    m = min(n, len(off))
    c[:m] = lo + (hi - lo) * off[:m]
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    px = c[:, 0:1] + rng.uniform(-0.9, 0.9, (n, k))
    py = c[:, 1:2] + rng.uniform(-0.9, 0.9, (n, k))
    return grid, f32(c), f32(rng.uniform(-0.3, 0.3, (n, 3))), f32(px), f32(py)


def _to_pybullet(frames, rng):
    """Frames (T, 49) in the port's layout, taken back to the reference's
    file layout: 61 columns (the last 12 unread), PyBullet leg order [FR,
    FL, RR, RL] with the hips' signs flipped, each leg's toes and the root
    lifted off the ground, and the root quaternion tilted, scaled off unit
    length and negated on every third frame: `mocap._reorder_pb_to_fk`
    undoes all but the tilt."""
    from agility_tpu_torch.envs import mocap

    T = len(frames)
    swap = lambda b: np.hstack([b[:, 3:6], b[:, 0:3], b[:, 9:12], b[:, 6:9]])
    out = np.concatenate([frames, rng.normal(size=(T, 12))], -1)
    for sl in (mocap.JOINT_POS, mocap.JOINT_VEL):
        b = frames[:, sl].copy()
        b[:, [0, 3, 6, 9]] *= -1.0
        out[:, sl] = swap(b)
    lift = rng.uniform(0.01, 0.05, 4)
    toes = frames[:, mocap.TOE_POS].reshape(T, 4, 3).copy()
    toes[:, :, 2] += lift
    out[:, mocap.TOE_POS] = swap(toes.reshape(T, 12))
    out[:, 2] += lift.mean()
    t = np.arange(T)
    q = np.stack([0.05 * np.sin(0.3 * t), 0.03 * np.cos(0.2 * t), 0.2 * np.sin(0.1 * t),
                  np.ones(T)], -1)
    out[:, mocap.ROOT_ROT] = (q * rng.uniform(0.9, 1.1, (T, 1))
                              * np.where(t % 3 == 0, -1.0, 1.0)[:, None])
    return out


def write_clip_dir(root, seed=0, categories=None, ulb=True):
    """A small mocap dataset in the reference's layout under `root`:
    mocap_all_lb/<mode>_<v>.txt, two clips of every mode (v = 0: 72 frames
    of 1/30 s, v = 1: 90 frames of 1/60 s, unequal motion weights), and,
    with `ulb`, mocap_all_ulb/ulb_0.txt and ulb_1.txt (60 frames of 1/40 s,
    50 of 1/50 s).  Each file is JSON {FrameDuration, MotionWeight,
    Frames[(n, 61)]} of mocap.synthetic's clips in PyBullet order.
    Returns {"lb": [(file name, frames)], "ulb": [...]} in file order."""
    import json
    import os

    from agility_tpu_torch.envs import mocap
    from agility_tpu_torch.envs.config import MOCAP_CATEGORIES

    categories = categories or MOCAP_CATEGORIES
    rng = np.random.default_rng(seed)
    model = build_go2_model()
    written = {"lb": [], "ulb": []}

    def write(kind, name, frames, dur, weight):
        sub = os.path.join(root, f"mocap_all_{kind}")
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, name), "w") as f:
            json.dump({"LoopMode": "Wrap", "FrameDuration": dur, "MotionWeight": weight,
                       "Frames": _to_pybullet(frames, rng).tolist()}, f)
        written[kind].append((name, len(frames)))

    def clips(n, dur, s, cats):
        m = mocap.synthetic(model, cats, n_frames=n, frame_dur=dur, clips_per_cat=1,
                            seed=seed + s, device="cpu")
        f = m.frames.double().numpy()
        return [f[a:a + b] for a, b in zip(m.clip_start.tolist(), m.clip_frames.tolist())]

    for v, (n, dur) in enumerate(((72, 1 / 30.0), (90, 1 / 60.0))):
        for k, (cat, frames) in enumerate(zip(categories, clips(n, dur, v, categories))):
            write("lb", f"{cat}_{v}.txt", frames, dur, 1.0 + 0.5 * v + 0.25 * k)
    if ulb:
        for i, (n, dur) in enumerate(((60, 1 / 40.0), (50, 1 / 50.0))):
            write("ulb", f"ulb_{i}.txt", clips(n, dur, 2 + i, ("trot",))[0], dur, 1.0)
    return {k: sorted(v) for k, v in written.items()}
