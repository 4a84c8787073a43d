"""Gait-statistics comparator (behavior-parity harness).

BASELINE.md's north star is behavioral: the trained BBC should reproduce the
mocap gaits — per-mode duty factors, stride frequency, and footfall phase
relations — within tolerance.  The reference validates this only by eye
(interactive play.py + matplotlib Logger, bbc/legged_gym/utils/logger.py);
here it is a measurable harness:

  * `gait_stats(contact, dt)` reduces a rollout's (T, N, 4) foot-contact
    trace to duty factor, stride frequency and pairwise phase-sync scalars.
  * `stats_from_toe_heights` computes the same stats from a mocap clip's toe
    trajectories (frame layout: bbc/rsl_rl/datasets/motion_loader.py:19-50,
    toe positions channels 19:31), so the *expert data itself* defines the
    target bands.
  * `bands_from_clips` aggregates per-mode bands over all labeled clips.
  * `compare` checks measured stats against bands and returns a verdict.

Used by `cli/play_bbc.py --compare_gait` and `tests/test_gait.py`.

Feet order everywhere: FL, FR, RL, RR (engine/env convention).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

FOOT_NAMES = ("FL", "FR", "RL", "RR")
# contact threshold on mocap toe height: toes within 3.5 cm of the ground
# plane count as stance (clips are ground-shifted at load,
# envs/mocap.py:_build)
TOE_CONTACT_Z = 0.035


def _stride_hz(contact: np.ndarray, dt: float) -> np.ndarray:
    """Mean touchdown rate [1/s] per foot.  contact: (T, 4) bool."""
    c = contact.astype(np.int8)
    touchdowns = np.clip(np.diff(c, axis=0), 0, 1).sum(axis=0)   # rising edges
    span = max(contact.shape[0] - 1, 1) * dt
    return touchdowns / span


def _pair_sync(contact: np.ndarray, i: int, j: int) -> float:
    """Fraction of steps where feet i and j agree on stance/swing (1.0 =
    perfectly in phase, 0.0 = perfect anti-phase)."""
    return float(np.mean(contact[:, i] == contact[:, j]))


def gait_stats(contact: np.ndarray, dt: float) -> Dict[str, np.ndarray]:
    """Reduce a contact trace to gait statistics.

    contact: (T, 4) or (T, N, 4) boolean stance flags, dt: control period.
    Multi-env traces are treated as N independent trials and averaged.
    """
    contact = np.asarray(contact)
    if contact.ndim == 2:
        contact = contact[:, None, :]
    duty = contact.mean(axis=0)                                   # (N, 4)
    stride = np.stack([_stride_hz(contact[:, n], dt)
                       for n in range(contact.shape[1])])         # (N, 4)
    sync = np.stack([
        [_pair_sync(contact[:, n], 0, 3),    # FL-RR (diagonal pair A)
         _pair_sync(contact[:, n], 1, 2),    # FR-RL (diagonal pair B)
         _pair_sync(contact[:, n], 0, 2),    # FL-RL (left lateral pair)
         _pair_sync(contact[:, n], 0, 1)]    # FL-FR (front pair)
        for n in range(contact.shape[1])])
    return {
        "duty": duty.mean(axis=0),            # (4,) per-foot duty factor
        "stride_hz": stride.mean(axis=0),     # (4,) touchdowns per second
        "diag_sync": float(sync[:, :2].mean()),
        "lateral_sync": float(sync[:, 2].mean()),
        "front_sync": float(sync[:, 3].mean()),
    }


def contact_from_toe_heights(toe_z: np.ndarray,
                             thresh: float = TOE_CONTACT_Z) -> np.ndarray:
    """(T, 4) toe heights -> (T, 4) stance flags."""
    return np.asarray(toe_z) < thresh


def stats_from_toe_heights(toe_z: np.ndarray, dt: float,
                           thresh: float = TOE_CONTACT_Z) -> Dict[str, np.ndarray]:
    return gait_stats(contact_from_toe_heights(toe_z, thresh), dt)


def clip_toe_heights(frames: np.ndarray) -> np.ndarray:
    """Extract (T, 4) toe z from (T, 49) mocap frames (FK foot order;
    envs/mocap.py frame layout: toe pos at channels 19:31, xyz per toe)."""
    toes = np.asarray(frames[:, 19:31]).reshape(-1, 4, 3)
    return toes[:, :, 2]


def bands_from_clips(clips: Sequence[np.ndarray], labels: Sequence[int],
                     frame_dur, mode_idx: int,
                     rel_tol: float = 0.3, abs_tol: float = 0.1) -> Dict[str, tuple]:
    """Per-mode acceptance bands from the labeled mocap clips themselves.

    For every clip of `mode_idx`, compute gait stats from its toe heights;
    the band for each scalar is [min - tol, max + tol] over clips, with
    tol = max(rel_tol * |value|, abs_tol).  `frame_dur` is a scalar or a
    per-clip sequence.  Returns {} if no clip matches (caller should skip
    the comparison)."""
    durs = (np.full(len(clips), frame_dur) if np.ndim(frame_dur) == 0
            else np.asarray(frame_dur))
    stats = [stats_from_toe_heights(clip_toe_heights(c), float(d))
             for c, l, d in zip(clips, labels, durs) if l == mode_idx]
    if not stats:
        return {}

    def band(key, reduce=np.mean):
        vals = np.asarray([reduce(s[key]) for s in stats])
        tol = np.maximum(rel_tol * np.abs(vals), abs_tol)
        return float((vals - tol).min()), float((vals + tol).max())

    return {"duty": band("duty"), "stride_hz": band("stride_hz"),
            "diag_sync": band("diag_sync")}


def bands_from_motion(motion, mode_idx: int, **kw) -> Dict[str, tuple]:
    """Bands from a loaded `envs.mocap.MotionData` (labeled clips only)."""
    frames = np.asarray(motion.frames)
    clips = [frames[s:s + n]
             for s, n in zip(motion.clip_start, motion.clip_frames)]
    return bands_from_clips(clips, list(motion.label), motion.clip_dur,
                            mode_idx, **kw)


def compare(stats: Dict[str, np.ndarray], bands: Dict[str, tuple]) -> Dict[str, bool]:
    """Check measured stats against bands; returns per-metric pass flags and
    an `ok` conjunction."""
    out = {}
    for key, (lo, hi) in bands.items():
        val = float(np.mean(stats[key]))
        out[key] = bool(lo <= val <= hi)
    out["ok"] = all(out.values())
    return out


def format_report(stats, bands, verdict) -> str:
    lines = [f"{'metric':<12}{'measured':>10}{'band':>20}{'ok':>6}"]
    for key, (lo, hi) in bands.items():
        val = float(np.mean(stats[key]))
        lines.append(f"{key:<12}{val:>10.3f}{f'[{lo:.3f}, {hi:.3f}]':>20}"
                     f"{'yes' if verdict[key] else 'NO':>6}")
    lines.append(f"gait parity: {'PASS' if verdict['ok'] else 'FAIL'}")
    return "\n".join(lines)
