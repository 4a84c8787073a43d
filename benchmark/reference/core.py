"""Comparison helpers the references of both configurations share: plain
torch, nothing of the program."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch


def apply_overrides(cfg, overrides: Dict):
    """Dotted-key overrides onto the frozen config tree (None values skipped)."""
    def set_in(node, parts, val):
        if len(parts) == 1:
            if isinstance(getattr(node, parts[0]), tuple) and isinstance(val, list):
                val = tuple(val)
            return dataclasses.replace(node, **{parts[0]: val})
        return dataclasses.replace(
            node, **{parts[0]: set_in(getattr(node, parts[0]), parts[1:], val)})

    for key, val in overrides.items():
        if val is not None:
            cfg = set_in(cfg, key.split("."), val)
    return cfg


def to_ref(obj, cls, sim_cls):
    """A program NamedTuple as the frozen copy's class of the same fields."""
    vals = {}
    for name in cls._fields:
        v = getattr(obj, name)
        vals[name] = to_ref(v, sim_cls, None) if name == "sim" else v
    return cls(**vals)


def get(state, dotted: str):
    for part in dotted.split("."):
        state = getattr(state, part)
    return state


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r|| over the whole tensor (float64)."""
    p, r = p.double(), r.double()
    den = float(torch.linalg.vector_norm(r))
    return float(torch.linalg.vector_norm(p - r)) / max(den, 1e-30)


def tf32(on: bool):
    """Set TF32 for float32 matmuls and convolutions; returns the old setting."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    return old


TRIM = 1e-3   # the share of envs, rounded up, left out of a trimmed gap


def trimmed_rel_gap(p: torch.Tensor, r: torch.Tensor, share: float = TRIM) -> float:
    """`rel_gap` over the envs (the leading axis) with the ceil(share * N)
    envs of the largest error left out: a contact that rounding switches on
    in one env and off in the other moves that env's state by O(1), as it
    would between two sound runs of the program."""
    p, r = p.double().reshape(p.shape[0], -1), r.double().reshape(r.shape[0], -1)
    err = torch.sum(torch.square(p - r), dim=1)
    keep = torch.argsort(err)[: p.shape[0] - math.ceil(share * p.shape[0])]
    den = float(torch.sum(torch.square(r[keep])))
    return math.sqrt(float(torch.sum(err[keep])) / max(den, 1e-60))


OUTLIER = 1e-2   # an env whose own relative gap passes this is counted


def env_rel_gaps(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each env's ||p_i - r_i|| over the root mean square of the reference's
    per-env norms (float64): about 1e-6 for a sound env, O(1) for an env
    whose contact rounding switched, or whose answer is wrong."""
    p, r = p.double().reshape(p.shape[0], -1), r.double().reshape(r.shape[0], -1)
    err = torch.linalg.vector_norm(p - r, dim=1)
    rms = math.sqrt(float(torch.mean(torch.sum(torch.square(r), dim=1))))
    return err / max(rms, 1e-30)


def state_gap(state, rew, ref_state, ref_rew, fields: Sequence[str]) -> Dict:
    """The trimmed relative gap of each float field of a new state and of the
    reward against the reference's, their largest ("gap"); the envs whose
    own gap in some field passes OUTLIER ("outliers"), which the trim cannot
    see; the untrimmed largest ("widest"), the largest env's own gap
    ("env_max") and the envs whose reset flag differs, for the log."""
    pairs = {f: (get(state, f), get(ref_state, f)) for f in fields}
    pairs["rew"] = (rew, ref_rew)
    gaps = {f: trimmed_rel_gap(a, b) for f, (a, b) in pairs.items()}
    per_env = torch.stack([env_rel_gaps(a, b) for a, b in pairs.values()]).amax(dim=0)
    return dict(gap=max(gaps.values()), fields=gaps,
                outliers=int((per_env > OUTLIER).sum()), env_max=float(per_env.max()),
                widest=max(rel_gap(a, b) for a, b in pairs.values()),
                reset_flips=int((state.reset_buf != ref_state.reset_buf).sum()))


def env_numbers(gaps: Sequence[Dict]) -> Dict[str, float]:
    """The env-step numbers compared over the judged steps: the widest
    trimmed gap, and the outlying envs counted over every judged step (a
    fault in one env shows at each step, a contact switch at few)."""
    if not gaps:
        return dict(env_step_gap=math.inf, env_outliers=math.inf)
    return dict(env_step_gap=max(g["gap"] for g in gaps),
                env_outliers=sum(g["outliers"] for g in gaps))


def fault_gaps(state_in, s_ref, ref_rew, gap) -> Dict[str, Dict]:
    """The env-step faults read by `gap` (a family's state_gap) against the
    reference's new state `s_ref`: a step that returns its input state
    unchanged, and an answer altered where it is produced, in every env
    (each env's observation taken from the next env: an index off by one)
    and in one env (env 0's taken from env 1)."""
    obs = s_ref.obs_buf
    one = obs.clone()
    one[0] = obs[1]
    return dict(unchanged=gap(state_in, torch.zeros_like(ref_rew), s_ref, ref_rew),
                altered=gap(s_ref._replace(obs_buf=torch.roll(obs, 1, dims=0)), ref_rew,
                            s_ref, ref_rew),
                one_env=gap(s_ref._replace(obs_buf=one), ref_rew, s_ref, ref_rew))


def watch_first_steps(ts, store: Dict[str, torch.Tensor], modules: Sequence[str],
                      optimisers: Sequence[str]) -> None:
    """Wrap each optimiser's step once: right after its first step, store the
    gradient as the optimiser got it, Adam's first moment over (1 - beta1),
    of each parameter not yet stored, by name."""
    names = {id(p): f"{m}.{n}" for m in modules for n, p in getattr(ts, m).named_parameters()}
    for attr in optimisers:
        opt = getattr(ts, attr)

        def step(*a, _opt=opt, **k):
            del _opt.step                      # the class's step from now on
            r = _opt.step(*a, **k)
            b1 = _opt.param_groups[0]["betas"][0]
            for group in _opt.param_groups:
                for p in group["params"]:
                    st = _opt.state.get(p, {})
                    name = names[id(p)]
                    if name not in store and "exp_avg" in st:
                        store[name] = (st["exp_avg"] / (1 - b1)).detach().clone()
            return r
        opt.step = step


def snapshot_params(ts, modules: Sequence[str]) -> Dict[str, torch.Tensor]:
    return {f"{m}.{k}": v.detach().clone()
            for m in modules for k, v in getattr(ts, m).named_parameters()}


def loss_gap(prog: Dict[str, float], ref: Dict[str, float], keys: Sequence[str]) -> float:
    """The largest |program - reference| / |reference| of the compared losses."""
    return max(abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in keys)


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  keep: Optional[List[str]] = None) -> Dict:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    names = keep if keep is not None else list(ref)
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) if k in prog else 0.0
          for k in names}
    med = sorted(rn.values())[len(rn) // 2] if rn else 0.0
    per = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}
    worst = max(per, key=per.get) if per else None
    return dict(gap=per[worst] if worst else 0.0, leaf=worst, median_norm=med)


def moving_leaves(first_grad: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """Leaves whose first gradient's norm in the reference reaches `share`
    of the median leaf's: the others move under Adam by round-off alone."""
    n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in first_grad.items()}
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= share * med]
