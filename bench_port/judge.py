"""The numbers that decide `correct`, each held to its limit. A cell's
limits file (`limits/<workload>.json`) names the numbers it compares; the
others are read for the look (`calibrate.py`).

Planning (per sampled call, the widest over the sample):
- `tsdf`, `qual`, `width`: the largest gap of the 40^3 TSDF volume, and of
  the grasp head's quality and width volumes, from the reference's, over
  the reference's largest magnitude (`.rms`: root mean square gaps);
- `rot`: the head's rotations, sign-free, each gap weighted by the
  reference's raw rotation norm over its largest (a near-zero raw
  rotation's direction is rounding on both sides);
- `cands`: the returned grasps against the reference's post-processing of
  the program's own volumes (process, NMS, top-k): each grasp's score,
  how far its voxel falls short of the threshold or of the best quality in
  its NMS window, its rotation and width; and the margin by which each
  candidate that was not returned is kept. The volumes' own gaps test the
  layers before the post-processing. `cands.returned`, not compared: the
  most grasps a sampled call returned; 0 where the seed's weights put the
  whole TSDF inside the surface, so that the processed quality is 0 in
  every voxel and no threshold keeps a grasp (PERF.md, section 7).
- `<gap>.vs_dtype`, where the configuration computes in another dtype
  than float32: each of the volumes' widest gaps over the sample, over the
  same widest gap of the reference with its products rounded to that dtype
  on the same scenes (`<gap>.dtype`). How far a bfloat16 computation lies
  from float32 is set by the seed's weights, several times more on some
  seeds than on others, and the program follows it, so no gap alone
  separates the program from the fp8 control by 3x over many seeds; in
  units of the dtype's own gap the program reads about 1 and the control
  about 10 on every seed (PERF.md, section 2).

Training (the first three steps, which set-up drives through the window's
own step and feed):
- `loss`: the largest relative gap of a loss term over the three steps;
- `grad`: the first gradient as Adam holds it after step 1 (its first
  moment over 1 - beta1), by the worst leaf: the gap of the leaf's norm
  from the reference's, over the larger of the reference leaf's norm and
  the median leaf's;
- `change`: the parameters' change over the three steps, the median leaf's
  gap in the same measure, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (the others, such as a bias
  before a softmax over views, move under Adam by round-off alone). The
  worst leaf's (`change.worst`) swings from seed to seed: Adam moves every
  element by about the learning rate whatever its gradient, so elements
  whose gradient is rounding flip on either side.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import reference
from .reference import ops

Cand = Tuple[Tuple[int, int, int], float, List[float], float]


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max())
    return float((a.float() - b).abs().max()) / max(scale, 1e-12)


def _rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The root mean square of the gap over that of b."""
    return float((a.float() - b).pow(2).mean().sqrt()
                 / b.pow(2).mean().sqrt().clamp_min(1e-30))


def cand_gaps(cands: List[Cand], q, rot, width, threshold: float,
              k: int, ref_cands: List[Cand]) -> Dict[str, float]:
    """`cands` judged against a processed quality q [res]^3, rotations
    [res]^3 x 4, widths [res]^3 and the candidates the reference's post-
    processing draws from them, by part: score, selection (threshold and
    NMS window), rotation (sign-free), width (over the largest), and the
    reference's candidates that were not returned."""
    q, rot, width = (t.detach().cpu().numpy() for t in (q, rot, width))
    n = q.shape[0]
    wscale = max(float(np.abs(width).max()), 1e-12)
    gaps = dict.fromkeys(("score", "select", "rot", "width", "missed"), 0.0)
    seen = set()

    def widen(key, value):
        gaps[key] = max(gaps[key], float(value))
    for v, s, quat, w in cands:
        v = tuple(int(i) for i in v)
        if not all(0 <= i < n for i in v):
            return dict.fromkeys(gaps, math.inf)
        seen.add(v)
        win = q[tuple(ops.window(i, n) for i in v)]
        quat = np.asarray(quat, np.float64)
        widen("score", abs(s - q[v]))
        widen("select", max(0.0, threshold - q[v])
              + max(0.0, win.max() - q[v]))
        widen("rot", min(np.abs(quat - rot[v]).max(),
                         np.abs(quat + rot[v]).max()))
        widen("width", abs(w - width[v]) / wscale)
    floor = min(s for _, s, _, _ in cands) if len(cands) >= k else None
    for v, s, _, _ in ref_cands:
        if v in seen:
            continue
        win = q[tuple(ops.window(i, n) for i in v)].copy()
        win[tuple(i - ops.window(i, n).start for i in v)] = -np.inf
        margin = min(s - threshold, s - win.max())
        if floor is not None:
            margin = min(margin, s - floor)
        widen("missed", max(margin, 0.0))
    return gaps


def volume_gaps(vol, heads, ref_vol, ref_heads) -> Dict[str, float]:
    """The TSDF's and the head's gaps, the widest and the root mean square.
    heads: (qual, rot, width) each [res]^3 x C; ref_heads: the reference's
    with the rotation's norm before normalisation. A rotation's gap is
    weighted by that norm over its largest: where the raw rotation is near
    zero its direction is rounding, in the reference as in the program."""
    qual, rot, width = heads
    r_qual, r_rot, r_width, r_norm = ref_heads
    weight = r_norm[..., 0] / r_norm.max().clamp_min(1e-30)
    sign_free = torch.minimum((rot - r_rot).abs().amax(-1),
                              (rot + r_rot).abs().amax(-1))
    return {"tsdf": _rel_gap(vol, ref_vol), "qual": _rel_gap(qual, r_qual),
            "rot": float((sign_free * weight).max()),
            "width": _rel_gap(width, r_width),
            "tsdf.rms": _rms_gap(vol, ref_vol),
            "qual.rms": _rms_gap(qual, r_qual),
            "rot.rms": float((sign_free * weight).pow(2).mean().sqrt()),
            "width.rms": _rms_gap(width, r_width)}


def plan_numbers(sample, ref_vol, ref_heads, threshold: float,
                 k: int, own=None) -> Dict[str, float]:
    """One sampled call's numbers, and the candidates' parts under dotted
    names. sample: (tsdf, (qual, rot, width) each [res]^3 x C,
    candidates); ref_vol, ref_heads: the reference's on the same scene
    (`volume_gaps`); own: (tsdf, heads) of the reference with its products
    in the configuration's dtype, where that is not float32, whose gaps
    come as `<gap>.dtype`. The candidates are judged against the
    reference's post-processing of the program's own volumes, so that they
    test the post-processing and the hand-over to the host, and the
    volumes' own gaps test the layers before it."""
    vol, (qual, rot, width), cands = sample
    out = volume_gaps(vol, (qual, rot, width), ref_vol, ref_heads)
    if own is not None:
        out.update({key + ".dtype": v for key, v in volume_gaps(
            own[0], own[1][:3], ref_vol, ref_heads).items()})
    q = reference.process_quality(vol, qual[..., 0], width[..., 0])
    mine = reference.candidates(q, rot, width[..., 0], threshold, k)
    parts = cand_gaps(cands, q, rot, width[..., 0], threshold, k, mine)
    out.update({"cands." + key: v for key, v in parts.items()})
    out["cands"] = max(parts.values())
    out["cands.returned"] = float(len(cands))
    return out


def vs_dtype(numbers: Dict[str, float]) -> Dict[str, float]:
    """`numbers` with each gap that has a `<gap>.dtype` beside it also over
    that (`<gap>.vs_dtype`); inf where that unit is not finite or not above
    0, so that a broken yardstick fails the run."""
    out = dict(numbers)
    for key, unit in numbers.items():
        if key.endswith(".dtype"):
            gap = key[:-len(".dtype")]
            out[gap + ".vs_dtype"] = (numbers[gap] / unit
                                      if math.isfinite(unit) and unit > 0
                                      else math.inf)
    return out


def _norm(t) -> float:
    return float(t.detach().double().norm()) if t is not None else 0.0


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float]):
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(want.values())
    return {n: abs(got[n] - w) / max(w, med, 1e-30) for n, w in want.items()}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {"losses": [{term: value}] a step, "grad": {leaf:
    tensor} (empty where the program's optimizer holds no state), "start":
    {leaf: tensor}, "end": {leaf: tensor}}. Besides the three numbers, the
    worst term and leaves and the median leaf's gaps, for the look."""
    loss, term, first, total = 0.0, None, 0.0, 0.0
    for step, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"])):
        for t, want in lr.items():
            gap = abs(lp.get(t, math.nan) - want) / max(abs(want), 1e-12)
            if not gap <= loss:
                loss, term = gap, t
            if step == 0 and not gap <= first:
                first = gap
            if t == "total" and not gap <= total:
                total = gap
    if len(prog["losses"]) < len(ref["losses"]) or math.isnan(loss):
        loss = first = total = math.inf
    g_ref = {n: _norm(t) for n, t in ref["grad"].items()}
    grads = _leaf_gaps({n: _norm(prog["grad"].get(n)) for n in g_ref}, g_ref)
    med = statistics.median(g_ref.values())
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * med]
    d_ref = {n: _norm(ref["end"][n] - ref["start"][n]) for n in moved}
    changes = _leaf_gaps({n: _norm(prog["end"][n] - prog["start"][n])
                          for n in moved}, d_ref)
    g_worst = max(grads, key=grads.get)
    c_worst = max(changes, key=changes.get)
    return {"loss": loss, "grad": grads[g_worst],
            "change": statistics.median(changes.values()),
            "loss.first": first, "loss.total": total, "loss.term": term,
            "grad.leaf": g_worst, "grad.median": statistics.median(
                grads.values()),
            "change.worst": changes[c_worst], "change.leaf": c_worst,
            "skipped": float(prog.get("skipped", 0))}


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    """The widest of each number over several samples."""
    out = {}
    for row in numbers:
        for k, v in row.items():
            if isinstance(v, str):
                out[k] = v
            else:
                out[k] = max(out.get(k, -math.inf), v if v == v else math.inf)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]): every number at or under its
    limit; a limit without a number fails."""
    rows = [(k, numbers.get(k, math.inf), lim) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
