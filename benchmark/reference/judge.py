"""The comparisons that decide `correct`: what the program produced in the
measured window against the plain reference.

Codec (`judge_codec`), per image or tile the program served, routed at
the unit's own `ratios` where it has them (a cell that serves several
operating points), at the cell's otherwise:
  stream_errors  streams the reference coder cannot read back to the
                 program's masks, or that it does not re-encode to the same
                 bytes, or a bpp that is not the streams' bits over the
                 pixels, or a mode that is not the ratios' (a count; exact:
                 limit 0);
  grain_diff     the share of latent positions whose grain (coarse, medium,
                 fine) differs from the reference router's;
  index_diff     the share of positions of equal grain whose VQ index
                 differs from the reference encoder's, the largest over the
                 images judged;
  rec_vs_fp8     how far the program's reconstruction lies from the
                 reference decoder's, decoding the program's own streams,
                 against how far the same reference computed in fp8 lies:
                 the share of values more than 16 levels (of 255) off, the
                 mean over the images judged, the program's over the fp8
                 reference's. The control (the reference in fp8 in the
                 program's place) reads 1.
The reconstruction is judged against the fp8 reference on the same images:
with random weights the seeds' decoders carry rounding into the far-off
pixels by amounts that differ several-fold from seed to seed, for bf16 and
fp8 alike, so no share read alone tells bf16 from fp8 on every seed
(PERF.md, PR 16).

Training (`judge_train`), over the first four steps. The program's first
step runs eagerly (it warms up and captures the step); the window replays
the capture, as steps 2-4 do. The reference takes step 1 from the seed's
weights, and each later step from the program's own state before it
(parameters, the discriminator's running statistics, Adam's moments and
step count), which the driver keeps on the host: followed from the seed
alone, sound implementations part by several % within three steps, since
Adam moves every element by about the learning rate whatever its gradient,
so elements whose gradient is at round-off move either way and the VQ
indices flip. Each number is taken per step and then
across the four steps by the second smallest: a VQ index that one step
sets apart at a near-tie moves that step's numbers by a discrete amount
(up to ~1e-4 of the loss), and rounding decides it, while a fault of the
replayed path moves steps 2-4 alike (PERF.md, PR 16). Per step:
  loss_gap   the larger relative gap of the generator's and discriminator's
             losses;
  grad_gap   the gradient as the optimizer got it, worked out from Adam's
             first moment ((m_t - b1 m_t-1) / (1 - b1)), by the worst leaf:
             | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
  step_gap   the same gap for each leaf's change over the step, by the
             worst leaf.
Leaves whose reference gradient is under a thousandth of the median leaf's
(a conv bias under GroupNorm, a key bias under softmax) move under Adam by
round-off alone and are left out.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import coder as C
from . import model as M

CODEC_NUMBERS = ("stream_errors", "grain_diff", "index_diff", "rec_vs_fp8")
# a training reading, one entry a step: the losses, |gradient| and |change|
# per leaf, the VQ index histogram
STEP_READINGS = ("losses", "grads", "steps", "counts")
FP8 = M.Prec("fp8")
TINY_LEAF = 1e-3
OFF_LEVELS = 16


def judge_codec(units: List[dict], params, cfg: dict, counts, ratios,
                device) -> Dict[str, float]:
    """units: one dict per image or tile the program served, with
    'image' ([H, W, 3] uint8), 'streams' ({name: bytes}), 'mode', 'bpp'
    (the program's figure for this unit, or None where it reported one for
    a whole image) and 'rec' ([H, W, 3] uint8, or float32 in [0, 1]
    units); 'image_bpp_error' marks a whole image's bpp that is not its
    tiles' bits over its pixels; 'ratios' (optional) the (coarse, medium)
    the unit was served at, in place of `ratios`."""
    coder = C.Coder(counts)
    out = dict.fromkeys(CODEC_NUMBERS, 0.0)
    off, off_fp8 = [], []
    for u in units:
        h, w, _ = u["image"].shape
        hl, wl = h // 4, w // 4
        try:
            ind_p, masks_p = C.decode_streams(coder, u["streams"], u["mode"],
                                              hl, wl)
        except C.StreamError:
            out["stream_errors"] += 1
            continue
        bits = 8 * sum(len(s) for s in u["streams"].values())
        r = tuple(u.get("ratios", ratios))
        if u.get("image_bpp_error") or u["mode"] != M.mode_of(*r):
            out["stream_errors"] += 1
        if (C.encode_streams(coder, ind_p, masks_p, u["mode"]) != u["streams"]
                or (u.get("bpp") is not None and u["bpp"] != bits / (h * w))):
            out["stream_errors"] += 1
        x = torch.from_numpy(u["image"]).to(device).permute(2, 0, 1)[None]
        with torch.no_grad():
            ind_r, masks_r, _ = M.encode(x.float() / 255.0, params, cfg, r)
            grains_p = M.grain_map([torch.from_numpy(m)[None].to(device)
                                    for m in masks_p])
            grains_r = M.grain_map(masks_r)
            same = grains_p == grains_r
            out["grain_diff"] = max(out["grain_diff"],
                                    1.0 - same.float().mean().item())
            ind_pt = torch.from_numpy(ind_p)[None].to(device)
            n_same = int(same.sum())
            if n_same:
                diff = ((ind_pt != ind_r) & same).sum().item() / n_same
                out["index_diff"] = max(out["index_diff"], diff)
            masks_pt = [torch.from_numpy(m)[None].to(device) for m in masks_p]
            got = torch.from_numpy(np.ascontiguousarray(u["rec"])).to(device)
            as_levels = ((lambda r: M.to_uint8(r)[0].float())
                         if got.dtype == torch.uint8
                         else (lambda r: 255.0 * r[0].permute(1, 2, 0)))
            want = as_levels(M.decode(ind_pt, masks_pt, params, cfg))
            fp8 = as_levels(M.decode(ind_pt, masks_pt, params, cfg, FP8))
            got = got.float() if got.dtype == torch.uint8 else 255.0 * got
            off.append(((got - want).abs() > OFF_LEVELS).float().mean().item())
            off_fp8.append(((fp8 - want).abs() > OFF_LEVELS).float().mean()
                           .item())
    out["rec_vs_fp8"] = (float(np.mean(off)) / max(float(np.mean(off_fp8)),
                                                   1e-9) if off else 1.0)
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              kept: List[str]) -> List[float]:
    """| |p| - |r| | / max(|r|, the median kept leaf's |r|), per kept leaf."""
    m = float(np.median([ref[k] for k in kept]))
    return [abs(prog[k] - ref[k]) / max(ref[k], m) for k in kept]


def kept_leaves(grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(grad.values())))
    return [k for k, v in grad.items() if v >= TINY_LEAF * med]


def step_numbers(prog: dict, ref: dict) -> Dict[str, List[float]]:
    """Each number of `judge_train` per step. prog and ref: per step,
    'losses' [(aeloss, discloss)], 'grads' [{leaf: |gradient|}], 'steps'
    [{leaf: |change over the step|}] and 'counts' [VQ index histogram];
    the leaves named as in the reference State ('gen.<name>',
    'disc.<name>'). 'index_moves' (looked at, not compared): the latent
    positions whose VQ index differs, half the L1 gap of the histograms."""
    return {
        "loss_gap": [max(abs(p - r) / max(abs(r), 1e-30)
                         for p, r in zip(ps, rs))
                     for ps, rs in zip(prog["losses"], ref["losses"])],
        "grad_gap": [max(leaf_gaps(p, r, kept_leaves(r)))
                     for p, r in zip(prog["grads"], ref["grads"])],
        "step_gap": [max(leaf_gaps(p, r, kept_leaves(g)))
                     for p, r, g in zip(prog["steps"], ref["steps"],
                                        ref["grads"])],
        "index_moves": [int((p.cpu() - r.cpu()).abs().sum()) // 2
                        for p, r in zip(prog["counts"], ref["counts"])]}


def judge_train(prog: dict, ref: dict) -> Dict[str, float]:
    """loss_gap, grad_gap, step_gap: the second smallest over the steps
    (see the module's docstring)."""
    per_step = step_numbers(prog, ref)
    return {k: sorted(per_step[k])[1]
            for k in ("loss_gap", "grad_gap", "step_gap")}


def follow(state, x: torch.Tensor, cfg: dict, ratios,
           half_batch: bool = False) -> dict:
    """One reference step on the batch x from `state`: its losses, its
    gradient as Adam got it ((m_t - b1 m_t-1) / (1 - b1)), each trained
    leaf's change and the VQ index histogram. half_batch=True leaves half
    of the batch out (a fault that the comparison has to catch)."""
    from . import train as T
    start = {k: v.detach().clone() for k, v in state.trained()}
    m0 = {k: m.clone() for k, m in state.m.items()}
    if half_batch:
        x = x[: max(1, x.shape[0] // 2)]
    r = T.train_step(state, x, cfg, ratios)
    grad = leaf_norms({k: (m - T.B1 * m0[k]) / (1 - T.B1)
                       for k, m in state.m.items()})
    step = leaf_norms({k: v.detach() - start[k] for k, v in state.trained()})
    return {"losses": (r["aeloss"], r["discloss"]), "grads": grad,
            "steps": step, "counts": r["counts"]}


def reference_readings(params: dict, states: List[dict], batches,
                       cfg: dict, ratios) -> dict:
    """The reference's readings: step 1 from the initial parameters
    ({'gen': ..., 'disc': ..., 'lpips': ...}), each later step from the
    stepped side's state before it (`states`, from `snapshot`, after steps
    1, 2, ...); batches: the steps' (NCHW, [-1, 1])."""
    from . import train as T
    out = {k: [] for k in STEP_READINGS}
    for i, x in enumerate(batches):
        state = (T.State(params["gen"], params["disc"], params["lpips"])
                 if i == 0 else T.State.resume(states[i - 1],
                                               params["lpips"]))
        r = follow(state, x, cfg, ratios)
        del state
        for k in STEP_READINGS:
            out[k].append(r[k])
    return out


def snapshot(gen: dict, disc: dict, m: dict, v: dict, t: int) -> dict:
    """A state after a step, on the host: parameters and the
    discriminator's running statistics ({name: tensor}), Adam's moments
    ({leaf: tensor}) and its step count."""
    host = lambda d: {k: x.detach().to("cpu", copy=True) for k, x in
                      d.items()}
    return {"gen": host(gen), "disc": host(disc), "m": host(m), "v": host(v),
            "t": int(t)}


def stepped_readings(state, batches, cfg: dict, ratios,
                     half_batch_replays: bool = False) -> dict:
    """The readings of the reference put in the program's place (a control
    or a fault), taken as the program's are, with its state kept before
    each step after the first; half_batch_replays=True steps on half of
    each batch after the first step."""
    out = {k: [] for k in (*STEP_READINGS, "states")}
    for i, x in enumerate(batches):
        if i:
            out["states"].append(snapshot(state.gen, state.dis, state.m,
                                          state.v, state.t))
        r = follow(state, x, cfg, ratios,
                   half_batch=half_batch_replays and i > 0)
        for k in STEP_READINGS:
            out[k].append(r[k])
    return out
