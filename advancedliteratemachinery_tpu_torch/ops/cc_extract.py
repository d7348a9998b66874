"""Device-side DB box extraction: prob map → quads (port of
`advancedliteratemachinery_tpu/ops/cc_extract.py`).

It matches the JAX device path step for step, not cv2:

1. binarize `prob > bin_thresh`;
2. connected components by iterated segmented cumulative max over row and
   column runs plus one 8-connectivity diagonal step per iteration. Labels
   start as each pixel's flat index and converge to the component's largest;
   a component that needs more than `cc_iters` traversals (a spiral) splits,
   two components never merge;
3. roots (label == own index), of which the top `max_boxes` are kept: on a
   page with more components the smallest flat indices are dropped;
4. per-(component, row) x-extents, from which a coarse-to-fine angle search
   finds the min-area rect exactly for each candidate angle;
5. score = mean prob over the filled rect; unclip by the DB paper's A·r/L
   offset; clip to the page;
6. slots ordered by (valid, score) descending with a stable sort.

Corners come in [tl, tr, br, bl] order, reading axis within ±45° of
horizontal. Where the JAX function used a TPU-shaped formulation (a
broadcast-equality argmax for the relabel, a [K, H, W] broadcast-reduce for
the row tables) this port computes the same values with `searchsorted` and
`scatter_reduce`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max
_BIG = 1e9


def _seg_run_max_scan(lab: torch.Tensor, mask: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """Segmented run max by a doubling (Hillis-Steele) scan in both
    directions — the general path for maps too large for the packed keys."""
    def scan(val, reset):
        n = val.shape[dim]
        off = 1
        while off < n:
            pv = torch.cat([torch.full_like(val.narrow(dim, 0, off),
                                            _I32_MIN),
                            val.narrow(dim, 0, n - off)], dim)
            pr = torch.cat([torch.zeros_like(reset.narrow(dim, 0, off)),
                            reset.narrow(dim, 0, n - off)], dim)
            # combine(a=earlier prefix, b=this prefix): keep b if b reset
            val = torch.where(reset, val, torch.maximum(pv, val))
            reset = reset | pr
            off *= 2
        return val

    reset = ~mask
    neg = torch.where(mask, lab, torch.full_like(lab, _I32_MIN))
    fwd = scan(neg, reset)
    bwd = scan(neg.flip(dim), reset.flip(dim)).flip(dim)
    out = torch.maximum(fwd, bwd)
    return torch.where(mask, out, torch.full_like(out, -1))


def connected_components(mask: torch.Tensor, cc_iters: int = 4
                         ) -> torch.Tensor:
    """mask [..., H, W] bool → labels [..., H, W] int32: each True pixel gets
    the max flat index of its 8-connected component, False pixels -1."""
    H, W = mask.shape[-2], mask.shape[-1]
    HW = H * W
    dev = mask.device
    flat = (torch.arange(H, dtype=torch.int32, device=dev)[:, None] * W
            + torch.arange(W, dtype=torch.int32, device=dev)[None, :])
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    lab0 = torch.where(mask, flat.expand(mask.shape), neg1)

    lab_bits = max(1, math.ceil(math.log2(HW + 1)))
    seg_bits = math.ceil(math.log2(max(H, W) + 1))

    if lab_bits + seg_bits <= 31:
        # packed key (run id << lab_bits | label + 1): run ids never
        # decrease along the scan, so a plain cummax stays inside its run
        reset = (~mask).to(torch.int32)
        seg_r = torch.cumsum(reset, dim=-1, dtype=torch.int32)
        seg_c = torch.cumsum(reset, dim=-2, dtype=torch.int32)
        low_mask = (1 << lab_bits) - 1

        def run_max(lab, seg, dim, length):
            key = (seg << lab_bits) | (lab + 1)
            fwd = torch.cummax(key, dim=dim).values
            keyb = ((length - seg) << lab_bits) | (lab + 1)
            bwd = torch.cummax(keyb.flip(dim), dim=dim).values.flip(dim)
            m = torch.maximum(fwd & low_mask, bwd & low_mask) - 1
            return torch.where(mask, m, neg1)

        def axis_passes(lab):
            lab = run_max(lab, seg_r, lab.ndim - 1, W)
            return run_max(lab, seg_c, lab.ndim - 2, H)
    else:
        def axis_passes(lab):
            lab = _seg_run_max_scan(lab, mask, lab.ndim - 1)
            return _seg_run_max_scan(lab, mask, lab.ndim - 2)

    lab = lab0
    for _ in range(cc_iters):
        lab = axis_passes(lab)
        # 8-connectivity step: max over the four diagonal neighbours, -1
        # off the map (views into one padded copy)
        pad = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=-1)
        d = lab
        for dy, dx in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            d = torch.maximum(
                d, pad[..., 1 - dy:1 - dy + H, 1 - dx:1 - dx + W])
        lab = torch.where(mask, d, neg1)
    return lab


def extract_boxes_device(prob: torch.Tensor, bin_thresh: float = 0.3,
                         box_thresh: float = 0.6, unclip_ratio: float = 1.5,
                         min_size: int = 3, max_boxes: int = 64,
                         cc_iters: int = 4, n_angles: int = 8,
                         angle_stages: int = 3
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prob [P, H, W] f32 → (quads [P, K, 4, 2], scores [P, K],
    valid [P, K] bool) with K = max_boxes; slots sorted by score descending,
    invalid slots zeroed."""
    P, H, W = prob.shape
    HW = H * W
    K = max_boxes
    dev = prob.device
    prob = prob.float()

    lab = connected_components(prob > bin_thresh, cc_iters=cc_iters)
    lab_flat = lab.reshape(P, HW)

    # --- component roots: label == own flat index; top-K of them ---
    flat = torch.arange(HW, dtype=torch.int32, device=dev)
    root_keys = torch.where(lab_flat == flat, lab_flat,
                            torch.full_like(lab_flat, -1))
    roots = torch.topk(root_keys, K, dim=-1).values              # [P, K] desc
    alive = roots >= 0

    # --- compact relabel: pixel label → its root's slot in [0, K), else K.
    # roots_s is sorted and its live entries unique, so searchsorted finds
    # the one slot the JAX function's first-match argmax finds
    roots_s = torch.sort(torch.where(alive, roots,
                                     torch.full_like(roots, _I32_MAX)),
                         dim=-1).values
    idx = torch.searchsorted(roots_s, lab_flat).clamp(max=K - 1)
    hit = (torch.gather(roots_s, 1, idx) == lab_flat) & (lab_flat >= 0)
    compact = torch.where(hit, idx, torch.full_like(idx, K))      # [P, HW]
    slot_alive = roots_s < _I32_MAX                               # [P, K]

    # --- per-(slot, row) x-extent tables; slot K collects the background ---
    ycoord = torch.arange(H, device=dev).repeat_interleave(W)
    xcoord = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)
    cell = compact * H + ycoord                                   # [P, HW]
    xmin = torch.full((P, (K + 1) * H), _BIG, device=dev).scatter_reduce(
        1, cell, xcoord.expand(P, HW), "amin")[:, :K * H].reshape(P, K, H)
    xmax = torch.full((P, (K + 1) * H), -_BIG, device=dev).scatter_reduce(
        1, cell, xcoord.expand(P, HW), "amax")[:, :K * H].reshape(P, K, H)
    row_live = xmax >= 0.0                                        # [P, K, H]
    yrow = torch.arange(H, dtype=torch.float32, device=dev)
    # [P, K, 1, H]: one angle-search stage evaluates all its candidates at
    # once (the same elementwise arithmetic per candidate, a few ops in
    # place of a few per candidate)
    xmin_a, xmax_a, live_a = xmin[:, :, None], xmax[:, :, None], \
        row_live[:, :, None]

    def extents(theta):
        """theta [P, K, A] → [P, K, A, 4] (umin, umax, vmin, vmax); exact
        because u and v are affine in x within a row."""
        c = torch.cos(theta)[..., None]
        s = torch.sin(theta)[..., None]
        ua, ub = c * xmin_a + s * yrow, c * xmax_a + s * yrow
        va, vb = -s * xmin_a + c * yrow, -s * xmax_a + c * yrow
        big = torch.tensor(_BIG, device=dev)
        umin = torch.where(live_a, torch.minimum(ua, ub), big).amin(-1)
        umax = torch.where(live_a, torch.maximum(ua, ub), -big).amax(-1)
        vmin = torch.where(live_a, torch.minimum(va, vb), big).amin(-1)
        vmax = torch.where(live_a, torch.maximum(va, vb), -big).amax(-1)
        return torch.stack([umin, umax, vmin, vmax], -1)

    # --- coarse-to-fine min-area rect (area is 90°-periodic in theta) ---
    half_pi = torch.tensor(math.pi / 2, dtype=torch.float32, device=dev)
    center = torch.zeros((P, K), dtype=torch.float32, device=dev)
    span = half_pi
    steps = torch.arange(n_angles, device=dev) / n_angles - 0.5
    best = None
    for _ in range(angle_stages):
        cands = center[..., None] + steps * span                  # [P, K, A]
        exts = extents(cands)                                     # [P,K,A,4]
        areas = ((exts[..., 1] - exts[..., 0])
                 * (exts[..., 3] - exts[..., 2]))                 # [P, K, A]
        pick = torch.argmin(areas, dim=-1)                        # first min
        center = torch.gather(cands, -1, pick[..., None])[..., 0]
        best = torch.gather(
            exts, -2, pick[..., None, None].expand(P, K, 1, 4))[..., 0, :]
        span = span / n_angles * 2.0       # keep both neighbours in reach

    theta = center
    umin, umax, vmin, vmax = best.unbind(-1)
    a_len = umax - umin
    b_len = vmax - vmin
    ct, st = torch.cos(theta), torch.sin(theta)
    ucen, vcen = (umin + umax) / 2, (vmin + vmax) / 2
    cx = ucen * ct - vcen * st
    cy = ucen * st + vcen * ct

    # normalize: reading axis = rect axis closest to horizontal
    swap = st.abs() > ct.abs()
    a2 = torch.where(swap, b_len, a_len)
    b2 = torch.where(swap, a_len, b_len)
    th2 = torch.where(swap, theta - half_pi, theta)
    th2 = torch.atan2(torch.sin(th2), torch.cos(th2))
    th2 = torch.where(th2 > half_pi, th2 - math.pi, th2)
    th2 = torch.where(th2 < -half_pi, th2 + math.pi, th2)
    ct2, st2 = torch.cos(th2), torch.sin(th2)

    # --- score: mean prob over the filled rect ---
    ys = ycoord.float()
    dx = xcoord[None, None, :] - cx[..., None]                    # [P, K, HW]
    dy = ys[None, None, :] - cy[..., None]
    u = dx * ct2[..., None] + dy * st2[..., None]
    v = -dx * st2[..., None] + dy * ct2[..., None]
    inside = ((u.abs() <= a2[..., None] / 2 + 0.5)
              & (v.abs() <= b2[..., None] / 2 + 0.5))
    ssum = torch.where(inside, prob.reshape(P, 1, HW), 0.0).sum(-1)
    scores = ssum / inside.sum(-1).clamp(min=1)

    # --- corners, unclip, clip, validity ---
    eu = torch.stack([ct2, st2], -1)       # reading axis
    ev = torch.stack([-st2, ct2], -1)      # downward axis
    cc = torch.stack([cx, cy], -1)
    ha, hb = a2[..., None] / 2, b2[..., None] / 2
    corners = torch.stack([cc - ha * eu - hb * ev,    # tl
                           cc + ha * eu - hb * ev,    # tr
                           cc + ha * eu + hb * ev,    # br
                           cc - ha * eu + hb * ev],   # bl
                          -2)                         # [P, K, 4, 2]
    area = a2 * b2
    length = 2 * (a2 + b2)
    dist = area * unclip_ratio / length.clamp(min=1e-6)
    vec = corners - cc[..., None, :]
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-6
    corners = corners + vec / norm * dist[..., None, None]
    corners = torch.stack([corners[..., 0].clamp(0, W - 1),
                           corners[..., 1].clamp(0, H - 1)], -1)

    valid = (slot_alive & (scores >= box_thresh)
             & (torch.minimum(a2, b2) >= min_size))

    # --- order slots by score descending; stable, as jnp.argsort ---
    rank = torch.where(valid, scores, torch.full_like(scores, -1.0))
    order = torch.argsort(-rank, dim=-1, stable=True)
    corners = torch.gather(corners, 1,
                           order[..., None, None].expand(P, K, 4, 2))
    scores = torch.gather(scores, 1, order)
    valid = torch.gather(valid, 1, order)
    corners = torch.where(valid[..., None, None], corners, 0.0)
    scores = torch.where(valid, scores, 0.0)
    return corners, scores, valid
