"""The front-end cells' comparison of what the timed path produced with the
plain float32 reference: the numbers that decide `correct`.

The reference is given the program's discrete choices where a near-tie
could fall either way: the anchor of every proposal and the program's keep
of it (its NMS over bf16 scores), and, for the sampled batches, the
program's masks at frame size, from which the reference filters, lifts and
pools. The keep itself is held to the reference's scores and boxes. Over
every frame of the window:

- keep_mismatch: the share of slots whose keep breaks the selection's
  rules (conf, NMS at iou, the max_masks_per_frame best) on the
  reference's float32 scores and boxes. The slots are the kept proposals
  and the reference's proposals inside the selection: scoring above conf,
  above the K2-th best where NMS cuts the candidates to K2, and above the
  lowest kept score where the frame keeps its maximum. A kept proposal
  breaks them where it scores under conf, or its box overlaps a kept box
  above iou; one of the others where it is not kept and no kept proposal
  scoring as high or higher overlaps it at iou or more. There is no knife
  edge here: near-ties flip under the program's rounding, so a sound
  program reads a small share, the same from seed to seed;
- mask_mismatch: over the kept proposals, the share of the pixels of
  either side's mask where the program's mask and the reference's at the
  same anchor differ, on the same pixels (a kept mask the program left
  empty differs wherever the reference's is set). Pixels on the knife edge
  are left out: a reference logit within KNIFE_LOGIT of the sum of its
  terms' magnitudes (|coefficient| times |prototype|, the scale of its
  rounding) from 0, or within KNIFE_BOX_PX of its box's edge lines;
- fdesc_gap: the largest 1 - cosine between the program's frame
  descriptor and the reference's (GeM over float32 DINOv2 patches).

Over the sampled batches (their masks at frame size):

- point_gap: the largest distance, in metres, from a lifted point of a
  valid mask to the nearest point of the other side's cloud (both
  directions), the reference lifting the program's mask from the frame's
  depth through the filters (area bounds, erosion-gated lifting with
  max_depth, the capped selection, the voxel means, the plane filter). A
  proposal that one side keeps and the other drops reads ONE_SIDED_M;
  proposals whose OBB extents lie within KNIFE_EXTENT_M of a plane
  threshold are left out;
- emb_gap: the largest 1 - cosine between a valid mask's embedding and
  the reference's float32 patches pooled with the program's mask;
- map_mismatch: the device mapper's pool after the batch's frames against
  the reference's frames (mapper_step) from the program's pool before
  them and the batch's observations: the share of live slots that differ
  (mapper_step.compare), the reference taking outlier removal's near-ties
  either way (mapper_step.closest).

The control is the same pipeline in the reference at CONTROL precision
(frontend_f32; mapper_step in bfloat16), given the same anchors and keep
and, for the map, the same pool before the batch and observations, held
against the float32 reference as the program is; its keep_mismatch is
that of its own selection (select) from its own scores and boxes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import frontend_f32 as ref
from benchmark.reference import mapper_step

KNIFE_LOGIT = 0.02       # share of the sum of the logit's terms' magnitudes
KNIFE_BOX_PX = 1.0       # pixels of the net's input size
KNIFE_EXTENT_M = 1e-3
ONE_SIDED_M = 1e3
# numbers kept for the record, not compared
RECORD = ("kept_masks", "keep_slots", "valid_per_sampled_frame", "sampled_batches",
          "sampled_after_a_spill", "map_near_ties", "map_runs")


def _cos_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    return 1.0 - (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=1e-30)


class Reference:
    """The reference's outputs for frames of one drive, with the weights
    drawn again from the scene's seed."""

    def __init__(self, cell):
        self.cell = cell
        self.seg_w, self.vit_w = ref.draw_weights(cell.scene_seed, cell.seg_arch, cell.vit_arch,
                                                  cell.device, cell.calib())

    def frames(self, idx):
        d = self.cell.drive
        img = torch.as_tensor(d.images[idx], device=self.cell.device)
        img = img.permute(0, 3, 1, 2).float() / 255.0
        dep = torch.as_tensor(d.depths[idx], device=self.cell.device)
        return img, dep.to(torch.float16).float()

    def nets(self, img, anchors, p: ref.Precision = ref.F32):
        """(mask logits (B, K, s, s), boxes (B, K, 4), the logits' scale,
        patches, and seg_forward's outputs: every anchor's score and box)."""
        fs = self.cell.fparams
        hw = tuple(max(32, (int(x) // 32) * 32) for x in fs.imgsz)
        seg = ref.seg_forward(self.seg_w, self.cell.seg_arch, ref.resize_bilinear(img, hw), p)
        lg, box, scale = ref.mask_logits(seg, anchors, hw, p)
        patches = ref.vit_forward(self.vit_w, self.cell.vit_arch,
                                  ref.vit_input(img, self.cell.vit_arch.patch), p)
        return lg, box, scale, patches, seg

    def filters(self, masks, depth, p: ref.Precision = ref.F32):
        """The mask filters and lifting on frame-size masks (B, K, H, W):
        (valid (B, K), knife (B, K), clouds [[(n, 3)]])."""
        fs, K = self.cell.fparams, self.cell.camera.K
        B, Kn, H, W = masks.shape
        area = masks.flatten(2).sum(-1)
        ok = (area >= H * W / fs.min_mask_len_div ** 2) & (area <= H * W / fs.max_mask_len_div ** 2)
        s = max(fs.pcd_stride, 1)
        lift = (ref.erode_strided(masks, 2 * fs.erosion_size + 1, s) if fs.erosion_size > 0
                else masks[..., ::s, ::s])
        pts = ref.lift_points(depth, K, s, p).reshape(B, -1, 3)
        d = depth[:, None, ::s, ::s]
        sel = (lift & (d > 1e-3)).flatten(2)
        near = (d <= fs.max_depth).flatten(2)
        n_all = sel.sum(-1)
        frac_ok = (sel & near).sum(-1) >= 0.25 * n_all.clamp(min=1)
        flat = sel & near
        rank = ref.pixel_rank(flat.shape[-1], masks.device)
        a, b, c = fs.plane_filter_params
        valid = torch.zeros(B, Kn, dtype=torch.bool, device=masks.device)
        knife = torch.zeros_like(valid)
        clouds = [[None] * Kn for _ in range(B)]
        for i, k in zip(*np.nonzero(area.cpu().numpy())):
            if not (frac_ok[i, k] and n_all[i, k] > 0):
                continue
            pix = torch.nonzero(flat[i, k])[:, 0]
            if len(pix) > fs.max_points_per_mask:
                pix = pix[torch.argsort(rank[pix], descending=True)[:fs.max_points_per_mask]]
            chosen = torch.zeros(flat.shape[-1], dtype=torch.bool, device=masks.device)
            chosen[pix] = True
            cloud, _ = ref.voxel_means(pts[i], chosen, fs.voxel_size, p)
            clouds[i][k] = cloud
            e = torch.sort(ref.obb_extent(cloud)).values
            plane = bool((e[2] > a) & (e[1] > b) & (e[0] < c))
            knife[i, k] = bool(((e - torch.tensor([c, b, a], dtype=e.dtype, device=e.device)).abs()
                                < KNIFE_EXTENT_M).any()) and len(cloud) >= 5
            valid[i, k] = bool(ok[i, k]) and not plane and len(cloud) > 0
        return valid, knife, clouds


def _ds_grid(hw, H, W, f, device):
    """Rows and columns of the net-size mask that the frame-size mask,
    kept at every f-th pixel, reads."""
    return (ref.nearest_index(hw[0], H, device)[::f], ref.nearest_index(hw[1], W, device)[::f])


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes a (n, 4) and b (m, 4), xyxy -> (n, m)."""
    def area(x):
        return (x[:, 2] - x[:, 0]).clamp(min=0) * (x[:, 3] - x[:, 1]).clamp(min=0)

    wh = (torch.minimum(a[:, None, 2:], b[None, :, 2:])
          - torch.maximum(a[:, None, :2], b[None, :, :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp(min=1e-9)


def select(score: torch.Tensor, box: torch.Tensor, conf: float, iou: float, max_out: int):
    """The selection of the control: (anchors (B, max_out), keep (B,
    max_out)) from scores (B, A) and boxes (B, A, 4): the K2 = 4 max_out
    best proposals scoring conf or more (a stable sort), greedy NMS at
    IoU above iou, the first max_out kept."""
    score, box = score.cpu(), box.cpu()
    B, A = score.shape
    K2 = min(4 * max_out, A)
    anchors = torch.zeros(B, max_out, dtype=torch.long)
    keep = torch.zeros(B, max_out, dtype=torch.bool)
    for f in range(B):
        s = torch.where(score[f] >= conf, score[f], torch.zeros_like(score[f]))
        order = torch.sort(s, descending=True, stable=True).indices[:K2]
        order = order[s[order] > 0]
        over = (_iou(box[f, order], box[f, order]) > iou).numpy()
        alive = []
        for i in range(len(order)):
            if not any(over[j, i] for j in alive):
                alive.append(i)
        chosen = order[alive[:max_out]]
        anchors[f, :len(chosen)], keep[f, :len(chosen)] = chosen, True
    return anchors, keep


def _keep_numbers(seg: dict, anchors, keep, fs):
    """(slots, slots that break the selection's rules) of one batch: the
    reference's scores and boxes (seg_forward) against the tested side's
    anchors (B, K) and keep (B, K)."""
    score, box = seg["score"].cpu().float(), seg["box"].cpu()
    anchors, keep = anchors.cpu(), keep.cpu()
    B, A = score.shape
    K2 = min(4 * fs.max_masks_per_frame, A)
    slots = broken = 0
    for f in range(B):
        s, b = score[f], box[f]
        kept = anchors[f][keep[f]].long()
        sk, bk = s[kept], b[kept]
        t = fs.conf
        if int((s >= fs.conf).sum()) > K2:
            t = max(t, float(torch.sort(s, descending=True).values[K2 - 1]))
        if len(kept) >= fs.max_masks_per_frame:
            t = max(t, float(sk.min()))
        is_kept = torch.zeros(A, dtype=torch.bool)
        is_kept[kept] = True
        dropped = torch.nonzero(~is_kept & (s > t))[:, 0]
        overlap = _iou(bk, bk).triu(1) > fs.iou
        by = ((_iou(b[dropped], bk) >= fs.iou) & (sk[None, :] >= s[dropped][:, None])).any(1)
        slots += len(kept) + len(dropped)
        broken += int((sk < fs.conf).sum()) + int(overlap.sum()) + int((~by).sum())
    return slots, broken


def _mask_numbers(r: Reference, lg_ref, box_ref, scale, keep, prog_ds, lg_test, box_test,
                  H, W):
    """(kept masks, pixels compared, pixels that differ) of one batch:
    keep (B, K) the program's; prog_ds (B, K, H/f, W/f) the tested side's
    masks; the tested side's logits and boxes (None for the program, whose
    masks are given) are sampled likewise. The pixels compared are those of
    the kept proposals' masks on either side, off the knife edge."""
    fs = r.cell.fparams
    rows, cols = _ds_grid(lg_ref.shape[-2:], H, W, fs.mask_downsample_factor, lg_ref.device)
    m_ref = ref.masks_from_logits(lg_ref, box_ref)[..., rows, :][..., cols]
    if prog_ds is None:
        prog_ds = ref.masks_from_logits(lg_test, box_test)[..., rows, :][..., cols]
    knife = ((lg_ref.abs() < KNIFE_LOGIT * scale)
             | (ref.box_edge_distance(box_ref, *lg_ref.shape[-2:]) < KNIFE_BOX_PX))
    knife = knife[..., rows, :][..., cols]
    kept = keep[..., None, None]
    union = (prog_ds | m_ref) & ~knife & kept
    differ = (prog_ds ^ m_ref) & ~knife & kept
    return int(kept.sum()), int(union.sum()), int(differ.sum())


def _cloud_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if len(a) == 0 or len(b) == 0:
        return ONE_SIDED_M if len(a) != len(b) else 0.0
    d = torch.cdist(a.double(), b.double())
    return float(max(d.min(1).values.max(), d.min(0).values.max()))


def numbers(cell, records: list, control: bool = False) -> dict:
    """The comparison's numbers over `records`, each {"frames", "out"
    (PerceptionOutput), "anchors", "keep" (the program's), "masks"
    (frame-size masks of a sampled batch, else None)}; with control, of
    the control in the program's place."""
    fs = cell.fparams
    with torch.no_grad(), ref.no_tf32():
        r = Reference(cell)
        low = ref.CONTROL
        H, W = cell.camera.height, cell.camera.width
        kept = union = differ = 0
        slots = broken = 0
        fdesc_gap = emb_gap = point_gap = 0.0
        valid = sampled = after_spill = 0
        maps = []
        for rec in records:
            img, dep = r.frames(rec["frames"])
            anchors = rec["anchors"].to(cell.device)
            keep = rec["keep"].to(cell.device)
            lg, box, scale, patches, seg = r.nets(img, anchors)
            fd_ref = ref.gem_descriptor(patches)
            if control:
                lg_t, box_t, _, patches_t, seg_t = r.nets(img, anchors, low)
                n, u, d = _mask_numbers(r, lg, box, scale, keep, None, lg_t, box_t, H, W)
                fd_t = ref.gem_descriptor(patches_t, low)
                sel = select(seg_t["score"], seg_t["box"], fs.conf, fs.iou,
                             fs.max_masks_per_frame)
            else:
                out = rec["out"]
                n, u, d = _mask_numbers(r, lg, box, scale, keep,
                                        torch.as_tensor(out.masks, device=cell.device),
                                        None, None, H, W)
                fd_t = torch.as_tensor(out.frame_descriptors, device=cell.device)
                sel = anchors, keep
            kept, union, differ = kept + n, union + u, differ + d
            n_s, n_b = _keep_numbers(seg, *sel, fs)
            slots, broken = slots + n_s, broken + n_b
            fdesc_gap = max(fdesc_gap, float(_cos_gap(fd_t, fd_ref).max()))
            if rec["masks"] is None:
                continue
            if control:
                full = ref.resize_nearest(ref.masks_from_logits(lg_t, box_t).float(), (H, W)) > 0.5
                emb_t = ref.pool_masks(patches_t, full, cell.vit_arch.patch, low)
                valid_t, _, clouds_t = r.filters(full, dep, low)
            else:
                full = rec["masks"].to(cell.device)
                emb_t = torch.as_tensor(out.embeddings, device=cell.device)
                valid_t = torch.as_tensor(out.valid, device=cell.device)
                pv = torch.as_tensor(out.points_valid, device=cell.device)
                pts = torch.as_tensor(out.points, device=cell.device)
                clouds_t = [[pts[i, k][pv[i, k]] for k in range(pts.shape[1])]
                            for i in range(pts.shape[0])]
            emb_ref = ref.pool_masks(patches, full, cell.vit_arch.patch)
            valid_r, knife, clouds_r = r.filters(full, dep)
            both = valid_t & valid_r
            if both.any():
                emb_gap = max(emb_gap, float(_cos_gap(emb_t, emb_ref)[both].max()))
            either = (valid_t | valid_r) & ~knife
            for i, k in zip(*np.nonzero(either.cpu().numpy())):
                gap = (_cloud_gap(clouds_t[i][k], clouds_r[i][k]) if both[i, k]
                       else ONE_SIDED_M)
                point_gap = max(point_gap, gap)
            valid += int(valid_t.sum())
            sampled += len(valid_t)
            if "map" in rec:
                maps.append(_map_numbers(cell, rec["map"], control))
                after_spill += rec["map"]["spills"] > 0
        out = dict(keep_mismatch=broken / max(slots, 1), mask_mismatch=differ / max(union, 1),
                   emb_gap=emb_gap, fdesc_gap=fdesc_gap, point_gap=point_gap,
                   map_mismatch=max((m["map_mismatch"] for m in maps), default=0.0))
        # for the record, not compared: how much the numbers cover
        out.update(kept_masks=kept, keep_slots=slots,
                   valid_per_sampled_frame=valid / max(sampled, 1),
                   sampled_batches=len(maps), sampled_after_a_spill=after_spill,
                   map_near_ties=sum(m["map_near_ties"] for m in maps),
                   map_runs=sum(m["map_runs"] for m in maps))
        return out


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _map_numbers(cell, m: dict, control: bool) -> dict:
    """The device mapper's state after a sampled batch against the
    reference's frames from its state before it (mapper_step.closest);
    with control, the reference in bfloat16 in the mapper's place."""
    before = {k: _host(v) for k, v in m["before"].items()}
    inputs = tuple(_host(x) for x in m["inputs"])
    if control:
        low = mapper_step.run_batch(before, inputs, cell.mparams, mapper_step.bf16)
        after = mapper_step.as_state(low)
    else:
        after = {k: _host(v) for k, v in m["after"].items()}
    return mapper_step.closest(before, inputs, cell.mparams, after)
