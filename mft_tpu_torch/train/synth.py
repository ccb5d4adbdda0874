"""Synthetic flow scenes with exact ground truth (numpy, host side).

A copy of ``mft_tpu/train/synth.py``: the same draws from the same
``np.random.Generator`` in the same order, so a seed gives the same arrays.
A textured background under an affine motion plus independently moving
textured sprites, composited in painter's order; flow, validity and
occlusion are analytic consequences of the scene geometry:

- every surface has a similarity pose per frame; frame t samples each
  surface's texture at its inverse pose;
- the flow of a frame-0 pixel owned by surface s is pose_t(x) - x (frame 0
  is the identity pose), exact and subpixel;
- a pixel is occluded at t iff its target leaves the frame or another
  surface is visible at the target's nearest pixel in frame t.

Multi-frame scenes give template -> t pairs for every t (the Kubric LongFlow
training distribution). ``chip_smoke.py`` writes such scenes as a Sintel-form
tree for the trainer.
"""

import numpy as np


# --------------------------------------------------------------------- #
# textures
# --------------------------------------------------------------------- #
def multiscale_texture(rng, H, W, octaves=4, base=16):
    """RGB uint8 multi-octave value-noise texture (smooth but feature-rich).

    Correlation needs local structure at several scales — pure white noise
    aliases under bilinear warps and defeats the coarse pyramid levels.
    """
    img = np.zeros((H, W, 3), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh = max(2, base * (2 ** o))
        if gh >= max(H, W):
            break
        grid = rng.random((gh + 2, gh + 2, 3), dtype=np.float32)
        ys = np.linspace(0, gh - 1e-3, H, dtype=np.float32)
        xs = np.linspace(0, gh - 1e-3, W, dtype=np.float32)
        y0 = ys.astype(np.int32)
        x0 = xs.astype(np.int32)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        g0, g1 = grid[y0], grid[y0 + 1]
        top = g0[:, x0]
        top += (g0[:, x0 + 1] - top) * fx
        bot = g1[:, x0]
        bot += (g1[:, x0 + 1] - bot) * fx
        top += (bot - top) * fy
        img += amp * top
        total += amp
        amp *= 0.55
    img /= total
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _bilinear_rgb(tex, x, y):
    """Sample (Ht, Wt, 3) texture at float coords; clamp-to-edge padding."""
    Ht, Wt = tex.shape[:2]
    x = np.clip(x.astype(np.float32), 0.0, Wt - 1.001)
    y = np.clip(y.astype(np.float32), 0.0, Ht - 1.001)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    t = np.ascontiguousarray(tex, dtype=np.float32)
    # gather the 4 corners with fused lerps (2 mults/channel fewer than the
    # expanded tent form; this is the generator's hot loop)
    c00 = t[y0, x0]
    c01 = t[y0, x0 + 1]
    c10 = t[y0 + 1, x0]
    c11 = t[y0 + 1, x0 + 1]
    c00 += (c01 - c00) * fx
    c10 += (c11 - c10) * fx
    c00 += (c10 - c00) * fy
    return c00


# --------------------------------------------------------------------- #
# scene = posed surfaces
# --------------------------------------------------------------------- #
def _pose_mat(angle, scale, tx, ty, cx, cy):
    """2x3 similarity about (cx, cy): x' = s R (x - c) + c + t."""
    c, s = np.cos(angle) * scale, np.sin(angle) * scale
    A = np.array([[c, -s], [s, c]], np.float32)
    b = (np.array([cx + tx, cy + ty]) - A @ np.array([cx, cy])).astype(
        np.float32)
    return A, b


def _apply(A, b, xy):
    return xy @ A.T + b


def _invert(A, b):
    Ai = np.linalg.inv(A)
    return Ai, -Ai @ b


class Scene:
    """A background + sprites scene over T frames with analytic GT.

    Each surface has per-frame pose (A_t, b_t) mapping its FRAME-0 pixel
    footprint to frame t. Frame 0 is rendered at the identity pose.
    """

    def __init__(self, rng, H, W, T=8, n_sprites=3, max_shift=0.035,
                 max_rot=0.012, max_scale=0.006):
        self.H, self.W, self.T = H, W, T
        mag = max(H, W)
        # the background moves at shift_gain=0.6, so its texture only needs
        # a 0.6*max_shift*T margin (plus rotation/scale slack)
        marg = int(0.6 * max_shift * mag * T) + int(0.05 * mag) + 8
        self.bg_tex = multiscale_texture(rng, H + 2 * marg, W + 2 * marg)
        self.bg_off = ((self.bg_tex.shape[0] - H) // 2,
                       (self.bg_tex.shape[1] - W) // 2)
        self._grid_cache = None

        # per-frame poses: constant velocity similarity motions
        def make_motion(shift_gain=1.0):
            vx = rng.uniform(-max_shift, max_shift) * mag * shift_gain
            vy = rng.uniform(-max_shift, max_shift) * mag * shift_gain
            va = rng.uniform(-max_rot, max_rot)
            vs = rng.uniform(-max_scale, max_scale)
            cx = rng.uniform(0.3, 0.7) * W
            cy = rng.uniform(0.3, 0.7) * H
            return [(va * t, 1.0 + vs * t, vx * t, vy * t, cx, cy)
                    for t in range(T)]

        self.surfaces = []  # list of dicts, index 0 = background
        self.surfaces.append({"motion": make_motion(0.6), "sprite": None})
        for _ in range(n_sprites):
            w = int(rng.uniform(0.12, 0.33) * W)
            h = int(rng.uniform(0.12, 0.33) * H)
            x0 = int(rng.uniform(0, W - w))
            y0 = int(rng.uniform(0, H - h))
            tex = multiscale_texture(rng, h, w, base=6)
            ellipse = rng.uniform() < 0.5
            self.surfaces.append({
                "motion": make_motion(1.4),
                "sprite": (x0, y0, w, h, tex, ellipse),
            })

    # ----------------------------------------------------------------- #
    def _sprite_mask_local(self, surf, x, y):
        """Membership of FRAME-0 coords (x, y) in the sprite footprint."""
        x0, y0, w, h, _, ellipse = surf["sprite"]
        if ellipse:
            u = (x - (x0 + w / 2)) / (w / 2)
            v = (y - (y0 + h / 2)) / (h / 2)
            return u * u + v * v <= 1.0
        return (x >= x0) & (x < x0 + w) & (y >= y0) & (y < y0 + h)

    def _grid(self):
        if self._grid_cache is None:
            ys, xs = np.mgrid[0:self.H, 0:self.W]
            self._grid_cache = np.stack([xs, ys], axis=-1).astype(
                np.float32)  # (H, W, 2) xy
        return self._grid_cache

    def _pose(self, surf, t):
        return _pose_mat(*surf["motion"][t])

    def _sprite_bbox(self, surf, t):
        """Frame-t pixel bounding box of a sprite (clipped, may be empty)."""
        x0, y0, w, h, _, _ = surf["sprite"]
        corners = np.array([[x0, y0], [x0 + w, y0],
                            [x0, y0 + h], [x0 + w, y0 + h]], np.float32)
        A, b = self._pose(surf, t)
        c = _apply(A, b, corners)
        xmin = max(int(np.floor(c[:, 0].min())) - 1, 0)
        xmax = min(int(np.ceil(c[:, 0].max())) + 2, self.W)
        ymin = max(int(np.floor(c[:, 1].min())) - 1, 0)
        ymax = min(int(np.ceil(c[:, 1].max())) + 2, self.H)
        return ymin, ymax, xmin, xmax

    def composite(self, t):
        """(RGB uint8 frame, int32 id-map) of frame t in one pass.

        Per sprite, the inverse pose is only evaluated inside the sprite's
        transformed bounding box — the dominant generator cost was
        full-grid pose+mask work for surfaces covering ~5% of the frame.
        """
        H, W = self.H, self.W
        grid = self._grid()  # (H, W, 2)
        # background fills everything
        A, b = self._pose(self.surfaces[0], t)
        Ai, bi = _invert(A, b)
        loc = _apply(Ai, bi, grid.reshape(-1, 2))
        oy, ox = self.bg_off
        out = _bilinear_rgb(self.bg_tex, loc[:, 0] + ox,
                            loc[:, 1] + oy).reshape(H, W, 3)
        ids = np.zeros((H, W), np.int32)
        # sprites, painter's order, restricted to their bounding boxes
        for si, surf in enumerate(self.surfaces[1:], start=1):
            y0b, y1b, x0b, x1b = self._sprite_bbox(surf, t)
            if y1b <= y0b or x1b <= x0b:
                continue
            sub = grid[y0b:y1b, x0b:x1b].reshape(-1, 2)
            A, b = self._pose(surf, t)
            Ai, bi = _invert(A, b)
            loc = _apply(Ai, bi, sub)
            m = self._sprite_mask_local(surf, loc[:, 0], loc[:, 1])
            x0, y0, w, h, tex, _ = surf["sprite"]
            box = out[y0b:y1b, x0b:x1b].reshape(-1, 3)
            box[m] = _bilinear_rgb(tex, loc[m, 0] - x0, loc[m, 1] - y0)
            out[y0b:y1b, x0b:x1b] = box.reshape(y1b - y0b, x1b - x0b, 3)
            idbox = ids[y0b:y1b, x0b:x1b].reshape(-1)
            idbox[m] = si  # later sprites on top
            ids[y0b:y1b, x0b:x1b] = idbox.reshape(y1b - y0b, x1b - x0b)
        img = np.clip(out, 0, 255).astype(np.uint8)
        return img, ids

    def id_map(self, t):
        """(H, W) int surface-id visible at each pixel of frame t."""
        return self.composite(t)[1]

    def render(self, t):
        """RGB uint8 frame t."""
        return self.composite(t)[0]

    def flow_occl(self, t, ids0=None, ids_t=None):
        """Exact flow frame0->t + occlusion of frame-0 pixels at frame t.

        returns: flow (H, W, 2) float32, occl (H, W) float32 in {0, 1}.
        Occlusion = target out of frame OR a different surface visible at
        the target (nearest-pixel id test). ``ids0``/``ids_t`` accept
        precomputed ``id_map`` results so multi-pair extraction from one
        scene doesn't recompute them per pair.
        """
        H, W = self.H, self.W
        xy = self._grid().reshape(-1, 2)
        ids0 = (self.id_map(0) if ids0 is None else ids0).reshape(-1)
        tgt = np.empty_like(xy)
        for si, surf in enumerate(self.surfaces):
            m = ids0 == si
            if not m.any():
                continue
            A, b = self._pose(surf, t)  # pose_0 is identity by construction
            tgt[m] = _apply(A, b, xy[m])
        flow = (tgt - xy).astype(np.float32)

        if ids_t is None:
            ids_t = self.id_map(t)
        xi = np.rint(tgt[:, 0]).astype(np.int64)
        yi = np.rint(tgt[:, 1]).astype(np.int64)
        oof = (xi < 0) | (xi >= W) | (yi < 0) | (yi >= H)
        vis = np.zeros(xy.shape[0], bool)
        inb = ~oof
        vis[inb] = ids_t[yi[inb], xi[inb]] == ids0[inb]
        occl = (~vis).astype(np.float32)
        return flow.reshape(H, W, 2), occl.reshape(H, W)


# --------------------------------------------------------------------- #
# batch iterator for training
# --------------------------------------------------------------------- #
def scene_pair_block(rng, H, W, T=8, n_sprites=3):
    """All T-1 template->t pairs from ONE scene, renders/id-maps shared.

    A scene costs T renders + T id-maps; extracting every pair from it
    amortizes that to ~1 render per training example (vs 2 renders + 2
    id-maps for ``sample_pair``).
    """
    scene = Scene(rng, H, W, T=T, n_sprites=n_sprites)
    img0, ids0 = scene.composite(0)
    out = []
    for t in range(1, T):
        img_t, ids_t = scene.composite(t)
        flow, occl = scene.flow_occl(t, ids0=ids0, ids_t=ids_t)
        valid = ((np.abs(flow[..., 0]) < 400)
                 & (np.abs(flow[..., 1]) < 400)).astype(np.float32)
        out.append((img0, img_t, flow, valid, occl))
    return out


def sample_pair(rng, H, W, T=8, n_sprites=3, delta_weights=None):
    """One training example: (img1, img2, flow, valid, occl) frame0->t.

    ``t`` is drawn from 1..T-1 (log-leaning weights by default — the MFT
    chain consumes mostly small deltas but must survive large ones).
    """
    scene = Scene(rng, H, W, T=T, n_sprites=n_sprites)
    if delta_weights is None:
        ts = np.arange(1, T)
        w = 1.0 / np.sqrt(ts)
        delta_weights = w / w.sum()
    t = int(rng.choice(np.arange(1, T), p=delta_weights))
    img1 = scene.render(0)
    img2 = scene.render(t)
    flow, occl = scene.flow_occl(t)
    valid = (np.abs(flow[..., 0]) < 400) & (np.abs(flow[..., 1]) < 400)
    return img1, img2, flow, valid.astype(np.float32), occl


def make_batch(rng, batch_size, H, W, **kw):
    """Stacked float32 training batch (images in [0, 255] RGB)."""
    items = [sample_pair(rng, H, W, **kw) for _ in range(batch_size)]
    img1 = np.stack([i[0] for i in items]).astype(np.float32)
    img2 = np.stack([i[1] for i in items]).astype(np.float32)
    flow = np.stack([i[2] for i in items])
    valid = np.stack([i[3] for i in items])
    occl = np.stack([i[4] for i in items])
    return img1, img2, flow, valid, occl


# --------------------------------------------------------------------- #
# a Sintel-form tree for the trainer
# --------------------------------------------------------------------- #
def pair_flow_occl(scene, t0, t1, ids0, ids1):
    """Exact flow frame t0 -> t1 and occlusion of frame-t0 pixels at t1,
    from the two frames' id maps: a pixel of surface s moves by
    pose_t1(pose_t0^-1(x)) - x; occluded as in :meth:`Scene.flow_occl`."""
    H, W = scene.H, scene.W
    xy = scene._grid().reshape(-1, 2)
    ids0 = ids0.reshape(-1)
    tgt = np.empty_like(xy)
    for si, surf in enumerate(scene.surfaces):
        m = ids0 == si
        if not m.any():
            continue
        Ai, bi = _invert(*scene._pose(surf, t0))
        A, b = scene._pose(surf, t1)
        tgt[m] = _apply(A, b, _apply(Ai, bi, xy[m]))
    flow = (tgt - xy).astype(np.float32)
    xi = np.rint(tgt[:, 0]).astype(np.int64)
    yi = np.rint(tgt[:, 1]).astype(np.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    vis = np.zeros(xy.shape[0], bool)
    vis[inb] = ids1[yi[inb], xi[inb]] == ids0[inb]
    return flow.reshape(H, W, 2), (~vis).astype(np.float32).reshape(H, W)


def write_sintel_tree(root, scenes=("synth_0", "synth_1"), frames=5, H=436, W=1024,
                      seed=0):
    """Write synthetic scenes in MPI-Sintel's training layout under ``root``:
    ``training/{clean,final}/<scene>/frame_%04d.png`` (the same RGB frames),
    ``training/flow/<scene>/frame_%04d.flo`` (frame i -> i+1, numbered from
    1 by the first frame) and ``training/occlusions_rev/<scene>/
    frame_%04d.png`` (0/255). returns the root, for ``env.sintel_dir``."""
    from pathlib import Path

    from mft_tpu_torch.io.png import encode_png
    from mft_tpu_torch.train.flow_readers import write_flo, write_image
    root = Path(root)
    rng = np.random.default_rng(seed)
    for name in scenes:
        scene = Scene(rng, H, W, T=frames)
        comps = [scene.composite(t) for t in range(frames)]
        dirs = {k: root / "training" / k / name
                for k in ("clean", "final", "flow", "occlusions_rev")}
        for d in dirs.values():
            d.mkdir(parents=True, exist_ok=True)
        for t, (img, _) in enumerate(comps, start=1):
            write_image(dirs["clean"] / f"frame_{t:04d}.png", img)
            write_image(dirs["final"] / f"frame_{t:04d}.png", img)
        for t in range(frames - 1):
            flow, occl = pair_flow_occl(scene, t, t + 1, comps[t][1], comps[t + 1][1])
            write_flo(dirs["flow"] / f"frame_{t + 1:04d}.flo", flow)
            (dirs["occlusions_rev"] / f"frame_{t + 1:04d}.png").write_bytes(
                encode_png((occl * 255).astype(np.uint8)))
    return root
