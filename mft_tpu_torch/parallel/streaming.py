"""Multi-clip streaming: C clips tracked in lockstep, one batch a timestep.

Port of ``mft_tpu/parallel/streaming.py`` (JAX ``StreamingTracker``, the
throughput mode of ``BASELINE.json`` configs[4]). Each timestep runs, for
all C clips at once, what the single-clip tracker (``tracker/mft.py``) runs
for one: one encode of the C new frames, one (C·N)-pair RAFT batch over the
feature ring (clip-major: pair n of clip c is row c·N + n), one chain +
select launch over (C, N, H, W) (kernel ``mft_chain_select`` with its clip
axis) and one write per ring tensor. The launches a timestep are the
single-clip frame's whatever C is, while the device work grows C-fold.

The ring state is device tensors with a leading clip axis: ``mem_imgs``
(C, S, H, W, 3) uint8 RGB, ``mem_flow`` (C, S, H, W, 2), ``mem_occl`` and
``mem_sigma`` (C, S, H, W), ``mem_fmap`` and ``mem_cnet`` (C, S, ...) the
encoder features; S = ring + 1 slots, as the single-clip tracker's. The
candidate, schedule, warm-start and slot logic are the single-clip
tracker's own methods (:class:`mft_tpu_torch.tracker.mft.MFT`).

With a ``mesh`` (a ``DeviceMesh`` with a ``"data"`` axis of w ranks, one
process a rank) rank r owns clips [r·C/w, (r+1)·C/w): ``init`` and
``track`` take the global (C, ...) frames, as JAX's API does, and return
the rank's own clips' results. Clips are independent, so no collective is
needed (the per-process form of JAX's clip-axis sharding).
"""

import numpy as np
import torch

from mft_tpu_torch.config import cfg_value
from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.core.flowou import FlowOU
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref
from mft_tpu_torch.tracker.mft import MFT


class StreamingTracker:
    """Track ``n_clips`` equally sized clips in lockstep.

    ``init(frames)`` with (C, H, W, 3) uint8 BGR template frames, then
    ``track(frames)`` a timestep -> FlowOU with a leading clip axis (the
    rank's clips with a mesh). All clips share the tracker config (deltas,
    occlusion threshold, schedule, warm start).
    """

    def __init__(self, config, n_clips, mesh=None, device="cuda"):
        self.C = config
        self.n_clips = int(n_clips)
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is None:
            self.clips = (0, self.n_clips)
        else:
            from mft_tpu_torch.parallel.mesh import shard_range
            self.clips = shard_range(self.n_clips, mesh)
        # the single-clip tracker (its flower, candidate, schedule, warm-start
        # and slot logic) on this tracker's state; its own ring is never made
        self._single = MFT(config, device=self.device)
        self._single.time_direction = 1
        self.deltas = self._single.deltas
        self.ring = self._single.ring
        self.template_slot = self._single.template_slot
        self.iters_schedule = self._single.iters_schedule
        self._warm = self._single._warm_start()

    @property
    def flower(self):
        return self._single.flower

    @flower.setter
    def flower(self, flower):
        self._single.flower = flower

    @property
    def local_clips(self) -> int:
        """The number of clips this process tracks."""
        return self.clips[1] - self.clips[0]

    @property
    def occlusion_threshold(self) -> float:
        return float(cfg_value(self.C.occlusion_threshold, 0.02))

    def _use_features(self) -> bool:
        """The feature-ring step needs a flower that encodes single frames."""
        return hasattr(self.flower, "padded_encode")

    def _own(self, x):
        """This process's clips of a global (C, ...) array or tensor."""
        lo, hi = self.clips
        return x[lo:hi]

    def _to_device(self, frames) -> torch.Tensor:
        """(C, H, W, 3) global frames -> the own clips' (c, H, W, 3) on the
        device. uint8 frames are BGR and flipped to RGB, a tensor on its own
        device before it moves (no round trip through the host), as JAX's
        streaming tracker flips ``np.asarray`` of any frames; other dtypes
        pass as they are. (The single-clip tracker, like JAX's, passes
        tensors through.)"""
        if len(frames) != self.n_clips:
            raise ValueError(f"expected frames for {self.n_clips} clips, got {len(frames)}")
        frames = self._own(frames)
        if isinstance(frames, torch.Tensor):
            if frames.dtype == torch.uint8:
                frames = frames.flip(-1)
            return frames.to(self.device)
        return self._single._to_device(frames)

    def _row_to_device(self, x) -> torch.Tensor:
        """An injected (C, ...) row, the own clips only, as the single-clip
        tracker's ``_row_to_device`` (a device tensor is not copied to the
        host). Rows that hold the own clips alone pass whole."""
        if len(x) == self.n_clips:
            x = self._own(x)
        elif len(x) != self.local_clips:
            raise ValueError(f"an injected row holds {len(x)} clips, not "
                             f"{self.n_clips} (or this rank's {self.local_clips})")
        return self._single._row_to_device(x)

    # ------------------------------------------------------------------ #
    def init(self, frames, start_frame_i=0):
        """Start every clip on its template frame. frames: (C, H, W, 3)
        uint8 BGR with H and W multiples of 8 (no per-clip padding).
        returns: zero FlowOUs with a clip axis, as JAX's init."""
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames)
        shape = tuple(frames.shape)
        if len(shape) != 4 or shape[0] != self.n_clips:
            raise ValueError(f"init expects ({self.n_clips}, H, W, 3) frames, got {shape}")
        C, H, W = self.local_clips, shape[1], shape[2]
        if H % 8 or W % 8:
            raise ValueError(f"streaming expects H and W multiples of 8 (no per-clip "
                             f"padding), got {H}x{W}")
        self.img_H, self.img_W = H, W
        self.start_frame_i = int(start_frame_i)
        self.current_frame_i = self.start_frame_i
        self._single.start_frame_i = self.start_frame_i
        imgs = self._to_device(frames)
        S, dev, ts = self.ring + 1, self.device, self.template_slot
        self.mem_imgs = torch.zeros((C, S, H, W, 3), dtype=imgs.dtype, device=dev)
        self.mem_imgs[:, ts] = imgs
        self.mem_flow = torch.zeros((C, S, H, W, 2), dtype=torch.float32, device=dev)
        self.mem_occl = torch.zeros((C, S, H, W), dtype=torch.float32, device=dev)
        self.mem_sigma = torch.zeros((C, S, H, W), dtype=torch.float32, device=dev)
        self.mem_fmap = self.mem_cnet = None
        if self._use_features():
            fm, cn = self.flower.padded_encode(imgs)
            self.mem_fmap = fm.new_zeros((C, S, *fm.shape[1:]))
            self.mem_cnet = cn.new_zeros((C, S, *cn.shape[1:]))
            self.mem_fmap[:, ts] = fm
            self.mem_cnet[:, ts] = cn
        return FlowOU(torch.zeros((C, H, W, 2), device=dev), torch.zeros((C, H, W), device=dev),
                      torch.zeros((C, H, W), device=dev))

    def track(self, frames, injected=None):
        """One lockstep timestep over all clips. frames: (C, H, W, 3).

        ``injected`` optionally maps candidate-pair index -> a row triple
        (flow (C, H, W, 2), occlusion (C, H, W), sigma (C, H, W)), numpy
        arrays or device tensors: those pairs skip RAFT (the single-clip
        tracker's FlowCache injection, JAX ``_get_step_inject``), the valid
        pairs left run as one batch of K·C pairs, the invalid ones get
        zeros, and chain + select runs over every candidate.
        returns: FlowOU (c, H, W, ...) of the own clips.
        """
        self.current_frame_i += 1
        t = self.current_frame_i
        imgs = self._to_device(frames)
        cands = self._single._candidates(t)
        slots = self._single._index([c.slot for c in cands])
        valid = self._single._index([c.valid for c in cands], torch.bool)
        wslot = t % self.ring
        if injected:
            if not self._use_features():
                raise NotImplementedError(
                    "streaming injection requires the feature-ring step (a flower with "
                    "padded_encode)")
            right, feats = self._pairs_injected(imgs, cands, slots, injected, t)
        elif self._use_features():
            right, feats = self._pairs(imgs, slots, t)
        else:
            right, feats = self._pairs_images(imgs, slots), None
        return self._select_and_write(imgs, slots, right, valid, wslot, feats)

    # ------------------------------------------------------------------ #
    def _warm_init(self, t, K, pos):
        """The (C·K, H, W, 2) initial flow of a warm-started batch of K pairs
        a clip: each clip's template pair (at ``pos``) starts from that clip's
        flow of the previous frame, the other pairs from zero."""
        prev = self.mem_flow[:, self._single._prev_slot(t)]
        init = prev.new_zeros((prev.shape[0], K, *prev.shape[1:]))
        init[:, pos] = prev
        return init.flatten(0, 1)

    def _features_forward(self, f_new, sub, idx, t):
        """RAFT over the clip-major batch of the pairs ``idx`` (ring slots
        ``sub``) of every clip: one ``features_forward`` of C·K pairs.
        returns: flow (C, K, H, W, 2), occlusion and sigma (C, K, H, W)."""
        C, K = f_new.shape[0], len(idx)
        fmap1 = self.mem_fmap.index_select(1, sub).flatten(0, 1)
        cnet1 = self.mem_cnet.index_select(1, sub).flatten(0, 1)
        fmap2 = f_new[:, None].expand(C, K, *f_new.shape[1:]).reshape(C * K, *f_new.shape[1:])
        kw = {}
        if self.iters_schedule is not None:
            kw["iters_schedule"] = tuple(self.iters_schedule[i] for i in idx) * C
        if self._warm and self._single._inf_idx in idx:
            kw["init_flow"] = self._warm_init(t, K, idx.index(self._single._inf_idx))
        out = self.flower.features_forward(fmap1, fmap2, cnet1, self.img_H, self.img_W, **kw)
        return tuple(x.reshape(C, K, *x.shape[1:]) for x in out)

    def _pairs(self, imgs, slots, t):
        """The feature-ring step's pairs: encode the C new frames once, every
        pair of every clip in one RAFT batch."""
        f_new, c_new = self.flower.padded_encode(imgs)
        right = self._features_forward(f_new, slots, list(range(len(self.deltas))), t)
        return FlowOU(*right), (f_new, c_new)

    def _pairs_injected(self, imgs, cands, slots, injected, t):
        """The injected step's pairs: the injected rows as given, the valid
        pairs left through RAFT as one batch, zeros for the rest."""
        f_new, c_new = self.flower.padded_encode(imgs)
        compute_idx = [i for i, c in enumerate(cands) if c.valid and i not in injected]
        rows = {i: tuple(self._row_to_device(x) for x in injected[i]) for i in injected}
        if compute_idx:
            sub = slots.index_select(0, self._single._index(compute_idx))
            comp = self._features_forward(f_new, sub, compute_idx, t)
            for p, i in enumerate(compute_idx):
                rows[i] = tuple(x[:, p] for x in comp)
        if len(rows) < len(cands):
            C, H, W = self.local_clips, self.img_H, self.img_W
            zero = (torch.zeros((C, H, W, 2), device=self.device),
                    torch.zeros((C, H, W), device=self.device),
                    torch.zeros((C, H, W), device=self.device))
        per = [rows[i] if i in rows else zero for i in range(len(cands))]
        right = FlowOU(*(torch.stack([p[f] for p in per], dim=1) for f in range(3)))
        return right, (f_new, c_new)

    def _pairs_images(self, imgs, slots):
        """The image step (a flower with no ``padded_encode``): every pair of
        every clip through ``forward_batch`` on the ring's images."""
        if self.C.flow_iters_schedule or self._warm:
            # this step runs the flower's uniform zero-init iterations; dropping a
            # configured schedule or warm start would track another mode
            raise NotImplementedError(
                "flow_iters_schedule/warm_start_inf require the feature-ring streaming "
                "step (a flower with padded_encode); this flower has none")
        C, N = self.local_clips, len(self.deltas)
        left = self.mem_imgs.index_select(1, slots).flatten(0, 1)
        right = imgs[:, None].expand(C, N, *imgs.shape[1:]).reshape(C * N, *imgs.shape[1:])
        out = self.flower.forward_batch(left, right)
        return FlowOU(*(x.reshape(C, N, *x.shape[1:]) for x in out))

    def _select_and_write(self, imgs, slots, right, valid, wslot, feats):
        """One chain + select over (C, N, H, W) and one write per ring tensor."""
        left = FlowOU(flow=self.mem_flow.index_select(1, slots),
                      occlusion=self.mem_occl.index_select(1, slots),
                      sigma=self.mem_sigma.index_select(1, slots))
        # the flower's plain_ops runs every kernel's plain version, as MFT's does
        select = chain_select_ref if getattr(self.flower, "plain_ops", False) else chain_select
        result = select(left, right, valid, self.occlusion_threshold)
        self.mem_imgs[:, wslot] = imgs
        self.mem_flow[:, wslot] = result.flow
        self.mem_occl[:, wslot] = result.occlusion
        self.mem_sigma[:, wslot] = result.sigma
        if feats is not None:
            self.mem_fmap[:, wslot] = feats[0]
            self.mem_cnet[:, wslot] = feats[1]
        return result
