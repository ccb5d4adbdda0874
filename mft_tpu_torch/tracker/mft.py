"""The MFT tracker: per-frame delta chaining, selection and ring memory.

Port of ``mft_tpu/tracker/mft.py`` (reference MFT/MFT.py:13-185) for its
fused frame step (``MFT._fused_frame_body``):

- ``MFT(config, device="cuda")``, ``init(img)``, ``track(img)`` -> meta with
  a FlowOU (template -> current frame) in ``meta.result``; images are
  (H, W, 3) uint8 BGR numpy arrays (opencv convention);
- device-resident ring memory: slots ``0..ring-1`` hold the last
  ``max_finite_delta`` frames' image, selected flow, occlusion, sigma and
  encoder features, slot ``ring`` the template frame; the slots are updated
  in place after each frame's result is computed;
- per frame: encode ONLY the new frame, run all delta pairs as one batch
  from the feature ring, chain + select per pixel, write the ring.

Not ported: FlowCache reads/writes and injected pairs, ``warm_start_inf``,
``track_chunk``, per-delta iteration schedules and the unfused timer path.
A config that sets one of these options raises (:data:`UNPORTED_OPTIONS`)
instead of being tracked as the default frame.
"""

from types import SimpleNamespace

import numpy as np
import torch

from mft_tpu_torch.config import cfg_value
from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.core.flowou import FlowOU, identity_flowou
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref

# tracker options of the JAX package that change the frame step, with the
# item of ROADMAP.md that ports them; a config that sets one raises
UNPORTED_OPTIONS = {
    "warm_start_inf": "A7 (template pair warm-started from the previous frame)",
    "flow_iters_schedule": "A9 (per-delta iteration schedules)",
    "cache_delta_infinity": "A6 (FlowCache and injected pairs)",
    "timers_enabled": "A17 (the unfused phase-timer frame step)",
}


class MFT:
    """Multi-Flow dense Tracker.

    ``config.exact_chain`` is accepted with either value: the port's chain +
    select (kernel and plain version) always computes the exact
    ``chain_select_ref`` math, which is what the option asks of the JAX
    tracker. The options of :data:`UNPORTED_OPTIONS` raise when set.
    """

    def __init__(self, config, device="cuda"):
        self.C = config
        deltas = list(config.deltas)
        if (bool(config.warm_start_inf) and any(np.isinf(d) for d in deltas)
                and bool(config.cache_delta_infinity)):
            raise ValueError(
                "warm_start_inf and cache_delta_infinity cannot be combined: "
                "warm-started template flows depend on the tracking history "
                "that produced them, so they are not reusable cache entries")
        for key, item in UNPORTED_OPTIONS.items():
            if bool(getattr(config, key)):
                raise NotImplementedError(f"{key} is not ported yet (ROADMAP {item})")
        self.device = resolve_device(device)
        self.deltas = sorted(deltas, key=lambda d: 0 if np.isinf(d) else d)
        finite = [int(d) for d in self.deltas if np.isfinite(d)]
        self.ring = max(finite) if finite else 1
        self.template_slot = self.ring
        self.occlusion_threshold = float(cfg_value(config.occlusion_threshold, 0.02))
        self.flower = config.flow_config.of_class(config.flow_config,
                                                  device=self.device)
        self._idx_cache = {}

    @property
    def plain_ops(self) -> bool:
        """True: run the plain PyTorch versions of every kernel, even on the
        card (to compare the two); False (default): the kernels."""
        return self.flower.plain_ops

    @plain_ops.setter
    def plain_ops(self, value: bool):
        self.flower.plain_ops = bool(value)

    def _to_device(self, img) -> torch.Tensor:
        """(H, W, 3) uint8 BGR host image -> (H, W, 3) uint8 RGB on the device;
        a tensor passes through."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        if img.dtype == np.uint8:
            img = np.ascontiguousarray(img[:, :, ::-1])
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    # ------------------------------------------------------------------ #
    def init(self, img, start_frame_i=0, time_direction=1):
        """Initialize tracking on the template frame (reference MFT.py:22-53)."""
        if time_direction not in (+1, -1):
            raise ValueError(f"time_direction must be +1 or -1, got {time_direction}")
        self.img_H, self.img_W = img.shape[:2]
        self.start_frame_i = int(start_frame_i)
        self.current_frame_i = self.start_frame_i
        self.time_direction = int(time_direction)

        H, W, S, dev = self.img_H, self.img_W, self.ring + 1, self.device
        img_d = self._to_device(img)
        self.mem_imgs = torch.zeros((S, H, W, 3), dtype=img_d.dtype, device=dev)
        self.mem_imgs[self.template_slot] = img_d
        self.mem_flow = torch.zeros((S, H, W, 2), dtype=torch.float32, device=dev)
        self.mem_occl = torch.zeros((S, H, W), dtype=torch.float32, device=dev)
        self.mem_sigma = torch.zeros((S, H, W), dtype=torch.float32, device=dev)
        fm, cn = self.flower.padded_encode(img_d[None])
        self.mem_fmap = fm.new_zeros((S, *fm.shape[1:]))
        self.mem_cnet = cn.new_zeros((S, *cn.shape[1:]))
        self.mem_fmap[self.template_slot] = fm[0]
        self.mem_cnet[self.template_slot] = cn[0]

        meta = SimpleNamespace()
        meta.result = identity_flowou((H, W), device=dev)
        return meta

    def is_before_start(self, frame_i):
        return ((self.time_direction > 0 and frame_i < self.start_frame_i)
                or (self.time_direction < 0 and frame_i > self.start_frame_i))

    def _candidates(self, t):
        """(ring slot, valid) of each delta's left frame at frame ``t``
        (reference MFT.py:74-102): the template for delta=inf, for the start
        frame and (invalid) for frames before the start."""
        out = []
        for delta in self.deltas:
            if np.isinf(delta):
                out.append((self.template_slot, True))
                continue
            li = t - int(delta) * self.time_direction
            if self.is_before_start(li):
                out.append((self.template_slot, False))
            elif li == self.start_frame_i:
                out.append((self.template_slot, True))
            else:
                out.append((li % self.ring, True))
        return out

    def _step_indices(self, cands, t):
        """Device (slots, valid) and the host write slot, cached: the pattern
        is periodic in t, so after one ring cycle nothing is uploaded."""
        key = tuple(zip(*cands))
        if key not in self._idx_cache:
            self._idx_cache[key] = (
                torch.tensor(key[0], dtype=torch.long, device=self.device),
                torch.tensor(key[1], dtype=torch.bool, device=self.device))
        slots, valid = self._idx_cache[key]
        return slots, valid, t % self.ring

    def pairs(self, img, t):
        """The frame step up to chain + select, for device image ``img`` as
        frame ``t``, changing no state: encode ONLY the new frame (every left
        frame's features are already in the ring, each was the current frame
        once) and run all delta pairs as one batch.

        returns: left (the ring's results of the left frames) and right (the
        pairs' flows) FlowOUs with a candidate axis (N, H, W, ...), valid
        (N,) and the new frame's (fmap, cnet) features.
        """
        slots, valid, _ = self._step_indices(self._candidates(t), t)
        N = len(self.deltas)
        f_new, c_new = self.flower.padded_encode(img[None])
        fmap1 = self.mem_fmap.index_select(0, slots)
        cnet1 = self.mem_cnet.index_select(0, slots)
        fmap2 = f_new.expand(N, *f_new.shape[1:])
        flows, occls, sigmas = self.flower.features_forward(
            fmap1, fmap2, cnet1, self.img_H, self.img_W)
        left = FlowOU(flow=self.mem_flow.index_select(0, slots),
                      occlusion=self.mem_occl.index_select(0, slots),
                      sigma=self.mem_sigma.index_select(0, slots))
        right = FlowOU(flow=flows, occlusion=occls, sigma=sigmas)
        return left, right, valid, (f_new, c_new)

    # ------------------------------------------------------------------ #
    def track(self, input_img):
        """Track one frame; returns meta.result = FlowOU template -> current.

        Reference parity: MFT/MFT.py:55-154.
        """
        self.current_frame_i += self.time_direction
        t = self.current_frame_i
        img = self._to_device(input_img)
        left, right, valid, (f_new, c_new) = self.pairs(img, t)
        select = chain_select_ref if self.plain_ops else chain_select
        result = select(left, right, valid, self.occlusion_threshold)

        wslot = t % self.ring
        self.mem_imgs[wslot] = img
        self.mem_flow[wslot] = result.flow
        self.mem_occl[wslot] = result.occlusion
        self.mem_sigma[wslot] = result.sigma
        self.mem_fmap[wslot] = f_new[0]
        self.mem_cnet[wslot] = c_new[0]

        meta = SimpleNamespace()
        meta.result = result
        return meta
