"""The MFT tracker: per-frame delta chaining, selection and ring memory.

Port of ``mft_tpu/tracker/mft.py`` (reference MFT/MFT.py:13-185):

- ``MFT(config, device="cuda")``, ``init(img)``, ``track(img)`` -> meta with
  a FlowOU (template -> current frame) in ``meta.result``; images are
  (H, W, 3) uint8 BGR numpy arrays (opencv convention);
- device-resident ring memory: slots ``0..ring-1`` hold the last
  ``max_finite_delta`` frames' image, selected flow, occlusion, sigma and
  encoder features, slot ``ring`` the template frame; the slots are updated
  in place after each frame's result is computed;
- the fused frame step (JAX ``MFT._fused_frame_body``): encode ONLY the new
  frame, run all delta pairs as one batch from the feature ring, chain +
  select per pixel, write the ring;
- ``flow_iters_schedule`` (:meth:`MFT._iters_schedule`): iterations per
  delta pair (``RAFT._flow_scheduled``);
- ``warm_start_inf`` (:meth:`MFT._warm_start`): the template pair starts
  from the previous frame's selected flow;
- ``timers_enabled``: the unfused step of JAX's ``track`` (no feature ring:
  both images of every pair encoded by ``forward_batch``), its two phases
  timed with device synchronisation; ``meta.phase_ms`` holds their ms.

Not ported: FlowCache reads/writes and injected pairs
(``cache_delta_infinity``) and ``track_chunk``. A config that sets
``cache_delta_infinity`` raises (:data:`UNPORTED_OPTIONS`) instead of being
tracked as the default frame.
"""

from types import SimpleNamespace

import numpy as np
import torch

from mft_tpu_torch.config import cfg_value
from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.core.flowou import FlowOU, identity_flowou
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref
from mft_tpu_torch.utils.timing import general_time_measurer


# tracker options of the JAX package that change the frame step, with the
# item of ROADMAP.md that ports them; a config that sets one raises
UNPORTED_OPTIONS = {
    "cache_delta_infinity": "A6 (FlowCache and injected pairs)",
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
        self.deltas = sorted(config.deltas, key=lambda d: 0 if np.isinf(d) else d)
        self._inf_idx = next((i for i, d in enumerate(self.deltas) if np.isinf(d)), None)
        if self._warm_start() and bool(config.cache_delta_infinity):
            raise ValueError(
                "warm_start_inf and cache_delta_infinity cannot be combined: "
                "warm-started template flows depend on the tracking history "
                "that produced them, so they are not reusable cache entries")
        for key, item in UNPORTED_OPTIONS.items():
            if bool(getattr(config, key)):
                raise NotImplementedError(f"{key} is not ported yet (ROADMAP {item})")
        self.iters_schedule = self._iters_schedule()
        self.timers_enabled = bool(config.timers_enabled)
        self.device = resolve_device(device)
        finite = [int(d) for d in self.deltas if np.isfinite(d)]
        self.ring = max(finite) if finite else 1
        self.template_slot = self.ring
        self.occlusion_threshold = float(cfg_value(config.occlusion_threshold, 0.02))
        self.flower = config.flow_config.of_class(config.flow_config,
                                                  device=self.device)
        self._idx_cache = {}

    def _warm_start(self) -> bool:
        """``warm_start_inf``: the template (delta=inf) pair's iterations start
        from the previous frame's selected flow instead of zero (JAX
        ``MFT._warm_start``); a no-op when no delta is infinite."""
        return bool(self.C.warm_start_inf) and self._inf_idx is not None

    def _prev_slot(self, t) -> int:
        """Ring slot of frame ``t - time_direction``'s selected flow, written
        one step ago; on the first tracked frame the slot is still zero, the
        identity flow of the template frame."""
        return (t - self.time_direction) % self.ring

    def _iters_schedule(self):
        """Iterations per delta pair from ``flow_iters_schedule`` (JAX
        ``MFT._iters_schedule``), a tuple in the order of ``self.deltas``, or
        None for ``flow_iters`` on every pair. A mapping {delta: iters}
        (``np.inf`` or ``'inf'`` keys the template pair; a missing delta gets
        ``flow_config.flow_iters``) or a sequence in the sorted delta order."""
        sched = self.C.flow_iters_schedule
        if not sched:
            return None
        default = int(self.C.flow_config.flow_iters or 12)
        if hasattr(sched, "items"):
            def match(d):
                for k, it in sched.items():
                    if isinstance(k, str):
                        if k == "inf" and np.isinf(d):
                            return int(it)
                    elif np.isinf(k) and np.isinf(d):
                        return int(it)
                    elif np.isfinite(k) and np.isfinite(d) and float(k) == float(d):
                        return int(it)
                return default
            return tuple(match(d) for d in self.deltas)
        out = tuple(int(i) for i in sched)
        if len(out) != len(self.deltas):
            raise ValueError(
                f"flow_iters_schedule len {len(out)} != {len(self.deltas)} deltas")
        return out

    def _flow_kwargs(self, t, batch):
        """The keywords of the flower's forward for frame ``t``: the schedule
        and, in warm-start mode, the previous frame's flow for the template
        pair (its index ``init_slot`` when ``batch`` is False, else as a
        full-batch init). Unset options are not passed."""
        kw = {}
        if self.iters_schedule is not None:
            kw["iters_schedule"] = self.iters_schedule
        if self._warm_start():
            prev = self.mem_flow[self._prev_slot(t)]
            if batch:
                init = prev.new_zeros((len(self.deltas), *prev.shape))
                init[self._inf_idx] = prev
                kw["init_flow"] = init
            else:
                kw["init_flow"], kw["init_slot"] = prev, self._inf_idx
        return kw

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
        self.mem_fmap = self.mem_cnet = None
        if not self.timers_enabled:
            # feature ring of the fused step: later frames encode only themselves
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
        """The fused frame step up to chain + select, for device image
        ``img`` as frame ``t``, changing no state: encode ONLY the new frame
        (every left frame's features are already in the ring, each was the
        current frame once) and run all delta pairs as one batch.

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
            fmap1, fmap2, cnet1, self.img_H, self.img_W, **self._flow_kwargs(t, False))
        right = FlowOU(flow=flows, occlusion=occls, sigma=sigmas)
        return self._left(slots), right, valid, (f_new, c_new)

    def _left(self, slots) -> FlowOU:
        """The ring's results of the left frames at ``slots``."""
        return FlowOU(flow=self.mem_flow.index_select(0, slots),
                      occlusion=self.mem_occl.index_select(0, slots),
                      sigma=self.mem_sigma.index_select(0, slots))

    def _acquire_flows(self, img, slots, t) -> FlowOU:
        """The unfused step's pairwise flows (JAX ``_acquire_flows`` without
        a FlowCache): every candidate, invalid ones included (they read the
        template slot and are masked in selection), through
        ``forward_batch`` on the ring's images and ``img``."""
        left = self.mem_imgs.index_select(0, slots)
        right = img.expand(len(self.deltas), *img.shape)
        flows, occls, sigmas = self.flower.forward_batch(left, right,
                                                         **self._flow_kwargs(t, True))
        return FlowOU(flow=flows, occlusion=occls, sigma=sigmas)

    def _select_and_write(self, img, left, right, valid, wslot):
        """Chain + select (K3, or its plain version with ``plain_ops``) and
        the ring writes of the frame's image and result."""
        select = chain_select_ref if self.plain_ops else chain_select
        result = select(left, right, valid, self.occlusion_threshold)
        self.mem_imgs[wslot] = img
        self.mem_flow[wslot] = result.flow
        self.mem_occl[wslot] = result.occlusion
        self.mem_sigma[wslot] = result.sigma
        return result

    # ------------------------------------------------------------------ #
    def track(self, input_img):
        """Track one frame; returns meta.result = FlowOU template -> current.

        Reference parity: MFT/MFT.py:55-154.
        """
        self.current_frame_i += self.time_direction
        t = self.current_frame_i
        img = self._to_device(input_img)
        meta = SimpleNamespace()
        if self.timers_enabled:
            meta.result, meta.phase_ms = self._track_timed(img, t)
            return meta
        left, right, valid, (f_new, c_new) = self.pairs(img, t)
        wslot = t % self.ring
        meta.result = self._select_and_write(img, left, right, valid, wslot)
        self.mem_fmap[wslot] = f_new[0]
        self.mem_cnet[wslot] = c_new[0]
        return meta

    def _track_timed(self, img, t):
        """The unfused frame step of ``timers_enabled`` (JAX ``track``'s
        unfused branch): the pairwise flows, then chain + select and the
        ring writes, each phase timed to its device completion.
        returns: (result, {'flow+chain': ms, 'selection': ms})."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else None
        slots, valid, wslot = self._step_indices(self._candidates(t), t)
        flow_timer = general_time_measurer("flow+chain", device_sync_fn=sync,
                                           start_now=True)
        right = self._acquire_flows(img, slots, t)
        flow_timer.stop()
        sel_timer = general_time_measurer("selection", device_sync_fn=sync,
                                          start_now=True)
        result = self._select_and_write(img, self._left(slots), right, valid, wslot)
        sel_timer.stop()
        return result, {timer.name: 1e3 * timer.report("sum")
                        for timer in (flow_timer, sel_timer)}
