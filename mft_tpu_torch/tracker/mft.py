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
  timed with device synchronisation; ``meta.phase_ms`` holds their ms;
- ``init(img, flow_cache=FlowCache)`` (:meth:`MFT._track_fused_cached`,
  JAX ``_track_fused_cached``): pairwise flows are read from and written to
  a :class:`mft_tpu_torch.io.FlowCache`, keyed (left frame, right frame),
  so that passes over one clip from other start frames reuse them. A frame
  with any valid finite pair missing runs the whole batch and writes every
  cacheable miss back (on the card as device rows); a frame whose valid
  finite pairs all hit runs RAFT on the pairs that missed alone (the
  template pair, unless ``cache_delta_infinity`` makes it cacheable too),
  the hits injected; with none left it runs no RAFT at all, only the encode,
  chain + select and the ring writes;
- ``track_chunk(imgs)``: K frames, the same results as K calls of
  :meth:`MFT.track`, bit for bit (JAX's one-dispatch chunk; the port runs
  the K frame steps in turn).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from mft_tpu_torch.config import cfg_value
from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.core.flowou import FlowOU, identity_flowou
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref
from mft_tpu_torch.utils.timing import general_time_measurer


@dataclasses.dataclass
class _Candidate:
    """One delta pair of a frame: its left frame's id and ring slot, whether
    it is valid (its left frame exists) and whether its flow may be cached."""
    delta: float
    left_id: int
    slot: int
    valid: bool
    cacheable: bool


class MFT:
    """Multi-Flow dense Tracker.

    ``config.exact_chain`` is accepted with either value: the port's chain +
    select (kernel and plain version) always computes the exact
    ``chain_select_ref`` math, which is what the option asks of the JAX
    tracker.
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
        self.iters_schedule = self._iters_schedule()
        self.device = resolve_device(device)
        finite = [int(d) for d in self.deltas if np.isfinite(d)]
        self.ring = max(finite) if finite else 1
        self.template_slot = self.ring
        self.flower = config.flow_config.of_class(config.flow_config,
                                                  device=self.device)
        self.flow_cache = None
        self._idx_cache = {}

    # read from self.C on every use: a runner may swap configs that share
    # the flow setup (deltas, schedule, warm start) on one tracker
    @property
    def occlusion_threshold(self) -> float:
        return float(cfg_value(self.C.occlusion_threshold, 0.02))

    @property
    def timers_enabled(self) -> bool:
        return bool(self.C.timers_enabled)

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

    def _flow_kwargs(self, t, idx=None, batch=False):
        """The keywords of the flower's forward for frame ``t`` over the pairs
        ``idx`` (all of them if None, JAX ``_features_fwd(compute_idx)``):
        the schedule's entries for those pairs and, in warm-start mode when
        the template pair is among them, the previous frame's flow for it
        (with its position in the sub-batch as ``init_slot`` when ``batch``
        is False, else as a sub-batch init). Unset options are not passed."""
        idx = list(range(len(self.deltas))) if idx is None else list(idx)
        kw = {}
        if self.iters_schedule is not None:
            kw["iters_schedule"] = tuple(self.iters_schedule[i] for i in idx)
        if self._warm_start() and self._inf_idx in idx:
            prev = self.mem_flow[self._prev_slot(t)]
            pos = idx.index(self._inf_idx)
            if batch:
                init = prev.new_zeros((len(idx), *prev.shape))
                init[pos] = prev
                kw["init_flow"] = init
            else:
                kw["init_flow"], kw["init_slot"] = prev, pos
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

    def _row_to_device(self, x) -> torch.Tensor:
        """A cache entry's array on the device as float32 (a device-tier
        tensor passes through with no copy)."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    # ------------------------------------------------------------------ #
    def init(self, img, start_frame_i=0, time_direction=1, flow_cache=None):
        """Initialize tracking on the template frame (reference MFT.py:22-53);
        ``flow_cache`` an optional :class:`mft_tpu_torch.io.FlowCache` the
        frames read pairwise flows from and write them to."""
        if time_direction not in (+1, -1):
            raise ValueError(f"time_direction must be +1 or -1, got {time_direction}")
        self.img_H, self.img_W = img.shape[:2]
        self.start_frame_i = int(start_frame_i)
        self.current_frame_i = self.start_frame_i
        self.time_direction = int(time_direction)
        self.flow_cache = flow_cache

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
        """The delta pairs of frame ``t`` (reference MFT.py:74-102, JAX
        ``_candidates``): the template for delta=inf (cacheable only with
        ``cache_delta_infinity``), for the start frame and (invalid) for
        frames before the start."""
        out = []
        cache_inf = bool(self.C.cache_delta_infinity)
        for delta in self.deltas:
            if np.isinf(delta):
                out.append(_Candidate(delta, self.start_frame_i, self.template_slot,
                                      True, cache_inf))
                continue
            li = t - int(delta) * self.time_direction
            if self.is_before_start(li):
                out.append(_Candidate(delta, li, self.template_slot, False, False))
            elif li == self.start_frame_i:
                out.append(_Candidate(delta, li, self.template_slot, True, True))
            else:
                out.append(_Candidate(delta, li, li % self.ring, True, True))
        return out

    def _index(self, values, dtype=torch.long) -> torch.Tensor:
        """A device tensor of ``values``, cached: the patterns are periodic in
        the frame index, so after one ring cycle nothing is uploaded."""
        key = (tuple(values), dtype)
        if key not in self._idx_cache:
            self._idx_cache[key] = torch.tensor(key[0], dtype=dtype, device=self.device)
        return self._idx_cache[key]

    def _step_indices(self, cands, t):
        """Device (slots, valid) of the candidates and the host write slot."""
        return (self._index([c.slot for c in cands]),
                self._index([c.valid for c in cands], torch.bool), t % self.ring)

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
            fmap1, fmap2, cnet1, self.img_H, self.img_W, **self._flow_kwargs(t))
        right = FlowOU(flow=flows, occlusion=occls, sigma=sigmas)
        return self._left(slots), right, valid, (f_new, c_new)

    def _left(self, slots) -> FlowOU:
        """The ring's results of the left frames at ``slots``."""
        return FlowOU(flow=self.mem_flow.index_select(0, slots),
                      occlusion=self.mem_occl.index_select(0, slots),
                      sigma=self.mem_sigma.index_select(0, slots))

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

    def _write_features(self, wslot, f_new, c_new):
        self.mem_fmap[wslot] = f_new[0]
        self.mem_cnet[wslot] = c_new[0]

    # ------------------------------------------------------------------ #
    # FlowCache
    def _read_cache_hits(self, cands, t):
        """One cache policy for both frame steps (JAX ``_read_cache_hits``):
        read every valid cacheable candidate. returns: ({candidate index:
        cached (flow, occl, sigma)}, whether ALL valid finite pairs hit, the
        condition for skipping the full batch)."""
        cache = self.flow_cache
        cached = {}
        if cache is not None:
            for i, c in enumerate(cands):
                if c.valid and c.cacheable:
                    hit = cache.read(c.left_id, t)
                    if hit is not None:
                        cached[i] = hit
        finite_valid = [i for i, c in enumerate(cands) if c.valid and np.isfinite(c.delta)]
        all_finite_hit = cache is not None and all(i in cached for i in finite_valid)
        return cached, all_finite_hit

    def _write_rows(self, cands, t, idx, right: FlowOU):
        """Write the rows ``idx`` of the batch ``right`` to the cache under
        their candidates' keys: one gather a field into tensors that hold
        those rows alone, so that the device tier's bytes are what it keeps
        alive."""
        if not idx:
            return
        rows = self._index([k for k, _ in idx])
        fl, oc, si = (x.index_select(0, rows) for x in (right.flow, right.occlusion,
                                                       right.sigma))
        for p, (_, i) in enumerate(idx):
            self.flow_cache.write(cands[i].left_id, t, fl[p], oc[p], si[p])

    def _stack_rows(self, rows, N):
        """(N, ...) flows, occlusions and sigmas from {candidate index: row
        triple}; the candidates without a row (invalid ones) get zeros."""
        if len(rows) < N:
            H, W = self.img_H, self.img_W
            zero = (torch.zeros((H, W, 2), device=self.device),
                    torch.zeros((H, W), device=self.device),
                    torch.zeros((H, W), device=self.device))
        per = [rows[i] if i in rows else zero for i in range(N)]
        return FlowOU(*(torch.stack([self._row_to_device(p[f]) for p in per])
                        for f in range(3)))

    def _track_fused_cached(self, img, cands, t):
        """The fused frame step under a FlowCache (JAX ``_track_fused_cached``,
        reference MFT.py:189-230). Any valid finite pair missing: the whole
        batch, every cacheable miss written back (computed values win over
        stale hits). All of them hit: the injected variant (JAX
        ``_get_fused_frame_inject``): only the valid pairs that missed run
        through RAFT, with their schedule entries and, in warm-start mode,
        the template pair's init at its place in the sub-batch; the hits go
        in as they are (device-tier rows with no copy); with no pair to
        compute the frame runs no RAFT at all."""
        cached, all_finite_hit = self._read_cache_hits(cands, t)
        if not all_finite_hit:
            return self._fused_step(img, t, cands, cached)
        slots, valid, wslot = self._step_indices(cands, t)
        compute_idx = [i for i, c in enumerate(cands) if c.valid and i not in cached]
        f_new, c_new = self.flower.padded_encode(img[None])
        rows = dict(cached)
        if compute_idx:
            sub = slots.index_select(0, self._index(compute_idx))
            K = len(compute_idx)
            comp = self.flower.features_forward(
                self.mem_fmap.index_select(0, sub), f_new.expand(K, *f_new.shape[1:]),
                self.mem_cnet.index_select(0, sub), self.img_H, self.img_W,
                **self._flow_kwargs(t, compute_idx))
            comp = FlowOU(*comp)
            for p, i in enumerate(compute_idx):
                rows[i] = (comp.flow[p], comp.occlusion[p], comp.sigma[p])
            self._write_rows(cands, t, [(p, i) for p, i in enumerate(compute_idx)
                                        if cands[i].cacheable], comp)
        right = self._stack_rows(rows, len(cands))
        result = self._select_and_write(img, self._left(slots), right, valid, wslot)
        self._write_features(wslot, f_new, c_new)
        return result

    def _acquire_flows(self, img, cands, t) -> FlowOU:
        """The unfused step's pairwise flows (JAX ``_acquire_flows``): cache
        reads, then one ``forward_batch`` on the ring's images and ``img``
        over every candidate, invalid ones included (they read the template
        slot and are masked in selection), or, when every valid finite pair
        hit, over the valid misses alone; computed cacheable misses are
        written back."""
        N = len(cands)
        cached, all_finite_hit = self._read_cache_hits(cands, t)
        if all_finite_hit:
            compute_idx = [i for i, c in enumerate(cands) if c.valid and i not in cached]
        else:
            compute_idx = list(range(N))
        rows = dict(cached)
        if compute_idx:
            sub = self._index([cands[i].slot for i in compute_idx])
            left = self.mem_imgs.index_select(0, sub)
            right = img.expand(len(compute_idx), *img.shape)
            comp = FlowOU(*self.flower.forward_batch(
                left, right, **self._flow_kwargs(t, compute_idx, batch=True)))
            for p, i in enumerate(compute_idx):
                rows[i] = (comp.flow[p], comp.occlusion[p], comp.sigma[p])
            if self.flow_cache is not None:
                self._write_rows(cands, t, [(p, i) for p, i in enumerate(compute_idx)
                                            if cands[i].valid and cands[i].cacheable
                                            and i not in cached], comp)
            if len(compute_idx) == N:
                return comp
        return self._stack_rows(rows, N)

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
        elif self.flow_cache is not None:
            meta.result = self._track_fused_cached(img, self._candidates(t), t)
        else:
            meta.result = self._fused_step(img, t)
        return meta

    def _fused_step(self, img, t, cands=None, cached=()):
        """The fused frame step over the whole batch; with ``cands``, its
        valid cacheable pairs but those in ``cached`` are written to the
        cache. returns: the frame's result."""
        left, right, valid, (f_new, c_new) = self.pairs(img, t)
        wslot = t % self.ring
        result = self._select_and_write(img, left, right, valid, wslot)
        self._write_features(wslot, f_new, c_new)
        if cands is not None:
            self._write_rows(cands, t, [(i, i) for i, c in enumerate(cands)
                                        if c.valid and c.cacheable and i not in cached],
                             right)
        return result

    def track_chunk(self, imgs):
        """Track ``len(imgs)`` frames (JAX ``track_chunk``): a list of host
        images or a stacked (K, H, W, 3) RGB device tensor. The same results
        as one :meth:`track` call a frame, bit for bit; one meta a frame.

        With a FlowCache attached, the chunk probes the cache
        (``contains``, no reads): if it holds any valid cacheable pair of
        the chunk's frames, every frame goes through :meth:`track` (hits and
        injection need the per-frame reads); else every frame runs the full
        batch with no reads and writes its valid cacheable pairs back, as
        JAX's chunk on a cold cache does. The timer step always goes frame
        by frame.
        """
        if isinstance(imgs, torch.Tensor) and imgs.dim() == 4:
            imgs = list(imgs.unbind(0))
        else:
            imgs = list(imgs)
        if self.timers_enabled or not imgs:
            return [self.track(im) for im in imgs]
        td = self.time_direction
        ts = [self.current_frame_i + (k + 1) * td for k in range(len(imgs))]
        cands_k = [self._candidates(t) for t in ts]
        cache = self.flow_cache
        if cache is not None and any(cache.contains(c.left_id, t)
                                     for ck, t in zip(cands_k, ts)
                                     for c in ck if c.valid and c.cacheable):
            return [self.track(im) for im in imgs]
        metas = []
        for im, t, ck in zip(imgs, ts, cands_k):
            self.current_frame_i = t
            meta = SimpleNamespace()
            meta.result = self._fused_step(self._to_device(im), t,
                                           ck if cache is not None else None)
            metas.append(meta)
        return metas

    def _track_timed(self, img, t):
        """The unfused frame step of ``timers_enabled`` (JAX ``track``'s
        unfused branch): the pairwise flows (cache reads and writes
        included), then chain + select and the ring writes, each phase timed
        to its device completion.
        returns: (result, {'flow+chain': ms, 'selection': ms})."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else None
        cands = self._candidates(t)
        slots, valid, wslot = self._step_indices(cands, t)
        flow_timer = general_time_measurer("flow+chain", device_sync_fn=sync,
                                           start_now=True)
        right = self._acquire_flows(img, cands, t)
        flow_timer.stop()
        sel_timer = general_time_measurer("selection", device_sync_fn=sync,
                                          start_now=True)
        result = self._select_and_write(img, self._left(slots), right, valid, wslot)
        sel_timer.stop()
        return result, {timer.name: 1e3 * timer.report("sum")
                        for timer in (flow_timer, sel_timer)}
