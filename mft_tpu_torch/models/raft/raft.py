"""RAFT-OU flow network: encoders -> correlation pyramid -> GRU loop -> OU heads.

Port of ``mft_tpu/models/raft/raft.py``, every variant of the JAX model
(``RAFTParams``: the big and the small model, the OU modules, normalized
features, relu on the uncertainty), in test mode and in train mode:
- inputs are (B, 3, H, W) float images in [0, 255], H and W divisible by 8;
- ``forward(image1, image2, iters, flow_init, test_mode)`` runs fnet on both
  frames in one batch and cnet on the first, then :meth:`flow_from_features`;
- ``encode`` runs fnet (and cnet) of one frame, so the tracker can keep
  features in a ring and encode each frame once;
- ``flow_from_features`` builds the pyramid, runs ``iters`` refinement
  iterations and, on the LAST one only, the occlusion/uncertainty heads and
  the mask head, then one shared convex upsampling;
- on iterations 1..iters-1 the lookup's only consumer is convc1, so it runs
  fused with it (kernel ``mft_corr_lookup_conv``); the last iteration's
  samples also feed the OU heads and use the plain lookup kernel;
- ``corr_method`` 'alt' or 'win' keeps no volume: only the pooled target
  features, from which every iteration's lookup (kernel ``mft_corr_alt`` or
  ``mft_corr_win``) recomputes its window correlations; convc1 then runs
  unfused on all iterations. These are the methods for frames whose
  all-pairs volume does not fit on the card.
- ``corr_method`` 'int8', 'packed', 'packed_i8', 'pallas_t', 'fold' and
  'mixed' store the volume in another form (int8 with per-(pair, level)
  scales, all levels packed in one map, both, lane-major, folded into rows
  of 128 lanes and built in one launch of the product kernel, or folded only
  in its big levels; ``corr.py``) and run that form's lookup kernel, unfused,
  on every iteration, as the JAX model does. The int8 forms halve the
  volume's bytes and sample in bfloat16 whatever the model dtype (error at
  most max|corr|/254 per value).
- ``conv_backend`` 'pallas' runs the update block's convs on the product
  kernel (``update.conv_apply``); the fused lookup still takes convc1 on
  iterations 1..iters-1 on the 'auto' path, as in JAX.
- ``corr_method`` 'mxu', 'gather' and 'pallas' are the JAX package's other
  formulations of the 'auto' volume lookup (tent-weight matmuls, a 4-tap
  gather, its Pallas kernels): the same function, so they run the 'auto'
  path (K1 + K2).
- ``iters`` given per pair (a tuple) runs :meth:`RAFT._flow_scheduled`:
  each pair its own number of iterations, the active pairs a batch prefix.
- ``small`` builds the small RAFT (bottleneck encoders, fnet 128 channels,
  cnet 96 + 64, ``SmallUpdateBlock``, lookup radius 3 whatever
  ``corr_radius``): it never fuses the lookup with convc1 (JAX
  ``_fused_lookup_on``), so every iteration runs the method's lookup, and
  it upsamples bilinearly (``upflow8``, ``upsample8``), having no mask head.
- ``occlusion_module`` None builds no OU block; one without
  'with_uncertainty' drops the uncertainty output; 'morelayers' picks the
  four-conv heads, 'upsample8' scales the upsampled uncertainty by 8; the
  outputs hold the 'occlusion' and 'uncertainty' keys of the heads the
  module has, as JAX's do. With no OU block the last test-mode iteration
  fuses the lookup too (its only consumer is convc1).
- ``normalized_features`` divides both frames' features by their norm
  (``corr.normalize_features``) before any volume or feature pyramid.
- ``relu_uncertainty`` applies relu to the upsampled uncertainty.

``test_mode=False`` runs :meth:`RAFT._flow_sequence` (JAX ``flow_from_features``
with ``test_mode=False``): lists, one entry per iteration, of the upsampled
flow, occlusion logits and uncertainty, the OU heads on every iteration
unless ``ou_last_iter_only``; the gradient stops at ``coords1`` before every
iteration's lookup and at the OU block's inputs ``net``, ``corr``, the flow
and ``delta_flow`` (not ``inp`` nor the motion features), as JAX's
``stop_gradient``s; the lookup is never fused with convc1 there.
``RAFT(cfg, train_mode=True)`` (JAX ``train_mode``) normalises cnet with the
batch's statistics and updates the running ones, applies the encoders'
dropout, builds the update block with ``conv_backend`` 'auto' (the product
kernel has no backward) and looks up every ``corr_method`` on the 'auto'
volume, whose lookup has a backward (``ops.corr_lookup_bwd``); the other
methods' kernels have none, as in JAX. :meth:`RAFT.cast_per_call` runs the
convs in bf16 over float32 master weights (``--mixed_precision``); the norms
and the coordinate arithmetic stay float32.
"""

import dataclasses

import torch
from torch import nn

from mft_tpu_torch.models.raft.corr import (build_corr_pyramid, build_corr_pyramid_folded,
                                            build_corr_pyramid_i8, build_corr_pyramid_mixed,
                                            build_corr_pyramid_t, build_feature_pyramid,
                                            corr_lookup, corr_lookup_features,
                                            corr_lookup_fused_conv, normalize_features,
                                            pack_corr_pyramid, pack_corr_pyramid_i8)
from mft_tpu_torch.models.raft.layers import BasicEncoder, BatchNorm, Conv2d, SmallEncoder
from mft_tpu_torch.models.raft.update import (BasicUpdateBlock,
                                              OcclusionAndUncertaintyBlock,
                                              SmallUpdateBlock)
from mft_tpu_torch.models.raft.upsample import convex_upsample_multi, upflow8, upsample8

# corr_method: 'auto' is the all-pairs volume; 'alt' and 'win' recompute the
# windows from the features; the volume methods store it in another form.
# The aliases are the JAX package's other lookups of the 'auto' volume (the
# same function) and run the 'auto' path.
FEATURE_METHODS = ("alt", "win")
VOLUME_METHODS = ("int8", "packed", "packed_i8", "pallas_t", "fold", "mixed")
AUTO_ALIASES = ("mxu", "gather", "pallas")
CORR_METHODS = ("auto", *FEATURE_METHODS, *VOLUME_METHODS, *AUTO_ALIASES)
# the methods whose stored volume slices to a batch prefix (JAX
# ``_flow_scheduled``); the others raise under an iteration schedule
SCHEDULE_METHODS = ("auto", *AUTO_ALIASES, "mixed", "packed", "packed_i8")


@dataclasses.dataclass(frozen=True)
class RAFTParams:
    """Static model configuration (the JAX ``RAFTParams``; its TPU-only
    knobs ``corr_tile`` and ``fuse_lookup`` are read and checked by
    ``wrapper.raft_params_from_config``)."""
    small: bool = False
    # None: no OU heads; a name with 'with_uncertainty' adds the uncertainty
    # output, 'morelayers' the four-conv heads, 'upsample8' scales the
    # upsampled uncertainty by 8
    occlusion_module: str | None = "separate_with_uncertainty"
    corr_levels: int = 4
    corr_radius: int = 4            # the small model looks up at radius 3
    normalized_features: bool = False
    compute_dtype: str = "float32"  # 'bfloat16' | 'float32' | 'auto' (bf16 on CUDA)
    corr_method: str = "auto"       # one of CORR_METHODS
    conv_backend: str = "auto"      # 'pallas': update-block convs on the product kernel
    relu_uncertainty: bool = False  # relu on the upsampled uncertainty
    ou_last_iter_only: bool = False  # test_mode=False: OU heads on the last iteration only
    dropout: float = 0.0            # the encoders' dropout in train mode

    def __post_init__(self):
        if self.corr_method not in CORR_METHODS:
            raise ValueError(f"unknown corr_method {self.corr_method!r}")
        if self.conv_backend not in ("auto", "pallas"):
            raise ValueError(f"unknown conv_backend {self.conv_backend!r}")

    @property
    def occlusion_estimation(self) -> bool:
        return self.occlusion_module is not None

    @property
    def uncertainty_estimation(self) -> bool:
        return self.occlusion_estimation and "with_uncertainty" in self.occlusion_module

    @property
    def uncertainty_upsample_mult(self) -> float:
        return 8.0 if self.occlusion_module and "upsample8" in self.occlusion_module else 1.0

    @property
    def ou_architecture(self) -> str:
        return ("morelayers" if self.occlusion_module and "morelayers" in self.occlusion_module
                else "simple")

    @property
    def effective_corr_radius(self) -> int:
        # the reference forces radius 3 for the small model (raft.py:37-40)
        return 3 if self.small else self.corr_radius

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    def dtype(self, device) -> torch.dtype:
        if self.compute_dtype == "auto":
            return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]


class RAFT(nn.Module):
    """RAFT, big or small, with the OU heads of ``occlusion_module``."""

    def __init__(self, cfg: RAFTParams = RAFTParams(), train_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_mode = train_mode
        self._compute_dtype = None
        dropout = cfg.dropout if train_mode else 0.0
        corr_channels = cfg.corr_levels * (2 * cfg.effective_corr_radius + 1) ** 2
        if cfg.small:
            self.fnet = SmallEncoder(output_dim=128, norm_fn="instance", dropout=dropout)
            self.cnet = SmallEncoder(output_dim=cfg.hidden_dim + cfg.context_dim,
                                     norm_fn="none", dropout=dropout)
            self.update_block = SmallUpdateBlock(cfg.hidden_dim, corr_channels)
            motion = 82
        else:
            self.fnet = BasicEncoder(output_dim=256, norm_fn="instance", dropout=dropout)
            self.cnet = BasicEncoder(output_dim=cfg.hidden_dim + cfg.context_dim,
                                     norm_fn="batch", dropout=dropout)
            for m in self.cnet.modules():
                if isinstance(m, BatchNorm):
                    m.use_batch_stats = train_mode
            # the product kernel has no backward: train on cuDNN, as JAX swaps
            # conv_pallas for its differentiable lowering in train mode
            backend = "auto" if train_mode else cfg.conv_backend
            self.update_block = BasicUpdateBlock(cfg.hidden_dim, corr_channels, backend)
            motion = 128
        if cfg.occlusion_estimation:
            # [net, inp, corr, flow, delta_flow, motion features]: 712 channels
            # in the big model, 442 in the small one
            self.occlusion_block = OcclusionAndUncertaintyBlock(
                cfg.hidden_dim + cfg.context_dim + corr_channels + 2 + 2 + motion,
                architecture=cfg.ou_architecture)

    @property
    def dtype(self) -> torch.dtype:
        return self._compute_dtype or self.fnet.conv1.weight.dtype

    def cast_per_call(self, dtype: torch.dtype):
        """Convs compute in ``dtype`` over the weights as they are (float32
        master weights under mixed precision), casting at every call."""
        self._compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = dtype
        return self

    def set_compute_dtype(self, dtype: torch.dtype):
        """Convs compute in ``dtype``; norm parameters and the biases of the
        update block's routed convs (``BasicUpdateBlock.routed_convs``) stay
        float32."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
        for m in self.update_block.routed_convs():
            m.bias.data = m.bias.data.float()
        return self

    def encode(self, image, with_context: bool = True):
        """(B, 3, H, W) images in [0, 255] -> (fmap, cnet or None), stride 8."""
        image = (2.0 * (image.float() / 255.0) - 1.0).to(self.dtype)
        fmap = self.fnet(image)
        cnet = self.cnet(image) if with_context else None
        return fmap, cnet

    def forward(self, image1, image2, iters=12, flow_init=None, test_mode: bool = True,
                plain: bool = False):
        """(B, 3, H, W) images in [0, 255] -> :meth:`flow_from_features`'s
        outputs. fnet runs on both frames as one batch, cnet on the first."""
        B = image1.shape[0]
        norm = lambda im: (2.0 * (im.float() / 255.0) - 1.0).to(self.dtype)
        fmaps = self.fnet(torch.cat([norm(image1), norm(image2)], dim=0))
        cnet = self.cnet(norm(image1))
        return self.flow_from_features(fmaps[:B], fmaps[B:], cnet, iters, flow_init,
                                       plain, test_mode)

    def flow_from_features(self, fmap1, fmap2, cnet, iters=12,
                           flow_init=None, plain: bool = False, test_mode: bool = True):
        """Everything after the encoders.

        args: fmap1/fmap2 (B, 256, H8, W8) fnet features (128 channels in
          the small model), cnet (B, hidden + context, H8, W8) context
          features of frame 1, iters an int or one count per pair
          (:meth:`_flow_scheduled`), flow_init optional (B, H8, W8, 2)
          low-resolution initial flow; ``plain`` runs the kernels' plain
          PyTorch versions instead of the kernels.
        returns: {'flow': (B, H, W, 2), 'occlusion': (B, H, W, 2) logits,
          'uncertainty': (B, H, W, 1) log-variance, 'coords': (B, H8, W8, 2)},
          'occlusion' and 'uncertainty' only where ``occlusion_module`` has
          those heads; with ``test_mode`` False (:meth:`_flow_sequence`) the
          head outputs are lists, one entry per iteration.
        """
        if not test_mode:
            if isinstance(iters, (tuple, list)):
                raise ValueError("iteration schedules are an inference-only mode")
            return self._flow_sequence(fmap1, fmap2, cnet, iters, flow_init, plain)
        if isinstance(iters, (tuple, list)):
            return self._flow_scheduled(fmap1, fmap2, cnet, tuple(iters), flow_init, plain)
        cfg = self.cfg
        B, _, H8, W8 = fmap1.shape
        radius, method = cfg.effective_corr_radius, cfg.corr_method
        fmap1, fmap2 = self._corr_features(fmap1, fmap2)
        features = method in FEATURE_METHODS
        if features:
            f1 = fmap1.permute(0, 2, 3, 1).contiguous()     # (B, H8, W8, C)
            f2_pyramid = build_feature_pyramid(fmap2, cfg.corr_levels)
        else:
            pyramid = self.stored_volume(fmap1, fmap2, plain)
        # the lookup fuses with convc1 on the 'auto' volume where convc1 is
        # its only consumer: not on the last iteration when OU heads follow
        fuse = not (features or cfg.small or method in VOLUME_METHODS)
        net, inp = self._context(cnet)
        coords0, coords1 = _initial_coords(fmap1, flow_init)

        to_nchw = lambda t: _to_nchw(t, H8, W8)
        for itr in range(iters):
            last = itr == iters - 1
            if features:
                corr = to_nchw(corr_lookup_features(method, f1, f2_pyramid,
                                                    coords1, radius, plain))
            elif not fuse or (last and cfg.occlusion_estimation):
                corr = to_nchw(corr_lookup(pyramid, coords1, radius, plain))
            else:
                corr = lambda w, b, _c=coords1: to_nchw(corr_lookup_fused_conv(
                    pyramid, _c, w, b, radius, plain))
            flow = to_nchw(coords1 - coords0)
            net, up_mask, delta_flow, motion = self.update_block(
                net, inp, corr, flow, need_mask=last, plain=plain)
            delta_flow = delta_flow.float()
            coords1 = coords1 + delta_flow.permute(0, 2, 3, 1).reshape(coords1.shape)

        return self._heads(net, inp, corr, coords1 - coords0, delta_flow, motion, up_mask,
                           H8, W8)

    def _flow_sequence(self, fmap1, fmap2, cnet, iters: int, flow_init=None,
                       plain: bool = False):
        """Train-mode forward (JAX ``flow_from_features(test_mode=False)``):
        every iteration's upsampled flow and, unless ``ou_last_iter_only``,
        its OU heads' outputs, with JAX's gradient stops."""
        cfg = self.cfg
        B, _, H8, W8 = fmap1.shape
        radius = cfg.effective_corr_radius
        fmap1, fmap2 = self._corr_features(fmap1, fmap2)
        # the methods whose lookups have no backward train on the 'auto' volume
        method = "auto" if self.train_mode else cfg.corr_method
        if method in FEATURE_METHODS:
            f1 = fmap1.permute(0, 2, 3, 1).contiguous()
            f2_pyramid = build_feature_pyramid(fmap2, cfg.corr_levels)
            lookup = lambda c: corr_lookup_features(method, f1, f2_pyramid, c, radius, plain)
        else:
            pyramid = self.stored_volume(fmap1, fmap2, plain, method)
            lookup = lambda c: corr_lookup(pyramid, c, radius, plain)
        net, inp = self._context(cnet)
        coords0, coords1 = _initial_coords(fmap1, flow_init)
        to_nchw = lambda t: _to_nchw(t, H8, W8)
        preds = {"flow": [], "occlusion": [], "uncertainty": []}
        for itr in range(iters):
            coords1 = coords1.detach()
            corr = to_nchw(lookup(coords1))
            net, up_mask, delta_flow, motion = self.update_block(
                net, inp, corr, to_nchw(coords1 - coords0), need_mask=True, plain=plain)
            delta_flow = delta_flow.float()
            coords1 = coords1 + delta_flow.permute(0, 2, 3, 1).reshape(coords1.shape)
            heads = not cfg.ou_last_iter_only or itr == iters - 1
            outs = self._heads(net, inp, corr, coords1 - coords0, delta_flow, motion,
                               up_mask, H8, W8, ou=heads, detach=True)
            for key in preds:
                if key in outs:
                    preds[key].append(outs[key])
        out = {key: v for key, v in preds.items() if key == "flow" or key in self._head_keys()}
        out["coords"] = (coords1 - coords0).reshape(B, H8, W8, 2)
        return out

    def _corr_features(self, fmap1, fmap2):
        """The features the volume or the feature pyramid is built from:
        normalized under ``normalized_features``."""
        if self.cfg.normalized_features:
            return normalize_features(fmap1), normalize_features(fmap2)
        return fmap1, fmap2

    def _context(self, cnet):
        """(net, inp): tanh of cnet's hidden channels, relu of the rest."""
        hd = self.cfg.hidden_dim
        return torch.tanh(cnet[:, :hd]), torch.relu(cnet[:, hd:])

    def _head_keys(self):
        """The output keys of the OU heads ``occlusion_module`` has."""
        keys = ("occlusion",) if self.cfg.occlusion_estimation else ()
        return keys + (("uncertainty",) if self.cfg.uncertainty_estimation else ())

    def stored_volume(self, fmap1, fmap2, plain: bool = False, method=None):
        """The stored volume of a volume method (the configured one by
        default): the list of :func:`build_corr_pyramid` for 'auto' and its
        aliases, else a tagged tuple."""
        method = method or self.cfg.corr_method
        levels = self.cfg.corr_levels
        if method == "int8":
            return ("i8", *build_corr_pyramid_i8(fmap1, fmap2, levels))
        if method == "pallas_t":
            return ("t", build_corr_pyramid_t(fmap1, fmap2, levels))
        if method == "fold":
            return ("fold", *build_corr_pyramid_folded(fmap1, fmap2, levels, plain))
        if method == "mixed":
            return build_corr_pyramid_mixed(fmap1, fmap2, levels)
        pyramid = build_corr_pyramid(fmap1, fmap2, levels)
        if method == "packed_i8":
            return ("packed_i8", *pack_corr_pyramid_i8(pyramid))
        if method == "packed":
            return ("packed", *pack_corr_pyramid(pyramid))
        return pyramid

    def _heads(self, net, inp, corr, flow_lo, delta_flow, motion, up_mask, H8, W8,
               ou: bool = True, detach: bool = False):
        """OU heads (where ``ou`` and the model has them) and the 8x
        upsampling of the flow and their outputs: one shared convex
        upsampling, or bilinear where there is no mask (the small model).
        flow_lo (B, P, 2) float32 low-resolution flow; the others NCHW;
        ``detach`` stops the gradient at the heads' inputs as JAX's train
        mode does (``net``, ``corr``, the flow and ``delta_flow``).
        returns: {'flow': (B, H, W, 2), 'occlusion': (B, H, W, 2) logits,
          'uncertainty': (B, H, W, 1), 'coords': (B, H8, W8, 2)}, the head
          keys only for the heads run."""
        cfg = self.cfg
        flow_nchw = _to_nchw(flow_lo, H8, W8)
        fields, coefs = [flow_nchw], [8.0]
        keys = self._head_keys() if ou else ()
        if keys:
            stop = (lambda t: t.detach()) if detach else (lambda t: t)
            occlusion, uncertainty = self.occlusion_block(
                stop(net), inp, stop(corr), stop(flow_nchw), stop(delta_flow), motion)
            fields.append(occlusion.float())
            coefs.append(1.0)
            if "uncertainty" in keys:
                fields.append(uncertainty.float())
                coefs.append(cfg.uncertainty_upsample_mult)
        if up_mask is None:   # small model: plain x8 bilinear
            ups = [upflow8(fields[0])] + [upsample8(f * c) for f, c in zip(fields[1:], coefs[1:])]
        else:
            ups = convex_upsample_multi(fields, up_mask.float(), coefs)
        out = dict(zip(("flow", *keys), ups))
        if "uncertainty" in out and cfg.relu_uncertainty:
            out["uncertainty"] = torch.relu(out["uncertainty"])
        out["coords"] = flow_lo.reshape(-1, H8, W8, 2)
        return out

    def _flow_scheduled(self, fmap1, fmap2, cnet, iters_schedule, flow_init=None,
                        plain: bool = False):
        """Per-pair iteration schedule (JAX ``RAFT._flow_scheduled``).

        Pair b runs exactly ``iters_schedule[b]`` iterations, its math that
        of :meth:`flow_from_features` with that many: the pairs are sorted
        by descending count (stably), so the active pairs are a batch
        prefix and each iteration computes that prefix on the stored volume
        sliced to it; the pairs whose count ends at an iteration get the OU
        heads, the mask head (on their rows only) and the convex upsampling
        there, and the outputs go back to the pairs' order. An iteration
        after which no pair ends runs the lookup fused with convc1 (K1) on
        the 'auto' volume; the others, and every iteration of 'mixed',
        'packed' and 'packed_i8', the method's lookup.
        """
        cfg = self.cfg
        if cfg.corr_method not in SCHEDULE_METHODS:
            raise NotImplementedError(
                "iters schedule requires a sliceable materialized pyramid; "
                f"corr_method={cfg.corr_method!r} is not supported")
        B, _, H8, W8 = fmap1.shape
        if len(iters_schedule) != B:
            raise ValueError(f"schedule len {len(iters_schedule)} != B={B}")
        sched = [int(i) for i in iters_schedule]
        if min(sched) < 1:
            raise ValueError(f"schedule entries must be >= 1: {sched}")
        order = sorted(range(B), key=lambda b: -sched[b])   # descending, stable
        counts = [sum(1 for s in sched if s > k) for k in range(max(sched))]
        if order != list(range(B)):
            # by slices: an index tensor would be a host-to-device copy, which
            # waits for the card's queue
            permute = lambda t: None if t is None else torch.cat([t[b:b + 1] for b in order])
            fmap1, fmap2, cnet, flow_init = map(permute, (fmap1, fmap2, cnet, flow_init))
        pyramid = self.stored_volume(*self._corr_features(fmap1, fmap2), plain)
        net, inp = self._context(cnet)
        coords0, coords1 = _initial_coords(fmap1, flow_init)
        # K1 on the 'auto' volume of the big model
        radius = cfg.effective_corr_radius
        fuse = not (cfg.small or isinstance(pyramid, tuple))

        to_nchw = lambda t: _to_nchw(t, H8, W8)
        outs = [None] * B   # in the pairs' own order
        m = B
        for itr, count in enumerate(counts):
            if count < m:
                m = count
                pyramid = slice_pyramid(pyramid, m)
                net, inp, coords0, coords1 = net[:m], inp[:m], coords0[:m], coords1[:m]
            m_next = counts[itr + 1] if itr + 1 < len(counts) else 0
            if fuse and m_next == m:
                corr = lambda w, b, _c=coords1, _p=pyramid: to_nchw(corr_lookup_fused_conv(
                    _p, _c, w, b, radius, plain))
            else:
                corr = to_nchw(corr_lookup(pyramid, coords1, radius, plain))
            net, up_mask, delta_flow, motion = self.update_block(
                net, inp, corr, to_nchw(coords1 - coords0), need_mask=m_next < m,
                plain=plain, mask_rows=(m_next, m))
            delta_flow = delta_flow.float()
            coords1 = coords1 + delta_flow.permute(0, 2, 3, 1).reshape(coords1.shape)
            if m_next == m:
                continue
            # pairs m_next..m-1 end after this iteration
            sl = slice(m_next, m)
            ends = self._heads(net[sl], inp[sl], corr[sl], (coords1 - coords0)[sl],
                               delta_flow[sl], motion[sl], up_mask, H8, W8)
            for j, row in enumerate(range(m_next, m)):
                outs[order[row]] = {k: t[j] for k, t in ends.items()}
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _to_nchw(t, H8: int, W8: int):
    """(B, P, C) pixel rows -> an NCHW view (B, C, H8, W8)."""
    return t.reshape(t.shape[0], H8, W8, -1).permute(0, 3, 1, 2)


def _initial_coords(fmap1, flow_init=None):
    """coords0, the (B, P, 2) float32 pixel grid at stride 8 (x, y), and
    coords1 = coords0 + flow_init (contiguous)."""
    B, _, H8, W8 = fmap1.shape
    P = H8 * W8
    ys, xs = torch.meshgrid(
        torch.arange(H8, device=fmap1.device, dtype=torch.float32),
        torch.arange(W8, device=fmap1.device, dtype=torch.float32),
        indexing="ij")
    coords0 = torch.stack([xs, ys], dim=-1).reshape(1, P, 2).expand(B, P, 2)
    coords1 = coords0.contiguous()
    if flow_init is not None:
        coords1 = coords1 + flow_init.float().reshape(B, P, 2)
    return coords0, coords1


def slice_pyramid(pyramid, m: int):
    """The stored volume of the first ``m`` pairs: batch-leading views,
    contiguous, with the per-pair scales of 'packed_i8'."""
    if not isinstance(pyramid, tuple):
        return [lvl[:m] for lvl in pyramid]
    tag = pyramid[0]
    if tag == "mixed":
        _, folded, fdims, padded = pyramid
        return ("mixed", [a[:m] for a in folded], fdims, [a[:m] for a in padded])
    if tag == "packed":
        return ("packed", pyramid[1][:m], pyramid[2])
    if tag == "packed_i8":
        return ("packed_i8", pyramid[1][:m], pyramid[2][:m], pyramid[3])
    raise ValueError(f"a {tag!r} volume is not sliced by pairs")
