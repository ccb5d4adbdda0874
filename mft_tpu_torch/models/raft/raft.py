"""RAFT-OU flow network: encoders -> correlation pyramid -> GRU loop -> OU heads.

Port of ``mft_tpu/models/raft/raft.py`` in test mode, big model only:
- inputs are (B, 3, H, W) float images in [0, 255], H and W divisible by 8;
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
Training mode is not ported.
"""

import dataclasses

import torch
from torch import nn

from mft_tpu_torch.models.raft.corr import (build_corr_pyramid, build_corr_pyramid_folded,
                                            build_corr_pyramid_i8, build_corr_pyramid_mixed,
                                            build_corr_pyramid_t, build_feature_pyramid,
                                            corr_lookup, corr_lookup_features,
                                            corr_lookup_fused_conv, pack_corr_pyramid,
                                            pack_corr_pyramid_i8)
from mft_tpu_torch.models.raft.layers import BasicEncoder
from mft_tpu_torch.models.raft.update import (BasicUpdateBlock,
                                              OcclusionAndUncertaintyBlock)
from mft_tpu_torch.models.raft.upsample import convex_upsample_multi


HIDDEN_DIM = CONTEXT_DIM = 128   # big model
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
    """Static model configuration (the ported subset of the JAX RAFTParams:
    big model, 'separate_with_uncertainty' heads)."""
    corr_levels: int = 4
    corr_radius: int = 4
    compute_dtype: str = "float32"  # 'bfloat16' | 'float32' | 'auto' (bf16 on CUDA)
    corr_method: str = "auto"       # one of CORR_METHODS
    conv_backend: str = "auto"      # 'pallas': update-block convs on the product kernel

    def __post_init__(self):
        if self.corr_method not in CORR_METHODS:
            raise ValueError(f"unknown corr_method {self.corr_method!r}")
        if self.conv_backend not in ("auto", "pallas"):
            raise ValueError(f"unknown conv_backend {self.conv_backend!r}")

    def dtype(self, device) -> torch.dtype:
        if self.compute_dtype == "auto":
            return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]


class RAFT(nn.Module):
    """RAFT with separate occlusion + uncertainty heads (inference)."""

    def __init__(self, cfg: RAFTParams = RAFTParams()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=HIDDEN_DIM + CONTEXT_DIM,
                                 norm_fn="batch")
        corr_channels = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.update_block = BasicUpdateBlock(HIDDEN_DIM, corr_channels,
                                             cfg.conv_backend)
        # [net, inp, corr, flow, delta_flow, motion features] = 712 channels
        self.occlusion_block = OcclusionAndUncertaintyBlock(
            HIDDEN_DIM + CONTEXT_DIM + corr_channels + 2 + 2 + 128)

    @property
    def dtype(self) -> torch.dtype:
        return self.fnet.conv1.weight.dtype

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

    def flow_from_features(self, fmap1, fmap2, cnet, iters=12,
                           flow_init=None, plain: bool = False):
        """Everything after the encoders.

        args: fmap1/fmap2 (B, 256, H8, W8) fnet features, cnet
          (B, 256, H8, W8) context features of frame 1, iters an int or one
          count per pair (:meth:`_flow_scheduled`), flow_init optional
          (B, H8, W8, 2) low-resolution initial flow; ``plain`` runs the
          kernels' plain PyTorch versions instead of the kernels.
        returns: {'flow': (B, H, W, 2), 'occlusion': (B, H, W, 2) logits,
          'uncertainty': (B, H, W, 1) log-variance, 'coords': (B, H8, W8, 2)}.
        """
        if isinstance(iters, (tuple, list)):
            return self._flow_scheduled(fmap1, fmap2, cnet, tuple(iters), flow_init, plain)
        cfg = self.cfg
        B, _, H8, W8 = fmap1.shape
        radius, method = cfg.corr_radius, cfg.corr_method
        features = method in FEATURE_METHODS
        if features:
            f1 = fmap1.permute(0, 2, 3, 1).contiguous()     # (B, H8, W8, C)
            f2_pyramid = build_feature_pyramid(fmap2, cfg.corr_levels)
        else:
            pyramid = self.stored_volume(fmap1, fmap2, plain)
        net = torch.tanh(cnet[:, :HIDDEN_DIM])
        inp = torch.relu(cnet[:, HIDDEN_DIM:])
        coords0, coords1 = _initial_coords(fmap1, flow_init)

        to_nchw = lambda t: _to_nchw(t, H8, W8)
        for itr in range(iters):
            last = itr == iters - 1
            if features:
                corr = to_nchw(corr_lookup_features(method, f1, f2_pyramid,
                                                    coords1, radius, plain))
            elif last or method in VOLUME_METHODS:
                corr = to_nchw(corr_lookup(pyramid, coords1, radius, plain))
            else:
                corr = lambda w, b, _c=coords1: to_nchw(corr_lookup_fused_conv(
                    pyramid, _c, w, b, radius, plain))
            flow = to_nchw(coords1 - coords0)
            net, up_mask, delta_flow, motion = self.update_block(
                net, inp, corr, flow, need_mask=last, plain=plain)
            delta_flow = delta_flow.float()
            coords1 = coords1 + delta_flow.permute(0, 2, 3, 1).reshape(coords1.shape)

        flow_up, occl_up, unc_up, low = self._heads(net, inp, corr, coords1 - coords0,
                                                    delta_flow, motion, up_mask, H8, W8)
        return {"flow": flow_up, "occlusion": occl_up, "uncertainty": unc_up,
                "coords": low}

    def stored_volume(self, fmap1, fmap2, plain: bool = False):
        """The stored volume of the configured volume method: the list of
        :func:`build_corr_pyramid` for 'auto' and its aliases, else a tagged
        tuple."""
        method, levels = self.cfg.corr_method, self.cfg.corr_levels
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

    def _heads(self, net, inp, corr, flow_lo, delta_flow, motion, up_mask, H8, W8):
        """OU heads and one shared convex upsampling of the pairs that end
        here. flow_lo (B, P, 2) float32 low-resolution flow; the others NCHW.
        returns: flow (B, H, W, 2), occlusion logits (B, H, W, 2),
          uncertainty (B, H, W, 1), low-resolution flow (B, H8, W8, 2)."""
        flow_nchw = _to_nchw(flow_lo, H8, W8)
        occlusion, uncertainty = self.occlusion_block(
            net, inp, corr, flow_nchw, delta_flow, motion)
        flow_up, occl_up, unc_up = convex_upsample_multi(
            [flow_nchw, occlusion.float(), uncertainty.float()], up_mask.float(),
            [8.0, 1.0, 1.0])
        return flow_up, occl_up, unc_up, flow_lo.reshape(-1, H8, W8, 2)

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
        pyramid = self.stored_volume(fmap1, fmap2, plain)
        net = torch.tanh(cnet[:, :HIDDEN_DIM])
        inp = torch.relu(cnet[:, HIDDEN_DIM:])
        coords0, coords1 = _initial_coords(fmap1, flow_init)
        radius, fuse = cfg.corr_radius, not isinstance(pyramid, tuple)   # the 'auto' volume

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
                outs[order[row]] = [t[j] for t in ends]
        flow_up, occl_up, unc_up, low = (torch.stack(t) for t in zip(*outs))
        return {"flow": flow_up, "occlusion": occl_up, "uncertainty": unc_up,
                "coords": low}


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
