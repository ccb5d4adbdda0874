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
Scheduled per-pair iterations and training mode are not ported.
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
# The JAX package's other methods, with the item of ROADMAP.md that ports
# them; the port never maps one onto another method.
FEATURE_METHODS = ("alt", "win")
VOLUME_METHODS = ("int8", "packed", "packed_i8", "pallas_t", "fold", "mixed")
CORR_METHODS = ("auto", *FEATURE_METHODS, *VOLUME_METHODS)
UNPORTED_CORR_METHODS = {
    "mxu": "A3 (other formulations of the volume lookup)",
    "gather": "A3 (other formulations of the volume lookup)",
    "pallas": "A3 (other formulations of the volume lookup)",
}


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
        if self.corr_method in UNPORTED_CORR_METHODS:
            raise NotImplementedError(
                f"corr_method={self.corr_method!r} is not ported yet (ROADMAP "
                f"{UNPORTED_CORR_METHODS[self.corr_method]}); ported: {CORR_METHODS}")
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

    def flow_from_features(self, fmap1, fmap2, cnet, iters: int = 12,
                           flow_init=None, plain: bool = False):
        """Everything after the encoders.

        args: fmap1/fmap2 (B, 256, H8, W8) fnet features, cnet
          (B, 256, H8, W8) context features of frame 1, flow_init optional
          (B, H8, W8, 2) low-resolution initial flow; ``plain`` runs the
          kernels' plain PyTorch versions instead of the kernels.
        returns: {'flow': (B, H, W, 2), 'occlusion': (B, H, W, 2) logits,
          'uncertainty': (B, H, W, 1) log-variance, 'coords': (B, H8, W8, 2)}.
        """
        cfg = self.cfg
        B, _, H8, W8 = fmap1.shape
        P = H8 * W8
        radius = cfg.corr_radius
        method, levels = cfg.corr_method, cfg.corr_levels
        features = method in FEATURE_METHODS
        if features:
            f1 = fmap1.permute(0, 2, 3, 1).contiguous()     # (B, H8, W8, C)
            f2_pyramid = build_feature_pyramid(fmap2, levels)
        elif method == "int8":
            pyramid = ("i8", *build_corr_pyramid_i8(fmap1, fmap2, levels))
        elif method == "packed_i8":
            pyramid = ("packed_i8", *pack_corr_pyramid_i8(
                build_corr_pyramid(fmap1, fmap2, levels)))
        elif method == "packed":
            pyramid = ("packed", *pack_corr_pyramid(
                build_corr_pyramid(fmap1, fmap2, levels)))
        elif method == "pallas_t":
            pyramid = ("t", build_corr_pyramid_t(fmap1, fmap2, levels))
        elif method == "fold":
            pyramid = ("fold", *build_corr_pyramid_folded(fmap1, fmap2, levels, plain))
        elif method == "mixed":
            pyramid = build_corr_pyramid_mixed(fmap1, fmap2, levels)
        else:
            pyramid = build_corr_pyramid(fmap1, fmap2, levels)
        net = torch.tanh(cnet[:, :HIDDEN_DIM])
        inp = torch.relu(cnet[:, HIDDEN_DIM:])

        ys, xs = torch.meshgrid(
            torch.arange(H8, device=fmap1.device, dtype=torch.float32),
            torch.arange(W8, device=fmap1.device, dtype=torch.float32),
            indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1).reshape(1, P, 2).expand(B, P, 2)
        coords1 = coords0.contiguous()
        if flow_init is not None:
            coords1 = coords1 + flow_init.float().reshape(B, P, 2)

        to_nchw = lambda t: t.reshape(B, H8, W8, -1).permute(0, 3, 1, 2)
        for itr in range(iters):
            last = itr == iters - 1
            if features:
                corr = to_nchw(corr_lookup_features(method, f1, f2_pyramid,
                                                    coords1, radius, plain))
            elif last or method in VOLUME_METHODS:
                samples = corr_lookup(pyramid, coords1, radius, plain)
                corr = to_nchw(samples)
            else:
                corr = lambda w, b, _c=coords1: to_nchw(corr_lookup_fused_conv(
                    pyramid, _c, w, b, radius, plain))
            flow = to_nchw(coords1 - coords0)
            net, up_mask, delta_flow, motion = self.update_block(
                net, inp, corr, flow, need_mask=last, plain=plain)
            delta_flow = delta_flow.float()
            coords1 = coords1 + delta_flow.permute(0, 2, 3, 1).reshape(B, P, 2)

        flow_lo = to_nchw(coords1 - coords0)
        occlusion, uncertainty = self.occlusion_block(
            net, inp, corr, flow_lo, delta_flow, motion)
        flow_up, occl_up, unc_up = convex_upsample_multi(
            [flow_lo, occlusion.float(), uncertainty.float()], up_mask.float(),
            [8.0, 1.0, 1.0])
        return {"flow": flow_up, "occlusion": occl_up, "uncertainty": unc_up,
                "coords": (coords1 - coords0).reshape(B, H8, W8, 2)}
