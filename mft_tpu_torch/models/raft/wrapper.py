"""RAFTFlow: the flow/occlusion/sigma service the MFT tracker uses.

Port of ``mft_tpu/models/raft/wrapper.py``: owns the weights, pads inputs to
a multiple of 8 (replicate padding, reference InputPadder), runs RAFT and
turns the raw head outputs into occlusion = softmax(logits)[..., 1] and
sigma = sqrt(exp(log-variance)).

Weights: ``config.model`` naming an existing file is loaded by its suffix
(:func:`load_weights`): a flax ``.msgpack``/``.bin`` variables file, as
the JAX package writes them (``weights/raftou_synth.msgpack``), or a
``.pt``/``.pth`` state dict, the reference's (renamed by
:mod:`mft_tpu_torch.models.raft.convert`) or this port's. A missing file means random
weights, made from ``config.init_seed`` (default 0) with a
``torch.Generator`` in the JAX package's init distributions (lecun-normal
convs, zero biases, identity batch norm). JAX weights in memory come across
through :func:`mft_tpu_torch.models.raft.convert.params_from_flax` and
:meth:`RAFTFlow.load_state_dict`.
"""

import logging
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mft_tpu_torch.config import cfg_value
from mft_tpu_torch.core.coords import grid_coords
from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.models.raft.convert import (is_reference_state_dict, params_from_flax,
                                               params_from_reference)
from mft_tpu_torch.models.raft.encoder_fuse import fused_basic_encode
from mft_tpu_torch.models.raft.flax_msgpack import read_variables
from mft_tpu_torch.models.raft.raft import RAFT, RAFTParams
from mft_tpu_torch.models.raft.upsample import downsample_flow8

logger = logging.getLogger(__name__)


def pad_to_8(H: int, W: int):
    """Sintel-mode padding amounts: ((top, bottom), (left, right))."""
    pad_ht = (((H // 8) + 1) * 8 - H) % 8
    pad_wd = (((W // 8) + 1) * 8 - W) % 8
    return ((pad_ht // 2, pad_ht - pad_ht // 2),
            (pad_wd // 2, pad_wd - pad_wd // 2))


# conv_backend values of the JAX package that lower the same convolutions
# differently; the port runs each of them as its PyTorch convolution, and
# 'pallas' on its product kernel (update.conv_apply)
SAME_CONV_BACKENDS = ("auto", "conv", "matmul", "im2col", "hybrid")
CONV_BACKENDS = (*SAME_CONV_BACKENDS, "pallas")


def check_corr_tile(v) -> int:
    """A corr_tile override: 0 (auto) or a power of two >= 8, else ValueError,
    as the JAX package's wrapper checks it. The tile sizes the TPU lookups'
    pixel blocks; the port's kernels take any pixel count, so a valid value
    changes nothing here."""
    t = int(v or 0)
    if t and (t < 8 or t & (t - 1)):
        raise ValueError(f"corr_tile must be 0 or a power of two >= 8, got {t}")
    return t


def raft_params_from_config(raft_kwargs) -> RAFTParams:
    """RAFTParams from a reference-style raft_params mapping (as JAX
    ``raft_params_from_config``): every option of the JAX model. An unknown
    ``corr_method`` or ``conv_backend`` raises; ``corr_tile`` and
    ``fuse_lookup`` choose the TPU's tiling and fusion, not the function, so
    every valid value is accepted."""
    get = (raft_kwargs.get if hasattr(raft_kwargs, "get")
           else lambda k, d=None: getattr(raft_kwargs, k, d))
    backend = str(get("conv_backend", "auto"))
    if backend not in CONV_BACKENDS:
        raise ValueError(f"unknown conv_backend {backend!r}")
    check_corr_tile(get("corr_tile", 0))
    return RAFTParams(small=bool(get("small", False)),
                      occlusion_module=get("occlusion_module", "separate_with_uncertainty"),
                      normalized_features=bool(get("normalized_features", False)),
                      relu_uncertainty=bool(get("relu_uncertainty", False)),
                      compute_dtype=str(get("compute_dtype", "auto")),
                      corr_method=str(get("corr_method", "auto")),
                      conv_backend="pallas" if backend == "pallas" else "auto",
                      ou_last_iter_only=bool(get("OU_last_iter_only", False)))


def random_init(model: nn.Module, seed: int = 0):
    """Deterministic init in the distributions flax's RAFT.init uses."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # lecun_normal: truncated normal at 2 std, variance 1/fan_in
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
    return model


def load_weights(path: Path) -> dict:
    """The float32 state dict of an existing weights file, by its suffix:
    ``.msgpack``/``.bin`` a flax variables file (read by
    :mod:`flax_msgpack`, converted by :func:`convert.params_from_flax`, as
    JAX's ``load_variables`` reads it), ``.pt``/``.pth`` a state dict: the
    reference's (some name only the reference uses: ``module.``,
    ``layer2.0``, ``downsample.1``, ...; read by
    :func:`convert.params_from_reference`, as JAX's ``load_torch_checkpoint``
    reads it) or this port's. A file that does not decode, or a name that
    neither form knows, raises (KeyError from the reference's map, or the
    strict ``load_state_dict``); it never falls back to random weights."""
    if path.suffix in (".msgpack", ".bin"):
        logger.info("loading flax weights %s", path)
        return params_from_flax(read_variables(path))
    if path.suffix in (".pt", ".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if is_reference_state_dict(state):
            logger.info("converting reference checkpoint %s", path)
            return params_from_reference(state)
        return state
    raise ValueError(f"unknown checkpoint format: {path}")


class RAFTFlow:
    """Flow/occlusion/sigma estimator (reference RAFTWrapper role)."""

    def __init__(self, config, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = raft_params_from_config(config.raft_params or {})
        self.iters = int(config.flow_iters or 12)
        if self.iters < 1:
            raise ValueError(f"flow_iters must be >= 1, got {self.iters}")
        self.plain_ops = False  # True: plain PyTorch lookups on the card too
        # one grouped-conv stack for fnet and cnet (encoder_fuse.py); the big
        # model's encoders only, as in JAX
        self.fused_encoder = bool(config.fused_encoder) and not self.cfg.small
        model = RAFT(self.cfg)
        path = Path(config.model) if config.model else None
        if path is not None and path.exists():
            model.load_state_dict(load_weights(path))
        else:
            logger.warning("checkpoint %s not found - using random init", path)
            random_init(model, cfg_value(config.init_seed, 0))
        self.model = model.to(self.device).eval()
        self.model.set_compute_dtype(self.cfg.dtype(self.device))
        self.model.requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    def load_state_dict(self, state_dict):
        """Load float32 weights (e.g. from params_from_flax); convs keep the
        compute dtype, the update block's routed conv biases float32."""
        self.model.load_state_dict(state_dict)

    # ------------------------------------------------------------------ #
    def padded_encode(self, images, with_context: bool = True):
        """(B, H, W, 3) RGB images in [0, 255] -> (fmap, cnet) at the padded
        stride-8 resolution, NCHW in the compute dtype; with the config's
        ``fused_encoder`` (big model) fnet and cnet run as one grouped-conv
        stack (:func:`encoder_fuse.fused_basic_encode`)."""
        (pt, pb), (pl, pr) = pad_to_8(images.shape[1], images.shape[2])
        x = images.to(self.device).float().permute(0, 3, 1, 2)
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb), mode="replicate")
        with torch.no_grad():
            if with_context and self.fused_encoder:
                return fused_basic_encode(self.model, x)
            return self.model.encode(x, with_context=with_context)

    def features_forward(self, fmap1, fmap2, cnet1, H: int, W: int,
                         init_flow=None, iters_schedule=None, init_slot=None):
        """Flow, occlusion and sigma from encoder features of (H, W) images.

        args: features from :meth:`padded_encode`; init_flow optional
          full-resolution initial flow: (B, H, W, 2) for the whole batch, or,
          with ``init_slot``, one (H, W, 2) map for pair ``init_slot`` alone
          (padded and downsampled once; the other pairs start from zero, as
          JAX's ``features_forward(init_slot=)``); iters_schedule optional
          iterations per pair (``RAFT._flow_scheduled``) in place of
          ``flow_iters``.
        returns: flow (B, H, W, 2), occlusion (B, H, W), sigma (B, H, W),
          float32, unpadded. A model without the occlusion or the
          uncertainty head raises ValueError (JAX's fails on the missing
          output).
        """
        if not self.cfg.uncertainty_estimation:
            missing = "occlusion" if not self.cfg.occlusion_estimation else "uncertainty"
            raise ValueError(f"occlusion_module={self.cfg.occlusion_module!r} has no "
                             f"{missing} head: the flow service returns occlusion and sigma")
        (pt, pb), (pl, pr) = pad_to_8(H, W)
        flow_init = None
        if init_flow is not None:
            fi = init_flow.to(self.device).float()
            fi = (fi[None] if init_slot is not None else fi).permute(0, 3, 1, 2)
            fi = F.pad(fi, (pl, pr, pt, pb), mode="replicate")
            flow_init = downsample_flow8(fi.permute(0, 2, 3, 1))
            if init_slot is not None:
                one = flow_init
                flow_init = one.new_zeros((fmap1.shape[0], *one.shape[1:]))
                flow_init[init_slot] = one[0]
        iters = self.iters if iters_schedule is None else tuple(int(i) for i in iters_schedule)
        with torch.no_grad():
            out = self.model.flow_from_features(fmap1, fmap2, cnet1, iters,
                                                flow_init, plain=self.plain_ops)
        Hp, Wp = H + pt + pb, W + pl + pr
        unpad = lambda x: x[:, pt:Hp - pb, pl:Wp - pr]
        flow = unpad(out["flow"]).contiguous()
        occl = unpad(torch.softmax(out["occlusion"], dim=-1)[..., 1]).contiguous()
        sigma = unpad(torch.sqrt(torch.exp(out["uncertainty"][..., 0]))).contiguous()
        return flow, occl, sigma

    def forward_batch(self, images1, images2, init_flow=None, iters_schedule=None):
        """Batched flow: (N, H, W, 3) RGB [0, 255] -> (flow, occl, sigma);
        init_flow optional (N, H, W, 2), iters_schedule optional iterations
        per pair."""
        H, W = images1.shape[1:3]
        fmap1, cnet1 = self.padded_encode(images1)
        fmap2, _ = self.padded_encode(images2, with_context=False)
        return self.features_forward(fmap1, fmap2, cnet1, H, W, init_flow,
                                     iters_schedule=iters_schedule)

    def compute_flow(self, src_img, dst_img, mode="flow", init_flow=None,
                     numpy_out=False):
        """Single-pair API (reference MFT/raft.py:30-94).

        args: src_img, dst_img (H, W, 3) uint8 BGR images; mode 'flow'
          (dense) or 'TC' (correspondences); init_flow optional (H, W, 2).
        returns (mode='flow'): flow (H, W, 2), {'occlusion': (H, W),
          'sigma': (H, W)}; (mode='TC'): src (H*W, 2) pixel coordinates
          (x, y) in raster order, dst = src + flow, {'occlusion': (H*W,),
          'sigma': (H*W,)}.
        """
        if mode not in ("flow", "TC"):
            raise ValueError(f"unknown mode {mode!r}")
        to_t = lambda im: torch.from_numpy(
            np.ascontiguousarray(im[:, :, ::-1]).astype(np.float32))[None]
        fi = None
        if init_flow is not None:
            fi = torch.as_tensor(np.asarray(init_flow, np.float32))[None]
        flow, occl, sigma = self.forward_batch(to_t(src_img), to_t(dst_img),
                                               init_flow=fi)
        flow, occl, sigma = flow[0], occl[0], sigma[0]
        if mode == "TC":
            H, W = flow.shape[:2]
            src = grid_coords(H, W, device=flow.device).reshape(-1, 2)
            flow, occl, sigma = src + flow.reshape(-1, 2), occl.reshape(-1), sigma.reshape(-1)
        if numpy_out:
            flow, occl, sigma = (t.cpu().numpy() for t in (flow, occl, sigma))
            if mode == "TC":
                src = src.cpu().numpy()
        extra = {"occlusion": occl, "sigma": sigma}
        return (src, flow, extra) if mode == "TC" else (flow, extra)
