"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mft_tpu_torch import ops
from mft_tpu_torch.config import default_config
from mft_tpu_torch.models.raft import corr as tcorr
from mft_tpu_torch.models.raft.corr import build_feature_pyramid
from mft_tpu_torch.tracker import MFT

pytestmark = pytest.mark.cuda
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def np_rng():
    return np.random.default_rng(0)


def _lookup_inputs(np_rng, dtype, dev, B=2, H8=6, W8=10, L=4, radius=4, F=256):
    """P = 60 pixels: not a multiple of the fused kernels' 32- and 64-pixel
    tiles; wc the (C, F) view of a (F, C) conv weight, as the model passes it."""
    P = H8 * W8
    levels = [(H8, W8), (H8 // 2, W8 // 2), (H8 // 4, W8 // 4), (1, 1)][:L]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    pyr = [t(np_rng.standard_normal((B, P, h, w))).to(DT[dtype]) for h, w in levels]
    coords = t(np_rng.uniform(-6, W8 + 6, (B, P, 2)))
    wc = t(np_rng.standard_normal((F, L * (2 * radius + 1) ** 2)) * 0.05).t()
    bias = t(np_rng.standard_normal((F,)) * 0.1)
    return pyr, coords, wc, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_kernel_matches_plain(np_rng, cuda, dtype):
    """Same float ops in the same order: bit-identical samples expected."""
    pyr, coords, _, _ = _lookup_inputs(np_rng, dtype, cuda)
    got = ops.corr_lookup(pyr, coords, 4)
    want = ops.corr_lookup_ref(pyr, coords, 4)
    assert got.dtype == DT[dtype] and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def _check_fused(pyr, coords, wc, bias, radius, dtype):
    """K1 against its plain version: f32 on the CUDA cores, the 324-term sum
    in another order (1e-4); bf16 on the tensor cores, every element within
    ops.product_error_bound (K = C) and within the stated tolerance, which
    allows the sum order to move the output's rounding by one ulp (rtol 8e-3)."""
    ops.reset_launch_counts()
    got = ops.corr_lookup_fused(pyr, coords, wc, bias, radius)
    assert ops.launch_counts()["corr_lookup_fused"] == 1
    assert ops.tensor_core_launch_counts()["corr_lookup_fused"] == (dtype == "bfloat16")
    want = ops.corr_lookup_fused_ref(pyr, coords, wc, bias, radius)
    assert got.dtype == DT[dtype] and got.shape == want.shape
    if dtype == "bfloat16":
        mag = ops.corr_lookup_fused_magnitude(pyr, coords, wc, radius)
        _assert_within_bound(got, want, mag, wc.shape[0])
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 8e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("F", [96, 256])
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernel_matches_plain(np_rng, cuda, dtype, radius, levels, F):
    """K1 at every radius and level count of its kernels, the big model's F
    (256) and the small model's (96), on B*P = 120 pixels (a ragged tile)."""
    pyr, coords, wc, bias = _lookup_inputs(np_rng, dtype, cuda, L=levels, radius=radius, F=F)
    _check_fused(pyr, coords, wc, bias, radius, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernel_many_tiles(np_rng, cuda, dtype):
    """K1 on 3 x 3000 pixels: more 64-pixel tiles than SMs, so persistent
    blocks take several, the last one ragged; wc a contiguous (C, F) tensor."""
    pyr, coords, wc, bias = _lookup_inputs(np_rng, dtype, cuda, B=3, H8=50, W8=60)
    _check_fused(pyr, coords, wc.contiguous(), bias, 4, dtype)


@pytest.mark.parametrize("radius,levels", [(1, 1), (4, 4)])
def test_fused_kernel_repairs_every_tile(cuda, radius, levels):
    """K1's rounding repair on its list and past its end: one output channel
    with weights of 2^10 widens the repair's window past the bf16 spacing of
    every other channel's outputs, so all of those are recomputed in the
    plain version's order. Each pixel's maps hold one value of its own and
    each channel its own bias, so the outputs differ, and every sum is
    exact: the result must equal the plain version's bit for bit."""
    B, P, F = 2, 200, 256
    dims = [(32, 32), (16, 16), (8, 8), (4, 4)][:levels]
    C = levels * (2 * radius + 1) ** 2
    p = torch.arange(P, device=cuda, dtype=torch.float32)
    value = (1.0 + (p % 64) / 128.0).view(1, P, 1, 1)
    pyr = [value.expand(B, P, h, w).contiguous().bfloat16() for h, w in dims]
    gen = torch.Generator(device=cuda).manual_seed(0)
    # whole positions at every level: samples are the map's value or 0
    coords = (torch.randint(1, 4, (B, P, 2), device=cuda, generator=gen) * 8).float()
    weight = torch.full((F, C), 2.0 ** -10, device=cuda)
    weight[F - 1] = 2.0 ** 10
    bias = torch.arange(F, device=cuda, dtype=torch.float32) / 64.0
    ops.reset_launch_counts()
    got = ops.corr_lookup_fused(pyr, coords, weight.bfloat16().t(), bias, radius)
    assert ops.tensor_core_launch_counts()["corr_lookup_fused"] == 1
    want = ops.corr_lookup_fused_ref(pyr, coords, weight.bfloat16().t(), bias, radius)
    assert got.shape == (B, P, F) and got.unique().numel() > F
    torch.testing.assert_close(got, want, **EXACT)


def test_fused_kernel_refuses_bad_widths(np_rng, cuda):
    """The tensor-core route takes F a multiple of 8 up to 256."""
    pyr, coords, _, _ = _lookup_inputs(np_rng, "bfloat16", cuda)
    for F in (100, 264):
        wc = torch.zeros((324, F), device=cuda)
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            ops.corr_lookup_fused(pyr, coords, wc, torch.zeros(F, device=cuda), 4)


def test_chain_select_kernel_matches_plain(np_rng, cuda):
    """Exact f32 math in the same order: identical selections and values,
    including exact ties (two identical candidates) and invalid candidates."""
    N, H, W = 7, 40, 48
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    lflow = t(np_rng.uniform(-12, 12, (N, H, W, 2)))
    locc = t(np_rng.uniform(0, 0.03, (N, H, W)))
    lsig = t(np_rng.uniform(0.1, 2.0, (N, H, W)))
    rflow = t(np_rng.uniform(-12, 12, (N, H, W, 2)))
    rocc = t(np_rng.uniform(0, 0.03, (N, H, W)))
    rsig = t(np_rng.uniform(0.1, 2.0, (N, H, W)))
    for m in (lflow, locc, lsig, rflow, rocc, rsig):
        m[1] = m[0]                       # candidates 0 and 1 tie exactly
    valid = torch.tensor([True, True, True, False, True, True, False], device=cuda)
    ops.reset_launch_counts()
    got = ops.chain_select(lflow, locc, lsig, rflow, rocc, rsig, valid, 0.02)
    assert ops.launch_counts()["chain_select"] == 1
    want = ops.chain_select_ref(lflow, locc, lsig, rflow, rocc, rsig, valid, 0.02)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-6)


def _chain_maps(np_rng, dev, N, H, W):
    """Candidate maps: per candidate a constant shift (n + 1)*(2, 1) px plus
    U(-0.5, 0.5) on most pixels, U(-12, 12) on a fifth (windows past every
    edge); candidates 0 and 1 identical (exact ties) where N > 1; the
    invalid ones every third from 2."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def flow():
        shift = (np.arange(N)[:, None, None, None] + 1) * np.array([2.0, 1.0])
        local = shift + np_rng.uniform(-0.5, 0.5, (N, H, W, 2))
        wild = np_rng.uniform(-12, 12, (N, H, W, 2))
        return np.where(np_rng.random((N, H, W, 1)) < 0.2, wild, local)

    maps = [t(flow()), t(np_rng.uniform(0, 0.03, (N, H, W))),
            t(np_rng.uniform(0.1, 2.0, (N, H, W))), t(flow()),
            t(np_rng.uniform(0, 0.03, (N, H, W))), t(np_rng.uniform(0.1, 2.0, (N, H, W)))]
    if N > 1:
        for m in maps:
            m[1] = m[0]
    valid = torch.tensor([n < 2 or n % 3 != 2 for n in range(N)], device=dev)
    return (*maps, valid)


def _assert_same_values(got, want):
    """Identical NaN positions, bit-identical values elsewhere."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        keep = ~torch.isnan(w)
        assert torch.equal(g[keep].view(torch.int32), w[keep].view(torch.int32))


@pytest.mark.parametrize("shape", [(40, 48), (37, 53)])
@pytest.mark.parametrize("N", list(range(1, 10)) + [17])
def test_chain_select_kernel_bits(np_rng, cuda, N, shape):
    """K3 bit for bit against chain_select_ref for every compiled candidate
    count (1..8) and the generic loop (9, 17), on whole and ragged 32 x 8
    tiles, with exact ties and invalid candidates."""
    maps = _chain_maps(np_rng, cuda, N, *shape)
    ops.reset_launch_counts()
    got = ops.chain_select(*maps, 0.02)
    assert ops.launch_counts()["chain_select"] == 1
    _assert_same_values(got, ops.chain_select_ref(*maps, 0.02))


@pytest.mark.parametrize("N", [1, 8])
def test_chain_select_kernel_all_invalid(np_rng, cuda, N):
    """Every candidate invalid: candidate 0 wins everywhere, as argmax."""
    maps = list(_chain_maps(np_rng, cuda, N, 37, 53))
    maps[-1] = torch.zeros(N, dtype=torch.bool, device=cuda)
    _assert_same_values(ops.chain_select(*maps, 0.02), ops.chain_select_ref(*maps, 0.02))


@pytest.mark.parametrize("N", [2, 7, 9])
def test_chain_select_kernel_invalid_first_wins(np_rng, cuda, N):
    """Candidate 0 invalid and every valid candidate occluded: all scores
    are -inf, so candidate 0 wins everywhere, as argmax, and the outputs
    are chained from an invalid candidate's maps."""
    maps = list(_chain_maps(np_rng, cuda, N, 37, 53))
    maps[1][1:] = 0.5
    maps[-1][0] = False
    want = ops.chain_select_ref(*maps, 0.02)
    assert bool((want[1] != 1.0).any())   # some endpoints inside: occlusions read
    _assert_same_values(ops.chain_select(*maps, 0.02), want)


@pytest.mark.parametrize("planted", ["locc", "lsig", "rocc", "rsig"])
def test_chain_select_kernel_nan(np_rng, cuda, planted):
    """NaN in one candidate map: the kernel selects and chains as argmax
    and torch.maximum do (the first NaN score wins, a NaN occlusion
    propagates), so its NaN positions and values equal the plain version's."""
    maps = list(_chain_maps(np_rng, cuda, 7, 40, 48))
    m = maps[{"locc": 1, "lsig": 2, "rocc": 4, "rsig": 5}[planted]]
    m[torch.from_numpy(np_rng.random(tuple(m.shape)) < 0.1).to(cuda)] = float("nan")
    want = ops.chain_select_ref(*maps, 0.02)
    assert any(bool(torch.isnan(w).any()) for w in want)
    _assert_same_values(ops.chain_select(*maps, 0.02), want)


@pytest.mark.parametrize("N", [1, 7, 9])
def test_chain_select_kernel_clip_axis(np_rng, cuda, N):
    """K3 over a clip axis (the streaming tracker's): one launch for 3 clips
    of (N, 37, 53) maps, NaN planted in one clip's occlusions and sigmas,
    bit for bit with its plain version and with 3 single-clip launches."""
    clips = [_chain_maps(np_rng, cuda, N, 37, 53) for _ in range(3)]
    maps = [torch.stack([c[k] for c in clips]) for k in range(6)]
    valid = clips[0][6]
    for k in (1, 5):
        hit = torch.from_numpy(np_rng.random(tuple(maps[k][1].shape)) < 0.1).to(cuda)
        maps[k][1][hit] = float("nan")
    ops.reset_launch_counts()
    got = ops.chain_select(*maps, valid, 0.02)
    assert ops.launch_counts()["chain_select"] == 1
    assert got[0].shape == (3, 37, 53, 2) and got[1].shape == (3, 37, 53)
    _assert_same_values(got, ops.chain_select_ref(*maps, valid, 0.02))
    singles = [ops.chain_select(*(m[c] for m in maps), valid, 0.02) for c in range(3)]
    _assert_same_values(got, tuple(torch.stack([one[f] for one in singles]) for f in range(3)))


def test_streaming_launches_and_matches_single(cuda):
    """StreamingTracker on the card, 2 clips of 64x64, 3 iterations: per
    timestep (iters - 1) fused lookups, one plain lookup and one chain +
    select for both clips; each clip against a single-clip MFT with the main
    path's frame gate (median <= 0.05 px, <= 1% of pixels over 0.5 px): the
    batches differ in size, so cuDNN may sum the bf16 convs in another order."""
    from mft_tpu_torch.parallel import StreamingTracker
    cfg = default_config()
    cfg.flow_config.flow_iters = 3
    rng = np.random.default_rng(0)
    tex = (rng.random((2, 80, 80, 3)) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(tex[:, k:k + 64, 2 * k:2 * k + 64]) for k in range(4)]
    st = StreamingTracker(cfg, n_clips=2, device=cuda)
    st.init(frames[0])
    ops.reset_launch_counts()
    results = [st.track(f) for f in frames[1:]]
    want = {k: 0 for k in ops.launch_counts()}
    want.update(corr_lookup_fused=6, corr_lookup=3, chain_select=3)
    assert ops.launch_counts() == want
    for c in range(2):
        single = MFT(cfg, device=cuda)
        single.init(frames[0][c])
        for k in range(1, 4):
            one = single.track(frames[k][c]).result
            gap = (results[k - 1].flow[c] - one.flow).norm(dim=-1)
            assert float(gap.median()) <= 0.05 and float((gap > 0.5).float().mean()) <= 0.01


def test_chain_select_kernel_refuses_misaligned_flows(np_rng, cuda):
    """The kernel reads each (x, y) flow pair as one 8-byte word: a flow map
    that starts 4 bytes into an allocation raises."""
    maps = list(_chain_maps(np_rng, cuda, 2, 8, 8))
    shifted = torch.empty(maps[0].numel() + 1, device=cuda)[1:].view(maps[0].shape)
    shifted.copy_(maps[0])
    maps[0] = shifted
    with pytest.raises(ValueError, match="8-byte aligned"):
        ops.chain_select(*maps, 0.02)


def test_mft_main_path_launches_each_kernel(cuda):
    """A small MFT run on the card goes through the three kernels: per frame
    (iters - 1) fused lookups, one plain lookup, one chain + select."""
    cfg = default_config()
    cfg.flow_config.flow_iters = 3
    tracker = MFT(cfg, device=cuda)
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    ops.reset_launch_counts()
    tracker.init(tex[:64, :64])
    for k in range(1, 4):
        res = tracker.track(np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64])).result
        assert res.flow.shape == (64, 64, 2) and bool(torch.isfinite(res.flow).all())
    want = {k: 0 for k in ops.launch_counts()}
    want.update(corr_lookup_fused=6, corr_lookup=3, chain_select=3)
    assert ops.launch_counts() == want


@pytest.mark.parametrize("method", ["auto", "alt"])
def test_mft_small_model_launches_its_kernels(cuda, method):
    """The small RAFT on the card (``small`` in the default config's
    raft_params): every iteration launches the method's lookup at radius 3
    ('auto': K2, never the fused K1), the frame one chain + select; finite
    flow."""
    cfg = default_config()
    cfg.flow_config.flow_iters = 3
    cfg.flow_config.raft_params.update(small=True, corr_method=method)
    tracker = MFT(cfg, device=cuda)
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    ops.reset_launch_counts()
    tracker.init(tex[:64, :64])
    for k in range(1, 3):
        res = tracker.track(np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64])).result
        assert res.flow.shape == (64, 64, 2) and bool(torch.isfinite(res.flow).all())
    name = {"auto": "corr_lookup", "alt": "corr_lookup_alt"}[method]
    want = {k: 0 for k in ops.launch_counts()}
    want.update({name: 6, "chain_select": 2})
    assert ops.launch_counts() == want


def _alt_inputs(np_rng, dtype, dev, kind, B=2, H8=13, W8=21, C=64, levels=4):
    """13x21 source pixels: ragged 8x8 tiles and odd pyramid levels."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    f1 = t(np_rng.standard_normal((B, H8, W8, C))).to(DT[dtype])
    f2 = t(np_rng.standard_normal((B, C, H8, W8))).to(DT[dtype])
    if kind == "wild":
        coords = np_rng.uniform(-8, W8 + 8, (B, H8 * W8, 2))
    else:
        g = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, H8 * W8, 2)
        coords = g + np_rng.uniform(-2, 2, (B, H8 * W8, 2))
    return f1, build_feature_pyramid(f2, levels), t(coords).contiguous()


# stated tolerance of the float32 kernels against the plain version: the same
# float ops in the same order (every dot in one fixed tree order), so
# bit-identical samples are expected; the tolerance admits last-bit
# differences only
ALT_TOL = {"float32": (1e-6, 1e-6)}


def _check_window(got, f1, pyr, coords, dtype, radius=4):
    """K4/K5 against their plain version: float32 to ALT_TOL; bfloat16 (the
    tile product on the tensor cores) within ops.product_error_bound (K = C,
    scale 1/sqrt(C), S from ops.corr_window_magnitude) on every element."""
    want = ops.corr_lookup_alt_ref(f1, pyr, coords, radius)
    assert got.dtype == DT[dtype] and got.shape == want.shape
    if dtype == "bfloat16":
        C = f1.shape[-1]
        _assert_within_bound(got, want, ops.corr_window_magnitude(f1, pyr, coords, radius), C,
                             ops.product.corr_scale(C))
    else:
        atol, rtol = ALT_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    return want


@pytest.mark.parametrize("kind", ["wild", "local"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["corr_lookup_alt", "corr_lookup_win"])
def test_alt_kernels_match_plain(np_rng, cuda, dtype, kind, name):
    f1, pyr, coords = _alt_inputs(np_rng, dtype, cuda, kind)
    ops.reset_launch_counts()
    got = getattr(ops, name)(f1, pyr, coords, 4)
    assert ops.launch_counts()[name] == 1
    assert ops.tensor_core_launch_counts()[name] == (dtype == "bfloat16")
    assert got.shape == (2, 13 * 21, 324)
    _check_window(got, f1, pyr, coords, dtype)


@pytest.mark.parametrize("kind", ["wild", "local"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["corr_lookup_alt", "corr_lookup_win"])
def test_alt_kernels_match_plain_small_model(np_rng, cuda, dtype, kind, name):
    """K4/K5 at the small model's shapes: C = 128 features (two of the
    kernel's four 8-channel chunks a lane) and radius 3 (196 outputs a
    pixel), 13x21 pixels; f32 to ALT_TOL, bf16 within the bound."""
    f1, pyr, coords = _alt_inputs(np_rng, dtype, cuda, kind, C=128)
    ops.reset_launch_counts()
    got = getattr(ops, name)(f1, pyr, coords, 3)
    assert ops.launch_counts()[name] == 1
    assert ops.tensor_core_launch_counts()[name] == (dtype == "bfloat16")
    assert got.shape == (2, 13 * 21, 196)
    _check_window(got, f1, pyr, coords, dtype, radius=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_win_kernel_staged_and_unstaged_agree(np_rng, cuda, dtype):
    """Wild coordinates on a 48x48 map: at level 0 a tile's tap box is the
    whole map (2304 positions > 1600) and the tile reads device memory; the
    smaller levels stage their boxes. Local coordinates stage every box.
    Both stay with the plain version's samples; with C=40 (5 chunks of 8
    channels) most lanes of a tap dot add zeros, and the bf16 kernel pads K
    to 48 with zeros."""
    tiles = 2 * 6 * 6                      # pairs x 8x8 tiles of 48x48
    for kind, want_unstaged in (("wild", tiles), ("local", 0)):
        f1, pyr, coords = _alt_inputs(np_rng, dtype, cuda, kind, H8=48, W8=48, C=40)
        stats = torch.zeros(2, dtype=torch.int32, device=cuda)
        got = ops.corr_lookup_win(f1, pyr, coords, 4, stats=stats)
        assert stats.tolist() == [4 * tiles - want_unstaged, want_unstaged], kind
        _check_window(got, f1, pyr, coords, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_win_kernel_boxes_straddle_the_cap(np_rng, cuda, dtype):
    """One launch on a 64x64 map whose tiles' level-0 boxes lie on both
    sides of the 1600-position cap: tile (0, 0) has its pixels at x, y in
    {10, 40} (box 40 x 40 = 1600: staged), tile (0, 1) at x in {10, 41},
    y in {10, 40} (41 x 40: read from device memory per pixel), the rest
    local. The smaller levels stage every box."""
    H8 = W8 = 64
    f1, pyr, coords = _alt_inputs(np_rng, dtype, cuda, "local", H8=H8, W8=W8, C=64)
    c = coords.view(2, H8, W8, 2)
    corner = torch.tensor([[10.5, 10.5], [40.5, 10.5], [10.5, 40.5], [40.5, 40.5]], device=cuda)
    c[:, :8, :8] = corner.repeat(16, 1).view(8, 8, 2)
    c[:, :8, 8:16] = (corner + torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0], [1.0, 0.0]],
                                            device=cuda)).repeat(16, 1).view(8, 8, 2)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda)
    got = ops.corr_lookup_win(f1, pyr, coords, 4, stats=stats)
    tiles = 2 * 8 * 8
    assert stats.tolist() == [4 * tiles - 2, 2]   # tile (0, 1) of each pair, level 0
    _check_window(got, f1, pyr, coords, dtype)


@pytest.mark.parametrize("overlap", [2.0 ** -6, 2.0 ** -12])
def test_window_kernel_repairs_near_orthogonal_features(cuda, overlap):
    """The bf16 rounding repair under load: f1 lives on channels 0..31 and f2
    on 32..63 plus ``overlap`` times a random part on all channels, so every
    dot is small against ||f1|| ||f2|| and many samples lie within the repair's
    window of a bf16 rounding boundary. At 2^-6 about twice the usual share
    of taps is marked, in long lists for the second sweep; at 2^-12 nearly
    every sample is, more taps than the list holds (2,048 at C = 64), and the
    level recomputes every dot on the CUDA cores. Either way every sample
    must equal the plain version's bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, H8, W8, C = 2, 24, 24, 64
    f1 = torch.zeros((B, H8, W8, C), device=cuda)
    f1[..., :32] = torch.randn((B, H8, W8, 32), device=cuda, generator=gen)
    f2 = overlap * torch.randn((B, C, H8, W8), device=cuda, generator=gen)
    f2[:, 32:] += torch.randn((B, 32, H8, W8), device=cuda, generator=gen)
    f1, f2 = f1.bfloat16(), f2.bfloat16()
    ys, xs = torch.meshgrid(torch.arange(H8, device=cuda), torch.arange(W8, device=cuda),
                            indexing="ij")
    coords = (torch.stack([xs, ys], -1).reshape(1, -1, 2).float()
              + 4 * torch.rand((B, H8 * W8, 2), device=cuda, generator=gen) - 2).contiguous()
    pyr = build_feature_pyramid(f2, 4)
    for name in ("corr_lookup_alt", "corr_lookup_win"):
        got = getattr(ops, name)(f1, pyr, coords, 4)
        want = _check_window(got, f1, pyr, coords, "bfloat16")
        torch.testing.assert_close(got, want, **EXACT)


@pytest.mark.parametrize("method", ["alt", "win"])
def test_mft_feature_path_launches_its_kernel(cuda, method):
    """corr_method 'alt' / 'win' on the card: every iteration launches the
    method's kernel, the frame one chain + select, and no volume lookup."""
    cfg = default_config()
    cfg.flow_config.flow_iters = 3
    cfg.flow_config.raft_params["corr_method"] = method
    tracker = MFT(cfg, device=cuda)
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    ops.reset_launch_counts()
    tracker.init(tex[:64, :64])
    for k in range(1, 3):
        res = tracker.track(np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64])).result
        assert res.flow.shape == (64, 64, 2) and bool(torch.isfinite(res.flow).all())
    name = {"alt": "corr_lookup_alt", "win": "corr_lookup_win"}[method]
    want = {k: 0 for k in ops.launch_counts()}
    want.update({name: 6, "chain_select": 2})
    assert ops.launch_counts() == want
    assert ops.tensor_core_launch_counts()[name] == 6   # the model is bf16


VOLUME_KERNELS = {"int8": "corr_lookup_q", "packed": "corr_lookup_packed",
                  "packed_i8": "corr_lookup_packed_i8", "pallas_t": "corr_lookup_t"}


def _stored_volume(np_rng, method, dtype, dev, kind, B=2, H8=13, W8=21, C=32):
    """A tagged volume of random features (13x21 source pixels: odd levels,
    widths 21+10+5+2 = 38) and coords, 'wild' past every level's edges or
    'local' (the pixel grid + U(-2, 2)). The int8 forms quantize a volume
    of ``dtype``."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    f1 = t(np_rng.standard_normal((B, C, H8, W8))).to(DT[dtype])
    f2 = t(np_rng.standard_normal((B, C, H8, W8))).to(DT[dtype])
    if kind == "wild":
        coords = np_rng.uniform(-6, W8 + 6, (B, H8 * W8, 2))
    else:
        g = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, H8 * W8, 2)
        coords = g + np_rng.uniform(-2, 2, (B, H8 * W8, 2))
    if method == "pallas_t":
        return ("t", tcorr.build_corr_pyramid_t(f1, f2, 4)), t(coords).contiguous()
    pyr = tcorr.build_corr_pyramid(f1, f2, 4)
    stored = {"int8": lambda: ("i8", *tcorr.quantize_pyramid(pyr)),
              "packed": lambda: ("packed", *tcorr.pack_corr_pyramid(pyr)),
              "packed_i8": lambda: ("packed_i8", *tcorr.pack_corr_pyramid_i8(pyr))}
    return stored[method](), t(coords).contiguous()


@pytest.mark.parametrize("kind", ["wild", "local"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", sorted(VOLUME_KERNELS))
def test_volume_kernels_match_plain(np_rng, cuda, method, dtype, kind):
    """The same float ops in the same order (tap dequantized, then weighted;
    built with -fmad=false): bit-identical samples expected, last-bit
    tolerance. int8 forms write bf16, the others the volume dtype."""
    stored, coords = _stored_volume(np_rng, method, dtype, cuda, kind)
    name = VOLUME_KERNELS[method]
    ops.reset_launch_counts()
    got = tcorr.corr_lookup(stored, coords, 4)
    assert ops.launch_counts()[name] == 1
    want = tcorr.corr_lookup(stored, coords, 4, plain=True)
    out_dt = torch.bfloat16 if method in ("int8", "packed_i8") else DT[dtype]
    assert got.dtype == want.dtype == out_dt and got.shape == (2, 13 * 21, 324)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=1e-6)
    _assert_same_bits(got, want)


def _assert_same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    differ = int((got.view(ints) != want.view(ints)).sum())
    assert differ == 0, f"{differ} of {got.numel()} outputs differ from the plain version's bits"


def _pyramid_dims(H8, W8):
    return [(H8, W8), (H8 // 2, W8 // 2), (H8 // 4, W8 // 4), (max(H8 // 8, 1), max(W8 // 8, 1))]


def _mixed_coords(np_rng, B, H8, W8, wild=0.1):
    """(B, H8*W8, 2): the pixel grid + U(-2, 2), a share ``wild`` of the
    pixels uniform over the map and 6 px past it."""
    P = H8 * W8
    g = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, P, 2)
    local = g + np_rng.uniform(-2, 2, (B, P, 2))
    far = np_rng.uniform(-6, W8 + 6, (B, P, 2))
    return np.where(np_rng.random((B, P, 1)) < wild, far, local).astype(np.float32)


# level-0 maps of the lane-major kernel's cases: P odd and a width of 21 (no
# run 16-byte aligned, groups straddle rows); whole 16-pixel groups, every
# run aligned; a width of 20 (groups straddle rows, runs aligned)
LANE_MAPS = {"13x21": (13, 21), "16x32": (16, 32), "12x20": (12, 20)}


@pytest.mark.parametrize("shape", sorted(LANE_MAPS))
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_major_kernel_matches_plain(np_rng, cuda, dtype, radius, shape):
    """K9 bit for bit against corr_lookup_t_ref, wild and local pixels in
    one launch: some (group, level) union boxes are staged, others read per
    pixel."""
    H8, W8 = LANE_MAPS[shape]
    B, P = 2, H8 * W8
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    levels = [t(np_rng.standard_normal((B, h, w, P))).to(DT[dtype])
              for h, w in _pyramid_dims(H8, W8)]
    coords = t(_mixed_coords(np_rng, B, H8, W8))
    ops.reset_launch_counts()
    ops.lane_major_staged_counts(reset=True)
    got = ops.corr_lookup_t(levels, coords, radius)
    staged, per_pixel = ops.lane_major_staged_counts(reset=True)
    assert ops.launch_counts()["corr_lookup_t"] == 1
    groups = -(-P // (32 // levels[0].element_size()))
    assert staged + per_pixel == B * groups * 4 and staged > 0 and per_pixel > 0
    _assert_same_bits(got, ops.corr_lookup_t_ref(levels, coords, radius))


@pytest.mark.parametrize("method", ["int8", "packed", "packed_i8", "pallas_t", "fold"])
def test_gather_volume_kernels_refuse_radius_5(np_rng, cuda, method):
    """K6-K9 and #4 are compiled for radius 1..4: radius 5 raises on the card."""
    if method == "fold":
        f1, f2, coords = _folded_inputs(np_rng, "bfloat16", cuda, "local")
        stored = ("fold", *tcorr.build_corr_pyramid_folded(f1, f2, 4))
    else:
        stored, coords = _stored_volume(np_rng, method, "bfloat16", cuda, "local")
    with pytest.raises(ValueError, match="radius"):
        tcorr.corr_lookup(stored, coords, 5)


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8 of bfloat16"])
def test_packed_kernel_stays_in_each_level(np_rng, cuda, form):
    """Filling the other levels' columns with large values (1e3; 127 in
    int8) changes no level-0 sample, also where the windows pass the
    level's right edge; K7 in f32 and bf16, K8 on int8."""
    method = "packed_i8" if form.startswith("int8") else "packed"
    stored, coords = _stored_volume(np_rng, method, form.split()[-1], cuda, "wild")
    packed, dims = stored[1], stored[-1]
    want = tcorr.corr_lookup(stored, coords, 4)
    for view in tcorr.unpack_levels(packed, dims)[1:]:
        view.fill_(127 if packed.dtype == torch.int8 else 1e3)
    got = tcorr.corr_lookup(stored, coords, 4)
    _assert_same_bits(got[..., :81].contiguous(), want[..., :81].contiguous())


@pytest.mark.parametrize("method", sorted(VOLUME_KERNELS))
def test_mft_volume_methods_launch_their_kernel(cuda, method):
    """corr_method 'int8', 'packed', 'packed_i8', 'pallas_t' on the card:
    every iteration launches the method's lookup kernel (no fused lookup),
    the frame one chain + select."""
    cfg = default_config()
    cfg.flow_config.flow_iters = 3
    cfg.flow_config.raft_params["corr_method"] = method
    tracker = MFT(cfg, device=cuda)
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    ops.reset_launch_counts()
    tracker.init(tex[:64, :64])
    for k in range(1, 3):
        res = tracker.track(np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64])).result
        assert res.flow.shape == (64, 64, 2) and bool(torch.isfinite(res.flow).all())
    want = {k: 0 for k in ops.launch_counts()}
    want.update({VOLUME_KERNELS[method]: 6, "chain_select": 2})
    assert ops.launch_counts() == want


def _folded_inputs(np_rng, dtype, dev, kind, B=3, H8=16, W8=32, C=40):
    """Features of a packable 16x32 map (levels 16x32 in 4 rows of 128
    lanes, 8x16 in one row, 4x8 and 2x4 zero-padded to one row) and coords
    'wild' past every level's edges or 'local' (the grid + U(-2, 2))."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    f1 = t(np_rng.standard_normal((B, C, H8, W8))).to(DT[dtype])
    f2 = t(np_rng.standard_normal((B, C, H8, W8))).to(DT[dtype])
    if kind == "wild":
        coords = np_rng.uniform(-6, W8 + 6, (B, H8 * W8, 2))
    else:
        g = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, H8 * W8, 2)
        coords = g + np_rng.uniform(-2, 2, (B, H8 * W8, 2))
    return f1, f2, t(coords).contiguous()


# The folded and mixed lookups and the float32 product kernels (volume build,
# convolution) do the plain versions' float ops in the same order (one
# ascending float32 sum per output; built with -fmad=false), so they are held
# to bit-identical results: tolerance 0. The bfloat16 product kernels sum on
# the tensor cores in their own order and are held to
# ops.product_error_bound on every element (_assert_within_bound).
EXACT = dict(atol=0.0, rtol=0.0)


def _assert_within_bound(got, want, magnitude, K, scale=1.0):
    """|got - want| <= K*2^-22*S*scale + 2^-7*|want| on every element."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bound = ops.product_error_bound(want, magnitude, K, scale)
    err = (got.float() - want.float()).abs()
    ratio = float((err / bound.clamp_min(1e-30)).max())
    assert bool((err <= bound).all()), f"max |got - want| / bound = {ratio:.3f}"


def _check_build(f1, f2, dtype):
    """The folded build of (f1, f2) through the kernel, one launch (on the
    tensor cores in bf16), against the plain version."""
    ops.reset_launch_counts()
    got, gdims = tcorr.build_corr_pyramid_folded(f1, f2, 4)
    assert ops.launch_counts()["corr_build_folded"] == 1
    assert ops.tensor_core_launch_counts()["corr_build_folded"] == (dtype == "bfloat16")
    want, wdims = tcorr.build_corr_pyramid_folded(f1, f2, 4, plain=True)
    assert gdims == wdims
    if dtype == "bfloat16":
        a, f2_levels, _ = tcorr.folded_operands(f1, f2, 4)
        mags = ops.corr_build_folded_magnitude(a, f2_levels)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == DT[dtype] and g.shape == w.shape
        if dtype == "bfloat16":
            _assert_within_bound(g, w, mags[lvl], f1.shape[1],
                                 ops.product.corr_scale(f1.shape[1]))
        else:
            torch.testing.assert_close(g, w, **EXACT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(16, 32), (8, 8)])
def test_build_folded_kernel_matches_plain(np_rng, cuda, dtype, dims):
    """All levels of all pairs in one launch; 8x8 has 64 source pixels, a
    ragged tile, and every level in one zero-padded row; C = 40 is a ragged
    k stage."""
    f1, f2, _ = _folded_inputs(np_rng, dtype, cuda, "wild", H8=dims[0], W8=dims[1])
    _check_build(f1, f2, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_folded_kernel_full_width(np_rng, cuda, dtype):
    """The 512x512 frame's build: 7 pairs of (256, 64, 64) features."""
    f1, f2, _ = _folded_inputs(np_rng, dtype, cuda, "wild", B=7, H8=64, W8=64, C=256)
    _check_build(f1, f2, dtype)


@pytest.mark.parametrize("kind", ["wild", "local"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_lookup_kernel_matches_plain(np_rng, cuda, dtype, kind):
    """The folded lookup on the plain build's levels; filling a small level's
    padding lanes with 1e3 changes no sample (taps stay in each level)."""
    f1, f2, coords = _folded_inputs(np_rng, dtype, cuda, kind)
    levels, dims = tcorr.build_corr_pyramid_folded(f1, f2, 4, plain=True)
    ops.reset_launch_counts()
    got = ops.corr_lookup_folded(levels, dims, coords, 4, ywin=8)
    assert ops.launch_counts()["corr_lookup_folded"] == 1
    want = ops.corr_lookup_folded_ref(levels, dims, coords, 4)
    assert got.dtype == DT[dtype] and got.shape == (3, 16 * 32, 324)
    torch.testing.assert_close(got, want, **EXACT)
    for lvl, (h, w) in zip(levels, dims):
        lvl.reshape(*lvl.shape[:2], -1)[..., h * w:] = 1e3
    torch.testing.assert_close(ops.corr_lookup_folded(levels, dims, coords, 4), want,
                               **EXACT)


@pytest.mark.parametrize("dims", [(16, 32), (8, 8), (8, 12), (11, 11)])
@pytest.mark.parametrize("kind", ["wild", "local"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_lookup_kernel_bits(np_rng, cuda, dtype, radius, kind, dims):
    """#4 on the gather bit for bit against corr_lookup_folded_ref: 16x32
    (level 0 in 4 rows of 128 values), 8x8 (every level one zero-padded
    row) and 8x12, 11x11 (one-row levels whose w does not divide 128); the
    padding lanes filled with 1e3 change nothing."""
    f1, f2, coords = _folded_inputs(np_rng, dtype, cuda, kind, H8=dims[0], W8=dims[1])
    levels, ldims = tcorr.build_corr_pyramid_folded(f1, f2, 4, plain=True)
    ops.reset_launch_counts()
    got = ops.corr_lookup_folded(levels, ldims, coords, radius)
    assert ops.launch_counts()["corr_lookup_folded"] == 1
    want = ops.corr_lookup_folded_ref(levels, ldims, coords, radius)
    assert got.shape == (3, dims[0] * dims[1], 4 * (2 * radius + 1) ** 2)
    _assert_same_bits(got, want)
    for lvl, (h, w) in zip(levels, ldims):
        lvl.reshape(*lvl.shape[:2], -1)[..., h * w:] = 1e3
    _assert_same_bits(ops.corr_lookup_folded(levels, ldims, coords, radius), want)


@pytest.mark.parametrize("dims", [(16, 32), (13, 21)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_lookup_kernel_matches_plain(np_rng, cuda, dtype, dims):
    """16x32: level 0 folds (4 rows per lane row), the rest stay plain;
    13x21: nothing folds (the all-plain case)."""
    f1, f2, coords = _folded_inputs(np_rng, dtype, cuda, "wild", H8=dims[0], W8=dims[1])
    stored = tcorr.build_corr_pyramid_mixed(f1, f2, 4)
    assert len(stored[1]) == (1 if dims == (16, 32) else 0)
    ops.reset_launch_counts()
    got = tcorr.corr_lookup(stored, coords, 4)
    assert ops.launch_counts()["corr_lookup_mixed"] == 1
    want = tcorr.corr_lookup(stored, coords, 4, plain=True)
    assert got.dtype == DT[dtype] and got.shape == (3, dims[0] * dims[1], 324)
    torch.testing.assert_close(got, want, **EXACT)


def round_up_coords(np_rng, n, level, lo=-3, hi=12):
    """(n, 2) level-0 coords c with c/2^level = nextafter(m, -inf) for
    integers m != 0 in [lo, hi): c/2^level + k rounds up to the integer m + k
    for the window offsets k that carry |m + k| past a power of two, so
    floor(c/2^level + k) is floor(c/2^level) + k + 1 there."""
    m = np_rng.integers(lo, hi - 1, (n, 2))
    m = np.where(m >= 0, m + 1, m).astype(np.float32)
    return np.nextafter(m, np.float32(-np.inf)) * np.float32(2.0 ** level)


def _gather_coords(np_rng, B, P, dims, radius):
    """(B, P, 2) level-0 coords for the levels ``dims``: a third of the pixels
    uniform over the map and well beyond it (windows wholly outside at every
    level, or partly), a third on the pixel grid + U(-2, 2), a third at
    coordinates whose window positions round up to an integer at some level
    (the staged box's margin)."""
    h0, w0 = dims[0]
    span = (radius + 3) * 2 ** len(dims)
    c = np.empty((B * P, 2), np.float32)
    k = np.arange(B * P) % 3
    n0, n1, n2 = (int((k == v).sum()) for v in range(3))
    c[k == 0] = np_rng.uniform((-span, -span), (w0 + span, h0 + span), (n0, 2))
    g = np.stack([np_rng.integers(0, w0, n1), np_rng.integers(0, h0, n1)], -1)
    c[k == 1] = g + np_rng.uniform(-2, 2, (n1, 2))
    c[k == 2] = np.concatenate([round_up_coords(np_rng, 1, int(l)) for l in
                                np_rng.integers(0, len(dims), n2)])
    return c.reshape(B, P, 2)


def _assert_rounds_up(coords, num_levels, radius):
    """Some window position of these coords rounds up to an integer."""
    c = coords.reshape(-1, 2).astype(np.float32)
    off = np.arange(-radius, radius + 1, dtype=np.float32)
    ups = 0
    for l in range(num_levels):
        a = c / np.float32(2.0 ** l)
        pos = a[:, :, None] + off                         # float32 adds
        ups += int((np.floor(pos) != np.floor(a)[:, :, None] + off).sum())
    assert ups > 0


# level dims of the gather's edge cases: rows of 30 and 15 values (60 and 30
# bytes in bf16, 120 and 60 in f32: no multiple of 16), odd maps (misaligned
# pixel bases), 1 to 4 levels, 1x1 and 2x2 levels
GATHER_LEVELS = {
    "1 level 17x30": [(17, 30)],
    "2 levels w30 w15": [(17, 30), (9, 15)],
    "3 levels": [(12, 30), (6, 15), (3, 7)],
    "4 levels": [(16, 16), (8, 8), (2, 2), (1, 1)],
}


@pytest.mark.parametrize("levels", sorted(GATHER_LEVELS))
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_lookup_kernel_matches_plain(np_rng, cuda, dtype, radius, levels):
    """K2 (corr_gather.cu) bit for bit against corr_lookup_ref on windows
    wholly and partly outside the maps, local windows and round-up
    positions; B*P = 87 pixels, not a multiple of the block's 8."""
    dims = GATHER_LEVELS[levels]
    B, P = 3, 29
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    pyr = [t(np_rng.standard_normal((B, P, h, w))).to(DT[dtype]) for h, w in dims]
    coords = _gather_coords(np_rng, B, P, dims, radius)
    _assert_rounds_up(coords, len(dims), radius)
    ops.reset_launch_counts()
    got = ops.corr_lookup(pyr, t(coords), radius)
    assert ops.launch_counts()["corr_lookup"] == 1
    want = ops.corr_lookup_ref(pyr, t(coords), radius)
    assert got.dtype == DT[dtype] and got.shape == (B, P, len(dims) * (2 * radius + 1) ** 2)
    torch.testing.assert_close(got, want, **EXACT)


def _int8_levels(np_rng, B, P, dims, dev):
    """int8 levels of random values, the extremes -128 and 127 at every
    level, and (B, L) scales that are no powers of two."""
    levels = []
    for h, w in dims:
        q = np_rng.integers(-128, 128, (B, P, h, w))
        flat = q.reshape(-1)
        flat[np_rng.integers(0, flat.size, max(flat.size // 8, 2))] = -128
        flat[np_rng.integers(0, flat.size, max(flat.size // 8, 2))] = 127
        levels.append(torch.from_numpy(q.astype(np.int8)).to(dev))
    scales = torch.from_numpy(np_rng.uniform(0.011, 0.093, (B, len(dims))).astype(np.float32))
    return levels, scales.to(dev)


@pytest.mark.parametrize("levels", sorted(GATHER_LEVELS))
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_q_kernel_matches_plain(np_rng, cuda, radius, levels):
    """K6 (the gather on int8 levels) bit for bit against corr_lookup_q_ref:
    odd level widths (rows start at any byte), windows outside the maps,
    local windows and round-up positions."""
    dims = GATHER_LEVELS[levels]
    B, P = 3, 29
    lv, scales = _int8_levels(np_rng, B, P, dims, cuda)
    assert all(int(q.min()) == -128 and int(q.max()) == 127 for q in lv)
    coords = torch.from_numpy(_gather_coords(np_rng, B, P, dims, radius)).to(cuda)
    ops.reset_launch_counts()
    got = ops.corr_lookup_q(lv, scales, coords, radius)
    assert ops.launch_counts()["corr_lookup_q"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, P, len(dims) * (2 * radius + 1) ** 2)
    _assert_same_bits(got, ops.corr_lookup_q_ref(lv, scales, coords, radius))


def test_gather_bits_unchanged_after_q(np_rng, cuda):
    """K2 on bf16 levels gives the plain version's bits before and after a
    K6 launch on int8 levels of the same shapes (one shared gather)."""
    dims = GATHER_LEVELS["3 levels"]
    B, P = 3, 29
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    pyr = [t(np_rng.standard_normal((B, P, h, w))).to(torch.bfloat16) for h, w in dims]
    coords = t(_gather_coords(np_rng, B, P, dims, 4))
    want = ops.corr_lookup_ref(pyr, coords, 4)
    before = ops.corr_lookup(pyr, coords, 4)
    lv, scales = _int8_levels(np_rng, B, P, dims, cuda)
    ops.corr_lookup_q(lv, scales, coords, 4)
    after = ops.corr_lookup(pyr, coords, 4)
    _assert_same_bits(before, want)
    _assert_same_bits(after, want)


# level dims of the packed lookups' cases: the pyramid of a 12x20 map (rows
# of 20+10+5+2 = 37 values: 148, 74 and 37 bytes, no row but the first
# 8-byte aligned, level 3 one row of the map's 12), of a 13x21 map (38
# values a row) and 3 levels of rows of 52 values
PACKED_LEVELS = {
    "12x20": _pyramid_dims(12, 20),
    "13x21": _pyramid_dims(13, 21),
    "3 levels w30 w15 w7": [(12, 30), (6, 15), (3, 7)],
}


def _packed_volume(np_rng, form, dims, B, P, dev):
    """A tagged packed volume of random values: float32 or bfloat16, or int8
    with the extremes -128 and 127 and scales that are no powers of two."""
    if form == "int8":
        levels, scales = _int8_levels(np_rng, B, P, dims, dev)
        return ("packed_i8", *tcorr.pack_corr_pyramid(levels)[:1], scales, tuple(dims))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    levels = [t(np_rng.standard_normal((B, P, h, w))).to(DT[form]) for h, w in dims]
    return ("packed", *tcorr.pack_corr_pyramid(levels))


@pytest.mark.parametrize("shape", sorted(PACKED_LEVELS))
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
def test_packed_kernels_match_plain(np_rng, cuda, form, radius, shape):
    """K7 (f32, bf16) and K8 (int8) on the gather bit for bit against
    corr_lookup_packed(_i8)_ref: rows of the packed map that start at any
    byte, windows wholly and partly outside the maps (wild and uniform),
    local windows and round-up positions; B*P = 87 pixels."""
    dims = PACKED_LEVELS[shape]
    B, P = 3, 29
    stored = _packed_volume(np_rng, form, dims, B, P, cuda)
    coords = _gather_coords(np_rng, B, P, dims, radius)
    _assert_rounds_up(coords, len(dims), radius)
    coords = torch.from_numpy(coords).to(cuda)
    name = VOLUME_KERNELS[stored[0]]
    ops.reset_launch_counts()
    got = tcorr.corr_lookup(stored, coords, radius)
    assert ops.launch_counts()[name] == 1
    want = tcorr.corr_lookup(stored, coords, radius, plain=True)
    assert got.dtype == (torch.bfloat16 if form == "int8" else DT[form])
    assert got.shape == (B, P, len(dims) * (2 * radius + 1) ** 2)
    _assert_same_bits(got, want)


def test_gather_bits_unchanged_after_packed(np_rng, cuda):
    """K2 on bf16 levels and K6 on int8 levels give the plain versions' bits
    before and after K7 and K8 launches on the same levels packed (one
    shared gather, one level table)."""
    dims = PACKED_LEVELS["12x20"]
    B, P = 3, 29
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    pyr = [t(np_rng.standard_normal((B, P, h, w))).to(torch.bfloat16) for h, w in dims]
    lv, scales = _int8_levels(np_rng, B, P, dims, cuda)
    coords = t(_gather_coords(np_rng, B, P, dims, 4))
    want = (ops.corr_lookup_ref(pyr, coords, 4), ops.corr_lookup_q_ref(lv, scales, coords, 4))
    calls = (lambda: ops.corr_lookup(pyr, coords, 4),
             lambda: ops.corr_lookup_q(lv, scales, coords, 4))
    before = [call() for call in calls]
    packed, pdims = tcorr.pack_corr_pyramid(pyr)
    packed_i8, _ = tcorr.pack_corr_pyramid(lv)
    _assert_same_bits(ops.corr_lookup_packed(packed, pdims, coords, 4), want[0])
    _assert_same_bits(ops.corr_lookup_packed_i8(packed_i8, scales, pdims, coords, 4), want[1])
    after = [call() for call in calls]
    for b, a, w in zip(before, after, want):
        _assert_same_bits(b, w)
        _assert_same_bits(a, w)


def test_gather_bits_unchanged_after_folded(np_rng, cuda):
    """K2, #9 and K1 (bf16, on the tensor cores) on dense levels, K6 on int8
    levels and K7, K8 on them packed give the plain versions' bits before
    and after #4 launches on the same values folded (one shared gather, one
    level table with the pixel strides #4 added). K1 reads one sample per
    output channel (weights +-1 on the diagonal, no bias), so its sums are
    exact."""
    dims = [(8, 12), (4, 6), (2, 3), (1, 1)]
    B, P = 3, 29
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    pyr = [t(np_rng.standard_normal((B, P, h, w))).to(torch.bfloat16) for h, w in dims]
    lv, scales = _int8_levels(np_rng, B, P, dims, cuda)
    packed, pdims = tcorr.pack_corr_pyramid(pyr)
    packed_i8, _ = tcorr.pack_corr_pyramid(lv)
    coords = t(_gather_coords(np_rng, B, P, dims, 4))
    wc = torch.zeros((324, 256), device=cuda)
    f = torch.arange(256, device=cuda)
    wc[f, f] = torch.where(f % 2 == 0, 1.0, -1.0)
    bias = torch.zeros(256, device=cuda)
    calls = (lambda: ops.corr_lookup(pyr, coords, 4),
             lambda: ops.corr_lookup_mixed([], (), pyr, coords, 4),
             lambda: ops.corr_lookup_q(lv, scales, coords, 4),
             lambda: ops.corr_lookup_packed(packed, pdims, coords, 4),
             lambda: ops.corr_lookup_packed_i8(packed_i8, scales, pdims, coords, 4),
             lambda: ops.corr_lookup_fused(pyr, coords, wc, bias, 4))
    want = (ops.corr_lookup_ref(pyr, coords, 4),
            ops.corr_lookup_mixed_ref([], (), pyr, coords, 4),
            ops.corr_lookup_q_ref(lv, scales, coords, 4),
            ops.corr_lookup_packed_ref(packed, pdims, coords, 4),
            ops.corr_lookup_packed_i8_ref(packed_i8, scales, pdims, coords, 4),
            ops.corr_lookup_fused_ref(pyr, coords, wc, bias, 4))
    before = [call() for call in calls]
    folded = []
    for lvl, (h, w) in zip(pyr, dims):
        row = torch.zeros((B, P, 128), dtype=lvl.dtype, device=cuda)
        row[..., :h * w] = lvl.reshape(B, P, h * w)
        folded.append(row.view(B, P, 1, 128))
    _assert_same_bits(ops.corr_lookup_folded(folded, dims, coords, 4), want[0])
    after = [call() for call in calls]
    for b, a, w in zip(before, after, want):
        _assert_same_bits(b, w)
        _assert_same_bits(a, w)


# (folded (h, w) with fold*w = 128, plain (h, w)) of the mixed lookup's cases
MIXED_LEVELS = {
    "1 folded + 2 plain w15 w7": ([(8, 32)], [(5, 15), (3, 7)]),
    "2 folded + 2 plain": ([(16, 32), (8, 16)], [(4, 8), (2, 4)]),
    "1 folded": ([(4, 64)], []),
    "1 plain w30": ([], [(9, 30)]),
}


@pytest.mark.parametrize("levels", sorted(MIXED_LEVELS))
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_mixed_kernel_matches_plain(np_rng, cuda, dtype, radius, levels):
    """#9 (corr_gather.cu) bit for bit against corr_lookup_mixed_ref on the
    gather's edge cases, with folded levels of 1 to 4 rows of 128 values;
    B*P = 87 pixels."""
    fdims, pdims = MIXED_LEVELS[levels]
    B, P = 3, 29
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    folded = [t(np_rng.standard_normal((B, P, h * w // 128, 128))).to(DT[dtype])
              for h, w in fdims]
    padded = [t(np_rng.standard_normal((B, P, h, w))).to(DT[dtype]) for h, w in pdims]
    dims = fdims + pdims
    coords = _gather_coords(np_rng, B, P, dims, radius)
    _assert_rounds_up(coords, len(dims), radius)
    ops.reset_launch_counts()
    got = ops.corr_lookup_mixed(folded, fdims, padded, t(coords), radius)
    assert ops.launch_counts()["corr_lookup_mixed"] == 1
    want = ops.corr_lookup_mixed_ref(folded, fdims, padded, t(coords), radius)
    assert got.dtype == DT[dtype] and got.shape == (B, P, len(dims) * (2 * radius + 1) ** 2)
    torch.testing.assert_close(got, want, **EXACT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernel_samples_match_plain(np_rng, cuda, dtype):
    """K1 (corr_lookup.cu) with each output channel f reading one window
    sample (wc[k, f] = +-1 for k = f, else 0; no bias): every f32 sum is
    exact, so K1's samples must equal the plain version's bit for bit, on
    the gather's edge-case coordinates."""
    B, P = 3, 29
    dims = [(16, 30), (8, 15), (4, 7), (2, 3)]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    pyr = [t(np_rng.standard_normal((B, P, h, w))).to(DT[dtype]) for h, w in dims]
    coords = t(_gather_coords(np_rng, B, P, dims, 4))
    wc = torch.zeros((324, 256), device=cuda)
    f = torch.arange(256, device=cuda)
    wc[f, f] = torch.where(f % 2 == 0, 1.0, -1.0)
    bias = torch.zeros(256, device=cuda)
    got = ops.corr_lookup_fused(pyr, coords, wc, bias, 4)
    want = ops.corr_lookup_fused_ref(pyr, coords, wc, bias, 4)
    assert got.dtype == DT[dtype] and got.shape == (B, P, 256)
    torch.testing.assert_close(got, want, **EXACT)
    samples = ops.corr_lookup(pyr, coords, 4)[..., :256]
    torch.testing.assert_close(got, torch.relu(samples.float() * wc[f, f]).to(got.dtype),
                               **EXACT)


# the update block's convs with their channels cut by 4 (Cout 2 kept):
# (Cout, Cin, kh, kw)
CONV_SHAPES = [(64, 81, 1, 1), (48, 64, 3, 3), (16, 32, 3, 3), (32, 64, 3, 3),
               (64, 96, 1, 5), (32, 96, 5, 1), (64, 32, 3, 3), (2, 64, 3, 3)]


def _check_conv(np_rng, dev, shape, dtype, act, channel_last, H=12, W=20):
    """One conv of 2 images through the kernel, one launch (on the tensor
    cores in bf16), against the plain version."""
    Cout, Cin, kh, kw = shape
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    x = t(np_rng.standard_normal((2, Cin, H, W))).to(DT[dtype])
    if channel_last:
        x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    w = t(np_rng.standard_normal((Cout, Cin, kh, kw)) / np.sqrt(Cin * kh * kw))
    b = t(np_rng.standard_normal((Cout,)) * 0.1)
    pad = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    ops.reset_launch_counts()
    got = ops.conv_pallas(x, w.to(DT[dtype]), b, pad, act=act)
    assert ops.launch_counts()["conv_pallas"] == 1
    assert ops.tensor_core_launch_counts()["conv_pallas"] == (dtype == "bfloat16")
    want = ops.conv_pallas_ref(x, w.to(DT[dtype]), b, pad, act=act)
    assert got.dtype == DT[dtype] and got.shape == (2, Cout, H, W)
    if dtype == "bfloat16":
        mag = ops.conv_pallas_magnitude(x, w.to(DT[dtype]), pad)
        _assert_within_bound(got, want, mag, Cin * kh * kw)
    else:
        torch.testing.assert_close(got, want, **EXACT)


@pytest.mark.parametrize("act", [None, "relu", "sigmoid", "tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_plain(np_rng, cuda, shape, dtype, act):
    """2 images of 12x20 (ragged pixel tiles, rows not 16-byte aligned),
    SAME padding; the 1x1 case reads a channel-last (permuted) input, as
    convc1 reads the lookup; Cin = 81 is a ragged channel chunk."""
    _check_conv(np_rng, cuda, shape, dtype, act, channel_last=shape[2] == shape[3] == 1)


def test_conv_kernel_bf16_to_float32_output(np_rng, cuda):
    """bf16 inputs with a float32 output (``out_dtype``): the same tensor-core
    sum, cast once to float32, within the bound of the plain version."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(np_rng.standard_normal((2, 64, 12, 20))).bfloat16()
    w = t(np_rng.standard_normal((48, 64, 3, 3)) / 24.0).bfloat16()
    b = t(np_rng.standard_normal((48,)) * 0.1)
    pad = ((1, 1), (1, 1))
    ops.reset_launch_counts()
    got = ops.conv_pallas(x, w, b, pad, act="tanh", out_dtype=torch.float32)
    assert ops.tensor_core_launch_counts()["conv_pallas"] == 1
    want = ops.conv_pallas_ref(x, w, b, pad, act="tanh", out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _assert_within_bound(got, want, ops.conv_pallas_magnitude(x, w, pad), 64 * 9)


@pytest.mark.parametrize("layout", ["nchw", "channel_last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", [((192, 256, 3, 3), "relu"), ((2, 256, 3, 3), None)])
def test_conv_kernel_full_width(np_rng, cuda, shape, act, dtype, layout):
    """convc2 (256 -> 192, 3x3, relu) and the flow head's 256 -> 2 at the
    frame's 64x64 maps, 2 images, on NCHW and on channel-last inputs."""
    _check_conv(np_rng, cuda, shape, dtype, act, layout == "channel_last", H=64, W=64)


@pytest.mark.parametrize("key,value", [("corr_method", "fold"), ("corr_method", "mixed"),
                                       ("conv_backend", "pallas")])
def test_mft_new_paths_launch_their_kernels(cuda, key, value):
    """Per tracked frame with 3 iterations: 'fold' one build and 3 folded
    lookups, 'mixed' 3 mixed lookups, conv_backend 'pallas' 2 fused lookups,
    1 lookup and 3*9 + 1 convs (convc1 on the last iteration); each one
    chain + select."""
    cfg = default_config()
    cfg.flow_config.flow_iters = 3
    cfg.flow_config.raft_params[key] = value
    tracker = MFT(cfg, device=cuda)
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    ops.reset_launch_counts()
    tracker.init(tex[:64, :64])
    for k in range(1, 3):
        res = tracker.track(np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64])).result
        assert res.flow.shape == (64, 64, 2) and bool(torch.isfinite(res.flow).all())
    per_frame = {"fold": dict(corr_build_folded=1, corr_lookup_folded=3),
                 "mixed": dict(corr_lookup_mixed=3),
                 "pallas": dict(corr_lookup_fused=2, corr_lookup=1, conv_pallas=28)}[value]
    want = {k: 0 for k in ops.launch_counts()}
    want.update({k: 2 * v for k, v in per_frame.items()}, chain_select=2)
    assert ops.launch_counts() == want


def _warp_inputs(np_rng, dev, N=3, H=37, W=45, C=6):
    """Maps, and coordinates: the grid plus U(-3, 3), a third of the pixels
    anywhere up to 10 px beyond the map, a third at half-integer shifts or
    odd multiples of 1/512 (the snap's ties)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    maps = t(4 * np_rng.standard_normal((N, H, W, C)))
    g = np.mgrid[0:H, 0:W].transpose(1, 2, 0)[..., ::-1].reshape(1, H * W, 2)
    c = g + np_rng.uniform(-3, 3, (N, H * W, 2))
    k = np_rng.integers(0, 3, (N, H * W, 1))
    wild = np_rng.uniform(0, 1, (N, H * W, 2)) * [W + 20, H + 20] - 10
    ties = g + np_rng.integers(-4, 5, (N, H * W, 2)) * 0.5 + np_rng.choice(
        [0.0, 1 / 512, 3 / 512, -5 / 512], (N, H * W, 2))
    c = np.where(k == 0, wild, np.where(k == 1, ties, c))
    return maps, t(c)


@pytest.mark.parametrize("C", [1, 4, 6, 16])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("map_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["exact", "tpu", "snap", "bf16"])
def test_warp_kernel_matches_plain(np_rng, cuda, mode, map_dtype, planar, C):
    """mft_warp equals its plain version bit for bit in every mode, with f32
    and bf16 maps, channel-last (staged) and planar output, at the compiled
    channel counts (1, 4, 6) and the generic instance (16); 3 x 1665 pixels
    leave a ragged block of 131."""
    maps, coords = _warp_inputs(np_rng, cuda, C=C)
    maps = maps.to(DT[map_dtype])
    got = ops.bilinear_warp(maps, coords, mode, planar=planar)
    want = ops.bilinear_warp_ref(maps, coords, mode, planar=planar)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, **EXACT)


@pytest.mark.parametrize("C", [1, 2, 4, 6, 16])
@pytest.mark.parametrize("layout", ["pairs", "strided", "planes", "offset maps"])
def test_warp_kernel_coordinate_layouts(np_rng, cuda, layout, C):
    """Bit for bit with the plain version whatever the coordinates' layout:
    (N, P, 2) pairs (one 8-byte load), pairs at a stride of 3 from an odd
    offset (two loads), separate x and y planes; and maps that do not start
    16-byte aligned (the generic instance), in 'tpu' mode on bf16 maps and
    'exact' mode on f32 maps."""
    maps, coords = _warp_inputs(np_rng, cuda, C=C)
    N, P = coords.shape[:2]
    if layout == "strided":
        buf = torch.zeros((N, P, 3), device=cuda)
        buf[..., 1:] = coords
        coords = buf[..., 1:]
    elif layout == "planes":
        coords = (coords[..., 0].contiguous(), coords[..., 1].contiguous())
    for mode, dtype in (("tpu", torch.bfloat16), ("exact", torch.float32)):
        m = maps.to(dtype)
        if layout == "offset maps":
            flat = torch.empty(m.numel() + 1, dtype=dtype, device=cuda)
            m = flat[1:].view(m.shape).copy_(m)
            assert m.data_ptr() % 16 and m.is_contiguous()
        got = ops.bilinear_warp(m, coords, mode)
        want = ops.bilinear_warp_ref(m, coords, mode)
        torch.testing.assert_close(got, want, **EXACT)


def test_warp_entry_points_launch_once(np_rng, cuda):
    """Each JAX entry point is one launch, equal to the plain version; the
    tiled one writes its C planes and shared coordinates broadcast."""
    N, H, W, C = 2, 32, 64, 6
    maps, coords = _warp_inputs(np_rng, cuda, N, H, W, C)
    maps = maps.bfloat16()
    sx, sy = coords[..., 0].reshape(N, H, W), coords[..., 1].reshape(N, H, W)
    ops.reset_launch_counts()
    outs = [ops.bilinear_warp_pallas(maps, coords), ops.bilinear_warp_banded(maps, coords),
            ops.bilinear_warp_blocked(maps, coords),
            torch.stack(ops.bilinear_warp_tiled(maps, sx, sy), -1).reshape(N, H * W, C)]
    assert ops.launch_counts()["bilinear_warp"] == 4
    want = ops.bilinear_warp_ref(maps, coords, "tpu")
    for got in outs:
        torch.testing.assert_close(got, want, **EXACT)
    shared = coords[:1].expand(N, -1, -1)
    torch.testing.assert_close(ops.bilinear_warp(maps, shared, "exact"),
                               ops.bilinear_warp_ref(maps, coords[:1].repeat(N, 1, 1), "exact"),
                               **EXACT)


def test_slice_path_launches_the_warp(cuda):
    """Point tracking and chain_select_pallas on a tracker's results: one
    warp launch each, equal to the plain versions; tracked frames launch no
    warp."""
    from mft_tpu_torch.tracker.fused import chain_select_pallas
    from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking_batch
    cfg = default_config()
    cfg.flow_config.flow_iters = 2
    tracker = MFT(cfg, device=cuda)
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64]) for k in range(4)]
    ops.reset_launch_counts()
    tracker.init(frames[0])
    results = [tracker.track(f).result for f in frames[1:3]]
    assert ops.launch_counts()["bilinear_warp"] == 0
    q = rng.uniform(-2, 66, (50, 2)).astype(np.float32)
    got = convert_to_point_tracking_batch(results, q)
    assert ops.launch_counts()["bilinear_warp"] == 1
    want = convert_to_point_tracking_batch(results, q, plain=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    left, right, valid, _ = tracker.pairs(tracker._to_device(frames[3]), 3)
    ops.reset_launch_counts()
    a = chain_select_pallas(left, right, valid)
    assert ops.launch_counts() == {**{k: 0 for k in ops.launch_counts()}, "bilinear_warp": 1}
    b = chain_select_pallas(left, right, valid, plain=True)
    for name in ("flow", "occlusion", "sigma"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), **EXACT)


# --------------------------------------------------------------------------- #
# the stored volumes sliced to a batch prefix (per-pair iteration schedules)
# --------------------------------------------------------------------------- #
SLICED_FORMS = ("volume", "fused", "mixed", "packed", "packed_i8")


def _sliced_volume(np_rng, form, m, dev, B=7, H8=8, W8=32, C=64):
    """A bf16 volume of 7 pairs of random features (an 8x32 map: 'mixed'
    folds level 0, 4 rows per 128 values; packed widths 32+16+8+4) in the
    form the model stores for ``form``, sliced to its first ``m`` pairs as
    ``raft.slice_pyramid`` slices it, and (m, P, 2) coords."""
    from mft_tpu_torch.models.raft.raft import slice_pyramid
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    f1 = t(np_rng.standard_normal((B, C, H8, W8))).to(torch.bfloat16)
    f2 = t(np_rng.standard_normal((B, C, H8, W8))).to(torch.bfloat16)
    if form == "mixed":
        stored = tcorr.build_corr_pyramid_mixed(f1, f2)
        assert len(stored[1]) == 1
    else:
        stored = tcorr.build_corr_pyramid(f1, f2)
        if form in ("packed", "packed_i8"):
            pack = tcorr.pack_corr_pyramid if form == "packed" else tcorr.pack_corr_pyramid_i8
            stored = (form, *pack(stored))
    coords = _gather_coords(np_rng, m, H8 * W8, _pyramid_dims(H8, W8), 4)
    return slice_pyramid(stored, m), torch.from_numpy(coords).to(dev)


@pytest.mark.parametrize("m", [1, 3, 6])
@pytest.mark.parametrize("form", SLICED_FORMS)
def test_sliced_volume_lookups_match_plain(np_rng, cuda, form, m):
    """K2, #9, K7 and K8 bit for bit, K1 (bf16, tensor cores) within the
    bound, on volumes of 7 pairs sliced to m = 1, 3 and 6 (B taken from the
    coords and the sliced levels, the scales of 'packed_i8' sliced with
    them); one launch each."""
    stored, coords = _sliced_volume(np_rng, form, m, cuda)
    if form == "fused":
        wc = torch.from_numpy(np_rng.standard_normal((256, 324)).astype(np.float32) * 0.05)
        bias = torch.from_numpy(np_rng.standard_normal(256).astype(np.float32) * 0.1)
        _check_fused(stored, coords, wc.to(cuda).t(), bias.to(cuda), 4, "bfloat16")
        return
    name = {"volume": "corr_lookup", "mixed": "corr_lookup_mixed",
            "packed": "corr_lookup_packed", "packed_i8": "corr_lookup_packed_i8"}[form]
    ops.reset_launch_counts()
    got = tcorr.corr_lookup(stored, coords, 4)
    assert ops.launch_counts()[name] == 1
    want = tcorr.corr_lookup(stored, coords, 4, plain=True)
    assert got.shape == (m, 256, 324)
    _assert_same_bits(got, want)


def test_raftflow_loads_msgpack_on_the_card(cuda, tmp_path):
    """synth_flow_config() loads the committed weights on the card: the same
    float32 state as on the CPU (bf16 convs, float32 norms and routed
    biases), a finite flow of one pair; a truncated copy raises."""
    from mft_tpu_torch.config import synth_flow_config
    from mft_tpu_torch.models.raft import RAFTFlow
    conf = synth_flow_config()
    flower = RAFTFlow(conf, device=cuda)
    ref = RAFTFlow(conf, device="cpu")
    for k, v in ref.model.state_dict().items():
        assert torch.equal(flower.model.state_dict()[k].cpu(), v), k
    rng = np.random.default_rng(0)
    tex = (rng.random((72, 72, 3)) * 255).astype(np.uint8)
    flow, extra = flower.compute_flow(tex[:64, :64], tex[2:66, 3:67])
    assert flow.device.type == "cuda" and bool(torch.isfinite(flow).all())
    bad = tmp_path / "w.msgpack"
    bad.write_bytes(open(conf.model, "rb").read()[:-100])
    conf.model = str(bad)
    with pytest.raises(ValueError, match="truncated"):
        RAFTFlow(conf, device=cuda)


def test_mft_scheduled_path_launches_each_kernel(cuda):
    """A scheduled warm MFT run on the card: the schedule {inf: 4, 1: 1, 2: 4,
    4: 4} sorts to (4, 4, 4, 1), pairs end after iterations 1 and 4, so per
    frame 2 fused lookups (iterations 2, 3), 2 plain ones, 1 chain + select;
    the timer step runs the same kernels."""
    cfg = default_config()
    cfg.deltas = [np.inf, 1, 2, 4]
    cfg.flow_iters_schedule = {np.inf: 4, 1: 1, 2: 4, 4: 4}
    cfg.warm_start_inf = True
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    for timers in (False, True):
        cfg.timers_enabled = timers
        tracker = MFT(cfg, device=cuda)
        ops.reset_launch_counts()
        tracker.init(tex[:64, :64])
        for k in range(1, 4):
            meta = tracker.track(np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64]))
            assert bool(torch.isfinite(meta.result.flow).all())
        want = {k: 0 for k in ops.launch_counts()}
        want.update(corr_lookup_fused=6, corr_lookup=6, chain_select=3)
        assert ops.launch_counts() == want
        assert timers == hasattr(meta, "phase_ms")


@pytest.mark.parametrize("m", [1, 2, 4, 7])
def test_fused_kernel_plain_order_at_every_row_count(np_rng, cuda, m):
    """K1 (bf16, tensor cores) against its plain version on a volume of 7
    pairs sliced to its first m: 0 outputs differ (the plain product sums in
    the order of K1's repair at every row count), and each side's rows equal
    the whole 7-pair call's."""
    stored, coords = _sliced_volume(np_rng, "volume", 7, cuda)
    wc = torch.from_numpy(np_rng.standard_normal((256, 324)).astype(np.float32) * 0.05)
    wc, bias = wc.to(cuda).t(), torch.from_numpy(
        np_rng.standard_normal(256).astype(np.float32) * 0.1).to(cuda)
    whole = (ops.corr_lookup_fused(stored, coords, wc, bias, 4),
             ops.corr_lookup_fused_ref(stored, coords, wc, bias, 4))
    sliced = [lvl[:m] for lvl in stored]
    got = ops.corr_lookup_fused(sliced, coords[:m].contiguous(), wc, bias, 4)
    want = ops.corr_lookup_fused_ref(sliced, coords[:m].contiguous(), wc, bias, 4)
    _assert_same_bits(got, want)
    _assert_same_bits(got, whole[0][:m])
    _assert_same_bits(want, whole[1][:m])


def test_flow_cache_round_trip_of_cuda_tensors(cuda, tmp_path):
    """CUDA tensors fill the device tier and read back as the same tensors;
    backup_to_disk writes them as .flowouX16.pkl files, which reload within
    the codec's quantisation step; FlowOU.write takes CUDA tensors too."""
    from mft_tpu_torch.core.flowou import FlowOU
    from mft_tpu_torch.io import FlowCache
    gen = torch.Generator(device=cuda).manual_seed(0)
    flow = torch.randn((40, 56, 2), device=cuda, generator=gen) * 8
    occl = torch.rand((40, 56), device=cuda, generator=gen)
    sigma = torch.rand((40, 56), device=cuda, generator=gen) * 20
    cache = FlowCache(tmp_path / "c")
    cache.write(3, 4, flow, occl, sigma)
    assert cache.read(3, 4) is cache.device_cache[(3, 4)] and not cache.ram_cache
    cache.backup_to_disk()
    reloaded = FlowCache(tmp_path / "c")
    reloaded.load_from_disk()
    FlowOU(flow, occl, sigma).write(tmp_path / "r.flowouX16.pkl")
    back = FlowOU.read(tmp_path / "r.flowouX16.pkl", device=cuda)
    for x, y, z in zip((flow, occl, sigma), reloaded.read(3, 4),
                       (back.flow, back.occlusion, back.sigma)):
        step = float(x.max() - x.min()) / 65535
        assert float((torch.from_numpy(y).to(cuda) - x).abs().max()) <= step
        assert z.is_cuda and torch.equal(z.cpu(), torch.from_numpy(y))


def test_mft_cache_paths_launch_their_kernels(cuda):
    """The tracker under a FlowCache on the card: a cold pass (the whole
    batch, K1 11 / K2 1 / K3 1 a frame, cache rows written as CUDA
    tensors), an injected pass (the template pair alone: the same counts),
    a cache_delta_infinity pass twice (the second RAFT-free: K3 only);
    track_chunk equal to per-frame track bit for bit."""
    from mft_tpu_torch.io import FlowCache
    cfg = default_config()
    cfg.deltas = [np.inf, 1, 2]
    rng = np.random.default_rng(0)
    tex = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64]) for k in range(5)]
    tracker = MFT(cfg, device=cuda)
    cache = FlowCache(None)
    per_frame = {}
    for name, cdi, raft in (("cold", False, 4), ("warm", False, 4), ("cdi", True, 2),
                            ("free", True, 0)):
        cfg.cache_delta_infinity = cdi
        ops.reset_launch_counts()
        tracker.init(frames[0], flow_cache=cache)
        per_frame[name] = [tracker.track(f).result for f in frames[1:]]
        want = {k: 0 for k in ops.launch_counts()}
        want.update(corr_lookup_fused=11 * raft, corr_lookup=raft, chain_select=4)
        assert ops.launch_counts() == want, name
    assert all(x.is_cuda for v in cache.device_cache.values() for x in v)
    for a, b in zip(per_frame["free"], per_frame["cdi"]):
        assert torch.equal(a.flow, b.flow) and torch.equal(a.sigma, b.sigma)
    cfg.cache_delta_infinity = False
    tracker.init(frames[0])
    chunked = tracker.track_chunk(frames[1:4]) + tracker.track_chunk(frames[4:])
    tracker.init(frames[0])
    for a, img in zip(chunked, frames[1:]):
        b = tracker.track(img).result
        assert torch.equal(a.result.flow, b.flow) and torch.equal(a.result.occlusion, b.occlusion)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_model_lookup_and_backward_match_plain(np_rng, cuda, dtype):
    """K2 and its backward at the small model's radius 3 on a 7-pair volume
    of 16x24 pixels (levels 16x24 .. 2x3): the 196 samples a pixel and the
    (2r+2)^2 = 64 box values a pixel's gradient stages, bit for bit with the
    plain versions; the autograd function's level gradients equal to the
    plain backward's."""
    B, H8, W8 = 7, 16, 24
    pyr, coords, _, _ = _lookup_inputs(np_rng, dtype, cuda, B=B, H8=H8, W8=W8, radius=3)
    pyr = [torch.from_numpy(np_rng.standard_normal((B, H8 * W8, H8 >> l, W8 >> l)).astype(
        np.float32)).to(cuda).to(DT[dtype]) for l in range(4)]
    ops.reset_launch_counts()
    got = ops.corr_lookup(pyr, coords, 3)
    assert ops.launch_counts()["corr_lookup"] == 1 and got.shape == (B, H8 * W8, 196)
    assert torch.equal(got, ops.corr_lookup_ref(pyr, coords, 3))
    dims = [tuple(lvl.shape[2:]) for lvl in pyr]
    g = torch.from_numpy(np_rng.standard_normal((B, H8 * W8, 196)).astype(np.float32))
    g = g.to(cuda).to(DT[dtype])
    bwd = ops.corr_lookup_bwd(g, coords, dims, 3)
    assert ops.launch_counts()["corr_lookup_bwd"] == 1
    for a, b in zip(bwd, ops.corr_lookup_bwd_ref(g, coords, dims, 3)):
        assert torch.equal(a, b)
    levels = [lvl.clone().requires_grad_() for lvl in pyr]
    ops.corr_lookup(levels, coords, 3).backward(g)
    for lvl, b in zip(levels, bwd):
        assert torch.equal(lvl.grad, b)


@pytest.mark.parametrize("radius", [4, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_backward_kernel_matches_plain(np_rng, cuda, dtype, radius):
    """The backward kernel against its plain version: the same four products
    per map position summed in the same order, rounded once: bit for bit in
    both dtypes; every value of every map written; one launch; even widths,
    odd ones (chunks across rows and pixels) and maps whose size a pixel is
    no multiple of 16 bytes (5x12 in bf16: 120 bytes), pixel counts with and
    without a partial group of 8 (120, 70, 180)."""
    for B, H8, W8 in ((2, 6, 10), (2, 5, 7), (3, 5, 12)):
        pyr, coords, _, _ = _lookup_inputs(np_rng, dtype, cuda, B=B, H8=H8, W8=W8,
                                           radius=radius)
        coords[0, :8] = torch.round(coords[0, :8])
        dims = [tuple(lvl.shape[2:]) for lvl in pyr]
        C = len(dims) * (2 * radius + 1) ** 2
        g = torch.from_numpy(np_rng.standard_normal((*coords.shape[:2], C)).astype(np.float32))
        g = g.to(cuda).to(DT[dtype])
        ops.reset_launch_counts()
        got = ops.corr_lookup_bwd(g, coords, dims, radius)
        assert ops.launch_counts()["corr_lookup_bwd"] == 1
        want = ops.corr_lookup_bwd_ref(g, coords, dims, radius)
        for a, b in zip(got, want):
            assert a.dtype == DT[dtype] and a.shape == b.shape
            assert torch.equal(a, b)
        if dtype == "bfloat16":   # within one bf16 rounding of the f32 result
            want32 = ops.corr_lookup_bwd_ref(g.float(), coords, dims, radius)
            for a, b in zip(got, want32):
                assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_function_gradients_on_the_card(np_rng, cuda, dtype):
    """The autograd function on the card: forward K2 and backward
    mft_corr_lookup_bwd (one launch each), its level gradients equal to the
    plain route's autograd (plain forward and backward) and, in f32, to
    autograd through the plain gather within 1e-6 (another summation order);
    coordinates that require a gradient raise."""
    pyr, coords, _, _ = _lookup_inputs(np_rng, dtype, cuda)
    levels = [lvl.clone().requires_grad_() for lvl in pyr]
    g = torch.from_numpy(np_rng.standard_normal((*coords.shape[:2], 324)).astype(np.float32))
    g = g.to(cuda).to(DT[dtype])
    ops.reset_launch_counts()
    out = ops.corr_lookup(levels, coords, 4)
    grads = torch.autograd.grad(out, levels, g)
    assert ops.launch_counts()["corr_lookup"] == 1
    assert ops.launch_counts()["corr_lookup_bwd"] == 1
    plain = torch.autograd.grad(ops.corr_lookup(levels, coords, 4, plain=True), levels, g)
    assert ops.launch_counts()["corr_lookup_bwd"] == 1
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    if dtype == "float32":
        gather = torch.autograd.grad(ops.corr_lookup_ref(levels, coords, 4), levels, g)
        for a, b in zip(grads, gather):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="coordinate gradient"):
        ops.corr_lookup(levels, coords.clone().requires_grad_(), 4)


def test_train_step_on_the_card(cuda):
    """Two full-recipe steps at 128x128 (batch 2, 3 iterations, bf16 compute
    over f32 parameters): finite losses, 3 K2 and 3 backward launches a
    step, every weight and batch statistic moved, and the plain route
    launching none."""
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.models.raft.raft import RAFTParams
    from mft_tpu_torch.models.raft.wrapper import random_init
    from mft_tpu_torch.train import synth
    from mft_tpu_torch.train.loop import make_train_step
    from mft_tpu_torch.train.optim import make_optimizer
    model = random_init(RAFT(RAFTParams(), train_mode=True), 0).to(cuda)
    model.cast_per_call(torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx, _ = make_optimizer(lr=1e-3, num_steps=10)
    state = {"model": model, "opt_state": tx.init(dict(model.named_parameters())), "step": 0}
    lk = dict(gamma=0.85, freeze_optical_flow=False)
    step = make_train_step(model, tx, lk, iters=3)
    batch = tuple(torch.from_numpy(b).to(cuda) for b in
                  synth.make_batch(np.random.default_rng(0), 2, 128, 128, T=3))
    for _ in range(2):
        ops.reset_launch_counts()
        state, metrics = step(state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        counts = ops.launch_counts()
        assert counts["corr_lookup"] == 3 and counts["corr_lookup_bwd"] == 3
    after = model.state_dict()
    moved = [k for k in after if k.endswith(("weight", "running_mean", "running_var"))]
    assert all(not torch.equal(after[k], before[k]) for k in moved), "a tensor did not move"
    ops.reset_launch_counts()
    make_train_step(model, tx, lk, iters=3, plain=True)(state, batch)
    assert all(n == 0 for n in ops.launch_counts().values())


SPLAT_ATOL = 1e-3        # in 0-255 units: chip_smoke.py phase 17a's gate


def test_forward_splat_on_the_card_matches_cpu(np_rng, cuda):
    """``FlowOU.warp_forward`` of a 0-255 edit and of its mask: the card's
    float atomics add in no fixed order, so the gate is a tolerance; the
    uint8 edit frames (the demo's ``draw_edit``) within 1 level."""
    from mft_tpu_torch.apps import demo
    from mft_tpu_torch.core import FlowOU
    H, W = 96, 128
    flow = np_rng.normal(0.0, 4.0, (H, W, 2)).astype(np.float32)
    zeros = np.zeros((H, W), np.float32)
    frame = (np_rng.random((H, W, 3)) * 255).astype(np.uint8)
    edit = demo.make_default_edit(frame)
    mask = edit.any(axis=2)
    results = [FlowOU(*(torch.from_numpy(a).to(d) for a in (flow, zeros, zeros)))
               for d in (cuda, torch.device("cpu"))]
    got, want = (r.warp_forward(edit.astype(np.float32), mask=mask, border=0.0)
                 for r in results)
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= SPLAT_ATOL
    got, want = (r.warp_forward(mask.astype(np.float32)[..., None], border=0.0)
                 for r in results)
    assert float((got.cpu() - want).abs().max()) <= SPLAT_ATOL / 255
    a, b = (demo.draw_edit(frame, r, edit, mask) for r in results)
    assert np.abs(a.astype(int) - b).max() <= 1


def test_demo_launches_per_frame(tmp_path, cuda):
    """The demo on the card, 3 frames of 128x128 on default_config(): K1 11,
    K2 1, K3 1 a tracked frame, one warp a point conversion (frame 0's too),
    one J3 and one J1 encode a JPEG frame written (two directories)."""
    from mft_tpu_torch.apps import demo
    from mft_tpu_torch.io.png import encode_png
    rng = np.random.default_rng(0)
    tex = (rng.random((140, 140, 3)) * 255).astype(np.uint8)
    (tmp_path / "clip").mkdir()
    for k in range(3):
        (tmp_path / "clip" / f"{k:03d}.png").write_bytes(
            encode_png(np.ascontiguousarray(tex[k:k + 128, 2 * k:2 * k + 128])))
    ops.reset_launch_counts()
    n = demo.main(["--video", str(tmp_path / "clip"), "--out", str(tmp_path / "out")])
    counts = ops.launch_counts()
    assert n == 3
    want = {k: 0 for k in counts}
    want.update(corr_lookup_fused=22, corr_lookup=2, chain_select=2, bilinear_warp=3,
                jpeg_encode_pixels=6, jpeg_huff_encode=6)
    assert counts == want
    assert len(list((tmp_path / "out" / "clip_points").iterdir())) == 3


# --------------------------------------------------------------------------- #
# JPEG: J1 (host entropy coding), J2 (decode pixels), J3 (encode pixels)
# --------------------------------------------------------------------------- #
def _jpeg_frames(np_rng, N, H, W, C):
    """Smooth texture plus noise: every coefficient band, runs of zeros."""
    y, x = np.mgrid[:H, :W]
    base = 127 + 60 * np.sin(x / 5.0)[..., None] * np.cos(y / 7.0)[..., None]
    img = base + np_rng.normal(0, 25, (N, H, W, 3))
    return np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8)[..., :C])


@pytest.mark.parametrize("quality", [15, 95])
@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444", "grey"])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (128, 96)])
def test_jpeg_pixel_kernels_match_plain(np_rng, cuda, shape, sampling, quality):
    """J3's coefficients and J2's pixels bit for bit with the plain versions,
    a batch of 3 frames in one launch each."""
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    C = 1 if sampling == "grey" else 3
    img = _jpeg_frames(np_rng, 3, *shape, C)
    geom = J.geometry_for(*shape, C, "420" if C == 1 else sampling)
    qtabs, recips = J._tables(geom, quality)
    ops.reset_launch_counts()
    got = OJ.jpeg_encode_pixels(torch.from_numpy(img).to(cuda), torch.from_numpy(recips).to(cuda),
                                geom)
    want = J.encode_pixels_ref(img, recips, geom)
    assert np.array_equal(got.cpu().numpy(), want)
    q = np.ascontiguousarray(np.broadcast_to(qtabs, (3,) + qtabs.shape))
    pix = OJ.jpeg_decode_pixels(got, torch.from_numpy(q).to(cuda), geom)
    torch.cuda.synchronize()
    assert np.array_equal(pix.cpu().numpy(), J.decode_pixels_ref(want, q, geom))
    assert ops.launch_counts() == {**{k: 0 for k in ops.launch_counts()},
                                   "jpeg_decode_pixels": 1, "jpeg_encode_pixels": 1}


def _jpeg_encode(img, quality, sampling, restart, device):
    """encode_jpeg's steps at any sampling and restart interval (the entry
    point writes cv2's default, 4:2:0 without restarts)."""
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    geom = J.geometry_for(*img.shape, sampling)
    qtabs, recips = J._tables(geom, quality)
    coefs = OJ.jpeg_encode_pixels(torch.from_numpy(img[None]).to(device),
                                  torch.from_numpy(recips).to(device), geom)[0].cpu().numpy()
    mcux, mcuy = J.scan_mcus(geom)
    body = OJ.jpeg_huff_encode(coefs, J.encode_comp_info(geom), J.STD_CODE_TABLES, mcux, mcuy,
                               restart, device)
    return J.file_header(geom, qtabs, restart) + body + b"\xff\xd9"


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", ["420", "444", "grey"])
def test_jpeg_entropy_and_entry_points_match_plain(np_rng, cuda, sampling, restart):
    """J1's native decoder and encoder bit for bit with the Python ones; the
    entry points on the card give the CPU's bytes and pixels."""
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    img = _jpeg_frames(np_rng, 1, 45, 70, 1 if sampling == "grey" else 3)[0]
    s = "420" if sampling == "grey" else sampling
    data = _jpeg_encode(img, 60, s, restart, cuda)
    assert data == _jpeg_encode(img, 60, s, restart, "cpu")
    if s == "420" and restart == 0:     # the entry point's sampling, no restarts
        grey = img[..., 0] if sampling == "grey" else img
        assert J.encode_jpeg(grey, 60, device=cuda) == data
    jf = J.parse_jpeg(data)
    a, b = (np.zeros((jf.geom.blocks, 64), np.int16) for _ in range(2))
    OJ.jpeg_huff_decode(jf.scans[0], a, "cpu")
    OJ.jpeg_huff_decode(jf.scans[0], b, cuda)
    assert np.array_equal(a, b)
    assert np.array_equal(J.decode_jpeg(data, device=cuda), J.decode_jpeg(data, device="cpu"))
    frames = J.decode_jpeg_frames([data, data], device=cuda, rgb=True, keep_grey=True)
    assert all(np.array_equal(f, J.decode_jpeg_frames([data], "cpu", rgb=True,
                                                      keep_grey=True)[0]) for f in frames)


def _bad_dc_table(data):
    """The file with the first DHT's last DC symbol (a bit count, at most
    15) raised to 200."""
    at = data.index(b"\xff\xc4")
    assert data[at + 4] == 0                              # class 0 (DC), slot 0
    end = at + 21 + sum(data[at + 5:at + 21])
    return data[:end - 1] + bytes([200]) + data[end:]


def test_jpeg_bad_dc_table_raises(np_rng, cuda):
    """A DC table with a symbol over 15 is refused as corrupt on the card as
    on the CPU, and J1's native decoder refuses such a table when it is given
    one."""
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    data = J.encode_jpeg(_jpeg_frames(np_rng, 1, 24, 40, 3)[0], 60, device=cuda)
    for device in (cuda, "cpu"):
        with pytest.raises(ValueError, match="bad DHT"):
            J.decode_jpeg(_bad_dc_table(data), device=device)
    scan = J.parse_jpeg(data).scans[0]
    luts = scan.luts.copy()
    luts[0] = np.where(luts[0] > 0, (luts[0] & 0xFF00) | 200, 0)
    bad = J.Scan(scan.data, scan.comp_info, luts, scan.mcux, scan.mcuy, scan.restart)
    for device in (cuda, "cpu"):
        with pytest.raises(ValueError, match="bad Huffman code"):
            OJ.jpeg_huff_decode(bad, np.zeros((J.parse_jpeg(data).geom.blocks, 64), np.int16),
                                device)


# --------------------------------------------------------------------------- #
# the MPEG-4 Part 2 codec: V1 (host), V2 and V3 (card)
# --------------------------------------------------------------------------- #
MP4V_FIXTURES = Path(__file__).parent / "data" / "torch_fixtures" / "mp4v"


@pytest.mark.parametrize("name", ["pan", "noise", "still", "odd"])
def test_mpeg4_decode_matches_plain(cuda, name):
    """V1 natively and V2 on the card bit for bit with their plain versions
    on a committed fixture, one launch each a VOP, and the entry point's
    frames equal the CPU's."""
    from mft_tpu_torch.io import mpeg4 as M
    from mft_tpu_torch.io import video
    from mft_tpu_torch.io.mp4 import read_mp4
    from mft_tpu_torch.ops import mpeg4 as OM
    path = MP4V_FIXTURES / f"{name}.mp4"
    v = read_mp4(path)
    vol = M.parse_config(v.config)
    geom = M.Geometry(vol.width, vol.height)
    ref = ref_t = None
    ops.reset_launch_counts()
    n = 0
    for data in v.read_samples():
        payload = data[M.find_vop(data, vol)[0]:]
        syn = OM.mpeg4_vlc_decode(payload, vol, cuda)
        assert syn.equal(M.vlc_decode_ref(payload, vol))
        p = syn.kind == M.P_VOP
        want = M.decode_pixels_ref(syn.levels, syn.mode, syn.qp, syn.mv, ref if p else None,
                                   geom, syn.rounding)
        t = [torch.from_numpy(a).to(cuda) for a in (syn.levels, syn.mode, syn.qp, syn.mv)]
        ref_t, img = OM.mpeg4_decode_pixels(*t, ref_t if p else None, geom, syn.rounding)
        assert np.array_equal(ref_t.cpu().numpy(), want)
        assert np.array_equal(img.cpu().numpy(), M.yuv_to_bgr_ref(want, geom))
        ref = want
        n += 1
    assert ops.launch_counts() == {**{k: 0 for k in ops.launch_counts()},
                                   "mpeg4_vlc_decode": n, "mpeg4_decode_pixels": n}
    got = list(video.get_video_frames(path, device=cuda))
    assert all(np.array_equal(a, b) for a, b in zip(
        got, video.get_video_frames(path, device="cpu")))


def test_mpeg4_reader_closed_early_launches_nothing_more(cuda):
    """A reader closed after its first frame leaves V1 and V2 at one launch
    each, then and after a pause: nothing decodes behind the caller."""
    from mft_tpu_torch.io import video
    ops.reset_launch_counts()
    frames = video.get_video_frames(MP4V_FIXTURES / "pan.mp4", device=cuda)
    next(frames)
    frames.close()
    want = {**{k: 0 for k in ops.launch_counts()}, "mpeg4_vlc_decode": 1,
            "mpeg4_decode_pixels": 1}
    assert ops.launch_counts() == want
    time.sleep(0.2)
    torch.cuda.synchronize()
    assert ops.launch_counts() == want


@pytest.mark.parametrize("seed,W,H", [(21, 128, 96), (22, 72, 40)])
def test_mpeg4_random_syntax_matches_plain(cuda, seed, W, H):
    """Random-syntax streams of the plain writer (1MV/4MV, dquant, ac_pred,
    vectors past the edge): V1's native writer's bytes, its decode and V2
    bit for bit with the plain versions."""
    from mft_tpu_torch.io import mpeg4 as M
    from mft_tpu_torch.ops import mpeg4 as OM
    rng = np.random.default_rng(seed)
    vol = M.Vol(W, H, 25)
    geom = M.Geometry(W, H)
    ref = ref_t = None
    for i, kind in enumerate("0111101"):
        syn = M.random_syntax(rng, vol, int(kind), 0, i)
        data = M.vlc_encode_ref(syn, vol, (0,))
        assert OM.mpeg4_vlc_encode(syn, vol, cuda, (0,)) == data
        got = OM.mpeg4_vlc_decode(data[4:], vol, cuda)
        assert got.equal(M.vlc_decode_ref(data[4:], vol))
        p = got.kind == M.P_VOP
        want = M.decode_pixels_ref(got.levels, got.mode, got.qp, got.mv, ref if p else None,
                                   geom, got.rounding)
        t = [torch.from_numpy(a).to(cuda) for a in (got.levels, got.mode, got.qp, got.mv)]
        ref_t, _ = OM.mpeg4_decode_pixels(*t, ref_t if p else None, geom, got.rounding,
                                          bgr=False)
        assert np.array_equal(ref_t.cpu().numpy(), want)
        ref = want


@pytest.mark.parametrize("W,H", [(96, 64), (72, 40)])
def test_mpeg4_encoder_matches_plain(cuda, tmp_path, W, H):
    """V3 and V1's writer give the plain encoder's levels and bytes, I- and
    P-VOPs, and the written file decodes on the card as on the CPU."""
    from mft_tpu_torch.io import mpeg4 as M
    from mft_tpu_torch.io import video
    rng = np.random.default_rng(3)
    tex = (rng.random((H + 30, W + 30, 3)) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(tex[k:k + H, 2 * k:2 * k + W]) for k in range(14)]
    for dev in (cuda, "cpu"):
        enc = M.Mp4vEncoder(tmp_path / f"{dev}.mp4", 25.0, W, H, device=dev)
        for f in frames:
            enc.write(f)
        enc.close()
    assert (tmp_path / "cuda.mp4").read_bytes() == (tmp_path / "cpu.mp4").read_bytes()
    got = list(video.get_video_frames(tmp_path / "cuda.mp4", device=cuda))
    want = list(video.get_video_frames(tmp_path / "cuda.mp4", device="cpu"))
    assert len(got) == 14 and all(np.array_equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------- #
# Motion JPEG: J1 (host) and J4 (card)
# --------------------------------------------------------------------------- #
VIDEO_FIXTURES = Path(__file__).parent / "data" / "torch_fixtures" / "video"


@pytest.mark.parametrize("name", ["mjpg.avi", "mjpg.mkv", "mjpg.mp4", "mjpg422.avi",
                                  "mjpg444.avi", "grey.avi", "nodht.avi"])
def test_mjpeg_decode_matches_plain(cuda, name):
    """J4 on the card bit for bit with its plain version over a batch of a
    fixture's frames, one launch; the entry point's frames equal the CPU's
    (J1 natively and J4 once a frame, 6 each)."""
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.io import mjpeg as MJ
    from mft_tpu_torch.io import video
    from mft_tpu_torch.io.container import open_track
    from mft_tpu_torch.ops.mjpeg import mjpeg_decode_pixels
    huff, qt, files, coefs = MJ.default_tables(), {}, [], []
    for data in open_track(VIDEO_FIXTURES / name).read_samples():
        jf = MJ.parse_frame(data, huff, qt)
        co = np.zeros((jf.geom.blocks, 64), np.int16)
        for scan in jf.scans:
            J.huff_decode_ref(scan, co)
        files.append(jf)
        coefs.append(co)
    co, q = np.stack(coefs), np.stack([jf.qtabs for jf in files]).astype(np.int32)
    ops.reset_launch_counts()
    got = mjpeg_decode_pixels(torch.from_numpy(co).to(cuda), torch.from_numpy(q).to(cuda),
                              files[0].geom)
    assert np.array_equal(got.cpu().numpy(), MJ.decode_pixels_ref(co, q, files[0].geom))
    assert ops.launch_counts()["mjpeg_decode_pixels"] == 1
    ops.reset_launch_counts()
    frames = list(video.get_video_frames(VIDEO_FIXTURES / name, device=cuda))
    counts = ops.launch_counts()
    assert counts["mjpeg_decode_pixels"] == 6 and counts["jpeg_huff_decode"] == 6
    assert all(np.array_equal(a, b) for a, b in zip(
        frames, video.get_video_frames(VIDEO_FIXTURES / name, device="cpu")))
