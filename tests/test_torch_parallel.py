"""The port's data-parallel mesh over torch.distributed, on the CPU.

One gloo run of 2 processes (this file run as a script, one rank each,
``tcp://localhost``). Each rank builds ``make_mesh()`` (a ``"data"`` axis of
2) and:

- takes one ``make_train_step(mesh=)`` step through ``shard_batch_fn`` on a
  global batch of 4 at 64x96, 2 iterations, float32, in the frozen-BN recipe
  (``__graft_entry__.py dryrun_multichip``'s: batch norm on its running
  statistics, every parameter trained); rank 1 starts from other weights,
  which the first call's broadcast must replace with rank 0's; the last
  sample keeps a quarter of its valid pixels, so the ranks' valid counts
  differ (the flow metrics are ratios over them);
- tracks 2 clips of 64x64 for 2 timesteps with ``StreamingTracker(mesh=)``,
  one clip a rank.

Rank 0 then takes the same step in one process on the whole batch, and
tracks the 2 clips in one process. The ranks write their numbers to files
that the test compares.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
B, H, W, ITERS = 4, 64, 96, 2
CLIPS, STEPS, CH, CW = 2, 2, 64, 64
# conv biases that an instance norm follows (the feature encoder): their
# gradient is zero in exact arithmetic, rounding noise in both steps
BEFORE_NORM = re.compile(r"^fnet\.(conv1|layer\d_\d\.(conv1|conv2|downsample_conv))\.bias$")
LOSS_KW = dict(gamma=0.85, freeze_optical_flow=False,
               occlusion_module="separate_with_uncertainty",
               uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
               weighting_unc_loss=False)


def _state(seed):
    """A frozen-BN model (batch norm on running statistics), all parameters
    trained, random weights from ``seed``; its optimizer."""
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.models.raft.raft import RAFTParams
    from mft_tpu_torch.train.loop import build_state
    from mft_tpu_torch.train.optim import make_optimizer
    model = RAFT(RAFTParams(compute_dtype="float32"), train_mode=False)
    tx, _ = make_optimizer(lr=1e-4, num_steps=10)
    return build_state(model, tx, seed=seed), tx


FLOW_RATIOS = ("train/epe", "train/1px", "train/3px", "train/5px")


def _batch():
    """The global batch; its last sample keeps a quarter of its valid
    pixels (rank 1's half then counts fewer than rank 0's)."""
    from mft_tpu_torch.train import synth
    rng = np.random.default_rng(0)
    img1, img2, flow, valid, occl = synth.make_batch(rng, B, H, W)
    valid[-1] *= rng.random((H, W)) < 0.25
    return tuple(torch.from_numpy(np.ascontiguousarray(b))
                 for b in (img1, img2, flow, valid, occl))


def _step(mesh, seed):
    """One train step; returns (loss, {name: gradient}, {name: parameter},
    the flow metrics (4,), the forward's predictions {key: (ITERS, ...)})."""
    from mft_tpu_torch.train.loop import make_train_step
    state, tx = _state(seed)
    model = state["model"]
    preds = {}
    hook = model.register_forward_hook(lambda m, args, out: preds.update(
        {k: np.stack([t.detach().numpy() for t in out[k]])
         for k in ("flow", "occlusion", "uncertainty")}))
    step = make_train_step(model, tx, LOSS_KW, iters=ITERS, mesh=mesh)
    state, metrics = step(state, _batch())
    hook.remove()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
             for n, p in model.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    ratios = np.array([float(metrics[k]) for k in FLOW_RATIOS])
    return float(metrics["train/loss"]), grads, params, ratios, preds


def _stream_config():
    from mft_tpu_torch.config import Config
    from mft_tpu_torch.models.raft import RAFTFlow
    conf, flow = Config(), Config()
    flow.of_class = RAFTFlow
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32"}
    flow.model = None
    flow.flow_iters = 2
    conf.flow_config = flow
    conf.deltas = [np.inf, 1, 2]
    conf.occlusion_threshold = 0.02
    return conf


def _frames():
    rng = np.random.default_rng(5)
    tex = (rng.random((CLIPS, CH + STEPS + 2, CW + 2 * STEPS + 2, 3)) * 255).astype(np.uint8)
    return np.ascontiguousarray(np.stack(
        [tex[:, k:k + CH, 2 * k:2 * k + CW] for k in range(STEPS + 1)]))


def _stream(n_clips, mesh=None, clip=None):
    """The last timestep's results: (flow, occlusion, sigma) numpy arrays
    with a clip axis; ``clip`` tracks that clip alone."""
    from mft_tpu_torch.parallel import StreamingTracker
    frames = _frames() if clip is None else _frames()[:, clip:clip + 1]
    st = StreamingTracker(_stream_config(), n_clips=n_clips, mesh=mesh, device="cpu")
    st.init(frames[0])
    for k in range(1, STEPS + 1):
        r = st.track(frames[k])
    return [x.numpy() for x in (r.flow, r.occlusion, r.sigma)]


def worker(rank: int, port: int, out: str):
    import torch.distributed as dist
    from mft_tpu_torch.parallel import StreamingTracker, make_mesh
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.train.loop import make_train_step
    torch.set_num_threads(1)   # two ranks beside the suite's other workers
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        mesh = make_mesh()
        res = {}
        loss, grads, params, ratios, _ = _step(mesh, seed=1234 if rank == 0 else 99)
        res["dp_loss"] = np.float64(loss)
        res["dp_ratios"] = ratios
        res.update({f"dp_grad/{n}": g for n, g in grads.items()})
        res.update({f"dp_param/{n}": p for n, p in params.items()})
        for k, x in enumerate(_stream(CLIPS, mesh=mesh)):
            res[f"stream_mesh/{k}"] = x
        for k, x in enumerate(_stream(1, clip=rank)):
            res[f"stream_own/{k}"] = x
        errors = []
        try:
            StreamingTracker(_stream_config(), n_clips=3, mesh=mesh, device="cpu")
        except ValueError as e:
            errors.append(f"ValueError {e}")
        try:
            make_train_step(RAFT(train_mode=True), None, LOSS_KW, mesh=mesh)
        except NotImplementedError as e:
            errors.append(f"NotImplementedError {e}")
        res["errors"] = np.array(errors)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:   # the references, in one process
        loss, grads, params, ratios, preds = _step(None, seed=1234)
        res["one_loss"] = np.float64(loss)
        res["one_ratios"] = ratios
        res.update({f"one_pred/{k}": v for k, v in preds.items()})
        res.update({f"one_grad/{n}": g for n, g in grads.items()})
        res.update({f"one_param/{n}": p for n, p in params.items()})
        for k, x in enumerate(_stream(CLIPS)):
            res[f"stream_one/{k}"] = x
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port),
                               str(tmp / f"rank{r}.npz")], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:   # a rank that did not end in time (a hung collective)
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_dp_step_matches_one_process_step(ranks):
    """The 2-rank step on the global batch against one process's step on the
    whole batch from the same weights: the loss within 1e-6 relative, each
    all-reduced gradient within 1e-5 of its tensor's largest |gradient|
    (the ranks' halves are summed in another order; the biases an instance
    norm follows, zero in exact arithmetic, both within 1e-5 of their conv
    weight's largest |gradient|), the same on both ranks;
    rank 1's other weights were replaced by rank 0's, so both ranks hold the
    same parameters after the update."""
    r0, r1 = ranks
    one, dp = float(r0["one_loss"]), float(r0["dp_loss"])
    assert abs(dp - one) <= 1e-6 * abs(one), (dp, one)
    assert float(r1["dp_loss"]) == dp
    names = [k.split("/", 1)[1] for k in r0 if k.startswith("one_grad/")]
    assert len(names) > 100
    for n in names:
        want, got = r0[f"one_grad/{n}"], r0[f"dp_grad/{n}"]
        if BEFORE_NORM.match(n):
            # the norm takes the mean out: both far below the conv weight's gradient
            scale = float(np.abs(r0[f"one_grad/{n[:-len('bias')]}weight"]).max())
            assert float(np.abs(got).max()) <= 1e-5 * scale, n
            assert float(np.abs(want).max()) <= 1e-5 * scale, n
        else:
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, n
        np.testing.assert_array_equal(r1[f"dp_grad/{n}"], got, err_msg=n)
        np.testing.assert_array_equal(r1[f"dp_param/{n}"], r0[f"dp_param/{n}"], err_msg=n)


def test_dp_flow_metrics_are_global_batch_ratios(ranks):
    """train/epe, 1px, 3px and 5px of the 2-rank step are the one-process
    step's on the whole batch (within 1e-6 relative: the ranks' sums add in
    another order), the same on both ranks, although the halves' valid
    counts differ, so that the mean of the halves' ratios is off; the
    one-process figures are JAX's ``sequence_loss`` metrics of the same
    predictions."""
    import jax.numpy as jnp
    from mft_tpu.train.losses import sequence_loss as jax_sequence_loss
    from mft_tpu_torch.train.losses import sequence_flow_loss
    r0, r1 = ranks
    one, dp = r0["one_ratios"], r0["dp_ratios"]
    np.testing.assert_array_equal(r1["dp_ratios"], dp)
    assert (np.abs(dp - one) <= 1e-6 * np.abs(one)).all(), (dp, one)
    _, _, flow_gt, valid, occl = _batch()
    assert valid[:B // 2].sum() > 1.5 * valid[B // 2:].sum()   # the halves differ
    flow = torch.from_numpy(r0["one_pred/flow"][-1])
    halves = [sequence_flow_loss([flow[s]], flow_gt[s], valid[s])[1]
              for s in (slice(0, B // 2), slice(B // 2, B))]
    rank_mean = np.array([(float(halves[0][k]) + float(halves[1][k])) / 2
                          for k in FLOW_RATIOS])
    assert np.abs(rank_mean - one).max() > 1e-3 * np.abs(one).max(), (rank_mean, one)
    preds = {k: list(jnp.asarray(r0[f"one_pred/{k}"]))
             for k in ("flow", "occlusion", "uncertainty")}
    _, jm = jax_sequence_loss(preds, jnp.asarray(flow_gt.numpy()), jnp.asarray(valid.numpy()),
                              occl_gt=jnp.asarray(occl.numpy()), **LOSS_KW)
    want = np.array([float(jm[k]) for k in FLOW_RATIOS])
    assert (np.abs(one - want) <= 1e-6 * np.abs(want)).all(), (one, want)


def test_streaming_over_mesh_matches_one_process(ranks):
    """Rank r tracks clip r of the 2: bit for bit what one process tracking
    that clip alone gives (the same batch), and within test_torch_mft.py's
    tolerance of one process tracking both clips (a batch twice the size,
    whose CPU convolutions may sum in another order)."""
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        for k in range(3):
            mesh, own, one = res[f"stream_mesh/{k}"], res[f"stream_own/{k}"], r0[f"stream_one/{k}"]
            assert mesh.shape[0] == 1
            np.testing.assert_array_equal(mesh, own)
            np.testing.assert_allclose(mesh[0], one[r], atol=1e-4, rtol=1e-5)


def test_mesh_errors(ranks):
    """3 clips over 2 ranks and a batch-statistics model over 2 ranks raise."""
    for res in ranks:
        errors = list(res["errors"])
        assert len(errors) == 2, errors
        assert errors[0].startswith("ValueError") and "split evenly" in errors[0]
        assert errors[1].startswith("NotImplementedError")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
