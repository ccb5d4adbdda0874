"""The port's synthetic-shard trainer and shard generator against JAX's tools.

``mft_tpu_torch/train/gen_synth_data.py`` against ``tools/gen_synth_data.py``
(run as a subprocess, as its users run it), ``train/train_synth.py``'s
``CachedSynthData`` and ``fixed_val_batch`` against ``tools/train_synth.py``'s
(imported by path), a 2-step run on the CPU with checkpoint, resume and
export (read back by the port's reader and by JAX's ``load_variables``), and
``run_val``'s promise to leave the running statistics as it found them.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mft_tpu.models.raft.raft import RAFT as JaxRAFT
from mft_tpu.models.raft.raft import RAFTParams as JaxRAFTParams
from mft_tpu.models.raft.wrapper import load_variables
from mft_tpu_torch.models.raft import RAFT
from mft_tpu_torch.models.raft.flax_msgpack import read_variables
from mft_tpu_torch.models.raft.raft import RAFTParams
from mft_tpu_torch.models.raft.wrapper import load_weights, random_init
from mft_tpu_torch.train import gen_synth_data, train_synth
from mft_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

REPO = Path(__file__).resolve().parents[1]
H, W, T = 64, 96, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tools():
    """tools/train_synth.py as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location("jax_train_synth",
                                                  REPO / "tools" / "train_synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """2 shards of 64x96, T = 3, written by the port and by JAX's tool."""
    tmp = tmp_path_factory.mktemp("shards")
    args = ["--size", str(H), str(W), "--T", str(T), "--count", "4"]
    assert gen_synth_data.generate(tmp / "port", (H, W), T, count=4, log=lambda m: None) == 4
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "gen_synth_data.py"),
                           "--out", str(tmp / "jax"), *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return tmp


def test_shards_equal_jax_tool(shards):
    """Array for array, name for name, dtype for dtype."""
    names = sorted(p.name for p in (shards / "port").glob("*.npz"))
    assert names == ["shard_000000.npz", "shard_000001.npz"]
    assert names == sorted(p.name for p in (shards / "jax").glob("*.npz"))
    for name in names:
        with np.load(shards / "port" / name) as a, np.load(shards / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["flows", "img0", "imgs", "occls"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        with np.load(shards / "port" / name) as a:
            assert a["imgs"].shape == (T - 1, H, W, 3) and a["flows"].dtype == np.float16
            assert a["occls"].dtype == np.uint8


def test_generate_resumes_after_existing_shards(tmp_path):
    """A second call with a higher count adds shards from the next seed on,
    as JAX's tool does; the first shard is the one a fresh run writes."""
    gen_synth_data.main(["--out", str(tmp_path), "--size", "32", "48", "--T", "2",
                         "--count", "1"])
    first = np.load(tmp_path / "shard_000000.npz")["img0"].copy()
    gen_synth_data.main(["--out", str(tmp_path), "--size", "32", "48", "--T", "2",
                         "--count", "3"])
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        f"shard_{i:06d}.npz" for i in range(3)]
    np.testing.assert_array_equal(np.load(tmp_path / "shard_000000.npz")["img0"], first)


def test_batches_equal_jax_cached_synth_data(shards, jax_tools):
    """Three next_batch draws (crops 48x64 of the 64x96 shards, batch 3) and
    fixed_val_batch equal JAX's, array for array."""
    ours = train_synth.CachedSynthData(shards / "port", (48, 64), 3, rescan_every=3600)
    theirs = jax_tools.CachedSynthData(shards / "port", (48, 64), 3, rescan_every=3600)
    try:
        for _ in range(3):
            for a, b in zip(ours.next_batch(), theirs.next_batch()):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    finally:
        ours.close()
        theirs.close()
    for a, b in zip(train_synth.fixed_val_batch(H, W, n=3), jax_tools.fixed_val_batch(H, W, n=3)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_prefetch_raises_when_producer_dies():
    class Broken:
        closed = False

        def next_batch(self):
            raise OSError("disk gone")

        def close(self):
            self.closed = True

    stream = train_synth.PrefetchBatches(Broken())
    with pytest.raises(RuntimeError, match="producer died"):
        stream.next_batch()
    stream.close()
    assert stream.stream.closed


def _args(tmp, data, steps, resume=False):
    args = ["--device", "cpu", "--data", str(data), "--size", str(H), str(W), "--batch", "2",
            "--iters", "2", "--steps", str(steps), "--save_every", "2", "--log_every", "1",
            "--out", str(tmp / "run"), "--export", str(tmp / "export.msgpack")]
    return args + (["--resume"] if resume else [])


@pytest.fixture(scope="module")
def trained(shards, tmp_path_factory):
    """A 2-step CPU run (checkpoint and export at step 2), then --resume to 3."""
    tmp = tmp_path_factory.mktemp("train")
    first = train_synth.main(_args(tmp, shards / "port", steps=2))
    state2 = {k: v.clone() for k, v in first["state"]["model"].state_dict().items()}
    export2 = (tmp / "export.msgpack").read_bytes()
    second = train_synth.main(_args(tmp, shards / "port", steps=3, resume=True))
    return tmp, first, state2, export2, second


def test_run_checkpoints_and_resumes(trained):
    """The first run takes 2 steps and writes step_00000002; --resume starts
    there (the restored state is the first run's, bit for bit) and takes 1
    more; the losses and validation figures are finite."""
    tmp, first, state2, _, second = trained
    assert first["steps"] == 2 and first["state"]["step"] == 2
    assert second["steps"] == 1 and second["state"]["step"] == 3
    assert sorted(p.name for p in (tmp / "run").glob("step_*")) == ["step_00000002",
                                                                     "step_00000003"]
    model = RAFT(RAFTParams(occlusion_module="separate_with_uncertainty",
                            compute_dtype="float32"), train_mode=True)
    state = restore_checkpoint(tmp / "run" / "step_00000002",
                               {"model": model, "opt_state": {}, "step": 0})
    assert state["step"] == 2 and latest_checkpoint(tmp / "run").name == "step_00000003"
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state2[k], rtol=0, atol=0, msg=k)
    assert all(np.isfinite(v) for r in (first, second) for v in r["val"].values())
    assert 0 <= first["data_wait"] <= first["seconds"]


def test_export_read_by_both_readers(trained):
    """The step-2 export holds the model's parameters and statistics: the
    port's reader gives them bit for bit, JAX's load_variables (flax into
    its RAFT's tree) the same arrays as the port's msgpack reader."""
    tmp, _, state2, export2, _ = trained
    path = tmp / "export2.msgpack"
    path.write_bytes(export2)
    got = load_weights(path)
    assert got.keys() == state2.keys()
    for k, v in got.items():
        torch.testing.assert_close(v, state2[k], rtol=0, atol=0, msg=k)
    jax_vars = load_variables(path, JaxRAFT(JaxRAFTParams(
        occlusion_module="separate_with_uncertainty", compute_dtype="float32")))
    ours = read_variables(path)
    flat_jax = dict(jax.tree_util.tree_flatten_with_path(jax_vars)[0])
    flat_ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert len(flat_ours) == len(flat_jax) > 100
    keys = {jax.tree_util.keystr(k): v for k, v in flat_jax.items()}
    for k, v in flat_ours.items():
        np.testing.assert_array_equal(np.asarray(keys[jax.tree_util.keystr(k)]), v)


def test_run_val_keeps_running_statistics():
    """run_val normalises with the validation batch's statistics (its
    forward would move the running ones) and leaves them as they were."""
    model = RAFT(RAFTParams(occlusion_module="separate_with_uncertainty",
                            compute_dtype="float32"), train_mode=True)
    random_init(model, 0)
    batch = train_synth.fixed_val_batch(H, W, n=2)
    before = {k: v.clone() for k, v in model.named_buffers()}
    val = train_synth.run_val(model, batch, iters=2)
    assert sorted(val) == ["val_epe", "val_epe_nonocc", "val_occ_acc", "val_px1", "val_px3",
                           "val_sigma_epe_corr"]
    assert all(np.isfinite(v) for v in val.values())
    for k, v in model.named_buffers():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    with torch.no_grad():
        img = torch.from_numpy(batch[0]).permute(0, 3, 1, 2)
        model(img, img, iters=1, test_mode=False)
    assert any(not torch.equal(v, before[k]) for k, v in model.named_buffers())
