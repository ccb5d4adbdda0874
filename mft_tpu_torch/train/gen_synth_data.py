"""Pre-generate synthetic training scenes as disk shards.

Port of ``tools/gen_synth_data.py``: the same ``shard_XXXXXX.npz`` files
from the same seeds, rendered by the port's ``train/synth.py Scene``. Each
shard is one scene: the template frame ``img0`` (H, W, 3) uint8, the T-1
target frames ``imgs``, their exact template -> frame flows ``flows`` as
float16 and occlusions ``occls`` as uint8. Writes are atomic (a temporary
file, then a rename), so :mod:`mft_tpu_torch.train.train_synth` can rescan
the directory while this keeps writing. Host-side numpy only.

    python -m mft_tpu_torch.train.gen_synth_data --out data_synth --count 4000
"""

import argparse
import os
import time
from pathlib import Path

import numpy as np

from mft_tpu_torch.train.synth import Scene


def write_shard(path: Path, seed: int, H: int, W: int, T: int):
    """Render the scene of ``seed`` and write it to ``path`` atomically."""
    rng = np.random.default_rng(seed)
    n_sprites = int(rng.integers(2, 5))
    scene = Scene(rng, H, W, T=T, n_sprites=n_sprites)
    img0, ids0 = scene.composite(0)
    imgs, flows, occls = [], [], []
    for t in range(1, T):
        img_t, ids_t = scene.composite(t)
        flow, occl = scene.flow_occl(t, ids0=ids0, ids_t=ids_t)
        imgs.append(img_t)
        flows.append(flow.astype(np.float16))
        occls.append((occl > 0.5).astype(np.uint8))
    tmp = path.parent / f".tmp_{seed:06d}.npz"
    np.savez(tmp, img0=img0, imgs=np.stack(imgs), flows=np.stack(flows),
             occls=np.stack(occls))
    os.replace(tmp, path)


def generate(out, size=(288, 352), T=8, count=4000, seed_start=0, log=print):
    """Write shards into ``out`` until ``count`` pairs (T-1 a shard) exist;
    the seeds go on from ``seed_start`` plus the shards already there.
    returns the number of pairs."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    H, W = size
    existing = sorted(out.glob("shard_*.npz"))
    n_pairs = len(existing) * (T - 1)
    seed = seed_start + len(existing)
    t0 = time.time()
    made = 0
    while n_pairs < count:
        path = out / f"shard_{seed:06d}.npz"
        if path.exists():
            seed += 1
            continue
        write_shard(path, seed, H, W, T)
        n_pairs += T - 1
        made += 1
        seed += 1
        if made % 50 == 0:
            rate = made * (T - 1) / (time.time() - t0)
            log(f"[gen] {n_pairs} pairs ({rate:.1f} pairs/s)")
    log(f"[gen] done: {n_pairs} pairs in {out}")
    return n_pairs


def get_parser():
    ap = argparse.ArgumentParser(description="pre-generate synthetic training shards")
    ap.add_argument("--out", default="data_synth")
    ap.add_argument("--size", type=int, nargs=2, default=[288, 352])
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--count", type=int, default=4000,
                    help="stop after this many PAIRS exist")
    ap.add_argument("--seed_start", type=int, default=0)
    return ap


def main(argv=None):
    args = get_parser().parse_args(argv)
    generate(args.out, args.size, args.T, args.count, args.seed_start,
             log=lambda msg: print(msg, flush=True))


if __name__ == "__main__":
    main()
