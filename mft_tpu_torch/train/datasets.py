"""Flow training datasets, the stage mixer and a prefetching batch loader.

Port of ``mft_tpu/train/datasets.py`` (reference MFT/RAFT/core/datasets.py:
63-647), the same file lists, pairings, augmentation parameters and stage
mixes. Each dataset yields channel-last numpy samples:
  img1, img2: (H, W, 3) float32 RGB 0..255
  flow: (H, W, 2) float32
  valid: (H, W) float32 {0, 1}
  occl: (H, W) float32 in [0, 1]

Datasets: MpiSintel (clean/final + occlusions_rev + the train/val
subsplit), FlyingChairs, FlyingThings3D (+ generated occlusion PNGs),
KubricLongTerm (template -> frame flow with first-frame motion
compensation), KITTI, VIPER and HD1K (sparse). ``fetch_dataset`` builds
every stage of the JAX package. Files are read by
:mod:`mft_tpu_torch.train.flow_readers` (PNG, JPEG, PPM, .flo, .pfm, .npz);
a dataset's JPEG images (VIPER's frames) decode for its ``device``, which
its augmenter's JPEG corruption uses too. :class:`BatchLoader` assembles
batches in worker threads; the train loop moves each batch to the card once.
"""

import logging
import pickle
import queue
import threading
from glob import glob
from pathlib import Path

import numpy as np

from mft_tpu_torch.train import flow_readers as fr
from mft_tpu_torch.train.augment import FlowAugmenter, SparseFlowAugmenter

logger = logging.getLogger(__name__)

# validation scenes of the official sintel train/val subsplit
# (reference datasets.py:411)
SINTEL_VAL_SCENES = ("alley_1", "ambush_6", "bamboo_2", "cave_4",
                     "market_5", "shaman_3")


class FlowDataset:
    """Base: file lists + read + augment (reference datasets.py:63-189)."""

    def __init__(self, aug_params=None, sparse=False, load_occlusion=False,
                 root=None):
        self.root = root
        self.sparse = sparse
        self.load_occlusion = load_occlusion
        self.augmentor = None
        self.device = "cuda"        # where JPEG images decode
        if aug_params is not None:
            cls = SparseFlowAugmenter if sparse else FlowAugmenter
            self.augmentor = cls(**aug_params)
            self.device = aug_params.get("device", self.device)
        self.image_list = []
        self.flow_list = []
        self.occlusion_list = []
        self.extra_info = []

    def __len__(self):
        return len(self.image_list)

    def _read_flow(self, index):
        if self.sparse:
            path = self.flow_list[index]
            if str(path).endswith(".npz"):  # VIPER
                flow, valid = fr.read_viper_flow(path)
            else:  # KITTI / HD1K 16-bit png
                flow, valid = fr.read_kitti_flow(path)
            return flow, valid
        data = fr.read_gen(self.flow_list[index], self.device)
        flow = data[0] if isinstance(data, tuple) else data
        return np.asarray(flow, np.float32), None

    def _read_occl(self, index):
        if not self.occlusion_list:
            return None
        occl = fr.read_image(self.occlusion_list[index], self.device)[..., 0].astype(np.float32)
        if occl.max() >= 1.1:
            occl = occl / 255.0
        return occl

    def __getitem__(self, index):
        index = index % len(self.image_list)
        img1 = fr.read_image(self.image_list[index][0], self.device).astype(np.uint8)
        img2 = fr.read_image(self.image_list[index][1], self.device).astype(np.uint8)
        flow, valid = self._read_flow(index)
        occl = self._read_occl(index)
        occl_in = occl[..., None] if occl is not None else np.zeros(
            (*flow.shape[:2], 1), np.float32)

        if self.augmentor is not None:
            img1, img2, flow, valid, occl_in = self.augmentor(
                img1, img2, flow, valid, occl_in)
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        occl_out = (occl_in[..., 0] if occl_in is not None
                    else np.zeros(flow.shape[:2], np.float32))
        return (img1.astype(np.float32), img2.astype(np.float32),
                flow.astype(np.float32), valid.astype(np.float32),
                occl_out.astype(np.float32))


class MpiSintel(FlowDataset):
    """Sintel clean/final with occlusion maps and the train/val subsplit.

    Reference parity: datasets.py:398-441 (occlusions_rev for reverse pairs,
    subsplit filtering by scene).
    """

    def __init__(self, aug_params=None, split="training", root="datasets/Sintel",
                 dstype="clean", load_occlusion=False, subsplit=None):
        super().__init__(aug_params, load_occlusion=load_occlusion, root=root)
        root = Path(root) / split
        img_root = root / dstype
        for scene_dir in sorted(img_root.glob("*")):
            scene = scene_dir.name
            if subsplit == "train" and scene in SINTEL_VAL_SCENES:
                continue
            if subsplit == "val" and scene not in SINTEL_VAL_SCENES:
                continue
            images = sorted(scene_dir.glob("*.png"))
            for i in range(len(images) - 1):
                self.image_list.append([str(images[i]), str(images[i + 1])])
                self.extra_info.append((scene, i))
                if split != "test":
                    self.flow_list.append(
                        str(root / "flow" / scene / f"frame_{i + 1:04d}.flo"))
                    if load_occlusion:
                        # MFT's regenerated occlusion maps, NOT Sintel's
                        # stock 'occlusions' dir (reference datasets.py:421)
                        self.occlusion_list.append(
                            str(root / "occlusions_rev" / scene
                                / f"frame_{i + 1:04d}.png"))


class FlyingChairs(FlowDataset):
    """Reference parity: datasets.py:444-457 (split via chairs_split.txt)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data"):
        super().__init__(aug_params, root=root)
        images = sorted(glob(str(Path(root) / "*.ppm")))
        flows = sorted(glob(str(Path(root) / "*.flo")))
        assert len(images) // 2 == len(flows)
        split_file = Path(root).parent / "chairs_split.txt"
        if split_file.exists():
            split_ids = np.loadtxt(split_file, dtype=np.int32)
        else:
            split_ids = np.ones(len(flows), np.int32)
        for i in range(len(flows)):
            xid = split_ids[i]
            if (split == "training" and xid == 1) or (split == "validation" and xid == 2):
                self.flow_list.append(flows[i])
                self.image_list.append([images[2 * i], images[2 * i + 1]])


class FlyingThings3D(FlowDataset):
    """Reference parity: datasets.py:460-498 (both time directions, optional
    generated occlusion maps)."""

    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass", load_occlusion=False):
        super().__init__(aug_params, load_occlusion=load_occlusion, root=root)
        root = Path(root)
        for cam in ("left",):
            for direction in ("into_future", "into_past"):
                img_dirs = sorted(root.glob(f"{dstype}/TRAIN/*/*/{cam}"))
                flo_dirs = sorted(root.glob(f"optical_flow/TRAIN/*/*/{direction}/{cam}"))
                for idir, fdir in zip(img_dirs, flo_dirs):
                    images = sorted(Path(idir).glob("*.png"))
                    flows = sorted(Path(fdir).glob("*.pfm"))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            im1, im2, flow = images[i], images[i + 1], flows[i]
                        else:
                            im1, im2, flow = images[i + 1], images[i], flows[i + 1]
                        # occlusion path derived from the FLOW path (same
                        # stem), skipping pairs whose map is missing — the
                        # reference's pairing rule (datasets.py:483-495); a
                        # sorted dir listing misaligns because the generator
                        # writes F-1 maps per direction with offset stems
                        occl = Path(str(flow).replace(
                            "optical_flow", "occlusions")).with_suffix(".png")
                        if load_occlusion and not occl.is_file():
                            continue
                        self.image_list.append([str(im1), str(im2)])
                        self.flow_list.append(str(flow))
                        if load_occlusion:
                            self.occlusion_list.append(str(occl))


class KubricLongTerm(FlowDataset):
    """Kubric MOVi-E 'longterm' template-to-frame flow pairs.

    Every sample pairs frame 0 with frame i+1 of a scene and reads the dense
    template->frame flowou (0000_to_XXXX.flowou.png). With
    ``correct_flow=True``, the first frame's (synthetically injected) motion
    field is compensated by back-warping, and only pixels with an unambiguous
    object mask stay valid. Reference parity: datasets.py:272-395.
    """

    def __init__(self, aug_params=None, split="train",
                 root="datasets/kubric_movi_e_longterm", load_occlusion=True,
                 correct_flow=False):
        super().__init__(aug_params, load_occlusion=load_occlusion, root=root)
        self.correct_flow = correct_flow
        self.flow_zero_list = []
        data_root = Path(root) / split
        if not data_root.exists():
            return
        for scene_dir in sorted(data_root.iterdir()):
            images = sorted((scene_dir / "images").glob("*.png"))
            flows = sorted((scene_dir / "flowou").glob("*.flowou.png"))
            for i in range(len(images) - 1):
                self.image_list.append([str(images[0]), str(images[i + 1])])
                self.extra_info.append((scene_dir.name, i))
                self.flow_list.append(str(flows[i + 1]))
                self.flow_zero_list.append(str(flows[0]))

    @staticmethod
    def _bw_warp(data, flow):
        """Backward bilinear warp of (H, W, C) by (H, W, 2) in numpy."""
        H, W = data.shape[:2]
        xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        x = np.clip(xs + flow[..., 0], 0, W - 1)
        y = np.clip(ys + flow[..., 1], 0, H - 1)
        x0 = np.floor(x).astype(np.int32)
        y0 = np.floor(y).astype(np.int32)
        x1 = np.minimum(x0 + 1, W - 1)
        y1 = np.minimum(y0 + 1, H - 1)
        wx = (x - x0)[..., None]
        wy = (y - y0)[..., None]
        return (data[y0, x0] * (1 - wx) * (1 - wy) + data[y0, x1] * wx * (1 - wy)
                + data[y1, x0] * (1 - wx) * wy + data[y1, x1] * wx * wy)

    def __getitem__(self, index):
        index = index % len(self.image_list)
        img1 = fr.read_image(self.image_list[index][0], self.device).astype(np.uint8)
        img2 = fr.read_image(self.image_list[index][1], self.device).astype(np.uint8)
        flow, occl, _ = fr.read_flowou_png(self.flow_list[index])
        occl = occl.astype(np.float32)
        valid = None

        if self.correct_flow:
            flow_zero, _, _ = fr.read_flowou_png(self.flow_zero_list[index])
            # the frame-0 marker flow is 0.0 on background, 0.5 on objects
            obj = flow_zero[..., 0] > 0.25
            flow_zero = np.broadcast_to(
                np.where(obj[..., None], 0.5, 0.0), flow.shape
            ).astype(np.float32)
            obj_f = obj.astype(np.float32) - 0.5
            flow = flow - flow_zero
            flow = self._bw_warp(flow, -flow_zero)
            obj_f = self._bw_warp(obj_f[..., None], -flow_zero)[..., 0] + 0.5
            occl = self._bw_warp(occl[..., None], -flow_zero)[..., 0]
            valid = ((obj_f > 0.99) | (obj_f < 0.01)).astype(np.float32)

        occl_in = occl[..., None]
        if self.augmentor is not None:
            img1, img2, flow, valid, occl_in = self.augmentor(
                img1, img2, flow.astype(np.float32), valid, occl_in)
        range_ok = ((np.abs(flow[..., 0]) < 1000)
                    & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        valid = range_ok if valid is None else valid * range_ok
        return (img1.astype(np.float32), img2.astype(np.float32),
                flow.astype(np.float32), valid.astype(np.float32),
                occl_in[..., 0].astype(np.float32))


class KITTI(FlowDataset):
    """Reference parity: datasets.py:501-519 (sparse GT)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI2015"):
        super().__init__(aug_params, sparse=True, root=root)
        root = Path(root) / split
        images1 = sorted(root.glob("image_2/*_10.png"))
        images2 = sorted(root.glob("image_2/*_11.png"))
        for i1, i2 in zip(images1, images2):
            self.image_list.append([str(i1), str(i2)])
            self.extra_info.append((i1.stem,))
        if split == "training":
            self.flow_list = [str(p) for p in sorted(root.glob("flow_occ/*_10.png"))]


class VIPER(FlowDataset):
    """VIPER (Playing-for-Benchmarks) forward flow, npz ground truth.

    The reference's ``validate_viper`` (evaluate.py:304-344) calls a
    ``datasets.VIPER`` class that was never committed to the reference repo;
    this is a working implementation of the interface it expects: frame
    pairs ``<seq>/<seq>_<frame>.jpg`` -> next frame, flow from
    ``<seq>_<frame>.npz`` (read_viper_flow, flow_readers.py). Sparse GT
    semantics (NaN/huge values masked invalid).
    """

    def __init__(self, aug_params=None, split="validation",
                 root="datasets/VIPER"):
        super().__init__(aug_params, sparse=True, root=root)
        root = Path(root)
        img_root = root / ("val" if split == "validation" else "train") / "img"
        flow_root = root / ("val" if split == "validation" else "train") / "flow"
        for seq_dir in sorted(img_root.glob("*")):
            images = sorted(seq_dir.glob("*.jpg")) or sorted(seq_dir.glob("*.png"))
            for i in range(len(images) - 1):
                flow_path = flow_root / seq_dir.name / (images[i].stem + ".npz")
                if flow_path.exists():
                    self.image_list.append([str(images[i]), str(images[i + 1])])
                    self.flow_list.append(str(flow_path))
                    self.extra_info.append((images[i].stem,))
        if not self.image_list:
            raise FileNotFoundError(
                f"no VIPER frame pairs with flow found under {root}")


class HD1K(FlowDataset):
    """Reference parity: datasets.py:522-538 (sparse GT)."""

    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True, root=root)
        root = Path(root)
        seq = 0
        while True:
            flows = sorted(root.glob(f"hd1k_flow_gt/flow_occ/{seq:06d}_*.png"))
            images = sorted(root.glob(f"hd1k_input/image_2/{seq:06d}_*.png"))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(str(flows[i]))
                self.image_list.append([str(images[i]), str(images[i + 1])])
            seq += 1


class MixedDataset:
    """Weighted concatenation of datasets (reference combine_datasets_with_
    weights, datasets.py:633-647): dataset i appears weight_i times."""

    def __init__(self, datasets, weights=None):
        weights = weights or [1] * len(datasets)
        self.weights = list(weights)
        self.parts = []
        for ds, w in zip(datasets, weights):
            if len(ds):
                self.parts.extend([ds] * int(w))
        self.lengths = [len(ds) for ds in self.parts]
        self.offsets = np.cumsum([0] + self.lengths)

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index):
        index = index % max(len(self), 1)
        part = int(np.searchsorted(self.offsets, index, side="right")) - 1
        return self.parts[part][index - self.offsets[part]]


def fetch_dataset(stage, image_size, env=None, dashcam_augmentation=False, device="cuda"):
    """Build the training mix for an official stage name.

    Official MFT stage 'sintel_things_kubric_train_subsplit' mixes
    100x sintel_clean + 100x sintel_final + things_final + kubric with
    zoom-in augmentation for kubric (reference datasets.py:541-630).
    ``dashcam_augmentation`` adds JPEG corruption at p=0.5 to every stage
    (reference datasets.py:546-552: do_jpeg_transform=True, jpeg_prop=0.5).
    ``device`` decodes JPEG images and runs the JPEG corruption.
    """
    from mft_tpu_torch.environment import env_settings
    env = env or env_settings()
    aug = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.6,
           "do_flip": True, "device": device}
    if dashcam_augmentation:
        aug.update({"do_jpeg_transform": True, "jpeg_prop": 0.5})

    if stage == "chairs":
        return FlyingChairs(dict(aug, min_scale=-0.1, max_scale=1.0),
                            split="training", root=env.flyingchairs_dir)
    if stage == "things":
        a = dict(aug, min_scale=-0.4, max_scale=0.8)
        return MixedDataset([
            FlyingThings3D(a, dstype="frames_cleanpass", root=env.flyingthings_dir),
            FlyingThings3D(a, dstype="frames_finalpass", root=env.flyingthings_dir),
        ])
    if stage == "sintel":
        a = dict(aug, min_scale=-0.2, max_scale=0.6)
        return MixedDataset([
            MpiSintel(a, dstype="clean", root=env.sintel_dir, load_occlusion=True),
            MpiSintel(a, dstype="final", root=env.sintel_dir, load_occlusion=True),
        ])
    if stage == "kubric":
        # resize forced on (prob 1.1): a 256^2 MOVi-E frame cannot supply a
        # 368x768 crop without the zoom-in resize
        a = dict(aug, min_scale=1.8, max_scale=2.2, do_flip=True,
                 stretch_prob=1.1, spatial_aug_prob=1.1,
                 asymmetric_color_aug_prob=0.0)
        return KubricLongTerm(a, root=env.kubric_dir, correct_flow=True)
    if stage == "kitti":
        return KITTI(dict(aug, min_scale=-0.2, max_scale=0.4, do_flip=False),
                     root=env.kitti_dir)
    if stage == "sintel_things_train_subsplit":
        # first-stage (no-kubric) recipe (reference datasets.py:572-577,
        # train_params_no_kubric.txt): 200x sintel_clean + 200x sintel_final
        # + things_final, one shared -0.4..0.8 scale range
        a = dict(aug, min_scale=-0.4, max_scale=0.8)
        sintel_clean = MpiSintel(a, dstype="clean", root=env.sintel_dir,
                                 load_occlusion=True, subsplit="train")
        sintel_final = MpiSintel(a, dstype="final", root=env.sintel_dir,
                                 load_occlusion=True, subsplit="train")
        things = FlyingThings3D(a, dstype="frames_finalpass",
                                root=env.flyingthings_dir, load_occlusion=True)
        return MixedDataset([sintel_clean, sintel_final, things],
                            weights=[200, 200, 1])
    if stage == "sintel_things_kubric_train_subsplit":
        # reference stage params (datasets.py:580-588): ONE -0.4..0.8 scale
        # range shared by sintel+things; kubric zooms 1.8..2.2 with resize
        # and stretch forced on (prob 1.1) and asymmetric color jitter OFF
        a_sintel = dict(aug, min_scale=-0.4, max_scale=0.8)
        a_things = dict(aug, min_scale=-0.4, max_scale=0.8)
        a_kubric = dict(aug, min_scale=1.8, max_scale=2.2,
                        stretch_prob=1.1, spatial_aug_prob=1.1,
                        asymmetric_color_aug_prob=0.0)
        sintel_clean = MpiSintel(a_sintel, dstype="clean", root=env.sintel_dir,
                                 load_occlusion=True, subsplit="train")
        sintel_final = MpiSintel(a_sintel, dstype="final", root=env.sintel_dir,
                                 load_occlusion=True, subsplit="train")
        things = FlyingThings3D(a_things, dstype="frames_finalpass",
                                root=env.flyingthings_dir, load_occlusion=True)
        kubric = KubricLongTerm(a_kubric, root=env.kubric_dir, correct_flow=True)
        return MixedDataset([sintel_clean, sintel_final, things, kubric],
                            weights=[100, 100, 1, 1])
    raise ValueError(f"unknown training stage {stage!r}")


class BatchLoader:
    """Thread-prefetching shuffled batch loader producing numpy batches."""

    def __init__(self, dataset, batch_size, num_workers=4, seed=0,
                 prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        idx_lock = threading.Lock()
        order = {"perm": self.rng.permutation(max(len(self.dataset), 1)),
                 "pos": 0}

        def next_indices():
            with idx_lock:
                out = []
                for _ in range(self.batch_size):
                    if order["pos"] >= len(order["perm"]):
                        order["perm"] = self.rng.permutation(max(len(self.dataset), 1))
                        order["pos"] = 0
                    out.append(int(order["perm"][order["pos"]]))
                    order["pos"] += 1
                return out

        def worker():
            while not stop.is_set():
                idxs = next_indices()
                samples = [self.dataset[i] for i in idxs]
                batch = tuple(np.stack(col) for col in zip(*samples))
                # retry putting the SAME batch until it fits (or shutdown):
                # dropping it on a full queue would burn CPU rebuilding
                # batches that are never trained on and skip the consumed
                # shuffle-permutation samples for the epoch
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                yield q.get()
        finally:
            # the workers finish the batch they are building, then stop: none
            # outlives the loop that read from it (its device work, a JPEG
            # stage's, would land in whatever runs next)
            stop.set()
            for t in threads:
                t.join()


def save_file_list_cache(path, payload):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_file_list_cache(path):
    path = Path(path)
    if not path.exists():
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
