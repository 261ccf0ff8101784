"""Datasets: KITTI train/eval pairs, Sintel sequences, consecutive frames.

The port's counterparts of ``opticalflow_tpu.data.datasets``: plain
indexable objects returning numpy NHWC samples, decoded by the port's own
PNG reader; batching and prefetch live in ``data/loader.py``.

  * :class:`KittiFlowTrain` — "<img1> <img2> <flow_png>" list file or
    auto-scan of ``image_2``/``flow_occ`` **temporal** neighbors (or
    ``pairing="stereo"``: ``image_2`` with ``image_3``), reduced
    augmentation, upsize-if-small, random 320×896 crop, 30% h-flip
    (``data_processing_or.py:160-294``);
  * :class:`KittiPairsEval` — KITTI 2012/2015 eval pairs *_10/*_11 with
    16-bit GT flow (``inference_kitti.py:134-202``);
  * :class:`SintelPairs` — MPI-Sintel clean/final with ``.flo`` GT;
  * :class:`ConsecutiveFrames` — frame_t/frame_{t+stride} pairs from a
    directory of frames for self-supervised training
    (``train_pseudo.py:23-62``).  A video file is not read yet: the port
    has no container reader (ROADMAP Queue 1 item 3).

The JAX module resizes with OpenCV; here ``io.images`` does, with
OpenCV's rules: the uint8 frames through ``resize_bilinear_u8``
(bit-exact), the float32 images and flow of the upsize step through
``resize_bilinear_f32`` and the valid mask through ``resize_nearest``.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from opticalflow_tpu_torch.data import augment as aug
from opticalflow_tpu_torch.io.flo import read_flo
from opticalflow_tpu_torch.io.images import (load_image, preprocess_pair,
                                             resize_bilinear_f32,
                                             resize_bilinear_u8,
                                             resize_nearest)
from opticalflow_tpu_torch.io.kitti import read_flow_png

__all__ = ["KittiFlowTrain", "KittiPairsEval", "SintelPairs",
           "ConsecutiveFrames"]


def _resize_flow(flow, h, w):
    """Resize a flow field and scale its vectors by the size ratio."""
    fh, fw = flow.shape[:2]
    if (fh, fw) == (h, w):
        return flow
    u = resize_bilinear_f32(flow[..., 0], h, w) * (w / float(fw))
    v = resize_bilinear_f32(flow[..., 1], h, w) * (h / float(fh))
    return np.stack([u, v], axis=-1).astype(np.float32)


class KittiFlowTrain:
    """KITTI fine-tuning samples: dict(images (H,W,6) [0,1], flow (H,W,2),
    valid (H,W)) at a fixed crop size."""

    def __init__(self, root: str, list_file: Optional[str] = None,
                 crop_hw: Tuple[int, int] = (320, 896),
                 augment: bool = True, flip_prob: float = 0.3,
                 pairing: str = "temporal", seed: int = 0):
        self.crop_h, self.crop_w = crop_hw
        self.augment = augment
        self.flip_prob = flip_prob
        self.seed = seed
        self.samples: List[Tuple[str, str, str]] = []
        if list_file:
            with open(list_file) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 3:
                        self.samples.append(tuple(parts))
        else:
            img_dir = os.path.join(root, "image_2")
            flow_dir = os.path.join(root, "flow_occ")
            imgs = sorted(glob(os.path.join(img_dir, "*.png")))
            if pairing == "temporal":
                for a, b in zip(imgs[:-1], imgs[1:]):
                    stem = os.path.splitext(os.path.basename(a))[0]
                    fp = os.path.join(flow_dir, f"{stem}.png")
                    if os.path.isfile(fp):
                        self.samples.append((a, b, fp))
            elif pairing == "stereo":
                for a in imgs:
                    b = a.replace("image_2", "image_3")
                    stem = os.path.splitext(os.path.basename(a))[0]
                    fp = os.path.join(flow_dir, f"{stem}.png")
                    if os.path.isfile(b) and os.path.isfile(fp):
                        self.samples.append((a, b, fp))
            else:
                raise ValueError(f"unknown pairing {pairing!r}")
        if not self.samples:
            raise FileNotFoundError(f"no KITTI training samples under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        return self.get(idx, epoch=0)

    def get(self, idx: int, epoch: int = 0):
        """Deterministic per-(seed, epoch, idx) sample — the data-iterator
        state needed for exact resume."""
        rng = np.random.default_rng((self.seed, epoch, idx))
        p1, p2, pf = self.samples[idx]
        im1 = load_image(p1).astype(np.float32) / 255.0
        im2 = load_image(p2).astype(np.float32) / 255.0
        flow, valid = read_flow_png(pf)

        if self.augment:
            im1, im2, flow, valid = aug.reduced_affine(im1, im2, flow,
                                                       valid, rng)
        h, w = im1.shape[:2]
        nh, nw = max(h, self.crop_h), max(w, self.crop_w)
        if (nh, nw) != (h, w):  # upsize-if-small, scaling flow vectors
            im1 = resize_bilinear_f32(im1, nh, nw)
            im2 = resize_bilinear_f32(im2, nh, nw)
            flow = _resize_flow(flow, nh, nw)
            valid = resize_nearest(np.asarray(valid, np.float32), nh,
                                    nw) > 0.5
        im1, im2, flow, valid = aug.random_crop(
            (im1, im2, flow, np.asarray(valid)),
            (self.crop_h, self.crop_w), rng)
        if self.augment and rng.random() < self.flip_prob:
            im1, im2, flow, valid = aug.hflip(im1, im2, flow.copy(), valid)
        return {
            "images": np.concatenate([im1, im2], axis=-1).astype(np.float32),
            "flow": flow.astype(np.float32),
            "valid": valid.astype(np.float32),
        }


class KittiPairsEval:
    """KITTI 2012/2015 evaluation pairs with sparse GT.

    2015 layout: image_2/XXXXXX_10.png + _11.png, flow_occ|flow_noc;
    2012 layout: colored_0 (else image_0).  Returns full-resolution uint8
    frames + GT flow + validity (``inference_kitti.py:134-202``).
    """

    def __init__(self, root: str, year: int = 2015, split: str = "training",
                 flow_kind: str = "flow_occ"):
        base = os.path.join(root, split)
        img_dir = None
        for cand in (("image_2",) if year == 2015
                     else ("colored_0", "image_0", "image_2")):
            d = os.path.join(base, cand)
            if os.path.isdir(d):
                img_dir = d
                break
        if img_dir is None:
            raise FileNotFoundError(f"no KITTI image dir under {base}")
        self.flow_dir = os.path.join(base, flow_kind)
        self.pairs = []
        for f in sorted(glob(os.path.join(img_dir, "*_10.png"))):
            s = f.replace("_10.png", "_11.png")
            gt = os.path.join(self.flow_dir, os.path.basename(f))
            if os.path.isfile(s):
                self.pairs.append((f, s, gt if os.path.isfile(gt) else None))
        if not self.pairs:
            raise FileNotFoundError(f"no *_10/_11 pairs in {img_dir}")

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int):
        p1, p2, pf = self.pairs[idx]
        out = {"im1": load_image(p1), "im2": load_image(p2),
               "stem": os.path.splitext(os.path.basename(p1))[0]}
        if pf:
            out["flow"], out["valid"] = read_flow_png(pf)
        return out


class SintelPairs:
    """MPI-Sintel frame pairs with .flo GT for clean/final EPE evaluation."""

    def __init__(self, root: str, render: str = "clean",
                 split: str = "training",
                 sequences: Optional[Sequence[str]] = None):
        img_root = os.path.join(root, split, render)
        flow_root = os.path.join(root, split, "flow")
        if not os.path.isdir(img_root):
            raise FileNotFoundError(img_root)
        self.pairs = []
        for seq in sequences or sorted(os.listdir(img_root)):
            frames = sorted(glob(os.path.join(img_root, seq, "frame_*.png")))
            for a, b in zip(frames[:-1], frames[1:]):
                stem = os.path.splitext(os.path.basename(a))[0]
                gt = os.path.join(flow_root, seq, f"{stem}.flo")
                self.pairs.append((a, b, gt if os.path.isfile(gt) else None,
                                   f"{seq}/{stem}"))
        if not self.pairs:
            raise FileNotFoundError(f"no Sintel pairs under {img_root}")

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int):
        p1, p2, pf, stem = self.pairs[idx]
        out = {"im1": load_image(p1), "im2": load_image(p2), "stem": stem}
        if pf:
            out["flow"] = read_flo(pf)
        return out


class ConsecutiveFrames:
    """frame_t / frame_{t+stride} pairs for self-supervised training, from a
    directory of ``*.png`` / ``*.jpg`` frames (``train_pseudo.py:23-62``),
    each resized to ``size_hw`` and preprocessed with ``preset``.  PNG
    frames need nothing beyond numpy; JPEG frames need imageio or PIL, and
    ``load_image`` says so when neither is installed.  A video file raises:
    the port has no container reader yet (ROADMAP Queue 1 item 3)."""

    def __init__(self, source: str, size_hw: Tuple[int, int] = (384, 512),
                 stride: int = 1, preset: str = "rgb_imagenet"):
        self.size_hw = size_hw
        self.preset = preset
        if not os.path.isdir(source):
            if os.path.exists(source):
                raise NotImplementedError(
                    f"{source!r} is not a directory: reading frames from a "
                    "video file is not ported yet (ROADMAP Queue 1 item 3); "
                    "pass a directory of PNG frames")
            raise FileNotFoundError(source)
        self.frames = sorted(glob(os.path.join(source, "*.png"))
                             + glob(os.path.join(source, "*.jpg")))
        self.stride = stride
        self.index = [(i, i + stride)
                      for i in range(0, len(self.frames) - stride)]
        if not self.index:
            raise FileNotFoundError(f"not enough frames in {source}")

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx: int):
        a, b = self.index[idx]
        h, w = self.size_hw
        im1 = resize_bilinear_u8(load_image(self.frames[a]), h, w)
        im2 = resize_bilinear_u8(load_image(self.frames[b]), h, w)
        return {"images": preprocess_pair(im1, im2, self.preset)[0]}
