"""Evaluation datasets: KITTI 2012/2015 pairs and MPI-Sintel sequences.

The port's counterparts of ``opticalflow_tpu.data.datasets.KittiPairsEval``
and ``SintelPairs``: plain indexable objects returning numpy samples
``{im1, im2, stem[, flow[, valid]]}`` with full-resolution uint8 RGB frames,
decoded by the port's own PNG reader.  The training datasets
(``KittiFlowTrain``, ``ConsecutiveFrames``) need the augmentations and
resizes of ``data/augment.py`` and a video decoder; they are ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Sequence

from opticalflow_tpu_torch.io.flo import read_flo
from opticalflow_tpu_torch.io.images import load_image
from opticalflow_tpu_torch.io.kitti import read_flow_png

__all__ = ["KittiPairsEval", "SintelPairs"]


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
