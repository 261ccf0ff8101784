"""FlowEngine — single-pair and batched inference on the GPU.

Counterpart of ``opticalflow_tpu.engine.FlowEngine``, with the same public
contract: numpy uint8 (H, W, 3) RGB frames in, numpy float32 (N, H, W, 2)
flow out.  Frames go to the device as uint8 (a quarter of the bytes of a
float32 batch) and are preprocessed there; the forward, the ×flow_scale
descale and the flow upsampling follow on the device, and only decode,
the /64 resize or pad, and file I/O stay on the host.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU and
no explicit device it raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opticalflow_tpu_torch.io import images as imio
from opticalflow_tpu_torch.models.pwcnet import FLOW_SCALE, PWCDCNet
from opticalflow_tpu_torch.models.torch_import import reference_state_dict
from opticalflow_tpu_torch.ops.resize import (flow_resize,
                                              resize_linear_antialiased)

__all__ = ["FlowEngine", "resolve_device"]

_BGR_ORDER = [2, 1, 0, 5, 4, 3]


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises if a CUDA device is asked for and
    none is available: nothing falls back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(CLI: --device cpu) to run on the CPU")
    return dev


def _as_uint8_frame(im, what: str) -> np.ndarray:
    """Validate/convert one frame for the uint8 upload path: exactly
    integral [0, 255] values of any dtype convert losslessly, anything else
    (e.g. frames already normalised to [0, 1]) fails loudly instead of
    returning plausible garbage flow."""
    a = np.asarray(im)
    if a.dtype == np.uint8:
        return a
    if (np.issubdtype(a.dtype, np.integer)
            or (np.issubdtype(a.dtype, np.floating)
                and np.all(a == np.rint(a)))):
        if a.size and (a.min() < 0 or a.max() > 255):
            raise TypeError(f"{what} has values outside [0, 255] "
                            f"(dtype {a.dtype}) — pass uint8 frames")
        return a.astype(np.uint8)
    raise TypeError(
        f"{what} must be uint8 (or exactly-integral [0, 255]) — got "
        f"non-integral {a.dtype} values; if the frames were normalized to "
        f"[0, 1], multiply by 255 and round, or decode to uint8 directly")


class FlowEngine:
    """Batched optical-flow inference.

    Args:
      model: a :class:`PWCDCNet`; the engine loads ``weights`` into it and
        moves it to ``device``.
      weights: a state dict (reference layout, tensors or numpy arrays;
        ``module.`` prefixes and the dead ``deconv2`` are tolerated) or an
        ``nn.Module`` whose state dict to copy.
      flow_scale: multiplier on the raw network output; 20.0 for the
        canonical Sintel weights (``script_pwc.py:72``), 1.0 for the
        reference's fine-tuned checkpoints (``train.py:71-72``).
      device: ``"cuda"`` (the default) or ``"cpu"``.
      dispatch_chunk: optional sub-batch size: a batch larger than and
        divisible by it runs as consecutive forwards of that size, which
        bounds the activation memory.
    """

    def __init__(self, model: PWCDCNet, weights: Union[Mapping, nn.Module],
                 *, flow_scale: float = FLOW_SCALE,
                 device: Union[str, torch.device, None] = None,
                 dispatch_chunk: Optional[int] = None):
        self.device = resolve_device(device)
        if dispatch_chunk is not None:
            dispatch_chunk = int(dispatch_chunk)
            if dispatch_chunk < 1:
                raise ValueError(
                    f"dispatch_chunk must be >= 1, got {dispatch_chunk}")
        self.dispatch_chunk = dispatch_chunk
        self.flow_scale = float(flow_scale)
        sd = (weights.state_dict() if isinstance(weights, nn.Module)
              else reference_state_dict(weights))
        model.load_state_dict(sd)
        self.model = model.to(self.device).eval()
        self._mean6 = torch.from_numpy(
            np.tile(imio.IMAGENET_MEAN, 2)).to(self.device)
        self._std6 = torch.from_numpy(
            np.tile(imio.IMAGENET_STD, 2)).to(self.device)

    # ------------------------------------------------------------ device side

    def _preprocess(self, xu8: torch.Tensor, preset: str) -> torch.Tensor:
        """uint8 (b, H, W, 6) on the device → float32 (b, 6, H, W), the
        same float32 elementwise math as the JAX engine."""
        x = xu8.float() / 255.0
        if preset == "bgr_unit":
            x = x[..., _BGR_ORDER]
        elif preset == "rgb_imagenet":
            x = (x - self._mean6) / self._std6
        return x.permute(0, 3, 1, 2).contiguous()

    def _quarter_flow_u8(self, xu8: np.ndarray, preset: str) -> torch.Tensor:
        """uint8 (B, H64, W64, 6) frames → scaled quarter-res flow
        (B, 2, H64/4, W64/4) on the device."""
        x = torch.from_numpy(np.ascontiguousarray(xu8)).to(self.device)
        b, chunk = x.shape[0], self.dispatch_chunk
        parts = (x.split(chunk) if chunk and b > chunk and b % chunk == 0
                 else [x])
        q = torch.cat([self.model(self._preprocess(p, preset))
                       for p in parts])
        return q * self.flow_scale

    # -------------------------------------------------------------- public API

    def flow_from_pair(self, im1: np.ndarray, im2: np.ndarray, *,
                       preset: str = "bgr_unit",
                       size_mode: str = "resize",
                       image_size: Optional[Tuple[int, int]] = None
                       ) -> np.ndarray:
        """uint8 RGB frame pair → (H, W, 2) flow at the original resolution.

        ``size_mode="resize"`` follows the canonical CLI
        (``script_pwc.py:47-81``): distorting resize to /64, infer, resize
        the quarter-res flow half-pixel straight back to (H, W), then scale
        u by W/W64 and v by H/H64.

        ``size_mode="pad"`` is the corrected evaluation path: replicate-pad
        to /64, infer, upsample the quarter-res flow to the padded size
        (align_corners=True), crop to (H, W).

        ``size_mode="pad_ref"`` keeps the reference's own order on purpose
        (``inference_kitti.py:216-224``): the quarter-res flow is unpadded
        by the FULL-res pad counts, then resized to (H, W) with an
        anisotropic vector rescale, for parity with metrics the reference
        computed.

        ``image_size`` is the fixed input size of ``size_mode=
        "resize_fixed"`` (the v1 script), which is not ported and raises;
        the other modes take ``None``, as the JAX engine's signature does.
        """
        return self.flow_from_pairs([im1], [im2], preset=preset,
                                    size_mode=size_mode,
                                    image_size=image_size)[0]

    def flow_from_pairs(self, im1s, im2s, *, preset: str = "bgr_unit",
                        size_mode: str = "resize",
                        image_size: Optional[Tuple[int, int]] = None
                        ) -> np.ndarray:
        """Batched :meth:`flow_from_pair`: N pairs of one common frame shape
        → (N, H, W, 2), one batched forward."""
        if len(im1s) != len(im2s) or not len(im1s):
            raise ValueError("im1s/im2s must be equal-length, non-empty")
        if preset not in imio.PREPROC_PRESETS:
            raise ValueError(f"unknown preprocessing preset {preset!r}; "
                             f"choose from {imio.PREPROC_PRESETS}")
        if size_mode == "resize_fixed":
            raise NotImplementedError(
                "size_mode='resize_fixed' (PIL resize to a fixed size) is not "
                "ported yet (ROADMAP Queue 1 item 2)")
        if size_mode not in ("resize", "pad", "pad_ref"):
            raise ValueError("size_mode must be 'resize', 'pad' or "
                             f"'pad_ref', got {size_mode!r}")
        h, w = im1s[0].shape[:2]
        for im in (*im1s, *im2s):
            if im.shape[:2] != (h, w):
                raise ValueError(
                    "flow_from_pairs needs one common frame shape per call; "
                    f"got {im.shape[:2]} vs {(h, w)} — group by shape first")
        im1s = [_as_uint8_frame(im, "im1") for im in im1s]
        im2s = [_as_uint8_frame(im, "im2") for im in im2s]
        with torch.inference_mode():
            if size_mode == "resize":
                flow = self._flow_resize(im1s, im2s, preset, h, w)
            else:
                flow = self._flow_pad(im1s, im2s, preset, size_mode, h, w)
            return flow.permute(0, 2, 3, 1).cpu().numpy()

    def _flow_resize(self, im1s, im2s, preset, h, w) -> torch.Tensor:
        x = np.stack([np.concatenate(
            (imio.resize_to_multiple_of_64(a)[0],
             imio.resize_to_multiple_of_64(b)[0]), axis=-1)
            for a, b in zip(im1s, im2s)])
        h64, w64 = x.shape[1:3]
        q = self._quarter_flow_u8(x, preset)
        if h < q.shape[2] or w < q.shape[3]:
            # a side under 16 px: the quarter-res flow shrinks there, and
            # the JAX engine's jax.image.resize antialiases when it shrinks
            flow = resize_linear_antialiased(q, h, w)
        else:
            # half-pixel bilinear upsampling, which is what jax.image.resize
            # (method="linear") and cv2.resize compute when enlarging; one
            # interpolation kernel, where resize_linear_antialiased would
            # take dense products over whole axes (112x436 and 256x1024
            # weights at Sintel size) for the same values
            flow = F.interpolate(q, size=(h, w), mode="bilinear",
                                 align_corners=False)
        scale = torch.tensor([np.float32(w / float(w64)),
                              np.float32(h / float(h64))],
                             dtype=torch.float32, device=flow.device)
        return flow * scale.view(1, 2, 1, 1)

    def _flow_pad(self, im1s, im2s, preset, size_mode, h, w) -> torch.Tensor:
        x = np.stack([np.concatenate((a, b), axis=-1)
                      for a, b in zip(im1s, im2s)])
        xp, ph, pw = imio.pad_to_multiple_of_64(x)
        hp, wp = xp.shape[1:3]
        if size_mode == "pad_ref" and (ph >= hp // 4 or pw >= wp // 4):
            raise ValueError(
                "pad_ref (the reference's unpad-quarter-by-full-pad order) "
                f"slices the quarter-res flow {hp // 4}x{wp // 4} by "
                f"({ph}, {pw}) — empty result for this frame size; use "
                "size_mode='pad'")
        q = self._quarter_flow_u8(xp, preset)
        if size_mode == "pad_ref":
            q = q[:, :, :q.shape[2] - ph, :q.shape[3] - pw]
            return flow_resize(q, h, w)
        return flow_resize(q, hp, wp)[:, :, :h, :w]

    def warmup(self, height: int, width: int, batch: int = 1,
               size_modes=("resize", "pad"),
               preset: str = "bgr_unit") -> None:
        """Run each size mode once on zero frames of this ORIGINAL size, so
        the first real request does not pay the kernel build and cuDNN's
        first-call set-up."""
        z = np.zeros((height, width, 3), np.uint8)
        for mode in size_modes:
            self.flow_from_pairs([z] * batch, [z] * batch, preset=preset,
                                 size_mode=mode)
