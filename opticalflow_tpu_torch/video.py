"""Streaming video → flow on the GPU, with host decode and the card
overlapped.

The port's counterpart of ``opticalflow_tpu.video``.  It replaces the
reference's serial loop (``pwc_extract_flow_video.py:219-308``: decode →
upload → forward → readback → draw → encode one pair at a time) with a
pipelined runner:

  * a decode thread fills a frame queue (``io/video.read_frames``);
  * each frame is uploaded once: a window of B+1 consecutive uint8 frames
    goes to the card from a pinned host buffer, and the B pairs are formed
    there (pair tensors would upload every interior frame twice);
  * preprocessing (/255, channel order, optional ImageNet norm) runs on the
    card; ``upload="i420"`` ships planar YUV 4:2:0 instead, half the
    bytes, unpacked on the card bit-exactly to OpenCV
    (:func:`yuv_i420_to_rgb_u8`) and edge-padded to /64 there;
  * ``depth`` windows stay in flight: each result is copied into pinned
    host memory behind a CUDA event, and the host draws window k while the
    card computes window k+1;
  * one readback per window, quarter-resolution flow, or with
    ``grid_step`` the flow decimated on the card to the arrow grid
    (:func:`decimate_flow`, ~16× fewer bytes again);
  * with ``mesh`` (``parallel.mesh.Mesh``: one process a card) each
    window's pairs are split over the ranks: rank 0 reads the stream and
    broadcasts each window, every rank computes its share, and an
    all-gather hands every rank every flow.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU
and no explicit device it raises.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opticalflow_tpu_torch.engine import resolve_device
from opticalflow_tpu_torch.io import images as imio
from opticalflow_tpu_torch.io.video import read_frames
from opticalflow_tpu_torch.io.yuv import pad_to_even
from opticalflow_tpu_torch.models.torch_import import reference_state_dict
from opticalflow_tpu_torch.parallel import mesh as meshlib
from opticalflow_tpu_torch.runtime.mpeg4 import to_i420

__all__ = ["VideoFlowRunner", "frame_pairs_from_video", "decimate_flow",
           "yuv_i420_to_rgb_u8"]

_SHIFT = 20


def yuv_i420_to_rgb_u8(yuv: torch.Tensor) -> torch.Tensor:
    """I420 → RGB on the device, bit-exact to ``cv2.COLOR_YUV2RGB_I420``
    (``io.yuv.i420_to_rgb`` is its plain version).

    ``yuv`` is (B, H·3/2, W) uint8: the Y plane, then the 2×-subsampled U
    and V planes back to back.  OpenCV's integer math: BT.601 video range
    at shift 20, round half up, 2×2 nearest chroma.  The chroma is sliced
    by element count: when H % 4 != 0 the U/V boundary falls inside a row.
    """
    b, h32, w = yuv.shape
    if h32 % 3 or (h32 * 2 // 3) % 2 or w % 2:
        raise ValueError(
            f"bad I420 packed shape {tuple(yuv.shape)}: rows must be H*3/2 "
            f"with H and W even (got packed rows {h32}, width {w})")
    h = h32 * 2 // 3
    y = (yuv[:, :h].to(torch.int32) - 16).clamp_(min=0) * 1220542
    ce = (h // 2) * (w // 2)
    chroma = yuv[:, h:].reshape(b, 2 * ce)
    u = chroma[:, :ce].reshape(b, h // 2, w // 2).to(torch.int32) - 128
    v = chroma[:, ce:].reshape(b, h // 2, w // 2).to(torch.int32) - 128
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    half = 1 << (_SHIFT - 1)
    r = (y + 1673527 * v + half) >> _SHIFT
    g = (y - 852492 * v - 409993 * u + half) >> _SHIFT
    bl = (y + 2116026 * u + half) >> _SHIFT
    return torch.stack([r, g, bl], dim=-1).clamp_(0, 255).to(torch.uint8)


def decimate_flow(flow: torch.Tensor, grid_step: int, frame_h: int,
                  frame_w: int) -> torch.Tensor:
    """Grid decimation of (B, Hq, Wq, 2) quarter-res flow on the device.

    The host path, ``viz.overlay.resize_flow_np(flow, frame_h, frame_w)``
    (half-pixel bilinear, vectors rescaled by ``frame_w/Wq``,
    ``frame_h/Hq``) read at every ``grid_step``-th pixel, sampled directly:
    ``g[b, i, j]`` is the full-res flow vector at frame pixel
    ``(j*grid_step, i*grid_step)``.  The overlays read only those pixels, so
    the readback ships the grid, not the field.
    """
    b, hq, wq, _ = flow.shape
    dev = flow.device
    gy = torch.arange(0, frame_h, grid_step, dtype=torch.float32, device=dev)
    gx = torch.arange(0, frame_w, grid_step, dtype=torch.float32, device=dev)
    fy = ((gy + 0.5) * (hq / frame_h) - 0.5).clamp(0.0, hq - 1.0)
    fx = ((gx + 0.5) * (wq / frame_w) - 0.5).clamp(0.0, wq - 1.0)
    y0 = fy.floor().long().clamp(max=max(hq - 2, 0))
    x0 = fx.floor().long().clamp(max=max(wq - 2, 0))
    wy = (fy - y0)[None, :, None, None]
    wx = (fx - x0)[None, None, :, None]
    r0 = flow[:, y0]
    r1 = flow[:, (y0 + 1).clamp(max=hq - 1)]
    x1 = (x0 + 1).clamp(max=wq - 1)
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out * torch.tensor([frame_w / wq, frame_h / hq], dtype=out.dtype,
                              device=dev)


def frame_pairs_from_video(path: str, max_frames: Optional[int] = None,
                           stride: int = 1) -> Iterator[np.ndarray]:
    """Yield BGR frames of a video file (``.mp4``, ``.avi``, ``.mkv``,
    ``.webm`` of MPEG-4 Part 2, MPEG-1/2, VP8, VP9, FFV1 or Motion JPEG;
    ``.mpg``/``.mpeg``/``.vob``; ``.ts``/``.m2ts``/``.mts``; ``.m2v``/
    ``.h263``; ``.y4m``),
    image sequence (``frames/%06d.jpg``) or frame directory, decoded by a
    thread that fills a bounded queue; a decode error is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=64)
    done = object()

    def decode():
        try:
            for frame in read_frames(path, max_frames, stride):
                q.put(frame)
        except BaseException as e:  # surface on the consumer's thread
            q.put(e)
            return
        q.put(done)

    threading.Thread(target=decode, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


class VideoFlowRunner:
    """Batched streaming flow over consecutive frame pairs.

    Args:
      model: the network (an ``nn.Module`` taking (B, 6, H, W) and giving
        quarter-res (B, 2, H/4, W/4) flow in network units), moved to
        ``device``.
      weights: a state dict to load into it (reference layout, as
        ``FlowEngine`` takes), or None to keep the model's own.
      preset: "rgb_unit" (the reference video scripts' convention,
        ``pwc_extract_flow_video.py:27-34``), "bgr_unit", or "rgb_imagenet".
      flow_scale: 1.0 for the repo's self-trained checkpoints, 20.0 for the
        canonical Sintel weights.
      batch: frame pairs per forward.  depth: windows in flight.
      mesh: a ``parallel.mesh.Mesh`` to split each window's pairs over its
        ranks (JAX's ``mesh=``, one process a card here): ``batch`` must
        divide by the ranks, the runner computes on ``mesh.device``, and
        the weights are checked equal on every rank and broadcast from
        rank 0 (``replicate``).  Rank 0 reads ``frames``; the others pass
        None to :meth:`run` (what they pass is not read).  Before each
        window rank 0 broadcasts a header (the window's real pairs and its
        frame size; zero pairs end the stream), then the window's frames
        as read, which every rank needs for its triples (host memory under
        gloo, which cannot send card memory); each rank uploads and runs
        its ``batch / world`` pairs (``batch / world + 1`` frames), a
        partial last window padded as without a mesh, and
        ``all_gather_rows`` hands every rank every flow, so every rank
        yields the same triples.
      grid_step: decimate the flow on the card to that arrow grid.
      upload: "bgr" ships RGB uint8 windows padded to /64 on the host;
        "i420" ships each frame's planar YUV 4:2:0 at its (even) size, half
        the bytes, converted on the host by ``runtime.mpeg4.to_i420``
        (OpenCV's arithmetic, in C) and unpacked and padded on the card.  The
        only fidelity cost is the 4:2:0 chroma subsample itself.

    ``stats`` counts windows and bytes uploaded (and, with a mesh, the
    bytes broadcast a rank), and the host's seconds spent forming windows
    and issuing their copies (``upload_s``), issuing the forwards and
    readbacks (``issue_s``) and waiting on readbacks (``wait_s``).
    """

    def __init__(self, model: nn.Module,
                 weights: Union[Mapping, nn.Module, None] = None, *,
                 preset: str = "rgb_unit", flow_scale: float = 1.0,
                 batch: int = 4, depth: int = 2, mesh=None,
                 grid_step: Optional[int] = None, upload: str = "bgr",
                 device: Union[str, torch.device, None] = None):
        if mesh is not None:
            if not isinstance(mesh, meshlib.Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            if batch % mesh.world:
                raise ValueError(f"batch {batch} not divisible by mesh size "
                                 f"{mesh.world}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        if preset not in imio.PREPROC_PRESETS:
            raise ValueError(f"unknown preprocessing preset {preset!r}")
        if upload not in ("bgr", "i420"):
            raise ValueError(f"unknown upload mode {upload!r}")
        self.device = resolve_device(device)
        if weights is not None:
            model.load_state_dict(
                weights.state_dict() if isinstance(weights, nn.Module)
                else reference_state_dict(weights))
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            meshlib.replicate(self.model, mesh)
        self.preset = preset
        self.flow_scale = float(flow_scale)
        self.batch = int(batch)
        self.depth = int(depth)
        self.grid_step = grid_step
        self.upload = upload
        self._pinned = self.device.type == "cuda"
        self._mean = torch.tensor(imio.IMAGENET_MEAN,
                                  device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(imio.IMAGENET_STD,
                                 device=self.device).view(1, 3, 1, 1)
        self.stats = {"windows": 0, "bytes_uploaded": 0, "upload_s": 0.0,
                      "issue_s": 0.0, "wait_s": 0.0}
        if mesh is not None:
            self.stats["bytes_broadcast"] = 0

    # ------------------------------------------------------------ device side

    def _step(self, frames: torch.Tensor, frame_h: int,
              frame_w: int) -> torch.Tensor:
        """One window on the device: (B+1, H64, W64, 3) uint8 RGB, or
        (B+1, He·3/2, We) I420 at the even frame size → (B, hq, wq, 2)
        scaled flow (or its grid)."""
        if self.upload == "i420":
            frames = yuv_i420_to_rgb_u8(frames)
        x = (frames.float() / 255.0).permute(0, 3, 1, 2)
        he, we = x.shape[2:]
        ph, pw = (64 - he % 64) % 64, (64 - we % 64) % 64
        if ph or pw:         # i420 only: bgr windows arrive padded
            x = F.pad(x, (0, pw, 0, ph), mode="replicate")
        if self.preset == "bgr_unit":
            x = x.flip(1)
        elif self.preset == "rgb_imagenet":
            x = (x - self._mean) / self._std
        pairs = torch.cat([x[:-1], x[1:]], dim=1)
        flow = (self.model(pairs) * self.flow_scale).permute(0, 2, 3, 1)
        if self.grid_step is not None:
            flow = decimate_flow(flow, self.grid_step, frame_h, frame_w)
        return flow.contiguous()

    # -------------------------------------------------------------- host side

    def _pad(self, frame: np.ndarray) -> np.ndarray:
        h, w = frame.shape[:2]
        ph, pw = (64 - h % 64) % 64, (64 - w % 64) % 64
        if ph or pw:
            frame = np.pad(frame, ((0, ph), (0, pw), (0, 0)), mode="edge")
        return frame

    def _pack(self, frame: np.ndarray, channel_order: str) -> np.ndarray:
        """One frame as it is uploaded: RGB padded to /64, or I420 at its
        even size (the /64 pad happens on the card, so no padding bytes
        are uploaded)."""
        if self.upload == "i420":
            return to_i420(pad_to_even(frame), channel_order)
        rgb = frame[..., ::-1] if channel_order == "bgr" else frame
        return self._pad(rgb)

    def _to_device(self, window) -> torch.Tensor:
        """Stack a window into (pinned) host memory and queue its copy."""
        host = torch.empty((len(window),) + window[0].shape,
                           dtype=torch.uint8, pin_memory=self._pinned)
        np.stack(window, out=host.numpy())
        self.stats["bytes_uploaded"] += host.numel()
        return host.to(self.device, non_blocking=True)

    def _readback(self, out: torch.Tensor):
        """Queue the result's copy into pinned host memory; the event says
        when it has landed."""
        if not out.is_cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _windows(self, frames: Iterator[np.ndarray]):
        """Lists of B+1 consecutive frames, each window's last frame the
        next one's first (it opens that window's first pair), and a last
        shorter window."""
        window = []
        for frame in frames:
            window.append(frame)
            if len(window) == self.batch + 1:
                yield window
                window = [frame]
        if len(window) > 1:
            yield window

    def _mesh_windows(self, frames):
        """:meth:`_windows` on rank 0, broadcast to every rank: a header
        (real pairs, frame shape) and the window's frames; zero pairs end
        the stream."""
        mesh = self.mesh
        source = self._windows(frames) if mesh.rank == 0 else None
        while True:
            window = next(source, None) if source is not None else None
            header = torch.zeros(5, dtype=torch.int64)
            if window is not None:
                header[0] = len(window) - 1
                header[1:1 + window[0].ndim] = torch.tensor(window[0].shape)
            meshlib.broadcast_(header, mesh)
            n_real, shape = int(header[0]), tuple(
                int(v) for v in header[1:] if v)
            if n_real == 0:
                return
            payload = torch.from_numpy(
                np.stack(window) if window is not None
                else np.empty((n_real + 1,) + shape, np.uint8))
            meshlib.broadcast_(payload, mesh)
            self.stats["bytes_broadcast"] += (header.numel() * 8
                                              + payload.numel())
            yield window if window is not None else list(payload.numpy())

    def _submit(self, window, channel_order: str):
        """Upload the window (this rank's share of it with a mesh) and queue
        its forward and readback: (host result, event, real pairs, the
        pairs' original frames)."""
        t0 = time.perf_counter()
        n_real = len(window) - 1
        fh, fw = window[0].shape[:2]     # the real (unpadded) size
        # a final partial window is padded up to B+1 frames: one shape for
        # the whole stream
        frames = window + [window[-1]] * (self.batch + 1 - len(window))
        if self.mesh is not None:
            per = self.batch // self.mesh.world
            frames = frames[self.mesh.rank * per:(self.mesh.rank + 1) * per
                            + 1]
        packed, memo = [], {}
        for f in frames:
            if id(f) not in memo:
                memo[id(f)] = self._pack(f, channel_order)
            packed.append(memo[id(f)])
        with torch.inference_mode():
            dev_frames = self._to_device(packed)
            t1 = time.perf_counter()
            out = self._step(dev_frames, fh, fw)
            if self.mesh is not None:
                out = meshlib.all_gather_rows(
                    out if self.mesh.backend == "nccl" else out.cpu(),
                    self.mesh)
            entry = (*self._readback(out), n_real,
                     list(zip(window[:-1], window[1:])))
        self.stats["windows"] += 1
        self.stats["upload_s"] += t1 - t0
        self.stats["issue_s"] += time.perf_counter() - t1
        return entry

    def run(self, frames: Optional[Iterator[np.ndarray]],
            channel_order: str = "bgr"
            ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (frame_t, frame_t1, flow) per consecutive pair, both
        original frames beside the flow that belongs to them.

        ``flow`` is the (H64/4, W64/4, 2) quarter-res field in pixel units at
        that scale (``viz.overlay.resize_flow_np`` draws it at frame size),
        or with ``grid_step`` the decimated (gh, gw, 2) grid in full-res
        pixel units (see :func:`decimate_flow`).  With a mesh, ranks other
        than 0 pass ``frames=None`` and yield the same triples as rank 0.
        """
        windows = (self._windows(frames) if self.mesh is None
                   else self._mesh_windows(frames))
        inflight = collections.deque()
        for window in windows:
            inflight.append(self._submit(window, channel_order))
            while len(inflight) > self.depth:
                yield from self._drain(inflight.popleft())
        while inflight:
            yield from self._drain(inflight.popleft())

    def _drain(self, entry):
        """One readback per window: wait for its copy, then hand out its
        pairs."""
        host, event, n_real, metas = entry
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        out = host.cpu().numpy()[:n_real]
        self.stats["wait_s"] += time.perf_counter() - t0
        for k, (m0, m1) in enumerate(metas):
            yield m0, m1, out[k]
