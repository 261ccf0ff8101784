"""Deployable-artifact export and its parity check, on the GPU.

Counterpart of ``opticalflow_tpu.export``, with a ``torch.export`` program
(a ``.pt2`` file) in place of StableHLO:

  * :func:`export_program`: the forward (NCHW input (B, 6, H, W) → the
    descaled quarter-res flow (B, 2, H/4, W/4)) as a ``torch.export``
    program, written with ``torch.export.save``.  The correlation is one
    operator node (``opticalflow_tpu_torch::correlation``, from
    ``ops/correlation.py``): on CUDA tensors it launches the hand-written
    kernel, counted by ``correlation_cuda.launches``, or raises; on CPU
    tensors it runs the plain version.  A model built with
    ``use_cuda_corr=False`` exports the plain correlation's operators
    instead.  The model's precision is stored with the artifact: an
    exported program does not carry PyTorch's global TF32 switches, which
    the model sets around its forward, and cuDNN uses TF32 by default;
  * :func:`load_exported`: load an artifact → a callable that runs it
    under the stored precision's TF32 switches;
  * :func:`parity_check`: the model and the artifact on one random input,
    the reference harness's metric set (``onnx_pth_compare.py:133-201``)
    and a 2×2 report image drawn without matplotlib.

``dynamic`` keeps the JAX package's three meanings: ``None`` the shape of
``input_shape``; ``"batch"`` a symbolic batch; ``"all"`` batch × ``64*h``
× ``64*w``.  Sizes of 1 are traced size-obliviously, so one ``"all"``
artifact serves a 64-pixel side, whose level-6 features are 1 pixel wide.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# ops.correlation registers the operator that a loaded program calls
import opticalflow_tpu_torch.ops.correlation  # noqa: F401
from opticalflow_tpu_torch.models.pwcnet import _tf32
from opticalflow_tpu_torch.utils.metrics import parity_report

__all__ = ["export_program", "load_exported", "parity_check",
           "report_figure", "EXTRA_FILE"]

#: the artifact's extra file holding its precision, flow scale and dynamic
EXTRA_FILE = "opticalflow_tpu_torch.json"
# the example a dynamic export traces: no dimension 1 (torch would fix it)
_EXAMPLE_BATCH = 2
_EXAMPLE_HW = (128, 192)


class _Forward(nn.Module):
    """input → quarter-res flow × flow_scale."""

    def __init__(self, model: nn.Module, flow_scale: float):
        super().__init__()
        self.model = model
        self.flow_scale = float(flow_scale)

    def forward(self, x):
        return self.model(x) * self.flow_scale


def _check_shape(input_shape) -> Tuple[int, int, int, int]:
    if len(input_shape) != 4 or input_shape[1] != 6:
        raise ValueError(f"input_shape is NCHW (B, 6, H, W), got "
                         f"{tuple(input_shape)}")
    b, c, h, w = (int(v) for v in input_shape)
    if b < 1 or h < 64 or w < 64 or h % 64 or w % 64:
        raise ValueError(f"input_shape needs B >= 1 and H, W multiples of 64, "
                         f"got {tuple(input_shape)}")
    return b, c, h, w


def export_program(model: nn.Module, path: str,
                   input_shape: Tuple[int, ...] = (1, 6, 256, 256),
                   flow_scale: float = 20.0,
                   dynamic: Optional[str] = None) -> str:
    """Export ``model``'s forward (×``flow_scale``) to ``path`` (a ``.pt2``
    file) on the model's device; returns ``path``.

    ``dynamic``: ``None`` for the shape ``input_shape`` (NCHW); ``"batch"``
    for any batch at its H and W; ``"all"`` for any batch and any H, W
    that are multiples of 64.  A dynamic export traces an example of batch
    2 (and 128×192 for ``"all"``); the artifact checks each input against
    its shapes.  The model's ``precision`` (``"highest"``: TF32 off, which
    the loaded artifact runs under), ``flow_scale`` and ``dynamic`` are
    stored in the artifact's extra file :data:`EXTRA_FILE`."""
    b, c, h, w = _check_shape(input_shape)
    batch = torch.export.Dim("batch", min=1)
    if dynamic is None:
        example, shapes = (b, c, h, w), None
    elif dynamic == "batch":
        example, shapes = (_EXAMPLE_BATCH, c, h, w), ({0: batch},)
    elif dynamic == "all":
        h64 = torch.export.Dim("h64", min=1)
        w64 = torch.export.Dim("w64", min=1)
        example = (_EXAMPLE_BATCH, c) + _EXAMPLE_HW
        shapes = ({0: batch, 2: 64 * h64, 3: 64 * w64},)
    else:
        raise ValueError(f"dynamic must be None, 'batch' or 'all', "
                         f"got {dynamic!r}")
    p = next(model.parameters())
    x = torch.zeros(example, dtype=torch.float32, device=p.device)
    fwd = _Forward(model.eval(), flow_scale)
    import torch.fx.experimental._config as fx_config
    from torch._dynamo.exc import UserError
    from torch.fx.experimental.symbolic_shapes import (
        ConstraintViolationError, GuardOnDataDependentSymNode)
    try:
        # size-oblivious: a dimension that is 1 at some shapes (the level-6
        # features of a 64-pixel side) is not fixed by the example's guards
        with torch.no_grad(), fx_config.patch(
                backed_size_oblivious=dynamic is not None):
            ep = torch.export.export(fwd, (x,), dynamic_shapes=shapes)
    except (UserError, ConstraintViolationError,
            GuardOnDataDependentSymNode) as e:
        if dynamic is None:
            raise
        raise ValueError(
            f"dynamic={dynamic!r} export needs a forward whose graph does "
            "not depend on the free dimensions, but the model fixes one (a "
            "Python branch or an assertion on a shape; the error below names "
            "it): remove that branch from the forward, or export with "
            "dynamic=None at the serving shape") from e
    meta = {"precision": getattr(model, "precision", "highest"),
            "flow_scale": float(flow_scale), "dynamic": dynamic}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path, extra_files={EXTRA_FILE: json.dumps(meta)})
    return path


class ExportedFlow:
    """A loaded artifact: ``artifact(x)`` runs the program on x (NCHW, a
    tensor or an array, moved to the artifact's device) under the stored
    precision's TF32 switches, in inference mode.  ``metadata`` is its
    extra file, ``program`` the ``ExportedProgram``."""

    def __init__(self, program, metadata: Dict):
        self.program = program
        self.metadata = metadata
        self._module = program.module()
        self._fast = metadata.get("precision", "highest") == "fast"
        tensors = list(program.state_dict.values())
        self.device = tensors[0].device if tensors else torch.device("cpu")

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode(), _tf32(self._fast):
            return self._module(x)


def load_exported(path: str) -> ExportedFlow:
    """Load an artifact of :func:`export_program` → :class:`ExportedFlow`."""
    extra = {EXTRA_FILE: ""}
    ep = torch.export.load(path, extra_files=extra)
    return ExportedFlow(ep, json.loads(extra[EXTRA_FILE] or "{}"))


def parity_check(model: nn.Module, artifact_path: str,
                 input_shape: Tuple[int, ...] = (1, 6, 256, 256),
                 flow_scale: float = 20.0,
                 report_image: Optional[str] = None,
                 seed: int = 0) -> Dict[str, float]:
    """The model against the artifact on one random input: the input is
    ``RandomState(seed).rand`` of the JAX package's NHWC shape (B, H, W, 6),
    transposed to NCHW, so both packages see the same numbers.  Returns
    ``utils.metrics.parity_report(artifact, model)`` over the (B, H/4, W/4,
    2) flows; ``report_image`` writes the 2×2 figure of the first pair."""
    b, c, h, w = _check_shape(input_shape)
    x = np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)
    p = next(model.parameters())
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    xt = xt.to(p.device)
    with torch.inference_mode():
        src = model.eval()(xt) * flow_scale
    art = load_exported(artifact_path)(xt)
    src = src.permute(0, 2, 3, 1).float().cpu().numpy()
    art = art.permute(0, 2, 3, 1).float().cpu().numpy()
    rep = parity_report(art, src)
    if report_image:
        from opticalflow_tpu_torch.io.images import encode_png
        fig, _ = report_figure(src[0], art[0], rep)
        os.makedirs(os.path.dirname(os.path.abspath(report_image)),
                    exist_ok=True)
        with open(report_image, "wb") as f:
            f.write(encode_png(fig))
    return rep


_TITLE_H = 30           # a panel's title strip, px
_LINE_H = 22            # a line of the metrics panel, px
_GAP = 10               # between and around the panels, px


def report_figure(src_flow: np.ndarray, art_flow: np.ndarray,
                 rep: Dict[str, float]):
    """The parity report's 2×2 figure (the reference harness's overlay
    report, ``onnx_pth_compare.py:281-349``) as a uint8 RGB image, and its
    panels ``{name: (y, x, panel)}``: ``"source"`` and ``"artifact"``, the
    two (h, w, 2) flows by ``viz.colorwheel.flow_to_color``; ``"epe"``, the
    per-pixel EPE by matplotlib's ``magma`` over [min, max] of the map;
    ``"metrics"``, ``rep`` as text.  The flows are enlarged by an integer
    factor (nearest) to at least 256 pixels on their longer side."""
    from opticalflow_tpu_torch.viz.colorwheel import flow_to_color, magma_rgb
    from opticalflow_tpu_torch.viz.text import put_text
    h, w = src_flow.shape[:2]
    k = max(1, 256 // max(h, w))
    err = np.sqrt(((np.asarray(src_flow, np.float64)
                    - np.asarray(art_flow, np.float64)) ** 2).sum(-1))
    lo, hi = float(err.min()), float(err.max())
    norm = (err - lo) / (hi - lo) if hi > lo else np.zeros_like(err)

    def big(img):
        return np.repeat(np.repeat(img, k, axis=0), k, axis=1)

    lines = [f"{name}: {v:.6g}" for name, v in rep.items()]
    cell_w = max(k * w, 300)
    cell_h = max(k * h, _LINE_H * len(lines) + _GAP)
    panels = {"source": big(flow_to_color(src_flow)),
              "artifact": big(flow_to_color(art_flow)),
              "epe": big(magma_rgb(norm))}
    text = np.full((cell_h, cell_w, 3), 255, np.uint8)
    for i, line in enumerate(lines):
        put_text(text, line, (4, _LINE_H * (i + 1) - 4), 0.6, (0, 0, 0))
    panels["metrics"] = text
    titles = {"source": "source model", "artifact": "exported artifact",
              "epe": f"EPE map, {lo:.3g} to {hi:.3g}", "metrics": "metrics"}
    fig_h = 2 * (cell_h + _TITLE_H) + 3 * _GAP
    fig_w = 2 * cell_w + 3 * _GAP
    fig = np.full((fig_h, fig_w, 3), 255, np.uint8)
    placed = {}
    for i, name in enumerate(("source", "artifact", "epe", "metrics")):
        r, c = divmod(i, 2)
        y = _GAP + r * (cell_h + _TITLE_H + _GAP) + _TITLE_H
        x = _GAP + c * (cell_w + _GAP)
        panel = panels[name]
        fig[y:y + panel.shape[0], x:x + panel.shape[1]] = panel
        put_text(fig, titles[name], (x, y - 8), 0.7, (0, 0, 0))
        placed[name] = (y, x, panel)
    return fig, placed
