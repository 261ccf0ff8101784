"""PWC-DC optical-flow network in PyTorch (NCHW).

Counterpart of ``opticalflow_tpu.models.pwcnet`` and of the reference
architecture (``models/PWCNet.py:40-273`` for ``PWCDCNet``, ``:277-492`` for
``PWCDCNet_old``): a 6-level siamese feature pyramid, per-level masked
bilinear backward warp of image-2 features, a max-displacement-4
correlation cost volume, DenseNet-style flow estimators and a dilated
context network whose residual refines the finest flow.

Modules carry the reference's state-dict names (``conv1a.0.weight``,
``predict_flow2.weight``, ``deconv6.weight``, ...), so a reference
checkpoint loads with ``load_state_dict`` after the ``module.`` strip; its
``deconv2`` is never applied by the forward and is not a module here.

Only the plain graph is ported.  The JAX package's TPU-only exact
re-expressions (blocked level 1, producer-piece dense blocks, fused
up-deconvs) compute the same function for TPU layouts and are left out.

Numerics:

  * ``dtype=torch.float32, precision="highest"`` is the checkpoint-parity
    mode: TF32 is turned off for the forward (cuDNN convolutions default to
    TF32 on the GPU, about three decimal digits);
  * ``dtype=torch.bfloat16``: bf16 convolutions, float32 flow heads
    (``PredictFlow``/``Deconv`` add their bias in float32), the cost volume
    fed in float32 unless ``precision="fast"``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from opticalflow_tpu_torch.ops.convops import leaky_relu
from opticalflow_tpu_torch.ops.correlation import correlation
from opticalflow_tpu_torch.ops.warp import warp_with_mask

__all__ = ["PWCDCNet", "pwc_dc_net", "pwc_dc_net_old", "PYRAMID_CHANNELS",
           "ESTIMATOR_CHANNELS", "FLOW_SCALE"]

# Feature channels at pyramid levels 1..6 (index 0 = input RGB).
PYRAMID_CHANNELS = (3, 16, 32, 64, 96, 128, 196)
# Dense-estimator conv widths (reference dd = cumsum([128,128,96,64,32])).
ESTIMATOR_CHANNELS = (128, 128, 96, 64, 32)
# Ground truth was divided by 20 in the reference training (README:31).
FLOW_SCALE = 20.0
# up_flow of level l+1 → pixel units at level l: 20 / 2^l.
_WARP_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
# (channels, dilation) of dc_conv1..dc_conv6 (reference :126-132).
_CONTEXT_SPECS = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


class ConvLR(nn.Sequential):
    """Conv2d(3×3) + LeakyReLU(0.1), the reference's ``conv()`` helper
    (hence the ``.0.`` in its state-dict keys).  Computes in the dtype of
    its input."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__(nn.Conv2d(cin, cout, 3, stride, dilation, dilation),
                         nn.LeakyReLU(0.1))

    def forward(self, x):
        conv = self[0]
        y = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                     conv.stride, conv.padding, conv.dilation)
        return leaky_relu(y)


class PredictFlow(nn.Conv2d):
    """3×3 conv to 2 channels, no activation; the conv runs in the input's
    dtype, the bias is added in float32 and the flow is float32."""

    def __init__(self, cin: int):
        super().__init__(cin, 2, 3, 1, 1)

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), None, padding=1)
        return y.float() + self.bias.view(1, -1, 1, 1)


class Deconv(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1) to 2 channels with a float32 output,
    like :class:`PredictFlow`."""

    def __init__(self, cin: int):
        super().__init__(cin, 2, 4, 2, 1)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), None, stride=2,
                               padding=1)
        return y.float() + self.bias.view(1, -1, 1, 1)


@contextlib.contextmanager
def _tf32(allowed: bool):
    """Set PyTorch's two TF32 switches for the duration of a forward."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class PWCDCNet(nn.Module):
    """PWC-DC network, both reference variants.

    Input ``x``: (B, 6, H, W), im1 ‖ im2 stacked on channels; H and W must
    be multiples of 64.  Output: ``flow2`` (B, 2, H/4, W/4) float32, or the
    tuple ``(flow2, flow3, flow4, flow5, flow6)`` when ``train=True``
    (``models/PWCNet.py:270-273``).  ``checkpoint_l2=True`` recomputes the
    level-2 estimator and the context network in the backward instead of
    keeping their activations (the largest of the forward): the trainer's
    ``remat="l2"``.
    """

    def __init__(self, md: int = 4, variant: str = "new",
                 dtype: torch.dtype = torch.float32,
                 precision: str = "highest", use_cuda_corr: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if variant not in ("new", "old"):
            raise ValueError(f"variant must be 'new' or 'old', got {variant!r}")
        if precision not in ("highest", "fast"):
            raise ValueError(f"precision must be 'highest' or 'fast', got "
                             f"{precision!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.md = md
        self.variant = variant
        self.dtype = dtype
        self.precision = precision
        self.use_cuda_corr = use_cuda_corr

        for lvl in range(1, 7):
            cin, ch = PYRAMID_CHANNELS[lvl - 1], PYRAMID_CHANNELS[lvl]
            for k, name in enumerate(self._pyramid_names(lvl)):
                self.add_module(name, ConvLR(cin if k == 0 else ch, ch,
                                             stride=2 if k == 0 else 1))
        nd = (2 * md + 1) ** 2
        for lvl in (6, 5, 4, 3, 2):
            cum = nd if lvl == 6 else nd + PYRAMID_CHANNELS[lvl] + 4
            for i, ch in enumerate(ESTIMATOR_CHANNELS):
                self.add_module(f"conv{lvl}_{i}", ConvLR(cum, ch))
                cum += ch
            self.add_module(f"predict_flow{lvl}", PredictFlow(cum))
            if lvl > 2:
                self.add_module(f"deconv{lvl}", Deconv(2))
                self.add_module(f"upfeat{lvl}", Deconv(cum))
        cin = cum
        for i, (ch, dil) in enumerate(_CONTEXT_SPECS, start=1):
            self.add_module(f"dc_conv{i}", ConvLR(cin, ch, dilation=dil))
            cin = ch
        self.add_module("dc_conv7", PredictFlow(cin))
        self.reset_parameters(generator)

    def _pyramid_names(self, lvl: int):
        if self.variant == "old":
            return [f"conv{lvl}a", f"conv{lvl}b"]
        # level 6 names its stride-2 conv "conv6aa" (reference :67-69)
        return ([f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"] if lvl < 6
                else ["conv6aa", "conv6a", "conv6b"])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Kaiming-normal weights (std √(2/fan_in), fan_in = kh·kw·C_in for
        convs and transposed convs alike, as the JAX package initialises),
        zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = (m.in_channels * m.kernel_size[0]
                          * m.kernel_size[1])
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                 generator=generator)
                m.bias.zero_()

    def _corr(self, a, b):
        cd = self.dtype if self.precision == "fast" else torch.float32
        out = correlation(a.to(cd), b.to(cd), pad_size=self.md,
                          kernel_size=1, max_displacement=self.md,
                          stride1=1, stride2=1,
                          use_cuda=self.use_cuda_corr)
        return leaky_relu(out).to(self.dtype)

    def _dense_block(self, x, lvl: int):
        """Five convs with dense concatenation; the variants concatenate in
        different orders (``models/PWCNet.py:202-206`` vs ``:426-443``)."""
        conv_first = ((True,) * 5 if self.variant == "new"
                      else (False, True, False, False, False))
        for i, cf in enumerate(conv_first):
            y = getattr(self, f"conv{lvl}_{i}")(x)
            x = torch.cat((y, x) if cf else (x, y), dim=1)
        return x

    def numerics(self):
        """The TF32 switches of this model's precision, as a context
        manager: the trainer holds it around the backward too, so that
        ``precision="highest"`` gradients are full float32."""
        return _tf32(self.precision == "fast")

    def forward(self, x: torch.Tensor, train: bool = False,
                checkpoint_l2: bool = False):
        if x.dim() != 4 or x.shape[1] != 6:
            raise ValueError(f"expected (B, 6, H, W), got {tuple(x.shape)}")
        if x.shape[2] % 64 or x.shape[3] % 64:
            raise ValueError(f"H and W must be multiples of 64, got "
                             f"{tuple(x.shape[2:])}")
        with self.numerics():
            return self._forward(x, train, checkpoint_l2)

    def _head2(self, xin):
        """Level 2's dense estimator, its flow and the context network's
        residual: the refined flow2.  Sets its own numerics, since a
        checkpoint recomputes it in the backward."""
        with self.numerics():
            xfeat = self._dense_block(xin, 2)
            dc = xfeat
            for i in range(1, len(_CONTEXT_SPECS) + 1):
                dc = getattr(self, f"dc_conv{i}")(dc)
            return self.predict_flow2(xfeat) + self.dc_conv7(dc)

    def _forward(self, x, train, checkpoint_l2):
        dt = self.dtype
        mask_thr = 0.9999 if self.variant == "new" else 0.999
        bsz = x.shape[0]
        # siamese pyramid: both images through one set of weights, batched
        # together so every conv runs once at 2B
        f = torch.cat([x[:, :3], x[:, 3:]], dim=0).to(dt)
        c1, c2 = {}, {}
        for lvl in range(1, 7):
            for name in self._pyramid_names(lvl):
                f = getattr(self, name)(f)
            c1[lvl], c2[lvl] = f[:bsz], f[bsz:]

        flows = {}
        for lvl in (6, 5, 4, 3, 2):
            if lvl == 6:
                xin = self._corr(c1[6], c2[6])
            else:
                warped = warp_with_mask(c2[lvl], up_flow * _WARP_SCALES[lvl],
                                        mask_threshold=mask_thr).to(dt)
                corr = self._corr(c1[lvl], warped)
                xin = torch.cat([corr, c1[lvl], up_flow.to(dt),
                                 up_feat.to(dt)], dim=1)
            if lvl == 2:
                flows[2] = (checkpoint(self._head2, xin, use_reentrant=False)
                            if checkpoint_l2 else self._head2(xin))
                break
            xfeat = self._dense_block(xin, lvl)
            flows[lvl] = getattr(self, f"predict_flow{lvl}")(xfeat)
            up_flow = getattr(self, f"deconv{lvl}")(flows[lvl].to(dt))
            up_feat = getattr(self, f"upfeat{lvl}")(xfeat)
        if train:
            return tuple(flows[lvl] for lvl in (2, 3, 4, 5, 6))
        return flows[2]


def pwc_dc_net(path: str | None = None, **kwargs) -> PWCDCNet:
    """Current-variant PWCDCNet, with weights from ``path`` (a reference
    torch checkpoint) or freshly initialised (``models/PWCNet.py:497-506``)."""
    return _init_or_load(PWCDCNet(variant="new", **kwargs), path)


def pwc_dc_net_old(path: str | None = None, **kwargs) -> PWCDCNet:
    """Legacy 2-conv-per-level variant (``models/PWCNet.py:511-520``)."""
    return _init_or_load(PWCDCNet(variant="old", **kwargs), path)


def _init_or_load(model: PWCDCNet, path: str | None) -> PWCDCNet:
    if path is not None:
        from opticalflow_tpu_torch.train.checkpoints import load_params
        model.load_state_dict(load_params(path))
    return model
