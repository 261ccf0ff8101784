"""The port's text (``viz/text.py``) against ``cv2.putText``.

``build_atlas`` makes the committed glyph atlas with OpenCV (the package
may not name it); the first test rebuilds it and asserts it equals
``opticalflow_tpu_torch/viz/glyphs.npz``.  Regenerate after an intended
change with ``python tests/test_torch_text.py``.  Tolerance: bit-exact.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opticalflow_tpu_torch.viz import text as T  # noqa: E402

FONT = cv2.FONT_HERSHEY_SIMPLEX
PAD = 64                     # canvas margin around the rendering origin


def build_atlas():
    """{key: array} of every printable glyph's mask as cv2 renders it alone
    (white on black, LINE_AA) at an integer origin, cropped to the box that
    holds all glyphs of a font, and each glyph's advance in pixels."""
    out = {}
    chars = [chr(c) for c in range(T.FIRST, T.LAST + 1)]
    for scale, th in T.FONTS:
        masks = []
        for ch in chars:
            canvas = np.zeros((2 * PAD, 2 * PAD, 3), np.uint8)
            cv2.putText(canvas, ch, (PAD, PAD), FONT, scale, (255, 255, 255),
                        th, cv2.LINE_AA)
            assert (canvas[..., 0] == canvas[..., 1]).all()
            masks.append(canvas[..., 0])
        masks = np.stack(masks)
        nz = np.argwhere(masks.max(axis=0) > 0)
        (y0, x0), (y1, x1) = nz.min(axis=0), nz.max(axis=0) + 1
        assert y0 > 0 and x0 > 0 and y1 < 2 * PAD and x1 < 2 * PAD
        base = cv2.getTextSize("a", FONT, scale, th)[0][0]
        adv = [cv2.getTextSize(ch + "a", FONT, scale, th)[0][0] - base
               for ch in chars]
        k = T.font_key(scale, th)
        out[f"masks_{k}"] = np.ascontiguousarray(masks[:, y0:y1, x0:x1])
        out[f"origin_{k}"] = np.array([PAD - y0, PAD - x0], np.int64)
        out[f"advance_{k}"] = np.array(adv, np.int64)
    return out


def test_committed_atlas_equals_cv2_rebuild():
    built = build_atlas()
    with np.load(T.ATLAS_PATH) as z:
        assert sorted(z.files) == sorted(built)
        for k, v in built.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def _textured(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 3) % 256, (yy * 5) % 256, (xx + 2 * yy) % 256],
                    axis=-1)
    return np.clip(base + rng.randint(-40, 41, base.shape), 0,
                   255).astype(np.uint8)


# every string the port's overlays draw: the CLIs' titles, the golden
# tests' titles, and the vanishing-point confidence at each rounding
DRAWN = (["PWC-Net (TPU)", "PWC-Net VP (TPU)", "golden", "VP"]
         + [f"p={p / 100:.2f}" for p in range(101)])


@pytest.mark.parametrize("scale", [0.7, 0.6])
def test_put_text_bit_exact_on_drawn_strings(scale):
    for i, s in enumerate(DRAWN):
        img = _textured(60, 260, i)
        col = [(255, 255, 255), (0, 255, 255), (30, 60, 250)][i % 3]
        org = (14 + i % 5, 35 + i % 3)
        want = img.copy()
        cv2.putText(want, s, org, FONT, scale, col, 2, cv2.LINE_AA)
        got = T.put_text(img.copy(), s, org, scale, col, 2)
        np.testing.assert_array_equal(got, want, err_msg=repr(s))


def test_put_text_bit_exact_on_random_strings_clipped():
    """Random printable strings, colours and origins, some glyphs off the
    image: overlapping glyphs blend in turn as cv2's do."""
    rng = np.random.RandomState(7)
    printable = [chr(c) for c in range(T.FIRST, T.LAST + 1)]
    for t in range(120):
        s = "".join(rng.choice(printable, rng.randint(1, 16)))
        scale = T.FONTS[t % 2][0]
        img = _textured(70, 200, 100 + t)
        col = tuple(int(v) for v in rng.randint(0, 256, 3))
        org = (int(rng.randint(-20, 180)), int(rng.randint(-5, 85)))
        want = img.copy()
        cv2.putText(want, s, org, FONT, scale, col, 2, cv2.LINE_AA)
        got = T.put_text(img.copy(), s, org, scale, col, 2)
        np.testing.assert_array_equal(got, want, err_msg=repr(s))


def test_atlas_advances_are_cv2_text_size_less_one():
    """cv2 5's getTextSize is the glyphs' advances plus one column: the
    integer advances the atlas places glyphs by, with no kerning."""
    rng = np.random.RandomState(3)
    printable = [chr(c) for c in range(T.FIRST, T.LAST + 1)]
    with np.load(T.ATLAS_PATH) as z:
        adv = {f: z[f"advance_{T.font_key(*f)}"] for f in T.FONTS}
    for t in range(200):
        s = "".join(rng.choice(printable, rng.randint(1, 20)))
        font = T.FONTS[t % 2]
        width = int(sum(adv[font][ord(c) - T.FIRST] for c in s))
        assert width + 1 == cv2.getTextSize(s, FONT, font[0], 2)[0][0], s


def test_put_text_refuses_what_the_atlas_lacks():
    img = np.zeros((20, 20, 3), np.uint8)
    with pytest.raises(ValueError, match="printable"):
        T.put_text(img, "café", (0, 10), 0.7, (255, 255, 255))
    with pytest.raises(ValueError, match="atlas"):
        T.put_text(img, "x", (0, 10), 1.0, (255, 255, 255))


if __name__ == "__main__":
    np.savez_compressed(T.ATLAS_PATH, **build_atlas())
    print(f"wrote {T.ATLAS_PATH}", file=sys.stderr)
