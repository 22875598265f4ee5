#!/usr/bin/env python
"""Write ``slenderobjdet_torch/utils/glyphs.py``: the coverage bitmaps and
advances of ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, scale, color, 1)`` for
printable ASCII, recovered from cv2 by rendering.

OpenCV 5.0 draws the Hershey faces with an embedded TrueType font: a glyph
is an 8-bit coverage bitmap, blended into the image at an integer pen
position, and the pen moves by an integer advance. Each glyph is rendered
alone, white on black (the pixels are then its coverage), and cropped; its
advance is the shift at which a following ``I`` reproduces cv2's rendering of
the pair. The script checks that every pair with five following glyphs and
200 seeded strings re-render pixel-equal before it writes the table.

    python tools/make_torch_glyph_table.py   # needs cv2 (5.0); the port does not
"""

import base64
import json
import os
import sys
import zlib

import cv2
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SCALES = (0.35, 1.0)
CHARS = [chr(c) for c in range(32, 127)]
OUT = "slenderobjdet_torch/utils/glyphs.py"
X0, Y0, H, W = 64, 64, 128, 2048


def render(text, scale):
    img = np.zeros((H, W, 3), np.uint8)
    cv2.putText(img, text, (X0, Y0), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 1)
    return img[:, :, 0]


def crop(cov):
    ys, xs = np.nonzero(cov)
    if not len(ys):
        return 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return int(x0 - X0), int(y0 - Y0), cov[y0:y1, x0:x1].copy()


def compose(text, table):
    """The port's rule (``utils/draw.py:put_text``) on a black canvas."""
    out = np.zeros((H, W), np.float64)
    x = X0
    for ch in text:
        adv, gx, gy, cov = table[ord(ch)]
        if cov.size:
            y0, x0 = Y0 + gy, x + gx
            region = out[y0:y0 + cov.shape[0], x0:x0 + cov.shape[1]]
            region[:] = np.floor(region + (255.0 - region) * cov / 255.0 + 0.5)
        x += adv
    return out.astype(np.uint8)


def glyphs_at(scale):
    table = {}
    for ch in CHARS:
        gx, gy, cov = crop(render(ch, scale))
        table[ord(ch)] = [0, gx, gy, cov]
    for ch in CHARS:
        want = render(ch + "I", scale)
        for adv in range(0, 200):
            table[ord(ch)][0] = adv
            if np.array_equal(compose(ch + "I", table), want):
                break
        else:
            raise SystemExit(f"no advance of {ch!r} at {scale} reproduces cv2")
    rs = np.random.RandomState(0)
    texts = [a + b for a in CHARS for b in "AIiW."]
    texts += ["".join(rs.choice(CHARS, rs.randint(2, 25))) for _ in range(200)]
    for t in texts:
        if not np.array_equal(compose(t, table), render(t, scale)):
            raise SystemExit(f"{t!r} at {scale} does not re-render pixel-equal")
    return table


def main():
    blob = {}
    for scale in SCALES:
        table = glyphs_at(scale)
        blob[repr(scale)] = {
            str(code): [adv, gx, gy, list(cov.shape),
                        base64.b64encode(cov.tobytes()).decode()]
            for code, (adv, gx, gy, cov) in table.items()}
    data = base64.b64encode(zlib.compress(json.dumps(blob, sort_keys=True).encode(), 9))
    lines = [data[i:i + 76].decode() for i in range(0, len(data), 76)]
    body = "\n".join(f'    "{ln}"' for ln in lines)
    with open(OUT, "w") as f:
        f.write(f'''"""Glyphs of ``cv2.putText`` with ``FONT_HERSHEY_SIMPLEX`` and thickness 1
(OpenCV {cv2.__version__}), for printable ASCII at the scales {", ".join(map(repr, SCALES))}.

Written by ``tools/make_torch_glyph_table.py`` from cv2's own renderings; do
not edit. Per scale and character code: the integer advance, the bitmap's
offset from the text origin (x, y; the origin is on the baseline) and its
8-bit coverage (``utils/draw.py:put_text`` blends it).
"""

import base64
import functools
import json
import zlib

import numpy as np

_DATA = (
{body}
)


@functools.lru_cache(maxsize=None)
def _tables():
    return json.loads(zlib.decompress(base64.b64decode("".join(_DATA))))


@functools.lru_cache(maxsize=None)
def glyph_table(scale: float):
    """{{code: (advance, dx, dy, coverage (h, w) uint8)}} at ``scale``."""
    tables = _tables()
    if repr(float(scale)) not in tables:
        raise ValueError(f"no glyph table at font scale {{scale}}; tables: {{sorted(tables)}}")
    out = {{}}
    for code, (adv, dx, dy, shape, cov) in tables[repr(float(scale))].items():
        bitmap = np.frombuffer(base64.b64decode(cov), np.uint8).reshape(shape)
        out[int(code)] = (adv, dx, dy, bitmap)
    return out
''')
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
