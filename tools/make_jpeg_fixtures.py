"""Write the JPEG fixtures of ``tests/fixtures/jpeg/`` from a seed.

Photograph-like stand-ins at ImageNet's usual sizes, for hosts that cannot
encode JPEGs themselves (no PIL): each image is a seeded mix of smooth
fields (low-frequency waves) and texture (noise whose strength varies across
the image), encoded at quality 90 with 4:2:0 chroma subsampling. One file is
progressive and one is grayscale. The script is deterministic for one
Pillow build: running it again writes the same bytes. Run from the root of
a checkout::

    python tools/make_jpeg_fixtures.py [--out tests/fixtures/jpeg]
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

SEED = 0
QUALITY = 90
#: (width, height): ImageNet's usual landscape and portrait shapes
SIZES = (
    (500, 375), (375, 500), (500, 333), (640, 480), (333, 500), (500, 400),
    (480, 640), (500, 375), (500, 500), (400, 300), (500, 281), (375, 500),
    (500, 375), (640, 427), (500, 334), (427, 640), (500, 375), (300, 400),
    (500, 332), (500, 375), (640, 480), (375, 500), (500, 353), (500, 375),
)
PROGRESSIVE = 5  # the index of the progressive file
GRAYSCALE = 11  # the index of the grayscale file


def image(rng: np.random.Generator, width: int, height: int) -> np.ndarray:
    """One (height, width, 3) uint8 image: waves plus texture of varying
    strength."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = np.empty((height, width, 3), np.float32)
    for c in range(3):
        field = np.full((height, width), rng.uniform(60, 190), np.float32)
        for _ in range(4):
            fx, fy = rng.uniform(0.002, 0.03, 2)
            field += rng.uniform(10, 40) * np.sin(fx * xx + fy * yy + rng.uniform(0, 6.3))
        out[..., c] = field
    cx, cy = rng.uniform(0, width), rng.uniform(0, height)
    radius = rng.uniform(0.3, 0.7) * max(width, height)
    strength = 0.4 + 0.6 * np.clip(1.0 - np.hypot(xx - cx, yy - cy) / radius, 0.0, 1.0)
    noise = rng.standard_normal((height, width, 3)).astype(np.float32)
    out += rng.uniform(18, 30) * strength[..., None] * noise
    return np.clip(out, 0, 255).astype(np.uint8)


def encode(arr: np.ndarray, progressive: bool = False, gray: bool = False) -> bytes:
    from PIL import Image

    img = Image.fromarray(arr)
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=QUALITY, subsampling=2, progressive=progressive)
    return buf.getvalue()


def fixtures() -> dict[str, bytes]:
    """File name -> JPEG bytes, for every fixture."""
    rng = np.random.default_rng(SEED)
    out = {}
    for i, (w, h) in enumerate(SIZES):
        data = encode(image(rng, w, h), progressive=i == PROGRESSIVE, gray=i == GRAYSCALE)
        kind = "progressive" if i == PROGRESSIVE else "gray" if i == GRAYSCALE else "rgb"
        out[f"{i:02d}_{w}x{h}_{kind}.jpg"] = data
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join("tests", "fixtures", "jpeg"))
    out_dir = parser.parse_args().out
    os.makedirs(out_dir, exist_ok=True)
    files = fixtures()
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    sizes = [len(d) for d in files.values()]
    print(f"{len(files)} JPEGs in {out_dir}: {sum(sizes):,} B, mean {np.mean(sizes):,.0f} B, "
          f"min {min(sizes):,} B, max {max(sizes):,} B")


if __name__ == "__main__":
    main()
