"""Write the colour image fixtures and their imageio decodes.

    python tests/fixtures/make_color_fixtures.py

tests/fixtures/color/ gets an RGB and an RGBA PNG written by imageio and a
4:2:0 JPEG written by Pillow (61x45: partial 16x16 MCUs and an odd chroma
width), each beside ``<name>.npy``, what ``imageio.v3.imread`` returns for
it. The port's decoders (``utils.png``, ``utils.jpeg``) are held against
those arrays on the CPU and, by chip_smoke.py, on the card's machine, which
has no imageio.
"""

from pathlib import Path

import imageio.v3 as iio
import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parent / "color"


def pattern(h=45, w=61, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c)
                     for c in range(channels)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def main():
    OUT.mkdir(exist_ok=True)
    iio.imwrite(OUT / "rgb.png", pattern())
    iio.imwrite(OUT / "rgba.png", pattern(channels=4, seed=1))
    Image.fromarray(pattern(seed=2)).save(OUT / "ycc420.jpg", quality=90, subsampling=2)
    for name in ("rgb.png", "rgba.png", "ycc420.jpg"):
        np.save(OUT / f"{Path(name).stem}.npy", np.asarray(iio.imread(OUT / name)))
        print(f"wrote {OUT / name}")


if __name__ == "__main__":
    main()
