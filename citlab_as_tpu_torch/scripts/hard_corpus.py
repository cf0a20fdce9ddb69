"""Hard synthetic corpus: skewed, noisy, dense multi-column pages (port of
``scripts/hard_corpus.py``).

Degrades :func:`citlab_as_tpu_torch.scripts.train_pipeline_gnn.
make_article_page` pages with the defects real scans show: a global skew
(the image rotated by a small angle, the GT coordinates by the same
transform), salt-and-pepper noise on a grey background texture, and denser
layouts (up to 4 columns). ``rule_grey`` fades the printed rules until the
separator net no longer finds them. The same seed draws the JAX script's
pages.

    python -m citlab_as_tpu_torch.scripts.hard_corpus --out_dir /tmp/hard --pages 8
"""
from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import numpy as np


def _rotate_points(points, angle_deg: float, cx: float, cy: float):
    a = math.radians(angle_deg)
    cos, sin = math.cos(a), math.sin(a)
    out = []
    for x, y in points:
        dx, dy = x - cx, y - cy
        out.append((cx + cos * dx - sin * dy, cy + sin * dx + cos * dy))
    return out


def make_hard_article_page(out_dir: str, name: str, rng: np.random.RandomState,
                           w: int = 1000, h: int = 1500,
                           max_skew_deg: float = 1.5,
                           noise_frac: float = 0.02,
                           dense: bool = True,
                           rule_grey: Optional[int] = None):
    """Multi-article page with skew, noise and texture. ``rule_grey`` remaps
    the printed separator rules (drawn at grey 40) to a fainter value; at
    about 200 the separator net no longer detects them, so the articles must
    come from the layout's gaps and the GNN alone. Returns (image path, page
    path, number of articles, skew in degrees)."""
    import scipy.ndimage as ndi

    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.scripts.train_pipeline_gnn import make_article_page
    from citlab_as_tpu_torch.utils.io import load_image, save_png

    # a clean page first (optionally denser: 3-4 narrow columns)
    if dense:
        n_cols = rng.randint(3, 5)
        img_path, page_path, n_articles = make_article_page(
            out_dir, name, rng, w=max(900, 250 * n_cols), h=h)
    else:
        img_path, page_path, n_articles = make_article_page(out_dir, name, rng, w=w, h=h)

    img = np.asarray(load_image(img_path, mode="L"), np.float32)
    hh, ww = img.shape
    if rule_grey is not None:
        img[img == 40] = float(rule_grey)   # fade the printed rules

    # skew: rotate the image, grey fill like a scanner's background
    skew = float(rng.uniform(-max_skew_deg, max_skew_deg))
    img = ndi.rotate(img, -skew, reshape=False, order=1, mode="constant", cval=235.0)

    # background texture and salt-and-pepper
    texture = ndi.gaussian_filter(rng.randn(hh // 8 + 1, ww // 8 + 1), 2.0)
    texture = np.kron(texture, np.ones((8, 8)))[:hh, :ww]
    img = np.clip(img + texture * 12.0, 0, 255)
    n_noise = int(noise_frac * hh * ww)
    ys = rng.randint(0, hh, n_noise)
    xs = rng.randint(0, ww, n_noise)
    img[ys[: n_noise // 2], xs[: n_noise // 2]] = 0
    img[ys[n_noise // 2:], xs[n_noise // 2:]] = 255
    save_png(img_path, img.astype(np.uint8))

    # the GT geometry rotated by the same transform (ndi.rotate(-skew) maps
    # source coordinates by +skew around the centre)
    page = Page(page_path)
    cx, cy = ww / 2.0, hh / 2.0
    for tl in page.get_textlines():
        node = page.get_child_by_id(page.page_doc, tl.id)[0]
        for tag in ("Coords", "Baseline"):
            for el in node:
                if el.tag.endswith(tag):
                    pts = [tuple(map(float, p.split(",")))
                           for p in el.get("points").split()]
                    rot = _rotate_points(pts, skew, cx, cy)
                    el.set("points", " ".join(
                        f"{int(round(x))},{int(round(y))}" for x, y in rot))
    page.write_page_xml(page_path)
    return img_path, page_path, n_articles, skew


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--pages", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_skew_deg", type=float, default=1.5)
    parser.add_argument("--noise_frac", type=float, default=0.02)
    args = parser.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(args.pages):
        img, page, n, skew = make_hard_article_page(
            args.out_dir, f"hard{i:03d}", rng,
            max_skew_deg=args.max_skew_deg, noise_frac=args.noise_frac)
        print(f"{img}: {n} articles, skew {skew:+.2f} deg")


if __name__ == "__main__":
    main()
