"""Write the ground-truth fixtures of ``chip_smoke.py``'s ``gt_eval`` phase
into ``tests/data/torch_gt/``:

- ``N_PAGES`` full-size (2000 x 1420) pages of the smoke's own newspaper
  generator (``chip_smoke.synthetic_newspaper``, seed ``SEED``) as PNG;
- ``page/<name>.xml`` for each: the drawn layout with typed TextRegions
  (the headlines ``heading``, with BNL structure types: a classic heading,
  a title subheadline and an author heading), every text line with a
  baseline, text and the article of its region (``chip_smoke.ARTICLES``),
  the three drawn rules as SeparatorRegions, and one TableRegion, one
  AdvertRegion and one ImageRegion;
- ``digests.json``: for every file that the JAX package's generators write
  from those pages (``RegionGroundTruthGenerator`` with TextRegion and
  SeparatorRegion at scale 1 and with a ``max_resolution`` that halves the
  page, and with SeparatorRegion alone, the separator net's GT; both BNL
  generators; and ``cli/run_as_gt_generation.py``), the sha256 of its
  pixels as PIL decodes them in mode "L", with the image's size;
  ``info.txt`` and ``regions_gt.json`` verbatim.

The smoke holds the port's generators to these digests on the card's
machine, which has no PIL. Needs PIL and the JAX package; run from the
repository root:

    JAX_PLATFORMS=cpu python scripts/make_gt_fixtures.py
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_gt")
SEED = 29
N_PAGES = 2
SHAPE = (2000, 1420)
HALF_RESOLUTION = (SHAPE[0] // 2, 0)          # (max height, max width): scale 0.5
# headline region -> (type, custom structure)
HEADLINE_STRUCTURE = {
    "r_hl_0": {"type": "heading"},
    "r_hl_1": {"type": "title", "subtype": "subheadline"},
    "r_hl_2": {"type": "heading", "subtype": "author"},
}
# the generator runs whose files are recorded: name -> (generator, keyword arguments)
REGION_RUNS = {
    "region": ("RegionGroundTruthGenerator", {}),
    "region_sep": ("RegionGroundTruthGenerator", {"region_types": ["SeparatorRegion"]}),
    "region_half": ("RegionGroundTruthGenerator", {"max_resolution": HALF_RESOLUTION}),
    "bnl": ("BNLGroundTruthGenerator", {}),
    "bnl_header": ("BNLHeaderGroundTruthGenerator", {}),
}


def write_page_xml(path, image_name, h, w, regions, rules):
    """The drawn layout as GT PAGE-XML (see the module docstring)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from citlab_as_tpu_torch.pagexml import (
        AdvertRegion, ImageRegion, Page, SeparatorRegion, TableRegion, TextLine, TextRegion,
    )
    from citlab_as_tpu_torch.pagexml.constants import TextRegionTypes

    def box(x0, y0, x1, y1):
        return [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]

    doc = Page(img_filename=image_name, img_w=w, img_h=h)
    text_regions = []
    for region_id, lines in regions:
        article = chip_smoke.ARTICLES[region_id]
        tls = []
        for line_id, (x0, y0, x1, y1) in lines:
            tl = TextLine(line_id, None, f"{article} {line_id}", [(x0, y1 - 2), (x1, y1 - 2)],
                          box(x0, y0, x1, y1))
            tl.set_article_id(article)
            tls.append(tl)
        xs0, ys0, xs1, ys1 = zip(*(b for _, b in lines))
        outline = box(min(xs0), min(ys0), max(xs1), max(ys1))
        if region_id in HEADLINE_STRUCTURE:
            text_regions.append(TextRegion(
                region_id, {"structure": dict(HEADLINE_STRUCTURE[region_id])}, outline, tls,
                region_type=TextRegionTypes.HEADING))
        else:
            text_regions.append(TextRegion(region_id, None, outline, tls))
    doc.set_text_regions(text_regions)
    for k, (x0, y0, x1, y1) in enumerate(rules):
        orientation = "vertical" if k == 0 else "horizontal"
        doc.add_region(SeparatorRegion(f"sep_{k}", {"structure": {"orientation": orientation}},
                                       box(x0, y0, x1, y1)))
    # a table over the right column's foot, an advert across the column
    # rule and an image over the left column's top: overlaps that the
    # disjoint channels resolve
    col = rules[0][0]
    doc.add_region(TableRegion("table_0", None, box(col + 40, h - 260, w - 40, h - 60)))
    doc.add_region(AdvertRegion("advert_0", None, [(col - 150, h // 2 - 90), (col + 170, h // 2 - 120),
                                                   (col + 150, h // 2 + 80), (col - 130, h // 2 + 95)]))
    doc.add_region(ImageRegion("image_0", None, box(30, 30, col - 40, 150)))
    doc.write_page_xml(path)


def pixel_digest(path):
    from PIL import Image
    with Image.open(path) as im:
        grey = np.asarray(im.convert("L"))
    return {"size": [int(grey.shape[1]), int(grey.shape[0])],
            "sha256_L": hashlib.sha256(grey.tobytes()).hexdigest()}


def record_dir(root):
    """{relative path: digest or text} of every file a generator wrote."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".png", ".jpg")):
                out[rel] = pixel_digest(path)
            else:
                with open(path, encoding="utf-8") as f:
                    out[rel] = {"text": f.read()}
    return dict(sorted(out.items()))


def run_jax_generators(image_paths, work):
    """Every recorded run of the JAX package's generators over the pages."""
    from citlab_as_tpu.cli import run_as_gt_generation
    from citlab_as_tpu.stages import bnl_ground_truth, ground_truth
    from citlab_as_tpu.utils.io import get_page_path

    runs = {}
    for run, (cls_name, kwargs) in REGION_RUNS.items():
        cls = getattr(ground_truth, cls_name, None) or getattr(bnl_ground_truth, cls_name)
        out = os.path.join(work, run)
        gen = cls(image_paths, **kwargs)
        gen.run_ground_truth_generation(out)
        if cls_name == "RegionGroundTruthGenerator":
            gen.create_ground_truth_json(out)
        runs[run] = record_dir(out)
    lst = os.path.join(work, "pages.lst")
    with open(lst, "w") as f:
        f.write("\n".join(get_page_path(p) for p in image_paths) + "\n")
    out = os.path.join(work, "as")
    run_as_gt_generation.main(["--pagexml_list", lst, "--save_folder", out])
    runs["as"] = record_dir(out)
    return runs


def main() -> int:
    sys.path.insert(0, REPO)
    import chip_smoke
    from citlab_as_tpu_torch.utils.io import save_png

    rules = []
    pages, _, layouts = chip_smoke.synthetic_newspaper(N_PAGES, *SHAPE, seed=SEED,
                                                       rules_out=rules)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(os.path.join(OUT, "page"))
    image_paths = []
    for i, (page, regions, page_rules) in enumerate(zip(pages, layouts, rules)):
        name = f"gt_page_{i:02d}"
        path = os.path.join(OUT, f"{name}.png")
        save_png(path, page)
        h, w = page.shape
        write_page_xml(os.path.join(OUT, "page", f"{name}.xml"), os.path.basename(path),
                       h, w, regions, page_rules)
        image_paths.append(path)
        print(f"{os.path.relpath(path, REPO)}: {os.path.getsize(path)} bytes")
    work = tempfile.mkdtemp(prefix="gt_fixtures_")
    try:
        runs = run_jax_generators(image_paths, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record = {"pages": [os.path.basename(p) for p in image_paths],
              "half_resolution": list(HALF_RESOLUTION), "runs": runs}
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"digests of {sum(len(r) for r in runs.values())} files in "
          f"{os.path.relpath(os.path.join(OUT, 'digests.json'), REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
