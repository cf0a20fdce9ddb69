"""Write the blind article-quality pages of ``chip_smoke.py``'s ``blind``
phase into ``tests/data/torch_blind/``: the pages of the JAX package's
three blind oracles (``tests/test_trained_models.py``), made by the same
generators with the same seeds, so that the card's machine (no PIL, no
JAX) runs the port over exactly those pages.

- ``multi``: ``scripts/train_pipeline_gnn.make_article_page`` with
  ``RandomState(777)``, one page ``p``;
- ``hard``: ``scripts/hard_corpus.make_hard_article_page`` with
  ``RandomState(7)``, two pages ``h0``, ``h1`` (skew 3 degrees, noise 0.05,
  rule grey 185);
- ``visual``: ``make_article_page`` with ``RandomState(31)``, ``(7)`` and
  ``(101)``, pages ``v31``, ``v7``, ``v101``.

Each page is a PNG beside ``page/<name>.xml`` (the input: the generator's
PAGE-XML with every text line's article id stripped) and
``gt/page/<name>.xml`` (the generator's PAGE-XML, the ground truth);
``blind.json`` lists the sets, their relation net and their floors.

Needs PIL and the JAX package's PAGE-XML code; run from the repository
root:

    JAX_PLATFORMS=cpu python scripts/make_blind_fixtures.py
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_blind")
# (set, relation net under models_ckpt_torch/, floors on the AS measure)
SETS = {
    "multi": {"gnn": "gnn_pipeline.npz", "as_f1": 0.98},
    "hard": {"gnn": "gnn_pipeline.npz", "as_f1": 0.96, "bd_f1": 0.9},
    "visual": {"gnn": "gnn_visual.npz", "as_f1": 0.95},
}


def strip_article_ids(page_path: str, gt_path: str) -> None:
    """Copy the generator's PAGE-XML to ``gt_path`` and strip every text
    line's article id from ``page_path``, as the JAX oracles do."""
    from citlab_as_tpu.pagexml import Page
    os.makedirs(os.path.dirname(gt_path), exist_ok=True)
    shutil.copy(page_path, gt_path)
    page = Page(page_path)
    lines = page.get_textlines()
    for tl in lines:
        tl.set_article_id(None)
    page.set_textline_attr(lines)
    page.write_page_xml(page_path)


def make_pages(out_dir: str) -> dict:
    """The six pages in ``out_dir``: {set: [(image, page, gt), ...]}."""
    sys.path.insert(0, REPO)
    from scripts.hard_corpus import make_hard_article_page
    from scripts.train_pipeline_gnn import make_article_page
    made = {name: [] for name in SETS}

    def add(kind, name, img, page):
        gt = os.path.join(out_dir, "gt", "page", f"{name}.xml")
        strip_article_ids(page, gt)
        made[kind].append((img, page, gt))

    rng = np.random.RandomState(777)
    img, page, n_articles = make_article_page(out_dir, "p", rng)
    assert n_articles >= 4
    add("multi", "p", img, page)
    rng = np.random.RandomState(7)
    for i in range(2):
        img, page, n_articles, _ = make_hard_article_page(
            out_dir, f"h{i}", rng, max_skew_deg=3.0, noise_frac=0.05, rule_grey=185)
        assert n_articles >= 4
        add("hard", f"h{i}", img, page)
    for seed in (31, 7, 101):
        img, page, n_articles = make_article_page(out_dir, f"v{seed}",
                                                  np.random.RandomState(seed))
        assert n_articles >= 3
        add("visual", f"v{seed}", img, page)
    return made


def main() -> int:
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    made = make_pages(OUT)
    record = {kind: dict(SETS[kind], pages=[os.path.splitext(os.path.basename(img))[0]
                                            for img, _, _ in pages])
              for kind, pages in made.items()}
    with open(os.path.join(OUT, "blind.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, name))
                for d, _, names in os.walk(OUT) for name in names)
    print(f"{os.path.relpath(OUT, REPO)}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
