"""Corpus utilities (port of ``citlab_as_tpu/utils/corpus_tools.py``):
article-id transfer, page statistics, list splitting, BERT pair export,
on the port's ``Page``.

Reference: article_separation/util/{overwrite_article_ids.py:10-198,
page_stats.py:9-38, create_sub_lists.py:6-42,
bert_finetuning_generation.py / bert_prediction_generation.py}.
"""
from __future__ import annotations

import json
import logging
import os
import random
from typing import Dict, Optional, Sequence, Tuple

from citlab_as_tpu_torch.pagexml import Page

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------- transfer

def overwrite_article_ids(page_paths: Sequence[str], gt_paths: Sequence[str]
                          ) -> Tuple[int, int]:
    """Overwrite each page's text line article ids from the same-id GT lines
    (overwrite_article_ids.py:10-84). Returns (files updated, lines updated)."""
    assert len(page_paths) == len(gt_paths), \
        f"Page list ({len(page_paths)}) must match GT list ({len(gt_paths)})"
    page_paths = sorted(page_paths, key=os.path.basename)
    gt_paths = sorted(gt_paths, key=os.path.basename)

    files_updated = 0
    lines_updated = 0
    for page_path, gt_path in zip(page_paths, gt_paths):
        page_file = Page(page_path)
        gt_file = Page(gt_path)
        gt_article = {tl.id: tl.get_article_id() for tl in gt_file.get_textlines()}

        updates = 0
        page_textlines = page_file.get_textlines()
        for tl in page_textlines:
            if tl.id in gt_article and tl.get_article_id() != gt_article[tl.id]:
                tl.set_article_id(gt_article[tl.id])
                updates += 1
        if updates:
            page_file.set_textline_attr(page_textlines)
            page_file.write_page_xml(page_path)
            files_updated += 1
            lines_updated += updates
    logger.info("Updated %d files / %d lines", files_updated, lines_updated)
    return files_updated, lines_updated


def overwrite_article_ids_by_region(page_paths: Sequence[str],
                                    gt_paths: Sequence[str]) -> int:
    """Region-level transfer: every line in a page region takes the majority
    GT article id of the lines sharing its region
    (overwrite_article_ids.py:87-198 semantics, simplified to the id-join)."""
    assert len(page_paths) == len(gt_paths)
    updated_files = 0
    for page_path, gt_path in zip(sorted(page_paths, key=os.path.basename),
                                  sorted(gt_paths, key=os.path.basename)):
        page_file = Page(page_path)
        gt_file = Page(gt_path)
        gt_article = {tl.id: tl.get_article_id() for tl in gt_file.get_textlines()}

        changed = False
        for region in page_file.get_text_regions():
            ids = [gt_article.get(tl.id) for tl in region.text_lines
                   if tl.id in gt_article]
            ids = [i for i in ids if i is not None]
            if not ids:
                continue
            majority = max(set(ids), key=ids.count)
            for tl in region.text_lines:
                if tl.get_article_id() != majority:
                    tl.set_article_id(majority)
                    changed = True
            page_file.set_textline_attr(region.text_lines)
        if changed:
            page_file.write_page_xml(page_path)
            updated_files += 1
    return updated_files


# ---------------------------------------------------------------- stats

def get_page_stats(path_to_pagexml: str, region_stats=True,
                   text_line_stats=True, article_stats=True) -> Dict[str, object]:
    """Per-page statistics dict (page_stats.py:9-38; printed by the CLI)."""
    page_file = Page(path_to_pagexml)
    width, height = page_file.get_image_resolution()
    out: Dict[str, object] = {"path": path_to_pagexml,
                              "width": width, "height": height}
    if region_stats:
        regions = page_file.get_regions()
        out["regions"] = {k: len(v) for k, v in regions.items()}
        if text_line_stats and "TextRegion" in regions:
            out["num_text_lines"] = sum(
                len(tr.text_lines) for tr in regions["TextRegion"])
    if article_stats:
        out["num_articles"] = len(page_file.get_article_dict())
    return out


# ---------------------------------------------------------------- splitting

def create_sub_lists(list_path: str, split: float = 0.1,
                     seed: Optional[int] = None) -> Tuple[str, str, str]:
    """Shuffle + split a list file into _train/_val/_test lists
    (create_sub_lists.py:6-42). ``split`` < 1 is a fraction for val AND test
    each; >= 1 an absolute count. Returns the three written paths."""
    with open(list_path) as f:
        paths = f.readlines()
    rng = random.Random(seed)
    rng.shuffle(paths)

    n = int(len(paths) * float(split)) if float(split) < 1 else int(split)
    assert len(paths) > 2 * n, "Not enough list elements for the desired split!"

    dirname = os.path.dirname(list_path)
    base = os.path.basename(list_path).split(".")[0]
    out_paths = []
    for name, chunk in (("val", paths[:n]), ("test", paths[n:2 * n]),
                        ("train", paths[2 * n:])):
        path = os.path.join(dirname, f"{base}_{name}.lst")
        with open(path, "w") as f:
            f.writelines(chunk)
        out_paths.append(path)
    val_path, test_path, train_path = out_paths
    return train_path, val_path, test_path


# ---------------------------------------------------------------- BERT pairs

def _region_texts(page: Page) -> Dict[str, str]:
    return {tr.id: "\n".join(tl.text for tl in tr.text_lines)
            for tr in page.get_text_regions()}


def _region_articles(page: Page) -> Dict[str, Optional[str]]:
    out = {}
    for tr in page.get_text_regions():
        ids = [tl.get_article_id() for tl in tr.text_lines]
        ids = [i for i in ids if i is not None]
        out[tr.id] = max(set(ids), key=ids.count) if ids else None
    return out


def generate_bert_finetuning_data(page_paths: Sequence[str], out_path: str) -> str:
    """Region-pair text JSON with same-article labels for external BERT
    similarity finetuning (bert_finetuning_generation.py). Schema:
    [{'text_a', 'text_b', 'label', 'page', 'id_a', 'id_b'}, ...]."""
    records = []
    for page_path in page_paths:
        page = Page(page_path)
        texts = _region_texts(page)
        articles = _region_articles(page)
        ids = list(texts.keys())
        for i, id_a in enumerate(ids):
            for id_b in ids[i + 1:]:
                if not texts[id_a] or not texts[id_b]:
                    continue
                records.append({
                    "page": os.path.basename(page_path),
                    "id_a": id_a, "id_b": id_b,
                    "text_a": texts[id_a], "text_b": texts[id_b],
                    "label": int(articles[id_a] is not None
                                 and articles[id_a] == articles[id_b]),
                })
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(records, f)
    return out_path


def generate_bert_prediction_data(page_paths: Sequence[str], out_path: str) -> str:
    """Unlabeled region-pair text JSON for BERT inference
    (bert_prediction_generation.py); the predictions come back through
    ``--external_jsons`` in feature generation."""
    records = []
    for page_path in page_paths:
        page = Page(page_path)
        texts = _region_texts(page)
        ids = list(texts.keys())
        for i, id_a in enumerate(ids):
            for id_b in ids[i + 1:]:
                records.append({
                    "page": os.path.basename(page_path),
                    "id_a": id_a, "id_b": id_b,
                    "text_a": texts[id_a], "text_b": texts[id_b],
                })
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(records, f)
    return out_path
