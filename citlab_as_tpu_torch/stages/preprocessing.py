"""Page preprocessing + error correction (port of
``citlab_as_tpu/stages/preprocessing.py``). Host only: PAGE-XML in, PAGE-XML
out, byte-equal to the JAX package's files (``.bak`` copies and mirrored
folders included).

Reference: python_util/preprocessing/page_preprocessing.py:18-159 and
python_util/error_correction/remove_incorrect_regions_and_lines.py:25-80.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from shutil import copyfile
from typing import List, Optional, Sequence

from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.utils.io import load_text_file
from citlab_as_tpu_torch.utils.misc import chunk_list, group_by_attribute

logger = logging.getLogger(__name__)

BATCH_SIZE = 100


class PagePreProcessor:
    """Correct PAGE-XML files in batches: drop duplicate-id text lines and
    short text lines hanging into the scan margins."""

    def __init__(self, page_path_list):
        if isinstance(page_path_list, str):
            self.page_path_list_full = load_text_file(page_path_list)
        else:
            self.page_path_list_full = list(page_path_list)
        self.num_files = len(self.page_path_list_full)
        self.page_path_list = chunk_list(self.page_path_list_full, BATCH_SIZE)
        self.current_batch_idx = 0
        self.num_batches = len(self.page_path_list)
        self.page_object_list = self._create_page_objects(self.current_batch_idx)

    def _create_page_objects(self, batch_idx) -> List[Page]:
        return [Page(p) for p in self.page_path_list[batch_idx]]

    def update_step(self) -> None:
        self.current_batch_idx = min(self.num_batches - 1, self.current_batch_idx + 1)
        self.page_object_list = self._create_page_objects(self.current_batch_idx)

    # ------------------------------------------------------------------
    def delete_textlines_with_same_id(self) -> None:
        """Keep only the first DOM node per duplicated text line id
        (page_preprocessing.py:41-62)."""
        for i, page_object in enumerate(self.page_object_list):
            textlines = page_object.get_textlines(ignore_redundant_textlines=False)
            if not textlines:
                continue
            groups = group_by_attribute(textlines, "id")
            removed = 0
            for tl_id, tl_list in groups.items():
                if len(tl_list) > 1:
                    removed += 1
                    nds = page_object.get_child_by_id(page_object.page_doc, tl_id)
                    for nd in nds[1:]:
                        page_object.remove_page_xml_node(nd)
            if removed:
                logger.info("Removed %d duplicated text line ids in %s",
                            removed, self.page_path_list[self.current_batch_idx][i])

    def delete_border_textlines(self, min_margin: int = 80) -> None:
        """Drop short text lines starting/ending within the page margins —
        fragments of neighboring pages in bad scans
        (page_preprocessing.py:64-120)."""
        for page_object in self.page_object_list:
            textlines = [tl for tl in page_object.get_textlines()
                         if tl.baseline is not None]
            if not textlines:
                continue

            def x_min(tl):
                return min(tl.baseline.to_polygon().x_points)

            def x_max(tl):
                return max(tl.baseline.to_polygon().x_points)

            lengths = {tl.id: x_max(tl) - x_min(tl) for tl in textlines}
            avg_len = sum(lengths.values()) / len(textlines)

            removed = 0
            for tl in sorted(textlines, key=x_min):
                if x_min(tl) >= min_margin:
                    break
                if lengths[tl.id] < avg_len / 2:
                    nd = page_object.get_child_by_id(page_object.page_doc, tl.id)[0]
                    page_object.remove_page_xml_node(nd)
                    removed += 1
            max_end_x = page_object.get_image_resolution()[0] - min_margin
            for tl in sorted(textlines, key=x_max, reverse=True):
                if x_max(tl) <= max_end_x:
                    break
                if lengths[tl.id] < avg_len / 2:
                    nds = page_object.get_child_by_id(page_object.page_doc, tl.id)
                    if nds:
                        page_object.remove_page_xml_node(nds[0])
                        removed += 1
            if removed:
                logger.info("Removed %d border text lines", removed)

    # ------------------------------------------------------------------
    def save_page_files(self, overwrite: bool = False,
                        save_folder: Optional[str] = None) -> None:
        """(True, *): overwrite; (False, None): backup then overwrite;
        (False, path): mirror under path (page_preprocessing.py:122-151)."""
        common_prefix = ""
        if save_folder:
            common_prefix = os.path.dirname(
                os.path.commonprefix(self.page_path_list_full)) + os.path.sep
        for page_path, page_object in zip(
                self.page_path_list[self.current_batch_idx], self.page_object_list):
            page_folder = os.path.realpath(os.path.dirname(page_path))
            real_save = os.path.realpath(save_folder) if save_folder else None

            if not overwrite and (save_folder is None or real_save == page_folder):
                save_path = page_path
                copyfile(page_path, page_path + ".bak")
            elif overwrite or save_folder is None or real_save == page_folder:
                save_path = page_path
            else:
                suffix = page_path.split(common_prefix)[-1]
                save_path = os.path.join(save_folder, suffix)
                Path(os.path.dirname(save_path)).mkdir(parents=True, exist_ok=True)
            page_object.write_page_xml(save_path)


def remove_incorrect_regions_and_lines(page_path_list: Sequence[str],
                                       overwrite: bool = True) -> None:
    """Remove duplicated text lines without a parent TextRegion and discard
    degenerate regions (remove_incorrect_regions_and_lines.py:25-80)."""
    from citlab_as_tpu_torch.stages.features import discard_text_regions_and_lines

    for page_path in page_path_list:
        page = Page(page_path)
        text_regions = page.get_text_regions()
        for text_region in text_regions:
            text_lines = []
            for text_line in text_region.text_lines:
                # lines with missing/degenerate coords are unusable by every
                # downstream stage (remove_incorrect_regions_and_lines.py:25)
                if text_line.surr_p is None or len(text_line.surr_p.points_list) < 2:
                    nds = page.get_child_by_id(page.page_doc, text_line.id)
                    for nd in nds:
                        page.remove_page_xml_node(nd)
                    continue
                nds = page.get_child_by_id(page.page_doc, text_line.id)
                if len(nds) > 1:
                    if len(nds) >= 3:
                        raise ValueError(
                            f"Expected at most two text lines with id {text_line.id}, "
                            f"found {len(nds)}.")
                    line1_has_region = bool(page.get_ancestor_by_name(nds[0], "TextRegion"))
                    line2_has_region = bool(page.get_ancestor_by_name(nds[1], "TextRegion"))
                    if line1_has_region and not line2_has_region:
                        duplicate = nds[1]
                    elif line2_has_region and not line1_has_region:
                        duplicate = nds[0]
                        custom = page.parse_custom_attr(duplicate.get("custom"))
                        article_id = custom.get("structure", {}).get("id")
                        if article_id:
                            text_line.set_article_id(article_id)
                    else:
                        raise ValueError("Can't determine duplicate text line.")
                    page.remove_page_xml_node(duplicate)
                text_lines.append(text_line)
            page.set_text_lines(text_region, text_lines, overwrite=True)

        text_regions, _ = discard_text_regions_and_lines(text_regions)
        page.set_text_regions(text_regions, overwrite=True)
        page.write_page_xml(page_path if overwrite else page_path + ".xml")
