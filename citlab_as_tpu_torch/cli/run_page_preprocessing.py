"""Page preprocessing CLI (port of
``citlab_as_tpu/cli/run_page_preprocessing.py``; reference:
python_util/preprocessing/run_page_preprocessing.py). Host only.

    python -m citlab_as_tpu_torch.cli.run_page_preprocessing \\
        --page_path_list pages.lst [--delete_border_textlines] \\
        [--overwrite | --save_folder DIR] [--fix_incorrect_regions]

Without ``--overwrite`` or ``--save_folder`` each page is copied to
``<page>.bak`` and then rewritten; ``--save_folder`` mirrors the pages'
folders under it; ``--fix_incorrect_regions`` writes ``<page>.xml`` beside
each page (the page path plus ``.xml``) unless ``--overwrite``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from citlab_as_tpu_torch.stages.preprocessing import (
    PagePreProcessor, remove_incorrect_regions_and_lines,
)
from citlab_as_tpu_torch.utils.io import load_list_file


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--page_path_list", type=str, required=True)
    parser.add_argument("--overwrite", action="store_true", default=False)
    parser.add_argument("--save_folder", type=str, default=None)
    parser.add_argument("--delete_duplicate_ids", action="store_true", default=True)
    parser.add_argument("--delete_border_textlines", action="store_true", default=False)
    parser.add_argument("--fix_incorrect_regions", action="store_true", default=False)
    args = parser.parse_args(argv)

    if args.fix_incorrect_regions:
        remove_incorrect_regions_and_lines(
            load_list_file(args.page_path_list), overwrite=args.overwrite)
        return

    proc = PagePreProcessor(args.page_path_list)
    for _ in range(proc.num_batches):
        if args.delete_duplicate_ids:
            proc.delete_textlines_with_same_id()
        if args.delete_border_textlines:
            proc.delete_border_textlines()
        proc.save_page_files(overwrite=args.overwrite, save_folder=args.save_folder)
        if proc.current_batch_idx == proc.num_batches - 1:
            break
        proc.update_step()


if __name__ == "__main__":
    main()
