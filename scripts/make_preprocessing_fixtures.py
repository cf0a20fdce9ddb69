"""Write the page-preprocessing fixtures of ``chip_smoke.py``'s ``models``
phase and ``tests/test_torch_preprocessing.py`` into
``tests/data/torch_preprocessing/``:

- ``N_PAGES`` PAGE-XML pages (seed ``SEED``) in two folders (``a/page``,
  ``b/page``), each with what the preprocessing corrects: a text line's
  id again on a line outside every region, with the article id the
  region's copy lacks, short text-line
  fragments in the left and right margins among full-width lines, lines
  with degenerate (one-point) or missing coordinates, and a region left
  with no usable line;
- ``digests.json``: for every flag combination of the JAX package's
  ``cli/run_page_preprocessing.py`` (``RUNS``), the sha256 of every file
  in the work directory after the CLI ran over a copy of the pages (the
  rewritten pages, ``.bak`` copies, mirrored folders, ``.xml.xml``
  outputs), with ``<LastChange>`` blanked.

The smoke holds the port's CLI to these digests on the card's machine;
the tier-1 test holds both packages to them. Needs the JAX package; run
from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_preprocessing_fixtures.py
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_preprocessing")
SEED = 31
N_PAGES = 4
PAGE_W, PAGE_H = 1400, 2000
# flag lists of run_page_preprocessing; "{mirror}" and "{same}" stand for a
# folder beside the pages and for the first page folder itself
RUNS = {
    "default": [],
    "border": ["--delete_border_textlines"],
    "overwrite": ["--overwrite"],
    "overwrite_border": ["--overwrite", "--delete_border_textlines"],
    "mirror": ["--save_folder", "{mirror}"],
    "mirror_border": ["--save_folder", "{mirror}", "--delete_border_textlines"],
    "mirror_overwrite": ["--save_folder", "{mirror}", "--overwrite"],
    "same_folder": ["--save_folder", "{same}"],
    "same_folder_border": ["--save_folder", "{same}", "--delete_border_textlines"],
    "fix": ["--fix_incorrect_regions"],
    "fix_overwrite": ["--fix_incorrect_regions", "--overwrite"],
}


def _line(line_id, x0, x1, y, article=None, coords=True):
    custom = f' custom="structure {{id:{article}; type:article;}}"' if article else ""
    out = f'      <TextLine id="{line_id}"{custom}>\n'
    if coords is True:
        out += (f'        <Coords points="{x0},{y - 28} {x1},{y - 28} {x1},{y + 4} '
                f'{x0},{y + 4}"/>\n')
    elif coords == "point":
        out += f'        <Coords points="{x0},{y}"/>\n'
    out += f'        <Baseline points="{x0},{y} {(x0 + x1) // 2},{y + 1} {x1},{y}"/>\n'
    out += (f"        <TextEquiv>\n          <Unicode>{line_id} text</Unicode>\n"
            f"        </TextEquiv>\n      </TextLine>\n")
    return out


def page_xml(name, rng):
    """One page of the fixture (see the module docstring)."""
    regions = []
    y0 = 120
    for r in range(3):
        x0, x1 = 120 + r * 400, 460 + r * 400
        lines = ""
        n = rng.randint(5, 9)
        for i in range(n):
            y = y0 + 70 * i + rng.randint(0, 10)
            lines += _line(f"{name}_r{r}_l{i}", x0 + rng.randint(0, 20), x1 - rng.randint(0, 20),
                           y, article=f"a{r}" if i % 2 == 0 else None)
        if r == 0:
            # margin fragments: short lines starting in the left margin
            for i in range(2):
                y = y0 + 70 * n + 60 * i
                lines += _line(f"{name}_lfrag{i}", rng.randint(5, 60), 140, y)
            lines += _line(f"{name}_deg", x0, x1, y0 + 70 * n + 200, coords="point")
        if r == 2:
            for i in range(2):
                y = y0 + 70 * n + 60 * i
                lines += _line(f"{name}_rfrag{i}", PAGE_W - 150, PAGE_W - rng.randint(5, 60), y)
            lines += _line(f"{name}_nocoords", x0, x1, y0 + 70 * n + 200, coords=False)
        hy = y0 + 70 * (n + 4)
        regions.append(
            f'    <TextRegion id="{name}_r{r}" custom="readingOrder {{index:{r};}}">\n'
            f'      <Coords points="{x0 - 10},{y0 - 40} {x1 + 10},{y0 - 40} '
            f'{x1 + 10},{hy} {x0 - 10},{hy}"/>\n{lines}    </TextRegion>\n')
    regions.append(
        f'    <TextRegion id="{name}_empty">\n'
        f'      <Coords points="50,1900 60,1900 60,1910 50,1910"/>\n'
        + _line(f"{name}_emptyline", 50, 60, 1905, coords="point") + '    </TextRegion>\n')
    # the duplicate outside every region, with the article the region's
    # copy lacks (it is taken over)
    outside = _line(f"{name}_r1_l1", 520, 860, 1800, article="a1").replace("      ", "    ", 1)
    return ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
            '<PcGts xmlns="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15">\n'
            '  <Metadata>\n    <Creator>fixture</Creator>\n'
            '    <Created>2024-01-02T03:04:05Z</Created>\n'
            '    <LastChange>2024-01-02T03:04:05Z</LastChange>\n  </Metadata>\n'
            f'  <Page imageFilename="{name}.png" imageWidth="{PAGE_W}" imageHeight="{PAGE_H}">\n'
            + "".join(regions) + outside + "  </Page>\n</PcGts>\n")


def write_pages(out_dir):
    rng = np.random.RandomState(SEED)
    paths = []
    for i in range(N_PAGES):
        folder = os.path.join(out_dir, "a" if i % 2 == 0 else "b", "page")
        os.makedirs(folder, exist_ok=True)
        paths.append(os.path.join(folder, f"p{i}.xml"))
        with open(paths[-1], "w", encoding="utf-8") as f:
            f.write(page_xml(f"p{i}", rng))
    return paths


def input_pages(data_dir=OUT):
    """The committed pages, relative to ``data_dir``, in list order."""
    return [os.path.join("a" if i % 2 == 0 else "b", "page", f"p{i}.xml")
            for i in range(N_PAGES)]


def normalised_digest(path):
    with open(path, "rb") as f:
        data = f.read()
    data = re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>", data)
    return hashlib.sha256(data).hexdigest()


def run_in_copy(main, argv_template, data_dir, work_root):
    """Copy the fixture pages into ``work_root/work``, run ``main`` (a
    ``run_page_preprocessing.main``) with the flags, and return
    ``{relative path: digest}`` of every file under the work directory."""
    work = os.path.join(work_root, "work")
    shutil.rmtree(work, ignore_errors=True)
    pages = []
    for rel in input_pages(data_dir):
        os.makedirs(os.path.join(work, os.path.dirname(rel)), exist_ok=True)
        pages.append(os.path.join(work, rel))
        shutil.copyfile(os.path.join(data_dir, rel), pages[-1])
    lst = os.path.join(work_root, "pages.lst")
    with open(lst, "w") as f:
        f.write("\n".join(pages) + "\n")
    argv = [a.format(mirror=os.path.join(work, "mirror"),
                     same=os.path.dirname(pages[0])) for a in argv_template]
    main(["--page_path_list", lst] + argv)
    return {os.path.relpath(os.path.join(d, n), work): normalised_digest(os.path.join(d, n))
            for d, _, names in os.walk(work) for n in names}


def main():
    sys.path.insert(0, REPO)
    from citlab_as_tpu.cli import run_page_preprocessing

    shutil.rmtree(OUT, ignore_errors=True)
    write_pages(OUT)
    digests = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in RUNS.items():
            digests["runs"][name] = {
                "argv": argv,
                "files": run_in_copy(run_page_preprocessing.main, argv, OUT, tmp)}
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {N_PAGES} pages and {len(RUNS)} runs' digests to {OUT}")


if __name__ == "__main__":
    main()
