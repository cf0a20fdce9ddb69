"""The port's page preprocessing (``stages/preprocessing.py``,
``cli/run_page_preprocessing.py``, ``utils/misc.py``) against the JAX
package's, on the CPU, with the clock frozen on both sides.

The committed fixture (``tests/data/torch_preprocessing``, written by
``scripts/make_preprocessing_fixtures.py``): pages in two folders with a
line id repeated outside every region, margin fragments, lines with
degenerate or missing coordinates and a region left without a usable
line. For every flag combination of the CLI (backup and overwrite,
``--save_folder`` mirroring into another folder and into a page folder
itself, ``--delete_border_textlines``, ``--fix_incorrect_regions`` with
and without ``--overwrite``) the files both CLIs write are equal byte for
byte, and both equal the committed digests. Batching over more pages than
a batch holds, and the ``ValueError`` cases of the region fix, are equal.
"""
import os
import shutil
import sys

import numpy as np
import pytest

from citlab_as_tpu.cli import run_page_preprocessing as jcli
from citlab_as_tpu.pagexml import page as jpage
from citlab_as_tpu.stages import preprocessing as jpre
from citlab_as_tpu.utils import misc as jmisc
from citlab_as_tpu_torch.cli import run_page_preprocessing as tcli
from citlab_as_tpu_torch.pagexml import page as tpage
from citlab_as_tpu_torch.stages import preprocessing as tpre
from citlab_as_tpu_torch.utils import misc as tmisc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import make_preprocessing_fixtures as fixtures  # noqa: E402

DIGESTS = fixtures.json.load(open(os.path.join(fixtures.OUT, "digests.json")))["runs"]


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_fixture_is_the_scripts_output(tmp_path):
    fixtures.write_pages(str(tmp_path))
    for rel in fixtures.input_pages():
        with open(os.path.join(fixtures.OUT, rel), "rb") as a, \
                open(os.path.join(tmp_path, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert sorted(DIGESTS) == sorted(fixtures.RUNS)


@pytest.mark.parametrize("run", sorted(fixtures.RUNS))
def test_cli_writes_the_jax_bytes(tmp_path, run):
    argv = fixtures.RUNS[run]
    digests, files = {}, {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        root = str(tmp_path / name)
        os.makedirs(root)
        digests[name] = fixtures.run_in_copy(main, argv, fixtures.OUT, root)
        files[name] = _files(os.path.join(root, "work"))
    assert files["port"] == files["jax"]
    assert digests["port"] == digests["jax"] == DIGESTS[run]["files"]
    # the run wrote corrected pages, and every input page is still there
    inputs = {fixtures.normalised_digest(os.path.join(fixtures.OUT, rel))
              for rel in fixtures.input_pages()}
    assert set(digests["port"].values()) - inputs
    assert all(rel in digests["port"] for rel in fixtures.input_pages())


def test_batches_equal_jax(tmp_path, monkeypatch):
    """Five pages in batches of two through ``PagePreProcessor`` (the CLI's
    loop), written beside the pages."""
    monkeypatch.setattr(jpre, "BATCH_SIZE", 2)
    monkeypatch.setattr(tpre, "BATCH_SIZE", 2)
    written = {}
    for name, module in (("jax", jpre), ("port", tpre)):
        root = tmp_path / name
        paths = []
        for i in range(5):
            rel = fixtures.input_pages()[i % len(fixtures.input_pages())]
            dst = root / f"f{i}" / "page" / os.path.basename(rel)
            os.makedirs(dst.parent)
            shutil.copyfile(os.path.join(fixtures.OUT, rel), dst)
            paths.append(str(dst))
        proc = module.PagePreProcessor(paths)
        assert proc.num_batches == 3
        for _ in range(proc.num_batches):
            proc.delete_textlines_with_same_id()
            proc.delete_border_textlines(min_margin=100)
            proc.save_page_files(overwrite=True)
            proc.update_step()
        written[name] = _files(str(root))
    assert written["port"] == written["jax"] and len(written["port"]) == 5


def _with_line_copies(path, line_id, copies, inside):
    """The page with ``copies`` more copies of line ``line_id``: inside its
    region (after it) or outside every region."""
    import re
    with open(path, encoding="utf-8") as f:
        xml = f.read()
    m = re.search(rf'      <TextLine id="{line_id}"[^>]*>.*?</TextLine>\n', xml, re.S)
    block = m.group(0)
    if inside:
        xml = xml.replace(block, block * (copies + 1))
    else:
        xml = xml.replace("  </Page>", block.replace("      ", "    ") * copies + "  </Page>")
    with open(path, "w", encoding="utf-8") as f:
        f.write(xml)


@pytest.mark.parametrize("case", ["two_inside", "three", "no_duplicates"])
def test_region_fix_errors_equal_jax(tmp_path, case):
    results = {}
    for name, module in (("jax", jpre), ("port", tpre)):
        page = tmp_path / name / "p0.xml"
        os.makedirs(page.parent)
        shutil.copyfile(os.path.join(fixtures.OUT, fixtures.input_pages()[0]), page)
        if case == "two_inside":
            _with_line_copies(str(page), "p0_r0_l2", 1, inside=True)
        elif case == "three":
            _with_line_copies(str(page), "p0_r2_l3", 2, inside=False)
        try:
            module.remove_incorrect_regions_and_lines([str(page)], overwrite=False)
            with open(str(page) + ".xml", "rb") as f:
                results[name] = ("ok", f.read())
        except ValueError as e:
            results[name] = ("ValueError", str(e))
    assert results["port"] == results["jax"]
    assert results["port"][0] == ("ok" if case == "no_duplicates" else "ValueError")


def test_misc_helpers_equal_jax():
    items = list(range(11))
    for n in (1, 3, 4, 11, 20):
        assert tmisc.split_list(items, n) == jmisc.split_list(items, n)
    for k in (1, 4, 11, 12):
        assert tmisc.chunk_list(items, k) == jmisc.chunk_list(items, k)
    objs = [type("O", (), {"id": i % 3, "v": i})() for i in range(7)]
    assert {k: [o.v for o in v] for k, v in tmisc.group_by_attribute(objs, "id").items()} == \
        {k: [o.v for o in v] for k, v in jmisc.group_by_attribute(objs, "id").items()}
    assert [o.v for o in tmisc.filter_by_attribute(objs, "id", 1)] == \
        [o.v for o in jmisc.filter_by_attribute(objs, "id", 1)]
    assert tmisc.flatten([[1, 2], [], [3]]) == jmisc.flatten([[1, 2], [], [3]])
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tmisc.chunk_list(items, bad)
        with pytest.raises(ValueError):
            tmisc.split_list(items, bad)
    assert np.array_equal(np.concatenate(tmisc.split_list(items, 4)), items)
