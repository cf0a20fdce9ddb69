"""PAGE-XML parity: the port's ElementTree-based ``pagexml`` and separator
writer against the JAX package's lxml-based ones. The gate is the written
file, byte for byte, with the timestamps frozen on both sides."""
import numpy as np
import pytest

import citlab_as_tpu.pagexml.page as jpage
import citlab_as_tpu.pagexml as jx
import citlab_as_tpu.stages.separator_writer as jwriter
import citlab_as_tpu_torch.pagexml.page as tpage
import citlab_as_tpu_torch.pagexml as tx
import citlab_as_tpu_torch.stages.separator_writer as twriter

from tests.test_heading_stage import PAGE_XML as HEADING_XML
from tests.test_pagexml import EXOTIC_TRANSKRIBUS, SAMPLE
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

SIDES = ((jx, jpage, jwriter), (tx, tpage, twriter))

PREFIXED = """<?xml version="1.0"?>
<!-- exported by a tool that prefixes the namespace -->
<pc:PcGts xmlns:pc="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15"
          xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
          xsi:schemaLocation="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15 http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15/pagecontent.xsd">
  <pc:Metadata><pc:Creator>c &amp; d</pc:Creator><pc:Created>t</pc:Created><pc:LastChange>t</pc:LastChange></pc:Metadata>
  <pc:Page imageFilename="a&quot;b.png" imageWidth="100" imageHeight="80">
    <!-- a comment inside -->
    <pc:TextRegion id="r1">
      <pc:Coords points="1,1 90,1 90,70 1,70"/>
      <pc:TextLine id="l1">
        <pc:Coords points="2,2 80,2 80,20 2,20"/>
        <pc:TextEquiv><pc:Unicode>  </pc:Unicode></pc:TextEquiv>
      </pc:TextLine>
      <pc:TextLine id="l2">
        <pc:Coords points="2,30 80,30 80,50 2,50"/>
        <pc:TextEquiv>mixed<pc:Unicode>x</pc:Unicode>
        </pc:TextEquiv>
      </pc:TextLine>
      <?keep this?>
    </pc:TextRegion>
  </pc:Page>
</pc:PcGts>
<!-- trailing -->
"""

FIXTURES = {"sample": SAMPLE, "exotic": EXOTIC_TRANSKRIBUS,
            "heading": HEADING_XML, "prefixed": PREFIXED}

TEXTS = ["a & b", "x < y > z", 'say "hi"', "two\nlines", "tab\there",
         "Zeitung für Städte – “Ärger”", "carriage\rreturn", ""]


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")


def _both(tmp_path, fn):
    """Run ``fn(pagexml_module, page_module, writer_module, out_path)`` on
    each side and return the two written files' bytes."""
    outs = []
    for i, (px, pg, wr) in enumerate(SIDES):
        out = str(tmp_path / f"out_{i}.xml")
        fn(px, pg, wr, out)
        with open(out, "rb") as f:
            outs.append(f.read())
    return outs


def _src(tmp_path, name):
    p = tmp_path / "page" / f"{name}.xml"
    p.parent.mkdir(exist_ok=True)
    p.write_text(FIXTURES[name], encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_load_write_bytes_equal(tmp_path, name):
    src = _src(tmp_path, name)
    a, b = _both(tmp_path, lambda px, pg, wr, out: px.Page(src).write_page_xml(out))
    assert a == b


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_load_mutate_write_bytes_equal(tmp_path, name):
    src = _src(tmp_path, name)

    def mutate(px, pg, wr, out):
        page = px.Page(src)
        tls = page.textlines
        for k, tl in enumerate(tls):
            tl.set_article_id(f"a{k % 2}")
            tl.set_structure_attribute("semantic_type", "heading")
        page.set_textline_attr(tls)
        page.remove_regions("SeparatorRegion")
        page.add_region(px.SeparatorRegion(
            page.get_unique_id("SeparatorRegion"),
            custom={"structure": {"orientation": "vertical"}},
            points=[(1, 2), (3, 2), (3, 40), (1, 40)]))
        regions = page.get_text_regions()
        new_line = px.TextLine("new_tl", {"readingOrder": {"index": "7"}},
                               "added <line> & more",
                               [(3, 18), (60, 18)],
                               [(3, 3), (60, 3), (60, 20), (3, 20)],
                               [px.Word("new_w", None, "wörd",
                                        [(3, 3), (20, 3), (20, 20), (3, 20)])])
        page.set_text_lines(regions[0], [new_line], overwrite=False)
        nd = page.get_child_by_id(page.page_doc, regions[-1].id)[0]
        page.set_custom_attr(nd, "structure", "type", "x")
        page.remove_custom_attr(nd, "structure", "type")
        first_tl = page.get_child_by_name(page.page_doc, "TextLine")[0]
        anc = page.get_ancestor_by_name(first_tl, "TextRegion")
        anc[0].set("type", "heading")
        assert page.get_ancestor_by_id(first_tl, anc[0].get("id")) == [anc[0]]
        page.write_page_xml(out, comments="a comment & more")

    a, b = _both(tmp_path, mutate)
    assert a == b
    assert b"new_tl" in a


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_accessors_equal(tmp_path, name):
    src = _src(tmp_path, name)
    seen = []
    for px, _, _ in SIDES:
        page = px.Page(src)
        seen.append({
            "ids": list(page.get_ids()),
            "res": page.get_image_resolution(),
            "file": page.get_image_filename(),
            "ps": page.get_print_space_coords(),
            "meta": vars(page.metadata)["Creator"],
            "lines": [(tl.id, tl.custom, tl.text,
                       tl.baseline and tl.baseline.points_list,
                       tl.surr_p and tl.surr_p.points_list,
                       [(w.id, w.text) for w in tl.words])
                      for tl in page.textlines],
            "regions": {k: [(r.id, r.custom, r.points.points_list)
                            for r in v]
                        for k, v in page.get_regions().items()},
            "types": [(r.id, r.region_type, len(r.text_lines))
                      for r in page.get_text_regions()],
            "articles": {k: [tl.id for tl in v]
                         for k, v in page.get_article_dict().items()},
            "valid": px.Page.validate_structural(page.page_doc),
        })
    assert seen[0] == seen[1]


def test_created_from_nothing_bytes_equal(tmp_path):
    def create(px, pg, wr, out):
        page = px.Page(creator_name="tester", img_filename="img/ä.png",
                       img_w=640, img_h=480)
        lines = [px.TextLine(f"tl_{i}", {"structure": {"id": "a1", "type": "article"}},
                             text, [(10, 30 + 40 * i), (300, 30 + 40 * i)],
                             [(10, 10 + 40 * i), (300, 10 + 40 * i),
                              (300, 35 + 40 * i), (10, 35 + 40 * i)])
                 for i, text in enumerate(TEXTS)]
        lines.append(px.TextLine("tl_nopoly", None, "dropped"))
        region = px.TextRegion("tr_1", {"readingOrder": {"index": "0"}},
                               [(5, 5), (320, 5), (320, 400), (5, 400)], lines)
        page.set_text_regions([region])
        page.add_region(px.ImageRegion("img_1", None,
                                       [(400, 10), (600, 10), (600, 200), (400, 200)]))
        page.write_page_xml(out)

    a, b = _both(tmp_path, create)
    assert a == b
    assert a.startswith(b"<?xml version='1.0' encoding='UTF-8' standalone='yes'?>\n<PcGts xmlns=")
    # and the file reads back the same on both sides
    for i, (px, _, _) in enumerate(SIDES):
        page = px.Page(str(tmp_path / f"out_{1 - i}.xml"))
        assert [tl.text for tl in page.textlines] == TEXTS


def test_metadata_repair_bytes_equal(tmp_path):
    p = tmp_path / "broken.xml"
    p.write_text('<?xml version="1.0"?>\n<PcGts xmlns="%s">\n  <Page imageFilename="x.jpg"'
                 ' imageWidth="10" imageHeight="10"/>\n</PcGts>' % tx.constants.NS_PAGE_XML)
    a, b = _both(tmp_path, lambda px, pg, wr, out: px.Page(str(p)).write_page_xml(out))
    assert a == b and b"Metadata entry was missing" in a


def test_validate_structural_rejections(tmp_path):
    """The port's ``validate`` is the structural validator: same verdicts as
    the JAX package's ``validate_structural`` on broken documents."""
    breakages = {
        "dup_id": SAMPLE.replace('id="tl_2"', 'id="tl_1"'),
        "no_coords": SAMPLE.replace(
            '<Coords points="520,0 530,0 530,1400 520,1400"/>', ""),
        "bad_points": SAMPLE.replace('points="50,90 500,90"', 'points="50,90"'),
        "neg_points": SAMPLE.replace('points="50,90 500,90"', 'points="-5,90 500,90"'),
        "no_width": SAMPLE.replace(' imageWidth="1000"', ""),
        "wrong_ns": SAMPLE.replace("2013-07-15", "2010-03-19"),
        "ok": SAMPLE,
    }
    for name, raw in breakages.items():
        p = tmp_path / f"{name}.xml"
        p.write_text(raw)
        verdicts = [px.Page.validate_structural(pg.Page.load_page_xml(None, str(p)))
                    for px, pg, _ in SIDES]
        assert verdicts[0] == verdicts[1], name
        assert verdicts[1] == (name == "ok"), name
    doc = tpage.Page.load_page_xml(None, str(tmp_path / "dup_id.xml"))
    assert tpage.Page.validate(doc) is False


def test_page_cache_and_snapshots(tmp_path):
    """The scoped parse cache and the generation-tracked snapshots: a second
    stage sees what the first wrote through the same instance."""
    src = _src(tmp_path, "sample")
    with tpage.page_cache():
        stage1 = tx.Page(src)
        tls = stage1.textlines
        tls[0].set_article_id("zz")
        stage1.set_textline_attr(tls)
        assert stage1.textlines is tls            # snapshot stayed valid
        stage1.write_page_xml(src)
        stage2 = tx.Page(src)
        assert stage2 is stage1
        assert stage2.textlines is tls            # survives set_metadata
        assert stage2.get_article_dict()["zz"][0].id == tls[0].id
        stage2.remove_regions("SeparatorRegion")
        assert stage2.textlines is not tls        # a mutation re-derives
        other = str(tmp_path / "page" / "other.xml")
        stage2.write_page_xml(other)
        assert tx.Page(other) is stage2
        assert tx.Page(src) is not stage2         # rebinding dropped the old key
    assert tx.Page(src) is not tx.Page(src)       # no cache outside the block


def test_parent_map_follows_edits_outside_the_api(tmp_path):
    page = tx.Page(_src(tmp_path, "sample"))
    region = page.get_child_by_name(page.page_doc, "TextRegion")[0]
    line = page.get_child_by_name(region, "TextLine")[0]
    page.remove_page_xml_node(line)                      # builds the map
    import xml.etree.ElementTree as ET
    moved = ET.SubElement(page.page_doc.getroot(), line.tag, {"id": "moved"})
    assert page.get_ancestor_by_name(moved, "TextRegion") == []
    page.remove_page_xml_node(moved)
    assert "moved" not in page.get_ids()


# ------------------------------------------------------------ separator writer

def _rect(x0, y0, x1, y1):
    return [[(x0, y0), (x1, y0), (x1, y1), (x0, y1)]]


def _write_png(path, h, w):
    from PIL import Image
    Image.fromarray(np.full((h, w), 255, np.uint8)).save(path)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("page_exists", [True, False])
def test_separator_writer_bytes_equal(tmp_path, page_exists):
    """Same polygons dict in, same file out, including a text line split at
    a vertical separator (tl_1 and tl_2 straddle x = 250..260), a line
    swallowed by a separator, and a separator with a large hole."""
    img = str(tmp_path / "p1.png")
    _write_png(img, 1400, 1000)
    src = _src(tmp_path, "sample") if page_exists else str(tmp_path / "page" / "none.xml")
    ring_with_hole = [[(600, 600), (900, 600), (900, 900), (600, 900)],
                      [(650, 650), (850, 650), (850, 850), (650, 850)]]
    polygons = {
        "SeparatorRegion_horizontal": [_rect(40.4, 400.6, 900.5, 410.2), ring_with_hole],
        "SeparatorRegion_vertical": [_rect(250.2, 20.0, 260.7, 500.0),
                                     _rect(45, 140, 505, 205)],
    }

    def write(px, pg, wr, out):
        writer = wr.SeparatorRegionToPageWriter(src, img, 1500, 1.0, polygons)
        writer.remove_separator_regions_from_page()
        writer.merge_regions()
        writer.save_page_xml(out)

    a, b = _both(tmp_path, write)
    assert a == b
    assert a.count(b"<SeparatorRegion ") >= 4
    if page_exists:
        assert b'id="tl_1_1"' in a and b'id="tl_1_2"' in a     # split
        assert b'id="tl_2"' not in a                           # swallowed
    else:
        assert b'imageWidth="1071"' in a                       # 1000 * 1500/1400


def test_region_writer_scaling_factor_and_size(tmp_path):
    img = str(tmp_path / "q.png")
    _write_png(img, 200, 100)
    got = [wr.RegionToPageWriter(str(tmp_path / "none.xml"), img, 900, 1.0)
           for _, _, wr in SIDES]
    assert got[0].scaling_factor == got[1].scaling_factor == 4.5
    assert (got[0].page_object.get_image_resolution()
            == got[1].page_object.get_image_resolution() == (450, 900))


# ------------------------------------------------------------ random documents

_WS = ["", " ", "\n", "\n  ", "\t", " \n "]
_TXT = ["", "a", "a b", " x ", "&amp;", "&lt;b&gt;", "é", "l1\nl2", "q\"q", "&#13;", "&#9;t"]


def _random_element(rng, depth):
    name = rng.choice(["A", "B", "Coords", "pc:P", "TextEquiv", "Unicode"])
    attrs = ""
    for k in rng.sample(["id", "points", "custom", "xml:space", "type"], rng.randint(0, 2)):
        v = rng.choice(["1", "a b", "x&amp;y", "&quot;q&quot;", "&lt;", "l&#10;f", "t&#9;",
                        "preserve" if k == "xml:space" else "v"])
        attrs += f' {k}="{v}"'
    if depth > 3 or rng.random() < 0.3:
        return f"<{name}{attrs}" + rng.choice(["/>", ">" + rng.choice(_TXT + _WS) + f"</{name}>"])
    body = rng.choice(_WS + _TXT[:3])
    for _ in range(rng.randint(0, 4)):
        r = rng.random()
        body += ("<!-- c -->" if r < 0.1 else "<?pi d?>" if r < 0.15
                 else "<![CDATA[ <x> ]]>" if r < 0.2 else _random_element(rng, depth + 1))
        body += rng.choice(_WS * 3 + _TXT[:4])
    return f"<{name}{attrs}>{body}</{name}>"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_documents_parse_and_print_like_lxml(tmp_path, seed):
    """Mixed content, blanks in every position, comments, PI nodes, CDATA, ``xml:space``, prefixes and characters that need
    escaping: parse with blank removal, pretty-print, compare the text with
    lxml's on 120 random documents per seed."""
    import random

    from lxml import etree

    from citlab_as_tpu_torch.pagexml import xmlio
    rng = random.Random(seed)
    ns = tx.constants.NS_PAGE_XML
    p = str(tmp_path / "doc.xml")
    for _ in range(120):
        doc = (f'<?xml version="1.0"?>\n<!-- top -->\n<PcGts xmlns="{ns}" xmlns:pc="http://pc" '
               f'xmlns:xsi="{tx.constants.NS_XSI}" xsi:schemaLocation="a b">{rng.choice(_WS)}'
               f'{_random_element(rng, 0)}{rng.choice(_WS)}{_random_element(rng, 0)}\n</PcGts>\n')
        with open(p, "w", encoding="utf-8") as f:
            f.write(doc)
        tree = etree.parse(p, etree.XMLParser(remove_blank_text=True))
        want = etree.tostring(tree, pretty_print=True, encoding="UTF-8", standalone=True,
                              xml_declaration=True).decode()
        assert xmlio.tostring(xmlio.parse(p)) == want, doc
