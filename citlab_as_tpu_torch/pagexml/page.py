"""DOM-backed PAGE-XML document (port of ``citlab_as_tpu/pagexml/page.py``).

Load / mutate / save PAGE-XML files. The DOM stays the source of truth so
elements we don't model round-trip untouched; accessors materialize typed
objects on demand.

The JAX package builds on lxml; this port builds on the standard library's
``xml.etree.ElementTree`` and writes the same bytes (``pagexml/xmlio.py``
has the parser's blank-text rule and the serializer). What lxml did with
XPath is done by walking the tree; ElementTree keeps no parent pointers, so
the page keeps a child-to-parent map that it rebuilds when it finds it
stale. There is no XSD validator in the standard library: ``validate`` is
:meth:`Page.validate_structural`, the check the JAX package itself falls
back to when its schema cannot be loaded.
"""
from __future__ import annotations

import datetime
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import xml.etree.ElementTree as etree

from citlab_as_tpu_torch.pagexml import constants as C
from citlab_as_tpu_torch.pagexml import xmlio
from citlab_as_tpu_torch.pagexml.objects import (
    REGIONS_DICT, PageXmlError, Points, TextLine, TextRegion, Word,
    format_custom_attr, parse_custom_attr, string_to_points,
)


def _trusted_points(parsed):
    """Wrap a get_point_list result (already exact int tuples) so the
    TextLine/Word/Region constructors skip their int() re-conversion."""
    return Points._trusted(parsed) if parsed is not None else None

logger = logging.getLogger(__name__)



def _pc(name: str) -> str:
    return "{%s}%s" % (C.NS_PAGE_XML, name)


def _root_of(elt):
    return elt.getroot() if hasattr(elt, "getroot") else elt


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None).isoformat() + "Z"


class Metadata:
    def __init__(self, creator, created, last_change, comments=None, transkribus_meta=None):
        self.Creator = creator
        self.Created = created
        self.LastChange = last_change
        self.Comments = comments
        self.TranskribusMeta = transkribus_meta


class TranskribusMetadata:
    def __init__(self, docId=None, pageId=None, pageNr=None, tsid=None, status=None,
                 userId=None, imgUrl=None, xmlUrl=None, imageId=None):
        self.docId = docId
        self.pageId = pageId
        self.pageNr = pageNr
        self.tsid = tsid
        self.status = status
        self.userId = userId
        self.imgUrl = imgUrl
        self.xmlUrl = xmlUrl
        self.imageId = imageId


# scoped parse cache: within a `page_cache()` block, re-loading a path whose
# file is unchanged since OUR last parse/write returns the SAME Page instance
# (the pipeline stages otherwise parse the same page file 5x per page, each
# stage re-reading what the previous one just wrote). Opt-in only: safe as
# long as every DOM mutation is saved before another consumer loads the path
# (true for all pipeline stages); plain `Page(path)` outside the context
# always parses fresh.
_PAGE_CACHE: dict = {}
_PAGE_CACHE_ON = False


class page_cache:
    """Context manager enabling the scoped Page parse cache."""

    def __enter__(self):
        global _PAGE_CACHE_ON
        self._prev = _PAGE_CACHE_ON
        _PAGE_CACHE_ON = True
        return self

    def __exit__(self, *exc):
        global _PAGE_CACHE_ON
        _PAGE_CACHE_ON = self._prev
        if not _PAGE_CACHE_ON:
            _PAGE_CACHE.clear()
        return False


def page_cache_discard(path: str) -> None:
    """Drop ``path`` from the scoped parse cache: its next load parses the
    file again."""
    _PAGE_CACHE.pop(os.path.abspath(path), None)


class Page:
    """Load, inspect, mutate and save a PAGE-XML document (page.py:27-891)."""

    def __new__(cls, path_to_xml=None, *args, **kwargs):
        if _PAGE_CACHE_ON and isinstance(path_to_xml, str):
            key = os.path.abspath(path_to_xml)
            entry = _PAGE_CACHE.get(key)
            if entry is not None and os.path.exists(key) \
                    and entry[0] == os.path.getmtime(key):
                return entry[1]
        return super().__new__(cls)

    def __init__(self, path_to_xml=None, creator_name=C.CREATOR,
                 img_filename=None, img_w=None, img_h=None):
        if path_to_xml is not None:
            key = os.path.abspath(path_to_xml)
            if (_PAGE_CACHE_ON and getattr(self, "_cache_key", None) == key
                    and self._cache_mtime == os.path.getmtime(key)):
                # cache hit: __new__ returned the live instance. Its DOM is
                # current (mutations happen in place), and the textlines /
                # metadata snapshots are generation-tracked properties that
                # re-derive lazily when a mutator has touched the DOM since
                # (e.g. get_article_dict reads self.textlines, which must
                # see the article ids baseline clustering just wrote).
                return
            self.page_doc = self.load_page_xml(path_to_xml)
            if _PAGE_CACHE_ON:
                self._cache_key = key
                self._cache_mtime = os.path.getmtime(key)
                _PAGE_CACHE[key] = (self._cache_mtime, self)
        else:
            self.page_doc = self.create_page_xml_document(
                creator_name, img_filename, img_w or 0, img_h or 0)
        # repair a missing Metadata node (page.py:35-40)
        root = self.page_doc.getroot()
        local_names = [xmlio.localname(e.tag) for e in root]
        if C.METADATA not in local_names:
            self.create_metadata(creator_name, comments="Metadata entry was missing, added.")
        if not self.validate(self.page_doc):
            logger.debug("File given by %s is not a valid PAGE-XML file.", path_to_xml)
        # metadata/textlines are generation-tracked properties that derive
        # on first access — no eager snapshot here (the separator writer,
        # for one, never reads them, and deriving textlines walks the DOM)

    # ---------------- snapshot freshness ----------------
    # The reference keeps `metadata` / `textlines` as parse-time attributes
    # (page.py:27-47) and re-parses the file per consumer; under the scoped
    # parse cache the same instance serves several pipeline stages, so the
    # snapshots are generation-tracked: every mutating Page method bumps
    # `_dom_gen` and the properties re-derive only when stale.
    _dom_gen = 0   # class default; instances shadow on first bump

    def mark_dom_mutated(self) -> None:
        """Invalidate the textlines/metadata snapshots. Called by every
        mutating Page method; call it manually after editing DOM nodes
        directly (outside the Page API)."""
        self._dom_gen = self._dom_gen + 1

    @property
    def textlines(self) -> List[TextLine]:
        if getattr(self, "_textlines_gen", -1) != self._dom_gen:
            self._textlines_snap = self.get_textlines()
            self._textlines_gen = self._dom_gen
        return self._textlines_snap

    @textlines.setter
    def textlines(self, value) -> None:
        self._textlines_snap = value
        self._textlines_gen = self._dom_gen

    @property
    def metadata(self) -> "Metadata":
        if getattr(self, "_metadata_gen", -1) != self._dom_gen:
            self._metadata_snap = self.get_metadata()
            self._metadata_gen = self._dom_gen
        return self._metadata_snap

    @metadata.setter
    def metadata(self, value) -> None:
        self._metadata_snap = value
        self._metadata_gen = self._dom_gen

    # ---------------- validation ----------------
    # the 2013-07-15 XSD's Coords/Baseline points facet:
    # ([0-9]+,[0-9]+ )+([0-9]+,[0-9]+)  — >= 2 non-negative integer pairs
    _POINTS_RE = re.compile(r"^([0-9]+,[0-9]+ )+[0-9]+,[0-9]+$")
    # elements the XSD requires to carry a Coords child
    _NEEDS_COORDS = ("TextRegion", "SeparatorRegion", "ImageRegion",
                     "GraphicRegion", "TableRegion", "ChartRegion",
                     "TextLine", "Word", "Glyph")

    @classmethod
    def validate(cls, doc) -> bool:
        """Structural validation (see :meth:`validate_structural`): the
        port has no XSD validator."""
        return cls.validate_structural(doc)

    @classmethod
    def validate_structural(cls, doc) -> bool:
        """Structural counterpart of the PAGE XSD:
        PcGts root in the PAGE namespace; exactly one Page carrying image
        dimensions; one Metadata led by Creator/Created/LastChange;
        document-unique ids; Coords present on every region/line/word with
        an XSD-conforming points list (>= 2 comma-separated non-negative
        integer pairs)."""
        try:
            root = doc.getroot()
        except AttributeError:
            root = doc
        if xmlio.split_tag(root.tag) != (C.NS_PAGE_XML, "PcGts"):
            return False
        pages = root.findall(f"{{{C.NS_PAGE_XML}}}Page")
        if len(pages) != 1:
            return False
        page_nd = pages[0]
        if page_nd.get("imageWidth") is None or page_nd.get("imageHeight") is None:
            return False
        meta = root.findall(f"{{{C.NS_PAGE_XML}}}{C.METADATA}")
        if len(meta) != 1:
            return False
        names = [xmlio.localname(e.tag) for e in meta[0]]
        if names[:3] != [C.CREATOR_ELT, C.CREATED_ELT, C.LAST_CHANGE_ELT]:
            return False
        # duplicate ids: the XSD's xs:ID type enforces document uniqueness
        ids = [e.get("id") for e in root.iter() if "id" in e.attrib]
        if len(ids) != len(set(ids)):
            return False
        # required + well-formed Coords
        for name in cls._NEEDS_COORDS:
            for nd in root.iter(f"{{{C.NS_PAGE_XML}}}{name}"):
                coords = nd.find(f"{{{C.NS_PAGE_XML}}}Coords")
                if coords is None:
                    return False
        for coords in root.iter(f"{{{C.NS_PAGE_XML}}}Coords"):
            points = coords.get("points")
            if points is None or not cls._POINTS_RE.match(points):
                return False
        for bl in root.iter(f"{{{C.NS_PAGE_XML}}}Baseline"):
            points = bl.get("points")
            if points is None or not cls._POINTS_RE.match(points):
                return False
        return True

    # ---------------- XML helpers ----------------
    @classmethod
    def get_child_by_name(cls, elt, child_name):
        """All descendant elements with that local name in the PAGE namespace."""
        elt = _root_of(elt)
        return [nd for nd in elt.iter(_pc(child_name)) if nd is not elt]

    @classmethod
    def get_child_by_id(cls, elt, _id):
        elt = _root_of(elt)
        return [nd for nd in elt.iter()
                if nd.get("id") == _id and nd is not elt]

    def _parent_of(self, nd):
        """Parent of ``nd`` from the child-to-parent map, rebuilt when the
        map does not know ``nd`` or names a parent that no longer holds it
        (the DOM may be edited outside the Page API)."""
        if nd is self.page_doc.getroot():
            return None
        parents = getattr(self, "_parent_map", None)
        parent = parents.get(nd) if parents is not None else None
        if parent is None or not any(child is nd for child in parent):
            parents = {child: par for par in self.page_doc.getroot().iter()
                       for child in par}
            self._parent_map = parents
            parent = parents.get(nd)
        return parent

    def _ancestors(self, elt) -> list:
        """Ancestors of ``elt`` in document order (the root first)."""
        out = []
        nd = self._parent_of(elt)
        while nd is not None:
            out.append(nd)
            nd = self._parent_of(nd)
        return out[::-1]

    def get_ancestor_by_name(self, elt, name):
        return [nd for nd in self._ancestors(elt) if nd.tag == _pc(name)]

    def get_ancestor_by_id(self, elt, _id):
        return [nd for nd in self._ancestors(elt) if nd.get("id") == _id]

    @classmethod
    def create_page_xml_node(cls, node_name):
        return etree.Element(_pc(node_name))

    def remove_page_xml_node(self, nd) -> None:
        self._parent_of(nd).remove(nd)
        self.mark_dom_mutated()

    def insert_page_xml_node(self, parent_nd, node_name):
        node = self.create_page_xml_node(node_name)
        parent_nd.append(node)
        self.mark_dom_mutated()
        return node

    # ---------------- custom attribute ----------------
    parse_custom_attr = staticmethod(parse_custom_attr)

    def get_custom_attr(self, nd, attr_name, sub_attr_name=None):
        """First- or second-level lookup in the parsed custom attribute;
        raises KeyError if missing (page.py:241-254)."""
        c = nd.get(C.CUSTOM_ATTR)
        if c is None:
            return None
        ddic = parse_custom_attr(c)
        if sub_attr_name is None:
            return ddic[attr_name]
        return ddic[attr_name][sub_attr_name]

    def set_custom_attr_from_dict(self, nd, custom_dict):
        nd.set(C.CUSTOM_ATTR, format_custom_attr(custom_dict))
        self.mark_dom_mutated()
        return nd

    def set_custom_attr(self, nd, attr_name, sub_attr_name, val):
        ddic = parse_custom_attr(nd.get(C.CUSTOM_ATTR))
        ddic.setdefault(attr_name, {})[sub_attr_name] = str(val)
        nd.set(C.CUSTOM_ATTR, format_custom_attr(ddic))
        self.mark_dom_mutated()
        return val

    def remove_custom_attr(self, nd, attr_name, sub_attr_name):
        ddic = parse_custom_attr(nd.get(C.CUSTOM_ATTR))
        if attr_name in ddic and sub_attr_name in ddic[attr_name]:
            ddic[attr_name].pop(sub_attr_name)
            nd.set(C.CUSTOM_ATTR, format_custom_attr(ddic))
            self.mark_dom_mutated()
        else:
            logger.debug("Can't remove %s from %s.", sub_attr_name, attr_name)

    # ---------------- text / points ----------------
    @classmethod
    def get_text_equiv(cls, nd) -> str:
        text_equivs = nd.findall(_pc(C.TEXTEQUIV))
        if not text_equivs:
            return ""
        unicode_nd = next((u for u in text_equivs[-1].iter(_pc(C.UNICODE))
                           if u is not text_equivs[-1]), None)
        if unicode_nd is None:
            return ""
        return unicode_nd.text or ""

    @staticmethod
    def make_text(nd) -> str:
        return " ".join(nd.itertext())

    @staticmethod
    def get_point_list(data):
        """Point list from a @points string or a node carrying one
        (page.py:352-372); returns None on malformed coordinates."""
        if isinstance(data, str):
            s_points = data
        else:
            s_points = next((nd.attrib["points"] for nd in data.iter()
                             if "points" in nd.attrib), None)
            if s_points is None:
                return None
        try:
            return string_to_points(s_points)
        except PageXmlError:
            return None

    @staticmethod
    def set_points(nd, l_xy):
        s = " ".join("%d,%d" % (int(x), int(y)) for x, y in l_xy)
        if nd is not None:
            nd.set(C.POINTS_ATTR, s)
        return s

    # ---------------- metadata ----------------
    def _metadata_nd(self):
        l_nd = self.page_doc.getroot().findall(f"{{{C.NS_PAGE_XML}}}{C.METADATA}")
        if len(l_nd) != 1:
            raise ValueError(f"PAGE-XML should have exactly one {C.METADATA} node, found {len(l_nd)}")
        return l_nd[0]

    def get_metadata(self) -> Metadata:
        meta_nd = self._metadata_nd()
        by_name = {}
        for child in meta_nd:
            by_name.setdefault(xmlio.localname(child.tag), child)
        tk_nd = by_name.get(C.TRANSKRIBUS_METADATA_ELT)
        tk = None
        if tk_nd is not None:
            tk = TranskribusMetadata(**{k: tk_nd.get(k) for k in (
                "docId", "pageId", "pageNr", "tsid", "status", "userId",
                "imgUrl", "xmlUrl", "imageId")})
        comments_nd = by_name.get(C.COMMENTS_ELT)
        return Metadata(
            by_name[C.CREATOR_ELT].text if C.CREATOR_ELT in by_name else None,
            by_name[C.CREATED_ELT].text if C.CREATED_ELT in by_name else None,
            by_name[C.LAST_CHANGE_ELT].text if C.LAST_CHANGE_ELT in by_name else None,
            comments_nd.text if comments_nd is not None else None,
            tk,
        )

    def set_metadata(self, creator, comments=None) -> None:
        """Bump LastChange; update/create Comments if given (page.py:113-142)."""
        meta_nd = self._metadata_nd()
        by_name = {}
        for child in meta_nd:
            by_name.setdefault(xmlio.localname(child.tag), child)
        by_name[C.LAST_CHANGE_ELT].text = _utc_now()
        # only Metadata children change here — a fresh textlines snapshot
        # stays valid (every write_page_xml goes through set_metadata, so
        # without this each stage's save would force the next stage into a
        # full textline re-derivation)
        tl_fresh = (getattr(self, "_textlines_gen", -1) == self._dom_gen
                    and hasattr(self, "_textlines_snap"))
        self.mark_dom_mutated()
        if tl_fresh:
            self._textlines_gen = self._dom_gen
        if comments is not None:
            comments_nd = by_name.get(C.COMMENTS_ELT)
            if comments_nd is None:
                comments_nd = etree.SubElement(meta_nd, "{%s}%s" % (C.NS_PAGE_XML, C.COMMENTS_ELT))
            comments_nd.text = comments

    def create_metadata(self, creator_name=C.CREATOR, comments=None):
        root = self.page_doc.getroot()
        metadata = self.create_page_xml_node(C.METADATA)
        root.insert(0, metadata)
        for name, text in ((C.CREATOR_ELT, creator_name), (C.CREATED_ELT, _utc_now()),
                           (C.LAST_CHANGE_ELT, _utc_now())):
            nd = etree.SubElement(metadata, "{%s}%s" % (C.NS_PAGE_XML, name))
            nd.text = text
        if comments is not None:
            nd = etree.SubElement(metadata, "{%s}%s" % (C.NS_PAGE_XML, C.COMMENTS_ELT))
            nd.text = comments
        self.mark_dom_mutated()
        return metadata

    # ---------------- page-level accessors ----------------
    def get_image_resolution(self) -> Tuple[int, int]:
        page_nd = self.get_child_by_name(self.page_doc, "Page")[0]
        return int(page_nd.get("imageWidth")), int(page_nd.get("imageHeight"))

    def get_image_filename(self) -> Optional[str]:
        page_nd = self.get_child_by_name(self.page_doc, "Page")[0]
        return page_nd.get("imageFilename")

    def get_print_space_coords(self) -> List[Tuple[int, int]]:
        """PrintSpace rectangle coords, clamped at 0; image extent fallback
        (page.py:417-454)."""
        ps_nds = self.get_child_by_name(self.page_doc, C.PRINT_SPACE)
        if len(ps_nds) != 1:
            w, h = self.get_image_resolution()
            return [(0, 0), (w, 0), (w, h), (0, h)]
        coords_nd = self.get_child_by_name(ps_nds[0], C.COORDS)[0]
        ps_coords = self.get_point_list(coords_nd.get(C.POINTS_ATTR))
        ps_coords = [(max(0, x), max(0, y)) for x, y in ps_coords]
        if len(ps_coords) != 4:
            raise PageXmlError(
                f"Expected exactly four PrintSpace coordinates, got {len(ps_coords)}.")
        return ps_coords

    def get_ids(self) -> List[str]:
        return [e.attrib["id"] for e in self.page_doc.getroot().iter()
                if "id" in e.attrib]

    def get_unique_id(self, page_object_name: str) -> Optional[str]:
        existing = set(self.get_ids())
        for i in range(1, 1001):
            new_id = f"{page_object_name}_{i}"
            if new_id not in existing:
                return new_id
        return None

    # ---------------- regions ----------------
    def get_text_regions(self, text_region_type=None) -> List[TextRegion]:
        """All TextRegions (typeless ones count as 'paragraph'), optionally
        filtered by type (page.py:479-506)."""
        res = []
        for nd in self.get_child_by_name(self.page_doc, C.TEXTREGION):
            tr_type = nd.get("type") or C.TextRegionTypes.PARAGRAPH
            if text_region_type is not None and tr_type != text_region_type:
                continue
            coords = _trusted_points(self.get_point_list(
                self.get_child_by_name(nd, C.COORDS)[0].get(C.POINTS_ATTR)))
            res.append(TextRegion(
                nd.get("id"), parse_custom_attr(nd.get(C.CUSTOM_ATTR)), coords,
                self.get_textlines(nd), tr_type))
        return res

    def get_regions(self) -> Dict[str, list]:
        """All regions keyed by region name (page.py:528-550)."""
        res: Dict[str, list] = {}
        for r_name, r_class in REGIONS_DICT.items():
            if r_name == C.TEXTREGION:
                trs = self.get_text_regions()
                if trs:
                    res[r_name] = trs
                continue
            nds = self.get_child_by_name(self.page_doc, r_name)
            if nds:
                res[r_name] = [
                    r_class(
                        nd.get("id"), parse_custom_attr(nd.get(C.CUSTOM_ATTR)),
                        _trusted_points(self.get_point_list(
                            self.get_child_by_name(nd, C.COORDS)[0].get(C.POINTS_ATTR))))
                    for nd in nds]
        return res

    def remove_regions(self, region_type: str) -> None:
        if region_type not in REGIONS_DICT:
            logger.info("There is no region with type %s, skipping.", region_type)
            return
        for nd in self.get_child_by_name(self.page_doc, region_type):
            self.remove_page_xml_node(nd)

    def add_region(self, region, overwrite=False) -> None:
        """Append a region; same-id handling per page.py:653-680."""
        page_nd = self.get_child_by_name(self.page_doc, "Page")[0]
        existing = self.get_child_by_id(page_nd, region.id)
        if existing:
            if not overwrite:
                logger.debug("Region %s already exists, skipping.", region.id)
                return
            for nd in existing:
                self.remove_page_xml_node(nd)
        page_nd.append(region.to_page_xml_node())
        self.mark_dom_mutated()

    def set_text_regions(self, text_regions, overwrite=False) -> None:
        if overwrite:
            for nd in self.get_child_by_name(self.page_doc, C.TEXTREGION):
                self.remove_page_xml_node(nd)
        page_nd = self.get_child_by_name(self.page_doc, "Page")[0]
        for tr in text_regions:
            page_nd.append(tr.to_page_xml_node())
        self.mark_dom_mutated()

    # ---------------- text lines / words ----------------
    def get_textlines(self, text_region_nd=None, ignore_redundant_textlines=True) -> List[TextLine]:
        base = text_region_nd if text_region_nd is not None else self.page_doc
        res = []
        seen = set()
        for nd in self.get_child_by_name(base, C.TEXTLINE):
            tl_id = nd.get("id")
            if tl_id in seen and ignore_redundant_textlines:
                continue
            seen.add(tl_id)
            bl_nds = self.get_child_by_name(nd, C.BASELINE)
            res.append(TextLine(
                tl_id,
                parse_custom_attr(nd.get(C.CUSTOM_ATTR)),
                self.get_text_equiv(nd),
                _trusted_points(self.get_point_list(bl_nds[0])) if bl_nds else None,
                _trusted_points(self.get_point_list(nd)),
                self.get_words(nd),
            ))
        return res

    def get_words(self, text_line_nd=None, ignore_redundant_words=True) -> List[Word]:
        base = text_line_nd if text_line_nd is not None else self.page_doc
        res = []
        seen = set()
        for nd in self.get_child_by_name(base, C.WORD):
            w_id = nd.get("id")
            if w_id in seen and ignore_redundant_words:
                continue
            seen.add(w_id)
            res.append(Word(
                w_id, parse_custom_attr(nd.get(C.CUSTOM_ATTR)),
                self.get_text_equiv(nd), _trusted_points(self.get_point_list(nd))))
        return res

    def update_textlines(self) -> None:
        self.textlines = self.get_textlines()

    def set_textline_attr(self, textlines) -> None:
        """Write each TextLine object's custom dict back to its DOM node.

        When every written object is a member of the live ``textlines``
        snapshot (the pipeline's usual case: mutate snapshot objects, then
        persist), the snapshot still mirrors the DOM afterwards — only
        ``tl.custom`` was copied over — so it stays valid and the next
        stage skips a full re-derivation.
        """
        snap_fresh = (getattr(self, "_textlines_gen", -1) == self._dom_gen
                      and hasattr(self, "_textlines_snap"))
        snap_ids = ({id(tl) for tl in self._textlines_snap}
                    if snap_fresh else ())
        wrote_snapshot_members = snap_fresh
        by_id = {nd.get("id"): nd
                 for nd in self.get_child_by_name(self.page_doc, C.TEXTLINE)}
        for tl in textlines:
            nd = by_id.get(tl.id)
            if nd is None:
                logger.warning("TextLine %s not found in document.", tl.id)
                continue
            self.set_custom_attr_from_dict(nd, tl.custom)
            if wrote_snapshot_members and id(tl) not in snap_ids:
                wrote_snapshot_members = False
        if wrote_snapshot_members:
            self._textlines_gen = self._dom_gen

    def set_text_lines(self, text_region, text_lines, overwrite=False) -> None:
        """Replace/append the text lines of one region and refresh the
        region-level TextEquiv (page.py:702-751)."""
        if isinstance(text_region, TextRegion):
            text_region_nd = self.get_child_by_id(self.page_doc, text_region.id)[0]
        else:
            text_region_nd = text_region

        if overwrite:
            for nd in self.get_child_by_name(text_region_nd, C.TEXTLINE):
                self.remove_page_xml_node(nd)

        existing = self.get_child_by_name(text_region_nd, C.TEXTLINE)
        idx = list(text_region_nd).index(existing[0]) if existing else 0
        texts = []
        for tl in text_lines:
            tl_nd = tl.to_page_xml_node()
            if tl_nd is None:
                continue
            text_region_nd.insert(idx, tl_nd)
            idx += 1
            texts.append(tl.text)

        region_text = "\n".join(texts)
        unicode_nds = text_region_nd.findall(
            "%s/%s" % (_pc(C.TEXTEQUIV), _pc(C.UNICODE)))
        if unicode_nds:
            unicode_nds[-1].text = region_text
        else:
            text_equiv_nd = etree.SubElement(
                text_region_nd, "{%s}%s" % (C.NS_PAGE_XML, C.TEXTEQUIV))
            unicode_nd = etree.SubElement(
                text_equiv_nd, "{%s}%s" % (C.NS_PAGE_XML, C.UNICODE))
            unicode_nd.text = region_text
        self.mark_dom_mutated()

    # ---------------- articles ----------------
    def get_article_dict(self) -> Dict[Optional[str], List[TextLine]]:
        article_dict: Dict[Optional[str], List[TextLine]] = {}
        for tl in self.textlines:
            article_dict.setdefault(tl.get_article_id(), []).append(tl)
        return article_dict

    # ---------------- IO ----------------
    def create_page_xml_document(self, creator_name=C.CREATOR, filename=None, img_w=0, img_h=0):
        root = etree.Element(
            "{%s}PcGts" % C.NS_PAGE_XML,
            attrib={"{%s}schemaLocation" % C.NS_XSI: C.XSI_LOCATION})
        metadata = etree.SubElement(root, "{%s}%s" % (C.NS_PAGE_XML, C.METADATA))
        for name, text in ((C.CREATOR_ELT, creator_name), (C.CREATED_ELT, _utc_now()),
                           (C.LAST_CHANGE_ELT, _utc_now())):
            nd = etree.SubElement(metadata, "{%s}%s" % (C.NS_PAGE_XML, name))
            nd.text = text
        page_node = etree.SubElement(root, "{%s}Page" % C.NS_PAGE_XML)
        page_node.set("imageFilename", filename if filename is not None else "")
        page_node.set("imageWidth", str(img_w))
        page_node.set("imageHeight", str(img_h))
        return xmlio.Document(
            root, {root: [(None, C.NS_PAGE_XML), ("xsi", C.NS_XSI)]})

    def load_page_xml(self, path_to_xml):
        return xmlio.parse(path_to_xml)

    def write_page_xml(self, save_path, creator=C.CREATOR, comments=None) -> None:
        self.set_metadata(creator, comments)
        parent = os.path.dirname(save_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(save_path, "w", encoding="utf-8") as f:
            f.write(xmlio.tostring(self.page_doc))
        if _PAGE_CACHE_ON:
            # DOM == file right after a write: keep this instance live for
            # the next stage's load of the same path
            key = os.path.abspath(save_path)
            old_key = getattr(self, "_cache_key", None)
            if old_key is not None and old_key != key:
                # rebinding this instance to a new path: drop the stale entry
                # so a later Page(old_path) re-parses the (unchanged) file
                # instead of returning this now-mutated DOM
                _PAGE_CACHE.pop(old_key, None)
            self._cache_key = key
            self._cache_mtime = os.path.getmtime(key)
            _PAGE_CACHE[key] = (self._cache_mtime, self)
