"""In-memory PAGE-XML objects: Points, Region hierarchy, TextLine, Word (port
copy of ``citlab_as_tpu/pagexml/objects.py`` on ``xml.etree.ElementTree``).

Serialization behavior mirrors python_util/parser/xml/page/page_objects.py
(e.g. TextLines without a surrounding polygon serialize to None and are
dropped; region text is the newline-join of its line texts).
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import xml.etree.ElementTree as etree

from citlab_as_tpu_torch.geometry.polygon import Polygon
from citlab_as_tpu_torch.pagexml import constants as C

logger = logging.getLogger(__name__)


class PageXmlError(Exception):
    pass


# -- custom attribute CSS-ish syntax ----------------------------------------

_CUSTOM_RULE_RE = re.compile(r"([^\s{}]+)\s*\{([^}]*)\}")
_CUSTOM_PROP_RE = re.compile(r"([^:;\s]+)\s*:\s*([^;]*?)\s*(?:;|$)")


def parse_custom_attr(s: Optional[str]) -> Dict[str, Dict[str, str]]:
    """Parse ``"readingOrder {index:4;} structure {type:catch-word;}"`` into
    ``{'readingOrder': {'index': '4'}, 'structure': {'type': 'catch-word'}}``.

    Same semantics as page.py:299-320 (cssutils there), implemented with a
    regex since the grammar is flat selector { prop:value; ... } rules.
    """
    if not s:
        return {}
    out: Dict[str, Dict[str, str]] = {}
    for sel, body in _CUSTOM_RULE_RE.findall(s):
        props: Dict[str, str] = {}
        for name, value in _CUSTOM_PROP_RE.findall(body):
            props[name] = value.strip()
        out[sel] = props
    return out


def format_custom_attr(ddic: Dict[str, Dict[str, str]]) -> str:
    """Inverse of :func:`parse_custom_attr` (page_util.py:5-22):
    ``"readingOrder {index:1;} structure {type:heading;}"``."""
    parts = []
    for k1, d2 in ddic.items():
        body = " ".join(f"{k2}:{v2};" for k2, v2 in d2.items())
        parts.append(f"{k1} {{{body}}}")
    return " ".join(parts)


def _pc(name: str) -> str:
    return "{%s}%s" % (C.NS_PAGE_XML, name)


def _append_text_equiv(nd, text: str) -> None:
    text_equiv_nd = etree.SubElement(nd, _pc(C.TEXTEQUIV))
    unicode_nd = etree.SubElement(text_equiv_nd, _pc(C.UNICODE))
    unicode_nd.text = text


# -- Points -----------------------------------------------------------------

class Points:
    """Coordinate list with the PAGE string form ``"x1,y1 x2,y2 ..."``
    (page_objects.py:55-81)."""

    def __init__(self, points_list: Sequence[Tuple[int, int]]):
        if isinstance(points_list, Points):
            # share the (immutable-by-convention) list: Points(points) is a
            # no-conversion pass-through for already-wrapped coordinates
            self.points_list = points_list.points_list
            return
        self.points_list: List[Tuple[int, int]] = [
            (int(x), int(y)) for x, y in points_list]

    @classmethod
    def _trusted(cls, parsed: List[Tuple[int, int]]) -> "Points":
        """Wrap a parser-produced ``[(int, int), ...]`` without the int()
        re-conversion pass (string_to_points already yields exact ints —
        the double conversion cost ~8k calls/page-group in the pipeline)."""
        obj = cls.__new__(cls)
        obj.points_list = parsed
        return obj

    @classmethod
    def from_string(cls, s: str) -> "Points":
        return cls._trusted(string_to_points(s))

    def to_string(self) -> str:
        return " ".join(f"{x},{y}" for x, y in self.points_list)

    def to_polygon(self) -> Polygon:
        return Polygon.from_points(self.points_list)

    def __len__(self):
        return len(self.points_list)

    def __iter__(self):
        return iter(self.points_list)


def string_to_points(s: str) -> List[Tuple[int, int]]:
    """``"0,0 1,2 3,4"`` -> [(0,0), (1,2), (3,4)] (page_objects.py:32-52).
    Raises PageXmlError on malformed pairs instead of exiting."""
    out = []
    for pair in s.split(" "):
        if not pair:
            continue
        try:
            sx, _, sy = pair.partition(",")
            out.append((int(sx), int(sy)))
        except ValueError as e:
            raise PageXmlError(f"Can't convert string '{pair}' to a point.") from e
    return out


def polygon_to_points(polygon: Polygon) -> Points:
    return Points(list(zip(polygon.x_points, polygon.y_points)))


# -- Regions ----------------------------------------------------------------

class Region:
    """Base PAGE region (page_objects.py:84-155)."""

    node_string: str = ""

    def __init__(self, _id, custom=None, points=None):
        if _id is None:
            raise PageXmlError("Every Region must have a unique id.")
        if points is None:
            raise PageXmlError("Every Region must have coordinates.")
        self.id = _id
        self.points = Points(points)
        self.custom = custom if custom is not None else {}

    def set_points(self, points) -> None:
        self.points = Points(points)

    def to_page_xml_node(self):
        nd = etree.Element(_pc(self.node_string))
        nd.set("id", str(self.id))
        if self.custom:
            nd.set(C.CUSTOM_ATTR, format_custom_attr(self.custom))
        coords_nd = etree.SubElement(nd, _pc(C.COORDS))
        coords_nd.set(C.POINTS_ATTR, self.points.to_string())
        return nd

    def get_reading_order(self):
        try:
            return self.custom["readingOrder"]["index"]
        except KeyError:
            return None

    def set_reading_order(self, reading_order) -> None:
        if reading_order:
            self.custom.setdefault("readingOrder", {})["index"] = str(reading_order)
        else:
            self.custom.pop("readingOrder", None)


class TextRegion(Region):
    node_string = C.TEXTREGION

    def __init__(self, _id, custom=None, points=None, text_lines=None,
                 region_type: str = C.TextRegionTypes.PARAGRAPH):
        super().__init__(_id, custom, points)
        self.text_lines: List[TextLine] = text_lines if text_lines is not None else []
        self.region_type = region_type

    def to_page_xml_node(self):
        nd = super().to_page_xml_node()
        nd.set("type", self.region_type)
        texts = []
        for text_line in self.text_lines:
            tl_nd = text_line.to_page_xml_node()
            if tl_nd is not None:
                nd.append(tl_nd)
                texts.append(text_line.text)
        region_text = "\n".join(t for t in texts if t)
        if region_text:
            _append_text_equiv(nd, region_text)
        return nd


class SeparatorRegion(Region):
    node_string = C.SEPARATORREGION

    def get_orientation(self) -> Optional[str]:
        try:
            return self.custom["structure"]["orientation"]
        except KeyError:
            return None


class ImageRegion(Region):
    node_string = C.IMAGEREGION


class LineDrawingRegion(Region):
    node_string = C.LINEDRAWINGREGION


class GraphicRegion(Region):
    node_string = C.GRAPHICREGION


class TableRegion(Region):
    node_string = C.TABLEREGION


class ChartRegion(Region):
    node_string = C.CHARTREGION


class MathsRegion(Region):
    node_string = C.MATHSREGION


class ChemRegion(Region):
    node_string = C.CHEMREGION


class MusicRegion(Region):
    node_string = C.MUSICREGION


class AdvertRegion(Region):
    node_string = C.ADVERTREGION


class NoiseRegion(Region):
    node_string = C.NOISEREGION


class UnknownRegion(Region):
    node_string = C.UNKNOWNREGION


REGIONS_DICT = {
    C.TEXTREGION: TextRegion,
    C.IMAGEREGION: ImageRegion,
    C.LINEDRAWINGREGION: LineDrawingRegion,
    C.GRAPHICREGION: GraphicRegion,
    C.TABLEREGION: TableRegion,
    C.CHARTREGION: ChartRegion,
    C.SEPARATORREGION: SeparatorRegion,
    C.MATHSREGION: MathsRegion,
    C.CHEMREGION: ChemRegion,
    C.MUSICREGION: MusicRegion,
    C.ADVERTREGION: AdvertRegion,
    C.NOISEREGION: NoiseRegion,
    C.UNKNOWNREGION: UnknownRegion,
}


# -- TextLine / Word --------------------------------------------------------

class TextLine:
    """PAGE text line: id, custom dict-of-dicts, text, baseline + surrounding
    polygon, words (page_objects.py:300-459)."""

    def __init__(self, _id, custom=None, text=None, baseline=None, surr_p=None, words=None):
        if _id is None:
            raise PageXmlError("Every TextLine must have a unique id.")
        self.id = _id
        self.custom: Dict[str, Dict[str, str]] = custom if custom is not None else {}
        self.baseline = Points(baseline) if baseline is not None else None
        self.text = text if text is not None else ""
        self.surr_p = Points(surr_p) if surr_p is not None else None
        self.words: List[Word] = words if words is not None else []

    def to_page_xml_node(self):
        if not self.surr_p:
            logger.warning(
                "Can't convert TextLine to PAGE-XML node: no surrounding polygon (%s).", self.id)
            return None
        nd = etree.Element(_pc(C.TEXTLINE))
        nd.set("id", str(self.id))
        if self.custom:
            nd.set(C.CUSTOM_ATTR, format_custom_attr(self.custom))
        coords_nd = etree.SubElement(nd, _pc(C.COORDS))
        coords_nd.set(C.POINTS_ATTR, self.surr_p.to_string())
        if self.baseline:
            bl_nd = etree.SubElement(nd, _pc(C.BASELINE))
            bl_nd.set(C.POINTS_ATTR, self.baseline.to_string())
        for word in self.words:
            word_nd = word.to_page_xml_node()
            if word_nd is not None:
                nd.append(word_nd)
        if self.text is not None:
            _append_text_equiv(nd, self.text)
        return nd

    def set_points(self, points) -> None:
        self.surr_p = Points(points)

    def set_baseline(self, baseline) -> None:
        self.baseline = Points(baseline) if baseline is not None else None

    def get_reading_order(self):
        try:
            return self.custom["readingOrder"]["index"]
        except KeyError:
            return None

    def set_reading_order(self, reading_order) -> None:
        if reading_order:
            self.custom.setdefault("readingOrder", {})["index"] = str(reading_order)
        else:
            self.custom.pop("readingOrder", None)

    def get_article_id(self) -> Optional[str]:
        """Article id iff structure type is 'article' (page_objects.py:380-388)."""
        try:
            return self.custom["structure"]["id"] if self.custom["structure"]["type"] == "article" else None
        except KeyError:
            return None

    def set_article_id(self, article_id=None) -> None:
        if article_id:
            struct = self.custom.setdefault("structure", {})
            struct["id"] = str(article_id)
            struct["type"] = "article"
        else:
            struct = self.custom.get("structure")
            if struct is not None:
                struct.pop("id", None)
                if not struct:
                    self.custom.pop("structure")

    def get_semantic_type(self) -> Optional[str]:
        try:
            return self.custom["structure"]["semantic_type"]
        except KeyError:
            return None

    def set_structure_attribute(self, attribute_name, attribute) -> None:
        self.custom.setdefault("structure", {})[attribute_name] = str(attribute)


class Word:
    """PAGE word: id, custom, text, surrounding polygon (page_objects.py:462-540)."""

    def __init__(self, _id, custom=None, text=None, surr_p=None):
        if _id is None:
            raise PageXmlError("Every Word must have a unique id.")
        self.id = _id
        self.custom: Dict[str, Dict[str, str]] = custom if custom is not None else {}
        self.text = text if text is not None else ""
        self.surr_p = Points(surr_p) if surr_p is not None else None

    def to_page_xml_node(self):
        if not self.surr_p:
            logger.warning(
                "Can't convert Word to PAGE-XML node: no surrounding polygon (%s).", self.id)
            return None
        nd = etree.Element(_pc(C.WORD))
        nd.set("id", str(self.id))
        if self.custom:
            nd.set(C.CUSTOM_ATTR, format_custom_attr(self.custom))
        coords_nd = etree.SubElement(nd, _pc(C.COORDS))
        coords_nd.set(C.POINTS_ATTR, self.surr_p.to_string())
        if self.text is not None:
            _append_text_equiv(nd, self.text)
        return nd

    def set_points(self, points) -> None:
        self.surr_p = Points(points)

    def get_reading_order(self):
        try:
            return self.custom["readingOrder"]["index"]
        except KeyError:
            return None

    def set_reading_order(self, reading_order) -> None:
        if reading_order:
            self.custom.setdefault("readingOrder", {})["index"] = str(reading_order)
        else:
            self.custom.pop("readingOrder", None)
