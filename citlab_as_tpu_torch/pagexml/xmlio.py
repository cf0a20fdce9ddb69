"""XML parsing and serialization for PAGE-XML on ``xml.etree.ElementTree``.

The JAX package reads and writes PAGE-XML with lxml. This module gives the
port the same bytes from the standard library:

- :func:`parse` drops ignorable blank text the way libxml2 does under
  ``remove_blank_text=True``, keeps comments and PI nodes
  (those outside the root element too) and remembers where each namespace
  prefix was declared, which ElementTree forgets;
- :func:`tostring` is libxml2's pretty printer: two spaces per level, no
  reformatting inside an element that holds text, ``<a/>`` for an empty
  element, lxml's single-quoted declaration with ``standalone='yes'``, and
  libxml2's escaping tables for text and attribute values.

A :class:`Document` stands in for ``lxml.etree._ElementTree``.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from xml.parsers import expat
from typing import Dict, List, Optional, Tuple

XML_NS = "http://www.w3.org/XML/1998/namespace"
_BLANKS = " \t\r\n"
# bracket a CDATA section in parsed text until the blank rule has run:
# U+FFFE and U+FFFF cannot occur in an XML document
_CDATA_START, _CDATA_END = "\ufffe", "\uffff"

NsDecl = Tuple[Optional[str], str]          # (prefix or None, uri)


class Document:
    """A parsed or created XML document: the root element, the namespace
    declarations of each element that carries any, and the comments and
    PI nodes (``<?target data?>``) before and after the root."""

    def __init__(self, root: ET.Element,
                 nsdecls: Optional[Dict[ET.Element, List[NsDecl]]] = None,
                 prolog: Optional[list] = None, epilog: Optional[list] = None):
        self.root = root
        self.nsdecls = nsdecls if nsdecls is not None else {}
        self.prolog = prolog if prolog is not None else []
        self.epilog = epilog if epilog is not None else []

    def getroot(self) -> ET.Element:
        return self.root


def split_tag(tag) -> Tuple[Optional[str], str]:
    """``{uri}local`` -> (uri, local); a bare name has namespace None.
    Comments and PI nodes (whose tag is a function) give
    (None, "")."""
    if not isinstance(tag, str):
        return None, ""
    if tag[:1] == "{":
        uri, _, local = tag[1:].partition("}")
        return uri, local
    return None, tag


def localname(tag) -> str:
    return split_tag(tag)[1]


def _is_blank(s: Optional[str]) -> bool:
    return s is not None and not s.strip(_BLANKS)


def _strip_blanks(root: ET.Element) -> None:
    """libxml2's blank-node rule (``areBlanks``) applied after the fact.
    A run of character data that is all whitespace and ends at a tag or at
    a CDATA section is dropped, unless one of these holds: the element is
    under ``xml:space="preserve"``; the run is the whole content of the
    element; character data of this element was kept before it; the node
    before it is text (a CDATA section); the element's first node is text."""
    stack = [(root, False)]
    while stack:
        nd, preserve = stack.pop()
        space = nd.get("{%s}space" % XML_NS)
        if space == "preserve":
            preserve = True
        elif space == "default":
            preserve = False
        children = list(nd)
        chars_seen = first_is_text = last_is_text = False

        def kept(slot, is_first, only):
            nonlocal chars_seen, first_is_text, last_is_text
            if slot is None:
                last_is_text = False
                return None
            out = []
            for i, piece in enumerate(slot.replace(_CDATA_END, _CDATA_START)
                                      .split(_CDATA_START)):
                if not piece:
                    continue
                if i % 2:                               # inside a CDATA section
                    out.append(piece)
                elif (preserve or chars_seen or last_is_text or first_is_text
                      or not _is_blank(piece) or (only and piece == slot)):
                    out.append(piece)
                    chars_seen = True
                else:
                    continue
                if is_first and len(out) == 1:
                    first_is_text = True
                last_is_text = True
            last_is_text = False                        # a child or the end tag follows
            return "".join(out) or None

        nd.text = kept(nd.text, True, not children)
        for child in children:
            child.tail = kept(child.tail, False, False)
            if isinstance(child.tag, str):
                stack.append((child, preserve))


def parse(path) -> Document:
    """Parse a file into a :class:`Document` (blank text removed, comments
    and PI nodes kept). Drives expat directly: ElementTree's
    own parser reports neither where a prefix was declared nor where a
    CDATA section starts."""
    tree = ET.TreeBuilder(insert_comments=True, insert_pis=True)
    parser = expat.ParserCreate(namespace_separator="}")
    parser.buffer_text = True
    parser.ordered_attributes = True
    nsdecls: Dict[ET.Element, List[NsDecl]] = {}
    prolog, epilog, pending = [], [], []
    names: Dict[str, str] = {}
    state = {"depth": 0, "root": None}

    def fixname(name: str) -> str:
        try:
            return names[name]
        except KeyError:
            names[name] = fixed = "{" + name if "}" in name else name
            return fixed

    def start(name, attrs):
        elem = tree.start(fixname(name), {
            fixname(attrs[i]): attrs[i + 1] for i in range(0, len(attrs), 2)})
        if pending:
            nsdecls[elem] = list(pending)
            pending.clear()
        if state["root"] is None:
            state["root"] = elem
        state["depth"] += 1

    def end(name):
        tree.end(fixname(name))
        state["depth"] -= 1

    def outside_root(node):
        if state["depth"] == 0:
            (prolog if state["root"] is None else epilog).append(node)

    parser.StartElementHandler = start
    parser.EndElementHandler = end
    parser.CharacterDataHandler = tree.data
    parser.StartNamespaceDeclHandler = (
        lambda prefix, uri: pending.append((prefix or None, uri)))
    parser.StartCdataSectionHandler = lambda: tree.data(_CDATA_START)
    parser.EndCdataSectionHandler = lambda: tree.data(_CDATA_END)
    parser.CommentHandler = lambda text: outside_root(tree.comment(text))
    parser.ProcessingInstructionHandler = (
        lambda target, text: outside_root(tree.pi(target, text)))
    try:
        with open(str(path), "rb") as f:
            parser.ParseFile(f)
    except expat.ExpatError as e:
        raise ET.ParseError(f"{path}: {e}") from e
    if state["root"] is None:
        raise ET.ParseError(f"no root element in {path}")
    tree.close()
    _strip_blanks(state["root"])
    return Document(state["root"], nsdecls, prolog, epilog)


# ---------------------------------------------------------------- writing

def _escape_text(s: str) -> str:
    if "&" in s:
        s = s.replace("&", "&amp;")
    if "<" in s:
        s = s.replace("<", "&lt;")
    if ">" in s:
        s = s.replace(">", "&gt;")
    if "\r" in s:
        s = s.replace("\r", "&#13;")
    return s


def _escape_attr(s: str) -> str:
    s = _escape_text(s)
    if '"' in s:
        s = s.replace('"', "&quot;")
    if "\n" in s:
        s = s.replace("\n", "&#10;")
    if "\t" in s:
        s = s.replace("\t", "&#9;")
    return s


def _special(node: ET.Element) -> Optional[str]:
    if node.tag is ET.Comment:
        return "<!--%s-->" % (node.text or "")
    if node.tag is ET.ProcessingInstruction:
        return "<?%s?>" % (node.text or "")
    return None


def _has_text_child(node: ET.Element) -> bool:
    if node.text is not None:
        return True
    return any(child.tail is not None for child in node)


class _Writer:
    def __init__(self, doc: Document):
        self.doc = doc
        self.out: List[str] = []

    @staticmethod
    def _prefix_for(uri: str, scope: Dict[Optional[str], str],
                    for_attr: bool):
        """An in-scope prefix bound to ``uri`` (the default namespace only
        for element names), or ``KeyError``."""
        if uri == XML_NS:
            return "xml"
        if not for_attr and scope.get(None) == uri:
            return None
        for prefix, bound in scope.items():
            if bound == uri and prefix is not None:
                return prefix
        raise KeyError(uri)

    @staticmethod
    def _new_prefix(scope) -> str:
        i = 0
        while "ns%d" % i in scope:
            i += 1
        return "ns%d" % i

    def _qname(self, tag: str, scope, decls: List[NsDecl], for_attr: bool):
        """Serialized name of ``tag`` and the scope it was resolved in: a
        namespace with no prefix in scope gets a new ``ns<i>`` declared on
        this element, in a copy of the scope."""
        uri, local = split_tag(tag)
        if uri is None:
            return local, scope
        try:
            prefix = self._prefix_for(uri, scope, for_attr)
        except KeyError:
            prefix = self._new_prefix(scope)
            scope = dict(scope)
            scope[prefix] = uri
            decls.append((prefix, uri))
        return (local if prefix is None else "%s:%s" % (prefix, local)), scope

    def node(self, node: ET.Element, level: int, fmt: bool,
             scope: Dict[Optional[str], str]) -> None:
        out = self.out
        special = _special(node)
        if special is not None:
            out.append(special)
            return
        own = self.doc.nsdecls.get(node)
        decls: List[NsDecl] = list(own) if own else []
        if decls:
            scope = dict(scope)
            scope.update(decls)
        name, scope = self._qname(node.tag, scope, decls, for_attr=False)
        attrs = []
        for k, v in node.attrib.items():
            k, scope = self._qname(k, scope, decls, for_attr=True)
            attrs.append((k, v))
        out.append("<" + name)
        for prefix, uri in decls:
            out.append(' xmlns%s="%s"' % ("" if prefix is None else ":" + prefix,
                                          _escape_attr(uri)))
        for k, v in attrs:
            out.append(' %s="%s"' % (k, _escape_attr(v)))
        children = list(node)
        if node.text is None and not children:
            out.append("/>")
            return
        out.append(">")
        if fmt and _has_text_child(node):
            fmt = False
        if node.text is not None:
            out.append(_escape_text(node.text))
        if fmt:
            out.append("\n")
        indent = "  " * (level + 1)
        for child in children:
            if fmt:
                out.append(indent)
            self.node(child, level + 1, fmt, scope)
            if fmt:
                out.append("\n")
            if child.tail is not None:
                out.append(_escape_text(child.tail))
        if fmt:
            out.append("  " * level)
        out.append("</%s>" % name)


def tostring(doc: Document) -> str:
    """The document as lxml writes it with ``pretty_print=True,
    encoding="UTF-8", standalone=True, xml_declaration=True`` (decoded)."""
    w = _Writer(doc)
    w.out.append("<?xml version='1.0' encoding='UTF-8' standalone='yes'?>\n")
    for nd in doc.prolog:
        w.out.append(_special(nd))
        w.out.append("\n")
    w.node(doc.root, 0, True, {})
    for nd in doc.epilog:
        w.out.append("\n")
        w.out.append(_special(nd))
    w.out.append("\n")
    return "".join(w.out)
