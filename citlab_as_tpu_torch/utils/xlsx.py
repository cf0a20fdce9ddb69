"""Minimal XLSX writer (port copy of ``citlab_as_tpu/utils/xlsx.py``; the
reference exports its reports with openpyxl).

XLSX is a zip of XML parts; this writes just what the AS tournament reports
need: multiple sheets, inline strings/numbers, bold + colored fonts,
horizontal alignment, a number format, column widths. API shape loosely
follows openpyxl (cell(row, column), column width dict) so the report code
reads naturally.
"""
from __future__ import annotations

import zipfile
from typing import Dict, List, Optional, Tuple
from xml.sax.saxutils import escape


class Font:
    def __init__(self, bold: bool = False, color: Optional[str] = None):
        self.bold = bold
        self.color = color

    def _key(self):
        return (self.bold, self.color)


class Cell:
    def __init__(self):
        self.value = None
        self.font: Optional[Font] = None
        self.number_format: Optional[str] = None
        self.align: Optional[str] = None


class Worksheet:
    def __init__(self, title: str):
        self.title = title
        self._cells: Dict[Tuple[int, int], Cell] = {}
        self.column_widths: Dict[int, float] = {}

    def cell(self, row: int, column: int) -> Cell:
        key = (row, column)
        if key not in self._cells:
            self._cells[key] = Cell()
        return self._cells[key]

    def set(self, row: int, column: int, value, bold=False, color=None,
            number_format=None, align=None) -> Cell:
        c = self.cell(row, column)
        c.value = value
        if bold or color:
            c.font = Font(bold=bold, color=color)
        c.number_format = number_format
        c.align = align
        return c

    def set_column_width(self, column: int, width: float) -> None:
        self.column_widths[column] = width

    @property
    def max_row(self):
        return max((r for r, _ in self._cells), default=0)

    @property
    def max_column(self):
        return max((c for _, c in self._cells), default=0)


def _col_letter(col: int) -> str:
    out = ""
    while col > 0:
        col, rem = divmod(col - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


class Workbook:
    def __init__(self):
        self.sheets: List[Worksheet] = []

    def create_sheet(self, title: str, index: Optional[int] = None) -> Worksheet:
        ws = Worksheet(title)
        if index is None:
            self.sheets.append(ws)
        else:
            self.sheets.insert(index, ws)
        return ws

    def get_sheet(self, title: str) -> Optional[Worksheet]:
        for ws in self.sheets:
            if ws.title == title:
                return ws
        return None

    # ------------------------------------------------------------------
    def _collect_styles(self):
        fonts = [Font()._key()]
        formats = []
        for ws in self.sheets:
            for c in ws._cells.values():
                if c.font is not None and c.font._key() not in fonts:
                    fonts.append(c.font._key())
                if c.number_format and c.number_format not in formats:
                    formats.append(c.number_format)
        return fonts, formats

    def _styles_xml(self, fonts, formats) -> str:
        num_fmts = "".join(
            f'<numFmt numFmtId="{164 + i}" formatCode="{escape(f)}"/>'
            for i, f in enumerate(formats))
        font_xml = []
        for bold, color in fonts:
            parts = ["<sz val=\"11\"/>"]
            if bold:
                parts.append("<b/>")
            if color:
                parts.append(f'<color rgb="FF{color}"/>')
            font_xml.append("<font>" + "".join(parts) + "</font>")
        # cellXfs: one xf per (font, numfmt, align) combination, built lazily
        xfs = ['<xf numFmtId="0" fontId="0" applyFont="1"/>']
        self._xf_index: Dict[tuple, int] = {(0, None, None): 0}
        for ws in self.sheets:
            for c in ws._cells.values():
                font_id = fonts.index(c.font._key()) if c.font else 0
                fmt_id = 164 + formats.index(c.number_format) if c.number_format else None
                key = (font_id, fmt_id, c.align)
                if key not in self._xf_index:
                    self._xf_index[key] = len(xfs)
                    attrs = [f'fontId="{font_id}"', 'applyFont="1"']
                    if fmt_id is not None:
                        attrs.append(f'numFmtId="{fmt_id}" applyNumberFormat="1"')
                    else:
                        attrs.append('numFmtId="0"')
                    align = (f'<alignment horizontal="{c.align}"/>' if c.align else "")
                    if align:
                        attrs.append('applyAlignment="1"')
                    xfs.append(f"<xf {' '.join(attrs)}>{align}</xf>")
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
            + (f'<numFmts count="{len(formats)}">{num_fmts}</numFmts>' if formats else "")
            + f'<fonts count="{len(font_xml)}">{"".join(font_xml)}</fonts>'
            '<fills count="1"><fill><patternFill patternType="none"/></fill></fills>'
            '<borders count="1"><border/></borders>'
            '<cellStyleXfs count="1"><xf/></cellStyleXfs>'
            f'<cellXfs count="{len(xfs)}">{"".join(xfs)}</cellXfs>'
            "</styleSheet>"
        )

    def _sheet_xml(self, ws: Worksheet, fonts, formats) -> str:
        cols = ""
        if ws.column_widths:
            col_parts = "".join(
                f'<col min="{c}" max="{c}" width="{w}" customWidth="1"/>'
                for c, w in sorted(ws.column_widths.items()))
            cols = f"<cols>{col_parts}</cols>"
        rows_out = []
        by_row: Dict[int, List[Tuple[int, Cell]]] = {}
        for (r, c), cell in ws._cells.items():
            by_row.setdefault(r, []).append((c, cell))
        for r in sorted(by_row):
            cells_out = []
            for c, cell in sorted(by_row[r]):
                if cell.value is None:
                    continue
                ref = f"{_col_letter(c)}{r}"
                font_id = fonts.index(cell.font._key()) if cell.font else 0
                fmt_id = 164 + formats.index(cell.number_format) if cell.number_format else None
                style = self._xf_index[(font_id, fmt_id, cell.align)]
                if isinstance(cell.value, (int, float)) and not isinstance(cell.value, bool):
                    cells_out.append(
                        f'<c r="{ref}" s="{style}"><v>{cell.value}</v></c>')
                else:
                    text = escape(str(cell.value))
                    cells_out.append(
                        f'<c r="{ref}" s="{style}" t="inlineStr">'
                        f"<is><t>{text}</t></is></c>")
            rows_out.append(f'<row r="{r}">{"".join(cells_out)}</row>')
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
            + cols + f'<sheetData>{"".join(rows_out)}</sheetData></worksheet>'
        )

    def save(self, path: str) -> None:
        if not self.sheets:
            self.create_sheet("Sheet")
        fonts, formats = self._collect_styles()
        styles = self._styles_xml(fonts, formats)

        n = len(self.sheets)
        content_types = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
            '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
            '<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>'
            + "".join(
                f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
                'ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
                for i in range(n))
            + "</Types>")
        rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
            "</Relationships>")
        sheets_xml = "".join(
            f'<sheet name="{escape(ws.title)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
            for i, ws in enumerate(self.sheets))
        workbook = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
            f"<sheets>{sheets_xml}</sheets></workbook>")
        wb_rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            + "".join(
                f'<Relationship Id="rId{i + 1}" '
                'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
                f'Target="worksheets/sheet{i + 1}.xml"/>'
                for i in range(n))
            + f'<Relationship Id="rId{n + 1}" '
            'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/styles" '
            'Target="styles.xml"/>'
            "</Relationships>")

        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("[Content_Types].xml", content_types)
            zf.writestr("_rels/.rels", rels)
            zf.writestr("xl/workbook.xml", workbook)
            zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
            zf.writestr("xl/styles.xml", styles)
            for i, ws in enumerate(self.sheets):
                zf.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                            self._sheet_xml(ws, fonts, formats))
