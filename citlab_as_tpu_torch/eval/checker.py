"""AS quality checker (port of ``citlab_as_tpu/eval/checker.py``, host only;
reference: as_eval/asQcTools/asCheckTools.py:16-202).

Problem codes:
  TL_11 — textline without text
  TL_12 — textline without article_id
  TL_21 — different textlines with identical text
  TR_11 — textregion with multiple article_ids
Runs selected checks over a list of PAGE-XML files and produces JSON / XLSX
reports.
"""
from __future__ import annotations

import json
import logging
from enum import Enum, auto, unique
from typing import Dict, List, Set

from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.utils.xlsx import Workbook

logger = logging.getLogger(__name__)


@unique
class AsProbCode(Enum):
    TL_11 = auto()
    TL_12 = auto()
    TL_21 = auto()
    TR_11 = auto()


PROB_CODE_DESC = {
    AsProbCode.TL_11: "textline without text",
    AsProbCode.TL_12: "textline without article_id",
    AsProbCode.TL_21: "different textlines with identical text",
    AsProbCode.TR_11: "textregion with multiple article_ids",
}


class AsProblem:
    def __init__(self, code: AsProbCode, entity: str, remark: str = ""):
        self.code = code
        self.entity = entity
        self.remark = remark

    def to_dict(self) -> dict:
        return {"code": self.code.name, "entity": self.entity, "remark": self.remark}

    def __repr__(self):
        return f"{self.code.name}\t{self.entity}\t{self.remark}"


class AsChecker:
    """Checker engine over a list of PAGE-XML files."""

    _CHECK_GROUPS = [
        ({AsProbCode.TL_11, AsProbCode.TL_12}, "_check_tl1"),
        ({AsProbCode.TL_21}, "_check_tl2"),
        ({AsProbCode.TR_11}, "_check_tr"),
    ]

    def __init__(self, code_set: Set[AsProbCode]):
        self.work_list = []
        used: Set[AsProbCode] = set()
        for codes, method in self._CHECK_GROUPS:
            act = codes & code_set
            if act:
                self.work_list.append((getattr(self, method), act))
                used |= act
        for code in code_set - used:
            logger.warning("%s not implemented; ignoring", code.name)
        if not self.work_list:
            raise RuntimeError("no checks to be performed")
        self.page_list: List[str] = []
        self.prob_dict: Dict[str, List[AsProblem]] = {}
        self.cnt_probs = 0
        self.cnt_dict = {code.name: 0 for code in used}
        self._act_page = None
        self._act_codes: Set[AsProbCode] = set()

    # ------------------------------------------------------------------
    def check_pages(self) -> None:
        for page_path in self.page_list:
            name = str(page_path)
            self._act_page = Page(name)
            probs: List[AsProblem] = []
            for method, codes in self.work_list:
                self._act_codes = codes
                probs.extend(method())
            if probs:
                self.prob_dict[name] = probs
                self.cnt_probs += len(probs)

    def _check_tl1(self) -> List[AsProblem]:
        out = []
        for tl in self._act_page.get_textlines():
            if AsProbCode.TL_11 in self._act_codes and len(tl.text) == 0:
                out.append(AsProblem(AsProbCode.TL_11, tl.id, "empty"))
                self.cnt_dict[AsProbCode.TL_11.name] += 1
            if AsProbCode.TL_12 in self._act_codes and tl.get_article_id() is None:
                out.append(AsProblem(AsProbCode.TL_12, tl.id, "w/o article"))
                self.cnt_dict[AsProbCode.TL_12.name] += 1
        return out

    def _check_tl2(self) -> List[AsProblem]:
        out = []
        if AsProbCode.TL_21 in self._act_codes:
            lines = sorted(self._act_page.get_textlines(), key=lambda x: x.id)
            for idx, tl1 in enumerate(lines):
                for tl2 in lines[idx + 1:]:
                    if len(tl1.text) > 0 and tl1.text == tl2.text:
                        out.append(AsProblem(
                            AsProbCode.TL_21, tl1.id, f"same as {tl2.id}"))
                        self.cnt_dict[AsProbCode.TL_21.name] += 1
        return out

    def _check_tr(self) -> List[AsProblem]:
        out = []
        if AsProbCode.TR_11 in self._act_codes:
            for tr in self._act_page.get_text_regions():
                ids = {tl.get_article_id() for tl in tr.text_lines
                       if tl.get_article_id() is not None}
                if len(ids) > 1:
                    out.append(AsProblem(AsProbCode.TR_11, tr.id, str(ids)))
                    self.cnt_dict[AsProbCode.TR_11.name] += 1
        return out

    # ------------------------------------------------------------------
    def prob_to_json(self) -> str:
        if not self.prob_dict:
            return json.dumps("(no problems detected)", indent=2)
        serializable = {
            page: [p.to_dict() for p in probs]
            for page, probs in self.prob_dict.items()}
        return json.dumps(serializable, indent=2)

    def probs_to_xlsx(self, xlsx_path) -> None:
        wb = Workbook()
        ws = wb.create_sheet("problems")
        for col, header in enumerate(["page", "code", "entity", "remark"], start=1):
            ws.set(1, col, header, bold=True)
        ws.set_column_width(1, 60)
        ws.set_column_width(4, 40)
        row = 2
        for page, probs in self.prob_dict.items():
            for p in probs:
                ws.set(row, 1, page)
                ws.set(row, 2, p.code.name)
                ws.set(row, 3, p.entity)
                ws.set(row, 4, p.remark)
                row += 1
        summary = wb.create_sheet("summary")
        summary.set(1, 1, "code", bold=True)
        summary.set(1, 2, "count", bold=True)
        summary.set(1, 3, "description", bold=True)
        summary.set_column_width(3, 50)
        for i, (code, cnt) in enumerate(sorted(self.cnt_dict.items()), start=2):
            summary.set(i, 1, code)
            summary.set(i, 2, cnt)
            summary.set(i, 3, PROB_CODE_DESC[AsProbCode[code]])
        wb.save(str(xlsx_path))
