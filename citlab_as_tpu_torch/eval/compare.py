"""Split/merge partition comparator + method tournament (port of
``citlab_as_tpu/eval/compare.py``; host only).

Reference: as_eval/asQcTools/asCompTools.py:19-374. Semantics:

- ``SeparatedPage``: article -> baseline partition of a PAGE-XML file;
- ``SepPageBlComper``: corrects = identical partition blocks; the
  intersection refinement of GT and HYP partitions yields
  splits = |refinement| - |GT|, merges = |HYP| - |refinement|,
  dist = splits - merges; consistency gtNIs + splits + merges == hypNIs;
- ``SepPageCompDict``: nested {dataset: {gtXML: {hypXML: comparison}}} with
  CSV / SQLite / pickle round-trips; method name derived from the hyp path;
- ``CompDictEvaler``: pairwise wins by lexicographic (dist, -corrects),
  iterative loser-elimination winner table, XLSX report.
"""
from __future__ import annotations

import logging
import pickle
from csv import DictReader, DictWriter
from pathlib import Path, PurePath
from sqlite3 import connect
from typing import Dict, List, Optional

from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.utils.xlsx import Workbook

logger = logging.getLogger(__name__)


class SeparatedPage(Page):
    """PAGE-XML with the article partition of its baselines (asCompTools.py:19-50)."""

    def __init__(self, xml_file_path):
        super().__init__(str(xml_file_path))
        self.xmlFilePath = Path(xml_file_path)
        self._bl_ignore: set = set()
        self._re_init()

    def _re_init(self):
        self.blNiDict: Dict[str, Optional[str]] = {
            bl.id: bl.get_article_id()
            for bl in self.get_textlines() if bl.id not in self._bl_ignore}
        self.niBlDict: Dict[Optional[str], List[str]] = {
            ni: [] for ni in self.get_article_dict().keys()}
        # iterate in baseline-id order so each article's list is born sorted
        for bl_id in sorted(self.blNiDict):
            self.niBlDict[self.blNiDict[bl_id]].append(bl_id)
        self._can_bl_part = None

    def removeBlSet(self, bl_set: set) -> None:
        self._bl_ignore.update(bl_set)
        self._re_init()

    def canonicalBlPartition(self) -> list:
        if self._can_bl_part is None:
            self._can_bl_part = sorted(
                sorted(bls) for bls in self.niBlDict.values() if bls)
        return self._can_bl_part


class SepPageComparison:
    """Comparison counters (asCompTools.py:53-78)."""

    def __init__(self):
        self.gtNIs = None
        self.hypNIs = None
        self.corrects = None
        self.splits = None
        self.merges = None
        self.dist = None

    def __str__(self):
        return str(self.__dict__)

    def dataDict(self) -> dict:
        return self.__dict__

    def loadDict(self, data: dict) -> None:
        for member in self.__dict__:
            setattr(self, member, int(data.get(member)))

    def checkConsistency(self) -> bool:
        return self.gtNIs + self.splits + self.merges == self.hypNIs


class SepPageComper:
    """Comparison engine base (asCompTools.py:81-100)."""

    def __init__(self):
        self._hyp_page: Optional[SeparatedPage] = None
        self._gt_page: Optional[SeparatedPage] = None
        self._alt_gt_dict: Dict[str, SeparatedPage] = {}
        self.comparison: Optional[SepPageComparison] = None

    def loadGT(self, xml_file_path) -> None:
        self._gt_page = SeparatedPage(xml_file_path)

    def compareTo(self, xml_file_path) -> SepPageComparison:
        self._hyp_page = SeparatedPage(xml_file_path)
        self.comparison = self._compare()
        return self.comparison

    def _compare(self) -> SepPageComparison:
        raise NotImplementedError


class SepPageBlComper(SepPageComper):
    """Baseline-partition comparison (semantics of asCompTools.py:103-147).

    The intersection refinement of the GT and HYP partitions is the set of
    nonempty pairwise block intersections — equivalently, the baselines
    grouped by their (GT article, HYP article) label pair. It is computed
    here as that single-pass grouping rather than by materializing block
    intersections, which changes nothing about the counts:

        splits = |refinement| - |GT articles|
        merges = |HYP articles| - |refinement|
        dist   = splits - merges
    """

    def _compare(self) -> SepPageComparison:
        hyp_page = self._hyp_page
        gt_page = self._aligned_gt({tl.id for tl in hyp_page.get_textlines()})

        label_pairs = {
            (gt_ni, hyp_page.blNiDict[bl_id])
            for bl_id, gt_ni in gt_page.blNiDict.items()}

        comparison = SepPageComparison()
        comparison.gtNIs = len(gt_page.niBlDict)
        comparison.hypNIs = len(hyp_page.niBlDict)
        hyp_blocks = {
            frozenset(block) for block in hyp_page.canonicalBlPartition()}
        comparison.corrects = sum(
            frozenset(block) in hyp_blocks
            for block in gt_page.canonicalBlPartition())
        comparison.splits = len(label_pairs) - comparison.gtNIs
        comparison.merges = comparison.hypNIs - len(label_pairs)
        comparison.dist = comparison.splits - comparison.merges
        return comparison

    def _aligned_gt(self, hyp_bl_ids: set) -> SeparatedPage:
        """GT page restricted to the HYP baselines, memoized per extra-set.

        HYP baselines missing from GT are an error; GT baselines missing
        from HYP are dropped from a cached copy of the GT page.
        """
        gt_page = self._gt_page
        gt_bl_ids = set(gt_page.blNiDict)
        if gt_bl_ids == hyp_bl_ids:
            return gt_page
        extra = frozenset(gt_bl_ids - hyp_bl_ids)
        if not extra:
            # every GT baseline is in HYP, yet HYP has baselines GT lacks
            raise AssertionError("cannot compare: inconsistent baselines")
        aligned = self._alt_gt_dict.get(extra)
        if aligned is None:
            aligned = SeparatedPage(gt_page.xmlFilePath)
            aligned.removeBlSet(set(extra))
            self._alt_gt_dict[extra] = aligned
        return aligned


class SepPageCompDict(dict):
    """{dataset: {gtXML: {hypXML: SepPageComparison}}} with IO round-trips
    (asCompTools.py:150-237)."""

    fieldNames = ["dataSet", "method", "gtXML", "hypXML",
                  *SepPageComparison().dataDict().keys()]

    @classmethod
    def path2method(cls, path: str) -> str:
        parts = PurePath(path).parent.parts
        if len(parts) >= 5:
            return f"{parts[-5]}/{parts[-1]}"
        return str(parts[-1]) if parts else str(path)

    def addItem(self, dataSet, gtXML, hypXML, comparison) -> None:
        self.setdefault(dataSet, {}).setdefault(gtXML, {})[hypXML] = comparison

    def loadPickle(self, dataset_label, pickle_path: Path) -> None:
        with Path(pickle_path).open("rb") as f:
            self[dataset_label] = pickle.load(f)

    def savePickle(self, dataset_label, pickle_path: Path) -> None:
        with Path(pickle_path).open("wb") as f:
            pickle.dump(self[dataset_label], f)

    def cleanup(self, incl_list: list) -> None:
        for data_dict in self.values():
            for gt_dict in data_dict.values():
                for hyp in gt_dict:
                    if self.path2method(hyp) not in incl_list:
                        gt_dict[hyp] = None

    def expCsv(self, csv_path: Path) -> None:
        with Path(csv_path).open("wt", encoding="utf8", newline="") as f:
            writer = DictWriter(f, fieldnames=self.fieldNames)
            writer.writeheader()
            for dataSet, data_dict in self.items():
                for gtXML, gt_dict in data_dict.items():
                    for hypXML, comp in gt_dict.items():
                        if comp is None:
                            continue
                        row = {"dataSet": dataSet,
                               "method": self.path2method(hypXML),
                               "gtXML": gtXML, "hypXML": hypXML}
                        row.update(comp.dataDict())
                        writer.writerow(row)

    def loadCSV(self, csv_path: Path, incl_list: list) -> None:
        with Path(csv_path).open("rt") as f:
            for row in DictReader(f):
                if row.get("method", "").lower() in incl_list:
                    comp = SepPageComparison()
                    comp.loadDict(row)
                    self.addItem(row["dataSet"], row["gtXML"], row["hypXML"], comp)

    def expSqlite(self, db_path: Path, table: str) -> None:
        fields = ", ".join(self.fieldNames)
        con = connect(str(db_path))
        cur = con.cursor()
        cur.execute(f"DROP TABLE IF EXISTS {table}")
        cur.execute(f"CREATE TABLE {table} ({fields})")
        for dataSet, data_dict in self.items():
            for gtXML, gt_dict in data_dict.items():
                for hypXML, comp in gt_dict.items():
                    if comp is None:
                        continue
                    values = [dataSet, self.path2method(hypXML), gtXML, hypXML]
                    values += [comp.dataDict()[k] for k in comp.dataDict()]
                    placeholders = ", ".join("?" * len(values))
                    cur.execute(
                        f"INSERT INTO {table} ({fields}) VALUES ({placeholders})",
                        values)
        con.commit()
        con.close()


class CompDictEvaler:
    """Tournament over comparison collections (asCompTools.py:240-374)."""

    def __init__(self, spc_dict: SepPageCompDict):
        self.spcDict = spc_dict
        self.winnerStatDict: Dict = {}
        self.winnerDict: Dict = {}

    def countWinnerStat(self) -> None:
        """Pairwise 'wins' by lexicographic (dist, -corrects) <=."""
        for dataSet, data_dict in self.spcDict.items():
            self.winnerStatDict[dataSet] = {}
            stat = self.winnerStatDict[dataSet]
            for gtXML, gt_dict in data_dict.items():
                for hyp0, comp0 in gt_dict.items():
                    if not comp0:
                        continue
                    m0 = SepPageCompDict.path2method(hyp0)
                    stat.setdefault(m0, {"all": 0})
                    for hyp1, comp1 in gt_dict.items():
                        if not comp1:
                            continue
                        m1 = SepPageCompDict.path2method(hyp1)
                        stat[m0].setdefault(m1, 0)
                        if (comp0.dist, -comp0.corrects) <= (comp1.dist, -comp1.corrects):
                            stat[m0][m1] += 1
                            stat[m0]["all"] += 1

    def calcWinnerDict(self) -> None:
        """Iterative loser-elimination table."""
        if not self.winnerStatDict:
            self.countWinnerStat()
        for dataSet, data_dict in self.winnerStatDict.items():
            self.winnerDict[dataSet] = {}
            act = self.winnerDict[dataSet]
            methods = list(data_dict.keys())
            for method in methods:
                act[method] = [data_dict[method]["all"]]
            methods = sorted(methods, key=lambda m: act[m][-1])
            act["_max"] = [act[methods[-1]][-1]]
            while len(methods) > 1:
                loser = methods.pop(0)
                for method in methods:
                    act[method].append(
                        act[method][-1] - data_dict[method].get(loser, 0))
                methods = sorted(methods, key=lambda m: act[m][-1])
                act["_max"].append(act[methods[-1]][-1])

    def winnerStat2xlsx(self, xlsx_path) -> None:
        """XLSX report: per-dataset win-ratio matrices + winner-table sheet."""
        wb = Workbook()
        for dataSet, data_dict in self.winnerStatDict.items():
            methods = sorted(data_dict.keys(),
                             key=lambda m: data_dict[m]["all"], reverse=True)
            ws = wb.create_sheet(dataSet)
            ws.set(1, 1, "all", bold=True, align="center")
            for col, m1 in enumerate(methods, start=3):
                ws.set(1, col, m1, bold=True, align="center")
            for col in range(1, len(methods) + 3):
                ws.set_column_width(col, 40)
            for row, m0 in enumerate(methods, start=2):
                ws.set(row, 1, data_dict[m0]["all"], align="center")
                ws.set(row, 2, m0, bold=True, align="center")
                for col, m1 in enumerate(methods, start=3):
                    if m0 == m1:
                        ws.set(row, col, data_dict[m0][m1],
                               color="666666", align="center")
                    else:
                        denom = data_dict[m1].get(m0, 0)
                        if denom > 0:
                            ratio = data_dict[m0].get(m1, 0) / denom
                            color = "880000" if ratio < 1.0 else "00DD00"
                            ws.set(row, col, ratio, color=color,
                                   number_format="0.00", align="center")
                        else:
                            ws.set(row, col, "", color="00DD00")

        if self.winnerDict:
            ws = wb.create_sheet("winner", index=0)
            ws.set_column_width(1, 40)
            row_offset = 0
            for dataSet, data_dict in self.winnerDict.items():
                methods = [m for m in data_dict if not m.startswith("_")]
                methods = sorted(methods, key=lambda m: len(data_dict[m]), reverse=True)
                row = 1
                ws.set(row_offset + row, 1, dataSet, align="left")
                for method in methods:
                    row += 1
                    ws.set(row_offset + row, 1, method, bold=True, align="center")
                    for index, value in enumerate(data_dict[method]):
                        bold = value == data_dict["_max"][index]
                        ws.set(row_offset + row, 2 + index, value,
                               bold=bold, align="center")
                row_offset += row + 1
        wb.save(str(xlsx_path))
