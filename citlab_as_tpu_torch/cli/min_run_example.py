"""Minimal split/merge comparison example (port of
``citlab_as_tpu/cli/min_run_example.py``; reference: as_eval/minRunEx.py:
8-51). Host only, as the comparator.

Runs the comparator on a work tree of the reference's shape::

    <work>/page/<name>.xml                      ground truth
    <work>/clustering/<method>/<name>_clustering.xml   hypotheses

and writes comparison.xlsx/.csv to the output dir. With --demo it first
synthesizes a tiny work tree so the example runs self-contained.

    python -m citlab_as_tpu_torch.cli.min_run_example --demo \
        --work_dir work --out_dir work_out
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

from citlab_as_tpu_torch.eval.compare import (
    CompDictEvaler, SepPageBlComper, SepPageCompDict,
)


def _demo_tree(work_dir: str) -> None:
    lines = []
    for i, (aid, y) in enumerate((("a1", 100), ("a1", 160), ("a2", 300),
                                  ("a2", 360))):
        lines.append(f'''<TextLine id="tl_{i}" custom="structure {{id:{aid}; type:article;}}">
  <Coords points="50,{y - 30} 550,{y - 30} 550,{y + 5} 50,{y + 5}"/>
  <Baseline points="50,{y} 550,{y}"/>
  <TextEquiv><Unicode>line {i}</Unicode></TextEquiv>
</TextLine>''')

    def page_xml(line_block):
        return f'''<?xml version="1.0"?>
<PcGts xmlns="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15">
  <Metadata><Creator>c</Creator><Created>t</Created><LastChange>t</LastChange></Metadata>
  <Page imageFilename="p.png" imageWidth="600" imageHeight="500">
    <TextRegion id="tr_1" type="paragraph">
      <Coords points="40,40 560,40 560,460 40,460"/>
{line_block}
    </TextRegion>
  </Page>
</PcGts>'''

    os.makedirs(os.path.join(work_dir, "page"), exist_ok=True)
    with open(os.path.join(work_dir, "page", "p.xml"), "w") as f:
        f.write(page_xml("\n".join(lines)))

    # method-good: identical; method-merged: everything one article
    merged = [l.replace("id:a2", "id:a1") for l in lines]
    for method, block in (("method-good", lines), ("method-merged", merged)):
        d = os.path.join(work_dir, "clustering", method)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "p_clustering.xml"), "w") as f:
            f.write(page_xml("\n".join(block)))


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--work_dir", type=str, default="work")
    parser.add_argument("--out_dir", type=str, default="work_out")
    parser.add_argument("--dataset", type=str, default="example")
    parser.add_argument("--demo", action="store_true", default=False,
                        help="synthesize a tiny demo work tree first")
    args = parser.parse_args(argv)

    if args.demo:
        _demo_tree(args.work_dir)

    gt_dir = os.path.join(args.work_dir, "page")
    clustering_dir = os.path.join(args.work_dir, "clustering")
    gt_files = sorted(glob.glob(os.path.join(gt_dir, "*.xml")))

    comper = SepPageBlComper()
    spc = SepPageCompDict()
    for gt_file in gt_files:
        comper.loadGT(gt_file)
        name = os.path.splitext(os.path.basename(gt_file))[0] + "_clustering.xml"
        for method in sorted(os.listdir(clustering_dir)):
            hyp = os.path.join(clustering_dir, method, name)
            if not os.path.exists(hyp):
                continue
            comp = comper.compareTo(hyp)
            print(f"{os.path.basename(gt_file)} vs {method}: {comp}")
            spc.addItem(args.dataset, gt_file, hyp, comp)

    evaler = CompDictEvaler(spc)
    evaler.calcWinnerDict()
    os.makedirs(args.out_dir, exist_ok=True)
    xlsx = os.path.join(args.out_dir, "comparison.xlsx")
    evaler.winnerStat2xlsx(xlsx)
    spc.expCsv(os.path.join(args.out_dir, "comparison.csv"))
    print(f"wrote {xlsx}")
    return spc, evaler


if __name__ == "__main__":
    main()
