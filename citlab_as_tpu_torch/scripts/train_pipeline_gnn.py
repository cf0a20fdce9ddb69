"""Train the relation GNN on features the real pipeline produces (port of
``scripts/train_pipeline_gnn.py``).

Synthetic multi-article newspaper pages are drawn to images and GT
PAGE-XML, the trained separator ARU-Net detects the drawn rules, text
regions come from the blind baseline clustering (then the GT article ids
are restored), and the feature generator writes the graph JSONs the GNN
trains on: the files inference reads. With ``--image_input`` the visual
net trains (``GraphRelation(image_input=True, visual_backbone=...)``, the
page images through the ARU backbone; ``ARU_v1`` runs its 3x3 convs on K1
under autograd).

Usage:
    python -m citlab_as_tpu_torch.scripts.train_pipeline_gnn
        --model_dir models_ckpt/gnn_pipeline [--image_input] [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from citlab_as_tpu_torch.device import DeviceLike


def make_article_page(out_dir: str, name: str, rng: np.random.RandomState,
                      w: int = 1000, h: int = 1500):
    """Multi-article page: 2-3 columns; horizontal rules split a column into
    articles; article starts get heading-sized strokes. GT article ids are
    written into the PAGE-XML text lines. Returns (image path, page path,
    number of articles); the image is ``<name>.png`` (``utils/io.py::
    save_png``), the page ``page/<name>.xml``."""
    from citlab_as_tpu_torch.utils.io import save_png

    n_cols = rng.randint(2, 4)
    col_w = w // n_cols
    img = np.full((h, w), 255, np.uint8)
    for c in range(1, n_cols):
        x = c * col_w
        img[40:h - 40, x - 2:x + 2] = 40

    lines = []
    i = 0
    article = 0
    for c in range(n_cols):
        x0, x1 = c * col_w + 30, (c + 1) * col_w - 30
        y = 90
        new_article = True
        lines_in_article = 0
        while y < h - 80:
            if new_article and rng.rand() < 0.7:
                # heading strokes (taller/fatter)
                for x in range(x0, x1 - 20, 34):
                    img[y - 44:y - 4, x:x + 14] = 0
                y_coords = (y - 48, y + 4)
            else:
                for x in range(x0, x1 - 8, 22):
                    img[y - 26:y - 2, x:x + 6] = 0
                y_coords = (y - 30, y + 4)
            lines.append(
                f'<TextLine id="tl_{i}" custom="structure '
                f'{{type:article; id:a{article + 1};}}">\n'
                f'  <Coords points="{x0},{y_coords[0]} {x1},{y_coords[0]} '
                f'{x1},{y_coords[1]} {x0},{y_coords[1]}"/>\n'
                f'  <Baseline points="{x0},{y} {x1},{y}"/>\n'
                f'  <TextEquiv><Unicode>line {i}</Unicode></TextEquiv>\n'
                f'</TextLine>')
            i += 1
            new_article = False
            lines_in_article += 1
            y += int(rng.uniform(55, 75))
            # article break inside the column: a horizontal rule and a clear
            # gap, only after a few lines (the DBSCAN stage needs the gap to
            # exceed the interline scale)
            if (y < h - 220 and lines_in_article >= 3
                    and rng.rand() < 0.35):
                img[y - 10:y - 7, x0 - 10:x1 + 10] = 40
                y += 60
                article += 1
                new_article = True
                lines_in_article = 0
        article += 1

    image_path = os.path.join(out_dir, f"{name}.png")
    save_png(image_path, img)
    xml = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<PcGts xmlns="http://schema.primaresearch.org/PAGE/gts/'
        'pagecontent/2013-07-15">\n'
        '  <Metadata><Creator>gen</Creator><Created>x</Created>'
        '<LastChange>x</LastChange></Metadata>\n'
        f'  <Page imageFilename="{name}.png" imageWidth="{w}" '
        f'imageHeight="{h}">\n'
        '    <TextRegion id="tr_1" type="paragraph">\n'
        f'      <Coords points="10,30 {w - 10},30 {w - 10},{h - 30} '
        f'10,{h - 30}"/>\n'
        + "\n".join(lines) +
        '\n    </TextRegion>\n  </Page>\n</PcGts>\n')
    page_dir = os.path.join(out_dir, "page")
    os.makedirs(page_dir, exist_ok=True)
    page_path = os.path.join(page_dir, f"{name}.xml")
    with open(page_path, "w") as f:
        f.write(xml)
    return image_path, page_path, article


def build_dataset(work_dir: str, num_pages: int, separator_model_dir: str,
                  seed: int, device: DeviceLike = "cuda") -> List[str]:
    """Pages -> trained-separator stage (on ``device``) -> blind text
    regions with the GT article ids restored -> feature JSONs (with the
    regions' polygons, for a visual net). Returns the JSON paths."""
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
    from citlab_as_tpu_torch.stages.features import generate_feature_jsons
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page

    rng = np.random.RandomState(seed)
    os.makedirs(work_dir, exist_ok=True)
    img_paths, page_paths = [], []
    for i in range(num_pages):
        img, page, _ = make_article_page(work_dir, f"g{i:03d}", rng)
        img_paths.append(img)
        page_paths.append(page)

    predictor = SegmentationPredictor(separator_model_dir, device=device)
    SeparatorNetPostProcessor(img_paths, predictor, fixed_height=1500).run_batched(batch_size=4)
    out_pages = [p + ".xml" for p in page_paths]

    # the text regions come from the blind path inference uses (DBSCAN
    # baseline clustering), so the net sees production region granularity;
    # the GT article ids are restored afterwards so that the features'
    # gt_relations come from the truth, not from the clusters
    for page_path in out_pages:
        gt_ids = {tl.id: tl.get_article_id()
                  for tl in Page(page_path).get_textlines()}
        cluster_page(page_path)
        generate_text_regions_for_page(page_path)
        page = Page(page_path)
        tls = page.get_textlines()
        for tl in tls:
            tl.set_article_id(gt_ids.get(tl.id))
        page.set_textline_attr(tls)
        page.write_page_xml(page_path)

    return generate_feature_jsons(out_pages, out_path=os.path.join(work_dir, "json"),
                                  image_paths=img_paths)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--work_dir", type=str,
                        default=os.path.join(tempfile.gettempdir(), "pipeline_gnn"))
    parser.add_argument("--num_pages", type=int, default=80)
    parser.add_argument("--epochs", type=int, default=24)
    parser.add_argument("--samples_per_epoch", type=int, default=1024)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--separator_model_dir", type=str,
                        default="models_ckpt/separator")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--image_input", action="store_true", default=False,
                        help="Train the visual 'v' variant: page images feed "
                             "the ARU visual backbone.")
    parser.add_argument("--resize_min_dim", type=int, default=288)
    parser.add_argument("--resize_max_dim", type=int, default=384)
    parser.add_argument("--visual_backbone", type=str, default="ARU_v1",
                        choices=["ARU_v1", "ARU_cutted_v1", "inception_v3"])
    parser.add_argument("--schedule", type=str, default="final_decay",
                        choices=["decay", "final_decay", "warmup_final_decay"])
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    json_paths = build_dataset(args.work_dir, args.num_pages,
                               args.separator_model_dir, args.seed, args.device)
    print(f"built {len(json_paths)} graph JSONs")
    split = max(1, int(0.9 * len(json_paths)))

    input_params = {"sample_num_relations_to_consider": 300,
                    "augmentation_config": ["scaling", "translation"]}
    model = None
    if args.image_input:
        from citlab_as_tpu_torch.models.gnn.model import GraphRelation
        input_params.update({"image_input": True,
                             "resize_min_dim": args.resize_min_dim,
                             "resize_max_dim": args.resize_max_dim})
        model = GraphRelation(15, 2, num_classes=2, image_input=True,
                              visual_backbone=args.visual_backbone)

    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    trainer = TrainerGNN(
        args.model_dir, json_paths[:split], json_paths[split:],
        flags={"epochs": args.epochs,
               "samples_per_epoch": args.samples_per_epoch,
               "batch_size": args.batch_size,
               "eval_every_n": 2,
               "best_export_metrics": ["f1"],
               "schedule_kind": args.schedule,
               "weight_decay": 1e-6},
        input_params=input_params,
        optimizer_params={"learning_rate": args.learning_rate,
                          "final_epochs": max(2, args.epochs // 4)},
        model=model, seed=args.seed, device=args.device)
    result = trainer.train()
    print("best metrics:", result["best_metrics"])
    return result


if __name__ == "__main__":
    main()
