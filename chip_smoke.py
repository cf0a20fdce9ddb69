"""Chip smoke test of the PyTorch/CUDA port (``citlab_as_tpu_torch``).

Run from the repository root on a machine with one CUDA card (H100):

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result):

1. device: card name, ``nvidia-smi`` name and power limit, torch and CUDA
   versions;
2. build: every kernel of the main path, from ``csrc/*.cu`` with nvcc (the
   host libraries, ``csrc/geometry_host.cpp``, ``csrc/image_decode.cpp``
   and ``csrc/image_encode.cpp``, build with the host compiler at their
   first call);
3. kernels: K1 (conv3x3) and K2 (separator morphology) against their plain
   PyTorch versions at the main path's shapes, then timed with CUDA events
   beside the plain version and, for K1, one cuDNN ``F.conv2d`` call: the
   eight (Cin -> Cout) pairs at full resolution (the ``kernels`` line's
   ``ms`` is their sum) and each of the 24 (pair, shape) instances one ARU
   forward launches, with the launch-weighted sum per forward. ``ms`` is
   CUDA events around launches the host issues one by one; ``device_ms`` is
   the same launches replayed from a CUDA graph, the device's time alone;
   K1 is also held against its plain version, and timed the same way, at
   the 24 instances of the heading stage's forward (4 x 960 x 640) and at
   the 24 of the segmentation trainer's forward (4 x 512 x 512, bf16 and
   f32, the two dtypes phase 13 trains in); K1 under autograd (its forward, cuDNN's backward) against autograd through
   ``F.conv2d`` at one main-path instance;
4. main path: 8 synthetic 2000 x 1420 pages through
   ``SeparatorNetPostProcessor(..., fixed_height=1500).run_batched(4)`` in
   bf16 with the converted separator weights; the kernels' launch counts
   (reset just before the run), mask agreement with the same run through
   the plain versions, column-rule recall, pages/s and a phase split;
5. files to files: the same kind of pages written as PNG files with one
   PAGE-XML each (text regions, 200-400 text lines in columns, a few
   headline lines of tall thick-stroked glyphs), through
   ``SeparatorNetPostProcessor(...).run_batched_fused(4)`` and then
   ``HeadingNetPostProcessor(..., page_paths=<the separator's output>,
   save_suffix="").run_batched_fused(4)``, in bf16 with the converted
   weights of both nets. Gates: every written file parses and is
   structurally valid, has SeparatorRegions, column-rule recall, the
   kernels' launch counts, the card's distance transform and per-line
   integers equal to the port's CPU device on the same pages (a sample of
   every page's lines, redone in a worker process of this script,
   ``--cpu-check``, that runs beside the later phases and is gated at the
   end, after dp_procs), every line's integers equal to the host path's,
   headline lines tagged ``heading`` and at most 5 % of the body lines;
   then pages/s per stage and a phase split of the heading stage;
6. workflow: the same kind of pages through the port's
   ``cli/run_full_workflow.py::run_full_workflow`` (separator, heading,
   baseline clustering, text regions, GNN features, the converted ``gnn``
   relation net, ``clustering_method="dbscan"``), groups of 4: one run off
   the clock, one timed (pages/s, the kernels' launch counts) and one whose
   ``timings`` give the stage split. Gates: K1 69 x 2 launches and K2 one
   per group, every clustered file valid (TextRegion y above the page edge
   clamped to 0, as :func:`structurally_valid` says) with an article id on
   every text line, no page whose line features the feature stage redoes on
   the host, and the card's relation confidences within 1e-5 of the port's CPU
   device on the same feature JSONs with equal dbscan labels. Articles and
   regions per page and the line pairs' agreement with the drawn layout are
   printed, not gated;
7. gnn: the relation GNN's forward alone on one group of 4 graphs at the
   node bucket of 64 (Delaunay edges): CUDA-event ms, eager and from a
   CUDA graph, and the device launches and device time of one forward
   (``torch.profiler``);
8. pipelined: 16 pages of the files phase's kind (4 groups of 4, so the
   four-stage wave reaches a steady state) through the sequential
   ``run_full_workflow`` and through ``run_full_workflow_pipelined`` with
   ``host_workers=0`` and with ``min(4, cpu_count - 1)`` spawned workers,
   two runs each on the same files. Gates on each driver's first run:
   every written file (page XML, feature JSON, clustered XML) byte-equal to
   the sequential run's with ``LastChange`` normalised; K1 69 x 2 and K2
   one launch per group; an article id on every text line; the pipelined
   ``timings`` keys. Pages/s of every run and the pipelined ``timings``
   are printed;
9. visual: the workflow's 8 pages with the converted visual relation net
   (``gnn_visual``, ARU_cutted backbone, page images at 288 / 384),
   sequential and pipelined. Gates: the pipelined files byte-equal to the
   sequential ones; K1 and K2 launches as in the workflow, and none from
   the visual forward alone; an article id on every text line; the card's
   visual confidences within ``VISUAL_CONF_TOL`` of the port's CPU device
   on the same feature JSONs and images, with equal dbscan labels. The
   visual forward's time per group is printed: eager (CUDA events) and
   device time (``torch.profiler``);
10. formats: the six committed JPEG / TIFF fixtures (``tests/data/
   torch_formats``: grey JPEG with restart markers, 4:2:0 colour JPEG,
   progressive JPEG, LZW + predictor TIFF in strips, Deflate TIFF in tiles,
   Group 4 TIFF; 2000 x 1420, made by ``scripts/make_format_fixtures.py``)
   decoded by the host C++ decoder: size and sha256 of the "L" bytes equal
   PIL's recorded ones; ms per page (median of 3) beside a PNG of the same
   pixels. Then the port's stage CLIs in the workflow's order on the card:
   ``run_net_post_processing`` separator (the fixtures and their PNG twins)
   and heading, baseline clustering, text regions, features,
   ``run_gnn_clustering``. Gates: K1 69 per forward and K2 one per group;
   every written page valid; the separator's page of each fixture equal to
   its PNG twin's (``LastChange`` and ``imageFilename`` blanked); an
   article id on every line; card vs CPU relation confidences within 1e-5
   with equal dbscan labels; ``gk_calc_metric`` equal to the numpy path to
   1e-9. The port's ``run_measure`` against GT from the drawn layout
   prints AS R/P/F (not gated);
11. variants: the PNM, PNG, TIFF, JPEG, BMP, GIF, WebP and JPEG 2000
   variants of the host decoders. Every small fixture of
   ``tests/data/torch_formats_variants/small`` (999 files: ASCII and
   16-bit PNM, PNG at every colour type and depth with and without Adam7,
   TIFF with CCITT modified Huffman / Group 3, FillOrder 2, 2- to 32-bit
   and float samples, both predictors, planar layouts, CMYK, JPEG-in-TIFF,
   old-style JPEG, YCbCr under LZW / Deflate / PackBits, BigTIFF; JPEG in
   CMYK / YCCK, arithmetic-coded, lossless, block-smoothed progressive and
   4:4:0; BMP of every header, depth, RLE and bitfields layout; GIF
   interlaced or not, with global / local tables and transparency; WebP
   lossy at every loop filter, partition and segment setting, with ALPH
   alpha under each filter, lossless, VP8X and animated; JPEG 2000 as JP2,
   JPX and raw codestreams in every progression order, with POC, tiles and
   tile-parts, every code-block style, SOP / EPH, PPM / PPT / PLT / PLM /
   TLM, ROI, 1- to 16-bit, signed and subsampled components, palettes;
   ``scripts/make_format_fixtures.py``) decodes to PIL's recorded size and
   "L" and "RGB" digests. Ten 2000 x 1420 pages: an Adam7 PNG and a
   16-bit PNG (holding the 8-bit values) written from the newspaper
   generator's arrays by the test encoders of ``scripts/format_variants.py``
   (pure numpy and zlib), the committed Group 3 2-D TIFF, YCbCr
   JPEG-in-TIFF and 16-bit LZW TIFF with the predictor, and the committed
   CMYK (Adobe), YCCK, arithmetic-coded progressive, lossless grey and
   block-smoothed progressive JPEGs (``tests/data/torch_formats_jpeg``),
   each decoded to its oracle (the written array, or PIL's digests; for
   the arithmetic-coded page, which PIL cannot read whole, libjpeg-turbo's)
   and saved as an 8-bit PNG twin; the twenty pages through
   ``run_full_workflow_pipelined`` with the production nets. Gates: each
   variant's ``_clustering.xml`` equal to its twin's (``LastChange`` and
   ``imageFilename`` blanked), K1 69 x 2 and K2 one launch per group, an
   article id on every line. A PBM (P4) page, an RLE8 BMP page and an
   interlaced GIF page, the committed lossy, lossless and alpha WebP
   pages (``tests/data/torch_formats_webp``) and the committed lossy 9/7
   RPCL-tiled, lossless 5/3 and lossy ICT colour JPEG 2000 pages
   (``tests/data/torch_formats_jpeg2000``) and the committed AVIF pages
   (``tests/data/torch_formats_avif``: PIL's defaults with palette and
   IntraBC, speed 8 with palette, a deblocked scanned copy, the scanned
   copy with loop restoration and CDEF, under superres, with film grain
   from aom's denoiser and as a 4 x 3 grid of 512 x 512 tiles, an avis
   sequence's first frame, and premultiplied alpha; the small fixtures
   include the AVIF variants of ``scripts/avif_variants.py``),
   each at PIL's "L" and "RGB" digests and beside its twin, through the
   separator CLI (they do not reach the workflow's page lookup): equal
   pages, K1 69 and K2 1 per group. The host decode ms per page (median of
   3) is printed beside each twin's;
12. blind: the JAX package's three blind article-quality oracles on the
   card: their pages (``tests/data/torch_blind``, made by
   ``scripts/make_blind_fixtures.py``: one multi-article page, two hard
   corpus pages, three pages for the visual relation net), article ids
   stripped, through ``run_full_workflow`` with the converted nets in
   bf16 through K1 (``gnn_pipeline``, or ``gnn_visual`` at 288 / 384),
   scored by the port's ``run_measure`` against the generators' ground
   truth. Gates: AS F1 above 0.98 (multi), 0.96 with baseline detection
   above 0.9 (hard), 0.95 mean (visual); K1 69 x 2 and K2 one launch per
   page group. The same pages with the ARU-Nets in f32 are measured
   beside, printed;
13. train: the segmentation trainer (``train/seg_trainer.py``) at the
   separator net's full width from its converted weights, on a GT
   directory of 4 drawn 1000 x 710 pages written with ``save_png``, batch
   4 x 512 x 512: 3 steps in f32 (TF32 off) on the card and on the CPU
   (losses within 1e-4 relative), then bf16 compute with float32 weights,
   3 steps off the clock and 10 timed, 2 eval steps (gates: K1 69 launches
   per train step and per eval step, finite losses, the first within 2e-2
   of the f32 one; the numbered step and best/accuracy, orbax checkpoints
   the port writes, read back equal to the trainer's live state bit for
   bit; the best export's directory predicts through
   ``SegmentationPredictor``);
   one step's device time split under
   ``torch.profiler`` (K1 forward, the K1 convs' cuDNN backward, other
   convs, optimizer, rest; idle share) and the weight cast and repack cost.
   Then the relation-GNN trainer (``train/trainer.py``) from the converted
   ``gnn`` weights on feature JSONs the feature stage writes from 8 drawn
   pages with article ids: 4 steps on the card and on the CPU (mean loss
   within 1e-5 relative), one epoch (batch 16 and 300 relations, the
   defaults; 128 steps; steps/s; its step and best/f1 read back equal to
   its live state bit for bit), ``run_lav`` (finite best F1), the best/f1
   directory in ``RelationPredictor`` against the trainer's confidences
   (1e-5). Last, ``run_train_segmentation`` and
   ``run_train_gnn`` with tiny epochs and no ``--device`` train on the card;
14. gt_eval: ground truth and evaluation. The port's generators (region GT
   with TextRegion and SeparatorRegion at scale 1 and at half resolution,
   separator-only region GT, both BNL generators, and
   ``cli/run_as_gt_generation.py`` without ``--device``) over the two
   committed 2000 x 1420 fixture pages of ``tests/data/torch_gt``
   (``scripts/make_gt_fixtures.py``): every written image's decoded
   pixels and every ``info.txt`` / ``regions_gt.json`` equal the JAX
   package's digests; the card's binarization and dilation equal the
   CPU's. Two bf16 steps of the segmentation trainer from the separator
   weights on the generated separator GT (K1 69 launches each). The heading
   grid search (``eval/heading_eval.py::run_grid_search``, the heading net
   at full width, 3 points) over 4 of the files phase's pages with GT
   region types: K1 69 launches per forward, metrics in [0, 1],
   ``f1_binary`` 1.0 at the default setting. ``cli/run_compare.py`` over the
   workflow phase's clustered pages (with the GT itself and every line one
   article as two more methods) against GT from the drawn layout: every
   comparison consistent, the CSV round-trips, the XLSX is a valid zip with
   a header and one row per method in each sheet; ``min_run_example
   --demo``; ``AsChecker`` finds no line without an article id;
15. models: the separator net exported from ``separator.npz`` to a bf16
   ``.frozen`` (``train/export.py``) and written into a TF ``.pb`` by this
   script's wire encoder, imported by ``models/pb_import.py``: on 4 main-path
   pages resized to height 1500, both forwards equal the ``.npz`` one bit
   for bit with 69 K1 launches each, and one separator-stage group from the
   ``.frozen`` net writes the ``.npz`` one's files (69 K1, 1 K2). The
   Inception v3 visual relation net at the ``gnn`` widths (seeded, its
   BatchNorm statistics calibrated on a seeded image) exported to a
   ``.frozen`` and served by ``run_gnn_clustering --image_input
   --visual_backbone inception_v3 --model_dir <.frozen>`` over 8 pages'
   visual feature JSONs at the defaults (600 / 1024: a 1024 x 1024 padded
   input): no K1 launch, one page's confidences card vs CPU within
   ``MODELS_CONF_TOL`` with equal dbscan labels and equal written
   PAGE-XML; eager and device ms per group of 4, the backbone's share,
   GFLOP and the f32 bound, peak memory. ``run_feature_generation
   --language german --wv_path`` (seeded vectors): the other features
   unchanged and the similarity equal to this script's recomputation from
   the page texts. The text-block post-processor's mask and polygons card
   vs CPU. ``run_page_preprocessing`` in every flag combination against
   the JAX package's digests (``tests/data/torch_preprocessing``,
   ``scripts/make_preprocessing_fixtures.py``);
16. parallel: data parallelism on the one card, over a mesh whose 2 shards
   both name it (on a machine of several cards, one card each:
   ``card_entries``) (``parallel/mesh.py``): ``ShardedSegmentationPredictor``
   over ``make_mesh()`` and over the 2 shards bit-equal to
   ``SegmentationPredictor`` at the same per-shard batch (69 K1 launches per
   shard forward); the pipelined workflow over the mesh on the pipelined
   phase's 16 pages (groups of 8, 4 per shard), with that phase's outputs
   deleted first, writing that phase's files byte for byte, K1 552 and K2 4 launches, pages/s beside the unsharded
   run's; ``run_net_post_processing --sharded`` writing the unsharded
   CLI's files in both modes; ``plot_net_output`` over 2 pages (K1 138)
   with each overlay equal to ``apply_mask`` of the card's probabilities;
   ``apply_transform`` card = CPU for every transform and kernel type on a
   2000 x 1420 page; ``initialize_multihost`` with a world-size-1 ``nccl``
   group. One card shows no scaling: the pages/s are printed, not claimed;
17. spatial: the height-sharded ARU forward (``parallel/spatial.py``) over
   meshes whose ``model`` devices all name the one card (on a machine of
   several cards, one card each, the broadsheet at k = 2 too, peak memory
   per card): the main-path
   batch (4 x 1536 x 1088, separator and heading nets in bf16, the
   separator's in f32 too) at k = 2 and 4, and a 9984 x 7040 broadsheet
   page at k = 1 and 4, against the unsharded forward (logits within 2e-2
   of their scale in bf16 and 1e-5 in f32, masks at ``THRESHOLD`` agreeing
   on 99.9 % of pixels, at most 0.1 % of pixels with probabilities 2e-2
   apart, K1 69 launches per shard), with eager and device ms,
   halo bytes and peak memory printed; ``ShardedSegmentationPredictor``
   over (data=2, model=2) against the unsharded predictor; the pipelined
   workflow over (2, 2) on the pipelined phase's 16 pages (valid files, an
   article id on every line, K1 1104 and K2 4; the files byte-equal to the
   pipelined phase's where the sharded forward is bit for bit, else their
   differences printed);
18. orbax: the JAX package's orbax checkpoints read and written here, where
   neither orbax nor tensorstore nor zstandard is installed (checked at the
   phase's start and end), by the port's own zstd, OCDBT and zarr code
   (``train/orbax.py``): the 9 committed directories of ``models_ckpt/``
   restored (ms per directory, warm page cache, and the host's zstd MB/s
   over all their chunks, printed), every array of the 5 converted
   ``models_ckpt_torch/*.npz`` equal to its directory's bit for bit; each
   directory re-written by the port (write ms, bytes against the committed
   directory, at most 1.10 x, and the host's zstd-frame writing MB/s,
   printed) and read back bit for bit with the committed ``_METADATA``;
   the zarr v3 checkpoint ``tests/data/torch_orbax_zarr3`` equal to
   ``models_ckpt/gnn/best/f1``; the workflow CLI over the workflow phase's 8
   pages with ``--separator_model_dir models_ckpt/separator
   --heading_model_dir models_ckpt/heading --gnn_model_dir
   models_ckpt/gnn/best/f1`` writing the ``--*_model`` (``.npz``) run's files
   byte for byte, K1 276 and K2 2 launches in each run; one relation-GNN
   train step resumed from a copy of ``models_ckpt/gnn`` (its step 29 and
   ``current_epoch.info``): the epoch after the saved one, a finite loss,
   adam's count carried on by one; the segmentation trainer at the
   separator's width resumed for one bf16 step from the orbax step it
   wrote itself (K1 69 launches under autograd, adam's count on by one);
19. recipes: the recipes that made ``models_ckpt/``
   (``citlab_as_tpu_torch/scripts``) on the card, through their ``main``.
   ``train_synthetic_separator`` at full width, bf16, batch 8 x 512 x 512,
   40 steps from scratch (steps/s; gates: K1 69 launches per train step
   and per eval forward, finite loss readbacks with the last below the
   first, card vs CPU losses of 2 steps from the same init and batches in
   f32 with TF32 off within 1e-4 relative, the written checkpoint in
   ``SegmentationPredictor`` with 69 K1 launches per forward).
   ``train_pipeline_gnn --image_input`` with the default ``ARU_v1``
   backbone: its dataset from 8 drawn pages through the separator on the
   card (K1 69 and K2 1 per group of 4), 2 epochs of 8 steps at batch 8
   with 288 / 384 images (train steps/s; one step's device split under
   ``torch.profiler``: K1 forward in f32, the K1 convs' cuDNN backward,
   the region max pool, the rest, and its idle share and peak memory);
   gates: K1 69 launches per train step, card vs CPU losses of 2 steps from
   the same init and batches in f32 within 1e-4 relative, ``best/f1`` in
   ``RelationPredictor(image_input=True, visual_backbone="ARU_v1")``
   within 1e-5 of the trainer's eval confidences. The ``gnn_visual``
   recipe (``ARU_cutted_v1``, ``warmup_final_decay``, 1 epoch): finite
   losses and no K1 launch in its steps. ``train_synthetic_gnn`` at its
   defaults: best f1 at least the JAX recipe's on a CPU less 0.02.
   ``eval_visual_gnn`` over its five seeds with the committed
   ``gnn_visual``: mean AS F above 0.95 (the blind phase's floor), K1 138
   and K2 1 per seed; mean and min printed.
20. dp_train: data-parallel training over a mesh of 2 shards that both
   name the one card (and over a mesh of every card where there are
   several): ``train/segmentation.py::make_sharded_train_step`` at the
   separator net's full width from ``separator.npz``, batch 8 x 512 x 512
   (4 per shard) of crops of the train phase's drawn GT pages, with a
   validity mask that gives every shard another weight and the separator
   recipe's class weights (8 : 1) and optimizer, 3 steps in f32 with
   TF32 off, then 2 bf16 steps off the clock and 10 timed beside the
   unsharded ``make_train_step`` on the same batches;
   ``TrainerGNN._make_sharded_train_step`` at the ``gnn`` checkpoint's
   widths from ``gnn.npz``, batch 16 (8 per shard) whose shards hold
   graphs of other sizes (uneven counts of valid relations), weight decay
   1e-4 and EMA 0.99, 3 steps then 10 timed beside the unsharded step; the
   ARU_v1 visual GNN, f32, batch 8 at 384 x 384 (4 per shard), 2 steps.
   Gates: K1 69 launches per shard per segmentation and ARU_v1 step (138
   on the 2-shard mesh); after every step every replica's parameters,
   optimizer state and EMA bit-equal to shard 0's; in f32 each sharded step
   against the unsharded step on the whole batch from the same start: the
   loss within 1e-5 relative, the gradient it applied within 1e-2 and the
   parameters after it within 1e-3 of their norms over the whole net (the
   worst leaf printed); the bf16 sharded losses finite, the first within
   2e-2 of the f32 one. Printed, not gated: sharded and unsharded steps/s (one card shows
   no scaling) and ``reduce_gradients``' ms.
21. dp_procs: data-parallel training across processes. Worker processes of
   this script (``--dp-procs-worker``), 2 on one card over ``gloo`` with
   CUDA tensors (``nccl`` refuses two ranks on one card), one per card on a
   machine of several over ``nccl``, each ``initialize_multihost()`` (which
   pins it to its card) and ``make_mesh()`` over every process's cards: the
   dp_train phase's segmentation steps at the separator's full width from
   ``separator.npz`` (3 f32, then 2 bf16 off the clock and 10 timed, batch
   8 x 512 x 512) and its relation GNN steps at the ``gnn`` checkpoint's
   widths (3, then 10 timed). Gates: every worker exits 0 within
   ``DP_PROCS_TIMEOUT`` seconds; the processes' replicas (parameters,
   optimizer state, EMA) bit-equal after every step (digests) and their
   losses equal; each f32 step, from the processes' own start, within
   ``DP_PARAM_TOL`` (parameters, EMA) and 1e-5 (loss) of the in-process
   ``make_sharded_train_step`` over a mesh of as many shards on the same
   cards; K1 69 per process per segmentation step summed over the
   processes, K2 none. Printed: steps/s per process and
   ``reduce_gradients``' ms (all_gather included) beside dp_train's
   in-process numbers.

The last two lines are the ``kernels`` JSON and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}   # tensor-core bf16, CUDA-core f32
K1_PAIRS = [(8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (16, 8), (32, 16), (64, 32)]
K1_SHAPE = (4, 1536, 1088)                  # the separator's forward: height 1500, padded
K1_HEADING_SHAPE = (4, 960, 640)            # the heading's forward: height 900, padded
K2_SHAPE = (4, 1500, 1065)                  # 2000 x 1420 pages at height 1500
K2_KERNELS = (15, 30, 10)
K2_WIDE_W = 3200                            # h_k + noise_k = 48 + 32 >= 64
PAGE_SHAPE = (2000, 1420)
N_PAGES, BATCH, FIXED_HEIGHT, THRESHOLD = 8, 4, 1500, 0.05
HEADING_FIXED_HEIGHT = 900
HEADLINES_PER_PAGE = 3
CPU_CHECK_EVERY = 20                        # lines redone on the CPU device: see cpu_check_lines
N_PIPE_PAGES = 16                           # 4 groups of 4: the wave's steady state
# card vs CPU confidences of the visual relation net: its backbone is f32
# convolutions (TF32 off) whose sums of up to 9 x 192 = 1728 products run in
# another order on cuDNN than on the CPU, and the GNN's segment sums are
# float atomics on the card (2.6e-6 apart without the backbone); 1e-4
# leaves room for that drift, and the dbscan labels, which decide the
# written files, are gated equal
VISUAL_CONF_TOL = 1e-4
VISUAL_KW = dict(image_input=True, visual_backbone="ARU_cutted_v1",
                 image_min_dimension=288, image_max_dimension=384)
FORMATS_DIR = os.path.join(REPO, "tests", "data", "torch_formats")
FORMATS_METRIC_PAGES = 2                    # pages whose measure the numpy path redoes
VARIANTS_DIR = os.path.join(REPO, "tests", "data", "torch_formats_variants")
JPEG_VARIANTS_DIR = os.path.join(REPO, "tests", "data", "torch_formats_jpeg")
WEBP_DIR = os.path.join(REPO, "tests", "data", "torch_formats_webp")
MAIN_FORMATS_DIR = os.path.join(REPO, "tests", "data", "torch_formats_main")
BOMB_SHAPE = (10000, 20000)                 # a PNG header past PIL's decompression-bomb limit
JPEG2000_DIR = os.path.join(REPO, "tests", "data", "torch_formats_jpeg2000")
REGISTRY_DIR = os.path.join(REPO, "tests", "data", "torch_formats_registry")
AVIF_DIR = os.path.join(REPO, "tests", "data", "torch_formats_avif")
BLIND_DIR = os.path.join(REPO, "tests", "data", "torch_blind")
# the train phase: the JAX trainer's default batch and crop; drawn pages of
# 1000 x 710 (the crops need 512 in both directions)
SEG_BATCH, SEG_CROP = 4, (512, 512)
SEG_GT_PAGES, TRAIN_PAGE_SHAPE = 4, (1000, 710)
SEG_CHECK_STEPS, SEG_WARM_STEPS, SEG_TIMED_STEPS, SEG_EVAL_STEPS = 3, 3, 10, 2
GT_TRAIN_STEPS = 2                           # bf16 steps on the generated separator GT
GRID_PAGES = 4                               # the files phase's first pages, for the grid search
GRID = dict(fixed_heights=(HEADING_FIXED_HEIGHT,), thresholds=(0.4,), net_weights=(0.8,))
GNN_PAGES, GNN_CHECK_STEPS, GNN_PARAGRAPH_LINES = 8, 4, 6
# one epoch of the GNN trainer: batch 16 and 300 relations as its defaults,
# 2048 samples (128 steps) where the default is 8192: the host's input
# pipeline (JSON parse, the JAX package's loop of Python relation draws)
# took 39-72 ms per batch of 16 on the card's machine, so the default
# epoch's 512 steps would take 20-37 s of the train phase's budget of about
# 60 s on host batches alone
GNN_EPOCH_SAMPLES = 2048
PIPELINED_TIMINGS = {"separator_materialize", "dispatch", "separator_drain",
                     "heading_dispatch", "heading_drain", "heading_finish",
                     "gnn_dispatch", "gnn_materialize", "gnn_clustering",
                     "separator_drain.contours", "separator_drain.write", "total"}


def _draw_page(rng, h, w, yy, xx):
    """One page of :func:`synthetic_pages`: (uint8 page, column-rule mask,
    layout dict with the rule's x, its half width and the line spacing)."""
    rule_w = rng.randint(3, 6)
    spacing = rng.randint(20, 31)
    col = rng.randint(int(0.4 * w), int(0.6 * w))
    v_sep = (np.abs(xx - col) < rule_w) & (yy >= h // 10) & (yy < h - h // 10)
    h_sep = np.zeros((h, w), bool)
    h_rules = (rng.randint(h // 5, h // 3), rng.randint(h // 2, 3 * h // 4))
    for y in h_rules:
        h_sep |= ((np.abs(yy - y) < max(1, rule_w - 1)) & (xx >= 10)
                  & (xx < col - rule_w - 5))
    sep = v_sep | h_sep
    band = (yy % spacing) < (spacing * 3) // 5
    low = rng.rand(-(-h // 6), -(-w // 6))
    words = np.kron(low, np.ones((6, 6)))[:h, :w] > 0.45
    margin = ((xx > 8) & (xx < w - 8) & (yy > 8) & (yy < h - 8)
              & (np.abs(xx - col) > rule_w + 3))
    img = np.ones((h, w))
    img[band & words & margin & ~sep] = 0.25
    img[sep] = 0.15
    img -= np.kron(rng.rand(-(-h // 2), -(-w // 2)), np.ones((2, 2)))[:h, :w] * 0.08
    page = (img * 255).clip(0, 255).astype(np.uint8)
    speckle = rng.rand(h, w) < 0.01
    page[speckle] = rng.randint(0, 256, int(speckle.sum()))
    return page, v_sep, {"col": col, "rule_w": rule_w, "spacing": spacing,
                         "h_rules": h_rules}


def synthetic_pages(n, h, w, seed):
    """Newspaper-like uint8 pages [h, w] in the style the separator net was
    trained on (``train/synthetic_data.py`` of the JAX package): light
    paper with scan noise, text-line bands of blobby words, a dark vertical
    column rule, two horizontal rules, 1% speckle. Returns (pages,
    column-rule boolean masks)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    drawn = [_draw_page(rng, h, w, yy, xx) for _ in range(n)]
    return [d[0] for d in drawn], [d[1] for d in drawn]


def rule_boxes(h, lay):
    """The drawn rules of one page as inclusive boxes (x0, y0, x1, y1): the
    vertical column rule first, then the two horizontal rules."""
    col, rule_w = lay["col"], lay["rule_w"]
    half = max(1, rule_w - 1)
    return ([(col - rule_w + 1, h // 10, col + rule_w - 1, h - h // 10 - 1)]
            + [(10, y - half + 1, col - rule_w - 6, y + half - 1) for y in lay["h_rules"]])


def synthetic_newspaper(n, h, w, seed, headlines=HEADLINES_PER_PAGE, rules_out=None):
    """Pages of :func:`synthetic_pages` with a text layout on top. Each page
    gets ``headlines`` headline lines in its left column (the bands under
    them cleared to paper, then tall zigzag glyphs of thick dark strokes) and one text line
    per text band and sub-column (each side of the column rule halved), in
    one text region per sub-column and one per headline. Returns (pages,
    column-rule masks, layouts); a layout is a list of regions
    ``(region id, [(line id, (x0, y0, x1, y1)), ...])`` with headline ids
    starting ``hl_``. A list ``rules_out`` receives each page's
    :func:`rule_boxes`."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    pages, rules, layouts = [], [], []
    for _ in range(n):
        page, v_sep, lay = _draw_page(rng, h, w, yy, xx)
        if rules_out is not None:
            rules_out.append(rule_boxes(h, lay))
        col, rule_w, spacing = lay["col"], lay["rule_w"], lay["spacing"]
        text_h = (spacing * 3) // 5
        left = (10, col - rule_w - 4)
        right = (col + rule_w + 4, w - 9)
        columns = []
        for x0, x1 in (left, right):
            mid = (x0 + x1) // 2
            columns += [(x0, mid - 3), (mid + 3, x1)]
        n_bands = (h - 16) // spacing
        # headline zones: three text bands tall, apart from each other
        span = max(3, -(-60 // spacing))
        starts = sorted(rng.choice(np.arange(2, n_bands - span - 2, span + 3),
                                   size=headlines, replace=False).tolist())
        regions, taken = [], set()
        thick, run = 14, 44                  # a stroke's width and x advance
        for k, b0 in enumerate(starts):
            y0, y1 = b0 * spacing, (b0 + span) * spacing - (spacing - text_h)
            page[y0 - 2:y1 + 2, left[0]:left[1] + 1] = 236
            # glyphs: zigzags of three slanted strokes, as tall as the zone. A
            # slanted stroke has no long vertical or horizontal run, so the
            # separator stage's openings cannot take it for a rule.
            rows = np.arange(y0 + 2, y1 - 2)
            frac = (rows - rows[0]) / (len(rows) - 1)
            for gx in range(left[0] + 8, left[1] - 3 * run - thick - 8, 3 * run + thick + 18):
                for j in range(3):
                    xs = np.round(gx + (j + (frac if j % 2 == 0 else 1 - frac)) * run)
                    for r, x in zip(rows, xs.astype(int)):
                        page[r, x:x + thick] = 25
            taken.update(range(b0, b0 + span))
            regions.append((f"r_hl_{k}", [(f"hl_{k}", (left[0], y0, left[1], y1))]))
        for c, (x0, x1) in enumerate(columns):
            lines = []
            for b in range(1, n_bands):
                if c < 2 and b in taken:
                    continue
                y0 = b * spacing
                lines.append((f"c{c}_l{b}", (x0, y0, x1, y0 + text_h)))
            regions.append((f"r_col_{c}", lines))
        pages.append(page)
        rules.append(v_sep)
        layouts.append(regions)
    return pages, rules, layouts


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, iters=20):
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph and replayed, so the host's time to issue a launch (tens of
    microseconds through Python, more than a small kernel runs) is not in
    the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, ops, kind):
    """(least ms, 'bytes' or 'operations') on an H100 SXM at full power."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    print(smi_line)
    return name, smi_line


def phase_build():
    """Build the kernels and the host libraries, one compiler each, all
    together, so that no later phase's timing holds a compile."""
    from citlab_as_tpu_torch.ops.kernels import build
    names = build.KERNEL_SOURCES + build.HOST_SOURCES
    t0 = time.perf_counter()
    build.build_all(names)
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s for {', '.join(names)}")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return secs


def k1_main_path_instances(shape=None):
    """The (Cin, Cout, H, W, launches per forward) of every K1 launch of one
    ARU forward at ``shape`` (default ``K1_SHAPE``): the detCNN (``models/arunet.py::_DetCNN``)
    runs on the input and on its 2x and 4x average pools, and each pass
    sends 23 convs through K1 on its first three levels."""
    _, h, w = shape or K1_SHAPE
    per_level = [[(8, 8, 6), (16, 8, 1)],
                 [(8, 16, 1), (16, 16, 6), (32, 16, 1)],
                 [(16, 32, 1), (32, 32, 6), (64, 32, 1)]]
    out = []
    for scale in range(3):
        for level, convs in enumerate(per_level):
            sh, sw = -(-h // 2 ** (scale + level)), -(-w // 2 ** (scale + level))
            out += [(cin, cout, sh, sw, n) for cin, cout, n in convs]
    return out


def k1_bound(b, h, w, cin, cout):
    pix = b * h * w
    return bound(2 * (pix * (cin + cout) + 9 * cin * cout + cout),
                 2 * 9 * cin * cout * pix, "bf16")


def phase_k1(dev):
    import torch
    import torch.nn.functional as F
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    b, h, w = K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(cin, cout, hh, ww, batch=b):
        x = torch.randn((batch, hh, ww, cin), device=dev, generator=gen)
        wt = torch.randn((cout, cin, 3, 3), device=dev, generator=gen) * (
            2.0 / (9 * cin + cout)) ** 0.5
        return x, wt, torch.full((cout,), 0.1, device=dev)

    def bf16_error(xb, wb, bb, what):
        got = k1.conv3x3(xb, wb, bb, relu=True).float()
        want = k1.conv3x3_plain(xb, wb, bb, relu=True).float()
        torch.cuda.synchronize()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        check(rel <= 2e-2, f"K1 bf16 {what}: error {rel} of the output scale")
        return rel

    worst_f32, worst_bf16 = 0.0, 0.0
    rows = []
    for cin, cout in K1_PAIRS:
        x, wt, bias = inputs(cin, cout, h, w)
        got = k1.conv3x3(x, wt, bias, relu=True)
        want = k1.conv3x3_plain(x, wt, bias, relu=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= 1e-4, f"K1 f32 {cin}->{cout}: max abs err {err}")
        worst_f32 = max(worst_f32, err)
        xb, wb, bb = x.bfloat16(), wt.bfloat16(), bias.bfloat16()
        rel = bf16_error(xb, wb, bb, f"{cin}->{cout}")
        worst_bf16 = max(worst_bf16, rel)
        # timed at the main path's dtype (bf16), without ReLU, so that the
        # one library call (conv2d with bias) computes the same function
        xn = xb.permute(0, 3, 1, 2)
        ms = cuda_ms(lambda: k1.conv3x3(xb, wb, bb))
        plain_ms = cuda_ms(lambda: k1.conv3x3_plain(xb, wb, bb))
        library_ms = cuda_ms(lambda: F.conv2d(xn, wb, bb, padding=1))
        f32_ms = cuda_ms(lambda: k1.conv3x3(x, wt, bias), iters=3, warmup=1)
        t_bound, by = k1_bound(b, h, w, cin, cout)
        rows.append({"cin": cin, "cout": cout, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": t_bound,
                     "bound_by": by, "f32_max_abs_err": err, "bf16_rel_err": rel,
                     "f32_ms": f32_ms})
        del x, xb, xn, got, want
    torch.cuda.empty_cache()
    print("K1 detail: " + json.dumps({"shape": list(K1_SHAPE), "dtype": "bf16",
                                      "pairs": rows}))

    # every (pair, shape) the two stages' forwards, the heading grid search's
    # forwards (one page each, so the persistent kernel runs another grid)
    # and the segmentation trainer's forward launch, with launches per
    # forward; the trainer also runs K1 in f32 (its card-vs-CPU check), so
    # that path holds both dtypes
    for label, shape in (("K1 main path", K1_SHAPE), ("K1 heading path", K1_HEADING_SHAPE),
                         ("K1 grid path", (1, *K1_HEADING_SHAPE[1:])),
                         ("K1 train path", (SEG_BATCH, *SEG_CROP))):
        instances = []
        for cin, cout, hh, ww, n in k1_main_path_instances(shape):
            x, wt, bias = inputs(cin, cout, hh, ww, shape[0])
            extra = {}
            if label == "K1 train path":
                got = k1.conv3x3(x, wt, bias, relu=True)
                want = k1.conv3x3_plain(x, wt, bias, relu=True)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(err <= 1e-4, f"K1 f32 {cin}->{cout} at {hh}x{ww}: max abs err {err}")
                worst_f32 = max(worst_f32, err)
                extra = {"f32_max_abs_err": err}
                del got, want
            xb, wb, bb = x.bfloat16(), wt.bfloat16(), bias.bfloat16()
            rel = bf16_error(xb, wb, bb, f"{cin}->{cout} at {hh}x{ww}")
            worst_bf16 = max(worst_bf16, rel)
            xn = xb.permute(0, 3, 1, 2)
            instances.append({
                **extra, "cin": cin, "cout": cout, "h": hh, "w": ww, "launches": n,
                "ms": cuda_ms(lambda: k1.conv3x3(xb, wb, bb), iters=20),
                "device_ms": cuda_graph_ms(lambda: k1.conv3x3(xb, wb, bb)),
                "library_ms": cuda_ms(lambda: F.conv2d(xn, wb, bb, padding=1), iters=20),
                "library_device_ms": cuda_graph_ms(lambda: F.conv2d(xn, wb, bb, padding=1)),
                "bound_ms": k1_bound(shape[0], hh, ww, cin, cout)[0], "bf16_rel_err": rel})
            del x, xb, xn
        check(len(instances) == 24 and sum(r["launches"] for r in instances) == 69,
              f"{label}: the instance table does not add up to 69 launches per forward")
        per_forward = {k: sum(r[k] * r["launches"] for r in instances)
                       for k in ("ms", "device_ms", "library_ms", "library_device_ms",
                                 "bound_ms")}
        print(f"{label}: " + json.dumps({"batch": shape[0], "shape": list(shape),
                                         "dtype": "bf16", "instances": instances,
                                         "per_forward": per_forward}))
    grad = k1_grad_check(dev)
    print(f"K1 ok: f32 max abs err {worst_f32:.3g} (<= 1e-4), bf16 max err "
          f"{worst_bf16:.3g} of output scale (<= 2e-2); gradients " + json.dumps(grad))
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                   "bound_ms")}
    return dict(total, max_abs_err=worst_f32,
                bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations")


def k1_grad_check(dev):
    """K1 under autograd (the kernel's forward, the cuDNN backward of
    ``Conv3x3Function``) against autograd through ``F.conv2d``, at one main
    path instance (16 -> 32 at a quarter of ``K1_SHAPE``), with and without
    ReLU: each gradient's max abs error over its largest entry, f32 (TF32
    off) within 1e-5 (db sums 418 thousand products in another order than
    cuDNN's), bf16 within 2e-2. Under ReLU the reference is masked by the
    kernel's own output, as the two forwards may round an output next to 0
    to opposite signs."""
    import torch
    import torch.nn.functional as F
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    b, h, w = K1_SHAPE
    cin, cout, h, w = 16, 32, h // 4, w // 4
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((b, h, w, cin), generator=gen, device=dev)
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (
            2.0 / (9 * cin + cout)) ** 0.5
        bias = 0.1 + 0.02 * torch.randn((cout,), generator=gen, device=dev)
        gy = torch.randn((b, h, w, cout), generator=gen, device=dev)
        for dtype, limit in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            for relu in (True, False):
                ours = [t.detach().to(dtype).clone().requires_grad_() for t in (x, wt, bias)]
                ref = [t.detach().to(dtype).clone().requires_grad_() for t in (x, wt, bias)]
                before = k1.launches
                y = k1.conv3x3(*ours, relu=relu)
                check(k1.launches == before + 1, "K1 under autograd did not launch the kernel")
                y.backward(gy.to(dtype))
                y_ref = F.conv2d(ref[0].permute(0, 3, 1, 2), ref[1], ref[2],
                                 padding=1).permute(0, 2, 3, 1)
                if relu:
                    y_ref = y_ref * (y.detach() > 0)
                y_ref.backward(gy.to(dtype))
                errs = [((a.grad.float() - r.grad.float()).abs().max()
                         / r.grad.float().abs().max()).item() for a, r in zip(ours, ref)]
                name = f"{str(dtype).split('.')[-1]}{'_relu' if relu else ''}"
                out[name] = dict(zip(("dx", "dw", "db"), errs))
                check(max(errs) <= limit, f"K1 gradients {name}: errors {errs} > {limit}")
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return {"instance": [b, h, w, cin, cout], "errors": out}


def k2_input(b, h, w, seed, dev):
    import torch
    pages, _ = synthetic_pages(b, h, w, seed)
    binary = np.stack([np.where(p < 128, 255, 0) for p in pages]).astype(np.uint8)
    return torch.from_numpy(binary).to(dev)


def phase_k2(dev):
    import torch
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.stages.separator import separator_kernel_sizes
    b, h, w = K2_SHAPE
    x = k2_input(b, h, w, 1, dev)
    worst = 0
    wide_kernels = separator_kernel_sizes(h, K2_WIDE_W)
    check(wide_kernels[0] + wide_kernels[2] >= 64, "K2 wide case is not wide")
    for img, kernels in ((x, K2_KERNELS),
                         (k2_input(2, h, K2_WIDE_W, 2, dev), wide_kernels)):
        for dtype in (torch.uint8, torch.float32):
            inp = img.to(dtype)
            got = k2.separator_morphology(inp, *kernels)
            want = k2.separator_morphology_plain(inp, *kernels)
            torch.cuda.synchronize()
            for g, wnt, what in zip(got, want, ("horizontal", "vertical")):
                diff = (g.float() - wnt.float()).abs().max().item()
                check(diff == 0, f"K2 {dtype} {tuple(img.shape)} {kernels}: "
                                 f"{what} differs (max {diff})")
                worst = max(worst, diff)
    print(f"K2 ok: bit-exact at {tuple(x.shape)} {K2_KERNELS} and at width "
          f"{K2_WIDE_W} {wide_kernels}, uint8 and f32")
    ms = cuda_ms(lambda: k2.separator_morphology(x, *K2_KERNELS), iters=20)
    device_ms = cuda_graph_ms(lambda: k2.separator_morphology(x, *K2_KERNELS), iters=50)
    print("K2 detail: " + json.dumps({"shape": list(K2_SHAPE), "kernels": list(K2_KERNELS),
                                      "ms": ms, "device_ms": device_ms}))
    plain_ms = cuda_ms(lambda: k2.separator_morphology_plain(x, *K2_KERNELS))
    n = b * h * w
    # one byte read per pixel, two written; ~4 compares per pixel and pass
    t_bound, by = bound(3 * n, 4 * 4 * n, "bf16")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": t_bound,
            "bound_by": by, "max_abs_err": worst}


def unpack(packed, width):
    return np.unpackbits(packed, axis=-1, count=width).astype(bool)


def phase_main_path(dev):
    import torch
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.models import arunet
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.stages import separator as sep

    n_pages, batch = N_PAGES, BATCH
    pages, rules = synthetic_pages(n_pages, *PAGE_SHAPE, seed=7)
    pred = SegmentationPredictor(
        os.path.join(REPO, "models_ckpt_torch", "separator.npz"),
        dtype=torch.bfloat16, device=dev)
    # warm-up: first-call costs (cuBLAS/cuDNN handles, allocator) off the clock
    sep.SeparatorNetPostProcessor(pages[:batch], pred, fixed_height=FIXED_HEIGHT,
                                  threshold=THRESHOLD).run_batched(batch_size=batch)
    torch.cuda.synchronize()

    proc = sep.SeparatorNetPostProcessor(pages, pred, fixed_height=FIXED_HEIGHT,
                                         threshold=THRESHOLD)
    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    polygons = proc.run_batched(batch_size=batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
    groups = -(-n_pages // batch)
    print(f"main path: {n_pages} pages in {secs:.3f} s = {n_pages / secs:.3f} pages/s; "
          f"launches {launches}")
    check(launches["conv3x3"] == 69 * groups,
          f"K1 launched {launches['conv3x3']} times, want 69 x {groups} forwards")
    check(launches["separator_morphology"] == groups,
          f"K2 launched {launches['separator_morphology']} times, want {groups}")
    check(all(p is not None for p in polygons), "a page produced no result")
    check(all(p["SeparatorRegion_vertical"] for p in polygons),
          "a page has no vertical separator polygon")

    phase = {}
    sep.SeparatorNetPostProcessor(pages, pred, fixed_height=FIXED_HEIGHT,
                                  threshold=THRESHOLD).run_batched(batch, phase=phase)
    print("phases (s, device-synced): " + json.dumps(phase))

    # the same groups through the chain with the kernels, then with the
    # plain versions substituted, for the mask comparison
    fused = sep.make_fused_separator_fn(pred.model)
    h0, w0 = pages[0].shape
    sc = FIXED_HEIGHT / h0
    out_h, out_w = int(h0 * sc), int(w0 * sc)
    kernels = sep.separator_kernel_sizes(out_h, out_w)

    def run_chain():
        outs = []
        for g in range(groups):
            x = torch.from_numpy(np.stack(pages[g * batch:(g + 1) * batch])).to(dev)
            outs.append(fused(x, out_h, out_w, *kernels, threshold=THRESHOLD).cpu().numpy())
        return np.concatenate(outs, axis=1)            # [2, n_pages, H, W/8]

    t0 = time.perf_counter()
    with_kernels = run_chain()
    chain_s = time.perf_counter() - t0
    saved = (arunet.conv3x3, sep.separator_morphology)
    arunet.conv3x3, sep.separator_morphology = (k1.conv3x3_plain,
                                                k2.separator_morphology_plain)
    try:
        t0 = time.perf_counter()
        plain = run_chain()
        plain_chain_s = time.perf_counter() - t0
    finally:
        arunet.conv3x3, sep.separator_morphology = saved
    agree = float((unpack(with_kernels, out_w) == unpack(plain, out_w)).mean())
    print(f"chain: kernels {chain_s:.3f} s, plain versions {plain_chain_s:.3f} s; "
          f"masks agree on {agree:.6f} of pixels")
    check(agree >= 0.999, f"masks agree on only {agree} of pixels (< 0.999)")

    # recall of the column rule: resized rule pixels whose whole footprint
    # lies inside the drawn rule, read from the vertical mask
    recalls = []
    for i, rule in enumerate(rules):
        ys, xs = np.nonzero(rule)
        y0, y1 = int(np.ceil(ys.min() * sc)), int(np.floor((ys.max() + 1) * sc))
        x0, x1 = int(np.ceil(xs.min() * sc)), int(np.floor((xs.max() + 1) * sc))
        vmask = unpack(with_kernels[1, i], out_w)
        recalls.append(float(vmask[y0:y1, x0:x1].mean()))
    print("column-rule recall per page: " + json.dumps(recalls))
    check(min(recalls) >= 0.99, f"column-rule recall {min(recalls)} < 0.99")
    return {"pages_per_s": n_pages / secs, "seconds": secs, "phase": phase,
            "launches": launches, "agree": agree, "recall": min(recalls)}


def write_layout_xml(path, image_name, h, w, regions):
    """The PAGE-XML of a drawn page: one TextRegion per layout region, one
    TextLine (box and baseline 2 px above its bottom) per line."""
    from citlab_as_tpu_torch.pagexml import Page, TextLine, TextRegion
    doc = Page(img_filename=image_name, img_w=w, img_h=h)
    text_regions = []
    for region_id, lines in regions:
        tls = [TextLine(line_id, None, "", [(x0, y1 - 2), (x1, y1 - 2)],
                        [(x0, y0), (x1, y0), (x1, y1), (x0, y1)])
               for line_id, (x0, y0, x1, y1) in lines]
        xs0, ys0, xs1, ys1 = zip(*(box for _, box in lines))
        text_regions.append(TextRegion(
            region_id, None, [(min(xs0), min(ys0)), (max(xs1), min(ys0)),
                              (max(xs1), max(ys1)), (min(xs0), max(ys1))], tls))
    doc.set_text_regions(text_regions)
    doc.write_page_xml(path)


def write_corpus(root, pages, layouts):
    """PNG files plus one PAGE-XML per page under ``root/page``, built with
    the port's own encoder and Page API. Returns the image paths."""
    from citlab_as_tpu_torch.utils.io import save_png
    os.makedirs(os.path.join(root, "page"))
    paths = []
    for i, (page, regions) in enumerate(zip(pages, layouts)):
        h, w = page.shape
        path = os.path.join(root, f"page_{i:02d}.png")
        save_png(path, page)
        write_layout_xml(os.path.join(root, "page", f"page_{i:02d}.xml"),
                         os.path.basename(path), h, w, regions)
        paths.append(path)
    return paths


def rule_recall_from_page(page, rule):
    """Share of the drawn column rule's interior (2 px in from its edges)
    that the page's vertical SeparatorRegions cover."""
    from citlab_as_tpu_torch.geometry.booleans import rasterize_rings
    ys, xs = np.nonzero(rule)
    x0, x1, y0, y1 = xs.min() + 2, xs.max() - 1, ys.min() + 2, ys.max() - 1
    covered = np.zeros((y1 - y0, x1 - x0), bool)
    for region in page.get_regions().get("SeparatorRegion", []):
        if region.get_orientation() == "vertical":
            covered |= rasterize_rings([region.points.points_list], (x0, y0),
                                       covered.shape)
    return float(covered.mean())


def cpu_check_lines(swt_boxes):
    """The lines of one page whose features are redone on the port's CPU
    device, as (tall lines, short lines): the ``HEADLINES_PER_PAGE`` largest
    lines; and every ``CPU_CHECK_EVERY``-th line, the last one, and the largest line
    of each chunk of crops that the card's fixpoint converges together
    (each page's lines start a chunk)."""
    from citlab_as_tpu_torch.ops.swt_device import _STATS_CHUNK
    n = len(swt_boxes)
    area = swt_boxes[:, 2].astype(np.int64) * swt_boxes[:, 3]
    tall = set(np.argsort(-area, kind="stable")[:HEADLINES_PER_PAGE].tolist())
    short = set(range(0, n, CPU_CHECK_EVERY)) | {n - 1}
    short |= {s + int(np.argmax(area[s:s + _STATS_CHUNK])) for s in range(0, n, _STATS_CHUNK)}
    return np.asarray(sorted(tall), np.int64), np.asarray(sorted(short - tall), np.int64)


def phase_files(dev):
    import torch
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops import swt_device
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.ops.swt import StrokeWidthDistanceTransform
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.pagexml.page import page_cache
    from citlab_as_tpu_torch.stages.heading import HeadingNetPostProcessor
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    from citlab_as_tpu_torch.utils import io as port_io

    n_pages, batch = N_PAGES, BATCH
    groups = -(-n_pages // batch)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    cpu_dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_check_")
    cpu_check = None
    try:
        t0 = time.perf_counter()
        pages, rules, layouts = synthetic_newspaper(n_pages, *PAGE_SHAPE, seed=11)
        paths = write_corpus(root, pages, layouts)
        n_lines = [sum(len(lines) for _, lines in lay) for lay in layouts]
        print(f"files: {n_pages} PNG + PAGE-XML written in {time.perf_counter() - t0:.2f} s; "
              f"text lines per page {n_lines}")
        check(all(200 <= n <= 400 for n in n_lines), f"text lines per page {n_lines}")
        sep_pred, head_pred = (SegmentationPredictor(
            os.path.join(REPO, "models_ckpt_torch", f"{net}.npz"),
            dtype=torch.bfloat16, device=dev) for net in ("separator", "heading"))

        def run_both(sep_phase=None, head_phase=None):
            """The two stages as the full workflow chains them; returns
            (seconds of each stage, the heading stage)."""
            port_io._IMAGE_CACHE.clear()
            t0 = time.perf_counter()
            sep = SeparatorNetPostProcessor(paths, sep_pred, fixed_height=FIXED_HEIGHT,
                                            threshold=THRESHOLD)
            sep.run_batched_fused(batch_size=batch, phase=sep_phase)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out_paths = [sep._page_path_for(p) + ".xml" for p in paths]
            with page_cache():
                head = HeadingNetPostProcessor(
                    paths, head_pred, fixed_height=HEADING_FIXED_HEIGHT,
                    page_paths=out_paths, save_suffix="")
                head.run_batched_fused(batch_size=batch, phase=head_phase)
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1, head, out_paths

        run_both()                                   # first-call costs off the clock
        k1.launches = 0
        k2.launches = 0
        swt_device.reset_counts()
        sep_s, head_s, head, out_paths = run_both()
        launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        counts = dict(swt_device.COUNTS)
        print(f"files to files: separator {n_pages / sep_s:.3f} pages/s ({sep_s:.3f} s), "
              f"heading {n_pages / head_s:.3f} pages/s ({head_s:.3f} s), both "
              f"{n_pages / (sep_s + head_s):.3f} pages/s; launches {launches}; "
              f"line-feature sweeps {counts['sweeps']}, host syncs {counts['syncs']}")
        check(launches["conv3x3"] == 69 * 2 * groups,
              f"K1 launched {launches['conv3x3']} times, want 69 x {2 * groups} forwards")
        check(launches["separator_morphology"] == groups,
              f"K2 launched {launches['separator_morphology']} times, want {groups}")

        sep_phase, head_phase = {}, {}
        swt_device.reset_counts()
        run_both(sep_phase, head_phase)
        print("files: separator phases (s, device-synced): " + json.dumps(sep_phase))
        print("files: heading phases (s, device-synced): " + json.dumps(dict(
            head_phase, sweeps=swt_device.COUNTS["sweeps"],
            host_syncs=swt_device.COUNTS["syncs"])))
        # what was written
        recalls, tagged = [], {"headline": [0, 0], "body": [0, 0]}
        for i, out_path in enumerate(out_paths):
            page = Page(out_path)
            check(Page.validate_structural(page.page_doc), f"{out_path} is not valid")
            check(page.get_regions().get("SeparatorRegion"),
                  f"{out_path} has no SeparatorRegion")
            recalls.append(rule_recall_from_page(page, rules[i]))
            lines = page.get_textlines()
            check(len(lines) >= n_lines[i], f"{out_path} lost text lines")
            for tl in lines:
                kind = "headline" if tl.id.startswith("hl_") else "body"
                tagged[kind][0] += tl.get_semantic_type() == "heading"
                tagged[kind][1] += 1
            types = {tr.id: tr.region_type for tr in page.get_text_regions()}
            check(all(t == "heading" for r, t in types.items() if r.startswith("r_hl_")),
                  f"{out_path}: a headline region is not of type heading: {types}")
        print("files: column-rule recall per page " + json.dumps(recalls)
              + f"; tagged heading: {tagged['headline'][0]} of {tagged['headline'][1]} "
              f"headline lines, {tagged['body'][0]} of {tagged['body'][1]} body lines")
        check(min(recalls) >= 0.99, f"column-rule recall {min(recalls)} < 0.99")
        check(tagged["headline"][0] == tagged["headline"][1] >= n_pages * HEADLINES_PER_PAGE,
              f"headline lines tagged heading: {tagged['headline']}")
        check(tagged["body"][0] <= 0.05 * tagged["body"][1],
              f"body lines tagged heading: {tagged['body']}")

        # the card's distance transform and per-line integers against the
        # port's CPU device, on the same pages and the same probability maps:
        # a sample of every page's lines goes through the CPU device in a
        # worker process (cpu_check_start) that runs beside the card's later
        # phases, and every line here against the host path (scipy label per
        # crop) over the card's distance transform, which the worker holds to
        # the CPU's
        t0 = time.perf_counter()
        gpu_features = swt_device.DeviceLineFeatures()
        host_swt = StrokeWidthDistanceTransform()
        checked_host = 0
        for g in range(groups):
            chunk = paths[g * batch:(g + 1) * batch]
            images = [np.asarray(port_io.load_image(p, "L")) for p in chunk]
            _, maps_u8, dt_u8, _ = head.fused_dispatch(images, chunk)
            boxes = [head.line_feature_boxes(
                Page(head._page_path_for(p)).textlines,
                head._writer_for(p).scaling_factor) for p in chunk]
            swt_list, net_list = [b[0] for b in boxes], [b[1] for b in boxes]
            got = gpu_features.dispatch_batch(dt_u8, maps_u8, swt_list, net_list)()
            maps_np, dt_np = maps_u8.cpu().numpy(), dt_u8.cpu().numpy()
            with open(os.path.join(cpu_dir, f"group_{g}.pkl"), "wb") as f:
                pickle.dump({"chunk": chunk, "images": np.stack(images), "dt": dt_np,
                             "maps": maps_np, "swt": swt_list, "net": net_list, "got": got,
                             "picks": [cpu_check_lines(sb) for sb in swt_list]}, f)
            for i, (g_net, g_sw) in enumerate(got):
                for box, sw_th in zip(swt_list[i], g_sw):
                    if box[2] >= 0:
                        check(host_swt.textline_features(dt_np[i], tuple(box)) == tuple(sw_th),
                              f"{chunk[i]}: line at {tuple(box)}: (stroke width, text "
                              f"height) {tuple(sw_th)} differ from the host path")
                        checked_host += 1
                # the summed-area table against plain sums of the same map
                for (bx, by, bw, bh), mean in zip(net_list[i][::8], g_net[::8]):
                    exact = maps_np[i][by:by + bh, bx:bx + bw].sum() / (255.0 * bw * bh)
                    check(abs(mean - exact) <= 1.0 / 255.0,
                          f"{chunk[i]}: net sum off by more than 1 count per pixel")
        cpu_check = cpu_check_start(cpu_dir)
        print(f"files: all {checked_host} lines' (stroke width, text height) from the card "
              f"equal to the host path's over the card's distance transform "
              f"({time.perf_counter() - t0:.1f} s); the CPU device's check of a sample of "
              f"every page's lines runs in worker process {cpu_check['proc'].pid}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if cpu_check is None:
            shutil.rmtree(cpu_dir, ignore_errors=True)
    return {"launches": launches, "cpu_check": cpu_check, "pages_per_s": {
        "separator": n_pages / sep_s, "heading": n_pages / head_s,
        "both": n_pages / (sep_s + head_s)}}


#: torch threads of the CPU-device check's worker process, which shares the
#: host with the card's later phases
CPU_CHECK_THREADS = 4
CPU_CHECK_TIMEOUT = 900                     # seconds from its start to its result


def cpu_check_start(work):
    """Start the CPU-device check of the files phase's pages (the group
    pickles in ``work``) in a worker process of this script; its output goes
    to ``work/log.txt``. :func:`cpu_check_finish` gates its result."""
    log = open(os.path.join(work, "log.txt"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cpu-check", work],
                            stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                            env=dict(os.environ, OMP_NUM_THREADS=str(CPU_CHECK_THREADS)))
    return {"proc": proc, "log": log, "work": work, "start": time.perf_counter()}


def cpu_check_stop(handle):
    """Stop the worker if it still runs and remove its files."""
    if handle["proc"].poll() is None:
        handle["proc"].kill()
    handle["proc"].wait()
    handle["log"].close()
    shutil.rmtree(handle["work"], ignore_errors=True)


def cpu_check_finish(handle):
    """Wait for the CPU-device check (until ``CPU_CHECK_TIMEOUT`` seconds
    after its start) and gate it: the worker exited 0, and the card's
    distance transform and every sampled line's (net sum, 2 x stroke width,
    text height) equal the CPU device's. Prints its line; returns the
    seconds the main process waited for it."""
    t0 = time.perf_counter()
    try:
        remaining = CPU_CHECK_TIMEOUT - (t0 - handle["start"])
        try:
            handle["proc"].wait(timeout=max(remaining, 1.0))
        except subprocess.TimeoutExpired:
            raise Fail(f"files: the CPU-device check outlived {CPU_CHECK_TIMEOUT} s")
        waited = time.perf_counter() - t0
        result_path = os.path.join(handle["work"], "result.json")
        if handle["proc"].returncode != 0 or not os.path.exists(result_path):
            with open(os.path.join(handle["work"], "log.txt")) as f:
                raise Fail(f"files: the CPU-device check exited {handle['proc'].returncode}: "
                           f"{f.read()[-3000:]}")
        with open(result_path) as f:
            result = json.load(f)
    finally:
        cpu_check_stop(handle)
    check(not result["differ"], "files: the card differs from the CPU device: "
                                + "; ".join(result["differ"][:5]))
    print(f"files: distance transform of {result['pages']} pages and {result['checked']} "
          f"lines' (net sum, 2 x stroke width, text height) from all {result['pages']} pages "
          f"equal to the CPU device's, bit for bit (worker process, {CPU_CHECK_THREADS} "
          f"threads, {result['seconds']:.1f} s beside the card's phases: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in result["split"].items())
          + f"; the main process waited {waited:.1f} s for it)")
    return waited


def cpu_check_worker(work):
    """The CPU-device check of the files phase, in a process of its own:
    each group's distance transform recomputed from its pages on the CPU
    (``otsu_binarize``, ``distance_transform_edt``) against the card's,
    then the sampled lines (:func:`cpu_check_lines`: the tall ones and the
    short ones apart, since a chunk of crops costs the CPU what its largest
    line asks for) through the port's CPU device against the card's
    results. Writes ``result.json``."""
    import torch
    sys.path.insert(0, REPO)
    from citlab_as_tpu_torch.ops import swt_device
    from citlab_as_tpu_torch.ops.binarize import otsu_binarize
    from citlab_as_tpu_torch.ops.distance_transform import distance_transform_edt
    torch.set_num_threads(CPU_CHECK_THREADS)
    t0 = time.perf_counter()
    features = swt_device.DeviceLineFeatures()
    split = {"edt": 0.0, "tall lines": 0.0, "short lines": 0.0}
    differ, checked, pages = [], 0, 0
    for name in sorted(n for n in os.listdir(work) if n.startswith("group_")):
        with open(os.path.join(work, name), "rb") as f:
            group = pickle.load(f)
        chunk, got = group["chunk"], group["got"]
        pages += len(chunk)
        t1 = time.perf_counter()
        x = torch.from_numpy(group["images"])
        _, binary = otsu_binarize(255.0 - x.to(torch.float32), blur_ksize=5)
        dt_cpu = distance_transform_edt(binary, cap=255.0).to(torch.uint8)
        split["edt"] += time.perf_counter() - t1
        if not np.array_equal(dt_cpu.numpy(), group["dt"]):
            differ.append(f"{chunk}: the distance transform differs between the card and "
                          "the CPU")
        maps_cpu = torch.from_numpy(group["maps"])
        for kind, picks in zip(("tall lines", "short lines"), zip(*group["picks"])):
            t1 = time.perf_counter()
            want = features.dispatch_batch(
                dt_cpu, maps_cpu,
                [sb[pick] for sb, pick in zip(group["swt"], picks)],
                [nb[pick] for nb, pick in zip(group["net"], picks)])()
            split[kind] += time.perf_counter() - t1
            for i, pick in enumerate(picks):
                if not np.array_equal(got[i][1][pick], want[i][1]):
                    differ.append(f"{chunk[i]}: (stroke width, text height) of {kind}")
                if not np.array_equal(got[i][0][pick], want[i][0]):
                    differ.append(f"{chunk[i]}: net sums of {kind}")
                checked += len(pick)
    with open(os.path.join(work, "result.json"), "w") as f:
        json.dump({"pages": pages, "checked": checked, "differ": differ, "split": split,
                   "seconds": time.perf_counter() - t0}, f)
    return 0


def _delaunay_graph(rng, n):
    """A page graph as the feature stage writes it: n region centres with
    Delaunay edges, 15 node and 2 edge features (random values)."""
    from scipy.spatial import Delaunay
    pts = rng.rand(n, 2) * np.array([1420.0, 2000.0])
    indptr, indices = Delaunay(pts).vertex_neighbor_vertices
    edges = [(v, int(u)) for v in range(n) for u in indices[indptr[v]:indptr[v + 1]]]
    return {"num_nodes": n,
            "node_features": rng.rand(n, 15).astype(np.float32).tolist(),
            "interacting_nodes": edges,
            "edge_features": rng.randint(0, 2, (len(edges), 2)).astype(float).tolist()}


def line_agreement(page, layout):
    """Pairwise same-article agreement of a clustered page's text lines
    with the drawn layout (lines of one drawn region belong together):
    the share of line pairs on which the two agree."""
    truth = {line_id: region for region, lines in layout for line_id, _ in lines}
    lines = [(truth[tl.id], tl.get_article_id()) for tl in page.get_textlines()
             if tl.id in truth]
    same_t = np.array([a[0] == b[0] for i, a in enumerate(lines) for b in lines[i + 1:]])
    same_h = np.array([a[1] == b[1] for i, a in enumerate(lines) for b in lines[i + 1:]])
    return float(np.mean(same_t == same_h)) if len(same_t) else 1.0


def structurally_valid(page):
    """(valid, clamped): ``Page.validate_structural`` of the clustered page.
    The text-region rule (textregion_generation.py) shifts a line's
    baseline up by 0.95 of its interline distance; for a top line whose
    next line is far below (a headline under it) that lands above the page
    edge, and the JAX package writes the same negative y
    (``tests/test_torch_workflow.py::test_text_regions_above_the_page_edge``).
    Such a file is taken as valid when it validates with the y values of
    its TextRegion Coords clamped to 0 (``clamped`` True); any other fault,
    a negative x included, leaves it invalid."""
    import copy
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.pagexml.constants import NS_PAGE_XML
    if Page.validate_structural(page.page_doc):
        return True, False
    doc = copy.deepcopy(page.page_doc)
    for region in doc.getroot().iter(f"{{{NS_PAGE_XML}}}TextRegion"):
        coords = region.find(f"{{{NS_PAGE_XML}}}Coords")
        if coords is not None and coords.get("points"):
            points = [p.split(",") for p in coords.get("points").split()]
            if all(len(p) == 2 and p[1].lstrip("-").isdigit() for p in points):
                coords.set("points", " ".join(f"{x},{max(int(y), 0)}" for x, y in points))
    return Page.validate_structural(doc), True


def phase_workflow(dev):
    """The port's ``run_full_workflow`` from PNG + PAGE-XML files to the
    clustered PAGE-XML, with the converted nets (bf16 ARU-Nets, the f32
    ``gnn`` relation net) and ``clustering_method="dbscan"``."""
    import torch
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages import features
    from citlab_as_tpu_torch.stages.clustering import TextblockClustering
    from citlab_as_tpu_torch.utils import io as port_io

    n_pages, batch = N_PAGES, BATCH
    groups = -(-n_pages // batch)
    root = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    host_swt = features.StrokeWidthDistanceTransform
    host_swt_pages = [0]

    class CountingSWT(host_swt):
        """The feature stage's host SWT, counting the pages whose lines it
        could not take from the heading stage's saved features."""

        def distance_transform(self, *args, **kwargs):
            host_swt_pages[0] += 1
            return super().distance_transform(*args, **kwargs)

    features.StrokeWidthDistanceTransform = CountingSWT
    try:
        pages, _, layouts = synthetic_newspaper(n_pages, *PAGE_SHAPE, seed=11)
        paths = write_corpus(root, pages, layouts)
        npz = os.path.join(REPO, "models_ckpt_torch")
        sep_pred, head_pred = (SegmentationPredictor(
            os.path.join(npz, f"{net}.npz"), dtype=torch.bfloat16, device=dev)
            for net in ("separator", "heading"))
        gnn = RelationPredictor(os.path.join(npz, "gnn.npz"), device=dev)

        def run(timings=None):
            """One workflow over the corpus (the page files are rewritten in
            place run after run); returns (seconds, result)."""
            port_io._IMAGE_CACHE.clear()
            t0 = time.perf_counter()
            result = run_full_workflow(
                paths, separator_predictor=sep_pred, heading_predictor=head_pred,
                gnn_predictor=gnn, clustering_method="dbscan", batch_size=batch,
                separator_fixed_height=FIXED_HEIGHT,
                heading_fixed_height=HEADING_FIXED_HEIGHT, timings=timings,
                device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, result

        run()                                        # first-call costs off the clock
        k1.launches = 0
        k2.launches = 0
        secs, result = run()
        launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        print(f"workflow: {n_pages / secs:.3f} pages/s ({secs:.3f} s for {n_pages} "
              f"pages, {groups} groups of {batch}); launches {launches}; pages whose "
              f"line features the feature stage redid on the host {host_swt_pages[0]}")
        check(launches["conv3x3"] == 69 * 2 * groups,
              f"K1 launched {launches['conv3x3']} times, want 69 x {2 * groups} forwards")
        check(launches["separator_morphology"] == groups,
              f"K2 launched {launches['separator_morphology']} times, want {groups}")
        check(not result["skipped"], f"pages skipped: {result['skipped']}")
        check(host_swt_pages[0] == 0,
              f"the feature stage redid the SWT on the host for {host_swt_pages[0]} pages "
              f"in two runs: the heading stage's line features did not match")
        check(len(result["clustered"]) == n_pages,
              f"{len(result['clustered'])} clustered files for {n_pages} pages")

        timings = {}
        run(timings)
        print("workflow: stage seconds " + json.dumps(timings))

        # what was written
        articles, regions, agreement, clamped = [], [], [], 0
        for path, layout in zip(result["clustered"], layouts):
            page = Page(path)
            valid, negative = structurally_valid(page)
            check(valid, f"{path} is not valid")
            clamped += negative
            lines = page.get_textlines()
            check(lines and all(tl.get_article_id() for tl in lines),
                  f"{path}: a text line has no article id")
            articles.append(len({tl.get_article_id() for tl in lines}))
            regions.append(len(page.get_text_regions()))
            agreement.append(line_agreement(page, layout))
        print(f"workflow: articles per page {articles}, text regions per page "
              f"{regions}; same-article agreement of line pairs with the drawn "
              f"regions {json.dumps([round(a, 4) for a in agreement])}; "
              f"{clamped} of {n_pages} pages valid only with negative TextRegion "
              f"y clamped to 0")

        # the card's relation confidences against the CPU's on the same JSONs
        json_dir = os.path.join(root, "json15d2bb")
        graphs = []
        for path in paths:
            name = os.path.splitext(os.path.basename(path))[0] + ".xml.json"
            with open(os.path.join(json_dir, name)) as f:
                graphs.append(json.load(f))
        cpu = RelationPredictor(os.path.join(npz, "gnn.npz"), device="cpu")
        worst, same_labels = 0.0, True
        for g in range(groups):
            chunk = graphs[g * batch:(g + 1) * batch]
            for c_card, c_cpu in zip(gnn.confidences_batch(chunk), cpu.confidences_batch(chunk)):
                worst = max(worst, float(np.abs(c_card - c_cpu).max()))
                labels = []
                for conf in (c_card, c_cpu):
                    tb = TextblockClustering()
                    tb.set_confs(conf)
                    tb.calc("dbscan")
                    labels.append(list(tb.tb_labels))
                same_labels &= labels[0] == labels[1]
        print(f"workflow: relation confidences card vs CPU max abs {worst:.3g} "
              f"(limit 1e-5) over {n_pages} pages of "
              f"{[g['num_nodes'] for g in graphs]} nodes; dbscan labels equal: {same_labels}")
        check(worst <= 1e-5, f"card vs CPU confidences differ by {worst}")
        check(same_labels, "dbscan labels differ between the card's and the CPU's confidences")
        # the clustered pages go on to the gt_eval phase's comparator
        kept = tempfile.mkdtemp(prefix="chip_smoke_clustered_")
        for path in result["clustered"]:
            shutil.copy(path, kept)
    finally:
        features.StrokeWidthDistanceTransform = host_swt
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "pages_per_s": n_pages / secs, "timings": timings,
            "clustered": [os.path.join(kept, os.path.basename(p)) for p in result["clustered"]],
            "layouts": layouts}


def phase_gnn(dev):
    """The relation GNN's forward alone: one group of 4 graphs at the node
    bucket of 64 with Delaunay edges, converted ``gnn`` weights, f32."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from citlab_as_tpu_torch.inference import RelationPredictor
    rng = np.random.RandomState(5)
    group = [_delaunay_graph(rng, n) for n in (64, 57, 49, 60)]
    pred = RelationPredictor(os.path.join(REPO, "models_ckpt_torch", "gnn.npz"), device=dev)
    inputs, _ = pred._batch_inputs(group)
    pred._ensure_params(inputs)
    eager = cuda_ms(lambda: pred.forward_confidences(inputs), iters=20, warmup=3)
    t0 = time.perf_counter()
    for _ in range(10):
        pred.confidences_batch(group)
    whole = (time.perf_counter() - t0) / 10 * 1e3
    try:
        graph_ms = cuda_graph_ms(lambda: pred.forward_confidences(inputs))
    except Exception as e:  # noqa: BLE001 - reported, not a gate
        graph_ms = f"not capturable ({type(e).__name__}: {e})"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred.forward_confidences(inputs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None
    print(f"gnn: one group of 4 graphs ({[g['num_nodes'] for g in group]} nodes, bucket "
          f"{pred._node_bucket}, edge bucket {pred._edges_bucket}): forward "
          f"{eager:.4f} ms eager, {graph_ms if isinstance(graph_ms, str) else f'{graph_ms:.4f} ms'}"
          f" from a CUDA graph; {len(kernels)} device launches per forward, "
          f"device time {device_ms} ms (torch.profiler); confidences_batch with host "
          f"preparation and readback {whole:.3f} ms")
    return {"eager_ms": eager, "graph_ms": graph_ms, "launches": len(kernels),
            "device_ms": device_ms}


def written_files(root):
    """Every file a workflow wrote under ``root`` (not its inputs: the PNGs
    and the original ``page/<name>.xml``), ``LastChange`` normalised."""
    import re
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if name.endswith(".png") or (os.path.dirname(rel) == "page"
                                         and not name.endswith(".xml.xml")):
                continue
            with open(os.path.join(root, rel), "rb") as f:
                out[rel] = re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>",
                                  f.read())
    return out


def _workflow_runner(dev, paths, gnn):
    """``run(driver, **kw)``: one workflow over ``paths`` with the converted
    ARU-Nets (bf16) and ``gnn``; returns (seconds, result, the kernels'
    launches counted from 0 just before the run, timings). The page files
    are rewritten in place run after run."""
    import torch
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.utils import io as port_io
    sep_pred, head_pred = (SegmentationPredictor(
        os.path.join(REPO, "models_ckpt_torch", f"{net}.npz"), dtype=torch.bfloat16,
        device=dev) for net in ("separator", "heading"))

    def run(driver, **kw):
        port_io._IMAGE_CACHE.clear()
        timings = {}
        k1.launches = 0
        k2.launches = 0
        t0 = time.perf_counter()
        result = driver(paths, separator_predictor=sep_pred, heading_predictor=head_pred,
                        gnn_predictor=gnn, clustering_method="dbscan", batch_size=BATCH,
                        separator_fixed_height=FIXED_HEIGHT,
                        heading_fixed_height=HEADING_FIXED_HEIGHT, timings=timings,
                        device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        return secs, result, launches, timings
    return run


def check_workflow_run(label, result, launches, groups, n_pages):
    """The gates every driver run shares: no page skipped, a clustered
    file per page with an article id on every text line, K1 69 x 2 and K2
    one launch per page group."""
    from citlab_as_tpu_torch.pagexml import Page
    check(not result["skipped"], f"{label}: pages skipped: {result['skipped']}")
    check(len(result["clustered"]) == n_pages,
          f"{label}: {len(result['clustered'])} clustered files for {n_pages} pages")
    for path in result["clustered"]:
        lines = Page(path).get_textlines()
        check(lines and all(tl.get_article_id() for tl in lines),
              f"{label}: {path}: a text line has no article id")
    check(launches["conv3x3"] == 69 * 2 * groups,
          f"{label}: K1 launched {launches['conv3x3']} times, want 69 x {2 * groups}")
    check(launches["separator_morphology"] == groups,
          f"{label}: K2 launched {launches['separator_morphology']} times, want {groups}")


def phase_pipelined(dev):
    """The sequential and the wave-pipelined workflow on 16 pages, with the
    host tail in the parent and over spawned workers."""
    from citlab_as_tpu_torch.cli.run_full_workflow import (
        run_full_workflow, run_full_workflow_pipelined)
    from citlab_as_tpu_torch.inference import RelationPredictor

    from citlab_as_tpu_torch.utils import workers as port_workers

    n_pages = N_PIPE_PAGES
    groups = -(-n_pages // BATCH)
    workers = min(4, (os.cpu_count() or 2) - 1)
    # the corpus stays for the parallel and spatial phases; main deletes it
    root = tempfile.mkdtemp(prefix="chip_smoke_pipelined_")
    kept = False
    # seconds of each wave's host tail over the worker pool: the first
    # wave's includes waiting for the workers' start-up
    map_items, pool_waves = port_workers.PersistentPool.map_items, []

    def timed_map_items(self, items):
        t0 = time.perf_counter()
        out = map_items(self, items)
        pool_waves.append(round(time.perf_counter() - t0, 4))
        return out
    port_workers.PersistentPool.map_items = timed_map_items
    try:
        pages, _, layouts = synthetic_newspaper(n_pages, *PAGE_SHAPE, seed=13)
        paths = write_corpus(root, pages, layouts)
        run = _workflow_runner(dev, paths, RelationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "gnn.npz"), device=dev))
        rates, timings_seen, reference, launches_seen = {}, {}, None, {}
        for label, driver, kw in (
                ("sequential", run_full_workflow, {}),
                ("pipelined", run_full_workflow_pipelined, {"host_workers": 0}),
                (f"pipelined, {workers} workers", run_full_workflow_pipelined,
                 {"host_workers": workers})):
            rates[label] = []
            for attempt in range(2):
                secs, result, launches, timings = run(driver, **kw)
                rates[label].append(n_pages / secs)
                if attempt:
                    continue
                check_workflow_run(label, result, launches, groups, n_pages)
                launches_seen[label] = launches
                files = written_files(root)
                if reference is None:
                    reference = files
                    check(sum(f.endswith("_clustering.xml") for f in files) == n_pages,
                          f"{label}: clustered files missing")
                    continue
                check(set(files) == set(reference),
                      f"{label}: wrote {sorted(set(files) ^ set(reference))[:4]} "
                      "unlike the sequential driver")
                differ = sorted(f for f in files if files[f] != reference[f])
                check(not differ, f"{label}: {len(differ)} files differ from the "
                                  f"sequential driver's, e.g. {differ[:3]}")
                check(PIPELINED_TIMINGS <= set(timings),
                      f"{label}: timings keys {sorted(timings)}")
                timings_seen[label] = timings
        print(f"pipelined: {n_pages} pages, {groups} groups of {BATCH}; all "
              f"{len(reference)} written files of both pipelined runs byte-equal to "
              f"the sequential run's; launches " + json.dumps(launches_seen))
        print("pipelined: pages/s (two runs each) " + json.dumps(rates))
        for label, timings in timings_seen.items():
            print(f"pipelined: timings ({label}) " + json.dumps(timings))
        print(f"pipelined: host tail per wave over {workers} workers, s (two runs of "
              f"{groups} waves) " + json.dumps(pool_waves))
        kept = True
    finally:
        port_workers.PersistentPool.map_items = map_items
        if not kept:
            shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches_seen["pipelined"], "pages_per_s": rates,
            "timings": timings_seen, "corpus": (root, paths, reference)}


def phase_visual(dev):
    """The workflow's 8 pages with the converted visual relation net,
    sequential and pipelined; its confidences against the port's CPU
    device; its forward timed alone."""
    import glob

    import torch
    from torch.profiler import ProfilerActivity, profile
    from citlab_as_tpu_torch.cli.run_full_workflow import (
        run_full_workflow, run_full_workflow_pipelined)
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.stages.clustering import TextblockClustering
    from citlab_as_tpu_torch.utils import io as port_io

    n_pages = N_PAGES
    groups = -(-n_pages // BATCH)
    npz = os.path.join(REPO, "models_ckpt_torch", "gnn_visual.npz")
    root = tempfile.mkdtemp(prefix="chip_smoke_visual_")
    try:
        pages, _, layouts = synthetic_newspaper(n_pages, *PAGE_SHAPE, seed=11)
        paths = write_corpus(root, pages, layouts)
        gnn = RelationPredictor(npz, device=dev, **VISUAL_KW)
        run = _workflow_runner(dev, paths, gnn)
        seconds, launches_seen, written = {}, {}, {}
        for label, driver in (("sequential", run_full_workflow),
                              ("pipelined", run_full_workflow_pipelined)):
            secs, result, launches, _ = run(driver)
            check_workflow_run(f"visual {label}", result, launches, groups, n_pages)
            seconds[label], launches_seen[label] = secs, launches
            written[label] = written_files(root)
        differ = sorted(f for f in written["sequential"]
                        if written["pipelined"].get(f) != written["sequential"][f])
        check(set(written["pipelined"]) == set(written["sequential"]) and not differ,
              f"visual: pipelined files differ from the sequential ones: {differ[:3]}")
        json_dirs = glob.glob(os.path.join(root, "json*"))
        check(len(json_dirs) == 1 and "v" in os.path.basename(json_dirs[0]),
              f"visual: feature JSON directories {json_dirs} (want one of visual regions)")
        print(f"visual: {n_pages} pages, sequential {n_pages / seconds['sequential']:.3f} "
              f"pages/s, pipelined {n_pages / seconds['pipelined']:.3f} pages/s; all "
              f"{len(written['sequential'])} written files byte-equal; launches "
              + json.dumps(launches_seen))

        graphs, images = [], []
        for path in paths:
            name = os.path.splitext(os.path.basename(path))[0] + ".xml.json"
            with open(os.path.join(json_dirs[0], name)) as f:
                graphs.append(json.load(f))
            images.append(np.asarray(port_io.load_image(path, "L")))
        cpu = RelationPredictor(npz, device="cpu", **VISUAL_KW)
        worst, same_labels = 0.0, True
        k1.launches = 0
        for g in range(groups):
            sl = slice(g * BATCH, (g + 1) * BATCH)
            for c_card, c_cpu in zip(gnn.confidences_batch(graphs[sl], images[sl]),
                                     cpu.confidences_batch(graphs[sl], images[sl])):
                worst = max(worst, float(np.abs(c_card - c_cpu).max()))
                labels = []
                for conf in (c_card, c_cpu):
                    tb = TextblockClustering()
                    tb.set_confs(conf)
                    tb.calc("dbscan")
                    labels.append(list(tb.tb_labels))
                same_labels &= labels[0] == labels[1]
        check(k1.launches == 0, f"visual: the visual forward launched K1 {k1.launches} times")
        print(f"visual: confidences card vs CPU max abs {worst:.3g} (limit "
              f"{VISUAL_CONF_TOL}) over {n_pages} pages of "
              f"{[g['num_nodes'] for g in graphs]} nodes; dbscan labels equal: "
              f"{same_labels}; K1 launches from the visual forward: {k1.launches}")
        check(worst <= VISUAL_CONF_TOL, f"visual: card vs CPU confidences differ by {worst}")
        check(same_labels, "visual: dbscan labels differ between card and CPU")

        # one group's forward alone (backbone at 384 x 384, pooling, GNN)
        inputs, _ = gnn._batch_inputs(graphs[:BATCH], images[:BATCH])
        eager = cuda_ms(lambda: gnn.forward_confidences(inputs), iters=10, warmup=2)
        t0 = time.perf_counter()
        for _ in range(3):
            gnn.confidences_batch(graphs[:BATCH], images[:BATCH])
        whole = (time.perf_counter() - t0) / 3 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gnn.forward_confidences(inputs)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None
        print(f"visual: forward of one group of {BATCH} pages (image "
              f"{tuple(inputs['image'].shape[1:3])}, node bucket {gnn._node_bucket}): "
              f"{eager:.4f} ms eager (CUDA events), device time {device_ms} ms over "
              f"{len(kernels)} device launches (torch.profiler); confidences_batch with "
              f"host preparation (image resize) and readback {whole:.3f} ms")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches_seen["pipelined"], "eager_ms": eager,
            "device_ms": device_ms, "max_abs_err": worst}


def png_header_bytes(w, h):
    """A grey PNG of w x h pixels whose image data holds one row: a header
    a decoder must refuse before it allocates the image."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(w + 1))) + chunk(b"IEND", b""))


def _normalised_xml(path):
    """A PAGE-XML file's bytes with ``LastChange`` and ``imageFilename``
    blanked: what a page's separator output owes to its pixels alone."""
    import re
    with open(path, "rb") as f:
        data = f.read()
    data = re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>", data)
    return re.sub(rb'imageFilename="[^"]*"', b'imageFilename=""', data)


def _median_ms(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_formats(dev):
    """The committed JPEG / TIFF page fixtures (tests/data/torch_formats,
    made by scripts/make_format_fixtures.py): the host decoder against
    PIL's recorded digests, then the port's stage CLIs over the pages on
    the card, then the port's AS measure against the drawn layout."""
    import glob
    import hashlib

    import torch
    from citlab_as_tpu_torch.cli import (
        run_baseline_clustering, run_feature_generation, run_gnn_clustering, run_measure,
        run_net_post_processing, run_textregion_generation)
    from citlab_as_tpu_torch.eval.measure import BaselineMeasureEval, get_data_from_pagexml
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages.clustering import TextblockClustering
    from citlab_as_tpu_torch.utils import io as port_io

    records = []
    for path in sorted(glob.glob(os.path.join(FORMATS_DIR, "*.json"))):
        with open(path) as f:
            records.append(json.load(f))
    check(len(records) == 6, f"formats: {len(records)} fixtures in {FORMATS_DIR}, want 6")
    npz = os.path.join(REPO, "models_ckpt_torch")
    root = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    try:
        # 1. decode: PIL's size and the sha256 of its "L" bytes, ms per page
        os.makedirs(os.path.join(root, "page"))
        fixtures, twins, decode_ms = [], [], {}
        for rec in records:
            name = os.path.splitext(rec["file"])[0]
            src = os.path.join(FORMATS_DIR, rec["file"])
            path = os.path.join(root, rec["file"])
            shutil.copy(src, path)
            shutil.copy(os.path.join(FORMATS_DIR, "page", f"{name}.xml"),
                        os.path.join(root, "page", f"{name}.xml"))
            size = port_io.image_size(path)
            check(list(size) == rec["size"], f"formats: {rec['file']} size {size}, PIL "
                  f"says {rec['size']}")
            grey = port_io.load_image(path, "L")
            digest = hashlib.sha256(np.ascontiguousarray(grey).tobytes()).hexdigest()
            check(digest == rec["sha256_L"], f"formats: {rec['file']} decodes to other "
                  f"pixels than PIL's ({digest} != {rec['sha256_L']})")
            twin = os.path.join(root, f"twin_{name}.png")
            port_io.save_png(twin, grey)
            shutil.copy(os.path.join(FORMATS_DIR, "page", f"{name}.xml"),
                        os.path.join(root, "page", f"twin_{name}.xml"))

            def load(p):
                port_io._IMAGE_CACHE.clear()
                return port_io.load_image(p, "L")
            decode_ms[rec["file"]] = {"ms": _median_ms(lambda: load(path)),
                                      "png_twin_ms": _median_ms(lambda: load(twin)),
                                      "bytes": os.path.getsize(path),
                                      "png_twin_bytes": os.path.getsize(twin)}
            fixtures.append(path)
            twins.append(twin)
        print("formats: decode ms per page (median of 3, host) beside the PNG of the "
              "same pixels " + json.dumps(decode_ms))
        print(f"formats: all {len(records)} fixtures decode to PIL's size and 'L' digest")

        def write_list(name, lines):
            path = os.path.join(root, name)
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            return path

        def promote(images):
            for image in images:
                page = port_io.get_page_path(image)
                os.replace(page + ".xml", page)

        def valid_pages(paths, what):
            for path in paths:
                valid, _ = structurally_valid(Page(path))
                check(valid, f"formats: {what} wrote an invalid page {path}")

        pages = [port_io.get_page_path(p) for p in fixtures]
        stage_s, launches = {}, {}

        def stage(label, fn, *args):
            port_io._IMAGE_CACHE.clear()
            k1.launches = 0
            k2.launches = 0
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stage_s[label] = time.perf_counter() - t0
            launches[label] = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
            return out

        # 2. the stage CLIs in the workflow's order, on the card
        both = fixtures + twins
        groups = -(-len(both) // BATCH)
        stage("separator", run_net_post_processing.main, [
            "--path_to_image_list", write_list("separator.lst", both), "--mode", "separator",
            "--model", os.path.join(npz, "separator.npz"), "--batch_size", str(BATCH),
            "--fixed_height", str(FIXED_HEIGHT), "--device", str(dev)])
        check(launches["separator"] == {"conv3x3": 69 * groups, "separator_morphology": groups},
              f"formats: separator launches {launches['separator']}, want K1 69 x {groups} "
              f"and K2 {groups}")
        valid_pages([port_io.get_page_path(p) + ".xml" for p in both], "the separator")
        separators = {}
        for image, twin in zip(fixtures, twins):
            a = _normalised_xml(port_io.get_page_path(image) + ".xml")
            b = _normalised_xml(port_io.get_page_path(twin) + ".xml")
            check(a == b, f"formats: the separator's page of {os.path.basename(image)} "
                  "differs from its PNG twin's")
            separators[os.path.basename(image)] = a.count(b"<SeparatorRegion")
        print("formats: the separator's pages equal their PNG twins'; SeparatorRegions "
              "per page " + json.dumps(separators))
        promote(fixtures)

        groups = -(-len(fixtures) // BATCH)
        stage("heading", run_net_post_processing.main, [
            "--path_to_image_list", write_list("heading.lst", fixtures), "--mode", "heading",
            "--model", os.path.join(npz, "heading.npz"), "--batch_size", str(BATCH),
            "--fixed_height", str(HEADING_FIXED_HEIGHT), "--device", str(dev)])
        check(launches["heading"] == {"conv3x3": 69 * groups, "separator_morphology": 0},
              f"formats: heading launches {launches['heading']}, want K1 69 x {groups}")
        valid_pages([p + ".xml" for p in pages], "the heading stage")
        promote(fixtures)

        page_list = write_list("pages.lst", pages)
        check(stage("baselines", run_baseline_clustering.main,
                    ["--path_to_xml_lst", page_list]) == [], "formats: baseline clustering "
              "skipped pages")
        check(stage("regions", run_textregion_generation.main,
                    ["--path_to_xml_lst", page_list]) == [], "formats: text regions skipped "
              "pages")
        valid_pages(pages, "the host stages")
        jsons = stage("features", run_feature_generation.main,
                      ["--pagexml_list", page_list, "--out_path", os.path.join(root, "json")])
        check(len(jsons) == len(pages), f"formats: {len(jsons)} feature files")
        cwd = os.getcwd()
        os.chdir(root)      # the clustering pages land beside page/ under the CWD
        try:
            clustered = stage("gnn_clustering", run_gnn_clustering.main, [
                "--eval_list", write_list("jsons.lst", jsons), "--model",
                os.path.join(npz, "gnn.npz"), "--clustering_method", "dbscan",
                "--out_dir", "", "--device", str(dev)])
        finally:
            os.chdir(cwd)
        clustered = [os.path.join(root, p) for p in clustered]
        check(len(clustered) == len(pages), f"formats: {len(clustered)} clustered pages")
        valid_pages(clustered, "the GNN clustering")
        for path in clustered:
            lines = Page(path).get_textlines()
            check(lines and all(tl.get_article_id() for tl in lines),
                  f"formats: {path}: a text line has no article id")
        print("formats: stage CLI seconds " + json.dumps(stage_s) + "; launches "
              + json.dumps(launches))

        # card vs CPU relation confidences on the written JSONs
        graphs = []
        for path in jsons:
            with open(path) as f:
                graphs.append(json.load(f))
        card = RelationPredictor(os.path.join(npz, "gnn.npz"), device=dev)
        cpu = RelationPredictor(os.path.join(npz, "gnn.npz"), device="cpu")
        worst, same_labels = 0.0, True
        for c_card, c_cpu in zip(card.confidences_batch(graphs), cpu.confidences_batch(graphs)):
            worst = max(worst, float(np.abs(c_card - c_cpu).max()))
            labels = []
            for conf in (c_card, c_cpu):
                tb = TextblockClustering()
                tb.set_confs(conf)
                tb.calc("dbscan")
                labels.append(list(tb.tb_labels))
            same_labels &= labels[0] == labels[1]
        print(f"formats: relation confidences card vs CPU max abs {worst:.3g} (limit 1e-5); "
              f"dbscan labels equal: {same_labels}")
        check(worst <= 1e-5, f"formats: card vs CPU confidences differ by {worst}")
        check(same_labels, "formats: dbscan labels differ between card and CPU")

        # 3. the AS measure against GT written from the drawn layout: each
        # line's article is its drawn region
        gt_dir = os.path.join(root, "gt", "page")
        os.makedirs(gt_dir)
        gts = []
        for rec in records:
            name = os.path.splitext(rec["file"])[0]
            page = Page(os.path.join(FORMATS_DIR, "page", f"{name}.xml"))
            lines = []
            for region in page.get_text_regions():
                for tl in region.text_lines:
                    tl.set_article_id(region.id)
                    lines.append(tl)
            page.set_textline_attr(lines)
            gts.append(os.path.join(gt_dir, f"{name}.xml"))
            page.write_page_xml(gts[-1])
        t0 = time.perf_counter()
        result = run_measure.main(["--path_to_gt_xml_lst", write_list("gt.lst", gts),
                                   "--path_to_hy_xml_lst", write_list("hy.lst", clustered)])
        measure_s = time.perf_counter() - t0
        check(result["counts"][2] == len(gts), f"formats: the measure counted {result['counts']}")
        worst_metric = 0.0
        for gt, hy in list(zip(sorted(gts), sorted(clustered)))[:FORMATS_METRIC_PAGES]:
            truth = [p for ps in get_data_from_pagexml(gt).values() for p in ps]
            reco = [p for ps in get_data_from_pagexml(hy).values() for p in ps]
            evals = []
            for native in (True, False):
                ev = BaselineMeasureEval(-1, -1)
                ev.calc_measure_for_page_baseline_polys(truth, reco, use_native=native)
                evals.append(ev.measure.result)
            for attr in ("page_wise_per_dist_tol_tick_per_line_precision",
                         "page_wise_per_dist_tol_tick_per_line_recall"):
                a, b = getattr(evals[0], attr)[0], getattr(evals[1], attr)[0]
                check(a.shape == b.shape, f"formats: gk_calc_metric {attr} shape")
                worst_metric = max(worst_metric, float(np.abs(a - b).max()))
        check(worst_metric <= 1e-9, f"formats: gk_calc_metric differs from numpy by "
              f"{worst_metric}")
        as_r, as_p, as_f = result["as"]
        print(f"formats: AS measure over {len(gts)} pages (run_measure, dynamic tolerances, "
              f"{measure_s:.3f} s): R {as_r:.6f} P {as_p:.6f} F {as_f:.6f}; baseline "
              f"detection {json.dumps(result['bd'])}; gk_calc_metric vs numpy max abs "
              f"{worst_metric:.3g} on {FORMATS_METRIC_PAGES} pages (limit 1e-9)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": {k: sum(launches[stage][k] for stage in launches)
                         for k in ("conv3x3", "separator_morphology")},
            "decode_ms": decode_ms, "stage_s": stage_s, "as": result["as"]}


def phase_variants(dev):
    """The PNM, PNG, TIFF, JPEG, BMP, GIF, WebP, JPEG 2000, raster (PCX,
    DCX, PSD, TGA, ICO, CUR, DIB, SGI, SUN, QOI, MSP, IM, XBM, XPM, PIXAR,
    SPIDER, GBR, IMT, MCIDAS, XVTHUMB) and registry (DDS, BLP, FTEX, ICNS,
    FITS, FLI, IPTC) variants: the committed small variant fixtures against
    PIL's recorded digests, full-size pages of the variants through the
    pipelined workflow beside 8-bit PNG twins of the same decoded pixels
    (among them the main path's formats under damage and at the edges of
    PIL's table, and a PNG header past PIL's decompression-bomb limit,
    which the workflow skips), and PBM, BMP, GIF, WebP, JPEG 2000, PCX, DCX,
    TGA, PSD, SGI, SUN, QOI, DDS (uncompressed and BC1) and FITS pages
    through the separator CLI."""
    import glob
    import hashlib

    from citlab_as_tpu_torch.cli import run_net_post_processing
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow_pipelined
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.utils import io as port_io
    from scripts.format_variants import (
        bmp_bytes, bmp_rle_bytes, gif_bytes, png_bytes, pnm_bytes, raster_pages)
    from scripts.registry_variants import registry_pages

    def digest(arr):
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()

    def load(p):
        port_io._IMAGE_CACHE.clear()
        return port_io.load_image(p, "L")

    def decode_row(path, twin):
        """Host decode ms of a page (median of 3) beside its PNG twin's."""
        return {"ms": _median_ms(lambda: load(path)),
                "png_twin_ms": _median_ms(lambda: load(twin)),
                "bytes": os.path.getsize(path), "png_twin_bytes": os.path.getsize(twin)}

    # 1. every small variant decodes to PIL's size and "L" / "RGB" bytes
    with open(os.path.join(VARIANTS_DIR, "small", "small.json")) as f:
        small = json.load(f)
    check(len(small) >= 100, f"variants: {len(small)} small fixtures")
    for rec in small:
        path = os.path.join(VARIANTS_DIR, "small", rec["file"])
        check(list(port_io.image_size(path)) == rec["size"],
              f"variants: {rec['file']} size differs from PIL's {rec['size']}")
        for mode in ("L", "RGB"):
            port_io._IMAGE_CACHE.clear()
            check(digest(port_io.load_image(path, mode)) == rec[f"sha256_{mode}"],
                  f"variants: {rec['file']} decodes to other {mode} pixels than PIL's")
    kinds = sorted({rec["file"].split("_")[0].split(".")[0] for rec in small})
    check({"bmp", "gif", "jpeg", "webp", "jpeg2000", "pcx", "dcx", "psd", "tga", "ico", "cur",
           "dib", "sgi", "sun", "qoi", "msp", "im", "xbm", "xpm", "pixar", "spider", "gbr", "imt",
           "mcidas", "xvthumb", "dds", "blp", "ftex", "icns", "fits", "fli", "iptc",
           "avif"} <= set(kinds),
          f"variants: small fixtures of {kinds}")
    print(f"variants: all {len(small)} small {' / '.join(kinds)} variants decode to PIL's "
          "size and 'L' and 'RGB' digests")

    root = tempfile.mkdtemp(prefix="chip_smoke_variants_")
    try:
        os.makedirs(os.path.join(root, "page"))
        pages, _, layouts = synthetic_newspaper(3, *PAGE_SHAPE, seed=31)
        # (file, the oracle of its "L" pixels: an array or PIL's digest); the
        # PNG pages come from the test encoders (filters at random), a 16-bit
        # one holding the 8-bit values
        variants = []
        for name, page, depth, interlace in (("adam7.png", pages[0], 8, True),
                                             ("grey16.png", pages[1], 16, False)):
            with open(os.path.join(root, name), "wb") as f:
                f.write(png_bytes(page[..., None], 0, depth, interlace, seed=31))
            variants.append((name, page))
        for rec_path, layout in zip(sorted(glob.glob(os.path.join(VARIANTS_DIR, "*.json"))),
                                    layouts):
            with open(rec_path) as f:
                rec = json.load(f)
            shutil.copy(os.path.join(VARIANTS_DIR, rec["file"]), os.path.join(root, rec["file"]))
            stem = os.path.splitext(rec["file"])[0]
            shutil.copy(os.path.join(VARIANTS_DIR, "page", f"{stem}.xml"),
                        os.path.join(root, "page", f"{stem}.xml"))
            variants.append((rec["file"], rec["sha256_L"]))
        check(len(variants) == 5, f"variants: {len(variants)} full-size pages, want 5")
        # the JPEG pages: their "L" and "RGB" digests (a pair of oracles)
        for rec_path in sorted(glob.glob(os.path.join(JPEG_VARIANTS_DIR, "*.json"))):
            with open(rec_path) as f:
                rec = json.load(f)
            shutil.copy(os.path.join(JPEG_VARIANTS_DIR, rec["file"]),
                        os.path.join(root, rec["file"]))
            stem = os.path.splitext(rec["file"])[0]
            shutil.copy(os.path.join(JPEG_VARIANTS_DIR, "page", f"{stem}.xml"),
                        os.path.join(root, "page", f"{stem}.xml"))
            variants.append((rec["file"], (rec["sha256_L"], rec["sha256_RGB"])))
        check(len(variants) == 10, f"variants: {len(variants)} full-size pages, want 10")
        # the main path's formats under damage and at the edges of PIL's
        # table: a JPEG PIL decodes through libjpeg-turbo's recovery of
        # changed entropy-coded bytes, an RGBA JPEG-in-TIFF, separate YCbCr
        # planes under LZW and a palette page with alpha ("PA"); PIL's "L"
        # and "RGB" digests
        for rec_path in sorted(glob.glob(os.path.join(MAIN_FORMATS_DIR, "*.json"))):
            with open(rec_path) as f:
                rec = json.load(f)
            shutil.copy(os.path.join(MAIN_FORMATS_DIR, rec["file"]),
                        os.path.join(root, rec["file"]))
            stem = os.path.splitext(rec["file"])[0]
            shutil.copy(os.path.join(MAIN_FORMATS_DIR, "page", f"{stem}.xml"),
                        os.path.join(root, "page", f"{stem}.xml"))
            variants.append((rec["file"], (rec["sha256_L"], rec["sha256_RGB"])))
        check(len(variants) == 14, f"variants: {len(variants)} full-size pages, want 14")
        for (name, _), page, layout in zip(variants[:2], pages, layouts):
            write_layout_xml(os.path.join(root, "page", f"{os.path.splitext(name)[0]}.xml"),
                             name, *page.shape, layout)
        paths, decode_ms = [], {}
        for name, oracle in variants:
            path = os.path.join(root, name)
            stem = os.path.splitext(name)[0]
            check(port_io.image_size(path) == PAGE_SHAPE[::-1],
                  f"variants: {name} size {port_io.image_size(path)}")
            grey = port_io.load_image(path, "L")
            if isinstance(oracle, tuple):
                check(digest(grey) == oracle[0]
                      and digest(port_io.load_image(path, "RGB")) == oracle[1],
                      f"variants: {name} decodes to other 'L' or 'RGB' pixels than the "
                      "recorded ones")
            elif isinstance(oracle, str):
                check(digest(grey) == oracle, f"variants: {name} decodes to other pixels "
                      "than PIL's")
            else:
                check(np.array_equal(grey, oracle), f"variants: {name} decodes to other "
                      "pixels than the array written")
            twin = os.path.join(root, f"twin_{stem}.png")
            port_io.save_png(twin, grey)
            shutil.copy(os.path.join(root, "page", f"{stem}.xml"),
                        os.path.join(root, "page", f"twin_{stem}.xml"))
            decode_ms[name] = decode_row(path, twin)
            paths += [path, twin]
        print(f"variants: the {len(variants)} full-size pages decode to their oracles; host "
              "decode ms per page (median of 3) beside the PNG twin's " + json.dumps(decode_ms))

        # a PNG header past PIL's decompression-bomb limit, among the pages:
        # refused by image_size, and skipped by the workflow with a logged
        # UnsupportedImageFormat while the other pages are written
        bomb = os.path.join(root, "bomb.png")
        with open(bomb, "wb") as f:
            f.write(png_header_bytes(*BOMB_SHAPE[::-1]))
        shutil.copy(os.path.join(root, "page", "adam7.xml"), os.path.join(root, "page", "bomb.xml"))
        try:
            port_io.image_size(bomb)
            check(False, "variants: image_size of the bomb page does not raise")
        except port_io.UnsupportedImageFormat as e:
            check("decompression-bomb" in str(e), f"variants: bomb page refused with {e}")

        # 2. the pipelined workflow over the variants and their twins
        run = _workflow_runner(dev, paths + [bomb], RelationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "gnn.npz"), device=dev))
        secs, result, launches, _ = run(run_full_workflow_pipelined, host_workers=0)
        skipped = result["skipped"]
        check(len(skipped) == 1 and os.path.basename(skipped[0]["page"]) == "bomb.png"
              and skipped[0]["stage"] == "load"
              and skipped[0]["error"].startswith("UnsupportedImageFormat"),
              f"variants: skipped {skipped}, want the bomb page alone at load")
        result = dict(result, skipped=[])
        check_workflow_run("variants", result, launches, -(-len(paths) // BATCH), len(paths))
        clustered = dict(zip(paths, result["clustered"]))
        for name, _ in variants:
            stem = os.path.splitext(name)[0]
            a = _normalised_xml(clustered[os.path.join(root, name)])
            b = _normalised_xml(clustered[os.path.join(root, f"twin_{stem}.png")])
            check(a == b, f"variants: the clustered page of {name} differs from its PNG "
                  "twin's")
        print(f"variants: pipelined workflow over {len(paths)} pages in {secs:.3f} s "
              f"({len(paths) / secs:.3f} pages/s), launches {json.dumps(launches)}; every "
              "variant's _clustering.xml equals its PNG twin's; the bomb page skipped: "
              f"{skipped[0]['error'][:120]}")

        # 3. a PBM page, an RLE8 BMP page (a grey-ramp palette: PIL's "L")
        # and an interlaced GIF page (a palette of greys that is not the
        # identity: PIL's "P"), written by the test encoders from the
        # generator's arrays, through the separator CLI (they do not reach
        # the workflow's page lookup), each beside its twin
        black = pages[2] < 128
        ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
        cli_pages = [
            ("bilevel.pbm", pnm_bytes(b"P4", PAGE_SHAPE[1], PAGE_SHAPE[0], None, black),
             np.where(black, 0, 255).astype(np.uint8), layouts[2]),
            ("rle8.bmp", bmp_bytes(pages[0], 8, palette=ramp, compression=1,
                                   rle_body=bmp_rle_bytes(pages[0], False, seed=31)),
             pages[0], layouts[0]),
            ("interlaced.gif", gif_bytes(255 - pages[1], ramp[::-1], interlace=True),
             pages[1], layouts[1])]
        # the raster formats, written byte by byte from the same arrays (all
        # lossless): 8-bit grey PCX runs, a DCX of two bilevel pages (PIL
        # reads the first), grey TGA RLE, grey PSD PackBits, grey SGI RLE,
        # 8-bit SUN RLE and the grey page as RGB QOI
        raster = raster_pages(pages)
        cli_pages += [(name, data, want, layouts[k % 3])
                      for k, (name, data, want) in enumerate(raster)]
        # the registry's formats written byte by byte from the same arrays:
        # an uncompressed luminance DDS and an 8-bit FITS (rows bottom-up)
        registry = registry_pages(pages)
        cli_pages += [(name, data, want, layouts[k % 3])
                      for k, (name, data, want) in enumerate(registry)]
        cli_paths = []
        for name, data, want, layout in cli_pages:
            path = os.path.join(root, name)
            stem = os.path.splitext(name)[0]
            with open(path, "wb") as f:
                f.write(data)
            check(port_io.image_size(path) == PAGE_SHAPE[::-1],
                  f"variants: {name} size {port_io.image_size(path)}")
            grey = port_io.load_image(path, "L")
            check(np.array_equal(grey, want),
                  f"variants: the {name} page decodes to other pixels than the array written")
            twin = os.path.join(root, f"twin_{stem}.png")
            port_io.save_png(twin, grey)
            write_layout_xml(os.path.join(root, "page", f"{stem}.xml"), name, *PAGE_SHAPE,
                             layout)
            shutil.copy(os.path.join(root, "page", f"{stem}.xml"),
                        os.path.join(root, "page", f"twin_{stem}.xml"))
            if not name.endswith(".pbm"):
                decode_ms[name] = decode_row(path, twin)
            cli_paths += [path, twin]
        # the committed full-size WebP pages (lossy, lossless, lossy with a
        # filtered VP8L alpha plane), JPEG 2000 pages (lossy 9/7 RPCL tiles
        # with PLT, lossless 5/3, lossy colour with the ICT) and the BC1 DDS
        # page PIL's writer made, held to PIL's recorded "L" and "RGB"
        # digests, through the same CLI run
        webp_names, jpeg2000_names, texture_names, avif_names = [], [], [], []
        for pages_dir, names in ((WEBP_DIR, webp_names), (JPEG2000_DIR, jpeg2000_names),
                                 (REGISTRY_DIR, texture_names), (AVIF_DIR, avif_names)):
            for rec_path in sorted(glob.glob(os.path.join(pages_dir, "*.json"))):
                with open(rec_path) as f:
                    rec = json.load(f)
                name, stem = rec["file"], os.path.splitext(rec["file"])[0]
                path = os.path.join(root, name)
                shutil.copy(os.path.join(pages_dir, name), path)
                check(port_io.image_size(path) == PAGE_SHAPE[::-1],
                      f"variants: {name} size {port_io.image_size(path)}")
                for mode in ("L", "RGB"):
                    port_io._IMAGE_CACHE.clear()
                    check(digest(port_io.load_image(path, mode)) == rec[f"sha256_{mode}"],
                          f"variants: the {name} page decodes to other {mode} pixels than "
                          "PIL's")
                twin = os.path.join(root, f"twin_{stem}.png")
                port_io.save_png(twin, port_io.load_image(path, "L"))
                for s in (stem, f"twin_{stem}"):
                    shutil.copy(os.path.join(pages_dir, "page", f"{stem}.xml"),
                                os.path.join(root, "page", f"{s}.xml"))
                decode_ms[name] = decode_row(path, twin)
                names.append(name)
                cli_paths += [path, twin]
        check(len(webp_names) == 3, f"variants: {len(webp_names)} WebP pages, want 3")
        check(len(jpeg2000_names) == 3,
              f"variants: {len(jpeg2000_names)} JPEG 2000 pages, want 3")
        check(len(texture_names) == 1, f"variants: {len(texture_names)} BC1 DDS pages, want 1")
        # the AVIF pages: PIL's defaults (palette and IntraBC), speed 8
        # (palette), a scanned copy (deblocked), the scan with loop
        # restoration and CDEF, the scan under superres; the noisy scan with
        # film grain, the scan as a grid of 512 x 512 tiles, an avis
        # sequence's first frame, premultiplied alpha
        check(len(avif_names) == 9, f"variants: {len(avif_names)} AVIF pages, want 9")
        image_list = os.path.join(root, "cli.lst")
        with open(image_list, "w") as f:
            f.write("".join(f"{p}\n" for p in cli_paths))
        port_io._IMAGE_CACHE.clear()
        k1.launches = 0
        k2.launches = 0
        run_net_post_processing.main([
            "--path_to_image_list", image_list, "--mode", "separator", "--model",
            os.path.join(REPO, "models_ckpt_torch", "separator.npz"), "--batch_size",
            str(BATCH), "--fixed_height", str(FIXED_HEIGHT), "--device", str(dev)])
        cli_launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        groups = -(-len(cli_paths) // BATCH)
        check(len(cli_paths) == 56 and groups == 14,
              f"variants: {len(cli_paths)} separator CLI pages in {groups} groups, want 56 in 14")
        check(cli_launches == {"conv3x3": 69 * groups, "separator_morphology": groups},
              f"variants: separator CLI launches {cli_launches}, want K1 69 and K2 1 per "
              f"group of {groups}")
        for name in ([p[0] for p in cli_pages] + webp_names + jpeg2000_names + texture_names
                     + avif_names):
            path = os.path.join(root, name)
            twin = os.path.join(root, f"twin_{os.path.splitext(name)[0]}.png")
            check(_normalised_xml(port_io.get_page_path(path) + ".xml")
                  == _normalised_xml(port_io.get_page_path(twin) + ".xml"),
                  f"variants: the separator's page of {name} differs from its PNG twin's")
        print("variants: the separator CLI's pages of the PBM, BMP, GIF, the three WebP, "
              "the three JPEG 2000, the seven raster, the three registry (DDS "
              "uncompressed and BC1, FITS) and the nine AVIF pages equal their PNG twins', "
              f"launches {json.dumps(cli_launches)} ({groups} groups of {BATCH}); host decode "
              "ms per page (median of 3) beside the PNG twin's " + json.dumps(
                  {k: decode_ms[k]
                   for k in ["rle8.bmp", "interlaced.gif"] + webp_names + jpeg2000_names
                   + [name for name, _, _ in raster] + [name for name, _, _ in registry]
                   + texture_names + avif_names}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": {k: launches[k] + cli_launches[k]
                         for k in ("conv3x3", "separator_morphology")},
            "decode_ms": decode_ms, "pages_per_s": len(paths) / secs}


def phase_blind(dev):
    """The blind article-quality oracles on the card: the committed pages of
    the JAX package's three blind tests (tests/data/torch_blind, made by
    scripts/make_blind_fixtures.py; article ids stripped from the input)
    through run_full_workflow in bf16 through K1, scored by the port's AS
    measure against the generators' ground truth at the JAX tests' floors.
    The same pages with the ARU-Nets in f32 are measured beside, printed."""
    import torch
    from citlab_as_tpu_torch.cli import run_measure
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.utils import io as port_io

    npz = os.path.join(REPO, "models_ckpt_torch")
    with open(os.path.join(BLIND_DIR, "blind.json")) as f:
        sets = json.load(f)
    readings, launches = {}, {"conv3x3": 0, "separator_morphology": 0}
    for kind, spec in sets.items():
        for dtype in ("bf16", "f32"):
            root = tempfile.mkdtemp(prefix=f"chip_smoke_blind_{kind}_")
            try:
                os.makedirs(os.path.join(root, "page"))
                images, gts = [], []
                for name in spec["pages"]:
                    images.append(os.path.join(root, f"{name}.png"))
                    shutil.copy(os.path.join(BLIND_DIR, f"{name}.png"), images[-1])
                    shutil.copy(os.path.join(BLIND_DIR, "page", f"{name}.xml"),
                                os.path.join(root, "page", f"{name}.xml"))
                    gts.append(os.path.join(BLIND_DIR, "gt", "page", f"{name}.xml"))
                sizes = {port_io.image_size(p) for p in images}
                gnn = os.path.join(npz, spec["gnn"])
                kw = ({"gnn_predictor": RelationPredictor(gnn, device=dev, **VISUAL_KW)}
                      if kind == "visual" else {"gnn_model_path": gnn})
                if dtype == "f32":
                    kw.update({f"{net}_predictor": SegmentationPredictor(
                        os.path.join(npz, f"{net}.npz"), dtype=torch.float32, device=dev)
                        for net in ("separator", "heading")})
                else:     # the predictors the paths make: the port's default, bf16
                    kw.update(separator_model_path=os.path.join(npz, "separator.npz"),
                              heading_model_path=os.path.join(npz, "heading.npz"))
                port_io._IMAGE_CACHE.clear()
                k1.launches = 0
                k2.launches = 0
                t0 = time.perf_counter()
                result = run_full_workflow(images, clustering_method="dbscan",
                                           out_dir=os.path.join(root, "out"), device=dev, **kw)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counted = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
                check(not result["skipped"] and len(result["clustered"]) == len(images),
                      f"blind {kind} {dtype}: pages skipped {result['skipped']}")
                lists = []
                for name, lines in (("gt.lst", gts), ("hy.lst", result["clustered"])):
                    lists.append(os.path.join(root, name))
                    with open(lists[-1], "w") as f:
                        f.write("\n".join(lines) + "\n")
                out = run_measure.main(["--path_to_gt_xml_lst", lists[0],
                                        "--path_to_hy_xml_lst", lists[1],
                                        "--min_tol", "10", "--max_tol", "30"])
            finally:
                shutil.rmtree(root, ignore_errors=True)
            readings[f"{kind} {dtype}"] = {"as": [float(x) for x in out["as"]],
                                           "bd": [float(x) for x in out["bd"]],
                                           "s": round(secs, 3), "launches": counted}
            if dtype == "bf16":
                # one page group per page size (the skewed pages differ)
                groups = len(sizes)
                check(counted == {"conv3x3": 69 * 2 * groups, "separator_morphology": groups},
                      f"blind {kind}: launches {counted}, want K1 69 x 2 x {groups} and K2 "
                      f"{groups}")
                for k in launches:
                    launches[k] += counted[k]
    print("blind: AS / BD (R, P, F) per set, bf16 gated, f32 beside "
          + json.dumps(readings))
    for kind, spec in sets.items():
        got = readings[f"{kind} bf16"]
        check(got["as"][2] > spec["as_f1"], f"blind {kind}: AS F1 {got['as'][2]} not above "
              f"{spec['as_f1']} in bf16 (f32: {readings[f'{kind} f32']['as'][2]})")
        if "bd_f1" in spec:
            check(got["bd"][2] > spec["bd_f1"], f"blind {kind}: baseline-detection F1 "
                  f"{got['bd'][2]} not above {spec['bd_f1']}")
    print("blind: every set above its floor in bf16 through K1 ("
          + ", ".join(f"{k} AS F1 > {v['as_f1']}" for k, v in sets.items()) + ")")
    return {"launches": launches, "readings": readings}


GT_DIR = os.path.join(REPO, "tests", "data", "torch_gt")


def gt_record_dir(root):
    """{relative path: {size, sha256_L} or {text}} of every file under
    ``root``, images decoded by the port's own decoders (PNG in Python,
    JPEG by the host C++ decoder) in mode "L": the shape of
    ``tests/data/torch_gt/digests.json``."""
    import hashlib
    from citlab_as_tpu_torch.utils.io import load_image
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".png", ".jpg")):
                grey = np.asarray(load_image(path, "L"))
                out[rel] = {"size": [int(grey.shape[1]), int(grey.shape[0])],
                            "sha256_L": hashlib.sha256(grey.tobytes()).hexdigest()}
            else:
                with open(path, encoding="utf-8") as f:
                    out[rel] = {"text": f.read()}
    return dict(sorted(out.items()))


def run_gt_generators(image_paths, work, dev, half_resolution, seconds=None):
    """The port's counterparts of ``scripts/make_gt_fixtures.py``'s runs:
    {run: :func:`gt_record_dir` of its output}, and the AS CLI's done count.
    The region and BNL generators are host code; the AS CLI runs its Otsu
    pass and dilation on ``dev``. ``seconds`` receives each run's wall
    seconds."""
    from citlab_as_tpu_torch.cli import run_as_gt_generation
    from citlab_as_tpu_torch.stages.bnl_ground_truth import (
        BNLGroundTruthGenerator, BNLHeaderGroundTruthGenerator)
    from citlab_as_tpu_torch.stages.ground_truth import RegionGroundTruthGenerator
    from citlab_as_tpu_torch.utils.io import get_page_path
    runs = {
        "region": (RegionGroundTruthGenerator, {}),
        "region_sep": (RegionGroundTruthGenerator, {"region_types": ["SeparatorRegion"]}),
        "region_half": (RegionGroundTruthGenerator,
                        {"max_resolution": tuple(half_resolution)}),
        "bnl": (BNLGroundTruthGenerator, {}),
        "bnl_header": (BNLHeaderGroundTruthGenerator, {}),
    }
    seconds = {} if seconds is None else seconds
    records = {}
    for run, (cls, kwargs) in runs.items():
        out = os.path.join(work, run)
        t0 = time.perf_counter()
        gen = cls(image_paths, **kwargs)
        gen.run_ground_truth_generation(out)
        if cls is RegionGroundTruthGenerator:
            gen.create_ground_truth_json(out)
        seconds[run] = time.perf_counter() - t0
        records[run] = gt_record_dir(out)
    lst = _write_list(os.path.join(work, "pages.lst"),
                      [get_page_path(p) for p in image_paths])
    out = os.path.join(work, "as")
    argv = ["--pagexml_list", lst, "--save_folder", out]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    done = run_as_gt_generation.main(argv)
    seconds["as"] = time.perf_counter() - t0
    records["as"] = gt_record_dir(out)
    return records, done


def compare_gt_records(want, got):
    """The first difference between two :func:`gt_record_dir` maps, or
    None."""
    for run in want:
        if run not in got:
            return f"{run}: not run"
        if sorted(want[run]) != sorted(got[run]):
            return (f"{run}: files {sorted(set(want[run]) ^ set(got[run]))} "
                    "written by one side only")
        for rel, entry in want[run].items():
            if got[run][rel] != entry:
                return f"{run}/{rel}: {got[run][rel]} != {entry}"
    return None


def _write_list(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_seg_gt(root, n, shape, seed):
    """A segmentation GT directory of drawn pages, in the layout the JAX
    package's GT generators write and ``train/seg_input_pipeline.py``
    reads: the grey page ``<name>.png`` and ``C3/<name>_GT0.png`` (the
    column rule) and ``C3/<name>_GT1.png`` (other)."""
    from citlab_as_tpu_torch.utils.io import save_png
    pages, rules = synthetic_pages(n, *shape, seed=seed)
    os.makedirs(os.path.join(root, "C3"))
    for i, (page, rule) in enumerate(zip(pages, rules)):
        name = f"page_{i:02d}"
        save_png(os.path.join(root, f"{name}.png"), page)
        save_png(os.path.join(root, "C3", f"{name}_GT0.png"), rule.astype(np.uint8) * 255)
        save_png(os.path.join(root, "C3", f"{name}_GT1.png"), (~rule).astype(np.uint8) * 255)
    return root


class StepLog:
    """Wraps ``make_train_step`` / ``make_eval_step`` of a trainer module so
    that every step it runs is logged: its loss, its K1 launches and its
    wall time up to a device sync (the trainers read every loss back, so
    the sync adds no wait)."""

    def __init__(self, module, names, dev):
        import torch
        from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
        self.module, self.names, self.steps = module, names, []
        self.originals = {n: getattr(module, n) for n in names}
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

        def recording(kind, maker):
            def make(*args):
                step = maker(*args)

                def run(*a, **kw):
                    before, t0 = k1.launches, time.perf_counter()
                    out = step(*a, **kw)
                    sync()
                    loss = out["loss"] if isinstance(out, dict) else out
                    self.steps.append({"kind": kind, "s": time.perf_counter() - t0,
                                       "k1": k1.launches - before, "loss": float(loss)})
                    return out
                return run
            return make

        for n in names:
            setattr(module, n, recording(n.split("_")[1], self.originals[n]))

    def restore(self):
        for n, fn in self.originals.items():
            setattr(self.module, n, fn)

    def of(self, kind):
        return [s for s in self.steps if s["kind"] == kind]


def _union_ms(intervals):
    total, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1e3


LABEL = "optimizer_update"


def profile_train_step(step, params, opt_state, batch, dev, classify=None):
    """One train step under ``torch.profiler``: its device time split into
    K1's forward (the kernel by name), the backward of the K1-routed convs
    (every kernel under ``Conv3x3FunctionBackward``: cuDNN's dgrad and
    wgrad, the ReLU mask, the bias sum), the other convs and transposed
    convs forward and backward, the optimizer update (a ``record_function``
    range around it, ``LABEL``), the rest (with its heaviest ops) and what
    the profiler links to no op; the step's wall under the profiler, and
    the device's idle share of it. ``classify``, given the op and its
    ancestors (recorded with their input shapes), may name another part
    first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=classify is not None) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # record_function also leaves a device-side annotation range of its name,
    # spanning its kernels on the device timeline: a label, not device work
    device = [e for e in events if e.device_type.name == "CUDA"
              and e.name != LABEL and not getattr(e, "is_user_annotation", False)]
    total_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3

    def category(e):
        chain = []
        while e is not None:
            chain.append(e)
            e = e.cpu_parent
        names = [c.name for c in chain]
        if classify is not None and classify(chain):
            return classify(chain)
        if any("Conv3x3FunctionBackward" in n for n in names):
            return "k1_backward"
        if LABEL in names:
            return "optimizer"
        if any(n.startswith(("aten::convolution", "aten::_convolution", "aten::cudnn_conv"))
               or "ConvolutionBackward" in n for n in names):
            return "other_convs"
        return "rest"

    k1_fwd = [e for e in device if "conv3x3_" in e.name]
    split = dict.fromkeys(("k1_forward", "k1_backward", "other_convs", "optimizer",
                           "rest"), 0.0)
    split["k1_forward"] = sum(e.time_range.elapsed_us() for e in k1_fwd) / 1e3
    rest = {}
    for e in events:
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        cat = category(e)
        for kern in e.kernels:
            if "conv3x3_" in kern.name or kern.name == LABEL:
                continue
            split[cat] = split.get(cat, 0.0) + kern.duration / 1e3
            if cat == "rest":
                t, n = rest.get(e.name, (0.0, 0))
                rest[e.name] = (t + kern.duration / 1e3, n + 1)
    # device time no op claimed (the kernel-to-op link is the profiler's)
    split["unattributed"] = total_ms - sum(split.values())
    top_rest = sorted(([k, t, n] for k, (t, n) in rest.items()), key=lambda r: -r[1])[:12]
    by_name = {}
    for e in device:
        t, n = by_name.get(e.name[:60], (0.0, 0))
        by_name[e.name[:60]] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    top_kernels = sorted(([k, t, n] for k, (t, n) in by_name.items()),
                         key=lambda r: -r[1])[:8]
    busy_ms = _union_ms([(e.time_range.start, e.time_range.end) for e in device])
    return {"wall_ms": wall_ms, "device_ms": total_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "launches": len(device),
            "k1_launches": len(k1_fwd),
            "rest_launches": sum(n for _, n in rest.values()),
            "split_ms": split, "rest_by_op_ms": top_rest, "top_kernels_ms": top_kernels}


def host_bytes(value):
    """A leaf's bytes on the host (a bf16 tensor's 16-bit patterns)."""
    import torch
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        value = value.numpy()
    value = np.asarray(value)
    return value.dtype.str, value.shape, value.tobytes()


def check_written(label, path, live):
    """The orbax checkpoint the port wrote at ``path`` (no ``checkpoint.npz``
    in it) read back by the port's reader equal to ``live``, the tree it
    was written from, bit for bit; returns the number of arrays."""
    from citlab_as_tpu_torch.train import orbax
    check(orbax.is_orbax_checkpoint(path) and "checkpoint.npz" not in os.listdir(path),
          f"{label}: {path} is not an orbax checkpoint")
    got, want = orbax.named_arrays(orbax.restore(path)), orbax.named_arrays(live)
    check(sorted(got) == sorted(want), f"{label}: {path} holds other arrays than written")
    bad = [k for k in want if host_bytes(got[k]) != host_bytes(want[k])]
    check(not bad, f"{label}: {path} reads back other values at {bad[:3]}")
    return len(want)


def train_segmentation(dev, root):
    """The segmentation trainer at the separator net's full width (ARU,
    featRoot 8, 5 scales, res_depth 3), bf16 compute with float32 weights,
    4 x 512 x 512 crops of drawn pages, from the converted separator
    weights."""
    import torch
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.models.arunet import _Conv
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train import seg_trainer
    from citlab_as_tpu_torch.train.input_pipeline import torch_batch
    from citlab_as_tpu_torch.train.segmentation import make_train_step
    from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict, load_npz

    gt = write_seg_gt(os.path.join(root, "seg_gt"), SEG_GT_PAGES, TRAIN_PAGE_SHAPE, seed=31)
    init = load_npz(os.path.join(REPO, "models_ckpt_torch", "separator.npz"))
    flags = {"epochs": 1, "batch_size": SEG_BATCH, "crop_size": SEG_CROP}
    log = StepLog(seg_trainer, ("make_train_step", "make_eval_step"), dev)
    try:
        # 1. f32 (TF32 off): card against CPU, same init, same batches
        losses = {}
        for name, d, dtype in (("card", dev, torch.float32),
                               ("cpu", torch.device("cpu"), torch.float32)):
            log.steps.clear()
            t0 = time.perf_counter()
            seg_trainer.TrainerSegmentation(
                os.path.join(root, f"seg_{name}"), gt,
                flags=dict(flags, steps_per_epoch=SEG_CHECK_STEPS), seed=0, device=d,
                compute_dtype=dtype, init_params=init).train()
            losses[name] = [s["loss"] for s in log.of("train")]
            print(f"train: segmentation f32 on the {name}: {SEG_CHECK_STEPS} steps in "
                  f"{time.perf_counter() - t0:.2f} s, losses {losses[name]}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]
        print(f"train: segmentation f32 card vs CPU losses, relative {[f'{r:.3g}' for r in rel]}"
              f" (limit 1e-4)")
        check(len(rel) == SEG_CHECK_STEPS and max(rel) <= 1e-4,
              f"train: segmentation card vs CPU losses differ by {rel}")

        # 2. bf16, as the trainer runs: warm-up steps off the clock, then timed
        log.steps.clear()
        k1.launches = k2.launches = 0
        steps = SEG_WARM_STEPS + SEG_TIMED_STEPS
        model_dir = os.path.join(root, "seg_bf16")
        trainer = seg_trainer.TrainerSegmentation(
            model_dir, gt, eval_gt_dir=gt,
            flags=dict(flags, steps_per_epoch=steps, eval_steps=SEG_EVAL_STEPS), seed=0,
            device=dev, init_params=init)
        result = trainer.train()
        launches_train = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        train, evals = log.of("train"), log.of("eval")
        bf16 = [s["loss"] for s in train]
        check(len(train) == steps and len(evals) == SEG_EVAL_STEPS,
              f"train: {len(train)} train and {len(evals)} eval steps logged")
        check(all(s["k1"] == 69 for s in train + evals),
              f"train: K1 launches per step {[s['k1'] for s in train + evals]}, want 69")
        check(launches_train == {"conv3x3": 69 * (steps + SEG_EVAL_STEPS),
                                 "separator_morphology": 0},
              f"train: launches in the bf16 run {launches_train}")
        check(all(np.isfinite(bf16)), f"train: bf16 losses {bf16}")
        first = abs(bf16[0] - losses["card"][0]) / abs(losses["card"][0])
        check(first <= 2e-2, f"train: bf16 first loss {bf16[0]} vs f32 {losses['card'][0]}")
        timed_s = sum(s["s"] for s in train[SEG_WARM_STEPS:])
        steps_per_s = SEG_TIMED_STEPS / timed_s
        print(f"train: segmentation bf16, batch {SEG_BATCH} x {SEG_CROP[0]} x {SEG_CROP[1]}: "
              f"{steps_per_s:.3f} steps/s ({SEG_TIMED_STEPS} steps after {SEG_WARM_STEPS} "
              f"off the clock; per step ms {[round(s['s'] * 1e3, 2) for s in train]}); "
              f"K1 launches 69 per train step and per eval step, "
              f"{launches_train['conv3x3']} in all; "
              f"losses {[round(v, 5) for v in bf16]}; first loss vs f32 {first:.3g} (limit "
              f"2e-2); eval {json.dumps({k: v for k, v in result['history'][-1].items()})}; "
              f"trainer seconds {json.dumps({k: round(v, 3) for k, v in trainer.timings.items()})}")
        state = result["state"]
        live = ckpt.trainer_state(state["params"], state["opt_state"], state["ema"],
                                  arunet_flax_from_state_dict)
        best = ckpt.best_path(model_dir, "accuracy")
        n_step = check_written("train", os.path.join(model_dir, "0"), live)
        n_best = check_written("train", best, live["params"])
        pred = SegmentationPredictor(best, device=dev)
        probs = pred(synthetic_pages(1, 512, 384, seed=3)[0][0].astype(np.float32) / 255.0)
        check(probs.shape == (512, 384, 2) and np.isfinite(probs).all(),
              "train: the exported separator does not predict")
        print(f"train: the segmentation trainer's orbax step ({n_step} arrays) and "
              f"best/accuracy ({n_best}) read back equal to its live state bit for bit; "
              f"best/accuracy served by SegmentationPredictor")

        # 3. one step under the profiler, and the weight cast + repack cost
        class Labelled:
            def __init__(self, opt):
                self.opt = opt

            def step(self, *args):
                from torch.profiler import record_function
                with record_function(LABEL):
                    return self.opt.step(*args)

        batch = torch_batch(next(trainer.train_ds.batches(SEG_BATCH, 1)), dev)
        prof = profile_train_step(make_train_step(trainer.model, Labelled(trainer.optimizer)),
                                  state["params"], state["opt_state"], batch, dev)
        # the profiler slows the host: the idle share of an unprofiled step
        # takes the timed steps' mean wall
        prof["idle_share_of_timed_step"] = 1.0 - prof["device_busy_ms"] / (
            timed_s / SEG_TIMED_STEPS * 1e3)
        print("train: one bf16 segmentation step under torch.profiler: " + json.dumps(prof))
        k1_weights = [m.weight for m in trainer.model.modules()
                      if isinstance(m, _Conv) and m.use_k1]
        casts = [w.to(torch.bfloat16) for w in k1_weights]
        params = list(trainer.model.parameters())
        repack = {"k1_weights": len(k1_weights),
                  "pack_ms": cuda_ms(lambda: [k1.pack_weights(w) for w in casts]),
                  "cast_all_params_ms": cuda_ms(lambda: [p.to(torch.bfloat16) for p in params]),
                  "packs_per_forward": len(k1_weights),
                  "packs_per_forward_if_cast_per_conv": 69}
        print("train: weight cast and K1 repack per forward: " + json.dumps(repack))
    finally:
        log.restore()
    return {"launches": launches_train, "steps_per_s": steps_per_s, "profile": prof,
            "repack": repack, "f32_rel": max(rel), "first_bf16_rel": first}


ARTICLES = {"r_hl_0": "a0", "r_col_0": "a0", "r_hl_1": "a1", "r_col_1": "a1",
            "r_hl_2": "a2", "r_col_2": "a2", "r_col_3": "a2"}


def gnn_corpus(root):
    """Feature JSONs with ``gt_relations`` from the port's feature stage, on
    drawn pages cut into paragraph regions of ``GNN_PARAGRAPH_LINES`` lines
    (25-33 regions a page, as a newspaper page has dozens), whose PAGE-XML gives
    each line the article of its drawn region: a headline and the
    sub-column under it, the last two sub-columns one article."""
    from citlab_as_tpu_torch.cli import run_feature_generation
    from citlab_as_tpu_torch.pagexml import Page
    pages, _, layouts = synthetic_newspaper(GNN_PAGES, *TRAIN_PAGE_SHAPE, seed=37)
    paragraphs = []
    for regions in layouts:
        cut = []
        for region_id, lines in regions:
            for k in range(0, len(lines), GNN_PARAGRAPH_LINES):
                cut.append((f"{region_id}_p{k // GNN_PARAGRAPH_LINES}",
                            lines[k:k + GNN_PARAGRAPH_LINES]))
        paragraphs.append(cut)
    images = write_corpus(root, pages, paragraphs)
    xmls = []
    for image in images:
        path = os.path.join(root, "page", os.path.basename(image)[:-4] + ".xml")
        page = Page(path)
        lines = []
        for region in page.get_text_regions():
            for tl in region.text_lines:
                tl.set_article_id(ARTICLES[region.id.rsplit("_p", 1)[0]])
                lines.append(tl)
        page.set_textline_attr(lines)
        page.write_page_xml(path)
        xmls.append(path)
    jsons = run_feature_generation.main([
        "--pagexml_list", _write_list(os.path.join(root, "pages.lst"), xmls),
        "--out_path", os.path.join(root, "json")])
    check(len(jsons) == GNN_PAGES, f"train: {len(jsons)} feature JSONs")
    nodes = []
    for path in jsons:
        with open(path) as f:
            graph = json.load(f)
        nodes.append(graph["num_nodes"])
        check(graph.get("gt_num_relations", 0) > graph["num_nodes"],
              f"train: {path} has no same-article pairs")
    print(f"train: {len(jsons)} feature JSONs of {nodes} regions")
    return sorted(jsons)


def train_gnn(dev, root):
    """The relation-GNN trainer at the ``gnn`` checkpoint's width (15 node
    and 2 edge features, 3 transitions, width 32), from its converted
    weights, on feature JSONs of drawn pages."""
    import torch
    from citlab_as_tpu_torch.cli import run_lav
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train.input_pipeline import torch_batch
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    from citlab_as_tpu_torch.weights import gnn_flax_from_state_dict, load_npz

    jsons = gnn_corpus(os.path.join(root, "gnn_corpus"))
    train, evl = jsons[:-2], jsons[-2:]
    init = load_npz(os.path.join(REPO, "models_ckpt_torch", "gnn.npz"))
    losses, trained = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        trainer = TrainerGNN(os.path.join(root, f"gnn_{name}"), train, [],
                             flags={"epochs": 1, "samples_per_epoch": 16 * GNN_CHECK_STEPS},
                             seed=0, device=d, init_params=init)
        result = trainer.train()
        check(all(p.device.type == d.type for p in result["state"]["params"].values()),
              f"train: the {name} GNN trainer's parameters are not on {d}")
        losses[name] = result["history"][0]["loss"]
        trained[name] = {k: v.detach().cpu() for k, v in result["state"]["params"].items()}
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    param_diff = max(float((trained["card"][k] - v).abs().max()) for k, v in trained["cpu"].items())
    print(f"train: relation GNN card vs CPU, mean loss of {GNN_CHECK_STEPS} steps "
          f"{losses['card']!r} / {losses['cpu']!r}, relative {rel:.3g} (limit 1e-5); "
          f"parameters after them max abs {param_diff:.3g} apart")
    check(rel <= 1e-5, f"train: GNN card vs CPU losses differ by {rel}")

    model_dir = os.path.join(root, "gnn_epoch")
    trainer = TrainerGNN(model_dir, train, evl,
                         flags={"epochs": 1, "samples_per_epoch": GNN_EPOCH_SAMPLES},
                         seed=0, device=dev, init_params=init)
    result = trainer.train()
    state = result["state"]
    live = ckpt.trainer_state(state["params"], state["opt_state"], state["ema"],
                              gnn_flax_from_state_dict)
    n_step = check_written("train", os.path.join(model_dir, "0"), live)
    n_best = check_written("train", ckpt.best_path(model_dir, "f1"), live["params"])
    print(f"train: the relation-GNN trainer's orbax step ({n_step} arrays) and best/f1 "
          f"({n_best}) read back equal to its live state bit for bit")
    steps = trainer.steps_per_epoch
    steps_per_s = steps / trainer.timings["steps"]
    print(f"train: relation GNN one epoch (batch 16, 300 relations, {steps} steps): "
          f"{steps_per_s:.3f} steps/s of train step; trainer seconds "
          f"{json.dumps({k: round(v, 3) for k, v in trainer.timings.items()})}; "
          f"{json.dumps(result['history'][0])}")
    lav = run_lav.main(["--model_dir", model_dir, "--eval_list",
                        _write_list(os.path.join(root, "eval.lst"), evl)])
    check(np.isfinite(lav["best_f1"]), f"train: run_lav best_f1 {lav['best_f1']}")
    batch_np, _, graph = next(trainer.input_fn.eval_batches(evl[:1]))
    n = int(graph["num_nodes"])
    want = trainer.predict(torch_batch(batch_np, dev)).cpu().numpy()[0, :n * n].reshape(n, n)
    got = RelationPredictor(ckpt.best_path(model_dir, "f1"), device=dev).confidences(graph)
    worst = float(np.abs(got - want).max())
    print(f"train: run_lav best_f1 {lav['best_f1']:.4f}; best/f1 in RelationPredictor vs "
          f"the trainer's confidences max abs {worst:.3g} (limit 1e-5)")
    check(worst <= 1e-5, f"train: exported GNN confidences differ by {worst}")
    return {"steps_per_s": steps_per_s, "card_vs_cpu_rel": rel, "best_f1": lav["best_f1"],
            "train_list": train, "eval_list": evl}


def phase_train(dev):
    """Training on the card: the segmentation trainer and the relation-GNN
    trainer (see the module docstring, phase 11), then both training CLIs
    with no ``--device`` flag."""
    import torch
    from citlab_as_tpu_torch.cli import run_train_gnn, run_train_segmentation
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        seg = train_segmentation(dev, root)
        gnn = train_gnn(dev, root)
        t0 = time.perf_counter()
        out = run_train_segmentation.main([
            "--model_dir", os.path.join(root, "cli_seg"), "--train_gt_dir",
            os.path.join(root, "seg_gt"), "--epochs", "1", "--steps_per_epoch", "2",
            "--batch_size", "2", "--crop_size", "256", "256"])
        seg_cli_s = time.perf_counter() - t0
        check(all(p.device.type == "cuda" for p in out["state"]["params"].values())
              and np.isfinite(out["history"][0]["loss"]),
              "train: run_train_segmentation did not train on the card")
        t0 = time.perf_counter()
        out = run_train_gnn.main([
            "--model_dir", os.path.join(root, "cli_gnn"), "--train_list",
            _write_list(os.path.join(root, "train.lst"), gnn["train_list"]),
            "--eval_list", _write_list(os.path.join(root, "eval2.lst"), gnn["eval_list"]),
            "--epochs", "1", "--samples_per_epoch", "32"])
        gnn_cli_s = time.perf_counter() - t0
        check(all(p.device.type == "cuda" for p in out["state"]["params"].values())
              and np.isfinite(out["history"][0]["loss"]),
              "train: run_train_gnn did not train on the card")
        print(f"train: run_train_segmentation {seg_cli_s:.2f} s and run_train_gnn "
              f"{gnn_cli_s:.2f} s on the card (no --device)")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": seg["launches"], "seg": seg, "gnn": {k: v for k, v in gnn.items() if "list" not in k}}


def _gt_layout_page(path, layout, articles):
    """Rewrite a drawn page's PAGE-XML as GT: the headline regions typed
    ``heading``; with ``articles``, every line the article of its region
    (:data:`ARTICLES`)."""
    from citlab_as_tpu_torch.pagexml import Page
    page = Page(path)
    for region_id, _ in layout:
        if region_id.startswith("r_hl_"):
            page.get_child_by_id(page.page_doc, region_id)[0].set("type", "heading")
    page.mark_dom_mutated()
    if articles:
        lines = []
        for region in page.get_text_regions():
            for tl in region.text_lines:
                tl.set_article_id(ARTICLES[region.id])
                lines.append(tl)
        page.set_textline_attr(lines)
    page.write_page_xml(path)


def gt_train_steps(dev, gt_dir, root):
    """``GT_TRAIN_STEPS`` bf16 steps of the segmentation trainer, from the
    converted separator weights, on a GT directory the port's generator
    wrote. Returns the logged steps."""
    from citlab_as_tpu_torch.train import seg_trainer
    from citlab_as_tpu_torch.train.seg_input_pipeline import find_gt_examples
    from citlab_as_tpu_torch.weights import load_npz
    examples = find_gt_examples(gt_dir)
    check(len(examples) == 2 and all(len(c) == 2 and g.endswith(".jpg") for g, c in examples),
          f"gt_eval: find_gt_examples gave {examples}")
    log = StepLog(seg_trainer, ("make_train_step",), dev)
    try:
        seg_trainer.TrainerSegmentation(
            os.path.join(root, "seg_from_gt"), gt_dir,
            flags={"epochs": 1, "steps_per_epoch": GT_TRAIN_STEPS, "batch_size": SEG_BATCH,
                   "crop_size": SEG_CROP}, seed=0, device=dev,
            init_params=load_npz(os.path.join(REPO, "models_ckpt_torch", "separator.npz"))
        ).train()
    finally:
        log.restore()
    return log.of("train")


def phase_gt_eval(dev, workflow_row):
    """Ground truth and evaluation on the card: the generators on the
    committed full-size fixture pages against the JAX package's digests,
    the card's dilation and binarization against the CPU's, a few train
    steps on the generated GT, the heading grid search, the comparator,
    its tournament and reports, and the checker."""
    import torch
    import xml.etree.ElementTree as ET
    import zipfile
    from citlab_as_tpu_torch.cli import min_run_example, run_compare
    from citlab_as_tpu_torch.eval.checker import AsChecker, AsProbCode
    from citlab_as_tpu_torch.eval.compare import SepPageCompDict
    from citlab_as_tpu_torch.eval.heading_eval import run_grid_search
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops.image_utils import get_binarization
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages.ground_truth import apply_dilation, create_baseline_gt_img

    root = tempfile.mkdtemp(prefix="chip_smoke_gt_")
    cpu = torch.device("cpu")
    k1.launches = 0
    k2.launches = 0
    try:
        # 1. the generators on the fixture pages, on the card
        with open(os.path.join(GT_DIR, "digests.json")) as f:
            record = json.load(f)
        images = [os.path.join(GT_DIR, p) for p in record["pages"]]
        seconds = {}
        got, done = run_gt_generators(images, os.path.join(root, "gt"), dev,
                                      record["half_resolution"], seconds)
        diff = compare_gt_records(record["runs"], got)
        check(diff is None, f"gt_eval: a generated file differs from the JAX package's: {diff}")
        check(done == len(images), f"gt_eval: the AS CLI generated {done} of {len(images)} pages")
        n_files = sum(len(r) for r in got.values())
        print(f"gt_eval: {n_files} files of {len(seconds)} generator runs over {len(images)} "
              f"fixture pages of 2000 x 1420 equal the JAX package's (decoded pixels, "
              f"info.txt and regions_gt.json bytes); seconds per page "
              + json.dumps({k: round(v / len(images), 3) for k, v in seconds.items()}))
        # the card's dilation and binarization against the CPU's
        for image in images:
            want = get_binarization(image, device=cpu)
            check(np.array_equal(get_binarization(image, device=dev), want),
                  f"gt_eval: {image}: the binarization differs between the card and the CPU")
            page = Page(os.path.join(GT_DIR, "page", os.path.basename(image)[:-4] + ".xml"))
            w, h = page.get_image_resolution()
            baselines = create_baseline_gt_img(page.get_article_dict(), 1.0, w, h)
            for kernel in ((3, 3), (5, 3)):
                check(np.array_equal(apply_dilation(baselines, kernel, dev),
                                     apply_dilation(baselines, kernel, cpu)),
                      f"gt_eval: {image}: the dilation {kernel} differs from the CPU")
        print(f"gt_eval: binarization (black share {float(want.mean()):.4f}) and the baseline "
              f"channel's dilation (3 x 3, 5 x 3) on the card equal the CPU's on "
              f"{len(images)} pages")

        # 2. the generated separator GT into training
        before = k1.launches
        steps = gt_train_steps(dev, os.path.join(root, "gt", "region_sep"), root)
        losses = [s["loss"] for s in steps]
        check(len(steps) == GT_TRAIN_STEPS and all(s["k1"] == 69 for s in steps),
              f"gt_eval: K1 launches per train step {[s['k1'] for s in steps]}, want 69")
        check(all(np.isfinite(losses)), f"gt_eval: train losses {losses}")
        check(k1.launches - before == 69 * GT_TRAIN_STEPS,
              f"gt_eval: {k1.launches - before} K1 launches in training")
        print(f"gt_eval: {GT_TRAIN_STEPS} bf16 steps of the segmentation trainer (batch "
              f"{SEG_BATCH} x {SEG_CROP[0]} x {SEG_CROP[1]}) from separator.npz on the "
              f"generated separator GT: losses {[round(v, 5) for v in losses]}, ms "
              f"{[round(s['s'] * 1e3, 1) for s in steps]}, K1 69 launches per step")

        # 3. the heading grid search over the files phase's pages
        pages, _, layouts = synthetic_newspaper(GRID_PAGES, *PAGE_SHAPE, seed=11)
        grid_dir = os.path.join(root, "grid")
        paths = write_corpus(grid_dir, pages, layouts)
        for path, layout in zip(paths, layouts):
            _gt_layout_page(os.path.join(grid_dir, "page", os.path.basename(path)[:-4] + ".xml"),
                            layout, articles=False)
        head = SegmentationPredictor(os.path.join(REPO, "models_ckpt_torch", "heading.npz"),
                                     dtype=torch.bfloat16, device=dev)
        # the shapes K1 gets here are the ones phase_k1's "K1 grid path" holds
        from citlab_as_tpu_torch.models import arunet
        seen = set()

        def recording_conv3x3(x, weight, *args, **kwargs):
            seen.add((*x.shape, weight.shape[0]))
            return k1_conv3x3(x, weight, *args, **kwargs)

        k1_conv3x3, arunet.conv3x3 = arunet.conv3x3, recording_conv3x3
        before = k1.launches
        t0 = time.perf_counter()
        try:
            results = run_grid_search(paths, head, **GRID)
        finally:
            arunet.conv3x3 = k1_conv3x3
        grid_s = time.perf_counter() - t0
        grid_shape = (1, *K1_HEADING_SHAPE[1:])
        want = {(1, h, w, cin, cout)
                for cin, cout, h, w, _ in k1_main_path_instances(grid_shape)}
        check(seen == want, f"gt_eval: K1 shapes in the grid search {sorted(seen)} are not "
              f"the {len(want)} instances of the K1 grid path at {grid_shape}")
        check(len(results) == 3, f"gt_eval: {len(results)} grid points, want 3")
        check(k1.launches - before == 69 * len(results) * GRID_PAGES,
              f"gt_eval: {k1.launches - before} K1 launches in the grid search, want 69 x "
              f"{len(results) * GRID_PAGES} forwards")
        for r in results:
            vals = list(r["metrics"].values())
            check(len(vals) == 12 and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals),
                  f"gt_eval: grid metrics {r['metrics']}")
        default = [r for r in results if r["setting"]["weight_dict"] ==
                   {"net": 0.8, "stroke_width": 0.0, "text_height": 0.2}]
        check(len(default) == 1 and default[0]["metrics"]["f1_binary"] == 1.0,
              f"gt_eval: f1_binary at the default setting {default}")
        print(f"gt_eval: heading grid search over {GRID_PAGES} pages, {len(results)} points "
              f"in {grid_s:.2f} s ({grid_s / len(results):.2f} s per point); K1 "
              f"{k1.launches - before} launches; f1_binary per point "
              + json.dumps([[r["setting"]["weight_dict"], r["metrics"]["f1_binary"]]
                            for r in results]))

        # 4. the comparator, its tournament and reports, and the checker
        work = os.path.join(root, "work")
        gt_page_dir = os.path.join(root, "gt_pages", "page")
        os.makedirs(gt_page_dir)
        gts = []
        for path, layout in zip(workflow_row["clustered"], workflow_row["layouts"]):
            # GT: the drawn layout with each line's article; hypotheses: the
            # workflow's clustering, the GT itself and every line one article
            name = os.path.basename(path)[:-len("_clustering.xml")]
            gt = os.path.join(gt_page_dir, f"{name}.xml")
            write_layout_xml(gt, f"{name}.png", *PAGE_SHAPE, layout)
            _gt_layout_page(gt, layout, articles=True)
            gts.append(gt)
            for method in ("dbscan", "gt", "one_article"):
                out = os.path.join(work, "run", "eval", "x", "clustering", method,
                                   f"{name}_clustering.xml")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                shutil.copy({"dbscan": path, "gt": gt, "one_article": path}[method], out)
                if method == "one_article":
                    page = Page(out)
                    lines = page.get_textlines()
                    for tl in lines:
                        tl.set_article_id("a")
                    page.set_textline_attr(lines)
                    page.write_page_xml(out)
        gt_list = _write_list(os.path.join(root, "gt.lst"), gts)
        t0 = time.perf_counter()
        spc, evaler = run_compare.main(["--gt_list", gt_list, "--work_dir", work,
                                        "--out_dir", os.path.join(root, "cmp"),
                                        "--dataset", "smoke"])
        compare_s = time.perf_counter() - t0
        comps = {(os.path.basename(g), SepPageCompDict.path2method(h)): c
                 for g, by_hyp in spc["smoke"].items() for h, c in by_hyp.items()}
        methods = sorted({m for _, m in comps})
        check(len(comps) == 3 * len(gts) and len(methods) == 3,
              f"gt_eval: {len(comps)} comparisons of methods {methods}")
        for key, c in comps.items():
            check(c.checkConsistency(), f"gt_eval: {key}: gtNIs + splits + merges != hypNIs: {c}")
            if key[1].endswith("/gt"):
                check(c.splits == c.merges == 0 and c.corrects == c.gtNIs,
                      f"gt_eval: {key}: GT against itself {c}")
        csv_path = os.path.join(root, "cmp", "comparison.csv")
        back = SepPageCompDict()
        back.loadCSV(csv_path, methods)
        check({(g, h): c.dataDict() for g, d in back["smoke"].items() for h, c in d.items()}
              == {(g, h): c.dataDict() for g, d in spc["smoke"].items() for h, c in d.items()},
              "gt_eval: the comparison CSV does not round-trip")
        with zipfile.ZipFile(os.path.join(root, "cmp", "comparison.xlsx")) as z:
            check(z.testzip() is None, "gt_eval: the XLSX zip is corrupt")
            sheets = {n: ET.fromstring(z.read(n)) for n in z.namelist()
                      if n.startswith("xl/worksheets/")}
        rows = {n: len(t.findall(".//{*}row")) for n, t in sheets.items()}
        check(len(sheets) == 2 and sorted(rows.values()) == [4, 4],
              f"gt_eval: XLSX sheets and rows {rows} (winner table and the dataset's "
              f"matrix: a header and one row per method)")
        wins = {m: d["all"] for m, d in evaler.winnerStatDict["smoke"].items()}
        demo_spc, _ = min_run_example.main(["--demo", "--work_dir", os.path.join(root, "demo"),
                                            "--out_dir", os.path.join(root, "demo_out")])
        demo = {os.path.basename(os.path.dirname(h)): c.dataDict()
                for d in demo_spc["example"].values() for h, c in d.items()}
        check(demo["method-good"]["dist"] == 0 and demo["method-merged"]["merges"] == -1,
              f"gt_eval: min_run_example --demo gave {demo}")
        checker = AsChecker(set(AsProbCode))
        checker.page_list = list(workflow_row["clustered"])
        checker.check_pages()
        checker.probs_to_xlsx(os.path.join(root, "problems.xlsx"))
        check(checker.cnt_dict["TL_12"] == 0,
              f"gt_eval: the checker finds lines without an article id: {checker.cnt_dict}")
        print(f"gt_eval: run_compare over {len(gts)} pages x {len(methods)} methods in "
              f"{compare_s:.2f} s, every comparison consistent; dbscan "
              + json.dumps([comps[(os.path.basename(g), m)].dataDict()
                            for g in gts for m in methods if m.endswith("/dbscan")][:4])
              + f"; tournament wins {json.dumps(wins)}, winner table "
              f"{json.dumps(evaler.winnerDict['smoke'])}; XLSX rows {rows}; CSV "
              f"round-trips; min_run_example --demo {json.dumps(demo)}; checker counts "
              f"{json.dumps(checker.cnt_dict)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(os.path.dirname(workflow_row["clustered"][0]), ignore_errors=True)
    launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
    check(launches == {"conv3x3": 69 * (GT_TRAIN_STEPS + 3 * GRID_PAGES),
                       "separator_morphology": 0}, f"gt_eval: launches {launches}")
    return {"launches": launches, "seconds_per_page": {
        k: v / len(images) for k, v in seconds.items()}, "grid_s": grid_s}


# ---------------------------------------------------------------- models

MODELS_PAGES = 8                            # the Inception visual net's pages: 2 groups of 4
MODELS_CONF_TOL = 1e-4                      # card vs CPU, as VISUAL_CONF_TOL
WV_DIM = 300                                # word2vec's usual width
WV_WORDS = ("zeitung", "regierung", "stadt", "bericht", "wahl", "markt", "preis",
            "schule", "kirche", "krieg", "frieden", "bahn", "hafen", "wetter",
            "rat", "gericht", "theater", "handel", "post", "land")
PREPROCESSING_DIR = os.path.join(REPO, "tests", "data", "torch_preprocessing")
CALIBRATION_SHAPE = (2, 1024, 1024, 1)      # the visual net's padded input at 600 / 1024


def _tf_const_name(path):
    """The TF const name of the reference's ARU_v1 graph for a flat flax
    ARU-Net path (the inverse of ``pb_import._tf_to_flax_name``)."""
    scope, inner, leaf = path[len("params/"):].rsplit("/", 2)
    if inner == "deconv":
        return f"aru_net/{scope[:-len('_deconv')]}/deconv/" + \
            ("weights" if leaf == "kernel" else "bias")
    tf_leaf = "weights" if leaf == "kernel" else "biases"
    if scope.startswith("attMapG/"):
        return f"aru_net/attMapG/attPart/{scope.split('/')[1]}/{tf_leaf}"
    if scope == "logit":
        return f"aru_net/logit/class/{tf_leaf}"
    return f"aru_net/{scope}/{tf_leaf}"


def write_arunet_pb(path, flat):
    """A frozen TF1 GraphDef (protobuf wire bytes, no TensorFlow) holding
    every weight of a flat flax ARU-Net as a float32 Const node in TF's
    layouts: conv kernels HWIO, transposed-conv kernels [k, k, out, in]
    flipped."""
    def varint(v):
        out = b""
        while True:
            b, v = v & 0x7F, v >> 7
            if not v:
                return out + bytes([b])
            out += bytes([b | 0x80])

    def field(num, payload):
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    graph = b""
    for key in sorted(flat):
        arr = np.asarray(flat[key], np.float32)
        if key.endswith("deconv/kernel"):
            arr = arr[::-1, ::-1].transpose(0, 1, 3, 2)
        shape = b"".join(field(2, varint(1 << 3) + varint(d)) for d in arr.shape)
        tensor = (varint(1 << 3) + varint(1) + field(2, shape)
                  + field(4, np.ascontiguousarray(arr).tobytes()))
        attr = field(1, b"value") + field(2, field(8, tensor))
        node = field(1, _tf_const_name(key).encode()) + field(2, b"Const") + field(5, attr)
        graph += field(1, node)
    with open(path, "wb") as f:
        f.write(graph)
    return path


def calibrate_batch_norm(backbone, image):
    """Set every BatchNorm's running statistics of a seeded Inception v3 to
    the per-channel mean and variance its conv gives on ``image`` (one
    forward, in order), so a randomly initialised net keeps its activations
    at unit scale through its 94 units instead of fading out."""
    import torch
    from citlab_as_tpu_torch.models.inception_v3 import ConvUnit

    def hook(unit):
        def set_stats(_, __, out):
            unit.BatchNorm_0.running_mean.copy_(out.mean(dim=(0, 2, 3)))
            unit.BatchNorm_0.running_var.copy_(out.var(dim=(0, 2, 3), unbiased=False))
        return set_stats
    handles = [m.Conv_0.register_forward_hook(hook(m))
               for m in backbone.modules() if isinstance(m, ConvUnit)]
    try:
        with torch.no_grad():
            backbone(image)
    finally:
        for h in handles:
            h.remove()


def inception_visual_gnn(seed, dev):
    """``GraphRelation(image_input=True, visual_backbone="inception_v3")`` at
    the ``gnn`` widths (15 node and 2 edge features, 3 transitions, width
    32): lecun-normal kernels and zero biases from a seeded generator (the
    flax initializers), BatchNorm calibrated on a seeded 2 x 1024 x 1024
    page-like image on ``dev``."""
    import torch
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    model = GraphRelation(15, 2, image_input=True, visual_backbone="inception_v3")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("visual.backbone."):
                continue
            if name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
    backbone = model.visual.backbone.init_random(seed)
    image = (torch.rand(CALIBRATION_SHAPE, generator=gen) > 0.1).float()
    calibrate_batch_norm(backbone.to(dev), image.to(dev))
    return model.cpu()


def _fill_words(page_path, rng):
    """Seeded German words (with stop words, numbers and punctuation) in
    every empty ``Unicode`` of a PAGE-XML file."""
    import re
    pool = list(WV_WORDS) * 2 + ["der", "die", "Die", "und", "in", "Der", "1923", ",", "."]
    with open(page_path, encoding="utf-8") as f:
        xml = f.read()
    xml = re.sub(r"<Unicode\s*/>|<Unicode></Unicode>", lambda _: "<Unicode>" + " ".join(
        pool[i].capitalize() if pool[i] in WV_WORDS and rng.rand() < 0.5 else pool[i]
        for i in rng.randint(0, len(pool), rng.randint(2, 9))) + "</Unicode>", xml)
    with open(page_path, "w", encoding="utf-8") as f:
        f.write(xml)


def _similarity_reference(page_path, vectors, stop_words):
    """The word-vector similarity of every region pair of a page, computed
    here from the PAGE-XML's texts (the reference's rule: at least 5
    tokens, alphabetic ones not in the stop list, lower-cased, summed,
    cosine mapped to [0, 1], 0.5 where a side has no vector)."""
    import re
    from citlab_as_tpu_torch.pagexml import Page
    regions = Page(page_path).get_regions()["TextRegion"]
    sums = []
    for tr in regions:
        tokens = re.findall(r"\w+|[^\w\s]", "\n".join(tl.text for tl in tr.text_lines))
        if len(tokens) < 5:
            sums.append(None)
            continue
        vs = [vectors[w.lower()] for w in tokens
              if w.isalpha() and w not in stop_words and w.lower() in vectors]
        sums.append(np.sum(vs, axis=0) if vs else np.zeros(1))

    def sim(a, b):
        if sums[a] is None or sums[b] is None:
            return 0.5
        x, y = sums[a], sums[b]
        cos = float(np.dot(x, y) / (np.linalg.norm(x) * np.linalg.norm(y))) \
            if np.any(x) and np.any(y) else 0.0
        return (cos + 1) / 2
    return sim


def phase_models(dev):
    """``.frozen`` and ``.pb`` ARU-Nets against the ``.npz`` one; the
    Inception v3 visual relation net exported to a ``.frozen`` and served by
    ``run_gnn_clustering``; the word-vector feature CLI; the text-block
    post-processor; the page-preprocessing CLI against the JAX package's
    digests."""
    import glob
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    from citlab_as_tpu_torch.cli import (run_feature_generation, run_gnn_clustering,
                                         run_page_preprocessing)
    from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
    from citlab_as_tpu_torch.models.pb_import import import_arunet_weights
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.ops.resize import resize_image
    from citlab_as_tpu_torch.stages.clustering import TextblockClustering
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    from citlab_as_tpu_torch.stages.textblock_postprocess import TextBlockNetPostProcessor
    from citlab_as_tpu_torch.stages.textblock_similarity import (
        _FALLBACK_STOPWORDS, load_word_vectors)
    from citlab_as_tpu_torch.train.export import export_checkpoint_frozen, export_frozen
    from citlab_as_tpu_torch.utils import io as port_io
    from citlab_as_tpu_torch.weights import (arunet_flax_from_state_dict,
                                             arunet_state_dict_from_flax, load_npz)
    from scripts.make_preprocessing_fixtures import run_in_copy

    launches = {"conv3x3": 0, "separator_morphology": 0}

    def counted(fn):
        k1.launches = k2.launches = 0
        out = fn()
        torch.cuda.synchronize()
        seen = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        for k, v in seen.items():
            launches[k] += v
        return out, seen

    root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    build_dir = os.path.join(REPO, "build", "chip_smoke_models")
    os.makedirs(build_dir, exist_ok=True)
    try:
        # -- .frozen and .pb ARU-Nets against the .npz one
        npz = os.path.join(REPO, "models_ckpt_torch", "separator.npz")
        frozen = export_checkpoint_frozen(npz, os.path.join(build_dir, "separator.frozen"),
                                          "arunet", model_kwargs={"dtype": "bfloat16"})
        pb = write_arunet_pb(os.path.join(build_dir, "separator.pb"), load_npz(npz))
        preds = {"npz": SegmentationPredictor(npz, device=dev),
                 "frozen": SegmentationPredictor(frozen, device=dev),
                 "pb": SegmentationPredictor(None, device=dev)}
        flat, matched, unmatched = import_arunet_weights(
            pb, arunet_flax_from_state_dict(preds["pb"].model.state_dict()))
        check(len(matched) == len(flat) and not unmatched,
              f"models: .pb import matched {len(matched)} of {len(flat)}, {unmatched[:3]} left")
        preds["pb"].model.load_state_dict(arunet_state_dict_from_flax(flat))
        pages, _ = synthetic_pages(BATCH, *PAGE_SHAPE, seed=7)
        out_h = FIXED_HEIGHT
        out_w = int(PAGE_SHAPE[1] * FIXED_HEIGHT / PAGE_SHAPE[0])
        x = resize_image(torch.from_numpy(np.stack(pages)).to(dev).float(), out_h, out_w)
        x = torch.nn.functional.pad(x, (0, -out_w % 64, 0, -out_h % 64))[..., None] / 255.0
        probs = {}
        for name, pred in preds.items():
            probs[name], seen = counted(lambda: pred._forward(x))
            check(seen["conv3x3"] == 69, f"models: the {name} ARU forward launched K1 "
                  f"{seen['conv3x3']} times, want 69")
        same = {name: bool(torch.equal(probs[name], probs["npz"])) for name in ("frozen", "pb")}
        print(f"models: ARU-Net forward at {tuple(x.shape)} bf16 from .frozen and .pb equal "
              f"to the .npz one bit for bit: {same}; 69 K1 launches each")
        check(all(same.values()), f"models: ARU forwards differ from the .npz one: {same}")

        sep_pages, _, layouts = synthetic_newspaper(BATCH, *PAGE_SHAPE, seed=13)
        paths = write_corpus(os.path.join(root, "sep"), sep_pages, layouts)
        written = {}
        for name in ("npz", "frozen"):
            proc = SeparatorNetPostProcessor(paths, preds[name], fixed_height=FIXED_HEIGHT,
                                             threshold=THRESHOLD)
            _, seen = counted(lambda: proc.run_batched_fused(BATCH))
            check(seen == {"conv3x3": 69, "separator_morphology": 1},
                  f"models: separator group from .{name} launched {seen}")
            written[name] = {p: _normalised_xml(p) for p in
                             glob.glob(os.path.join(root, "sep", "page", "*.xml.xml"))}
            for p in written[name]:
                os.remove(p)
        check(len(written["npz"]) == BATCH and written["frozen"] == written["npz"],
              "models: the separator stage from the .frozen net wrote other files")
        print(f"models: separator stage, one group of {BATCH} pages from .frozen writes the "
              f"same {len(written['npz'])} files as from .npz (69 K1 and 1 K2 launches each)")
        del preds, probs, x

        # -- pages with words; feature JSONs with and without word vectors
        rng = np.random.RandomState(17)
        pages, _, layouts = synthetic_newspaper(MODELS_PAGES, *PAGE_SHAPE, seed=17)
        images = write_corpus(root, pages, layouts)
        page_paths = [port_io.get_page_path(p) for p in images]
        for p in page_paths:
            _fill_words(p, rng)
        wv = os.path.join(root, "wv.txt")
        with open(wv, "w", encoding="utf-8") as f:
            f.write(f"{len(WV_WORDS)} {WV_DIM}\n")
            for w in WV_WORDS:
                f.write(w + " " + " ".join(f"{v:.6f}" for v in rng.randn(WV_DIM)) + "\n")
        lst = _write_list(os.path.join(root, "pages.lst"), page_paths)
        t0 = time.perf_counter()
        run_feature_generation.main(["--pagexml_list", lst, "--visual_regions", "--out_path",
                                     os.path.join(root, "json_plain")])
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_feature_generation.main(["--pagexml_list", lst, "--visual_regions", "--out_path",
                                     os.path.join(root, "json_wv"), "--language", "german",
                                     "--wv_path", wv])
        wv_s = time.perf_counter() - t0
        vectors = load_word_vectors(wv)
        worst_sim, distinct = 0.0, set()
        for p in page_paths:
            name = os.path.splitext(os.path.basename(p))[0] + ".json"
            with open(os.path.join(root, "json_plain", name)) as f:
                plain = json.load(f)
            with open(os.path.join(root, "json_wv", name)) as f:
                withwv = json.load(f)
            check(withwv["node_features"] == plain["node_features"]
                  and [e[:2] for e in withwv["edge_features"]] == plain["edge_features"],
                  f"models: word vectors moved other features of {name}")
            sim = _similarity_reference(p, vectors, _FALLBACK_STOPWORDS["german"])
            for (a, b), e in zip(withwv["interacting_nodes"], withwv["edge_features"]):
                worst_sim = max(worst_sim, abs(e[2] - sim(a, b)))
                distinct.add(e[2])
        print(f"models: run_feature_generation --language german --wv_path ({len(WV_WORDS)} "
              f"seeded {WV_DIM}-d vectors) over {MODELS_PAGES} pages in {wv_s:.2f} s "
              f"({plain_s:.2f} s without); similarity vs the smoke's recomputation from "
              f"the texts max abs {worst_sim:.3g}; {len(distinct)} distinct values")
        check(worst_sim <= 1e-6 and len(distinct) > 2,
              f"models: word-vector similarity off by {worst_sim} ({len(distinct)} values)")

        # -- the Inception v3 visual relation net: export, serve, time
        t0 = time.perf_counter()
        model = inception_visual_gnn(19, dev)
        frozen_gnn = export_frozen(
            os.path.join(build_dir, "inception_visual.frozen"), "graph_relation", model,
            model_kwargs={"image_input": True, "visual_backbone": "inception_v3"})
        print(f"models: Inception visual GNN initialised, calibrated and exported in "
              f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(frozen_gnn) / 2**20:.1f} MiB)")
        del model
        json_paths = sorted(glob.glob(os.path.join(root, "json_plain", "*.json")))
        json_lst = _write_list(os.path.join(root, "json.lst"), json_paths)
        cli_args = ["--image_input", "--visual_backbone", "inception_v3",
                    "--model_dir", frozen_gnn]
        _, seen = counted(lambda: run_gnn_clustering.main(
            ["--eval_list", json_lst, "--out_dir", os.path.join(root, "warm")] + cli_args))
        t0 = time.perf_counter()
        card_written, seen = counted(lambda: run_gnn_clustering.main(
            ["--eval_list", json_lst, "--out_dir", os.path.join(root, "card")] + cli_args))
        cli_s = time.perf_counter() - t0
        check(len(card_written) == MODELS_PAGES and seen["conv3x3"] == 0,
              f"models: run_gnn_clustering wrote {len(card_written)} pages, K1 {seen}")
        cpu_written = run_gnn_clustering.main(
            ["--eval_list", _write_list(os.path.join(root, "one.lst"), json_paths[:1]),
             "--out_dir", os.path.join(root, "cpu"), "--device", "cpu"] + cli_args)
        same_xml = _normalised_xml(cpu_written[0]) == _normalised_xml(card_written[0])
        with open(json_paths[0]) as f:
            graph = json.load(f)
        image = np.asarray(port_io.load_image(images[0], "L"))
        kw = dict(image_input=True, visual_backbone="inception_v3")
        card_pred = RelationPredictor(frozen_gnn, device=dev, **kw)
        c_card = card_pred.confidences(graph, image)
        c_cpu = RelationPredictor(frozen_gnn, device="cpu", **kw).confidences(graph, image)
        conf_err = float(np.abs(c_card - c_cpu).max())
        labels = []
        for conf in (c_card, c_cpu):
            tb = TextblockClustering()
            tb.set_confs(conf)
            tb.calc("dbscan")
            labels.append(list(tb.tb_labels))
        print(f"models: run_gnn_clustering --image_input --visual_backbone inception_v3 "
              f"--model_dir <.frozen> over {MODELS_PAGES} pages on the card in {cli_s:.2f} s "
              f"(K1 launches {seen['conv3x3']}); one page card vs CPU: confidences max abs "
              f"{conf_err:.3g} (limit {MODELS_CONF_TOL}), dbscan labels equal "
              f"{labels[0] == labels[1]}, PAGE-XML equal {same_xml}; conf spread "
              f"{float(c_card.min()):.4f}-{float(c_card.max()):.4f}")
        check(conf_err <= MODELS_CONF_TOL, f"models: Inception GNN card vs CPU {conf_err}")
        check(labels[0] == labels[1], "models: dbscan labels differ between card and CPU")
        check(same_xml, "models: the card's clustered PAGE-XML differs from the CPU's")

        graphs, imgs = [], []
        for jp, ip in zip(json_paths[:BATCH], images[:BATCH]):
            with open(jp) as f:
                graphs.append(json.load(f))
            imgs.append(np.asarray(port_io.load_image(ip, "L")))
        inputs, _ = card_pred._batch_inputs(graphs, imgs)
        backbone = card_pred.model.visual.backbone
        flops = [0]

        def count_flops(mod, inp, out):
            flops[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size[0] * \
                mod.kernel_size[1] // mod.groups
        handles = [m.register_forward_hook(count_flops) for m in card_pred.model.modules()
                   if isinstance(m, torch.nn.Conv2d)]
        card_pred.forward_confidences(inputs)
        for h in handles:
            h.remove()

        @torch.no_grad()
        def backbone_fn():
            return backbone(inputs["image"])
        eager = cuda_ms(lambda: card_pred.forward_confidences(inputs), iters=5, warmup=2)
        backbone_eager = cuda_ms(backbone_fn, iters=5, warmup=1)
        device_ms = {}
        for label, fn in (("forward", lambda: card_pred.forward_confidences(inputs)),
                          ("backbone", backbone_fn)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
            device_ms[label] = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                                if kernels else None, len(kernels))
        torch.cuda.reset_peak_memory_stats()
        card_pred.forward_confidences(inputs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bound_ms = flops[0] / PEAK_OPS_PER_S["f32"] * 1e3
        fwd_dev, fwd_n = device_ms["forward"]
        bb_dev, bb_n = device_ms["backbone"]
        share = f"{bb_dev / fwd_dev:.3f}" if fwd_dev and bb_dev else "not measured"
        print(f"models: Inception visual forward, one group of {BATCH} pages (image "
              f"{tuple(inputs['image'].shape[1:3])}, node bucket {card_pred._node_bucket}, "
              f"f32, TF32 off): {eager:.3f} ms eager (CUDA events), device {fwd_dev} ms over "
              f"{fwd_n} launches (torch.profiler); backbone alone {backbone_eager:.3f} ms "
              f"eager, device {bb_dev} ms over {bb_n} launches, share of the forward's "
              f"device time {share}; {flops[0] / 1e9:.1f} GFLOP of convolution, f32 "
              f"CUDA-core bound {bound_ms:.3f} ms; peak memory {peak:.2f} GiB")
        inception = {"eager_ms": eager, "device_ms": fwd_dev, "backbone_eager_ms": backbone_eager,
                     "backbone_device_ms": bb_dev, "gflop": flops[0] / 1e9,
                     "bound_ms": bound_ms, "peak_gib": peak, "cli_s": cli_s,
                     "conf_err": conf_err}
        del card_pred, inputs

        # -- the text-block post-processor: card vs CPU on a page-sized map
        prng = np.random.RandomState(23)
        prob = prng.rand(*PAGE_SHAPE).astype(np.float32) * 0.04
        for _ in range(60):
            y, x0 = prng.randint(0, PAGE_SHAPE[0] - 300), prng.randint(0, PAGE_SHAPE[1] - 300)
            prob[y:y + prng.randint(4, 150), x0:x0 + prng.randint(4, 150)] = prng.uniform(0.05, 1)
        net_output = np.stack([prob, 1 - prob], axis=-1)
        post = {d: TextBlockNetPostProcessor(device=d) for d in (dev, "cpu")}
        t0 = time.perf_counter()
        mask_card = post[dev].post_process(net_output)
        post_s = time.perf_counter() - t0
        mask_cpu = post["cpu"].post_process(net_output)
        polys = [post[d].to_polygons(m) for d, m in ((dev, mask_card), ("cpu", mask_cpu))]
        print(f"models: text-block post-processor on a {PAGE_SHAPE} map: mask card vs CPU "
              f"equal {bool(np.array_equal(mask_card, mask_cpu))} ({post_s * 1e3:.1f} ms on the "
              f"card), {len(polys[0])} polygons, equal {polys[0] == polys[1]}")
        check(np.array_equal(mask_card, mask_cpu) and polys[0] == polys[1] and polys[0],
              "models: the text-block post-processor differs between card and CPU")

        # -- page preprocessing against the JAX package's digests
        with open(os.path.join(PREPROCESSING_DIR, "digests.json")) as f:
            runs = json.load(f)["runs"]
        bad = [name for name, run in runs.items()
               if run_in_copy(run_page_preprocessing.main, run["argv"], PREPROCESSING_DIR,
                              os.path.join(root, "pre", name)) != run["files"]]
        print(f"models: run_page_preprocessing, {len(runs)} flag combinations: written files "
              f"equal the JAX package's digests in {len(runs) - len(bad)}")
        check(not bad, f"models: preprocessing differs from the digests in {bad}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"models: launches {json.dumps(launches)}")
    return {"launches": launches, "inception": inception}


PARALLEL_SHARDS = 2                         # shards of the one card's mesh
PARALLEL_CLI_PAGES = 4                      # pages of the --sharded CLI check
PARALLEL_PLOT_PAGES = 2                     # pages of plot_net_output
TRANSFORMS = ("erosion", "dilation", "opening", "closing", "gradient", "tophat",
              "blackhat")


def card_entries(dev, n):
    """``n`` mesh entries: one per card (cards 0 to n - 1) on a machine of
    ``n`` cards or more, else ``dev`` n times (shards that share the one
    card)."""
    import torch
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def entries_label(mesh):
    """How a mesh's entries lie on the machine's cards, for a printed line."""
    cards = sorted({str(d) for d in mesh.devices.ravel()})
    return f"{len(cards)} cards ({', '.join(cards)})" if len(cards) > 1 else "one card"


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_parallel(dev, pipelined_row):
    """The data-parallel path: a mesh of ``PARALLEL_SHARDS`` shards that
    all name ``dev`` on one card, or one card each on a machine of several
    (:func:`card_entries`), and ``make_mesh()``, every card. Gates: (a)
    ``ShardedSegmentationPredictor`` equals
    ``SegmentationPredictor`` bit for bit at the same per-shard batch and
    padded shape, 69 K1 launches per shard forward; (b) the pipelined
    workflow over the mesh, from the inputs alone (the earlier runs' files
    deleted), writes the pipelined phase's files byte for byte over its 16
    pages, with K1 552 and K2 4 launches (pages/s beside the
    unsharded run's); (c) ``run_net_post_processing --sharded`` writes the
    unsharded CLI's files, both modes; (d) ``plot_net_output`` over 2 pages,
    K1 138 launches, each overlay equal to ``apply_mask`` recomputed in
    numpy from the card's probabilities; (e) ``apply_transform`` for every
    transform and kernel type on a full page, card equal to CPU; (f)
    ``initialize_multihost()`` brings up a world-size-1 ``nccl`` group."""
    import torch
    import torch.distributed as dist
    from citlab_as_tpu_torch.cli import plot_net_output, run_net_post_processing
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow_pipelined
    from citlab_as_tpu_torch.inference import (RelationPredictor, SegmentationPredictor,
                                               ShardedSegmentationPredictor)
    from citlab_as_tpu_torch.ops.image_utils import apply_transform
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.ops.resize import scale_image
    from citlab_as_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from citlab_as_tpu_torch.utils.io import load_image, save_png

    root, paths, reference = pipelined_row["corpus"]
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    mesh = make_mesh(card_entries(dev, PARALLEL_SHARDS))
    n_cards = torch.cuda.device_count()
    npz = {net: os.path.join(REPO, "models_ckpt_torch", f"{net}.npz")
           for net in ("separator", "heading", "gnn")}
    try:
        # (a) sharded forwards against the unsharded predictor
        pages, _ = synthetic_pages(BATCH * max(PARALLEL_SHARDS, n_cards), *PAGE_SHAPE,
                                   seed=41)
        scaled = [scale_image(torch.from_numpy(p.astype(np.float32)), FIXED_HEIGHT,
                              1.0)[0].numpy() / 255.0 for p in pages]
        single = SegmentationPredictor(npz["separator"], dtype=torch.bfloat16, device=dev)
        want = [out for g in range(max(PARALLEL_SHARDS, n_cards))
                for out in single.predict_batch(scaled[g * BATCH:(g + 1) * BATCH])]
        for label, shard_mesh in (("make_mesh()", make_mesh()), ("2 shards", mesh)):
            sharded = ShardedSegmentationPredictor.from_predictor(single, shard_mesh)
            n = sharded.n_data
            k1.launches = 0
            got = sharded.predict_batch(scaled[:BATCH * n])
            torch.cuda.synchronize()
            check(k1.launches == 69 * n, f"parallel (a) {label}: K1 launched "
                                         f"{k1.launches} times, want 69 x {n}")
            differ = [i for i, (a, b) in enumerate(zip(got, want)) if not np.array_equal(a, b)]
            check(not differ, f"parallel (a) {label}: pages {differ} differ from the "
                              "unsharded predictor's")
            print(f"parallel (a): {label}: {n} shard(s) of {BATCH} pages at "
                  f"{scaled[0].shape}, bit-equal to SegmentationPredictor; K1 {k1.launches}")

        # (b) the pipelined workflow over the mesh, on the pipelined phase's
        # pages, from inputs alone: every file the earlier runs wrote goes
        # first, so no file can pass on another run's bytes
        n_pages = len(paths)
        for rel in written_files(root):
            os.remove(os.path.join(root, rel))
        run = _workflow_runner(dev, paths, RelationPredictor(npz["gnn"], device=dev))
        rates, launches = [], None
        for attempt in range(2):
            secs, result, seen, timings = run(run_full_workflow_pipelined, mesh=mesh)
            rates.append(n_pages / secs)
            if attempt:
                continue
            launches = seen
            groups = -(-n_pages // (BATCH * PARALLEL_SHARDS))
            check_workflow_run("parallel (b)", result, seen, groups * PARALLEL_SHARDS,
                               n_pages)
            files = written_files(root)
            check(set(files) == set(reference),
                  f"parallel (b): wrote {sorted(set(files) ^ set(reference))[:4]} unlike "
                  "the pipelined phase")
            differ = sorted(f for f in files if files[f] != reference[f])
            check(not differ, f"parallel (b): {len(differ)} files differ from the "
                              f"pipelined phase's, e.g. {differ[:3]}")
            check(PIPELINED_TIMINGS <= set(timings), f"parallel (b): timings keys "
                                                     f"{sorted(timings)}")
        print(f"parallel (b): {n_pages} pages over {PARALLEL_SHARDS} shards of "
              f"{entries_label(mesh)}, "
              f"groups of {BATCH * PARALLEL_SHARDS}: all {len(reference)} written files "
              f"byte-equal to the pipelined phase's; launches {json.dumps(launches)}")
        print(f"parallel (b): pages/s, 2 shards (two runs) {json.dumps(rates)}; unsharded "
              f"pipelined, no workers (pipelined phase) "
              f"{json.dumps(pipelined_row['pages_per_s']['pipelined'])}")

        # (c) run_net_post_processing --sharded against the unsharded CLI
        news, _, layouts = synthetic_newspaper(PARALLEL_CLI_PAGES, *PAGE_SHAPE, seed=43)
        cli_corpus = os.path.join(work, "cli")
        write_corpus(cli_corpus, news, layouts)
        cli_mesh = run_net_post_processing._mesh_for
        run_net_post_processing._mesh_for = lambda device: mesh
        try:
            for mode in ("separator", "heading"):
                outs = {}
                for label, extra in (("unsharded", []), ("sharded", ["--sharded"])):
                    sub = os.path.join(work, f"cli_{mode}_{label}")
                    shutil.copytree(cli_corpus, sub)
                    lst = _write_list(sub + ".lst", [
                        os.path.join(sub, f"page_{i:02d}.png")
                        for i in range(PARALLEL_CLI_PAGES)])
                    k1.launches = k2.launches = 0
                    t0 = time.perf_counter()
                    run_net_post_processing.main(
                        ["--path_to_image_list", lst, "--mode", mode, "--model", npz[mode],
                         "--batch_size", "2"] + extra)
                    torch.cuda.synchronize()
                    outs[label] = (written_files(sub), round(time.perf_counter() - t0, 3),
                                   k1.launches, k2.launches)
                check(len(outs["sharded"][0]) == PARALLEL_CLI_PAGES
                      and outs["sharded"][0] == outs["unsharded"][0],
                      f"parallel (c): --sharded {mode} wrote other files than the "
                      "unsharded CLI")
                print(f"parallel (c): run_net_post_processing --mode {mode}: "
                      f"{PARALLEL_CLI_PAGES} pages, --sharded over {PARALLEL_SHARDS} shards "
                      "writes the unsharded files; (s, K1, K2) unsharded "
                      f"{outs['unsharded'][1:]}, sharded {outs['sharded'][1:]}")
        finally:
            run_net_post_processing._mesh_for = cli_mesh

        # (d) plot_net_output on the card
        plot_dir = os.path.join(work, "plot")
        plot_paths = []
        os.makedirs(plot_dir)
        for i in range(PARALLEL_PLOT_PAGES):
            plot_paths.append(os.path.join(plot_dir, f"page_{i:02d}.png"))
            save_png(plot_paths[-1], pages[i])
        lst = _write_list(os.path.join(plot_dir, "images.lst"), plot_paths)
        seen_probs = []
        overlay = plot_net_output.plot_image_with_net_output

        def recording(image, net_output, save_path=None):
            seen_probs.append((image, net_output))
            return overlay(image, net_output, save_path=save_path)
        plot_net_output.plot_image_with_net_output = recording
        try:
            k1.launches = 0
            t0 = time.perf_counter()
            written = plot_net_output.main(["--path_to_img_lst", lst, "--model",
                                            npz["separator"], "--save_folder",
                                            os.path.join(plot_dir, "out")])
            torch.cuda.synchronize()
            plot_secs = time.perf_counter() - t0
        finally:
            plot_net_output.plot_image_with_net_output = overlay
        check(k1.launches == 69 * PARALLEL_PLOT_PAGES,
              f"parallel (d): K1 launched {k1.launches} times, want 69 x "
              f"{PARALLEL_PLOT_PAGES}")
        check(len(written) == len(seen_probs) == PARALLEL_PLOT_PAGES,
              f"parallel (d): plot_net_output wrote {len(written)} files")
        for path, (image, probs) in zip(written, seen_probs):
            want_overlay = np.stack([image] * 3, axis=-1)
            colors = plot_net_output.random_colors(max(probs.shape[-1] - 1, 1))
            for c in range(probs.shape[-1] - 1):
                want_overlay = plot_net_output.apply_mask(
                    want_overlay, (probs[..., c] > 0.5).astype(np.uint8), colors[c])
            check(np.array_equal(np.asarray(load_image(path, mode="RGB")), want_overlay),
                  f"parallel (d): {path} is not the overlay of the card's probabilities")
        print(f"parallel (d): plot_net_output over {PARALLEL_PLOT_PAGES} pages in "
              f"{plot_secs:.3f} s, K1 {k1.launches}; overlays equal apply_mask of the card's "
              "probabilities")

        # (e) apply_transform, card against CPU, on a full page
        page = pages[0]
        t0 = time.perf_counter()
        for kind in ("rect", "ellipse", "cross"):
            for transform in TRANSFORMS:
                got = apply_transform(page, transform, (5, 3), kind, device=dev)
                check(np.array_equal(got, apply_transform(page, transform, (5, 3), kind,
                                                          device="cpu")),
                      f"parallel (e): {transform} / {kind}: card differs from the CPU")
        print(f"parallel (e): apply_transform, {len(TRANSFORMS)} transforms x 3 kernel "
              f"types on {page.shape}: card = CPU ({time.perf_counter() - t0:.1f} s both)")

        # (f) multi-process bring-up, world size 1
        env = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                               "RANK")}
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                          WORLD_SIZE="1", RANK="0")
        try:
            check(initialize_multihost() is True and dist.is_initialized()
                  and dist.get_backend() == "nccl", "parallel (f): no nccl group")
            ones = torch.ones(4, device=dev)
            dist.all_reduce(ones)
            torch.cuda.synchronize()
            check(ones.tolist() == [1.0] * 4, "parallel (f): all_reduce over one rank")
            check(initialize_multihost() is True, "parallel (f): a second call failed")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print("parallel (f): initialize_multihost: nccl, world size 1, all_reduce ok")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "pages_per_s": rates}


SPATIAL_SHARDS = (2, 4)                     # k of the main-path batch's sharded forward
BROADSHEET_SHAPE = (9984, 7040)             # a broadsheet page at 600 dpi, not resized
BROADSHEET_SHARDS = (2, 4)                  # its k on a machine of several cards; 4 on one
# a sharded forward against the unsharded one: the logits within these
# shares of their scale (bf16: K1's limit; f32 with TF32 off), and at most
# SPATIAL_PIXEL_SHARE of the pixels with a probability SPATIAL_PROB_TOL
# apart. bf16's own rounding moves a few pixels' probabilities that far:
# the unsharded bf16 forward is up to 0.14 (separator) and 0.44 (heading)
# from the f32 one, at 0.02 % and 0.09 % of the pixels of the main-path
# batch (NVIDIA H100 80GB HBM3, 700 W), so no bound on every pixel's
# probability holds in bf16
SPATIAL_BF16_TOL, SPATIAL_F32_TOL = 2e-2, 1e-5
SPATIAL_PROB_TOL, SPATIAL_PIXEL_SHARE = 2e-2, 1e-3


class HaloMeter:
    """Counts what the row exchanges of ``parallel/spatial.py`` move while
    it is entered: ``halo_bytes``, the rows copied from a neighbour shard,
    and ``ext_bytes``, the shards' rows with their neighbours' that the
    layers concatenate (one more copy of each layer input per shard)."""

    def __init__(self):
        self.halo_bytes = self.ext_bytes = 0

    def __enter__(self):
        from citlab_as_tpu_torch.parallel import spatial
        self._spatial, self._exchange = spatial, spatial.exchange_rows

        def counting(shards, top, bottom, axis=1):
            out = self._exchange(shards, top, bottom, axis)
            for x, halo in zip(shards, out):
                moved = sum(h.numel() * h.element_size() for h in halo if h is not None)
                self.halo_bytes += moved
                if moved:
                    self.ext_bytes += moved + x.numel() * x.element_size()
            return out
        spatial.exchange_rows = counting
        return self

    def __exit__(self, *exc):
        self._spatial.exchange_rows = self._exchange


def spatial_net(net, dev, k):
    """``net`` height-sharded over a (1, k) mesh (:func:`card_entries`: one
    entry per card where there are k cards, else k entries that name
    ``dev``), from the mesh's own replicas."""
    from citlab_as_tpu_torch.parallel.mesh import make_mesh, replicate
    from citlab_as_tpu_torch.parallel.spatial import SpatialARU
    mesh = make_mesh(card_entries(dev, k), data=1, model=k)
    return SpatialARU(replicate(mesh, net, over_model=True)[0], mesh.model_devices(0)).eval()


def prob_readings(got, want):
    """How far two forwards' probabilities are apart: the largest
    difference, the share of pixels with one above ``SPATIAL_PROB_TOL``,
    and the share on which the channel-0 masks at ``THRESHOLD`` agree."""
    import torch
    diff = (got - want).abs()
    return {"prob_err": diff.max().item(),
            "pixels_off": (diff > SPATIAL_PROB_TOL).any(-1).float().mean().item(),
            "mask_agree": ((got[..., 0] > THRESHOLD) == (want[..., 0] > THRESHOLD)
                           ).float().mean().item(),
            "bit_equal": bool(torch.equal(got, want))}


def compare_probs(label, got, want):
    """The gates of a sharded forward's probabilities against the
    unsharded ones: masks agreeing on at least 99.9 % of pixels, at most
    ``SPATIAL_PIXEL_SHARE`` of them ``SPATIAL_PROB_TOL`` apart."""
    out = prob_readings(got, want)
    check(out["mask_agree"] >= 0.999,
          f"spatial {label}: masks agree on {out['mask_agree']} of pixels (< 0.999)")
    check(out["pixels_off"] <= SPATIAL_PIXEL_SHARE,
          f"spatial {label}: {out['pixels_off']} of pixels have probabilities more than "
          f"{SPATIAL_PROB_TOL} apart (> {SPATIAL_PIXEL_SHARE})")
    return out


def compare_forwards(label, got, want, f32=False):
    """:func:`compare_probs` of two forwards, and their logits within
    ``SPATIAL_BF16_TOL`` (f32: ``SPATIAL_F32_TOL``) of the logits' scale."""
    import torch
    out = compare_probs(label, torch.softmax(got.float(), -1),
                        torch.softmax(want.float(), -1))
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    limit = (SPATIAL_F32_TOL if f32 else SPATIAL_BF16_TOL) * scale
    check(err <= limit, f"spatial {label}: logits {err} apart (> {limit})")
    return dict(out, logit_err=err, logit_scale=scale, bit_equal=bool(torch.equal(got, want)))


def timed_forward(fn, x, iters, k=1):
    """(eager ms, device ms, peak bytes) of ``fn(x)`` without autograd:
    CUDA events around host-issued calls, a CUDA graph's replay, the
    allocator's peak over one call (on a machine of several cards a list,
    each card's own). A forward over ``k`` cards (:func:`card_entries`) has
    no device ms (None): a CUDA graph captures one card's stream."""
    import torch
    cards = range(torch.cuda.device_count())
    with torch.no_grad():
        sync_cards()
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        fn(x)
        sync_cards()
        peaks = [torch.cuda.max_memory_allocated(i) for i in cards]
        peak = peaks if len(peaks) > 1 else peaks[0]
        across = k > 1 and torch.cuda.device_count() >= k
        return (cuda_ms(lambda: fn(x), iters=iters, warmup=1),
                None if across else cuda_graph_ms(lambda: fn(x), iters=iters), peak)


def differing_lines(files, reference, names):
    """What differs between two runs' files ``names``: the count of lines
    of each that differ, and over all of them the element that each such
    line of ``reference`` opens ("text" where it opens none)."""
    import re
    lines, elements = {}, {}
    for name in names:
        got, want = files[name].splitlines(), reference[name].splitlines()
        lines[name] = abs(len(got) - len(want))
        for a, b in zip(got, want):
            if a != b:
                lines[name] += 1
                tag = re.search(rb"<([A-Za-z]+)", b)
                element = tag.group(1).decode() if tag else "text"
                elements[element] = elements.get(element, 0) + 1
    return lines, elements


def phase_spatial(dev, pipelined_row):
    """The height-sharded ARU forward (``parallel/spatial.py``) over meshes
    whose model devices all name the one card, or on a machine of several
    cards name one card each (:func:`card_entries`). Gates: (a) the main-path
    batch (4 x 1536 x 1088, the separator's and the heading's converted
    nets, bf16) at k = 2 and 4 against the unsharded forward: logits within
    2e-2 of their scale, masks at ``THRESHOLD`` agreeing on 99.9 % of
    pixels, at most 0.1 % of the pixels with probabilities 2e-2 apart
    (:func:`compare_forwards`), K1 69 launches per shard; the separator net
    in f32 (TF32 off), its logits within 1e-5 of their scale; (b) a
    broadsheet page of 9984 x 7040 at k = 1 and 4 (and 2 where there are
    several cards), the same gates (device ms, halo bytes and peak memory
    per card printed; on one card every shard shares the memory, so it is
    not divided by k); (c) ``ShardedSegmentationPredictor``
    over (data=2, model=2) against the unsharded predictor at the same
    per-shard batch, the probability gates, K1 276; (d) the pipelined
    workflow over (2, 2) on the pipelined phase's 16 pages (earlier files
    deleted first): no page skipped, each clustered and valid with an
    article id on every line; K1 69 x 2 nets x 2 shards x 2 rows x 2
    groups = 1104 and K2 4; the files byte-equal to the pipelined phase's
    where (a) found the sharded forward bit for bit, else their differences
    counted and printed."""
    import torch
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow_pipelined
    from citlab_as_tpu_torch.inference import (RelationPredictor, SegmentationPredictor,
                                               ShardedSegmentationPredictor)
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.ops.resize import scale_image
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.parallel.mesh import make_mesh

    npz = {net: os.path.join(REPO, "models_ckpt_torch", f"{net}.npz")
           for net in ("separator", "heading", "gnn")}
    preds = {net: SegmentationPredictor(npz[net], dtype=torch.bfloat16, device=dev)
             for net in ("separator", "heading")}
    out = {}

    def sharded_run(fn, x, k):
        with HaloMeter() as meter, torch.no_grad():
            k1.launches = 0
            y = fn(x)
            torch.cuda.synchronize()
            launches = k1.launches
        check(launches == 69 * k, f"spatial: K1 launched {launches} times, want 69 x {k}")
        return y, meter

    # (a) the main-path batch
    pages, _ = synthetic_pages(BATCH, *PAGE_SHAPE, seed=47)
    scaled = [scale_image(torch.from_numpy(p.astype(np.float32)), FIXED_HEIGHT,
                          1.0)[0].numpy() / 255.0 for p in pages]
    x = torch.from_numpy(preds["separator"]._pack_host(scaled)).to(dev)
    bit_equal = True
    rows = []
    for net_name, pred in preds.items():
        with torch.no_grad():
            want = pred.model(x)
        eager, device, peak = timed_forward(pred.model, x, 5)
        rows.append({"net": net_name, "k": 1, "eager_ms": eager, "device_ms": device,
                     "peak_bytes": peak})
        for k in SPATIAL_SHARDS:
            net = spatial_net(pred.model, dev, k)
            got, meter = sharded_run(net, x, k)
            gates = compare_forwards(f"(a) {net_name} k={k}", got, want)
            bit_equal &= gates["bit_equal"]
            eager, device, peak = timed_forward(net, x, 5, k)
            rows.append({"net": net_name, "k": k, **gates, "eager_ms": eager,
                         "device_ms": device, "peak_bytes": peak,
                         "halo_bytes": meter.halo_bytes, "ext_bytes": meter.ext_bytes})
            del got
    f32 = SegmentationPredictor(npz["separator"], dtype=torch.float32, device=dev).model
    with torch.no_grad():
        want = f32(x)
        # bf16's own error: the unsharded bf16 forward against this f32 one
        floor = prob_readings(torch.softmax(preds["separator"].model(x), -1),
                              torch.softmax(want, -1))
    rows.append({"net": "separator bf16 against f32, unsharded", **floor})
    for k in SPATIAL_SHARDS:
        got, _ = sharded_run(spatial_net(f32, dev, k), x, k)
        rows.append({"net": "separator f32", "k": k,
                     **compare_forwards(f"(a) separator f32 k={k}", got, want, f32=True)})
    del f32, want, got
    torch.cuda.empty_cache()
    print(f"spatial (a): {tuple(x.shape)} bf16 at k = {SPATIAL_SHARDS}, K1 69 per shard; "
          f"bit-equal to the unsharded forward: {bit_equal}; " + json.dumps(rows))
    out["main_batch"] = rows

    # (b) a broadsheet page at 600 dpi, tiled from a drawn page
    tile, _ = synthetic_pages(1, *PAGE_SHAPE, seed=53)
    h, w = BROADSHEET_SHAPE
    reps = (-(-h // PAGE_SHAPE[0]), -(-w // PAGE_SHAPE[1]))
    page = np.tile(tile[0], reps)[:h, :w]
    xb = torch.from_numpy(page.astype(np.float32) / 255.0)[None, :, :, None].to(dev)
    rows = []
    sep = preds["separator"].model
    with torch.no_grad():
        want = sep(xb)
    eager, device, peak = timed_forward(sep, xb, 2)
    rows.append({"k": 1, "eager_ms": eager, "device_ms": device, "peak_bytes": peak})
    ks = BROADSHEET_SHARDS if torch.cuda.device_count() > 1 else BROADSHEET_SHARDS[-1:]
    for k in ks:
        net = spatial_net(sep, dev, k)
        got, meter = sharded_run(net, xb, k)
        gates = compare_forwards(f"(b) broadsheet k={k}", got, want)
        del got
        eager, device, peak = timed_forward(net, xb, 2, k)
        rows.append({"k": k, **gates, "eager_ms": eager, "device_ms": device,
                     "peak_bytes": peak, "halo_bytes": meter.halo_bytes,
                     "ext_bytes": meter.ext_bytes})
        del net
    del want
    f32 = SegmentationPredictor(npz["separator"], dtype=torch.float32, device=dev).model
    with torch.no_grad():
        want = f32(xb)
    got, _ = sharded_run(spatial_net(f32, dev, 4), xb, 4)
    rows.append({"k": 4, "dtype": "f32",
                 **compare_forwards("(b) broadsheet f32 k=4", got, want, f32=True)})
    del f32, want, got, xb
    torch.cuda.empty_cache()
    print(f"spatial (b): broadsheet 1 x {h} x {w}, separator net bf16, k = 1 and {list(ks)} "
          f"over {entries_label(make_mesh(card_entries(dev, 4)))}"
          " (peak memory per card; where the shards share one card it is not divided by k) "
          + json.dumps(rows))
    out["broadsheet"] = rows

    # (c) the predictor over (data=2, model=2)
    mesh = make_mesh(card_entries(dev, 4), data=2, model=2)
    more, _ = synthetic_pages(BATCH, *PAGE_SHAPE, seed=59)
    scaled += [scale_image(torch.from_numpy(p.astype(np.float32)), FIXED_HEIGHT,
                           1.0)[0].numpy() / 255.0 for p in more]
    single = preds["separator"]
    want = [o for g in range(2) for o in single.predict_batch(scaled[g * BATCH:(g + 1) * BATCH])]
    sharded = ShardedSegmentationPredictor.from_predictor(single, mesh)
    k1.launches = 0
    got = sharded.predict_batch(scaled)
    torch.cuda.synchronize()
    check(k1.launches == 69 * 4, f"spatial (c): K1 launched {k1.launches} times, want 276")
    gates = compare_probs("(c) predictor", torch.from_numpy(np.stack(got)),
                          torch.from_numpy(np.stack(want)))
    print(f"spatial (c): ShardedSegmentationPredictor over (2, 2), {len(scaled)} pages: "
          f"K1 {k1.launches}; " + json.dumps(gates))

    # (d) the pipelined workflow over (2, 2), from the inputs alone
    root, paths, reference = pipelined_row["corpus"]
    for rel in written_files(root):
        os.remove(os.path.join(root, rel))
    run = _workflow_runner(dev, paths, RelationPredictor(npz["gnn"], device=dev))
    secs, result, launches, _ = run(run_full_workflow_pipelined, mesh=mesh)
    n_pages = len(paths)
    groups = -(-n_pages // (BATCH * 2))
    check(not result["skipped"], f"spatial (d): pages skipped: {result['skipped']}")
    check(len(result["clustered"]) == n_pages,
          f"spatial (d): {len(result['clustered'])} clustered files for {n_pages} pages")
    for path in result["clustered"]:
        page = Page(path)
        lines = page.get_textlines()
        check(lines and all(tl.get_article_id() for tl in lines),
              f"spatial (d): {path}: a text line has no article id")
        check(structurally_valid(page)[0], f"spatial (d): {path} is not valid PAGE-XML")
    want_k1 = 69 * 2 * 2 * 2 * groups
    check(launches["conv3x3"] == want_k1,
          f"spatial (d): K1 launched {launches['conv3x3']} times, want {want_k1}")
    check(launches["separator_morphology"] == 2 * groups,
          f"spatial (d): K2 launched {launches['separator_morphology']} times, "
          f"want {2 * groups}")
    files = written_files(root)
    check(set(files) == set(reference),
          f"spatial (d): wrote {sorted(set(files) ^ set(reference))[:4]} unlike the "
          "pipelined phase")
    differ = sorted(f for f in files if files[f] != reference[f])
    lines_differ, elements = differing_lines(files, reference, differ)
    if bit_equal:
        check(not differ, f"spatial (d): {len(differ)} files differ from the pipelined "
                          f"phase's though the sharded forward is bit for bit: {differ[:3]}")
    print(f"spatial (d): {n_pages} pages over (2, 2) of {entries_label(mesh)}, {groups} "
          f"groups of {BATCH * 2}: {n_pages / secs:.3f} pages/s; launches "
          f"{json.dumps(launches)}; "
          f"{len(differ)} of {len(files)} written files differ from the pipelined phase's "
          f"(lines that differ per file: {json.dumps(lines_differ)}; by element: "
          f"{json.dumps(elements)})")
    out["launches"] = launches
    out["files_differ"] = len(differ)
    return out


# ---------------------------------------------------------------- orbax

ORBAX_DIRS = ("separator/3000", "heading/3000", "gnn/28", "gnn/29", "gnn/best/f1",
              "gnn_pipeline/22", "gnn_pipeline/23", "gnn_pipeline/best/f1",
              "gnn_visual/best/f1")
# the converted weights and the orbax directory each was converted from
ORBAX_NPZ = {"separator": "separator", "heading": "heading", "gnn": "gnn/best/f1",
             "gnn_pipeline": "gnn_pipeline/best/f1", "gnn_visual": "gnn_visual/best/f1"}


def phase_orbax(dev):
    """The JAX package's orbax checkpoints (``models_ckpt/``) read on the
    card's machine by the port's own zstd, OCDBT and zarr code, with no
    orbax, tensorstore or zstandard: every committed directory restored (ms
    each, and the host's zstd MB/s over every chunk of them), each converted
    ``.npz`` equal to its directory's variables bit for bit; the workflow
    CLI over the workflow phase's 8 pages with ``--separator_model_dir``,
    ``--heading_model_dir`` and ``--gnn_model_dir`` writing the ``.npz``
    run's files byte for byte (K1 276, K2 2, counted from 0 just before the
    orbax run); one relation-GNN train step resumed from a copy of the
    committed run ``models_ckpt/gnn`` (step 29 with adam's state)."""
    import torch
    from citlab_as_tpu_torch.cli.run_full_workflow import main as workflow_cli
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train.orbax import restore, save
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    from citlab_as_tpu_torch.utils import io as port_io
    from citlab_as_tpu_torch.utils import zstd
    from citlab_as_tpu_torch.utils.ocdbt import OcdbtStore
    from citlab_as_tpu_torch.weights import load_npz

    found = [d for d in ORBAX_DIRS if os.path.isfile(os.path.join(REPO, "models_ckpt", d,
                                                                  "_METADATA"))]
    check(len(found) == 9, f"orbax: {len(found)} of 9 committed checkpoint directories")
    for name in ("orbax", "tensorstore", "zstandard", "jax"):
        check(name not in sys.modules, f"orbax: {name} is loaded")
    read_ms, leaves = {}, 0
    for d in ORBAX_DIRS:
        t0 = time.perf_counter()
        tree = restore(os.path.join(REPO, "models_ckpt", d))
        read_ms[d] = round((time.perf_counter() - t0) * 1e3, 3)
        leaves += len(ckpt.flatten(tree))
    frames = []
    for d in ORBAX_DIRS:
        store = OcdbtStore(os.path.join(REPO, "models_ckpt", d))
        frames += [store.read(k) for k in store.list() if not k.endswith(".zarray")]
    zstd.decompress(frames[0])
    t0 = time.perf_counter()
    raw = sum(len(zstd.decompress(f)) for f in frames)
    zstd_s = time.perf_counter() - t0
    print(f"orbax: read ms per checkpoint directory (warm page cache) {json.dumps(read_ms)}; "
          f"{leaves} leaves; host zstd {raw / zstd_s / 1e6:.1f} MB/s ({len(frames)} chunks, "
          f"{sum(map(len, frames))} -> {raw} bytes in {zstd_s * 1e3:.3f} ms)")
    for npz, d in ORBAX_NPZ.items():
        want = load_npz(os.path.join(REPO, "models_ckpt_torch", f"{npz}.npz"))
        got, _ = ckpt.checkpoint_variables(os.path.join(REPO, "models_ckpt", d))
        check(sorted(got) == sorted(want), f"orbax: {d} and {npz}.npz hold other arrays")
        for k, v in want.items():
            g = np.asarray(got[k])
            check(g.dtype == v.dtype and g.shape == v.shape and g.tobytes() == v.tobytes(),
                  f"orbax: {d}:{k} differs from {npz}.npz")
    print(f"orbax: the 5 converted .npz equal their orbax directories' variables bit for bit")

    # the port's writer: each committed directory's tree, its arrays held as
    # tensors (jax.Arrays, as orbax wrote them), written again and read back
    contents = [zstd.decompress(f) for f in frames]
    t0 = time.perf_counter()
    framed = [zstd.compress(c) for c in contents]
    frame_s = time.perf_counter() - t0
    check(all(zstd.decompress(f) == c for f, c in zip(framed, contents)),
          "orbax: a written zstd frame does not decode to its content")
    write_ms, sizes = {}, {}
    out_root = tempfile.mkdtemp(prefix="chip_smoke_orbax_write_")
    try:
        for d in ORBAX_DIRS:
            src = os.path.join(REPO, "models_ckpt", d)
            tree = tensors(restore(src))
            t0 = time.perf_counter()
            out = save(os.path.join(out_root, d.replace("/", "_")), tree)
            write_ms[d] = round((time.perf_counter() - t0) * 1e3, 3)
            check_written("orbax", out, tree)
            with open(os.path.join(src, "_METADATA")) as f, \
                    open(os.path.join(out, "_METADATA")) as g:
                check(json.load(f) == json.load(g), f"orbax: {d} re-written has another "
                      "_METADATA")
            sizes[d] = [dir_bytes(out), dir_bytes(src)]
            check(sizes[d][0] <= 1.10 * sizes[d][1],
                  f"orbax: {d} re-written takes {sizes[d][0]} bytes, the committed "
                  f"{sizes[d][1]} (limit 1.10 x)")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    print(f"orbax: the 9 directories re-written by the port and read back bit for bit, "
          f"_METADATA as committed; write ms per directory {json.dumps(write_ms)}; bytes "
          f"[written, committed] {json.dumps(sizes)}; host zstd frames written "
          f"{raw / frame_s / 1e6:.1f} MB/s ({raw} -> {sum(map(len, framed))} bytes in "
          f"{frame_s * 1e3:.3f} ms, raw and RLE blocks)")
    v3 = os.path.join(REPO, "tests", "data", "torch_orbax_zarr3")
    n_v3 = check_written("orbax", v3, restore(os.path.join(REPO, "models_ckpt", "gnn", "best",
                                                              "f1")))
    print(f"orbax: the zarr v3 checkpoint tests/data/torch_orbax_zarr3 reads equal to "
          f"models_ckpt/gnn/best/f1 ({n_v3} arrays) bit for bit")

    root = tempfile.mkdtemp(prefix="chip_smoke_orbax_")
    try:
        pages, _, layouts = synthetic_newspaper(N_PAGES, *PAGE_SHAPE, seed=11)
        paths = write_corpus(root, pages, layouts)
        image_list = _write_list(os.path.join(root, "images.lst"), paths)
        ckpt_dir, npz = os.path.join(REPO, "models_ckpt"), os.path.join(REPO,
                                                                         "models_ckpt_torch")
        flags = {"npz": ["--separator_model", os.path.join(npz, "separator.npz"),
                         "--heading_model", os.path.join(npz, "heading.npz"),
                         "--gnn_model", os.path.join(npz, "gnn.npz")],
                 "orbax": ["--separator_model_dir", os.path.join(ckpt_dir, "separator"),
                           "--heading_model_dir", os.path.join(ckpt_dir, "heading"),
                           "--gnn_model_dir", os.path.join(ckpt_dir, "gnn", "best", "f1")]}
        files, secs = {}, {}
        for run in ("npz", "orbax"):
            port_io._IMAGE_CACHE.clear()
            k1.launches = 0
            k2.launches = 0
            t0 = time.perf_counter()
            result = workflow_cli(["--path_to_image_list", image_list, "--batch_size",
                                   str(BATCH), "--clustering_method", "dbscan"] + flags[run])
            torch.cuda.synchronize()
            secs[run] = round(time.perf_counter() - t0, 3)
            launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
            check_workflow_run(f"orbax ({run})", result, launches, N_PAGES // BATCH, N_PAGES)
            files[run] = written_files(root)
        same = sorted(k for k in files["npz"] if files["orbax"].get(k) == files["npz"][k])
        print(f"orbax: workflow CLI with the three --*_model_dir flags {secs['orbax']} s "
              f"(with the .npz {secs['npz']} s, models loaded in each); launches {launches}; "
              f"{len(same)} of {len(files['npz'])} written files byte-equal to the .npz run's")
        check(sorted(files["orbax"]) == sorted(files["npz"]) and len(same) == len(files["npz"]),
              "orbax: the workflow from models_ckpt/ wrote other files than from the .npz")

        model_dir = os.path.join(root, "gnn_run")
        shutil.copytree(os.path.join(ckpt_dir, "gnn"), model_dir)
        saved = ckpt.read_epoch_info(model_dir)["current_epoch"]
        count = int(restore(os.path.join(model_dir, "29"))["opt_state"][0]["count"])
        jsons = gnn_corpus(os.path.join(root, "gnn_corpus"))
        trainer = TrainerGNN(model_dir, jsons, [], flags={"epochs": saved + 1,
                                                          "samples_per_epoch": 16},
                             seed=0, device=dev)
        t0 = time.perf_counter()
        out = trainer.train()
        resume_s = time.perf_counter() - t0
        loss = out["history"][0]["loss"] if out["history"] else float("nan")
        print(f"orbax: relation GNN resumed from models_ckpt/gnn step 29 (epoch {saved}, "
              f"adam count {count}): one step, loss {loss!r}, count "
              f"{out['state']['opt_state']['count']}, {resume_s:.3f} s")
        check([r["epoch"] for r in out["history"]] == [saved], "orbax: the resume ran "
              f"epochs {[r['epoch'] for r in out['history']]}, want [{saved}]")
        check(np.isfinite(loss), f"orbax: resumed step loss {loss}")
        check(out["state"]["opt_state"]["count"] == count + 1,
              "orbax: the resumed optimizer did not carry adam's count")
        resume = resume_segmentation_step(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("orbax", "tensorstore", "zstandard", "jax"):
        check(name not in sys.modules, f"orbax: {name} is loaded")
    return {"launches": launches, "resume_launches": resume, "read_ms": read_ms,
            "zstd_mb_per_s": raw / zstd_s / 1e6, "write_ms": write_ms, "bytes": sizes,
            "zstd_write_mb_per_s": raw / frame_s / 1e6}


def tensors(tree):
    """A restored tree with its numpy arrays as tensors (bf16 leaves are
    tensors already)."""
    import torch
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v) for v in tree]
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, names in os.walk(path)
               for f in names)


def resume_segmentation_step(dev, root):
    """The segmentation trainer at the separator's width writes one bf16
    step (2 x 256 x 256 crops) as an orbax checkpoint; a new trainer with
    nothing left to train holds that state bit for bit, and one with one
    more epoch resumes it for one step: K1 69 launches under autograd
    (counted from 0 just before it), adam's count carried on by one."""
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train.seg_trainer import TrainerSegmentation
    from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict, load_npz

    gt = write_seg_gt(os.path.join(root, "seg_gt"), 2, TRAIN_PAGE_SHAPE, seed=41)
    model_dir = os.path.join(root, "seg_run")
    flags = {"epochs": 1, "steps_per_epoch": 1, "batch_size": 2, "crop_size": (256, 256)}

    def run(epochs, init=None):
        out = TrainerSegmentation(model_dir, gt, flags=dict(flags, epochs=epochs), seed=0,
                                  device=dev, init_params=init).train()
        state = out["state"]
        return out, ckpt.trainer_state(state["params"], state["opt_state"], state["ema"],
                                       arunet_flax_from_state_dict)

    first, written = run(1, load_npz(os.path.join(REPO, "models_ckpt_torch",
                                                  "separator.npz")))
    n = check_written("orbax", os.path.join(model_dir, "0"), written)
    held, live = run(1)
    check(held["history"] == [], "orbax: a trainer with nothing left to train trained")
    check_written("orbax", os.path.join(model_dir, "0"), live)
    count = first["state"]["opt_state"]["count"]
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    out, _ = run(2)
    resume_s = time.perf_counter() - t0
    launches = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
    loss = out["history"][0]["loss"] if out["history"] else float("nan")
    print(f"orbax: segmentation trainer resumed from its own orbax step 0 ({n} arrays, "
          f"read back bit for bit): one bf16 step, loss {loss!r}, adam count {count} -> "
          f"{out['state']['opt_state']['count']}, launches {launches}, {resume_s:.3f} s")
    check([r["epoch"] for r in out["history"]] == [1] and np.isfinite(loss),
          f"orbax: the segmentation resume ran {out['history']}")
    check(out["state"]["opt_state"]["count"] == count + 1,
          "orbax: the resumed segmentation optimizer did not carry adam's count")
    check(launches == {"conv3x3": 69, "separator_morphology": 0},
          f"orbax: launches in the resumed segmentation step {launches}")
    return launches


RECIPE_SEP_STEPS, RECIPE_SEP_BATCH, RECIPE_SEP_CROP = 40, 8, 512
RECIPE_CHECK_STEPS = 2                      # card vs CPU steps of each f32 check
RECIPE_PAGES = 8                            # the pipeline recipe's dataset: 2 groups of 4
RECIPE_EPOCHS, RECIPE_SAMPLES, RECIPE_BATCH = 2, 64, 8
RECIPE_IMAGE_DIMS = (288, 384)              # --resize_min_dim / --resize_max_dim defaults
#: train_synthetic_gnn's best f1 at its defaults in the JAX package
#: (0.9597, on a CPU host; PERF.md, Findings), less 0.02
SYNTH_GNN_F1_FLOOR = 0.9597343295973433 - 0.02
EVAL_SEEDS = "31,7,101,202,303"             # eval_visual_gnn's default seeds
VISUAL_AS_F1_FLOOR = 0.95                   # the blind phase's unlowered floor


class RecipeSteps:
    """Wraps a step maker (``segmentation.make_train_step`` or
    ``TrainerGNN._make_train_step``) so that every step it makes records its
    K1 launches, its loss tensor (not read back: the recipes read their own)
    and, on the card, an event after it; ``trainers`` keeps the
    ``TrainerGNN`` objects whose steps were made."""

    def __init__(self, owner, name, dev):
        import torch
        from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
        self.owner, self.name = owner, name
        self.original = getattr(owner, name)
        self.k1, self.losses, self.events, self.trainers = [], [], [], []
        original = self.original

        def make(*args, **kwargs):
            if args and hasattr(args[0], "input_fn"):
                self.trainers.append(args[0])
            step = original(*args, **kwargs)

            def run(*a):
                before = k1.launches
                loss = step(*a)
                self.k1.append(k1.launches - before)
                self.losses.append(loss)
                if dev.type == "cuda":
                    self.events.append(torch.cuda.Event(enable_timing=True))
                    self.events[-1].record()
                return loss
            return run
        setattr(owner, name, make)

    def restore(self):
        setattr(self.owner, self.name, self.original)

    def steps_per_s(self, skip=1):
        """Steps per second on the card's timeline from the end of step
        ``skip`` to the end of the last (the host's gaps included)."""
        import torch
        torch.cuda.synchronize()
        n = len(self.events) - skip
        return n / (self.events[skip - 1].elapsed_time(self.events[-1]) / 1e3)


def _counts():
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    return k1.launches, k2.launches


def recipe_separator(dev, root):
    """``train_synthetic_separator``: card against CPU in f32, then the
    recipe's ``main`` at full width in bf16 from scratch."""
    import torch
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.scripts import train_synthetic_separator as recipe
    from citlab_as_tpu_torch.train import segmentation

    # 1. f32 (TF32 off), the same init and batches on the card and the CPU
    batches = [recipe.recipe_batch(0, i, RECIPE_SEP_BATCH, RECIPE_SEP_CROP, False, dev)
               for i in range(RECIPE_CHECK_STEPS)]
    losses = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        _, params, opt_state, step = recipe.build(RECIPE_SEP_STEPS, 1e-3, 8.0, 0, d,
                                                  dtype=torch.float32)
        losses[name] = [float(step(params, opt_state, {k: v.to(d) for k, v in b.items()}))
                        for b in batches]
        print(f"recipes: separator f32 on the {name}: {RECIPE_CHECK_STEPS} steps at "
              f"{RECIPE_SEP_BATCH} x {RECIPE_SEP_CROP} x {RECIPE_SEP_CROP} in "
              f"{time.perf_counter() - t0:.2f} s, losses {losses[name]!r}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]
    check(max(rel) <= 1e-4, f"recipes: separator card vs CPU losses differ by {rel}")

    # 2. the recipe as a user runs it, bf16
    log = RecipeSteps(segmentation, "make_train_step", dev)
    evaluate, evals = recipe.evaluate, []

    def counting_evaluate(model, batch):
        before = _counts()[0]
        out = evaluate(model, batch)
        evals.append(_counts()[0] - before)
        return out
    recipe.evaluate = counting_evaluate
    model_dir = os.path.join(root, "separator")
    try:
        t0 = time.perf_counter()
        acc, precision, recall = recipe.main([
            "--model_dir", model_dir, "--steps", str(RECIPE_SEP_STEPS),
            "--batch", str(RECIPE_SEP_BATCH), "--crop", str(RECIPE_SEP_CROP)])
        wall = time.perf_counter() - t0
    finally:
        recipe.evaluate = evaluate
        log.restore()
    read = [float(log.losses[i]) for i in range(RECIPE_SEP_STEPS)
            if i % 50 == 0 or i == RECIPE_SEP_STEPS - 1]
    check(len(log.k1) == RECIPE_SEP_STEPS and set(log.k1) == {69} and evals == [69],
          f"recipes: separator K1 launches per train step {sorted(set(log.k1))}, per eval {evals}")
    check(all(np.isfinite(read)) and read[-1] < read[0],
          f"recipes: separator loss readbacks {read}")
    steps_per_s = log.steps_per_s(skip=1) if dev.type == "cuda" else float("nan")
    before = _counts()[0]
    probs = SegmentationPredictor(model_dir, device=dev)(
        synthetic_pages(1, 1024, 704, seed=5)[0][0].astype(np.float32) / 255.0)
    forward_k1 = _counts()[0] - before
    check(forward_k1 == 69 and probs.shape == (1024, 704, 2) and np.isfinite(probs).all(),
          f"recipes: the separator recipe's checkpoint predicts with {forward_k1} K1 launches")
    print(f"recipes: train_synthetic_separator, bf16, batch {RECIPE_SEP_BATCH} x "
          f"{RECIPE_SEP_CROP} x {RECIPE_SEP_CROP}, {RECIPE_SEP_STEPS} steps from scratch: "
          f"{steps_per_s:.3f} steps/s (steps 2-{RECIPE_SEP_STEPS}, card timeline); main "
          f"{wall:.2f} s; loss readbacks {read!r}; final acc {acc:.4f} precision "
          f"{precision:.4f} recall {recall:.4f}; K1 69 per train step and per eval forward; "
          f"f32 card vs CPU relative {[f'{r:.3g}' for r in rel]} (limit 1e-4); its checkpoint "
          f"in SegmentationPredictor: 69 K1 launches per forward")
    return {"steps_per_s": steps_per_s, "f32_rel": max(rel), "readbacks": read}


def _visual_region_pool(chain):
    """The region max pool's ops and their backward: the only 5-d operands
    of the visual relation net's step."""
    for ev in chain:
        if any(isinstance(s, list) and len(s) == 5 for s in (ev.input_shapes or [])):
            return "region_max_pool"
    return None


def recipe_pipeline(dev, root):
    """``train_pipeline_gnn --image_input`` with the default ``ARU_v1``
    backbone: the dataset through the separator on the card, a few epochs,
    card against CPU, best/f1 served, one step profiled."""
    import torch
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.scripts import train_pipeline_gnn as recipe
    from citlab_as_tpu_torch.train.input_pipeline import torch_batch
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    from citlab_as_tpu_torch.utils.io import get_img_from_json_path, load_image

    build, built = recipe.build_dataset, {}

    def counting_build(*args, **kwargs):
        before = _counts()
        out = build(*args, **kwargs)
        built["launches"] = [a - b for a, b in zip(_counts(), before)]
        return out
    recipe.build_dataset = counting_build
    log = RecipeSteps(TrainerGNN, "_make_train_step", dev)
    model_dir = os.path.join(root, "gnn_v1")
    args = ["--model_dir", model_dir, "--work_dir", os.path.join(root, "pipeline"),
            "--num_pages", str(RECIPE_PAGES), "--epochs", str(RECIPE_EPOCHS),
            "--samples_per_epoch", str(RECIPE_SAMPLES), "--batch_size", str(RECIPE_BATCH),
            "--separator_model_dir", os.path.join(REPO, "models_ckpt", "separator"),
            "--image_input"]
    try:
        t0 = time.perf_counter()
        result = recipe.main(args)
        wall = time.perf_counter() - t0
    finally:
        recipe.build_dataset = build
        log.restore()
    groups = -(-RECIPE_PAGES // 4)
    check(built["launches"] == [69 * groups, groups],
          f"recipes: build_dataset launched K1, K2 {built['launches']}")
    trainer = log.trainers[0]
    steps = RECIPE_EPOCHS * (RECIPE_SAMPLES // RECIPE_BATCH)
    check(len(log.k1) == steps and set(log.k1) == {69},
          f"recipes: ARU_v1 K1 launches per train step {log.k1}")
    losses = [float(v) for v in log.losses]
    check(all(np.isfinite(losses)) and "f1" in result["best_metrics"],
          f"recipes: ARU_v1 losses {losses}, best {result['best_metrics']}")
    steps_per_s = steps / trainer.timings["steps"]

    # best/f1 in RelationPredictor against the trainer's eval confidences
    batch_np, path, graph = next(trainer.input_fn.eval_batches(trainer.eval_list[:1]))
    n = int(graph["num_nodes"])
    want = trainer.predict(torch_batch(batch_np, dev)).cpu().numpy()[0, :n * n].reshape(n, n)
    pred = RelationPredictor(os.path.join(model_dir, "best", "f1"), image_input=True,
                             visual_backbone="ARU_v1", image_min_dimension=RECIPE_IMAGE_DIMS[0],
                             image_max_dimension=RECIPE_IMAGE_DIMS[1], device=dev)
    got = pred.confidences(graph, np.asarray(load_image(get_img_from_json_path(path), "L")))
    worst = float(np.abs(got - want).max())
    check(worst <= 1e-5, f"recipes: ARU_v1 best/f1 confidences differ by {worst}")

    # f32 (TF32 off): the same init and batches on the card and the CPU
    check_losses = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        check_log = RecipeSteps(TrainerGNN, "_make_train_step", d)
        try:
            t0 = time.perf_counter()
            TrainerGNN(os.path.join(root, f"gnn_v1_{name}"), trainer.train_list, [],
                       flags={"epochs": 1, "batch_size": RECIPE_BATCH,
                              "samples_per_epoch": RECIPE_BATCH * RECIPE_CHECK_STEPS,
                              "weight_decay": 1e-6},
                       input_params=trainer.input_fn.params, seed=0, device=d,
                       model=type(trainer.model)(15, 2, image_input=True,
                                                 visual_backbone="ARU_v1")).train()
        finally:
            check_log.restore()
        check_losses[name] = [float(v) for v in check_log.losses]
        print(f"recipes: ARU_v1 visual GNN f32 on the {name}: {RECIPE_CHECK_STEPS} steps in "
              f"{time.perf_counter() - t0:.2f} s, losses {check_losses[name]!r}")
    rel = [abs(a - b) / abs(b) for a, b in zip(check_losses["card"], check_losses["cpu"])]
    check(len(rel) == RECIPE_CHECK_STEPS and max(rel) <= 1e-4,
          f"recipes: ARU_v1 card vs CPU losses differ by {rel}")

    # one train step under the profiler (its optimizer update labelled)
    prof = None
    if dev.type == "cuda":
        class Labelled:
            def __init__(self, opt):
                self.opt = opt

            def step(self, *a):
                from torch.profiler import record_function
                with record_function(LABEL):
                    return self.opt.step(*a)

        optimizer, trainer.optimizer = trainer.optimizer, Labelled(trainer.optimizer)
        step = trainer._make_train_step()
        trainer.optimizer = optimizer
        params = dict(trainer.model.named_parameters())
        opt_state = optimizer.init(params)
        batch = torch_batch(next(trainer.input_fn.train_batches(
            trainer.train_list, RECIPE_BATCH, 1)), dev)
        torch.cuda.reset_peak_memory_stats(dev)
        prof = profile_train_step(step, params, opt_state, batch, dev,
                                  classify=_visual_region_pool)
        prof["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        prof["idle_share_of_timed_step"] = 1.0 - prof["device_busy_ms"] / (1e3 / steps_per_s)
        print("recipes: one ARU_v1 visual GNN train step (batch 8, 384 x 384, f32) under "
              "torch.profiler: " + json.dumps(prof))
    print(f"recipes: train_pipeline_gnn --image_input (ARU_v1): {RECIPE_PAGES} pages, "
          f"build_dataset K1 {built['launches'][0]} and K2 {built['launches'][1]}; "
          f"{steps} train steps at batch {RECIPE_BATCH}, {steps_per_s:.3f} steps/s of train "
          f"step, K1 69 per train step; main {wall:.2f} s; trainer seconds "
          f"{json.dumps({k: round(v, 3) for k, v in trainer.timings.items()})}; losses "
          f"{[round(v, 5) for v in losses]}; history {json.dumps(result['history'])}; "
          f"best/f1 in RelationPredictor vs the trainer max abs {worst:.3g} (limit 1e-5); "
          f"f32 card vs CPU relative {[f'{r:.3g}' for r in rel]} (limit 1e-4)")
    return {"steps_per_s": steps_per_s, "f32_rel": max(rel), "profile": prof,
            "dataset_launches": built["launches"]}


def recipe_gnn_visual(dev, root):
    """The ``gnn_visual`` recipe: ``--image_input --visual_backbone
    ARU_cutted_v1 --schedule warmup_final_decay``, one epoch."""
    from citlab_as_tpu_torch.scripts import train_pipeline_gnn as recipe
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    log = RecipeSteps(TrainerGNN, "_make_train_step", dev)
    try:
        t0 = time.perf_counter()
        recipe.main(["--model_dir", os.path.join(root, "gnn_visual"), "--work_dir",
                     os.path.join(root, "pipeline_cutted"), "--num_pages", str(RECIPE_PAGES),
                     "--epochs", "1", "--samples_per_epoch", str(RECIPE_SAMPLES),
                     "--batch_size", str(RECIPE_BATCH), "--separator_model_dir",
                     os.path.join(REPO, "models_ckpt", "separator"), "--image_input",
                     "--visual_backbone", "ARU_cutted_v1", "--schedule", "warmup_final_decay"])
        wall = time.perf_counter() - t0
    finally:
        log.restore()
    losses = [float(v) for v in log.losses]
    check(len(losses) == RECIPE_SAMPLES // RECIPE_BATCH and all(np.isfinite(losses))
          and set(log.k1) == {0}, f"recipes: gnn_visual recipe losses {losses}, K1 {log.k1}")
    steps_per_s = len(losses) / log.trainers[0].timings["steps"]
    print(f"recipes: train_pipeline_gnn --image_input --visual_backbone ARU_cutted_v1 "
          f"--schedule warmup_final_decay, 1 epoch: {len(losses)} steps, {steps_per_s:.3f} "
          f"steps/s of train step, no K1 launch in them; losses {[round(v, 5) for v in losses]}; "
          f"main {wall:.2f} s")
    return {"steps_per_s": steps_per_s}


def recipe_synthetic_gnn(root):
    """``train_synthetic_gnn`` at its defaults."""
    from citlab_as_tpu_torch.scripts import train_synthetic_gnn as recipe
    t0 = time.perf_counter()
    result = recipe.main(["--model_dir", os.path.join(root, "gnn_synthetic")])
    wall = time.perf_counter() - t0
    f1 = result["best_metrics"].get("f1", float("nan"))
    print(f"recipes: train_synthetic_gnn at its defaults: best f1 {f1:.4f} (floor "
          f"{SYNTH_GNN_F1_FLOOR}), {wall:.2f} s; history {json.dumps(result['history'][-1])}")
    check(f1 >= SYNTH_GNN_F1_FLOOR, f"recipes: train_synthetic_gnn best f1 {f1}")
    return {"best_f1": f1, "seconds": wall}


def recipe_eval_visual(dev):
    """``eval_visual_gnn`` over its five seeds with the committed
    ``gnn_visual``."""
    from citlab_as_tpu_torch.scripts import eval_visual_gnn as recipe
    evaluate, runs = recipe.evaluate_seed, []

    def counting_evaluate(*args, **kwargs):
        before = _counts()
        out = evaluate(*args, **kwargs)
        runs.append((out[2], [a - b for a, b in zip(_counts(), before)]))
        return out
    recipe.evaluate_seed = counting_evaluate
    try:
        t0 = time.perf_counter()
        mean = recipe.main(["--seeds", EVAL_SEEDS])
        wall = time.perf_counter() - t0
    finally:
        recipe.evaluate_seed = evaluate
    fs = [f for f, _ in runs]
    check(all(launches == [138, 1] for _, launches in runs),
          f"recipes: eval_visual_gnn launches per seed {[l for _, l in runs]}")
    print(f"recipes: eval_visual_gnn over seeds {EVAL_SEEDS}: AS F {fs}, mean {mean:.4f}, "
          f"min {min(fs):.4f} (mean floor {VISUAL_AS_F1_FLOOR}); {wall:.2f} s; K1 138 and K2 1 "
          f"per seed")
    check(mean > VISUAL_AS_F1_FLOOR, f"recipes: eval_visual_gnn mean AS F {mean}")
    return {"mean": mean, "min": min(fs)}


def phase_recipes(dev):
    """The recipes that made ``models_ckpt/`` on the card (see the module
    docstring, phase 19)."""
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    root = tempfile.mkdtemp(prefix="chip_smoke_recipes_")
    try:
        k1.launches = k2.launches = 0
        out = {"separator": recipe_separator(dev, root),
               "pipeline": recipe_pipeline(dev, root),
               "gnn_visual": recipe_gnn_visual(dev, root),
               "synthetic_gnn": recipe_synthetic_gnn(root),
               "eval_visual": recipe_eval_visual(dev)}
        out["launches"] = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


DP_SHARDS = 2                               # data shards of the one card's mesh
DP_SEED = 41
DP_SEG_BATCH, DP_SEG_CROP = 8, 512          # the separator recipe's batch and crop
DP_SEG_WARM, DP_SEG_TIMED = 2, 10           # bf16 steps off the clock, then timed
DP_CHECK_STEPS = 3                          # f32 steps of the sharded-vs-unsharded check
DP_CLASS_WEIGHTS = (8.0, 1.0)               # the separator recipe's
DP_GNN_BATCH, DP_GNN_TIMED = 16, 10
DP_VISUAL_BATCH, DP_VISUAL_STEPS = 8, 2
DP_WEIGHT_DECAY = 1e-4
DP_EMA_DECAY = 0.99
#: sharded against unsharded from the same start, after one step: the
#: difference norm over the whole net's parameters, and over its gradient
#: (the sum the sharded step applies against the whole batch's), each over
#: its own norm. Not per leaf: Adam turns float32 summation noise in a
#: gradient near zero into up to a step of lr (a first step from a zero
#: state into a step of +-lr), and the card's cuDNN backward over half
#: batches sums in another order from call to call, so a leaf of a few
#: small elements can lie 5e-4-8e-4 of its norm from the unsharded one, and
#: once in 12 first steps the whole net 2e-4; the ARU_v1 net's region max
#: pool sends a gradient to another cell where a near tie resolves
#: otherwise, up to 3.9e-4 of the whole gradient (PERF.md, Findings). A
#: dropped shard or a mean of shard means moves these by far more (the
#: losses' gate holds the latter)
DP_PARAM_TOL = 1e-3
DP_GRAD_TOL = 1e-2


def sync_cards():
    import torch
    for index in range(torch.cuda.device_count()):
        torch.cuda.synchronize(index)


def dp_replicas_equal(label, trees):
    """Gate: every replica's tensors (parameters, optimizer slots, EMA
    shadows) and counters bit-equal to shard 0's."""
    import torch
    from citlab_as_tpu_torch.parallel.mesh import _leaves
    first = _leaves(trees[0])
    for i, tree in enumerate(trees[1:], 1):
        leaves = _leaves(tree)
        check(len(leaves) == len(first), f"dp_train: {label}: replica {i}'s tree differs")
        for a, b in zip(leaves, first):
            same = (torch.equal(a.to(b.device), b) if isinstance(a, torch.Tensor) else a == b)
            check(same, f"dp_train: {label}: replica {i} is not bit-equal to shard 0's")


def dp_gaps(got, want):
    """(difference norm over the whole tree over its norm, the largest such
    ratio of one leaf, that leaf's name) of two ``{name: tensor}`` trees."""
    import torch
    with torch.no_grad():
        diff = norm = 0.0
        leaves = {}
        for k, w in want.items():
            d = float(torch.linalg.vector_norm((got[k].to(w.device) - w).double())) ** 2
            n = float(torch.linalg.vector_norm(w.double())) ** 2
            diff, norm = diff + d, norm + n
            leaves[k] = (d / max(n, 1e-60)) ** 0.5
    worst = max(leaves, key=leaves.get)
    return (diff / max(norm, 1e-60)) ** 0.5, leaves[worst], worst


def dp_grads(params_list):
    """The gradients a sharded step applied: each replica's own gradient
    (None: a zero) summed in shard order, as ``reduce_gradients`` sums
    them."""
    import torch
    first = params_list[0]
    return {k: sum((torch.zeros_like(p) if p.grad is None else p.grad).to(first[k].device)
                   for p in (params[k] for params in params_list))
            for k in first}


def dp_timed(step, batches):
    """Each step's wall (device-synced before and after), the losses read
    after the clock stops."""
    walls, losses = [], []
    for batch in batches:
        sync_cards()
        t0 = time.perf_counter()
        losses.append(step(batch))
        sync_cards()
        walls.append(time.perf_counter() - t0)
    return walls, [float(v) for v in losses]


def dp_set(dst, src):
    """Copy the tree ``src`` into the live tree ``dst`` (tensors in place,
    counters by value)."""
    import torch
    with torch.no_grad():
        for k, v in src.items():
            if isinstance(v, dict):
                dp_set(dst[k], v)
            elif isinstance(v, torch.Tensor):
                dst[k].copy_(v)
            else:
                dst[k] = v


def dp_align(single, sharded):
    """The unsharded run's parameters, optimizer state and EMA set to shard
    0's, bit for bit: the start the next two steps share."""
    dp_set(single["params"], sharded["params"][0])
    dp_set(single["state"], sharded["states"][0])
    if single.get("ema") is not None:
        dp_set(single["ema"], sharded["emas"][0])


def dp_compare(label, mesh, sharded, single, steps, trees):
    """Gates of each sharded step against one unsharded step on the whole
    batch from the same start (``dp_align`` before each), over ``steps``:
    the losses within 1e-5 relative; the gradient the sharded step applied
    within ``DP_GRAD_TOL`` and the parameters after the two steps within
    ``DP_PARAM_TOL`` of the unsharded ones (each over the whole net); the
    replicas (``trees()``, one tree per replica) bit-equal after every step.
    Returns the sharded losses, the relative loss gaps, the net's and the
    worst leaf's parameter and gradient gaps, the K1 launches of each
    sharded step and both steps' walls (device-synced)."""
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    out = {k: [] for k in ("losses", "rel", "gaps", "leaf_gaps", "grad_gaps",
                           "grad_leaf_gaps", "k1", "walls", "single_walls")}
    for i in steps:
        dp_align(single, sharded)
        before = k1.launches
        (wall,), (got,) = dp_timed(sharded["step"], [i])
        out["k1"].append(k1.launches - before)
        (single_wall,), (want,) = dp_timed(single["step"], [i])
        out["losses"].append(got)
        out["walls"].append(wall)
        out["single_walls"].append(single_wall)
        out["rel"].append(abs(got - want) / abs(want))
        gap, leaf_gap, leaf = dp_gaps(sharded["params"][0], single["params"])
        out["gaps"].append(gap)
        out["leaf_gaps"].append((leaf_gap, leaf))
        gap, leaf_gap, leaf = dp_gaps(dp_grads(sharded["params"]), dp_grads([single["params"]]))
        out["grad_gaps"].append(gap)
        out["grad_leaf_gaps"].append((leaf_gap, leaf))
        dp_replicas_equal(label, trees())
    print(f"dp_train: {label}: {dp_readings(out)}")
    check(max(out["rel"]) <= 1e-5,
          f"dp_train: {label}: sharded vs unsharded losses differ by {out['rel']}")
    check(max(out["grad_gaps"]) <= DP_GRAD_TOL,
          f"dp_train: {label}: sharded vs unsharded gradients differ by {out['grad_gaps']}")
    check(max(out["gaps"]) <= DP_PARAM_TOL,
          f"dp_train: {label}: sharded vs unsharded parameters differ by {out['gaps']}")
    return out


def dp_readings(got):
    """The comparison's readings as one clause of a printed line."""
    def fmt(values):
        return [f"{v:.3g}" for v in values]

    def worst(pairs):
        return [f"{v:.3g} ({k})" for v, k in pairs]
    return (f"losses relative {fmt(got['rel'])} (limit 1e-5), applied gradient "
            f"{fmt(got['grad_gaps'])} of its norm (limit {DP_GRAD_TOL}; worst leaf "
            f"{worst(got['grad_leaf_gaps'])}), parameters {fmt(got['gaps'])} of their norm "
            f"(limit {DP_PARAM_TOL}; worst leaf {worst(got['leaf_gaps'])})")


def dp_seg_batches(root, dev):
    """The bf16 run's batches: 8 x 512 x 512 crops of the train phase's
    drawn GT pages (column rule against the rest), as a user fine-tunes the
    separator on GT of their own, with a validity mask that keeps the top
    (B + i) / 2B of page i's rows: every shard carries another weight."""
    import torch
    from citlab_as_tpu_torch.train.seg_input_pipeline import (
        SegmentationDataset, find_gt_examples,
    )
    gt = write_seg_gt(os.path.join(root, "seg_gt"), SEG_GT_PAGES, TRAIN_PAGE_SHAPE,
                      seed=DP_SEED)
    data = SegmentationDataset(find_gt_examples(gt), (DP_SEG_CROP, DP_SEG_CROP),
                               augment=False, seed=DP_SEED)
    keep = np.ones((DP_SEG_BATCH, DP_SEG_CROP, DP_SEG_CROP), np.float32)
    for i in range(DP_SEG_BATCH):
        keep[i, DP_SEG_CROP * (DP_SEG_BATCH + i) // (2 * DP_SEG_BATCH):] = 0.0
    return [{"image": torch.from_numpy(b["image"]).to(dev),
             "label": torch.from_numpy(b["label"]).to(dev),
             "mask": torch.from_numpy(b["mask"] * keep).to(dev)}
            for b in data.batches(DP_SEG_BATCH, DP_SEG_WARM + DP_SEG_TIMED)]


def dp_segmentation(dev, mesh, label, root):
    """The separator net at full width from ``separator.npz``, the recipe's
    class weights and optimizer: f32 sharded vs unsharded, then bf16 timed
    beside the unsharded step on the same batches."""
    import torch
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.parallel.mesh import reduce_gradients, replicate, shard_batch
    from citlab_as_tpu_torch.train.optimizer import adam, cosine_decay_schedule
    from citlab_as_tpu_torch.train.segmentation import (
        create_model, make_sharded_train_step, make_train_step, pixel_weights,
    )
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz
    init = arunet_state_dict_from_flax(
        load_npz(os.path.join(REPO, "models_ckpt_torch", "separator.npz")))
    optimizer = adam(cosine_decay_schedule(1e-3, DP_SEG_WARM + DP_SEG_TIMED, alpha=0.1))
    n = mesh.shape["data"]
    batches = dp_seg_batches(root, dev)
    shards = [shard_batch(mesh, b) for b in batches]

    def build(dtype):
        model = create_model(dtype=dtype)
        model.load_state_dict(init)
        model = model.to(dev)
        replicas = replicate(mesh, model)
        params = [dict(r.named_parameters()) for r in replicas]
        states = [optimizer.init(p) for p in params]
        step = make_sharded_train_step(replicas, optimizer, mesh, DP_CLASS_WEIGHTS)
        single_params = dict(model.named_parameters())
        single_state = optimizer.init(single_params)
        single = make_train_step(model, optimizer, DP_CLASS_WEIGHTS)
        return ({"step": lambda i: step(params, states, shards[i]), "params": params,
                 "states": states},
                {"step": lambda i: single(single_params, single_state, batches[i]),
                 "params": single_params, "state": single_state})

    weights = [float(torch.sum(pixel_weights(b["label"], b["mask"], DP_CLASS_WEIGHTS)))
               for b in shards[0]]
    check(len(set(weights)) == n, f"dp_train: {label}: shard weights {weights} are not uneven")
    sharded, single = build(torch.float32)
    f32 = dp_compare(f"{label}, segmentation f32", mesh, sharded, single,
                     range(DP_CHECK_STEPS),
                     lambda: [[p, s] for p, s in zip(sharded["params"], sharded["states"])])
    del sharded, single

    sharded, single = build(torch.bfloat16)
    k1_bf16, losses, walls = [], [], []
    for i in range(DP_SEG_WARM + DP_SEG_TIMED):
        before = k1.launches
        wall, loss = dp_timed(sharded["step"], [i])
        k1_bf16.append(k1.launches - before)
        walls += wall
        losses += loss
        dp_replicas_equal(f"{label}, segmentation bf16",
                          [[p, s] for p, s in zip(sharded["params"], sharded["states"])])
    single_walls, single_losses = dp_timed(single["step"], range(DP_SEG_WARM + DP_SEG_TIMED))
    check(f32["k1"] == [69 * n] * DP_CHECK_STEPS and k1_bf16 == [69 * n] * len(k1_bf16),
          f"dp_train: {label}: K1 launches per sharded segmentation step {f32['k1']}, "
          f"{k1_bf16}; want {69 * n}")
    check(all(np.isfinite(losses)), f"dp_train: {label}: bf16 sharded losses {losses}")
    first = abs(losses[0] - f32["losses"][0]) / abs(f32["losses"][0])
    check(first <= 2e-2,
          f"dp_train: {label}: bf16 first loss {losses[0]} vs f32 {f32['losses'][0]}")
    rate = DP_SEG_TIMED / sum(walls[DP_SEG_WARM:])
    single_rate = DP_SEG_TIMED / sum(single_walls[DP_SEG_WARM:])
    grads = [{k: p.grad for k, p in params.items()} for params in sharded["params"]]
    reduce_ms = cuda_ms(lambda: reduce_gradients(mesh, grads, sharded["params"]))
    print(f"dp_train: {label}: segmentation at the separator's width, batch "
          f"{DP_SEG_BATCH} x {DP_SEG_CROP} x {DP_SEG_CROP} ({DP_SEG_BATCH // n} per shard), "
          f"class weights {DP_CLASS_WEIGHTS}, shard weights {weights}; f32 (TF32 off) "
          f"sharded vs unsharded, each step from the same start: {dp_readings(f32)}; "
          f"bf16: {rate:.3f} sharded steps/s beside {single_rate:.3f} "
          f"unsharded (steps {DP_SEG_WARM + 1}-{DP_SEG_WARM + DP_SEG_TIMED}, wall, "
          f"device-synced), losses {[round(v, 5) for v in losses]}, first vs f32 "
          f"{first:.3g} (limit 2e-2), unsharded {[round(v, 5) for v in single_losses]}; "
          f"K1 {69 * n} per sharded step; reduce_gradients {reduce_ms:.4f} ms (CUDA events, "
          f"mean of 10) over {sum(p.numel() for p in sharded['params'][0].values())} "
          f"gradients per shard; replicas bit-equal after every step")
    return {"steps_per_s": rate, "unsharded_steps_per_s": single_rate,
            "f32_rel": max(f32["rel"]), "f32_param_gap": max(f32["gaps"]),
            "f32_grad_gap": max(f32["grad_gaps"]), "reduce_ms": reduce_ms}


def dp_gnn_graph(rng, n):
    """A page graph of ``n`` Delaunay-connected regions in three articles,
    with its relation ground truth."""
    graph = _delaunay_graph(rng, n)
    article = [3 * i // n for i in range(n)]
    graph["gt_relations"] = [[1, i, j] for i in range(n) for j in range(n)
                             if article[i] == article[j]]
    return graph


def dp_gnn_batches(input_fn, n_data, steps, batch_size, seed, visual_paths=None):
    """``steps`` training batches (the trainer's sampling of 300 relations
    per graph) whose shards hold graphs of other sizes: shard s's graphs
    have 4 + 6 s to 9 + 6 s nodes, so its count of valid relations differs
    from every other shard's."""
    rng = np.random.RandomState(seed)
    per = batch_size // n_data
    out = []
    for _ in range(steps):
        examples = []
        for i in range(batch_size):
            if visual_paths is not None:
                path = visual_paths[i % len(visual_paths)]
                with open(path) as f:
                    graph = json.load(f)
            else:
                path, graph = None, dp_gnn_graph(rng, 4 + 6 * (i // per) + rng.randint(6))
            examples.append(input_fn.prepare_example(graph, training=True, json_path=path))
        out.append(input_fn._stack_to_common_shape(examples))
    return out


def dp_visual_pages(root, n_pages, seed):
    """``n_pages`` random grey pages (``g<i>.png``) with feature JSONs of
    region graphs (``json/g<i>.json``) whose sizes grow with the page
    index, as ``build_dataset`` writes them for the visual nets."""
    from citlab_as_tpu_torch.utils.io import save_png
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "json"), exist_ok=True)
    paths = []
    for g in range(n_pages):
        h, w = 384, 288
        save_png(os.path.join(root, f"g{g}.png"), (rng.rand(h, w) * 255).astype(np.uint8))
        graph = dp_gnn_graph(rng, 4 + 2 * g)
        regions = []
        for _ in range(graph["num_nodes"]):
            x0, y0 = rng.randint(0, w - 40), rng.randint(0, h - 40)
            x1, y1 = x0 + rng.randint(8, 40), y0 + rng.randint(8, 40)
            regions.append([[x0, x1, x1, x0], [y0, y0, y1, y1]])
        graph["visual_regions_nodes"] = regions
        graph["num_points_visual_regions_nodes"] = [4] * graph["num_nodes"]
        path = os.path.join(root, "json", f"g{g}.json")
        with open(path, "w") as f:
            json.dump(graph, f)
        paths.append(path)
    return paths


def dp_relation(dev, mesh, label, root, visual):
    """The relation trainer's step sharded against its unsharded step from
    the same start: the ``gnn`` checkpoint's net (batch 16, weight decay and
    EMA), or the ARU_v1 visual net (f32, batch 8 at 384 x 384, K1 under
    autograd in each shard's backbone)."""
    import copy
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.parallel.mesh import replicate, shard_batch
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train.input_pipeline import InputGNN, torch_batch
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    from citlab_as_tpu_torch.weights import load_npz
    n = mesh.shape["data"]
    name = "ARU_v1 visual GNN" if visual else "relation GNN"
    if visual:
        batch_size, steps = DP_VISUAL_BATCH, DP_VISUAL_STEPS
        input_params = {"image_input": True, "resize_min_dim": RECIPE_IMAGE_DIMS[0],
                        "resize_max_dim": RECIPE_IMAGE_DIMS[1]}
        flags = {"weight_decay": DP_WEIGHT_DECAY, "batch_size": batch_size}
        kw = {"model": GraphRelation(15, 2, image_input=True, visual_backbone="ARU_v1")}
        paths = dp_visual_pages(os.path.join(root, "visual"), batch_size, DP_SEED)
    else:
        batch_size, steps = DP_GNN_BATCH, DP_CHECK_STEPS + DP_GNN_TIMED
        input_params, paths = None, None
        flags = {"weight_decay": DP_WEIGHT_DECAY, "ema_decay": DP_EMA_DECAY,
                 "batch_size": batch_size}
        kw = {"init_params": load_npz(os.path.join(REPO, "models_ckpt_torch", "gnn.npz"))}
    trainer = TrainerGNN(os.path.join(root, f"trainer_{visual}"), [], [], flags=flags,
                         input_params=input_params, seed=0, device=dev, **kw)
    batches = dp_gnn_batches(trainer.input_fn, n, steps, batch_size, DP_SEED, paths)
    trainer._build_model(batches[0])
    single_model = copy.deepcopy(trainer.model)
    replicas = replicate(mesh, trainer.model)
    params = [dict(r.named_parameters()) for r in replicas]
    states = [trainer.optimizer.init(p) for p in params]
    emas = [ckpt.ema_init(p) for p in params] if not visual else None
    step = trainer._make_sharded_train_step(mesh, replicas)
    trainer.model = single_model
    single_params = dict(single_model.named_parameters())
    single_state = trainer.optimizer.init(single_params)
    single_ema = ckpt.ema_init(single_params) if not visual else None
    single = trainer._make_train_step()
    whole = [torch_batch(b, dev) for b in batches]
    shards = [shard_batch(mesh, b) for b in whole]
    counts = [int(s["num_relations_to_consider"].sum()) for s in shards[0]]
    check(len(set(counts)) == n, f"dp_train: {label}: {name} valid relations per shard "
                                 f"{counts} are not uneven")

    def single_step(i):
        loss = single(single_params, single_state, whole[i])
        if single_ema is not None:
            ckpt.ema_update(single_ema, single_params, DP_EMA_DECAY)
        return loss

    sharded = {"step": lambda i: step(params, states, shards[i], emas), "params": params,
               "states": states, "emas": emas}

    def trees():
        return [[p, s] + ([emas[i]] if emas else [])
                for i, (p, s) in enumerate(zip(params, states))]

    n_check = DP_VISUAL_STEPS if visual else DP_CHECK_STEPS
    got = dp_compare(f"{label}, {name}", mesh, sharded,
                     {"step": single_step, "params": single_params, "state": single_state,
                      "ema": single_ema}, range(n_check), trees)
    want_k1 = 69 * n if visual else 0
    check(got["k1"] == [want_k1] * n_check,
          f"dp_train: {label}: K1 launches per sharded {name} step {got['k1']}, want {want_k1}")
    if visual:         # the checked steps, the first included
        walls, single_walls = got["walls"], got["single_walls"]
    else:
        walls, _ = dp_timed(sharded["step"], range(DP_CHECK_STEPS, steps))
        single_walls, _ = dp_timed(single_step, range(DP_CHECK_STEPS, steps))
        dp_replicas_equal(f"{label}, {name}", trees())
    rate, single_rate = len(walls) / sum(walls), len(single_walls) / sum(single_walls)
    print(f"dp_train: {label}: {name}, batch {batch_size} ({batch_size // n} per shard), "
          f"valid relations per shard {counts}, weight decay {DP_WEIGHT_DECAY}"
          + ("" if visual else f", EMA {DP_EMA_DECAY}") + f"; f32 sharded vs unsharded over "
          f"{n_check} steps, each from the same start: {dp_readings(got)}; K1 {want_k1} per "
          f"sharded step; {rate:.3f} sharded "
          f"steps/s beside {single_rate:.3f} unsharded over {len(walls)} steps (wall, "
          f"device-synced" + (", the first included" if visual else "")
          + "); replicas bit-equal after every step")
    return {"steps_per_s": rate, "unsharded_steps_per_s": single_rate,
            "f32_rel": max(got["rel"]), "f32_param_gap": max(got["gaps"]),
            "f32_grad_gap": max(got["grad_gaps"])}


def phase_dp_train(dev):
    """Data-parallel training over a mesh (see the module docstring, phase
    20)."""
    import torch
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    meshes = {f"{DP_SHARDS} shards of one card": make_mesh([dev] * DP_SHARDS)}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = make_mesh()
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_train_")
    out = {}
    try:
        k1.launches = k2.launches = 0
        for label, mesh in meshes.items():
            out[label] = {"segmentation": dp_segmentation(dev, mesh, label,
                                                          os.path.join(root, str(len(out)))),
                          "gnn": dp_relation(dev, mesh, label, os.path.join(root, str(len(out))),
                                             visual=False),
                          "visual": dp_relation(dev, mesh, label,
                                                os.path.join(root, str(len(out))), visual=True)}
        out["launches"] = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(out["launches"]["separator_morphology"] == 0,
          f"dp_train: K2 launched {out['launches']['separator_morphology']} times")
    return out


DP_PROCS_TIMEOUT = 360                      # seconds each dp_procs worker may take
DP_PROCS_ONE_CARD = 2                       # processes on a machine of one card


def dp_cpu(tree):
    """``tree`` (dicts / lists of tensors and counters) with every tensor
    detached and copied to the host."""
    import torch
    from citlab_as_tpu_torch.parallel.mesh import _map_tree
    return _map_tree(lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x,
                     tree)


def dp_digest(tree):
    """sha256 over the bytes of every tensor of ``tree`` and every counter,
    in order: two processes' replicas are bit-equal where their digests
    are."""
    import hashlib
    import torch
    from citlab_as_tpu_torch.parallel.mesh import _leaves
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def dp_seg_setup(dev, mesh, root):
    """The separator net at full width from ``separator.npz`` over ``mesh``
    with the recipe's optimizer and class weights, and the dp_train
    batches (``root/seg_batches.pt``) split over its shards: ``build(dtype)
    -> (step(i), params, states)`` and the optimizer."""
    import torch
    from citlab_as_tpu_torch.parallel.mesh import replicate, shard_batch
    from citlab_as_tpu_torch.train.optimizer import adam, cosine_decay_schedule
    from citlab_as_tpu_torch.train.segmentation import create_model, make_sharded_train_step
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz
    init = arunet_state_dict_from_flax(
        load_npz(os.path.join(REPO, "models_ckpt_torch", "separator.npz")))
    optimizer = adam(cosine_decay_schedule(1e-3, DP_SEG_WARM + DP_SEG_TIMED, alpha=0.1))
    batches = torch.load(os.path.join(root, "seg_batches.pt"))
    shards = [shard_batch(mesh, {k: v.to(dev) for k, v in b.items()}) for b in batches]

    def build(dtype):
        model = create_model(dtype=dtype)
        model.load_state_dict(init)
        replicas = replicate(mesh, model.to(dev))
        params = [dict(r.named_parameters()) for r in replicas]
        states = [optimizer.init(p) for p in params]
        step = make_sharded_train_step(replicas, optimizer, mesh, DP_CLASS_WEIGHTS)
        return (lambda i: step(params, states, shards[i])), params, states
    return build


def dp_gnn_setup(dev, mesh, root, name):
    """The relation trainer at the ``gnn`` checkpoint's widths from
    ``gnn.npz`` (weight decay and EMA) over ``mesh``, on the batches of
    ``root/gnn_batches.pkl``: ``(step(i), params, states, emas)``."""
    from citlab_as_tpu_torch.parallel.mesh import replicate, shard_batch
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train.input_pipeline import torch_batch
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    from citlab_as_tpu_torch.weights import load_npz
    with open(os.path.join(root, "gnn_batches.pkl"), "rb") as f:
        batches = pickle.load(f)
    trainer = TrainerGNN(os.path.join(root, f"trainer_{name}"), [], [],
                         flags={"weight_decay": DP_WEIGHT_DECAY, "ema_decay": DP_EMA_DECAY,
                                "batch_size": DP_GNN_BATCH}, seed=0, device=dev,
                         init_params=load_npz(os.path.join(REPO, "models_ckpt_torch",
                                                           "gnn.npz")))
    trainer._build_model(batches[0])
    replicas = replicate(mesh, trainer.model)
    params = [dict(r.named_parameters()) for r in replicas]
    states = [trainer.optimizer.init(p) for p in params]
    emas = [ckpt.ema_init(p) for p in params]
    step = trainer._make_sharded_train_step(mesh, replicas)
    shards = [shard_batch(mesh, torch_batch(b, dev)) for b in batches]
    return (lambda i: step(params, states, shards[i], emas)), params, states, emas


def dp_procs_worker(root, backend):
    """One process of the dp_procs phase: ``initialize_multihost`` (its
    card pinned), a mesh of every process's cards, the f32 segmentation
    steps (rank 0 saves each step's start and end for the main process's
    check), the timed bf16 steps, ``reduce_gradients`` timed, the relation
    steps; a digest of the replicas after every step, K1 and K2 launches.
    Writes ``root/result_<rank>.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    from citlab_as_tpu_torch.parallel.mesh import (
        initialize_multihost, local_devices, make_mesh, reduce_gradients,
    )
    check(initialize_multihost(backend=backend) is True, "dp_procs: no process group")
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        dev = local_devices()[0]
        mesh = make_mesh()
        out = {"rank": rank, "world": world, "device": str(dev),
               "card": torch.cuda.current_device(), "backend": dist.get_backend(), "mesh": repr(mesh), "local_rows": mesh.local_rows}
        k1.launches = k2.launches = 0
        build = dp_seg_setup(dev, mesh, root)

        def saved(tag, params, states, emas=None):
            if rank == 0:
                tree = {"params": params[0], "state": states[0]}
                if emas is not None:
                    tree["ema"] = emas[0]
                torch.save(dp_cpu(tree), os.path.join(root, f"{tag}.pt"))

        seg = {k: [] for k in ("f32_losses", "f32_k1", "f32_digests", "losses", "k1", "walls",
                               "digests")}
        step, params, states = build(torch.float32)
        for i in range(DP_CHECK_STEPS):
            saved(f"seg_before_{i}", params, states)
            before = k1.launches
            (wall,), (loss,) = dp_timed(step, [i])
            seg["f32_k1"].append(k1.launches - before)
            seg["f32_losses"].append(loss)
            seg["f32_digests"].append(dp_digest([params, states]))
            saved(f"seg_after_{i}", params, states)
        del step, params, states
        step, params, states = build(torch.bfloat16)
        for i in range(DP_SEG_WARM + DP_SEG_TIMED):
            before = k1.launches
            (wall,), (loss,) = dp_timed(step, [i])
            seg["k1"].append(k1.launches - before)
            seg["walls"].append(wall)
            seg["losses"].append(loss)
            seg["digests"].append(dp_digest([params, states]))
        grads = [{k: p.grad for k, p in shard.items()} for shard in params]
        seg["reduce_ms"] = cuda_ms(lambda: reduce_gradients(mesh, grads, params))
        seg["gradients"] = sum(p.numel() for p in params[0].values())
        out["seg"] = seg
        del step, params, states, grads
        torch.cuda.empty_cache()

        gnn = {k: [] for k in ("losses", "digests", "walls")}
        step, params, states, emas = dp_gnn_setup(dev, mesh, root, str(rank))
        for i in range(DP_CHECK_STEPS + DP_GNN_TIMED):
            if i < DP_CHECK_STEPS:
                saved(f"gnn_before_{i}", params, states, emas)
            (wall,), (loss,) = dp_timed(step, [i])
            gnn["walls"].append(wall)
            gnn["losses"].append(loss)
            gnn["digests"].append(dp_digest([params, states, emas]))
            if i < DP_CHECK_STEPS:
                saved(f"gnn_after_{i}", params, states, emas)
        out["gnn"] = gnn
        out["launches"] = {"conv3x3": k1.launches, "separator_morphology": k2.launches}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"result_{rank}.pt"))
    return 0


def dp_procs_spawn(root, world, backend):
    """``world`` processes of :func:`dp_procs_worker` over one coordinator
    port, each with torchrun's variables (and, on a machine of several
    cards, ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK``, which pin it to its card).
    A process that fails, or outlives ``DP_PROCS_TIMEOUT`` seconds, fails
    the phase; every process is stopped before this returns."""
    import torch
    port = str(_free_port())
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2")
    if torch.cuda.device_count() > 1:
        env["LOCAL_WORLD_SIZE"] = str(world)
    procs = []
    try:
        for rank in range(world):
            log = open(os.path.join(root, f"log_{rank}.txt"), "w")
            extra = {"RANK": str(rank)}
            if "LOCAL_WORLD_SIZE" in env:
                extra["LOCAL_RANK"] = str(rank)
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-procs-worker", root, backend],
                cwd=REPO, env=dict(env, **extra), stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.perf_counter() + DP_PROCS_TIMEOUT
        for proc, _ in procs:
            try:
                proc.wait(timeout=max(deadline - time.perf_counter(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
    results = []
    for rank, (proc, _) in enumerate(procs):
        path = os.path.join(root, f"result_{rank}.pt")
        if proc.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(root, f"log_{rank}.txt")) as f:
                raise Fail(f"dp_procs: process {rank} of {world} exited {proc.returncode} "
                           f"(killed at {DP_PROCS_TIMEOUT} s if negative): {f.read()[-3000:]}")
        results.append(torch.load(path))
    return results


def dp_procs_compare(label, root, kind, results, step, params, states, emas=None):
    """Gates of the processes' f32 steps against the in-process sharded
    ``step`` over a mesh of as many shards on the same cards, each step from
    the process run's start (its rank 0's saved state, set into every
    in-process replica): the loss within 1e-5 relative, the parameters after
    it (and the EMA) within ``DP_PARAM_TOL`` of their norms over the whole
    net. Returns the relative loss gaps and the whole net's and the worst
    leaf's parameter gaps."""
    import torch
    out = {"rel": [], "gaps": [], "leaf_gaps": [], "ema_gaps": []}
    for i in range(DP_CHECK_STEPS):
        start = torch.load(os.path.join(root, f"{kind}_before_{i}.pt"))
        end = torch.load(os.path.join(root, f"{kind}_after_{i}.pt"))
        for j in range(len(params)):
            dp_set(params[j], start["params"])
            dp_set(states[j], start["state"])
            if emas is not None:
                dp_set(emas[j], start["ema"])
        want = float(step(i))
        losses = results[0][kind]["f32_losses" if kind == "seg" else "losses"]
        out["rel"].append(abs(losses[i] - want) / abs(want))
        gap, leaf_gap, leaf = dp_gaps(end["params"], params[0])
        out["gaps"].append(gap)
        out["leaf_gaps"].append((leaf_gap, leaf))
        if emas is not None:
            out["ema_gaps"].append(dp_gaps(end["ema"], emas[0])[0])
    check(max(out["rel"]) <= 1e-5,
          f"dp_procs: {label}: process and in-process losses differ by {out['rel']}")
    check(max(out["gaps"] + out["ema_gaps"]) <= DP_PARAM_TOL,
          f"dp_procs: {label}: process and in-process parameters differ by {out['gaps']}, "
          f"EMA {out['ema_gaps']}")
    return out


def phase_dp_procs(dev, dp_train_row):
    """Data-parallel training across processes (see the module docstring,
    phase 21)."""
    import torch
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    from citlab_as_tpu_torch.train.input_pipeline import InputGNN
    cards = torch.cuda.device_count()
    world = cards if cards > 1 else DP_PROCS_ONE_CARD
    backend = "nccl" if cards > 1 else "gloo"     # nccl refuses two ranks on one card
    mesh = make_mesh() if cards > 1 else make_mesh([dev] * world)
    in_process = (dp_train_row or {}).get(
        f"{cards} cards" if cards > 1 else f"{DP_SHARDS} shards of one card")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_procs_")
    try:
        batches = dp_seg_batches(root, torch.device("cpu"))
        torch.save(batches, os.path.join(root, "seg_batches.pt"))
        with open(os.path.join(root, "gnn_batches.pkl"), "wb") as f:
            pickle.dump(dp_gnn_batches(InputGNN(None, num_classes=2, seed=0), world,
                                       DP_CHECK_STEPS + DP_GNN_TIMED,
                                       DP_GNN_BATCH, DP_SEED), f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results = dp_procs_spawn(root, world, backend)
        spawn_s = time.perf_counter() - t0
        check([r["backend"] for r in results] == [backend] * world,
              f"dp_procs: backends {[r['backend'] for r in results]}")
        check([r["local_rows"] for r in results] == [[r] for r in range(world)],
              f"dp_procs: rows per process {[r['local_rows'] for r in results]}")
        seg = [r["seg"] for r in results]
        gnn = [r["gnn"] for r in results]
        for key, runs in (("f32_digests", seg), ("digests", seg), ("digests", gnn)):
            for i, digests in enumerate(zip(*(run[key] for run in runs))):
                check(len(set(digests)) == 1, f"dp_procs: {key} step {i}: the processes' "
                                              "replicas are not bit-equal")
        k1_steps = [sum(run[key][i] for run in seg) for key in ("f32_k1", "k1")
                    for i in range(len(seg[0][key]))]
        check(k1_steps == [69 * world] * len(k1_steps),
              f"dp_procs: K1 launches per step over all processes {k1_steps}, want "
              f"{69 * world}")
        launches = {k: sum(r["launches"][k] for r in results)
                    for k in ("conv3x3", "separator_morphology")}
        check(launches["separator_morphology"] == 0,
              f"dp_procs: K2 launched {launches['separator_morphology']} times")
        for key, runs in (("f32_losses", seg), ("losses", seg), ("losses", gnn)):
            check(all(run[key] == runs[0][key] for run in runs),
                  f"dp_procs: the processes' {key} differ")
        check(all(np.isfinite(seg[0]["losses"])), f"dp_procs: bf16 losses {seg[0]['losses']}")

        # the in-process sharded steps from the same starts
        before = k1.launches
        build = dp_seg_setup(dev, mesh, root)
        step, params, states = build(torch.float32)
        seg_gates = dp_procs_compare("segmentation f32", root, "seg", results, step, params,
                                     states)
        del step, params, states
        step, params, states, emas = dp_gnn_setup(dev, mesh, root, "main")
        gnn_gates = dp_procs_compare("relation GNN", root, "gnn", results, step, params,
                                     states, emas)
        del step, params, states, emas
        k1.launches = before                 # the reference's launches are not the path's
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def rate(walls):
        return len(walls) / sum(walls)
    seg_rates = [rate(run["walls"][DP_SEG_WARM:]) for run in seg]
    gnn_rates = [rate(run["walls"][DP_CHECK_STEPS:]) for run in gnn]

    def beside(net, key, fmt=".3f"):
        return "not run" if in_process is None else format(in_process[net][key], fmt)
    place = "one card" if cards <= 1 else f"{cards} cards, one each"
    print(f"dp_procs: {world} processes over {backend} ({place}), each pinned by "
          f"initialize_multihost: cards {[r['card'] for r in results]}, {results[0]['mesh']}; "
          f"workers {spawn_s:.1f} s from spawn to exit")
    print(f"dp_procs: segmentation at the separator's width, batch {DP_SEG_BATCH} x "
          f"{DP_SEG_CROP} x {DP_SEG_CROP} ({DP_SEG_BATCH // world} per process), f32 against "
          f"the in-process sharded step over {mesh.shape['data']} shards of the same cards, "
          f"each step from the processes' start: losses relative "
          f"{[f'{v:.3g}' for v in seg_gates['rel']]} (limit 1e-5), parameters "
          f"{[f'{v:.3g}' for v in seg_gates['gaps']]} of their norm (limit {DP_PARAM_TOL}; "
          f"worst leaf {[f'{v:.3g} ({k})' for v, k in seg_gates['leaf_gaps']]}); bf16: "
          f"{[round(r, 3) for r in seg_rates]} steps/s per process (steps "
          f"{DP_SEG_WARM + 1}-{DP_SEG_WARM + DP_SEG_TIMED}, wall, device-synced) beside the "
          f"in-process {beside('segmentation', 'steps_per_s')} sharded and "
          f"{beside('segmentation', 'unsharded_steps_per_s')} unsharded (dp_train); "
          f"reduce_gradients {[round(run['reduce_ms'], 4) for run in seg]} ms per process "
          f"(CUDA events, mean of 10, all_gather included) beside "
          f"{beside('segmentation', 'reduce_ms', '.4f')} in process, over "
          f"{seg[0]['gradients']} gradients per shard; K1 {69 * world} per step over all "
          f"processes; replicas bit-equal across the processes after every step; bf16 losses "
          f"{[round(v, 5) for v in seg[0]['losses']]}")
    print(f"dp_procs: relation GNN, batch {DP_GNN_BATCH} ({DP_GNN_BATCH // world} per "
          f"process), weight decay {DP_WEIGHT_DECAY}, EMA {DP_EMA_DECAY}; f32 against the "
          f"in-process sharded step: losses relative {[f'{v:.3g}' for v in gnn_gates['rel']]}, "
          f"parameters {[f'{v:.3g}' for v in gnn_gates['gaps']]}, EMA "
          f"{[f'{v:.3g}' for v in gnn_gates['ema_gaps']]} of their norms; "
          f"{[round(r, 3) for r in gnn_rates]} steps/s per process over {DP_GNN_TIMED} steps "
          f"beside the in-process {beside('gnn', 'steps_per_s')} sharded and "
          f"{beside('gnn', 'unsharded_steps_per_s')} unsharded (dp_train); replicas "
          f"bit-equal after every step; launches over all processes {json.dumps(launches)}")
    return {"launches": launches, "world": world, "backend": backend,
            "seg_steps_per_s": seg_rates, "gnn_steps_per_s": gnn_rates,
            "reduce_ms": [run["reduce_ms"] for run in seg],
            "seg_rel": seg_gates["rel"], "seg_gaps": seg_gates["gaps"],
            "gnn_rel": gnn_gates["rel"], "gnn_gaps": gnn_gates["gaps"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import citlab_as_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    from citlab_as_tpu_torch.device import resolve_device
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out

    pipelined_row = files_row = None
    try:
        dev = resolve_device("cuda")
        name, smi_line = timed("device", phase_device)
        timed("build", phase_build)
        k1_row = timed("k1", phase_k1, dev)
        k2_row = timed("k2", phase_k2, dev)
        main_row = timed("main path", phase_main_path, dev)
        files_row = timed("files", phase_files, dev)
        workflow_row = timed("workflow", phase_workflow, dev)
        timed("gnn", phase_gnn, dev)
        pipelined_row = timed("pipelined", phase_pipelined, dev)
        visual_row = timed("visual", phase_visual, dev)
        formats_row = timed("formats", phase_formats, dev)
        variants_row = timed("variants", phase_variants, dev)
        blind_row = timed("blind", phase_blind, dev)
        train_row = timed("train", phase_train, dev)
        gt_eval_row = timed("gt_eval", phase_gt_eval, dev, workflow_row)
        models_row = timed("models", phase_models, dev)
        parallel_row = timed("parallel", phase_parallel, dev, pipelined_row)
        spatial_row = timed("spatial", phase_spatial, dev, pipelined_row)
        orbax_row = timed("orbax", phase_orbax, dev)
        recipes_row = timed("recipes", phase_recipes, dev)
        dp_train_row = timed("dp_train", phase_dp_train, dev)
        dp_procs_row = timed("dp_procs", phase_dp_procs, dev, dp_train_row)
        timed("files (CPU check, wait)", cpu_check_finish, files_row["cpu_check"])
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if pipelined_row is not None:     # the parallel and spatial phases' corpus
            shutil.rmtree(pipelined_row["corpus"][0], ignore_errors=True)
        if files_row is not None:         # its CPU-device check, if still running
            cpu_check_stop(files_row["cpu_check"])
    print(f"phase seconds {json.dumps(seconds)}; all {sum(seconds.values()):.1f} s")
    kernels = [
        dict(name="conv3x3", route="cuda", source="citlab_as_tpu_torch/csrc/conv3x3.cu",
             replaces="citlab_as_tpu/ops/pallas/conv3x3.py:110",
             launches=main_row["launches"]["conv3x3"],
             launches_files=files_row["launches"]["conv3x3"],
             launches_workflow=workflow_row["launches"]["conv3x3"],
             launches_pipelined=pipelined_row["launches"]["conv3x3"],
             launches_visual=visual_row["launches"]["conv3x3"],
             launches_formats=formats_row["launches"]["conv3x3"],
             launches_variants=variants_row["launches"]["conv3x3"],
             launches_blind=blind_row["launches"]["conv3x3"],
             launches_train=train_row["launches"]["conv3x3"],
             launches_gt_eval=gt_eval_row["launches"]["conv3x3"],
             launches_models=models_row["launches"]["conv3x3"],
             launches_parallel=parallel_row["launches"]["conv3x3"],
             launches_spatial=spatial_row["launches"]["conv3x3"],
             launches_orbax=orbax_row["launches"]["conv3x3"],
             launches_orbax_resume=orbax_row["resume_launches"]["conv3x3"],
             launches_recipes=recipes_row["launches"]["conv3x3"],
             launches_dp_train=dp_train_row["launches"]["conv3x3"],
             launches_dp_procs=dp_procs_row["launches"]["conv3x3"], **k1_row),
        dict(name="separator_morphology", route="cuda",
             source="citlab_as_tpu_torch/csrc/separator_morphology.cu",
             replaces="citlab_as_tpu/ops/pallas/separator_morphology.py:125",
             launches=main_row["launches"]["separator_morphology"],
             launches_files=files_row["launches"]["separator_morphology"],
             launches_workflow=workflow_row["launches"]["separator_morphology"],
             launches_pipelined=pipelined_row["launches"]["separator_morphology"],
             launches_visual=visual_row["launches"]["separator_morphology"],
             launches_formats=formats_row["launches"]["separator_morphology"],
             launches_variants=variants_row["launches"]["separator_morphology"],
             launches_blind=blind_row["launches"]["separator_morphology"],
             launches_train=train_row["launches"]["separator_morphology"],
             launches_gt_eval=gt_eval_row["launches"]["separator_morphology"],
             launches_models=models_row["launches"]["separator_morphology"],
             launches_parallel=parallel_row["launches"]["separator_morphology"],
             launches_spatial=spatial_row["launches"]["separator_morphology"],
             launches_orbax=orbax_row["launches"]["separator_morphology"],
             launches_orbax_resume=orbax_row["resume_launches"]["separator_morphology"],
             launches_recipes=recipes_row["launches"]["separator_morphology"],
             launches_dp_train=dp_train_row["launches"]["separator_morphology"],
             launches_dp_procs=dp_procs_row["launches"]["separator_morphology"], **k2_row),
    ]
    # ``launches``: the in-memory main path's count; ``launches_files``: the
    # files-to-files path's; ``launches_workflow``: the whole workflow's;
    # ``launches_pipelined``: the pipelined workflow's (16 pages, no
    # workers); ``launches_visual``: the pipelined workflow's with the visual
    # relation net; ``launches_formats``: the stage CLIs' over the JPEG /
    # TIFF fixtures (separator and heading; each counted from 0 just before
    # its run); ``launches_variants``: the pipelined workflow's over the
    # fourteen full-size variant pages and their PNG twins (28 pages, 7
    # groups: K1 69 x 2 x 7, K2 7; the bomb page among them is skipped at
    # load) plus the separator CLI's over the PBM, BMP, GIF,
    # three WebP, three JPEG 2000 and seven raster (PCX, DCX, TGA, PSD, SGI,
    # SUN, QOI) pages and their twins (32 pages, 8 groups: K1 69 x 8, K2 8);
    # ``launches_blind``: the three blind-quality bf16
    # workflow runs' (one group per page size: K1 69 x 2 and K2 1 per group,
    # 4 groups in all; each run counted from 0 just before it);
    # ``launches_train``: the segmentation trainer's bf16 run (13
    # train steps and 2 eval steps, 69 each); ``launches_gt_eval``: the
    # ground-truth and evaluation phase's (2 train steps on generated GT and
    # the heading grid search's 12 forwards, 69 each); ``launches_models``:
    # the models phase's (the .npz, .frozen and .pb separator forwards and
    # one separator-stage group each from .npz and .frozen: K1 69 x 5, K2 2);
    # ``launches_parallel``: the pipelined workflow's over a 2-shard mesh of
    # the card (16 pages, 2 groups of 8: K1 69 x 2 nets x 2 shards x 2, K2 4);
    # ``launches_spatial``: the pipelined workflow's over a (data=2, model=2)
    # mesh of the card, each data row's forwards height-sharded over its 2
    # devices (16 pages, 2 groups of 8: K1 69 x 2 nets x 2 row shards x 2
    # data rows x 2 groups = 1104, K2 4); ``launches_orbax``: the workflow
    # CLI's with the three --*_model_dir flags naming models_ckpt/ (8 pages,
    # 2 groups of 4: K1 69 x 2 x 2 = 276, K2 2); ``launches_orbax_resume``: the
    # segmentation step resumed from the port's own orbax step (K1 69, K2 0);
    # ``launches_recipes``: the recipes phase's (the separator recipe's 40
    # bf16 train steps, its eval forward and its checkpoint's forward, 69
    # each; the pipeline recipe's dataset, 69 and K2 1 per group of 4 pages,
    # and its ARU_v1 visual GNN's 16 train steps, 69 each, its eval forwards
    # and the f32 card check's 2 steps; the gnn_visual recipe's dataset
    # (ARU_cutted_v1: none in its steps); eval_visual_gnn's five workflows,
    # K1 138 and K2 1 each); ``launches_dp_train``: the data-parallel train
    # steps over a 2-shard mesh of the card and, on a machine with several,
    # a mesh of every card (per mesh of n shards: K1 69 n per sharded and 69
    # per unsharded segmentation or ARU_v1 step, 3 f32 and 12 bf16
    # segmentation steps and 2 ARU_v1 steps of each; 3,519 on one card; the
    # relation GNN's steps none; K2 none); ``launches_dp_procs``: the
    # processes' of the data-parallel train steps across processes (2 on
    # one card, one per card on a machine of several), summed over them: K1
    # 69 per process per segmentation step, 3 f32 and 12 bf16 (2,070 on one
    # card, 4,140 on four), the relation steps none; K2 none. The main
    # process's in-process steps that the processes are held to do not count
    keys = ("name", "route", "source", "replaces", "launches", "launches_files",
            "launches_workflow", "launches_pipelined", "launches_visual", "launches_formats",
            "launches_variants", "launches_blind", "launches_train", "launches_gt_eval",
            "launches_models", "launches_parallel", "launches_spatial", "launches_orbax",
            "launches_orbax_resume", "launches_recipes", "launches_dp_train",
            "launches_dp_procs", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi_line)
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-check"]:           # the files phase's worker
        sys.exit(cpu_check_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-procs-worker"]:     # a dp_procs phase's process
        sys.exit(dp_procs_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
