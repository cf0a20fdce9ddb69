"""Heading detection stage (port of ``citlab_as_tpu/stages/heading.py``).

Fuses ARU-Net heading probabilities with stroke-width / text-height
features from the distance transform:

1. per text line: mean net probability over its (rescaled) bbox; stroke
   width (median per-CC max DT) and text height (max CC height) from the
   full-resolution SWT image;
2. page-level normalization: subtract the per-page mode, rescale to [0, 1];
3. decision: heading if any hard threshold fires (net >= 1.0 /
   stroke-width >= 1.0 / text-height >= 0.9 / (sw+th)/2 >= 0.9 by default)
   or the weighted sum (net .8, sw 0, th .2) exceeds the threshold (0.4);
4. a TextRegion becomes type 'heading' when >= text_line_percentage (0.8)
   of its lines are headings; all other regions are reset to 'paragraph'.

The fused path (:meth:`HeadingNetPostProcessor.run_batched_fused`) keeps
the probability map and the distance transform on the device and reads
back ``[n_lines, 3]`` integers per page (``ops/swt_device.py``); with
``use_device_swt`` off it reads the uint8 probability maps back and takes
the SWT features on the host (``ops/swt.py``), as :meth:`run` does.

The pipelined workflow driver calls the group API directly:
:meth:`HeadingNetPostProcessor.fused_dispatch` (on the batch it uploaded
for both nets), then ``fused_drain_dispatch``, ``fused_materialize`` and
``fused_finish``. A plain ``predict_fn`` takes the fused host path there
(:func:`make_callable_heading_fn`).

Not ported: the JAX package's host C line-statistics mode and its device
buffer pinning.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from citlab_as_tpu_torch.ops.binarize import otsu_binarize
from citlab_as_tpu_torch.ops.distance_transform import distance_transform_edt
from citlab_as_tpu_torch.ops.resize import get_scaling_factor, scale_image
from citlab_as_tpu_torch.ops.swt import StrokeWidthDistanceTransform
from citlab_as_tpu_torch.ops.swt_device import DeviceLineFeatures
from citlab_as_tpu_torch.pagexml.constants import TextRegionTypes
from citlab_as_tpu_torch.stages.separator import (
    SeparatorNetPostProcessor, _phase, callable_net_u8, resized_prob_u8,
)
from citlab_as_tpu_torch.stages.separator_writer import RegionToPageWriter
from citlab_as_tpu_torch.utils.async_copy import upload
from citlab_as_tpu_torch.utils.faults import page_guard
from citlab_as_tpu_torch.utils.io import get_page_path, load_image, load_list_file
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)

DEFAULT_WEIGHTS = {"net": 0.8, "stroke_width": 0.0, "text_height": 0.2}
DEFAULT_THRESHOLDS = {"net_thresh": 1.0, "stroke_width_thresh": 1.0,
                      "text_height_thresh": 0.9, "sw_th_thresh": 0.9}


def make_fused_heading_fn(model: torch.nn.Module) -> Callable:
    """Device chain: original uint8 pages [B, H0, W0] -> quantized uint8
    heading probability map (channel 0) [B, out_h, out_w]. The uint8 map is
    what the host classifier consumes (it divides by 255 again), so reading
    back 1 byte/px instead of the f32 probabilities loses nothing."""

    @torch.no_grad()
    def fused(img_u8: torch.Tensor, out_h: int, out_w: int,
              pad_multiple: int = 64,
              phase: Optional[Dict[str, float]] = None) -> torch.Tensor:
        with _phase(phase, "resize+forward", img_u8.device):
            return resized_prob_u8(model, img_u8, out_h, out_w, pad_multiple)

    return fused


def make_fused_heading_swt_fn(model: torch.nn.Module) -> Callable:
    """Device chain computing BOTH the heading probability map and the
    full-resolution SWT distance transform (invert -> Gaussian+Otsu ->
    capped EDT) from the same uploaded uint8 batch. Neither output is read
    back: both stay on the device and feed the per-line feature programs
    (``ops/swt_device.py``)."""

    @torch.no_grad()
    def fused(img_u8: torch.Tensor, out_h: int, out_w: int,
              pad_multiple: int = 64,
              phase: Optional[Dict[str, float]] = None):
        dev = img_u8.device
        with _phase(phase, "resize+forward", dev):
            prob_u8 = resized_prob_u8(model, img_u8, out_h, out_w, pad_multiple)
        with _phase(phase, "otsu+edt", dev):
            inv = 255.0 - img_u8.to(torch.float32)
            _, binary = otsu_binarize(inv, blur_ksize=5)
            dt_u8 = distance_transform_edt(binary, cap=255.0).to(torch.uint8)
        return prob_u8, dt_u8

    return fused


def make_callable_heading_fn(predict_fn: Callable) -> Callable:
    """The contract of :func:`make_fused_heading_fn` for a plain
    ``predict_fn(image_grey[H, W]) -> probabilities[H, W, C]``: the uint8
    maps of ``stages/separator.py::callable_net_u8`` (the quantization of
    :meth:`HeadingNetPostProcessor.run`), as a CPU tensor."""

    def fused(img_u8: torch.Tensor, out_h: int, out_w: int,
              pad_multiple: int = 64,
              phase: Optional[Dict[str, float]] = None) -> torch.Tensor:
        return torch.from_numpy(np.stack(callable_net_u8(predict_fn, img_u8, out_h, out_w)))

    return fused


def scale_to_new_interval(data, old_min, old_max, new_min=0.0, new_max=1.0):
    """Affine remap of ``data`` from [old_min, old_max] to [new_min, new_max];
    identity when the old interval is degenerate."""
    if old_max - old_min == 0:
        return data
    return (new_max - new_min) / (old_max - old_min) * (data - old_min) + new_min


def _tick(phase: Optional[Dict[str, float]], name: str, t0: float) -> None:
    if phase is not None:
        phase[name] = phase.get(name, 0.0) + time.perf_counter() - t0


class HeadingNetPostProcessor:
    """``predictor``: an ``inference.SegmentationPredictor`` (channel 0 =
    heading) or, for :meth:`run`, any ``predict_fn(image_grey[H, W]) ->
    probabilities[H, W, C]``; None with a zero net weight."""

    def __init__(self, image_list, predictor: Optional[Callable] = None,
                 fixed_height: Optional[int] = 900, scaling_factor: float = 1.0,
                 weight_dict: Optional[Dict[str, float]] = None,
                 threshold: float = 0.4,
                 thresh_dict: Optional[Dict[str, float]] = None,
                 text_line_percentage: float = 0.8,
                 page_paths: Optional[List[str]] = None,
                 save_suffix: str = ".xml"):
        """``page_paths``/``save_suffix`` let a caller chain this
        stage onto another stage's output pages (e.g. the separator stage's
        ``<page>.xml.xml``, updated in place with ``save_suffix=''``);
        defaults give the standalone contract (``page/<name>.xml`` in,
        ``page/<name>.xml.xml`` out)."""
        if isinstance(image_list, str):
            self.image_paths = load_list_file(image_list)
        else:
            self.image_paths = list(image_list)
        if page_paths is not None and len(page_paths) != len(self.image_paths):
            raise ValueError("page_paths must match image_list length")
        self.page_paths = (dict(zip(self.image_paths, page_paths))
                           if page_paths is not None else None)
        self.save_suffix = save_suffix
        self.predictor = predictor
        self.fixed_height = fixed_height
        self.scaling_factor = scaling_factor
        self.swt = StrokeWidthDistanceTransform(dark_on_bright=True)
        self.weight_dict = dict(weight_dict) if weight_dict else dict(DEFAULT_WEIGHTS)
        self.threshold = threshold
        self.thresh_dict = dict(thresh_dict) if thresh_dict else dict(DEFAULT_THRESHOLDS)
        self.text_line_percentage = text_line_percentage
        # device SWT path (fused DT + per-line feature programs); None =
        # on, unless the predictor's device is the CPU
        self.use_device_swt: Optional[bool] = None
        self._device_features: Optional[DeviceLineFeatures] = None
        self._fused: Optional[Callable] = None
        # per-page fault hook: None = raise through; a callback
        # (image_path, stage, exc) switches to the log-and-skip contract
        self.on_page_error = None
        # device path: saved per-line (bbox, stroke_width, text_height) per
        # page — the GNN feature stage needs the SAME quantities for the
        # same lines and can reuse them instead of recomputing a distance
        # transform
        self.line_features_by_page: Dict[str, Dict] = {}

    def _page_path_for(self, image_path: str) -> str:
        if self.page_paths is not None:
            return self.page_paths[image_path]
        return get_page_path(image_path)

    def _writer_for(self, image_path: str) -> RegionToPageWriter:
        return RegionToPageWriter(
            self._page_path_for(image_path), path_to_image=image_path,
            fixed_height=self.fixed_height, scaling_factor=self.scaling_factor)

    # ------------------------------------------------------------------
    def get_net_prob_for_text_line(self, net_output, text_line, scaling_factor) -> float:
        """Mean net probability over the rescaled line bbox."""
        if text_line.surr_p is None:
            return 0.0
        poly = text_line.surr_p.to_polygon()
        if scaling_factor is not None:
            poly.rescale(scaling_factor)
        bb = poly.get_bounding_box()
        if bb.width <= 0 or bb.height <= 0:
            return 0.0
        crop = net_output[bb.y:bb.y + bb.height, bb.x:bb.x + bb.width]
        return float(np.sum(crop) / (bb.width * bb.height))

    # ------------------------------------------------------------------
    def line_feature_boxes(self, text_lines, scaling_factor):
        """[L, 4] int32 (x, y, w, h) bbox pairs for the device feature
        programs: unscaled (SWT crop) and rescaled (net prob crop) — the
        same bboxes the host path computes. Lines without a surrounding
        polygon are marked w = -1 (features forced to zero)."""
        swt_boxes = np.full((len(text_lines), 4), -1, np.int32)
        net_boxes = np.full((len(text_lines), 4), -1, np.int32)
        for i, tl in enumerate(text_lines):
            if tl.surr_p is None:
                continue
            poly = tl.surr_p.to_polygon()
            bb = poly.get_bounding_box()
            swt_boxes[i] = (bb.x, bb.y, bb.width, bb.height)
            if scaling_factor is not None:
                poly.rescale(scaling_factor)
                bb = poly.get_bounding_box()
            net_boxes[i] = (bb.x, bb.y, bb.width, bb.height)
        return swt_boxes, net_boxes

    def classify_page(self, page_object, scaling_factor,
                      net_output_post: Optional[np.ndarray],
                      swt_feature_image: Optional[np.ndarray],
                      save_features_key: Optional[str] = None) -> None:
        """Tag TextLines (custom structure{semantic_type:heading}) and
        TextRegions (type=heading) in place.

        ``save_features_key``: page path under which to stash the per-line
        (bbox, stroke_width, text_height) in ``line_features_by_page`` so
        the GNN feature stage can reuse them (the device path saves them in
        fused_finish)."""
        text_lines = page_object.textlines   # snapshot

        sw_raw, th_raw, net_prob = {}, {}, {}
        saved = {}
        for tl in text_lines:
            if tl.surr_p is None or swt_feature_image is None:
                sw_raw[tl.id], th_raw[tl.id] = 0.0, 0
            else:
                bb = tl.surr_p.to_polygon().get_bounding_box()
                sw_raw[tl.id], th_raw[tl.id] = self.swt.textline_features(
                    swt_feature_image, (bb.x, bb.y, bb.width, bb.height))
                saved[tl.id] = ((bb.x, bb.y, bb.width, bb.height),
                                sw_raw[tl.id], th_raw[tl.id])
            if self.weight_dict["net"] == 0 or net_output_post is None:
                net_prob[tl.id] = 0.0
            else:
                net_prob[tl.id] = self.get_net_prob_for_text_line(
                    net_output_post, tl, scaling_factor)
        if save_features_key is not None and swt_feature_image is not None:
            self.line_features_by_page[save_features_key] = saved
        self.classify_from_features(page_object, text_lines,
                                    net_prob, sw_raw, th_raw)

    def classify_from_features(self, page_object, text_lines,
                               net_prob: Dict, sw_raw: Dict,
                               th_raw: Dict) -> None:
        """Decision half of the stage (page-mode normalization, hard
        thresholds, weighted sum, >=80% region typing) — shared verbatim by
        the host and device feature paths."""
        use_swt = len(sw_raw) > 0
        if use_swt:
            sw_mode = Counter(sw_raw.values()).most_common(1)[0][0]
            th_mode = Counter(th_raw.values()).most_common(1)[0][0]
            sw_diff = {k: v - sw_mode for k, v in sw_raw.items()}
            th_diff = {k: v - th_mode for k, v in th_raw.items()}
            sw_min, sw_max = min(sw_diff.values()), max(sw_diff.values())
            th_min, th_max = min(th_diff.values()), max(th_diff.values())

        w = self.weight_dict
        t = self.thresh_dict
        for tl in text_lines:
            net_conf = net_prob[tl.id]
            if use_swt:
                sw_conf = scale_to_new_interval(sw_diff[tl.id], sw_min, sw_max)
                th_conf = scale_to_new_interval(th_diff[tl.id], th_min, th_max)
                if (sw_conf >= t["stroke_width_thresh"]
                        or th_conf >= t["text_height_thresh"]
                        or (sw_conf + th_conf) / 2 >= t["sw_th_thresh"]
                        or net_conf >= t["net_thresh"]):
                    conf = 1.0
                else:
                    conf = (w["net"] * net_conf + w["stroke_width"] * sw_conf
                            + w["text_height"] * th_conf)
            else:
                conf = net_conf

            if conf > self.threshold:
                nd = page_object.get_child_by_id(page_object.page_doc, tl.id)[0]
                # mirror the write into the snapshot object so the textlines
                # snapshot stays coherent with the DOM (re-validated below)
                tl.custom.setdefault("structure", {})[
                    "semantic_type"] = str(TextRegionTypes.HEADING)
                page_object.set_custom_attr_from_dict(nd, tl.custom)

        for text_region in page_object.get_text_regions():
            nd = page_object.get_child_by_id(page_object.page_doc, text_region.id)[0]
            nd.set("type", TextRegionTypes.PARAGRAPH)
            if not text_region.text_lines:
                continue
            n_headings = sum(
                1 for tl in text_region.text_lines
                if tl.custom.get("structure", {}).get("semantic_type") == TextRegionTypes.HEADING)
            if n_headings / len(text_region.text_lines) >= self.text_line_percentage:
                nd.set("type", TextRegionTypes.HEADING)
        # region @type edits above bypass the Page API: invalidate snapshots.
        # The per-line semantic_type writes were mirrored into the snapshot
        # objects themselves (text_lines IS the snapshot at both call sites),
        # so re-validate it — region @type lives outside the snapshot. The
        # identity check keeps an external caller passing a SUBSET list from
        # clobbering the snapshot with it.
        page_object.mark_dom_mutated()
        if getattr(page_object, "_textlines_snap", None) is text_lines:
            page_object.textlines = text_lines

    def _classify_and_save(self, image_path: str, net_output_post,
                           image: np.ndarray):
        """Host tail of one page: SWT image, classification, write."""
        swt_feature_image = self.swt.distance_transform(image, cache_key=image_path)
        page_path = self._page_path_for(image_path)
        writer = self._writer_for(image_path)
        self.classify_page(writer.page_object, writer.scaling_factor,
                           net_output_post, swt_feature_image,
                           save_features_key=page_path + self.save_suffix)
        logger.debug("Saving heading results to %s%s", page_path, self.save_suffix)
        writer.save_page_xml(page_path + self.save_suffix)
        return writer.page_object

    # ------------------------------------------------------------------
    def run(self) -> List:
        """Page by page on the host: the net through ``predictor``'s call,
        the SWT features with scipy."""
        pages = []
        for image_path in self.image_paths:
            def run_one(image_path=image_path):
                image = load_image(image_path, mode="L").astype(np.float32)
                net_output_post = None
                if self.weight_dict["net"] > 0 and self.predictor is not None:
                    scaled, _sc = scale_image(torch.from_numpy(image),
                                              self.fixed_height, self.scaling_factor)
                    image_grey = scaled.numpy() / 255.0
                    net_output = np.asarray(self.predictor(image_grey))
                    # the reference's quantize-then-normalize round trip
                    net_output = np.asarray(net_output * 255, dtype=np.uint8)
                    net_output_post = net_output[:, :, 0] / 255.0
                pages.append(self._classify_and_save(image_path, net_output_post, image))
            page_guard(self.on_page_error, image_path, "heading", run_one)
        return pages

    def run_batched(self, batch_size: int = 4) -> List:
        """With a batching predictor and a net weight, the fused device
        path (:meth:`run_batched_fused`); else :meth:`run`."""
        if (self.predictor is None or self.weight_dict["net"] == 0
                or not hasattr(self.predictor, "model")):
            return self.run()
        return self.run_batched_fused(batch_size=batch_size)

    def fused_dispatch(self, images: List[np.ndarray], chunk: List[str],
                       phase: Optional[Dict[str, float]] = None,
                       device_batch: Optional[torch.Tensor] = None):
        """Run the fused heading forward for one same-shape page group;
        returns the in-flight entry for :meth:`fused_drain_dispatch`. With
        the device SWT on, the chain also computes the full-resolution
        distance transform; both outputs stay on the device.
        ``device_batch``: the group's pages already on the device as uint8
        [B, H0, W0]; else they are uploaded here. A plain ``predict_fn``
        takes the host path (:func:`make_callable_heading_fn`)."""
        if self._fused is None:
            if not hasattr(self.predictor, "model"):
                self.use_device_swt = False
                self._fused = make_callable_heading_fn(self.predictor)
            else:
                if self.use_device_swt is None:
                    self.use_device_swt = self.predictor.device.type != "cpu"
                make = (make_fused_heading_swt_fn if self.use_device_swt
                        else make_fused_heading_fn)
                self._fused = make(self.predictor.model)
        h0, w0 = images[0].shape
        sc = get_scaling_factor(h0, w0, self.scaling_factor,
                                fixed_height=self.fixed_height)
        out_h, out_w = (h0, w0) if sc == 1.0 else (int(h0 * sc), int(w0 * sc))
        batch = (device_batch if device_batch is not None
                 else upload(images, self.predictor.device))
        out = self._fused(batch, out_h, out_w,
                          pad_multiple=getattr(self.predictor, "pad_multiple", 64),
                          phase=phase)
        maps_u8, dt_u8 = out if self.use_device_swt else (out, None)
        return chunk, maps_u8, dt_u8, list(images)

    def fused_drain_dispatch(self, entry, phase: Optional[Dict[str, float]] = None):
        """First half of the drain: on the device-SWT path, per page the
        line bboxes go up and the per-line feature programs run (nothing
        read back yet). Returns the state for :meth:`fused_materialize`."""
        chunk, maps_u8, dt_u8, images = entry
        if not self.use_device_swt or dt_u8 is None:
            return "host", entry
        if self._device_features is None:
            self._device_features = DeviceLineFeatures()

        t0 = time.perf_counter()
        pages, swt_list, net_list = [], [], []
        for image_path in chunk:
            def prepare_one(image_path=image_path):
                page_path = self._page_path_for(image_path)
                writer = self._writer_for(image_path)
                text_lines = writer.page_object.textlines   # snapshot
                swt_boxes, net_boxes = self.line_feature_boxes(
                    text_lines, writer.scaling_factor)
                return ((image_path, page_path, writer, text_lines),
                        swt_boxes, net_boxes)
            prepared = page_guard(self.on_page_error, image_path, "heading",
                                  prepare_one)
            if prepared is None:
                # skipped page: keep its slot so the box lists stay aligned
                # with the device batch index (dt_u8[i] / maps_u8[i]); the
                # None page entry drops out in fused_finish
                prepared = (None, [], [])
            pages.append(prepared[0])
            swt_list.append(prepared[1])
            net_list.append(prepared[2])
        _tick(phase, "parse+boxes", t0)
        if not any(p is not None for p in pages):
            return "device", (pages, lambda: [([], None)] * len(pages))
        with _phase(phase, "line features", dt_u8.device):
            handle = self._device_features.dispatch_batch(
                dt_u8, maps_u8, swt_list, net_list)
        return "device", (pages, handle)

    def fused_materialize(self, state, phase: Optional[Dict[str, float]] = None):
        """Read back one group's per-line feature integers (device path) or
        probability maps (host path). Returns the input for
        :meth:`fused_finish`."""
        kind, payload = state
        t0 = time.perf_counter()
        if kind == "host":
            chunk, maps_u8, _dt, images = payload
            out = "host", (chunk, maps_u8.cpu().numpy(), images)
        else:
            pages, handle = payload
            out = "device", (pages, handle())
        _tick(phase, "readback", t0)
        return out

    def fused_finish(self, materialized, pages_by_path: dict,
                     phase: Optional[Dict[str, float]] = None) -> None:
        """Pure host tail: classification + XML write for one materialized
        group."""
        kind, payload = materialized
        t0 = time.perf_counter()
        if kind == "host":
            chunk, maps_np, images = payload
            for image_path, net_u8, image in zip(chunk, maps_np, images):
                def finish_one(image_path=image_path, net_u8=net_u8, image=image):
                    pages_by_path[image_path] = self._classify_and_save(
                        image_path, net_u8 / 255.0, image)
                page_guard(self.on_page_error, image_path, "heading", finish_one)
            _tick(phase, "classify+write", t0)
            return

        net_on = self.weight_dict["net"] > 0
        pages, results = payload
        for page_entry, (netp, sw_th) in zip(pages, results):
            if page_entry is None:    # skipped at fused_drain_dispatch
                continue
            image_path, page_path, writer, text_lines = page_entry

            def finish_one(image_path=image_path, page_path=page_path,
                           writer=writer, text_lines=text_lines,
                           netp=netp, sw_th=sw_th):
                net_prob, sw_raw, th_raw = {}, {}, {}
                saved = {}
                for j, tl in enumerate(text_lines):
                    net_prob[tl.id] = float(netp[j]) if net_on else 0.0
                    sw_raw[tl.id] = float(sw_th[j, 0])
                    th_raw[tl.id] = int(sw_th[j, 1])
                    if tl.surr_p is not None:
                        bb = tl.surr_p.to_polygon().get_bounding_box()
                        saved[tl.id] = ((bb.x, bb.y, bb.width, bb.height),
                                        sw_raw[tl.id], th_raw[tl.id])
                self.line_features_by_page[page_path + self.save_suffix] = saved
                self.classify_from_features(writer.page_object, text_lines,
                                            net_prob, sw_raw, th_raw)
                writer.save_page_xml(page_path + self.save_suffix)
                pages_by_path[image_path] = writer.page_object
            page_guard(self.on_page_error, image_path, "heading", finish_one)
        _tick(phase, "classify+write", t0)

    def fused_drain_finish(self, state, pages_by_path: dict,
                           phase: Optional[Dict[str, float]] = None) -> None:
        """Materialize + classify one group: :meth:`fused_materialize` of
        :meth:`fused_drain_dispatch`'s state, then :meth:`fused_finish`."""
        self.fused_finish(self.fused_materialize(state, phase), pages_by_path, phase)

    def fused_drain(self, entry, pages_by_path: dict,
                    phase: Optional[Dict[str, float]] = None) -> None:
        """Drain one group of :meth:`fused_dispatch`: the per-line feature
        programs, their readback, then classification and the XML write on
        the host (on the device-SWT path only the per-line integers leave
        the device). Writes each page's result into ``pages_by_path``."""
        self.fused_drain_finish(self.fused_drain_dispatch(entry, phase), pages_by_path, phase)

    def run_batched_fused(self, batch_size: int = 4,
                          phase: Optional[Dict[str, float]] = None) -> List:
        """Fused device path: uint8 originals up, per-line integers (or, on
        the host-SWT path, uint8 heading maps) down. The previous group's
        host tail (classification + XML write) runs right after the next
        group's forward was issued, so it overlaps that group's device
        work. ``phase`` (optional) collects seconds per phase — load,
        resize+forward, otsu+edt, parse+boxes, line features, readback,
        classify+write — with a device sync around each device phase.
        Returns the Page objects in input order (None for a skipped page)."""
        pages_by_path: dict = {}
        pending = None
        groups = iter(SeparatorNetPostProcessor.group_by_shape(
            self.image_paths, self.image_paths, batch_size,
            on_error=self.on_page_error))
        while True:
            t0 = time.perf_counter()
            group = next(groups, None)
            _tick(phase, "load", t0)
            if group is None:
                break
            images, chunk = group
            entry = self.fused_dispatch(images, chunk, phase)
            if pending is not None:
                self.fused_finish(pending, pages_by_path, phase)
            state = self.fused_drain_dispatch(entry, phase)
            pending = self.fused_materialize(state, phase)
        if pending is not None:
            self.fused_finish(pending, pages_by_path, phase)
        return [pages_by_path.get(p) for p in self.image_paths]
