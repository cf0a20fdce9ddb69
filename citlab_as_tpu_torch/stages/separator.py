"""Separator detection stage (port of ``citlab_as_tpu/stages/separator.py``).

The device chain, per same-shape page group: uint8 pages up -> resize ->
ARU-Net -> softmax -> uint8 quantize -> threshold -> CC filter ->
h/v morphology (K2) -> bit-pack; the packed masks come down in one
readback and the host traces contours and rescales them. This is the JAX
package's fused chain (``make_fused_separator_fn``, ``sep_post=device``)
with the ARU-Net's low-channel 3x3 convs on K1.

Per page the chain ends in one polygons dict
``{"SeparatorRegion_horizontal": [...], "SeparatorRegion_vertical": [...]}``
rescaled to the original page. Given image files, the stage hands that dict
to the PAGE-XML writer (``stages/separator_writer.py``: text lines split at
vertical separators, SeparatorRegions added) and saves
``page/<name>.xml.xml``; given in-memory pages it returns the dicts.

For the pipelined workflow driver the group API is split as in the JAX
package: :meth:`SeparatorNetPostProcessor.fused_dispatch` (optionally on a
batch the caller has already uploaded), :meth:`~SeparatorNetPostProcessor.fused_prefetch`
(the packed masks' readback started behind the group's own work),
:meth:`~SeparatorNetPostProcessor.fused_materialize` (waits on that copy
only) and :meth:`~SeparatorNetPostProcessor.fused_drain` (the host tail).

Not ported: the JAX package's host C post-processing branch and its device
buffer pinning.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.ops.connected_components import remove_small_components
from citlab_as_tpu_torch.ops.contours import trace_contours
from citlab_as_tpu_torch.ops.kernels.separator_morphology import separator_morphology
from citlab_as_tpu_torch.ops.resize import get_scaling_factor, resize_image, scale_image
from citlab_as_tpu_torch.pagexml.constants import SEPARATORREGION
from citlab_as_tpu_torch.stages.separator_writer import SeparatorRegionToPageWriter
from citlab_as_tpu_torch.utils.async_copy import prefetch, to_numpy, upload
from citlab_as_tpu_torch.utils.faults import page_guard
from citlab_as_tpu_torch.utils.io import get_page_path, load_image, load_list_file
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)

MIN_CC_SIZE = 100


def apply_threshold(net_output: np.ndarray, threshold: float) -> np.ndarray:
    """uint8-aware binarization."""
    if net_output.dtype == np.uint8:
        threshold = threshold * 255
    return np.asarray((net_output > threshold) * 255, dtype=np.uint8)


def separator_kernel_sizes(h: int, w: int) -> Tuple[int, int, int]:
    """(h_k, v_k, noise_k) = 15W/1000, 30H/1500, 10W/1000, at least 1."""
    return (max(1, int(15 * w / 1000)), max(1, int(30 * h / 1500)),
            max(1, int(10 * w / 1000)))


@contextmanager
def _phase(phase: Optional[Dict[str, float]], name: str, device: torch.device):
    """Add the wall time of the block to ``phase[name]``. With a phase dict
    the block is bracketed by device syncs, so its time is its own; without
    one nothing is timed and nothing syncs."""
    if phase is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phase[name] = phase.get(name, 0.0) + time.perf_counter() - t0


def pack_bits_device(mask: torch.Tensor) -> torch.Tensor:
    """[..., W] bool -> [..., ceil(W/8)] uint8, MSB-first (np.unpackbits
    reads it back)."""
    w = mask.shape[-1]
    pad = -w % 8
    if pad:
        mask = F.pad(mask, (0, pad))
    groups = mask.reshape(mask.shape[:-1] + ((w + pad) // 8, 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=mask.device)
    return torch.sum(groups.to(torch.int32) * weights, dim=-1).to(torch.uint8)


def unpack_mask_bits(packed: np.ndarray, width: int) -> np.ndarray:
    """[H, ceil(W/8)] uint8 bit rows -> [H, W] {0, 255} uint8 mask."""
    bits = np.unpackbits(np.asarray(packed), axis=-1, count=width)
    return (bits * 255).astype(np.uint8)


def separator_post_process(binary: np.ndarray, device: torch.device
                           ) -> Dict[str, np.ndarray]:
    """Thresholded separator image [H, W] -> horizontal and vertical masks:
    CC filter (< 100 px removed), then the K2 morphology chain with the
    kernel sizes scaled to the image."""
    h, w = binary.shape
    x = torch.from_numpy(np.ascontiguousarray(binary)).to(device)[None]
    cleaned = remove_small_components(x, MIN_CC_SIZE)
    horizontal, vertical = separator_morphology(
        cleaned, *separator_kernel_sizes(h, w))
    return {"horizontal": horizontal[0].cpu().numpy(),
            "vertical": vertical[0].cpu().numpy()}


def resized_prob_u8(model: torch.nn.Module, img_u8: torch.Tensor, out_h: int,
                    out_w: int, pad_multiple: int = 64) -> torch.Tensor:
    """Original uint8 pages [B, H0, W0] -> the net's channel-0 probability
    map at [B, out_h, out_w], quantized to uint8 (``.to(uint8)`` truncates,
    as the reference's uint8 round trip does): resize, zero-pad to a
    multiple of ``pad_multiple``, forward, softmax, crop."""
    x = img_u8.to(torch.float32)
    if (out_h, out_w) != tuple(x.shape[1:]):
        x = resize_image(x, out_h, out_w)
    x = F.pad(x, (0, -out_w % pad_multiple, 0, -out_h % pad_multiple))
    probs = torch.softmax(model(x[..., None] / 255.0), dim=-1)
    return (probs[:, :out_h, :out_w, 0] * 255.0).to(torch.uint8)


def make_fused_separator_fn(model: torch.nn.Module) -> Callable:
    """The whole device chain for one group: original uint8 pages
    [B, H0, W0] in, bit-packed masks [2, B, out_h, ceil(out_w/8)] out
    (horizontal, vertical). Quantize-then-threshold replicates the
    reference's uint8 round trip (``.to(uint8)`` truncates)."""

    @torch.no_grad()
    def fused(img_u8: torch.Tensor, out_h: int, out_w: int, h_kernel: int,
              v_kernel: int, noise_kernel: int, threshold: float,
              pad_multiple: int = 64,
              phase: Optional[Dict[str, float]] = None) -> torch.Tensor:
        dev = img_u8.device
        with _phase(phase, "resize+forward", dev):
            net_u8 = resized_prob_u8(model, img_u8, out_h, out_w, pad_multiple)
            binary = net_u8.to(torch.float32) > threshold * 255.0
        with _phase(phase, "cc", dev):
            cleaned = remove_small_components(binary, MIN_CC_SIZE)
        with _phase(phase, "morphology", dev):
            horizontal, vertical = separator_morphology(
                cleaned, h_kernel, v_kernel, noise_kernel)
            packed = torch.stack([pack_bits_device(horizontal > 0),
                                  pack_bits_device(vertical > 0)])
        return packed

    return fused


def callable_net_u8(predict_fn: Callable, img_u8: torch.Tensor, out_h: int,
                    out_w: int) -> List[np.ndarray]:
    """A plain ``predict_fn(image_grey[H, W]) -> probabilities[H, W, C]`` on
    each page of the uint8 batch as the stages' page-by-page ``run`` calls
    it: resized on the host to (out_h, out_w), in [0, 1]; its channel 0
    quantized to uint8 (truncated) per page."""
    maps = []
    for page in img_u8.cpu():
        scaled = page.to(torch.float32)
        if (out_h, out_w) != tuple(scaled.shape):
            scaled = resize_image(scaled, out_h, out_w)
        net_output = np.asarray(predict_fn(scaled.numpy() / 255.0))
        maps.append(np.asarray(net_output * 255, dtype=np.uint8)[..., 0])
    return maps


def make_callable_separator_fn(predict_fn: Callable) -> Callable:
    """The contract of :func:`make_fused_separator_fn` for a plain
    ``predict_fn``: the net outputs of :func:`callable_net_u8`, thresholded
    as :meth:`SeparatorNetPostProcessor.process_image` does it; the CC
    filter and the morphology run on the pages' device."""

    @torch.no_grad()
    def fused(img_u8: torch.Tensor, out_h: int, out_w: int, h_kernel: int,
              v_kernel: int, noise_kernel: int, threshold: float,
              pad_multiple: int = 64,
              phase: Optional[Dict[str, float]] = None) -> torch.Tensor:
        binary = np.stack([apply_threshold(net_u8, threshold) for net_u8 in
                           callable_net_u8(predict_fn, img_u8, out_h, out_w)])
        cleaned = remove_small_components(
            torch.from_numpy(binary).to(img_u8.device), MIN_CC_SIZE)
        horizontal, vertical = separator_morphology(
            cleaned, h_kernel, v_kernel, noise_kernel)
        return torch.stack([pack_bits_device(horizontal > 0),
                            pack_bits_device(vertical > 0)])

    return fused


def masks_to_polygons(mask: np.ndarray, separator_type: Optional[str] = None
                      ) -> Dict[str, list]:
    """Contours of a separator mask keyed by region name."""
    key = SEPARATORREGION if separator_type is None else f"{SEPARATORREGION}_{separator_type}"
    return {key: trace_contours(mask)}


def rescale_polygons_dict(polygons_dict: Dict[str, list],
                          scaling_factor: float) -> Dict[str, list]:
    """Scale every ring of every polygon."""
    out = {}
    for name, poly_list in polygons_dict.items():
        out[name] = [
            [[(x * scaling_factor, y * scaling_factor) for x, y in ring] for ring in rings]
            for rings in poly_list]
    return out


class SeparatorNetPostProcessor:
    """Separator detection over image files or in-memory pages.

    ``image_list``: image paths (a list, or the path of a list file) — the
    stage then reads ``page/<name>.xml`` beside each image (or the matching
    entry of ``page_paths``), writes the separators into it and saves it as
    ``<page path>.xml``; the run methods return the Page objects. Or uint8
    grayscale pages [H, W] — the run methods then return one rescaled
    polygons dict per page and write nothing; ``names`` gives one key per
    page (default "0", "1", ...) for the per-page fault hook.
    ``predictor``: an ``inference.SegmentationPredictor`` (its ``model``
    and ``device`` run the chain) or any
    ``predict_fn(image_grey[H, W]) -> probabilities[H, W, C]``, whose CC
    filter and morphology then run on ``device`` (per page in :meth:`run`,
    per group in the fused methods). Results come in input order, None for
    a page skipped by the fault hook.
    """

    def __init__(self, image_list: Union[str, Sequence[str], Sequence[np.ndarray]],
                 predictor, fixed_height: Optional[int] = 1500,
                 scaling_factor: float = 1.0, threshold: float = 0.05,
                 names: Optional[Sequence[str]] = None,
                 page_paths: Optional[Sequence[str]] = None,
                 device: DeviceLike = None):
        if isinstance(image_list, str):
            image_list = load_list_file(image_list)
        self.images = list(image_list)
        self.from_files = bool(self.images) and isinstance(self.images[0], str)
        if self.from_files:
            if names is not None:
                raise ValueError("names belong to in-memory pages; image "
                                 "files are keyed by their paths")
            self.names = list(self.images)
        else:
            self.names = ([str(i) for i in range(len(self.images))]
                          if names is None else list(names))
        if len(self.names) != len(self.images) or len(set(self.names)) != len(self.names):
            raise ValueError("names must be unique, one per image")
        if page_paths is not None and not (
                self.from_files and len(page_paths) == len(self.images)):
            raise ValueError("page_paths must match an image_list of files")
        self.page_paths = (dict(zip(self.images, page_paths))
                           if page_paths is not None else None)
        self.predictor = predictor
        self.fixed_height = fixed_height
        self.scaling_factor = scaling_factor
        self.threshold = threshold
        if device is not None:
            self.device = resolve_device(device)
        elif hasattr(predictor, "device"):
            self.device = predictor.device
        else:
            raise ValueError("a predictor without a device needs device=")
        self._fused = (make_fused_separator_fn(predictor.model)
                       if hasattr(predictor, "model")
                       else make_callable_separator_fn(predictor))
        # per-page fault hook: None = raise through; a callback
        # (name, stage, exc) switches to the log-and-skip contract
        self.on_page_error = None

    @property
    def image_paths(self) -> List[str]:
        if not self.from_files:
            raise AttributeError("in-memory pages have no paths")
        return self.images

    def _page_path_for(self, image_path: str) -> str:
        if self.page_paths is not None:
            return self.page_paths[image_path]
        return get_page_path(image_path)

    def _write_page(self, image_path: str, polygons_dict):
        """Merge the polygons into the page's PAGE-XML and save it as
        ``<page path>.xml``; returns the Page object."""
        page_path = self._page_path_for(image_path)
        writer = SeparatorRegionToPageWriter(
            page_path, image_path, self.fixed_height, self.scaling_factor,
            polygons_dict)
        writer.remove_separator_regions_from_page()
        writer.merge_regions()
        logger.debug("Saving separator results to %s.xml", page_path)
        writer.save_page_xml(page_path + ".xml")
        return writer.page_object

    def _finish(self, name: str, polygons_dict,
                phase: Optional[Dict[str, float]] = None):
        """What a page's result is: the written Page for an image file, the
        polygons dict for an in-memory page."""
        if not self.from_files:
            return polygons_dict
        t0 = time.perf_counter()
        page = self._write_page(name, polygons_dict)
        if phase is not None:
            phase["write"] = phase.get("write", 0.0) + time.perf_counter() - t0
        return page

    def process_image(self, image_grey: np.ndarray, sc: float) -> Dict[str, list]:
        """Forward + post-processing for one scaled grayscale page in
        [0, 1]: the rescaled polygons dict."""
        net_output = np.asarray(self.predictor(image_grey))
        net_output = np.asarray(net_output * 255, dtype=np.uint8)
        binary = apply_threshold(net_output[..., 0], self.threshold)
        masks = separator_post_process(binary, self.device)
        polygons_dict = {}
        for separator_type, mask in masks.items():
            polygons_dict.update(masks_to_polygons(mask, separator_type))
        return rescale_polygons_dict(polygons_dict, 1.0 / sc)

    def run(self) -> List:
        """Page by page, resized on the host: the forward through the
        predictor's own call, then CC filter and morphology on its device."""
        results: Dict[str, object] = {}
        for image, name in zip(self.images, self.names):
            def run_one(image=image, name=name):
                if isinstance(image, str):
                    image = load_image(image, mode="L")
                scaled, sc = scale_image(
                    torch.from_numpy(np.array(image, np.float32)),
                    self.fixed_height, self.scaling_factor)
                polygons_dict = self.process_image(scaled.numpy() / 255.0, sc)
                results[name] = self._finish(name, polygons_dict)
            page_guard(self.on_page_error, name, "separator", run_one)
        return [results.get(name) for name in self.names]

    @staticmethod
    def group_by_shape(images: Sequence[Union[str, np.ndarray]],
                       names: Sequence[str], max_batch: int, on_error=None
                       ) -> Iterator[Tuple[List[np.ndarray], List[str]]]:
        """Consecutive same-shape page groups of at most ``max_batch``, as
        (images, names). An entry of ``images`` that is a path is loaded
        here, lazily, so a large corpus holds one group of images in
        memory; ``on_error(name, "load", exc)`` switches a load failure
        (truncated or unreadable image) to the log-and-skip contract."""
        group: List[np.ndarray] = []
        chunk: List[str] = []
        for image, name in zip(images, names):
            if isinstance(image, str):
                try:
                    image = np.asarray(load_image(image, mode="L"), np.uint8)
                except Exception as e:  # noqa: BLE001 - the skip contract
                    if on_error is None:
                        raise
                    on_error(name, "load", e)
                    continue
            if group and (group[0].shape != image.shape or len(group) >= max_batch):
                yield group, chunk
                group, chunk = [], []
            group.append(image)
            chunk.append(name)
        if group:
            yield group, chunk

    def fused_dispatch(self, images: List[np.ndarray], chunk: List[str],
                       phase: Optional[Dict[str, float]] = None,
                       device_batch: Optional[torch.Tensor] = None):
        """Run the device chain for one same-shape group; returns the
        in-flight entry for :meth:`fused_drain` (the masks stay on the
        device until materialized). ``device_batch``: the group's pages
        already on the device as uint8 [B, H0, W0] (one upload serves both
        nets of the pipelined workflow); else they are uploaded here."""
        h0, w0 = images[0].shape
        sc = get_scaling_factor(h0, w0, self.scaling_factor,
                                fixed_height=self.fixed_height)
        out_h, out_w = (h0, w0) if sc == 1.0 else (int(h0 * sc), int(w0 * sc))
        batch = device_batch if device_batch is not None else upload(images, self.device)
        hv_packed = self._fused(
            batch, out_h, out_w, *separator_kernel_sizes(out_h, out_w),
            threshold=self.threshold,
            pad_multiple=getattr(self.predictor, "pad_multiple", 64), phase=phase)
        return chunk, hv_packed, out_w, [sc] * len(chunk)

    @staticmethod
    def fused_prefetch(entry):
        """Start the readback of the group's packed masks behind the work
        queued on the current stream (``utils/async_copy.py``); returns the
        entry for :meth:`fused_materialize`, which then waits on that copy
        only."""
        chunk, hv_packed, out_w, scales = entry
        return chunk, prefetch(hv_packed), out_w, scales

    def fused_materialize(self, entry, phase: Optional[Dict[str, float]] = None):
        """Copy the group's packed masks to the host in one readback (or
        wait for the prefetched copy)."""
        chunk, hv_packed, out_w, scales = entry
        t0 = time.perf_counter()
        hv = to_numpy(hv_packed)
        if phase is not None:
            phase["readback"] = phase.get("readback", 0.0) + time.perf_counter() - t0
        return chunk, hv[0], hv[1], out_w, scales

    def fused_drain(self, entry, results: Dict[str, object],
                    phase: Optional[Dict[str, float]] = None) -> None:
        """Materialize one group (unless ``entry`` is already
        :meth:`fused_materialize`'s result) and do the host tail: unpack,
        contour trace, rescale, and for image files write PAGE-XML, into
        ``results[name]``."""
        if len(entry) == 4:
            entry = self.fused_materialize(entry, phase)
        chunk, h_packed, v_packed, out_w, scales = entry
        for i, (name, sc) in enumerate(zip(chunk, scales)):
            def drain_one(i=i, name=name, sc=sc):
                t0 = time.perf_counter()
                polygons_dict = {}
                for separator_type, packed in (("horizontal", h_packed[i]),
                                               ("vertical", v_packed[i])):
                    polygons_dict.update(masks_to_polygons(
                        unpack_mask_bits(packed, out_w), separator_type))
                polygons_dict = rescale_polygons_dict(polygons_dict, 1.0 / sc)
                if phase is not None:
                    phase["contours"] = (phase.get("contours", 0.0)
                                         + time.perf_counter() - t0)
                results[name] = self._finish(name, polygons_dict, phase)
            page_guard(self.on_page_error, name, "separator", drain_one)

    def run_batched_fused(self, batch_size: int = 4,
                          phase: Optional[Dict[str, float]] = None
                          ) -> List[Optional[object]]:
        """The fused device chain over same-shape groups of ``batch_size``
        pages, two deep: the next group is dispatched before the previous
        one is drained, so contour tracing and PAGE-XML writing overlap the
        device's work. ``phase`` (optional) collects seconds per phase —
        load, resize+forward, cc, morphology, readback, contours, write —
        with a device sync around each device phase."""
        results: Dict[str, object] = {}
        in_flight = None
        groups = iter(self.group_by_shape(self.images, self.names, batch_size,
                                          on_error=self.on_page_error))
        while True:
            t0 = time.perf_counter()
            group = next(groups, None)
            if phase is not None and self.from_files:
                phase["load"] = phase.get("load", 0.0) + time.perf_counter() - t0
            if group is None:
                break
            images, chunk = group
            entry = page_guard(self.on_page_error, ",".join(chunk), "separator",
                               lambda: self.fused_dispatch(images, chunk, phase))
            if in_flight is not None:
                self.fused_drain(in_flight, results, phase)
            in_flight = entry
        if in_flight is not None:
            self.fused_drain(in_flight, results, phase)
        return [results.get(name) for name in self.names]

    # the stage's batched path is the fused device chain on every device
    run_batched = run_batched_fused
