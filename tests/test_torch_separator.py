"""The whole slice: the port's fused separator chain against the JAX
package's ``make_fused_separator_fn`` (called directly: on the CPU the JAX
stage itself takes its per-stage path), at float32 with the converted
separator weights, on the same synthetic uint8 pages. Packed masks must be
identical and the polygons dicts equal."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import chip_smoke
from citlab_as_tpu.models.arunet import ARUNet as FlaxARUNet
from citlab_as_tpu.stages import separator as jsep
from citlab_as_tpu_torch.inference import SegmentationPredictor
from citlab_as_tpu_torch.stages import separator as tsep
from citlab_as_tpu_torch.weights import load_npz
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEP_NPZ = os.path.join(REPO, "models_ckpt_torch", "separator.npz")
FIXED_HEIGHT = 96


def synthetic_pages(n, h, w, seed):
    return chip_smoke.synthetic_pages(n, h, w, seed)[0]


@pytest.fixture(scope="module")
def flat_params():
    return load_npz(SEP_NPZ)


@pytest.fixture(scope="module")
def jax_fused(flat_params):
    variables = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in flat_params.items()})}
    fused = jsep.make_fused_separator_fn(FlaxARUNet(n_classes=2))
    return lambda *a, **k: np.asarray(fused(variables, *a, **k))


@pytest.fixture(scope="module")
def predictor():
    return SegmentationPredictor(SEP_NPZ, dtype=torch.float32, device="cpu")


def _jax_polygons(h_packed, v_packed, out_w, sc):
    d = {}
    for kind, packed in (("horizontal", h_packed), ("vertical", v_packed)):
        d.update(jsep.masks_to_polygons(jsep.unpack_mask_bits(packed, out_w), kind))
    return jsep.rescale_polygons_dict(d, 1.0 / sc)


@pytest.mark.parametrize("kernels", [(5, 7, 3), None])
def test_fused_chain_matches_jax(jax_fused, predictor, kernels):
    """Two 128 x 92 pages resized to height 96: packed [2, B, H, W/8] masks
    bit-identical to JAX's, for explicit morphology kernels and for the
    stage's own (which are 1 at this size)."""
    pages = synthetic_pages(2, 128, 92, seed=0)
    out_h, out_w = 96, int(92 * 96 / 128)
    kernels = kernels or tsep.separator_kernel_sizes(out_h, out_w)
    args = dict(out_h=out_h, out_w=out_w, h_kernel=kernels[0],
                v_kernel=kernels[1], noise_kernel=kernels[2], threshold=0.05)
    want = jax_fused(jnp.asarray(np.stack(pages)), **args)
    fused = tsep.make_fused_separator_fn(predictor.model)
    got = fused(torch.from_numpy(np.stack(pages)), **args).numpy()
    assert got.shape == want.shape == (2, 2, out_h, -(-out_w // 8))
    assert np.unpackbits(want[1]).sum() > 0, "no vertical separator found"
    np.testing.assert_array_equal(got, want)


@pytest.mark.usefixtures("jax_native")
def test_stage_polygons_match_jax(jax_fused, predictor):
    """SeparatorNetPostProcessor.run_batched (grouping, dispatch, readback,
    contours, rescale) gives the polygons dicts the JAX chain + JAX host
    tail give, page for page, across two page shapes."""
    pages = synthetic_pages(2, 128, 92, seed=1) + synthetic_pages(1, 120, 100, seed=2)
    proc = tsep.SeparatorNetPostProcessor(pages, predictor,
                                          fixed_height=FIXED_HEIGHT,
                                          threshold=0.05)
    phase = {}
    got = proc.run_batched(batch_size=2, phase=phase)
    assert set(phase) == {"resize+forward", "cc", "morphology", "readback",
                          "contours"}
    for i, page in enumerate(pages):
        h0, w0 = page.shape
        sc = FIXED_HEIGHT / h0
        out_h, out_w = int(h0 * sc), int(w0 * sc)
        hk, vk, nk = tsep.separator_kernel_sizes(out_h, out_w)
        hv = jax_fused(jnp.asarray(page[None]), out_h=out_h, out_w=out_w,
                       h_kernel=hk, v_kernel=vk, noise_kernel=nk, threshold=0.05)
        want = _jax_polygons(hv[0, 0], hv[1, 0], out_w, sc)
        assert got[i] == want
    assert any(got[i]["SeparatorRegion_vertical"] for i in range(3))


def test_separator_post_process_matches_jax():
    """The per-page post (CC filter + K2 chain) equals the JAX device chain."""
    rng = np.random.RandomState(4)
    binary = np.zeros((150, 200), np.uint8)
    binary[10:140, 100:103] = 255
    binary[60:62, 5:95] = 255
    binary[rng.rand(150, 200) < 0.03] = 255
    got = tsep.separator_post_process(binary, torch.device("cpu"))
    want_h, want_v = jsep._separator_masks_device(
        jnp.asarray(binary), jnp.int32(100), *tsep.separator_kernel_sizes(150, 200))
    np.testing.assert_array_equal(got["vertical"], np.asarray(want_v))
    np.testing.assert_array_equal(got["horizontal"], np.asarray(want_h))


def test_fault_hook_skips_a_failing_page(predictor):
    pages = synthetic_pages(2, 64, 48, seed=3)
    pages.append(np.zeros((64,), np.uint8))        # malformed page
    errors = []
    proc = tsep.SeparatorNetPostProcessor(pages, predictor, fixed_height=None,
                                          names=["a", "b", "bad"])
    proc.on_page_error = lambda name, stage, exc: errors.append((name, stage))
    out = proc.run_batched(batch_size=2)
    assert out[2] is None and out[0] is not None and out[1] is not None
    assert errors == [("bad", "separator")]
    with pytest.raises(ValueError):
        tsep.SeparatorNetPostProcessor(pages, predictor, names=["a", "a", "b"])


def test_group_by_shape_keeps_order_and_caps_batch():
    shapes = [(4, 4), (4, 4), (4, 4), (5, 4), (4, 4)]
    images = [np.zeros(s, np.uint8) for s in shapes]
    groups = list(tsep.SeparatorNetPostProcessor.group_by_shape(
        images, list("abcde"), 2))
    assert [g[1] for g in groups] == [["a", "b"], ["c"], ["d"], ["e"]]


# ------------------------------------------------------------ files to files

def _write_corpus(root, pages):
    """PNG files (the port's own encoder) and one PAGE-XML per page, built
    with the port's Page API: two text lines, one of which straddles the
    first drawn column rule."""
    from citlab_as_tpu_torch.pagexml import Page, TextLine, TextRegion
    from citlab_as_tpu_torch.utils.io import save_png
    os.makedirs(os.path.join(root, "page"), exist_ok=True)
    paths = []
    for i, page in enumerate(pages):
        h, w = page.shape
        p = os.path.join(root, f"p{i}.png")
        save_png(p, page)
        doc = Page(img_filename=f"p{i}.png", img_w=w, img_h=h)
        lines = [TextLine("tl_wide", None, "wide", [(2, h // 2 + 4), (w - 3, h // 2 + 4)],
                          [(2, h // 2 - 4), (w - 3, h // 2 - 4), (w - 3, h // 2 + 6),
                           (2, h // 2 + 6)]),
                 TextLine("tl_small", None, "small", [(2, 9), (9, 9)],
                          [(2, 2), (9, 2), (9, 10), (2, 10)])]
        doc.set_text_regions([TextRegion("tr_1", None, [(0, 0), (w - 1, 0), (w - 1, h - 1),
                                                        (0, h - 1)], lines)])
        doc.write_page_xml(os.path.join(root, "page", f"p{i}.xml"))
        paths.append(p)
    return paths


def test_stage_from_files_writes_what_the_writer_writes(tmp_path, predictor, monkeypatch):
    """From image files the stage writes ``page/<name>.xml.xml``: the bytes
    are those of the separator writer fed the in-memory stage's polygons,
    and ``run`` (page by page) writes the same files."""
    import citlab_as_tpu_torch.pagexml.page as tpage
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages.separator_writer import SeparatorRegionToPageWriter
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    pages = synthetic_pages(1, 128, 92, seed=1) + synthetic_pages(1, 120, 100, seed=2)
    paths = _write_corpus(str(tmp_path), pages)
    want_polys = tsep.SeparatorNetPostProcessor(
        pages, predictor, fixed_height=FIXED_HEIGHT).run_batched(batch_size=2)

    phase = {}
    proc = tsep.SeparatorNetPostProcessor(paths, predictor, fixed_height=FIXED_HEIGHT)
    written = proc.run_batched_fused(batch_size=2, phase=phase)
    assert {"load", "write"} <= set(phase) and proc.image_paths == paths
    outs = []
    for path, polys, page_obj in zip(paths, want_polys, written):
        page_path = os.path.join(str(tmp_path), "page",
                                 os.path.basename(path)[:-4] + ".xml")
        with open(page_path + ".xml", "rb") as f:
            outs.append(f.read())
        writer = SeparatorRegionToPageWriter(page_path, path, FIXED_HEIGHT, 1.0, polys)
        writer.remove_separator_regions_from_page()
        writer.merge_regions()
        ref = str(tmp_path / "ref.xml")
        writer.save_page_xml(ref)
        assert outs[-1] == open(ref, "rb").read()
        assert isinstance(page_obj, Page) and Page.validate(page_obj.page_doc)
    assert any(b"orientation:vertical" in o for o in outs)
    assert any(b'id="tl_wide_1"' in o for o in outs), "no text line was split"

    tsep.SeparatorNetPostProcessor(paths, predictor, fixed_height=FIXED_HEIGHT).run()
    for path, out in zip(paths, outs):
        page_path = os.path.join(str(tmp_path), "page", os.path.basename(path)[:-4] + ".xml")
        assert open(page_path + ".xml", "rb").read() == out


def test_stage_from_files_page_paths_list_file_and_load_errors(tmp_path, predictor):
    pages = synthetic_pages(3, 64, 48, seed=3)
    paths = _write_corpus(str(tmp_path), pages)
    with open(paths[1], "wb") as f:
        f.write(b"II*\x00 not a png")                      # unreadable image
    lst = tmp_path / "images.lst"
    lst.write_text("\n".join(paths) + "\n")
    other = [str(tmp_path / "elsewhere" / f"{i}.xml") for i in range(3)]
    os.makedirs(tmp_path / "elsewhere")
    for src, dst in zip(paths, other):
        os.replace(os.path.join(str(tmp_path), "page",
                                os.path.basename(src)[:-4] + ".xml"), dst)

    proc = tsep.SeparatorNetPostProcessor(str(lst), predictor, fixed_height=None,
                                          page_paths=other)
    with pytest.raises(Exception, match="TIFF"):
        proc.run_batched_fused(batch_size=2)
    errors = []
    proc.on_page_error = lambda name, stage, exc: errors.append((name, stage))
    out = proc.run_batched_fused(batch_size=2)
    assert errors == [(paths[1], "load")]
    assert out[1] is None and out[0] is not None and out[2] is not None
    assert os.path.exists(other[0] + ".xml") and not os.path.exists(other[1] + ".xml")
    groups = list(tsep.SeparatorNetPostProcessor.group_by_shape(
        [paths[0], paths[2]], ["x", "y"], 4))
    assert [g[1] for g in groups] == [["x", "y"]] and groups[0][0][0].dtype == np.uint8
    with pytest.raises(ValueError):
        tsep.SeparatorNetPostProcessor(paths, predictor, names=["a", "b", "c"])
    with pytest.raises(ValueError):
        tsep.SeparatorNetPostProcessor(pages, predictor, page_paths=other)
