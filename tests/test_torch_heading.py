"""The heading stage as a whole: the port against the JAX package on the
CPU, same page files, same weights (random from a seed, and the committed
trained heading net), float32.

Tolerances: the quantized probability map may differ from JAX's by 1 count
(of 255) at a pixel, where a float32 probability falls next to a multiple
of 1/255, and must be equal on at least 99.9 % of the pixels; the distance
transform is equal bit for bit; the heading tags and region types written
to PAGE-XML are equal. The JAX stage runs with ``use_device_swt = True`` on
the CPU, as its own tests run it; its ARU-Net takes the plain convolution
route (its Pallas switch is off by default)."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.inference import SegmentationPredictor as JaxPredictor
from citlab_as_tpu.pagexml import Page as JaxPage
from citlab_as_tpu.stages import heading as jhead
from citlab_as_tpu_torch.inference import SegmentationPredictor
from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.pagexml.page import page_cache
from citlab_as_tpu_torch.stages import heading as thead
from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"featRoot": 8, "scale_space_num": 3, "res_depth": 1, "num_scales_att": 2}
H, W = 240, 320


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fixpoints run thousands of small tensor ops: one thread per
    worker is faster than every worker's pool fighting for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _page_image(i, seed=5):
    """White page with a fat-stroke candidate heading, thin body lines and
    noise specks (the fixture of the JAX package's device-SWT test)."""
    rng = np.random.RandomState(seed + i)
    img = np.full((H, W), 255, np.uint8)
    img[20:60, 20:300 - 10 * i] = 0
    for y in (90, 130, 170):
        for x in range(20, 290, 14):
            img[y:y + 14, x:x + 4] = 0
    img[rng.rand(H, W) < 0.002] = 0
    return img


def _page_xml(i, nocoords=True):
    lines = ['''<TextLine id="tl_a">
      <Coords points="18,18 302,18 302,62 18,62"/>
      <Baseline points="18,60 302,60"/></TextLine>''']
    for k, y in enumerate((90, 130, 170)):
        lines.append(f'''<TextLine id="tl_b{k}">
      <Coords points="18,{y - 2} 295,{y - 2} 295,{y + 16} 18,{y + 16}"/>
      <Baseline points="18,{y + 14} 295,{y + 14}"/></TextLine>''')
    if nocoords:
        lines.append('<TextLine id="tl_nocoords"><TextEquiv><Unicode>x</Unicode>'
                     '</TextEquiv></TextLine>')
    return f'''<?xml version="1.0" encoding="UTF-8"?>
<PcGts xmlns="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15">
  <Metadata><Creator>t</Creator><Created>x</Created><LastChange>x</LastChange></Metadata>
  <Page imageFilename="hd{i}.png" imageWidth="{W}" imageHeight="{H}">
    <TextRegion id="tr_head" type="paragraph">
      <Coords points="10,10 310,10 310,70 10,70"/>
{lines[0]}
    </TextRegion>
    <TextRegion id="tr_body" type="heading">
      <Coords points="10,80 310,80 310,230 10,230"/>
{chr(10).join(lines[1:])}
    </TextRegion>
    <TextRegion id="tr_empty"><Coords points="1,1 5,1 5,5 1,5"/></TextRegion>
  </Page>
</PcGts>'''


def _corpus(root, n=2, nocoords=True):
    os.makedirs(os.path.join(root, "page"), exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"hd{i}.png")
        Image.fromarray(_page_image(i)).save(p)
        with open(os.path.join(root, "page", f"hd{i}.xml"), "w") as f:
            f.write(_page_xml(i, nocoords))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def predictors():
    """{name: (jax predictor, port predictor)} with identical float32
    parameters: a narrow shallow random net and the trained heading net."""
    out = {}
    for name, model_dir, gp in (("random", None, SMALL),
                                ("trained", os.path.join(REPO, "models_ckpt", "heading"), None)):
        jp = JaxPredictor(model_dir=model_dir, graph_params=gp, dtype=jnp.float32,
                          pad_multiple=32, seed=2)
        tp = SegmentationPredictor(
            None if model_dir is None else os.path.join(REPO, "models_ckpt_torch", "heading.npz"),
            graph_params=gp, dtype=torch.float32, pad_multiple=32, device="cpu")
        if model_dir is None:
            flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
                jp.variables, sep="/").items()}
            tp.model.load_state_dict(arunet_state_dict_from_flax(flat))
        out[name] = (jp, tp)
    return out


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_fused_heading_chain_matches_jax(predictors, weights):
    jp, tp = predictors[weights]
    pages = np.stack([_page_image(i) for i in range(2)])
    out_h, out_w = 192, 256                       # fixed height 192: a real resize
    j_prob, j_dt = jhead.make_fused_heading_swt_fn(jp.model)(
        jp.variables, jnp.asarray(pages), out_h=out_h, out_w=out_w, pad_multiple=32)
    t_prob, t_dt = thead.make_fused_heading_swt_fn(tp.model)(
        torch.from_numpy(pages), out_h, out_w, pad_multiple=32)
    j_prob, j_dt = np.asarray(j_prob), np.asarray(j_dt)
    assert t_prob.dtype == t_dt.dtype == torch.uint8
    assert t_prob.shape == (2, out_h, out_w) and t_dt.shape == (2, H, W)
    np.testing.assert_array_equal(t_dt.numpy(), j_dt)          # bit for bit
    assert j_dt.max() >= 10, "the fat strokes must show in the DT"
    diff = np.abs(t_prob.numpy().astype(np.int32) - j_prob.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    only = thead.make_fused_heading_fn(tp.model)(torch.from_numpy(pages), out_h, out_w,
                                                 pad_multiple=32)
    assert torch.equal(only, t_prob)


def _tags(page_cls, root, n, suffix=".xml.xml"):
    out = {}
    for i in range(n):
        page = page_cls(os.path.join(root, "page", f"hd{i}{suffix}"))
        out[i] = ({tl.id: (tl.custom.get("structure") or {}).get("semantic_type")
                   for tl in page.get_textlines()},
                  {tr.id: tr.region_type for tr in page.get_text_regions()})
    return out


@pytest.mark.parametrize("weights,fixed_height", [("random", None), ("trained", 192)])
def test_heading_stage_tags_match_jax(tmp_path, predictors, weights, fixed_height):
    jp, tp = predictors[weights]
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    paths = [_corpus(r) for r in roots]

    jproc = jhead.HeadingNetPostProcessor(paths[0], jp, fixed_height=fixed_height)
    jproc.use_device_swt = True
    jproc.run_batched_fused(batch_size=2)

    tproc = thead.HeadingNetPostProcessor(paths[1], tp, fixed_height=fixed_height)
    tproc.use_device_swt = True
    phase = {}
    pages = tproc.run_batched_fused(batch_size=2, phase=phase)

    want, got = _tags(JaxPage, roots[0], 2), _tags(Page, roots[1], 2)
    assert got == want
    assert any(v == "heading" for tags, _ in got.values() for v in tags.values())
    assert all(types["tr_head"] == "heading" and types["tr_body"] == "paragraph"
               and types["tr_empty"] == "paragraph" for _, types in got.values())
    assert len(pages) == 2 and all(isinstance(p, Page) for p in pages)
    assert {"load", "resize+forward", "otsu+edt", "parse+boxes", "line features",
            "readback", "classify+write"} <= set(phase)
    # the saved per-line features are the JAX stage's, value for value
    for (jk, jv), (tk, tv) in zip(sorted(jproc.line_features_by_page.items()),
                                  sorted(tproc.line_features_by_page.items())):
        assert os.path.basename(jk) == os.path.basename(tk)
        assert jv == tv and "tl_nocoords" not in tv and len(tv) == 4


def test_heading_host_paths_agree_with_device_path(tmp_path, predictors):
    """``run`` (host SWT, scipy), the fused path with the device SWT off
    (maps read back, host SWT) and the fused device-SWT path tag the same
    lines; ``use_device_swt`` left at None means off on a CPU predictor."""
    _, tp = predictors["random"]
    tags = []
    for mode in ("run", "fused_host", "fused_device", "batched"):
        root = str(tmp_path / mode)
        paths = _corpus(root, n=2)
        proc = thead.HeadingNetPostProcessor(paths, tp, fixed_height=None)
        if mode == "run":
            proc.run()
        elif mode == "batched":
            proc.use_device_swt = True
            proc.run_batched(batch_size=2)
        else:
            proc.use_device_swt = None if mode == "fused_host" else True
            proc.run_batched_fused(batch_size=2)
            assert proc.use_device_swt is (mode == "fused_device")
        tags.append(_tags(Page, root, 2))
    assert tags[0] == tags[1] == tags[2] == tags[3]


def test_heading_swt_only_and_fault_hook(tmp_path):
    """No predictor and a zero net weight: SWT features alone find the
    heading. A page whose PAGE-XML is missing a readable image is skipped
    through the fault hook, and the others are still written."""
    root = str(tmp_path / "c")
    paths = _corpus(root, n=2)
    with open(paths[1], "wb") as f:
        f.write(b"\xff\xd8not a png")
    seen = []
    proc = thead.HeadingNetPostProcessor(
        paths, None, fixed_height=None,
        weight_dict={"net": 0.0, "stroke_width": 0.5, "text_height": 0.5})
    proc.on_page_error = lambda path, stage, exc: seen.append((path, stage, type(exc).__name__))
    pages = proc.run_batched(batch_size=2)
    assert len(pages) == 1
    assert seen == [(paths[1], "heading", "UnsupportedImageFormat")]
    tags, _ = _tags(Page, root, 1)[0]
    assert tags["tl_a"] == "heading" and tags["tl_b0"] is None


def test_separator_then_heading_chained_in_place(tmp_path, predictors):
    """Files to files, as the full workflow chains them: the separator
    stage writes ``page/<name>.xml.xml``; the heading stage takes those as
    ``page_paths`` with ``save_suffix=""`` and updates them in place,
    through one parse per page under the page cache."""
    _, tp = predictors["random"]
    root = str(tmp_path / "w")
    paths = _corpus(root, n=2, nocoords=False)
    for p in paths:                                   # a column rule to find
        img = np.asarray(Image.open(p)).copy()
        img[5:235, 306:309] = 0
        Image.fromarray(img).save(p)
    with page_cache():
        sep_pred = SegmentationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "separator.npz"),
            dtype=torch.float32, pad_multiple=32, device="cpu")
        sep = SeparatorNetPostProcessor(paths, sep_pred, fixed_height=None)
        sep_pages = sep.run_batched_fused(batch_size=2)
        out_paths = [sep._page_path_for(p) + ".xml" for p in paths]
        assert all(os.path.exists(p) for p in out_paths)
        head = thead.HeadingNetPostProcessor(paths, tp, fixed_height=None,
                                             page_paths=out_paths, save_suffix="")
        head.use_device_swt = True
        head_pages = head.run_batched_fused(batch_size=2)
        assert all(a is b for a, b in zip(sep_pages, head_pages))   # one parse
    assert not os.path.exists(out_paths[0] + ".xml")
    for p in out_paths:
        page = Page(p)
        assert Page.validate_structural(page.page_doc)
        assert len(page.get_textlines()) == 4
    assert sorted(head.line_features_by_page) == sorted(out_paths)
    with pytest.raises(ValueError):
        thead.HeadingNetPostProcessor(paths, tp, page_paths=out_paths[:1])


@pytest.mark.parametrize("drain", ["fused_drain", "fused_drain_finish"])
def test_fused_drain_per_group_writes_the_jax_stage_bytes(tmp_path, predictors, monkeypatch,
                                                          drain):
    """A caller that drives the stage group by group: ``fused_dispatch``
    then ``fused_drain`` (or ``fused_drain_dispatch`` then
    ``fused_drain_finish``) per same-shape group of 2 over 3 pages, in both
    packages on the trained heading net; every written PAGE-XML byte-equal
    (the clock frozen on both sides), every page in ``pages_by_path``."""
    from citlab_as_tpu.pagexml import page as jpage
    from citlab_as_tpu.stages.separator import SeparatorNetPostProcessor as JaxSeparator
    from citlab_as_tpu_torch.pagexml import page as tpage
    for mod in (jpage, tpage):
        monkeypatch.setattr(mod, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    jp, tp = predictors["trained"]
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    paths = [_corpus(r, n=3) for r in roots]

    jproc = jhead.HeadingNetPostProcessor(paths[0], jp, fixed_height=192)
    jproc.use_device_swt = True
    jpages, groups = {}, 0
    for images, chunk in JaxSeparator.group_by_shape(paths[0], 2):
        entry = jproc.fused_dispatch(images, chunk, 2)
        if drain == "fused_drain":
            jproc.fused_drain(entry, jpages)
        else:
            jproc.fused_drain_finish(jproc.fused_drain_dispatch(entry), jpages)
        groups += 1

    tproc = thead.HeadingNetPostProcessor(paths[1], tp, fixed_height=192)
    tproc.use_device_swt = True
    tpages = {}
    for images, chunk in SeparatorNetPostProcessor.group_by_shape(paths[1], paths[1], 2):
        entry = tproc.fused_dispatch(images, chunk)
        if drain == "fused_drain":
            tproc.fused_drain(entry, tpages)
        else:
            tproc.fused_drain_finish(tproc.fused_drain_dispatch(entry), tpages)

    assert groups == 2
    assert sorted(os.path.basename(p) for p in tpages) == sorted(
        os.path.basename(p) for p in jpages) == ["hd0.png", "hd1.png", "hd2.png"]
    assert all(isinstance(p, Page) for p in tpages.values())
    for i in range(3):
        with open(os.path.join(roots[0], "page", f"hd{i}.xml.xml"), "rb") as f:
            want = f.read()
        with open(os.path.join(roots[1], "page", f"hd{i}.xml.xml"), "rb") as f:
            got = f.read()
        assert got == want, i
    assert any(v == "heading" for tags, _ in _tags(Page, roots[1], 3).values()
               for v in tags.values())
