"""The port's text-block stages against the JAX package's, on the CPU.

- word vectors (``stages/textblock_similarity.py``): the loaders (word2vec
  text with and without its header line, ``.npz``), the tokenizer, the
  stop-word lists (the test runs before lower-casing, as in the JAX
  module) and the per-pair similarity; then ``run_feature_generation
  --language german --wv_path <file>`` over demo pages whose lines carry
  words, with seeded vectors in both formats: the feature JSONs equal the
  JAX CLI's byte for byte;
- the text-block post-processor (``stages/textblock_postprocess.py``) on
  seeded probability maps: the CC-filtered mask equal bit for bit
  (components around the 99-100 pixel cut), the polygons and the point
  thinning equal, and ``xy_cut``'s rectangles equal.
"""
import filecmp
import os
import re
import sys

import numpy as np
import pytest

from citlab_as_tpu.stages import textblock_postprocess as jpost
from citlab_as_tpu.stages import textblock_similarity as jsim
from citlab_as_tpu_torch.stages import textblock_postprocess as tpost
from citlab_as_tpu_torch.stages import textblock_similarity as tsim
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VOCAB = ["Zeitung", "Regierung", "Stadt", "Bericht", "Wahl", "Markt", "Preis",
         "Schule", "Kirche", "Krieg", "Frieden", "Bahn", "Hafen", "Wetter"]
STOP = ["der", "die", "Die", "und", "in", "von", "Der", "mit"]
OTHER = ["1923", "Unbekannt", "fremd", ",", ".", "-", "Ära"]


def _text(rng, n):
    pool = VOCAB * 3 + STOP * 2 + OTHER
    return " ".join(pool[i] for i in rng.randint(0, len(pool), n))


def _write_vectors(root, kind, rng, dim=6):
    words = sorted({w.lower() for w in VOCAB} | {w.lower() for w in STOP} | {"ära"})
    vectors = rng.randn(len(words), dim).astype(np.float32)
    if kind == "npz":
        path = os.path.join(root, "wv.npz")
        np.savez(path, words=np.asarray(words), vectors=vectors)
        return path
    path = os.path.join(root, f"wv_{kind}.txt")
    with open(path, "w", encoding="utf-8") as f:
        if kind == "header":
            f.write(f"{len(words)} {dim}\n")
        for w, v in zip(words, vectors):
            f.write(w + " " + " ".join(repr(float(x)) for x in v) + "\n")
    return path


@pytest.mark.parametrize("kind", ["header", "plain", "npz"])
def test_word_vector_loaders_equal_jax(tmp_path, kind):
    path = _write_vectors(str(tmp_path), kind, np.random.RandomState(1))
    got, want = tsim.load_word_vectors(path), jsim.load_word_vectors(path)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_similarity_features_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    vectors = tsim.load_word_vectors(_write_vectors(str(tmp_path), "npz", rng))
    blocks = {f"r{i}": _text(rng, rng.randint(2, 14)) for i in range(9)}
    blocks["r_empty"] = ""
    blocks["r_stop"] = "der die und in von mit der"
    for language in ("german", "English", "klingon"):
        got = tsim.TextblockSimilarity(language, word_vectors=vectors)
        want = jsim.TextblockSimilarity(language, word_vectors=vectors)
        assert got._stop_words == jsim._FALLBACK_STOPWORDS.get(language.lower(), set())
        for ext in (got, want):
            ext.set_tb_dict(blocks)
            ext.run()
        assert got.feature_dict == want.feature_dict
    assert tsim.word_tokenize("Die Wahl, 1923-Ära!") == jsim.word_tokenize("Die Wahl, 1923-Ära!")
    assert tsim.normalized_cos_sim(np.zeros(3), np.ones(3)) == 0.5
    with pytest.raises(ValueError):
        tsim.TextblockSimilarity("german")


@pytest.fixture(scope="module")
def word_pages(tmp_path_factory):
    """Two demo pages with words in their lines, through the JAX package's
    baseline clustering and text regions (the feature stage's input)."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu.stages.baseline_clustering import cluster_page
    from citlab_as_tpu.stages.textregion import generate_text_regions_for_page
    root = str(tmp_path_factory.mktemp("words"))
    rng = np.random.RandomState(3)
    pages = []
    for i, seed in enumerate((3, 11)):
        make_demo_page(root, f"w{i}", np.random.RandomState(seed))
        page = os.path.join(root, "page", f"w{i}.xml")
        with open(page, encoding="utf-8") as f:
            xml = f.read()
        xml = re.sub(r"demo line \d+", lambda _: _text(rng, rng.randint(1, 12)), xml)
        with open(page, "w", encoding="utf-8") as f:
            f.write(xml)
        cluster_page(page, min_polygons_for_cluster=3, rectangle_interline_factor=0.4)
        generate_text_regions_for_page(page)
        pages.append(page)
    lst = os.path.join(root, "pages.lst")
    with open(lst, "w") as f:
        f.write("\n".join(pages) + "\n")
    return root, lst


@pytest.mark.parametrize("kind", ["header", "npz"])
def test_feature_generation_with_word_vectors_equals_jax(word_pages, kind):
    from citlab_as_tpu.cli import run_feature_generation as jcli
    from citlab_as_tpu_torch.cli import run_feature_generation as tcli
    root, lst = word_pages
    wv = _write_vectors(root, kind, np.random.RandomState(4))
    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        outs[name] = os.path.join(root, f"json_{kind}_{name}")
        cli.main(["--pagexml_list", lst, "--out_path", outs[name], "--language", "german",
                  "--wv_path", wv])
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) == 2
    for name in names:
        assert filecmp.cmp(os.path.join(outs["jax"], name), os.path.join(outs["port"], name),
                           shallow=False), name
    import json
    with open(os.path.join(outs["port"], names[0])) as f:
        graph = json.load(f)
    # separator crossings (2) + the similarity; not all 0.5
    assert {len(e) for e in graph["edge_features"]} == {3}
    assert len({e[2] for e in graph["edge_features"]}) > 2


def _probability_map(seed, h=160, w=130):
    """Blobs of many sizes (several near the 1 % cut of 99-100 pixels) on
    noise; channel 0 is the text-block probability."""
    rng = np.random.RandomState(seed)
    prob = rng.rand(h, w).astype(np.float32) * 0.04
    for _ in range(14):
        y, x = rng.randint(0, h - 16), rng.randint(0, w - 16)
        bh, bw = rng.randint(3, 16), rng.randint(3, 16)
        prob[y:y + bh, x:x + bw] = rng.uniform(0.05, 1.0)
    prob[5:15, 5:15] = 0.9                      # 100 px
    prob[20:29, 40:51] = 0.9                    # 99 px
    return np.stack([prob, 1.0 - prob], axis=-1)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_block_post_processor_equals_jax(seed):
    net_output = _probability_map(seed)
    got_proc = tpost.TextBlockNetPostProcessor(device="cpu")
    want_proc = jpost.TextBlockNetPostProcessor()
    got, want = got_proc.post_process(net_output), want_proc.post_process(net_output)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.any() and (got == 0).any()
    assert got_proc.to_polygons(got) == want_proc.to_polygons(want)
    assert got_proc.run_on_probability_map(net_output) == \
        want_proc.run_on_probability_map(net_output)


def test_remove_every_nth_point_equals_jax():
    rng = np.random.RandomState(5)
    for n_points in (10, 39, 40, 41, 95):
        poly = [(int(x), int(y)) for x, y in rng.randint(0, 100, (n_points, 2))]
        closed = poly + [poly[0]]
        for p in (poly, closed):
            for n, iters in ((2, 1), (3, 2), (2, 0)):
                assert tpost.remove_every_nth_point(list(p), n, 20, iters) == \
                    jpost.remove_every_nth_point(list(p), n, 20, iters)


@pytest.mark.parametrize("seed", [0, 1])
def test_xy_cut_equals_jax(seed):
    """A text-block map (255 = block) of columns of paragraphs: the
    recursive XY-cut's leaf rectangles equal, at the default and a
    shallow depth."""
    rng = np.random.RandomState(seed)
    img = np.zeros((300, 240), np.uint8)
    for col in range(3):
        y = rng.randint(5, 20)
        while y < 260:
            h = rng.randint(15, 50)
            x0 = 10 + col * 78 + rng.randint(0, 6)
            img[y:y + h, x0:x0 + rng.randint(50, 66)] = 255
            y += h + rng.randint(8, 20)
    for kwargs in ({}, {"max_recursion_depth": 2, "mode": "vertical", "threshold": 0.95}):
        got = [tuple(vars(r).values()) for r in tpost.xy_cut(img, **kwargs)]
        want = [tuple(vars(r).values()) for r in jpost.xy_cut(img, **kwargs)]
        assert got == want and len(got) > 1
    assert tpost.get_separators(img, "vertical") == jpost.get_separators(img, "vertical")
