"""Word-vector text block similarity (port of
``citlab_as_tpu/stages/textblock_similarity.py``; reference: gnn/input/
textblock_similarity.py:9-97).

Per text block: tokenize, keep alphabetic non-stopword tokens, sum their
word vectors; per pair: cosine similarity mapped to [0, 1]. The reference
uses gensim KeyedVectors and nltk. The port reads word2vec text files and
``.npz`` files (``words`` a string array, ``vectors``) and uses the JAX
module's builtin stop-word lists only: the JAX module asks nltk's
stop-word corpus first and falls back to these lists where the corpus is
not installed; the port does not use nltk. Kept as in the JAX module: the
stop-word test runs before lower-casing, and the token regex is
``\\w+|[^\\w\\s]``.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

# the JAX module's fallback stop-word lists
_FALLBACK_STOPWORDS = {
    "german": {"der", "die", "das", "und", "in", "von", "zu", "den", "dem",
               "ein", "eine", "mit", "ist", "des", "im", "auf", "für", "an",
               "als", "auch", "es", "sich", "nicht", "am", "nach", "bei"},
    "english": {"the", "a", "an", "and", "or", "of", "to", "in", "on", "is",
                "are", "was", "were", "for", "with", "as", "by", "at", "it",
                "that", "this", "be", "from", "not"},
    "french": {"le", "la", "les", "un", "une", "des", "de", "du", "et", "en",
               "dans", "est", "que", "qui", "pour", "sur", "au", "aux", "par",
               "avec", "ne", "pas", "se", "il", "elle"},
    "finnish": {"ja", "on", "ei", "että", "se", "hän", "oli", "mutta", "kun",
                "niin", "myös", "joka", "ovat", "tai", "sen"},
}


def word_tokenize(text: str) -> list:
    return _TOKEN_RE.findall(text)


def load_word_vectors(path: str) -> Dict[str, np.ndarray]:
    """Load word vectors from word2vec text format ('word v1 v2 ...' lines,
    optional count/dim header) or a .npz with 'words'/'vectors' arrays."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {str(w): v for w, v in zip(data["words"], data["vectors"])}
    vectors: Dict[str, np.ndarray] = {}
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        first = f.readline().rstrip("\n")
        parts = first.split(" ")
        if len(parts) != 2 or not parts[0].isdigit():
            word, vals = parts[0], parts[1:]
            vectors[word] = np.asarray([float(v) for v in vals], np.float32)
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            vectors[parts[0]] = np.asarray([float(v) for v in parts[1:]], np.float32)
    return vectors


def _get_stopwords(language: str) -> set:
    return set(_FALLBACK_STOPWORDS.get(language.lower(), set()))


def normalized_cos_sim(x, y) -> float:
    """Cosine similarity mapped to [0, 1]; 0.5 for zero vectors."""
    cos = 0.0
    if np.any(x) and np.any(y):
        cos = float(np.dot(x, y) / (np.linalg.norm(x) * np.linalg.norm(y)))
    return (cos + 1) / 2


class TextblockSimilarity:
    """Feature extractor with the reference's output schema:
    ``feature_dict['edge_features'][idA][idB] = [similarity]`` plus a
    'default' entry."""

    default_edge_value = [0.5]
    min_tb_len = 5

    def __init__(self, language: str, wv_path: Optional[str] = None,
                 word_vectors: Optional[Dict[str, np.ndarray]] = None):
        self._language = language
        if word_vectors is not None:
            self._word_vectors = word_vectors
        elif wv_path is not None:
            self._word_vectors = load_word_vectors(wv_path)
        else:
            raise ValueError("Either wv_path or word_vectors must be given")
        self._stop_words = _get_stopwords(language)
        self._tb_dict: Optional[Dict[str, str]] = None
        self.feature_dict: Optional[dict] = None

    def set_tb_dict(self, tb_dict: Dict[str, str]) -> None:
        self._tb_dict = tb_dict

    def run(self) -> None:
        self.feature_dict = {"edge_features": {"default": self.default_edge_value}}
        scores = self._calc_block_scores()
        self._calc_edge_scores(scores)

    def _calc_block_scores(self) -> Dict[str, np.ndarray]:
        scores = {}
        for tb_key, text in self._tb_dict.items():
            tokens = word_tokenize(text)
            if len(tokens) < self.min_tb_len:
                logger.debug("ignoring textblock %s with only %d words", tb_key, len(tokens))
                continue
            words = [w for w in tokens if w.isalpha()]
            no_stop = [w.lower() for w in words if w not in self._stop_words]
            vect_list = [self._word_vectors[w] for w in no_stop if w in self._word_vectors]
            scores[tb_key] = np.sum(vect_list, axis=0) if vect_list else np.zeros(1)
        return scores

    def _calc_edge_scores(self, scores: Dict[str, np.ndarray]) -> None:
        keys = sorted(scores.keys())
        for k0 in keys:
            self.feature_dict["edge_features"][k0] = {}
            for k1 in keys:
                if k0 < k1:
                    self.feature_dict["edge_features"][k0][k1] = [
                        normalized_cos_sim(scores[k0], scores[k1])]
                elif k0 > k1:
                    self.feature_dict["edge_features"][k0][k1] = \
                        self.feature_dict["edge_features"][k1][k0]
