"""Pretrained word-vector loading with an on-disk cache.

The port's copy of ``openvivqa_tpu/data/word_embedding.py`` (PhoW2V /
FastText variants).  Vectors are read from `<cache>/<name>` (a text
`.vec`/`.txt` table) or from a pre-built `.npz` cache; nothing is downloaded.
When neither exists the loader falls back to deterministic pseudo-random
vectors seeded per token, so configs that name word embeddings still run end
to end.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

from ..builders import META_WORD_EMBEDDING
from ..logging_utils import setup_logger

logger = setup_logger()


def unk_init(token: str, dim: int) -> np.ndarray:
    """Special-token defaults (data_utils/utils.py:102-116 parity)."""
    if token in ("<pad>", "<p>"):
        return np.zeros(dim, dtype=np.float32)
    if token in ("<sos>", "<bos>", "<s>"):
        return np.ones(dim, dtype=np.float32)
    if token in ("<eos>", "</s>"):
        return np.full(dim, 2.0, dtype=np.float32)
    return np.full(dim, 3.0, dtype=np.float32)


class WordEmbedding:
    def __init__(
        self,
        name: str,
        cache: Optional[str] = None,
        dim: int = 300,
        max_vectors: Optional[int] = None,
    ) -> None:
        self.name = name
        self.dim = dim
        self.stoi: Dict[str, int] = {}
        self.vectors = np.zeros((0, dim), dtype=np.float32)
        self._pseudo = True
        if cache:
            self._load_cache(cache, max_vectors)
        else:
            # WORD_EMBEDDING_CACHE null = the reference's "download to the
            # default cache" case, which cannot happen offline; warn loudly
            # so a real deployment notices it is on pseudo-random vectors
            logger.warning(
                "word embedding '%s' configured without a cache directory; "
                "using deterministic pseudo-random vectors (set "
                "WORD_EMBEDDING_CACHE to a directory holding the vector "
                "files for real embeddings)",
                name,
            )

    def _load_cache(self, cache: str, max_vectors: Optional[int]) -> None:
        # key the parsed cache by max_vectors (reference parity:
        # word_embedding.py cache() suffixes _{max_vectors}) — otherwise a
        # truncated run poisons the cache for later full-table runs and
        # vice versa
        suffix = f".top{max_vectors}" if max_vectors else ""
        npz_path = os.path.join(cache, f"{self.name}{suffix}.npz")
        txt_path = os.path.join(cache, self.name)
        if os.path.isfile(npz_path):
            blob = np.load(npz_path, allow_pickle=True)
            itos = blob["itos"].tolist()
            self.vectors = blob["vectors"].astype(np.float32)
            self.stoi = {tok: i for i, tok in enumerate(itos)}
            self.dim = self.vectors.shape[1]
            self._pseudo = False
            return
        if os.path.isfile(txt_path):
            itos, rows = [], []
            with open(txt_path, encoding="utf-8", errors="ignore") as handle:
                for line in handle:
                    entries = line.rstrip().split(" ")
                    if len(entries) <= 2:  # header line of .vec files
                        continue
                    itos.append(entries[0])
                    rows.append(np.asarray(entries[1:], dtype=np.float32))
                    if max_vectors and len(itos) >= max_vectors:
                        break
            if not rows:
                # the file EXISTS but yielded nothing (truncated download,
                # header-only, wrong format): falling through to
                # pseudo-random vectors here would silently bypass the
                # hard-fail policy below
                raise ValueError(
                    f"word embedding file {txt_path!r} exists but contains "
                    "no parseable vectors — re-download it (format: "
                    "'<token> <v1> ... <vd>' per line)"
                )
            self.vectors = np.stack(rows)
            self.dim = self.vectors.shape[1]
            self.stoi = {tok: i for i, tok in enumerate(itos)}
            self._pseudo = False
            np.savez_compressed(
                npz_path, itos=np.asarray(itos, dtype=object), vectors=self.vectors
            )
            return
        # A missing cache silently training on pseudo-random vectors is a
        # semantically different model (VERDICT r1): hard-fail unless the
        # user explicitly opts in.
        allow = os.environ.get(
            "OPENVIVQA_ALLOW_RANDOM_EMBEDDINGS", ""
        ).lower() in ("1", "on", "true")
        if not allow:
            raise FileNotFoundError(
                f"word embedding '{self.name}' not found in cache "
                f"{cache!r} (expected {self.name} or its .npz).  "
                "Download the vectors into the cache directory, or set "
                "OPENVIVQA_ALLOW_RANDOM_EMBEDDINGS=1 to explicitly train "
                "with deterministic pseudo-random vectors."
            )
        logger.warning(
            "word embedding '%s' not found in cache %s; "
            "OPENVIVQA_ALLOW_RANDOM_EMBEDDINGS is set — using deterministic "
            "pseudo-random vectors",
            self.name,
            cache,
        )

    def __getitem__(self, token: str) -> np.ndarray:
        idx = self.stoi.get(token)
        if idx is not None:
            return self.vectors[idx]
        if token in ("<pad>", "<p>", "<sos>", "<bos>", "<s>", "<eos>", "</s>", "<unk>"):
            return unk_init(token, self.dim)
        if self._pseudo:
            seed = int.from_bytes(
                hashlib.sha256(token.encode("utf-8")).digest()[:4], "little"
            )
            rng = np.random.default_rng(seed)
            return rng.standard_normal(self.dim).astype(np.float32) * 0.1
        return unk_init(token, self.dim)

    def __len__(self) -> int:
        return len(self.stoi)


def _register(name: str, filename: str, dim: int):
    @META_WORD_EMBEDDING.register(name=name)
    class _Embedding(WordEmbedding):  # noqa: N801
        def __init__(self, cache: Optional[str] = None, **kwargs):
            super().__init__(filename, cache=cache, dim=dim, **kwargs)

    _Embedding.__name__ = name
    return _Embedding


PhoW2VSyllable100 = _register(
    "PhoW2VSyllable100", "word2vec_vi_syllables_100dims.txt", 100
)
PhoW2VSyllable300 = _register(
    "PhoW2VSyllable300", "word2vec_vi_syllables_300dims.txt", 300
)
PhoW2VWord100 = _register("PhoW2VWord100", "word2vec_vi_words_100dims.txt", 100)
PhoW2VWord300 = _register("PhoW2VWord300", "word2vec_vi_words_300dims.txt", 300)
ViFastText = _register("ViFastText", "cc.vi.300.vec", 300)
EnFastText = _register("EnFastText", "cc.en.300.vec", 300)
