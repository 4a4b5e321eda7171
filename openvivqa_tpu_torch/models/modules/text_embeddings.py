"""Text embeddings.

Counterpart of ``UsualEmbedding``, ``LSTMTextEmbedding`` (with its ``_LSTM``)
and the registered ``HierarchicalFeaturesExtractor`` in
``openvivqa_tpu/models/modules/text_embeddings.py``, under the reference's
parameter names (``components.weight``, or ``components.1`` for the projection
of frozen pretrained vectors; the LSTM embedding's ``embedding``, ``proj`` and
``lstm``).  The hierarchical extractor's names are the port's own
(``embedding``, its UsualEmbedding, and ``convs.N``, one Conv1d per n-gram
size): no reference converter reads them.  The dynamic and OCR embeddings wait
for the models that use them.  Every embedding returns
``(features, (padding_bias, causal_bias))`` with additive 0 / MASK_VALUE biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...builders import META_TEXT_EMBEDDING
from ...ops.gather import take_rows, take_rows_shared
from ...parallel.mesh import whole
from .bert import dropout
from .masks import causal_bias, padding_bias


def _token_masks(tokens: torch.Tensor, padding_idx: int):
    return padding_bias(tokens, padding_idx), causal_bias(tokens.shape[-1], tokens.device)


@META_TEXT_EMBEDDING.register()
class UsualEmbedding(nn.Module):
    """A learned table whose padding row reads as zero at every forward, or,
    with TEXT_EMBEDDING.WORD_EMBEDDING set, the vocab's frozen pretrained
    vectors under a learned projection and dropout."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        self.dropout = config.DROPOUT
        self.pretrained = config.get("WORD_EMBEDDING") is not None
        if not self.pretrained:
            self.components = nn.Embedding(len(vocab), config.D_MODEL)
            return
        if vocab.word_embeddings is None:
            raise ValueError(
                "TEXT_EMBEDDING.WORD_EMBEDDING is set but the vocab has no word_embeddings "
                "loaded (a vocab cache pickled before WORD_EMBEDDING was configured? rebuild "
                "it, or align the vocab config's WORD_EMBEDDING)"
            )
        vectors = torch.as_tensor(vocab.word_embeddings, dtype=torch.float32)
        self.register_buffer("word_vectors", vectors, persistent=False)
        self.components = nn.ModuleDict({"1": nn.Linear(vectors.shape[1], config.D_MODEL)})

    def forward(self, tokens: torch.Tensor, generator=None):
        tokens = tokens.long()
        masks = _token_masks(tokens, self.padding_idx)
        if self.pretrained:
            features = self.components["1"](F.embedding(tokens, self.word_vectors))
            return dropout(features, self.dropout, generator), masks
        features = self.components(tokens) * (tokens != self.padding_idx)[..., None]
        return features, masks


@META_TEXT_EMBEDDING.register()
class LSTMTextEmbedding(nn.Module):
    """Embed (a learned table whose padding row reads as zero at every
    forward, or the vocab's frozen pretrained vectors), project, dropout, then
    a one-layer LSTM over the whole padded sequence (not packed: the padded
    steps run too, as in the JAX package).  flax's LSTM cell has one bias, on
    its hidden kernels: here that is ``bias_hh_l0``, and ``bias_ih_l0`` is held
    out of training (no gradient; zero unless a reference checkpoint sets it),
    so that one Adam step moves the summed bias as the JAX package's does."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        self.dropout = config.DROPOUT
        self.pretrained = config.get("WORD_EMBEDDING") is not None
        if self.pretrained:
            if vocab.word_embeddings is None:
                raise ValueError(
                    "TEXT_EMBEDDING.WORD_EMBEDDING is set but the vocab has no word_embeddings "
                    "loaded (a stale vocab cache? a mismatched vocab config?)"
                )
            vectors = torch.as_tensor(vocab.word_embeddings, dtype=torch.float32)
            self.register_buffer("word_vectors", vectors, persistent=False)
            d_embedding = vectors.shape[1]
        else:
            self.embedding = nn.Embedding(len(vocab), config.D_EMBEDDING)
            d_embedding = config.D_EMBEDDING
        self.proj = nn.Linear(d_embedding, config.D_MODEL)
        self.lstm = nn.LSTM(config.D_MODEL, config.D_MODEL, batch_first=True)
        self.lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, tokens: torch.Tensor, generator=None):
        tokens = tokens.long()
        masks = _token_masks(tokens, self.padding_idx)
        if self.pretrained:
            embedded = F.embedding(tokens, self.word_vectors)
        else:
            embedded = self.embedding(tokens) * (tokens != self.padding_idx)[..., None]
        features = dropout(self.proj(embedded), self.dropout, generator)
        out, _ = self.lstm(features.contiguous())
        return out, masks


def conv_windows(conv: nn.Conv1d, features: torch.Tensor) -> torch.Tensor:
    """A 'valid' Conv1d over the time axis of channels-last features:
    (bs, L, d_in) -> (bs, L - n + 1, d_out)."""
    return conv(features.transpose(1, 2)).transpose(1, 2)


@META_TEXT_EMBEDDING.register()
class HierarchicalFeaturesExtractor(nn.Module):
    """A UsualEmbedding, then one Conv1d per n-gram size; each n-gram window's
    feature is added into every token position the window covers, and the
    sizes' sums are added, so the output stays token-aligned (bs, L, D) under
    the token masks."""

    def __init__(self, config, vocab):
        super().__init__()
        self.ngrams = [int(n) for n in config.N_GRAMS]
        self.embedding = UsualEmbedding(config, vocab)
        self.convs = nn.ModuleList(
            nn.Conv1d(config.D_MODEL, config.D_MODEL, n) for n in self.ngrams)

    def forward(self, tokens: torch.Tensor, generator=None):
        features, masks = self.embedding(tokens, generator)
        out = None
        for n, conv in zip(self.ngrams, self.convs):
            windows = conv_windows(conv, features)  # window p covers tokens [p, p + n)
            acc = sum(F.pad(windows, (0, 0, offset, n - 1 - offset)) for offset in range(n))
            out = acc if out is None else out + acc
        return out, masks


def split_embedding_lookup(fixed_weights: torch.Tensor, oov_features: torch.Tensor,
                           tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """Rows of the [shared fixed (n_fixed, d) | per-sample OOV (bs, K, d)] table
    for tokens (bs, L), ids from n_fixed on indexing the OOV block, without
    building the (bs, n_fixed + K, d) table.  A padding token reads its row as
    F.embedding does (padding_idx only stops gradients): its row's gradient is
    stopped, which changes no forward value."""
    tokens = tokens.long()
    n_fixed = fixed_weights.shape[0]
    oov_ids = tokens - n_fixed
    oov_rows = take_rows(oov_features, oov_ids.clamp(0, oov_features.shape[1] - 1))
    gathered = take_rows_shared(fixed_weights, tokens) + torch.where(
        (oov_ids >= 0)[..., None], oov_rows, torch.zeros((), dtype=oov_rows.dtype,
                                                         device=oov_rows.device))
    is_pad = (tokens == padding_idx)[..., None].to(gathered.dtype)
    return gathered * (1.0 - is_pad) + gathered.detach() * is_pad


@META_TEXT_EMBEDDING.register()
class DynamicEmbedding(nn.Module):
    """A learned fixed-vocab table (``fixed_weights``, len(vocab) x D_MODEL)
    joined with each sample's OCR feature rows: ids from len(vocab) on index
    the OCR block."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        self.fixed_weights = nn.Parameter(torch.empty(len(vocab), config.D_MODEL))
        nn.init.xavier_uniform_(self.fixed_weights)

    def forward(self, tokens: torch.Tensor, oov_features: torch.Tensor, generator=None):
        masks = _token_masks(tokens, self.padding_idx)
        return split_embedding_lookup(whole(self.fixed_weights), oov_features, tokens,
                                      self.padding_idx), masks


@META_TEXT_EMBEDDING.register()
class FixedVocabDynamicEmbedding(nn.Module):
    """DynamicEmbedding whose fixed rows the caller supplies (standalone
    M4C's vocab projection rows); no parameters."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx

    def forward(self, tokens: torch.Tensor, oov_features: torch.Tensor,
                fixed_weights: torch.Tensor, generator=None):
        masks = _token_masks(tokens, self.padding_idx)
        return split_embedding_lookup(fixed_weights, oov_features, tokens,
                                      self.padding_idx), masks


@META_TEXT_EMBEDDING.register()
class OcrWordEmbedding(nn.Module):
    """The projection of each OCR token's FastText vector (the data layer
    emits ``ocr_fasttext_features``), then dropout."""

    def __init__(self, config, vocab):
        super().__init__()
        self.dropout = config.DROPOUT
        self.proj = nn.Linear(config.D_EMBEDDING, config.D_MODEL)

    def forward(self, ocr_fasttext_features: torch.Tensor, generator=None):
        return dropout(self.proj(ocr_fasttext_features), self.dropout, generator), None
