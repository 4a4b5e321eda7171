"""Beam search as a Python loop of static-shape steps.

Counterpart of ``openvivqa_tpu/training/decode.py``, with its semantics kept
letter for letter: all shapes are (bs * beam, ...) from the first step and beams
1..B-1 start at a cumulative log-prob of -1e18, so the first selection takes the
top-`beam` words of beam 0; once a beam emits <eos> its cumulative log-prob is
frozen, word 0 is its only continuation that does not cost EOS_FREEZE, and the
log-probs recorded for it are multiplied by its alive mask (0); the beams are
sorted by cumulative log-prob at the end.

The JAX package's ``lax.scan`` becomes a loop over ``max_len`` steps whose
tensors never change shape (so that a CUDA graph can capture the step later).
Its one-hot matmul reorder of the caches was a TPU workaround: here the ring
caches are reordered with ``index_select``; the encoder K/V, identical across a
sample's beams, live outside the cache and are never touched.

Candidates are selected with a stable descending sort, which, like
``jax.lax.top_k``, returns the lowest index first among equals: frozen beams
hold many candidates at exactly EOS_FREEZE and disabled ones at -1e18, where
``torch.topk`` promises no order.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch

NEG_INF = -1e18
EOS_FREEZE = -999.0


def _gather_beams(tree, selected_beam: torch.Tensor, bs: int, beam: int):
    """Reorder every (bs * beam, ...) tensor of `tree` (nested dicts, lists,
    tuples and plain objects) by the per-sample beam indices selected_beam
    (bs, beam); anything else passes through."""
    offsets = torch.arange(bs, device=selected_beam.device)[:, None] * beam
    rows = (offsets + selected_beam).reshape(-1)

    def gather(node):
        if isinstance(node, torch.Tensor):
            if node.ndim == 0 or node.shape[0] != bs * beam:
                return node
            return node.index_select(0, rows.to(node.device))
        if isinstance(node, dict):
            return {key: gather(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(gather(value) for value in node)
        if hasattr(node, "__dict__"):
            clone = copy.copy(node)
            for key, value in vars(node).items():
                setattr(clone, key, gather(value))
            return clone
        return node

    return gather(tree)


def _top_k_stable(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, the lowest index first among equals."""
    ordered, indices = torch.sort(values, dim=-1, descending=True, stable=True)
    return ordered[..., :k], indices[..., :k]


def _take_beams(x: torch.Tensor, selected_beam: torch.Tensor) -> torch.Tensor:
    """x (bs, beam, ...) reordered along its beam axis."""
    index = selected_beam.reshape(selected_beam.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, index.expand(selected_beam.shape + x.shape[2:]))


@torch.no_grad()
def beam_search(
    step_fn: Callable[[Dict, torch.Tensor], Tuple[torch.Tensor, Dict]],
    init_cache: Dict,
    batch_size: int,
    beam_size: int,
    max_len: int,
    bos_idx: int,
    eos_idx: int,
    out_size: int = 1,
    return_probs: bool = False,
    device: Optional[torch.device] = None,
):
    """step_fn: (cache, tokens (bs * beam, 1) int64) -> (log-probs (bs * beam, 1,
    V), new cache); the encoder outputs are closed over, already expanded to
    bs * beam rows.  init_cache: the zeroed cache tree with bs * beam leading
    dims.  Returns (outputs, log_probs[, all_log_probs]): outputs (bs, max_len)
    int32 when out_size == 1, else (bs, out_size, max_len)."""
    bs, beam = batch_size, beam_size
    f32 = {"dtype": torch.float32, "device": device}
    cache = init_cache
    seq_logprob = torch.full((bs, beam, 1), NEG_INF, **f32)
    seq_logprob[:, 0] = 0.0
    selected_words = torch.full((bs * beam, 1), bos_idx, dtype=torch.int64, device=device)
    seq_mask = torch.ones((bs, beam, 1), **f32)
    outputs = torch.zeros((bs, beam, max_len), dtype=torch.int64, device=device)
    log_probs = torch.zeros((bs, beam, max_len), **f32)
    stacked = []

    for t in range(max_len):
        word_logprob, cache = step_fn(cache, selected_words)
        vocab_size = word_logprob.shape[-1]
        word_logprob = word_logprob.reshape(bs, beam, vocab_size).float()
        candidate = seq_logprob + word_logprob

        # freeze finished beams; at t = 0 the previous words are <bos>, a no-op
        alive = (selected_words.reshape(bs, beam, 1) != eos_idx).to(torch.float32)
        seq_mask = seq_mask * alive
        masked_word_logprob = word_logprob * seq_mask
        frozen = seq_logprob.expand_as(candidate).clone()
        frozen[:, :, 1:] = EOS_FREEZE
        candidate = seq_mask * candidate + frozen * (1.0 - seq_mask)

        selected_logprob, selected_idx = _top_k_stable(
            candidate.reshape(bs, beam * vocab_size), beam)
        selected_beam = selected_idx // vocab_size  # (bs, beam)
        words = selected_idx % vocab_size

        cache = _gather_beams(cache, selected_beam, bs, beam)
        seq_logprob = selected_logprob[..., None]
        seq_mask = _take_beams(seq_mask, selected_beam)
        outputs = _take_beams(outputs, selected_beam)
        outputs[:, :, t] = words
        # the chosen word's log-prob under the masked distribution
        this_word_logprob = _take_beams(masked_word_logprob, selected_beam).gather(
            2, words[..., None])
        log_probs = _take_beams(log_probs, selected_beam)
        log_probs[:, :, t] = this_word_logprob[..., 0]
        selected_words = words.reshape(bs * beam, 1)
        if return_probs:
            stacked.append(masked_word_logprob)

    # sort the beams by their final cumulative log-prob, stably
    order = torch.sort(-seq_logprob[:, :, 0], dim=1, stable=True).indices
    outputs = _take_beams(outputs, order)[:, :out_size].to(torch.int32)
    log_probs = _take_beams(log_probs, order)[:, :out_size]
    if out_size == 1:
        outputs, log_probs = outputs[:, 0], log_probs[:, 0]
    if return_probs:
        all_log_probs = _take_beams(torch.stack(stacked, dim=2), order)  # (bs, beam, T, V)
        return outputs, log_probs, all_log_probs
    return outputs, log_probs


def _repeat_rows(tree, beam: int):
    """Every tensor of `tree` (a tensor, or nested dicts, lists and tuples
    such as IterativeM4C's encoder state) with each row repeated `beam` times;
    anything else passes through."""
    if isinstance(tree, torch.Tensor):
        return tree.repeat_interleave(beam, dim=0)
    if isinstance(tree, dict):
        return {key: _repeat_rows(value, beam) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_repeat_rows(value, beam) for value in tree)
    return tree


@torch.no_grad()
def generate(model, batch: Dict[str, torch.Tensor], beam_size: int, out_size: int = 1,
             return_probs: bool = False):
    """Encode once, expand to beams (the encoder output may be a tensor or a
    tree of them), prepare the decode invariants once, then
    beam-search with the model's single-token decode step.  The batch size is
    the batch's own (loaders pad the last batch, so it is the same for a whole
    split)."""
    encoder_features, encoder_bias = model.encode(batch)
    enc_b = _repeat_rows(encoder_features, beam_size)
    bias_b = _repeat_rows(encoder_bias, beam_size)
    first = next(iter(batch.values()))
    batch_size, device = first.shape[0], first.device
    prep = model.prepare_decode(enc_b, bias_b)
    cache = model.init_decode_cache(batch_size * beam_size, device)

    def step_fn(cache, tokens):
        return model.decode_step(tokens, cache, prep), cache

    return beam_search(
        step_fn, cache, batch_size=batch_size, beam_size=beam_size,
        max_len=model.max_generation_length, bos_idx=model.vocab.bos_idx,
        eos_idx=model.vocab.eos_idx, out_size=out_size, return_probs=return_probs,
        device=device,
    )
