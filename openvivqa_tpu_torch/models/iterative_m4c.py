"""IterativeM4C: a single-stream prefix LM over [regions, grids, OCR tokens,
question | answer] with a dynamic-vocab answer stream (the fixed vocab and
each sample's OCR rows) and a pointer network that copies OCR tokens,
beam-searched at eval.

Counterpart of ``openvivqa_tpu/models/iterative_m4c.py``.  ``build_model``
gives configs/iterative_m4c.yaml (ARCHITECTURE M4C with an OCR_DET_EMBEDDING)
to this model.  Every stream is tagged with the text embedding of its
modality's special token; the OCR stream sums its det, rec, box and word
embeddings.  ``forward`` returns log-probs (a log_softmax over [vocab scores |
pointer scores]).  The model has no ``decoder``: it implements the decode
interface itself, and the JAX package's flax ``cache`` collection becomes the
decode cache's tensors, which beam search reorders with the beams: the token
buffer (rows, T) and, in the incremental mode, the answer bank (rows, layers,
T, d) of every layer's inputs at the written slots.  The step counter is an
int, shared by all rows.  What no step changes (the joint prefix, or in the
incremental mode every layer's input over it, the OCR rows and the OCR
outputs) lives in ``prepare_decode``'s state, identical across a sample's beams.

Eval routes: the quadratic step re-encodes [prefix | buffer] under the full
(bs, 1, L, L) prefix-LM bias, every attention through the packed kernel; the
incremental mode (``DECODING_MODE: incremental``, context-blind) encodes the
prefix once and then attends each new token, one query row, over [that layer's
prefix inputs | bank] (the packed kernel's single-query block).  The FFNs are
``nn.Linear``, as the JAX package leaves them to its compiler.  Parameter names
are the port's (no reference converter reads this model): the streams'
embeddings at the top, ``encoder``, ``dynamic_network.{query,key}`` and
``vocab_proj``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..builders import (
    META_ARCHITECTURE,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, GenerativeModel, init_xavier_law_
from .mmf_m4c import resolve_decoding_mode
from .modules.masks import MASK_VALUE, causal_bias, combine_biases, padding_bias, prefix_lm_bias


class DynamicPointerNetwork(nn.Module):
    """Pointer scores query(OCR) . key(answer) / sqrt(d), set to MASK_VALUE at
    padded OCR tokens (not added), transposed to (bs, L_ans, K)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)

    def forward(self, ocr_features, answer_features, ocr_bias):
        scores = self.query(ocr_features) @ self.key(answer_features).transpose(1, 2)
        scores = scores / math.sqrt(float(self.d_model))
        masked = ocr_bias[:, 0, 0, :, None] != 0  # (bs, K, 1)
        scores = torch.where(masked, torch.full_like(scores, MASK_VALUE), scores)
        return scores.transpose(1, 2)


@META_ARCHITECTURE.register()
class IterativeM4C(GenerativeModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.decoding_mode, self.context_blind = resolve_decoding_mode(config)
        self.region_embedding = build_vision_embedding(config.REGION_EMBEDDING)
        self.grid_embedding = build_vision_embedding(config.GRID_EMBEDDING)
        self.box_embedding = build_vision_embedding(config.BOX_EMBEDDING)
        self.ocr_det_embedding = build_vision_embedding(config.OCR_DET_EMBEDDING)
        self.ocr_rec_embedding = build_vision_embedding(config.OCR_REC_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.ocr_embedding = build_text_embedding(config.OCR_TEXT_EMBEDDING, vocab)
        self.dynamic_embedding = build_text_embedding(config.DYNAMIC_EMBEDDING, vocab)
        self.encoder = build_encoder(config.ENCODER)
        self.dynamic_network = DynamicPointerNetwork(config.D_MODEL)
        self.vocab_proj = nn.Linear(config.D_MODEL, len(vocab))

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers (``init_xavier_law_``; the dynamic
        embedding's fixed rows Xavier-uniform too)."""
        init_xavier_law_(self, generator)
        table = self.dynamic_embedding.fixed_weights
        bound = math.sqrt(6.0 / sum(table.shape))
        with torch.no_grad():
            table.copy_((2.0 * torch.rand(table.shape, generator=generator) - 1.0) * bound)

    # -- the streams -------------------------------------------------------------------
    def _tag(self, features, token_idx: int, generator=None):
        tokens = torch.full(features.shape[:2], token_idx, dtype=torch.long,
                            device=features.device)
        tag, _ = self.text_embedding(tokens, generator)
        return features + tag

    def embed_features(self, batch: BatchTensors, generator=None):
        """The joint prefix (bs, C, d) and its padding bias (bs, 1, 1, C)."""
        v, g = self.vocab, generator
        region, region_bias = self.region_embedding(batch["region_features"], g)
        region = self._tag(region, v.feat_idx, g)
        region = region + self._tag(self.box_embedding(batch["region_boxes"], g)[0], v.box_idx, g)

        grid, grid_bias = self.grid_embedding(batch["grid_features"], g)
        grid = self._tag(grid, v.feat_idx, g)
        grid = grid + self._tag(self.box_embedding(batch["grid_boxes"], g)[0], v.box_idx, g)

        det, ocr_bias = self.ocr_det_embedding(batch["ocr_det_features"], g)
        det = self._tag(det, v.ocr_det_idx, g)
        rec = self._tag(self.ocr_rec_embedding(batch["ocr_rec_features"], g)[0], v.ocr_rec_idx, g)
        boxes = self._tag(self.box_embedding(batch["ocr_boxes"], g)[0], v.box_idx, g)
        words = self._tag(self.ocr_embedding(batch["ocr_fasttext_features"], g)[0], v.ocr_idx, g)
        ocr = det + rec + boxes + words

        question, (question_bias, _) = self.text_embedding(batch["question_tokens"], g)
        question = self._tag(question, v.question_idx, g)
        return (torch.cat([region, grid, ocr, question], dim=1),
                torch.cat([region_bias, grid_bias, ocr_bias, question_bias], dim=-1))

    @staticmethod
    def _ocr_span(batch: BatchTensors):
        start = batch["region_features"].shape[1] + batch["grid_features"].shape[1]
        return start, start + batch["ocr_det_features"].shape[1]

    def _answer_features(self, tokens, embedded_ocr, generator=None):
        features, (pad_bias, _) = self.dynamic_embedding(tokens, embedded_ocr, generator)
        return self._tag(features, self.vocab.answer_idx, generator), pad_bias

    def _output(self, answer_out, ocr_out, ocr_bias):
        scores = torch.cat([self.vocab_proj(answer_out),
                            self.dynamic_network(ocr_out, answer_out, ocr_bias)], dim=-1)
        return torch.log_softmax(scores, dim=-1)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        """Teacher-forced log-probs (bs, T, V + K) on batch["answer_tokens"]."""
        joint, joint_bias = self.embed_features(batch, generator)
        ocr_start, ocr_end = self._ocr_span(batch)
        return self._teacher_forced(batch["answer_tokens"], joint, joint_bias, ocr_start,
                                    joint[:, ocr_start:ocr_end],
                                    joint_bias[..., ocr_start:ocr_end], generator)

    def _teacher_forced(self, tokens, joint, joint_bias, ocr_start: int, embedded_ocr, ocr_bias,
                        generator=None):
        joint_len, ocr_len = joint.shape[1], embedded_ocr.shape[1]
        answer_features, answer_pad = self._answer_features(tokens, embedded_ocr, generator)
        answer_block = combine_biases(answer_pad, causal_bias(tokens.shape[1], tokens.device))
        encoded = self.encoder(torch.cat([joint, answer_features], dim=1),
                               prefix_lm_bias(joint_bias, answer_pad, answer_block,
                                              self.context_blind),
                               generator)
        return self._output(encoded[:, joint_len:],
                            encoded[:, ocr_start:ocr_start + ocr_len], ocr_bias)

    # -- the decode interface ----------------------------------------------------------
    def encode(self, batch: BatchTensors, generator=None):
        """(state, joint padding bias): the state holds the OCR rows, their
        bias and start, and the joint prefix, or in the incremental mode every
        encoder layer's input over the prefix (the first of them is the prefix
        itself) and the encoded OCR rows."""
        joint, joint_bias = self.embed_features(batch, generator)
        ocr_start, ocr_end = self._ocr_span(batch)
        state = {"ocr": joint[:, ocr_start:ocr_end], "ocr_bias": joint_bias[..., ocr_start:ocr_end],
                 "ocr_start": ocr_start}
        if self.decoding_mode == "incremental":
            ctx_out, layer_inputs = self.encoder(joint, joint_bias, return_layer_inputs=True)
            state["ctx_inputs"] = tuple(layer_inputs)
            state["ocr_out"] = ctx_out[:, ocr_start:ocr_end]
        else:
            state["joint"] = joint
        return state, joint_bias

    def prepare_decode(self, encoder_state, encoder_attention_bias) -> Dict:
        return {**encoder_state, "bias": encoder_attention_bias}

    def init_decode_cache(self, rows: int, device) -> Dict:
        max_len = self.max_generation_length
        cache = {"tokens": torch.zeros((rows, max_len), dtype=torch.long, device=device),
                 "step": 0}
        if self.decoding_mode == "incremental":
            d = self.vocab_proj.in_features
            cache["bank"] = torch.zeros((rows, len(self.encoder.layers), max_len, d),
                                        dtype=torch.float32, device=device)
        return cache

    def _write_token(self, token, cache) -> int:
        """Write the step's tokens (rows, 1) into the buffer; returns the step."""
        i = cache["step"]
        cache["tokens"][:, i] = token[:, 0]
        cache["step"] = i + 1
        return i

    def decode_step(self, token: torch.Tensor, cache: Dict, prep: Dict) -> torch.Tensor:
        """Log-probs (rows, 1, V + K) of the next token after `token` (rows, 1);
        writes `cache` in place."""
        if self.decoding_mode == "incremental":
            return self._incremental_decode_step(token, cache, prep)
        i = self._write_token(token, cache)
        buffer = cache["tokens"]
        joint, embedded_ocr = prep["joint"], prep["ocr"]
        joint_len, ocr_start, max_len = joint.shape[1], prep["ocr_start"], buffer.shape[1]
        answer_features, _ = self._answer_features(buffer, embedded_ocr)
        positions = torch.arange(max_len, device=buffer.device)
        generated = torch.where(positions <= i, 0.0, MASK_VALUE)[None, None, None, :]
        answer_col = combine_biases(padding_bias(buffer, self.vocab.padding_idx), generated)
        answer_block = combine_biases(answer_col, causal_bias(max_len, buffer.device))
        encoded = self.encoder(torch.cat([joint, answer_features], dim=1),
                               prefix_lm_bias(prep["bias"], answer_col, answer_block,
                                              self.context_blind))
        ocr_out = encoded[:, ocr_start:ocr_start + embedded_ocr.shape[1]]
        return self._output(encoded[:, joint_len + i:joint_len + i + 1], ocr_out, prep["ocr_bias"])

    def _incremental_decode_step(self, token, cache, prep):
        """One token against the cached prefix inputs: C + T keys a layer
        instead of re-encoding C + T rows.  The slot bias masks the slots not
        yet written and the padding tokens among those that are (beam search
        feeds word 0, the padding id, to finished beams)."""
        i = self._write_token(token, cache)
        buffer, bank = cache["tokens"], cache["bank"]
        ctx_inputs = prep["ctx_inputs"]
        rows, max_len = buffer.shape
        joint_len = ctx_inputs[0].shape[1]
        token_features, _ = self._answer_features(token, prep["ocr"])
        position = torch.full((rows, 1), float(joint_len + 1 + i), device=buffer.device)
        slots = torch.where(torch.arange(max_len, device=buffer.device) <= i, 0.0, MASK_VALUE)
        slot_bias = combine_biases(slots[None, None, None, :].expand(rows, 1, 1, max_len),
                                   padding_bias(buffer, self.vocab.padding_idx))
        bias = torch.cat([prep["bias"], slot_bias], dim=-1)
        out = self.encoder.decode_step(token_features, position, ctx_inputs,
                                       [bank[:, layer] for layer in range(bank.shape[1])], i, bias)
        return self._output(out, prep["ocr_out"], prep["ocr_bias"])

    def decode_teacher_forced(self, tokens, encoder_state, encoder_attention_bias,
                              generator=None) -> torch.Tensor:
        """Log-probs of given tokens from an ``encode()`` state (the SCST
        re-scoring path).  In the incremental mode the joint prefix is the
        first cached layer input."""
        joint = encoder_state.get("joint")
        if joint is None:
            joint = encoder_state["ctx_inputs"][0]
        return self._teacher_forced(tokens, joint, encoder_attention_bias,
                                    encoder_state["ocr_start"], encoder_state["ocr"],
                                    encoder_state["ocr_bias"], generator)
