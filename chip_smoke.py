#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``openvivqa_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of every kernel from ``openvivqa_tpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel of the MMF_M4C eval and training paths against its plain
     PyTorch version on the same inputs at the paths' shapes (batch 64, hidden
     768, FFN 3072; kernel C at the encode, decode and TextBert rows and kernel F
     at the MMT context and TextBert encodes, each with its launch plans, its
     device time by launch and cuBLAS bf16 on the same two products alone;
     the dropout attention at rate 0.1 under one seed, so both
     draw the same Philox mask, the forward's keep bits bit for bit against
     ``dropout_mask_bits``, also at MMF_IterativeM4C's encoder and decoder
     cross-attention training shapes, with the backward's two kernels timed
     apart and SDPA's backward alone beside SDPA's forward + backward), kernel
     D over T + 1 greedy steps of the MMT (64 rows, 8 heads of 96, the 210-key
     context and 5 slots), and each decode-step kernel of the
     IterativeMCAN beam path (kernels A, B and the decoder-layer step at 63
     rows, hidden 512, FFN 2048, over T + 1 steps with the ring reordered
     between steps as beam search does; the layer step also bit for bit
     against its three stage kernels), and kernel E of the Iterative M4C
     decode step (64 rows, hidden 512, 210 bf16 encoder keys, eps 1e-12),
     the flat attention at JointTransformer's beam-eval cross step (60 rows x
     8 heads x 1 query over the joint stream's keys, d 64, one fully masked
     row), with a per-head bias and at d_k != d_v, and the streamed attention
     at 64 x 1536 x 1536 (hd 512, 8 heads; beside the packed kernel at that
     shape) and at a ragged 1601 keys, with the max |kernel - plain| beside its
     tolerance, median CUDA-event times of the kernel's call, of its plain
     version and, for the attention kernels, of one torch.nn.functional.
     scaled_dot_product_attention call on the same inputs (timed here only,
     never called by the port), the device time of the kernel and of that
     library call (torch.profiler over 20 calls, ``device_ms``; the call time
     less it is the host's share), and each kernel's bound: the least time the
     card could take, max(FLOPs / 989 TFLOP/s bf16, bytes / 3.35 TB/s), each
     input read once and each output written once; the device time by
     launch of kernels C and F, of kernels A, B, D, E, the decoder-layer step
     (also at JointTransformer's beam step, 60 rows over 324 bf16 keys), the
     two-bias attention and the streamed attention (A, B, D, E, the layer step
     and the two-bias attention each one launch a call); at each cut-over of
     ``ops/fused_attention.py::attention_block`` both blocks forced at the same
     shape (the flat attention at the cross step's geometry and the packed one
     at the MMT geometry with 1, 2, 4, 8 and 16 query rows; the packed block
     resident and streaming at 400 and 401 keys, hd 512 over 8 heads);
  4. ``configs/mmf_m4c.yaml`` at its full widths (random weights from the seed,
     with TEXT_BERT.LOAD_PRETRAINED false and no word embeddings, whose files
     are not in the repository) on synthetic data with 100 regions and 100 OCR
     tokens: ``TrainingMMF.evaluate_metrics`` over the dev split once in each
     decode mode, with the launch counts of the kernels, scores, samples/s of
     the kernel path and of the plain path, the teacher-forced max |score
     diff| between the two paths and their greedy-token agreement, and a
     torch.profiler table of one greedy decode;
  5. the same config trained for one epoch: ``TrainingMMF.start()`` (432 train
     questions, 7 steps of 64, a dev eval, last and best checkpoints), then
     ``get_predictions()`` from ``best_model.pth``, with the per-step losses,
     the launch counts, peak device memory, the train-step time of one batch
     on the kernel path and on the plain path, the gradients of one step on
     both paths (same weights, batch and generator seed) per parameter group,
     and a torch.profiler table of one train step;
  6. ``configs/iterative_mcan.yaml`` at its full widths (512 wide, 8 heads, 3 + 3
     + 3 layers, 1024-wide regions; random weights from the seed) on the same
     synthetic data: ``OpenEndedTask.evaluate_metrics`` over the dev split with
     beam 3 (21 samples x 3 beams = 63 rows a step) on the layer route (3
     decoder-layer launches a step and no plain version called) and on the
     staged route (kernels A, B and C, OPENVIVQA_DECODE_KERNEL_PARTS=
     self,cross,ffn); one batch on the layer, staged and plain routes: token
     agreement, the max difference of the beams' cumulative log-probs, the
     decode time of each; a torch.profiler table of one decode; then
     ``start()`` for one epoch and ``get_predictions()``, the step losses, one
     step's gradients (finite, and non-zero wherever a gradient exists), the
     train-step time on the kernel and plain paths and peak device memory;
  7. ``configs/mmf_iterative_m4c.yaml`` at its full widths (hidden 512, 8
     heads, TextBert 4 + joint encoder 4 + cross-attention decoder 4 layers,
     FFN 2048; random weights, TEXT_BERT.LOAD_PRETRAINED false) on phase 4's
     data: ``TrainingMMF.evaluate_metrics`` over the dev split with
     ``DECODING_MODE: incremental`` (F and C in the encodes; kernels A, E and C
     each step: A = E = steps x 4 layers x dev batches launches, no plain
     version called) and as written (quadratic greedy: F, C and the packed
     attention), each with the kernel vs plain path checks of phase 4; the
     incremental vs the quadratic greedy on one batch;
     ``configs/mmf_iterative_multilevel_m4c.yaml``, one incremental greedy
     batch (E launches counted); one incremental greedy batch (kernel D) each of
     ``configs/mmf_regional_m4c.yaml`` and ``configs/mmf_language_adaptive_m4c.yaml``
     at their widths (random weights; the regional grid stream at the
     generator's 49 x 2048 grids; the language-adaptive model's frozen random
     12-layer, 768-wide vinai/phobert-base-sized backbone); then ``start()`` for
     one epoch of ``mmf_iterative_m4c``, ``get_predictions()``, the train-step
     time on both paths, peak memory and the gradients of the train split
     (finite, non-zero except the key-projection biases);
  8. ``configs/vit_mt5.yaml`` (ViTmT5 under VlspEvjVqaTask) at its full widths
     (ViT-base 12 x 768 at 224 x 224, mT5-small 8 x 512 with 6 heads of 64 and
     250,112 rows, a 3 x 512 decoder; random weights from the seed, no
     checkpoint or tokenizer file) on a synthetic EVJVQA set (80 images, four
     splits, Japanese and Vietnamese questions): the two-bias attention against
     its plain version at the mT5 train and eval batches in both head-bias
     forms with a fully masked sample, beside one scaled_dot_product_attention
     call; the mT5 encoder on the kernel and plain routes; beam-3
     ``evaluate_metrics`` over the dev split (two-bias = 8 x batches, packed =
     12 x batches, layer step = steps x 3 x batches launches, no plain version
     called); plain vs kernel route on one batch (token agreement >= 90 %,
     ``generate()`` times); ``start()`` for one epoch, ``get_predictions()``
     (both test-split files), one step's gradients (none on the frozen ViT and
     mT5, non-zero elsewhere but the key biases), train-step times, peak
     memory and torch.profiler tables;
  9. ``configs/joint_transformer_vlsp.yaml`` (JointTransformer under
     VlspEvjVqaTask) at its full widths (d_model 512, 8 heads, 3 + 3 layers,
     FFN 2048; random weights from the seed) on phase 8's EVJVQA set and its
     VinVL-shaped feature store (75-100 regions x 2048, 49 grids x 1024, their
     boxes): beam-3 ``evaluate_metrics`` over the dev split on the layer route
     (layer step = steps x 3 x batches, packed = 3 x batches, flat none) and on
     the module route, OPENVIVQA_DECODE_KERNEL_PARTS=none (flat = steps x 3 x 2
     x batches, layer step none), no plain version called; one batch on the
     layer, module and plain routes (token agreement >= 90 %, cumulative
     log-prob differences, ``generate()`` times, torch.profiler tables);
     ``start()`` for one epoch, ``get_predictions()``, one step's gradients,
     train-step times and peak memory; the model's Encoder over a 16 x 1536
     stream with a padding bias (3 streamed launches per forward, in eval and
     in training with a backward; within 2^-5 of the plain route relative to
     its largest output);
 10. the ClassificationTask configs on phase 4's data (and a second set with
     2048-wide regions for the last three): ``configs/mcan.yaml`` at its full
     widths (512 wide, 8 heads of 64, 3 self + 3 guided layers, FFN 2048, the
     LSTM 300 -> 512; random weights from the seed): ``evaluate_metrics`` over
     the dev split on the kernel path (packed = 9 x dev batches, nothing else
     launched, no plain version called), eval samples/s on both paths in turns,
     the kernel vs plain path's log-probs over the dev split (max |diff|
     within LOGPROB_TOL, argmax agreement >= 90 %), the packed kernel against
     its plain version at MCAN's three encoder attentions (64 x 100 x 100, 64
     x 100 x Lq, 64 x Lq x Lq on the first dev batch's own projections and
     padding biases) beside one f32 SDPA call, a torch.profiler table of one
     eval batch; one step's gradients on
     both paths on the seeded weights, the gradients of the train split, the
     train-step time on both paths; then ``start()`` for one epoch (the
     config's constant rate, Adam at 1.0: finite losses only) and
     ``get_predictions()``; then each of ``mcan_non_lstm``,
     ``mcan_hierarchical``, ``saaa``, ``saaa_non_lstm``, ``saaa_hierarchical``,
     ``vanilla_transformer``, ``parallel_attention_transformer`` and
     ``hierarchical_co_attention`` at its own widths: dev eval with exact packed
     launches (9, 8, 4 x 8 a batch; none for SAAA, which has no attention core)
     and one train step with a finite loss and finite gradients; every config
     with an attention core (MCAN's three too) also gets the kernel vs plain
     path's log-probs over the dev split (max |diff| within LOGPROB_TOL,
     argmax agreement >= 90 %) and the packed kernel against its plain version
     at every shape one eval forward gives it, on that forward's own inputs
     (64 x 110 x 110 for VanillaTransformer; the co-attention models' 64 x
     100 x Lq, 64 x Lq x 100, 64 x 100 x 100 and 64 x Lq x Lq); phase 10's
     seconds;
 11. the rest of the M4C family at its widths (random weights from the seed,
     TEXT_BERT.LOAD_PRETRAINED false) on one synthetic set of 120 images (100
     regions x 1024, 49 grids x 2048, up to 100 OCR tokens, questions of 10, T =
     5), each config at its own batch sizes: ``configs/m4c.yaml`` (the
     standalone M4C under TrainingMMF: 512 wide, 8 heads of 64, 4 question + 4
     joint layers, FFN 3072) through ``evaluate_metrics`` in both decode modes
     with exact launch counts (quadratic: F 4, C 4 + 4T, packed 4T a batch;
     incremental: F 8, C 8 + 4T, D 4T), phase 4's kernel vs plain checks, the
     incremental against the context-blind quadratic greedy, kernels C, D and
     the packed attention against their plain versions on the inputs one
     forward gives them (``capture_calls``), then one step's gradients on both
     paths, ``start()`` for one epoch (batches of 16) and ``get_predictions()``,
     then the dropout pair against its plain versions on the inputs one train
     step gives it (16 x 165 x 165 under the prefix-LM bias, 16 x 10 x 10);
     ``configs/iterative_m4c.yaml`` (IterativeM4C under OcrOpenEndedTask):
     beam-3 ``evaluate_metrics`` (packed = 4 x T x batches, nothing else), one
     batch on the kernel and plain routes and in the incremental mode against
     the context-blind quadratic one (token agreement, cumulative log-probs of
     the agreeing beams), the packed kernel under the prefix-LM bias and at one
     query row, one epoch and predictions; then
     ``small_mmf_improved_decoding_m4c``, ``experimental_mmf_m4c`` (its OCR
     input at the data's 812 columns, as flax infers it; the config says
     1024), ``mmf_iterative_lorra`` and ``mmf_lorra`` (MmfClassificationTask; no kernel launched, its attentions plain as in the
     JAX package): a dev eval with exact launches, the kernel vs plain scores
     (not for ``mmf_lorra``) and the gradients of the train split; phase 11's
     seconds;
 12. eight more configs at their full widths (random weights from the seed):
     ``unique_transformer``, ``cross_modality_transformer_vlsp``,
     ``visiolinguistic_transformer_vlsp`` and ``extended_mcan_vlsp`` under
     VlspEvjVqaTask on phase 8's EVJVQA set (beam 3 x 20 = 60 rows), each
     with a beam dev eval at exact launches and no plain version called
     (UniqueTransformer, which re-encodes [prefix | answer buffer] at every
     step: packed = 6 x T a batch; the dual-stream generators packed = 12 and
     ExtendedMCAN 9 an encode, the layer step T x 3), one batch's
     ``generate()`` on the kernel and plain paths (token agreement >= 90 %,
     cumulative log-probs of the agreeing samples within LOGPROB_TOL),
     teacher-forced log-probs of those tokens within TF_TOL (the whole
     distributions' and the encoder output's differences printed beside), the packed kernel at every shape
     ``generate()`` gave it (60 x 332 x 332 under the prefix-LM bias; 20 x
     149 x 26 and the like) and the layer step at the beam rows and keys
     (Sk 175), one train step (finite loss, gradients finite and non-zero but
     the gradient-free biases; UniqueTransformer also one step's gradients on
     both paths and train-step times); ``cross_modality_transformer`` and
     ``visiolinguistic_transformer`` (ClassificationTask) on phase 10's
     2048-wide set (packed = 12 a batch, kernel vs plain log-probs, the packed
     kernel at their shapes, one step); ``iterative_saaa`` (TrainingSAAATask)
     on phase 4's data (the layer step over 101 keys, one layer) and
     ``readable_iterative_mcan`` (OpenEndedTask over the OCR datasets) on
     phase 11's (packed at 21 x 200 x 200 and against the question, the layer
     step over ~210 keys), each as the VLSP generators; phase 12's seconds.
 13. ``vit_mbert_classification.yaml`` (ClassificationTask, batches of 10, ViT-base
     on the EVJVQA images at 224, mBERT-uncased at 105,879 x 768 x 12 layers,
     d_model 512) and ``vit_mbert_generation.yaml`` (VlspEvjVqaTask on a
     ViT-shaped store of 197 x 768 per image) at full widths: dev evals with
     exact launches (12 F and 12 C a mBERT forward, 12 packed a ViT forward,
     the layer step steps x 3 a beam batch) and no plain call, kernel vs plain
     (the classifier's log-probs relative to their magnitude, which its sum
     over every token puts in the hundreds, within BF16_ULP, argmax agreement;
     the generator's tokens and teacher-forced log-probs), F, C, the packed
     entry and the layer step at the shapes the forwards give them, one
     step's gradients on both paths, the train split's gradients (none on the
     frozen backbones), one epoch each with exact or non-zero launches; then
     SCST on the generator: ``_switch_to_scst()``, one ``train_scst()`` epoch of
     12 samples x 5 beams (exact launches, finite losses and rewards, every
     parameter with a gradient moved and no frozen one), and a resume from
     ``last_model.pth`` with ``use_rl`` (Adam's step continues, the RL rate);
     the same for one short SCST epoch (two batches) of ``iterative_mcan``
     (OpenEndedTask), ``iterative_m4c`` (OcrOpenEndedTask) and
     ``iterative_saaa`` (TrainingSAAATask); each frozen backbone's output,
     kernel vs plain, within 2^-5 of its magnitude (``check_backbone_chains``).
 14. ``vit_mbert_classification.yaml`` with TEXT_EMBEDDING an ALBERT
     (albert-base-v2: 30,000 x 128 -> 768, one layer shared by 12) and a
     DeBERTa (deberta-v3-base: 128,100 x 768 x 12, 256 buckets) wrapper: dev
     evals with exact launches (F a layer; the two-bias entry with a
     per-sample head bias and C at eps 1e-7 a layer) and no plain call, kernel
     vs plain, the backbone chains, the text kernels at their shapes (ALBERT's
     F, past BERT's weight scale, held stage by stage against float64), one
     step's gradients; ``iterative_mcan.yaml`` with an AdaptiveDecoder (3 + 1 adaptive
     layers, a frozen BERTModel at bert-base widths): the beam-3 dev eval with
     exact decode launches, kernel vs plain, the frozen LM's chain, F, C and the
     layer step at the decode's shapes, one XE epoch and its gradients; the
     plain-torch modules (geometry, memory, adaptive + AoA cores,
     GeometricEncoder, SpatialCirclePosition, TextSemanticSeparate) once on the
     card against the CPU.  Phase 4 also runs ``small_mmf_m4c.yaml`` in both
     decode modes with exact launches and one step's gradients.  Every phase
     prints its seconds.  The configs name checkpoints that no file here holds:
     the script sets OPENVIVQA_ALLOW_RANDOM_BACKBONE=1 and says so.
 15. scale-out (``parallel/``, ``TRAINING.MESH`` and ``TRAINING.REMAT``), last:
     ``configs/mmf_m4c.yaml``'s train step of 64 at full widths, each variant
     built from the seed with the same weights, batch and generator seed as the
     unwrapped task: (b) under TRAINING.REMAT, the dropout forward's keep bits
     of the forward and of the recomputation equal the unwrapped step's, the
     gradients within STEP_GRAD_RTOL (bit-equal expected) and the generator's
     state after the step equal, with both steps' peak device memory; (c)
     under FSDP at world size 1 over NCCL, one greedy dev batch inside
     ``eval_weights`` (kernels on whole weights) against the unwrapped
     model's teacher-forced scores within SCORE_TOL, one step's gradients within
     STEP_GRAD_RTOL, peak memory; (a) under DDP at world size 1 over NCCL, the
     parameters after one Adam step bit-equal to the unwrapped step's, both
     steps' CUDA-event times; the dropout pair launched in each; then the
     process group is destroyed and (d) two spawned gloo ranks on cuda:0 run
     ``small_mmf_m4c.yaml`` (dropout 0) at 32 rows each: their DDP gradients
     against one process's full-batch step of 64 within STEP_GRAD_RTOL,
     equal parameter checksums after the Adam step, and with dropout 0.1
     different kernel seeds and keep bits on the two ranks.
 16. tensor parallelism (``TRAINING.MESH.MODEL_PARALLEL`` 2), last: one model
     rank in this process, then two spawned gloo ranks at (data 1, model 2)
     on the one card, each built from the seed with the same weights:
     ``configs/mmf_m4c.yaml`` (incremental, dropout on) greedy-decodes one dev
     batch inside ``eval_weights`` (tokens and teacher-forced scores bit-equal
     to one rank's; the gather of the whole weights timed apart) and takes one
     train step at generator seed 1234 (loss, and every gradient within
     TP_GRAD_RTOL of one rank's), then three timed Adam steps (equal
     replicated-parameter checksums and generator states on the two ranks);
     ``configs/iterative_mcan.yaml`` beam-searches one dev batch on the layer
     and staged routes (token agreement 100 %); every run's launch counts equal
     one rank's exactly, with kernels C, F, D and the packed attention (eval),
     the dropout pair (train), A, B and the layer step (beam) launched.  Its times are of two
     processes sharing one card over gloo, and say nothing of NCCL's speed.
Phase 2 prints the registers and spill bytes of every instance of block B, of
the dropout backward kernels, of gemm_sm90.cu's kernels, of the persistent
decoder-step kernel and of the streamed attention's two from nvcc's ptxas
report, and checks in the library's SASS (cuobjdump) that no wgmma kernel
writes an operand of a product after its fence, or touches it before the wait
(``wgmma_hazards``; a hazard fails the phase).  Launch counts are reset just before each main-path run (4 and 7: each decode
mode and decode batch; 5, 6, 7, 8, 9 and 10: each eval route, start() and
get_predictions(); 9: each long-stream forward; 10, 11 and 12: each config's dev eval and
each decode mode; 13 and 14: each dev eval, each start() and each SCST epoch) and read just after it, kernel
C's and F's also by row count.  The
nvcc/ptxas log (registers and spills per kernel) is kept beside the library in
build/kernels/.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 64
LN_TOL = 2e-3  # LayerNorm outputs: bf16 intermediates may round one ulp apart under another summation order
# attention outputs: a softmax weight rounded to bf16 may land one ulp (2^-8
# relative) apart, moving the output by up to 2^-8 * weight * |v| with N(0, 1)
# inputs; no LayerNorm follows to shrink it
ATTN_TOL = 1e-2
# dropout-attention gradients, relative to their largest magnitude: each
# bf16-rounded dropped weight or logit gradient may land one ulp apart
GRAD_RTOL = 1e-2
SLOT_TOL = 1e-2  # bf16-stored K/V slots: one bf16 ulp at |k| ~ 1 is 7.8e-3
# a bf16 ring at any magnitude: one bf16 ulp is at most 2^-7 of the value, so
# |kernel - plain| / max(|plain|, 1) stays below it
BF16_ULP = 2.0 ** -7
SCORE_TOL = 1e-2  # teacher-forced scores, kernel path vs plain path
# one train step's gradients, kernel path vs plain path, relative to each
# parameter group's largest gradient: the attentions' bf16 roundings differ by
# an ulp here and there and compound through 16 layers and back
STEP_GRAD_RTOL = 5e-2
# the decoder-layer step against its plain version: each sublayer's output is
# rounded to bf16 on its way into the next product, so float32 sums that differ
# in their last bits may round one bf16 ulp (7.8e-3 at 1) apart there, and the
# difference is carried through two more sublayers
LAYER_TOL = 1e-2
RING_TOL = 1e-4  # float32 ring: the k, v rows are f32 sums in another order
# cumulative log-probs of the beams that hold the same tokens on two decode
# routes: nine chained sublayers on bf16 operands under another summation order
# move a token's log-prob by up to about 1e-2 (see LAYER_TOL), and a beam sums
# max_answer_length of them
LOGPROB_TOL = 5e-2
# a key projection's bias has no gradient: softmax(q . (k + b)) does not depend on b
# (MultiHeadAttention's fc_k, BERT's self.key); nor has the bias of a logit that a
# softmax over tokens or regions reads, a constant shift of every logit
# (the attention-reduce MLPs' fc2, SAAA's glimpse logits x_conv)
GRADIENT_FREE = ("fc_k.bias", "self.key.bias", "attr_reduce.fc2.bias", "x_conv.bias")
DROPOUT_RATE = 0.1
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s at 700 W (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PROFILE_TRIES = 3  # traces of one measurement, where torch.profiler saw no device event

SOURCES = {
    "fused_ffn_step": ("ffn.cu", "openvivqa_tpu/ops/decode_step.py:675"),
    "fused_encoder_self_attention": ("encoder_layer.cu", "openvivqa_tpu/ops/encoder_layer.py:147"),
    "fused_attention_packed": ("fused_attention.cu", "openvivqa_tpu/ops/fused_attention.py:215"),
    "fused_bert_self_step": ("decoder_layer_step.cu", "openvivqa_tpu/ops/decode_step.py:892"),
    "fused_attention_packed_dropout": (
        "fused_attention.cu", "openvivqa_tpu/ops/fused_attention.py:1012"),
    "fused_attention_packed_dropout_backward": (
        "fused_attention_dropout.cu", "openvivqa_tpu/ops/fused_attention.py:1057"),
    "fused_self_attention_step": (
        "decoder_layer_step.cu", "openvivqa_tpu/ops/decode_step.py:230"),
    "fused_cross_attention_step": (
        "decoder_layer_step.cu", "openvivqa_tpu/ops/decode_step.py:559"),
    "fused_decoder_layer_step": (
        "decoder_layer_step.cu", "openvivqa_tpu/ops/decode_step.py:418"),
    "fused_cross_attention_streamed": (
        "decoder_layer_step.cu", "openvivqa_tpu/ops/decode_step.py:1146"),
    "fused_attention_packed_2bias": (
        "fused_attention.cu", "openvivqa_tpu/ops/fused_attention.py:661"),
    "fused_attention_packed_streamed": (
        "fused_attention_streamed.cu", "openvivqa_tpu/ops/fused_attention.py:483"),
    "fused_attention": ("fused_attention_flat.cu", "openvivqa_tpu/ops/fused_attention.py:1239"),
}
STEP_PLAIN = ("fused_self_attention_step_plain", "fused_cross_attention_step_plain",
              "fused_decoder_layer_step_plain", "fused_ffn_step_plain",
              "fused_cross_attention_streamed_plain")
ATTENTION_PLAIN = ("fused_attention_packed_plain", "fused_attention_packed_2bias_plain",
                   "fused_attention_packed_streamed_plain", "fused_attention_plain")


def log(*parts) -> None:
    print(*parts, flush=True)


# the kernels whose registers and spills phase 2 prints from nvcc's ptxas report
PTXAS_KERNELS = ("packed_block_kernel", "dropout_dq_kernel", "dropout_dkdv_kernel",
                 "gemm_bias_sm90_kernel", "gemm_partial_sm90_kernel", "gemm_ln_sm90_kernel",
                 "rows_reduce_bias_kernel", "cast_bf16_kernel", "decoder_step_kernel",
                 "streamed_attention_kernel", "stream_cast_kernel")


def template_args(kernel: str, mangled: str):
    """The template arguments of `kernel` in a mangled name ("" for a plain
    kernel, None when the name is another kernel's): integers and bools as
    numbers, float as f32, __nv_bfloat16 as bf16."""
    match = re.search(kernel + r"(?:I((?:L[ib]\d+E|13__nv_bfloat16|S\d*_|f)+)E|E)", mangled)
    if match is None:
        return None
    args = match.group(1) or ""
    names = re.findall(r"L[ib](\d+)E|(13__nv_bfloat16|S\d*_)|(f)", args)
    return ",".join(number or ("bf16" if bf else "f32") for number, bf, f32 in names)


def ptxas_report(report: Path) -> None:
    """Registers and spill bytes (stores / loads) of every template instance of
    PTXAS_KERNELS, from the -Xptxas -v output kept beside the library; and any
    line where ptxas says it ignored a setmaxnreg."""
    text = report.read_text()
    entry = re.compile(r"Compiling entry function '(\S+)' for \S+\n"
                       r"ptxas info\s*: Function properties for \S+\n"
                       r"\s*\d+ bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n"
                       r"ptxas info\s*: Used (\d+) registers")
    found = {}
    for name, stores, loads, registers in entry.findall(text):
        for kernel in PTXAS_KERNELS:
            args = template_args(kernel, name)
            if args is not None:
                found.setdefault(kernel, []).append(f"<{args}> {registers}/{stores}/{loads}")
    for kernel in PTXAS_KERNELS:
        log(f"  ptxas {kernel} <template args> registers/spill stores/spill loads: "
            + "; ".join(sorted(found.get(kernel, ["not in the report"]))))
    for line in text.splitlines():
        if "setmaxnreg" in line:
            log(f"  ptxas: {line.strip()}")


_SASS = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Za-z0-9_.]*)\s*([^;]*);")
_NO_DEST = ("ST", "RED", "SYNCS", "UTMA", "UBLKCP", "WARPGROUP", "BAR", "BRA")


def _registers(operand: str, width: int = 1) -> set:
    """The general registers an operand names, `width` from each (a 64- or
    128-bit operand), none from an address in brackets."""
    found = set()
    for reg in re.findall(r"\bR(\d+)\b", re.sub(r"\[[^\]]*\]", "", operand)):
        found.update(range(int(reg), int(reg) + width))
    return found


def wgmma_hazards(sass: str) -> dict:
    """Per function of a `cuobjdump -sass` listing that issues HGMMA (wgmma), the
    instructions that break the register contract of wgmma.mma_async: a write to
    an A fragment or accumulator register of an HGMMA after the WARPGROUP.ARRIVE
    (wgmma.fence) before it, or a read or write of them between the HGMMA and the
    WARPGROUP.DEPBAR that waits for every product (wgmma.wait_group 0).  A linear
    walk of each function's listing; the hazard list is empty where ptxas kept
    the contract."""
    hazards, name, lines = {}, None, []

    def walk(lines):
        found, armed, written = [], {}, set()  # armed: register in flight -> "a" or "acc"
        for op, args in lines:
            operands = [a.strip() for a in args.split(",")]
            width = 4 if ".128" in op or ".X4" in op.upper() else (
                2 if ".64" in op or "WIDE" in op or ".X2" in op.upper() else 1)
            if op.startswith("WARPGROUP.ARRIVE"):
                written = set()
                continue
            if op.startswith("WARPGROUP.DEPBAR"):
                if operands[-1] in ("0x0", "0"):
                    armed = {}
                continue
            if op.startswith("HGMMA"):
                n = int(re.search(r"64x(\d+)x", op).group(1))
                acc = set(range(int(operands[0][1:]), int(operands[0][1:]) + n // 2))
                a_regs = set()
                if re.fullmatch(r"R\d+", operands[1]):
                    a_regs = set(range(int(operands[1][1:]), int(operands[1][1:]) + 4))
                for reg in sorted((acc | a_regs) & written):
                    found.append(f"R{reg} written after the fence, read by {op} {args.strip()}")
                armed.update({reg: "a" for reg in a_regs})
                armed.update({reg: "acc" for reg in acc})
                continue
            dest = set()
            if re.fullmatch(r"R\d+(\.reuse)?", operands[0]) and not op.startswith(_NO_DEST):
                dest = _registers(operands[0], width)
                sources = set().union(*(_registers(o) for o in operands[1:]))
            else:
                sources = set().union(*(_registers(o, width) for o in operands))
            written |= dest
            for reg in sorted(dest & armed.keys()):
                found.append(f"{op} {args.strip()} writes R{reg}, an operand of an HGMMA in flight")
            for reg in sorted(sources & {r for r, what in armed.items() if what == "acc"}):
                found.append(f"{op} {args.strip()} reads R{reg}, an accumulator of an HGMMA in flight")
        return found

    for line in sass.splitlines():
        if "Function :" in line:
            if name and any(op.startswith("HGMMA") for op, _ in lines):
                hazards[name] = walk(lines)
            name, lines = line.split("Function :")[1].strip(), []
            continue
        match = _SASS.search(line)
        if match and name:
            lines.append((match.group(1), match.group(2)))
    if name and any(op.startswith("HGMMA") for op, _ in lines):
        hazards[name] = walk(lines)
    return hazards


def sass_report(library: Path) -> list:
    """wgmma_hazards over the library's SASS (cuobjdump), per HGMMA kernel; the
    phase's failures: a kernel that breaks the contract, or no HGMMA kernel."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    hazards = wgmma_hazards(sass)
    for name, found in sorted(hazards.items()):
        demangled = re.sub(r"_GLOBAL__N__\w+?_", "", name)
        log(f"  SASS wgmma operands {demangled[:90]}: {len(found)} hazard(s)"
            + "".join(f"\n    {h}" for h in found[:8]))
    if not hazards:
        return ["SASS: no HGMMA kernel in the library"]
    return [f"SASS: {name} touches a wgmma operand while the product runs"
            for name, found in sorted(hazards.items()) if found]


def median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_by_kernel(fn, reps: int = 20) -> dict:
    """torch.profiler over `reps` calls of `fn` (after one warm-up call): the
    device activity (kernels, memsets) of one call by kernel name, as
    [microseconds, launches].  The launches are the events seen over `reps`;
    the profiler now and then loses one (it never adds one), so a kernel's time
    a call is its mean time a launch times its launches a call rounded to a
    whole number.  Now and then it loses every event of a trace: such a trace
    is taken again, up to `PROFILE_TRIES` times in all, and an empty result
    means that every one of them was empty.  A kernel's name is the first
    identifier followed by its template or argument list."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(PROFILE_TRIES):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                match = re.search(r"(\w+)\s*[<(]",
                                  event.name.replace("(anonymous namespace)", ""))
                name = match.group(1) if match else event.name
                entry = by_name.setdefault(name, [0.0, 0])
                entry[0] += event.time_range.elapsed_us()
                entry[1] += 1
        if by_name:
            break
    return {name: [us / n * max(1, round(n / reps)), n / reps] for name, (us, n) in by_name.items()}


def device_ms(fn, reps: int = 20):
    """(ms, timer): the device time of one call of `fn`.  torch.profiler over
    `reps` calls, the sum of the device activity (kernels, memsets) divided by
    `reps` ("profiler"); where the profiler shows no device time, CUDA events
    around 100 back-to-back calls ("events x100")."""
    import torch

    total_us = sum(us for us, _ in device_by_kernel(fn, reps).values())
    if total_us > 0:
        return total_us / 1e3, "profiler"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(100):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 100, "events x100"


def tensor_bytes(*items) -> int:
    """Bytes of every tensor in `items` (nested in tuples, lists and dicts)."""
    import torch

    total = 0
    for item in items:
        if isinstance(item, torch.Tensor):
            total += item.numel() * item.element_size()
        elif isinstance(item, dict):
            total += tensor_bytes(*item.values())
        elif isinstance(item, (tuple, list)):
            total += tensor_bytes(*item)
    return total


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take."""
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def plain_dropout_attention(*args):
    """The dropout attention's autograd function with both directions in their
    plain versions, on whatever device the tensors lie."""
    from openvivqa_tpu_torch.ops import fused_attention

    return fused_attention.PackedDropoutAttention.apply(*args, False)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions, for the
    comparison runs of this script only."""
    from openvivqa_tpu_torch.ops import decode_step, encoder_layer, fused_attention

    swaps = [
        (decode_step, "fused_ffn_step", decode_step.fused_ffn_step_plain),
        (decode_step, "fused_bert_self_step", decode_step.fused_bert_self_step_plain),
        (decode_step, "fused_self_attention_step", decode_step.fused_self_attention_step_plain),
        (decode_step, "fused_cross_attention_step", decode_step.fused_cross_attention_step_plain),
        (decode_step, "fused_decoder_layer_step", decode_step.fused_decoder_layer_step_plain),
        (decode_step, "fused_cross_attention_streamed",
         decode_step.fused_cross_attention_streamed_plain),
        (encoder_layer, "fused_encoder_self_attention",
         encoder_layer.fused_encoder_self_attention_plain),
        (fused_attention, "fused_attention_packed", fused_attention.fused_attention_packed_plain),
        (fused_attention, "fused_attention_packed_dropout", plain_dropout_attention),
        (fused_attention, "fused_attention_packed_2bias",
         fused_attention.fused_attention_packed_2bias_plain),
        (fused_attention, "fused_attention_packed_streamed",
         fused_attention.fused_attention_packed_streamed_plain),
        (fused_attention, "fused_attention", fused_attention.fused_attention_plain),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, original in saved:
            setattr(module, name, original)


@contextlib.contextmanager
def decode_parts(parts: str):
    """OPENVIVQA_DECODE_KERNEL_PARTS for the calls inside."""
    saved = os.environ.get("OPENVIVQA_DECODE_KERNEL_PARTS")
    os.environ["OPENVIVQA_DECODE_KERNEL_PARTS"] = parts
    try:
        yield
    finally:
        if saved is None:
            del os.environ["OPENVIVQA_DECODE_KERNEL_PARTS"]
        else:
            os.environ["OPENVIVQA_DECODE_KERNEL_PARTS"] = saved


@contextlib.contextmanager
def count_plain_calls(calls: dict):
    """Count the calls of the decode-step kernels' and the attention kernels'
    plain versions."""
    from openvivqa_tpu_torch.ops import decode_step, fused_attention

    saved = {(module, name): getattr(module, name)
             for module, names in ((decode_step, STEP_PLAIN), (fused_attention, ATTENTION_PLAIN))
             for name in names}

    def counting(key):
        def call(*args, **kwargs):
            calls[key[1]] = calls.get(key[1], 0) + 1
            return saved[key](*args, **kwargs)
        return call

    for module, name in saved:
        setattr(module, name, counting((module, name)))
    try:
        yield
    finally:
        for (module, name), original in saved.items():
            setattr(module, name, original)


# kernel C's and F's launches by row count at the last counts_now()
LAST_BY_ROWS = {}


def counts_now() -> dict:
    """The launch counts of the run since the last reset, and (kept for
    rows_text) kernel C's and F's launches by row count."""
    from openvivqa_tpu_torch.ops import _cuda

    LAST_BY_ROWS.clear()
    LAST_BY_ROWS.update(_cuda.launch_counts_by_rows())
    return _cuda.launch_counts()


def rows_text() -> str:
    """Kernel C's and F's launches of the last counts_now() by row count (their
    totals are in the counts beside it)."""
    parts = [f"{name} {json.dumps(by_rows)}" for name, by_rows in LAST_BY_ROWS.items() if by_rows]
    return "; by rows: " + ", ".join(parts) if parts else ""


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def make_recorder(results, failures):
    """record(name, what, err, tol, kernel, plain, flops, nbytes, library): log
    one case of a kernel against its plain version, with the call times
    (CUDA-event medians) of `kernel`, `plain` and `library` (callables; one
    library call or None) and the device times of `kernel` and `library`;
    `results` keeps, per kernel, the first case's times and bound (the
    kernel's main shape) and the largest error over all cases, for the JSON
    line.  `tol` None: the caller holds the case stage by stage
    (``encoder_float64_stages``) and adds its failures itself."""

    def record(name, what, err, tol, kernel, plain, flops, nbytes, library=None):
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        dev_ms, timer = device_ms(kernel)
        library_ms = library_dev_ms = None
        lib = ""
        if library is not None:
            library_ms, library_dev_ms = median_ms(library), device_ms(library)[0]
            lib = f", one library call {library_ms:.4f} ms (device {library_dev_ms:.4f} ms)"
        bound_ms, bound_by = bound(flops, nbytes)
        held = "held by stage" if tol is None else f"tol {tol:.0e}"
        log(f"  {name} [{what}]: max|kernel-plain| {err:.3e} ({held}), "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms by {timer}, host share "
            f"{ms - dev_ms:.4f} ms), plain {plain_ms:.4f} ms{lib}; bound {bound_ms:.4f} ms "
            f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), "
            f"kernel at {100 * bound_ms / ms:.1f} % of it ({100 * bound_ms / dev_ms:.1f} % "
            "by device time)")
        if tol is not None and not err <= tol:
            failures.append(f"{name} [{what}]: max err {err} > {tol}")
        entry = results.setdefault(name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms, "device_timer": timer,
        })
        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    return record


def launch_split(fn) -> str:
    """One call's device time by launch (kernel name) and the launches of each,
    for the entries whose calls make several or should make one."""
    split = device_by_kernel(fn)
    return "device ms by launch: " + ", ".join(
        f"{name} {us / 1e3:.4f} (x{n:g})" for name, (us, n) in split.items())


def cublas_reference(products) -> None:
    """A yardstick, timed here and never called by the port: cuBLAS (torch.matmul)
    on the same two bf16 products alone, without their epilogues."""
    log(f"    cuBLAS bf16, the two products alone: call {median_ms(products):.4f} ms, "
        f"device {device_ms(products)[0]:.4f} ms")


# query rows at which each single-query cut-over is timed from both sides
CUT_OVER_ROWS = (1, 2, 4, 8, 16)


def compare_blocks(label, run, blocks, want, chosen, failures):
    """Both sides of a cut-over at one shape: `run(block)` forced to each of
    `blocks`, its call and device time, each output within ATTN_TOL of the
    plain version's `want`; `chosen` is what attention_block picks there."""
    parts = []
    for block in blocks:
        fn = lambda b=block: run(b)  # noqa: E731
        err = max_err(fn(), want)
        if not err <= ATTN_TOL:
            failures.append(f"{label} on block {block}: max err {err} > {ATTN_TOL}")
        parts.append(f"{block} call {median_ms(fn):.4f} ms, device {device_ms(fn)[0]:.4f} ms "
                     f"(max|kernel-plain| {err:.1e})")
    log(f"  cut-over [{label}]: " + "; ".join(parts) + f"; attention_block picks {chosen}")


def check_kernels(task, shapes, seed, failures, generative, iterative, joint_task):
    """Phase 3: every kernel of the paths against its plain version;
    `generative` is the IterativeMCAN task, whose decoder gives the step
    kernels their weights and shapes; `iterative` the MMF_IterativeM4C task,
    whose decoder gives kernel E its weights and shapes; `joint_task` the
    JointTransformer task, whose dev batch gives the flat attention its
    shapes."""
    import torch

    from openvivqa_tpu_torch.ops import decode_step, encoder_layer, fused_attention
    from openvivqa_tpu_torch.models.modules.bert import LN_EPS
    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def lengths_bias(bs, n, zero_first: bool):
        lengths = torch.randint(1, n + 1, (bs,), generator=gen, device=dev)
        if zero_first:
            lengths[0] = 0  # a sample with every key masked
        pos = torch.arange(n, device=dev)[None]
        return torch.where(pos < lengths[:, None], 0.0, MASK_VALUE).float().contiguous()

    model = task.model
    bf16 = torch.bfloat16
    mmt_w = model.mmt.encoder.layer[0].kernel_weights(bf16)
    text_w = model.text_bert.encoder.layer[0].kernel_weights(bf16)
    heads = model.num_heads
    hd = model.hidden_size
    scale = 1.0 / float(hd // heads) ** 0.5
    c_len, t_len, q_len = shapes["ctx"], shapes["dec"], shapes["question"]
    joint = c_len + t_len
    results = {}
    record = make_recorder(results, failures)

    # kernel C: the MMT context-encode rows, the decode-step rows, the TextBert rows;
    # each with its device time by launch and cuBLAS on the same two products
    f = mmt_w["ffn"]
    d_ff = f["w1"].shape[1]
    for what, rows, w in ((f"encode rows {BATCH}x{c_len}", BATCH * c_len, f),
                          (f"decode rows {BATCH}", BATCH, f),
                          (f"TextBert rows {BATCH}x{q_len}", BATCH * q_len, text_w["ffn"])):
        x = randn(rows, hd)
        args = (x, w["w1"], w["b1"], w["w2"], w["b2"], w["ln_scale"], w["ln_bias"], LN_EPS)
        out = decode_step.fused_ffn_step(*args)
        err = max_err(out, decode_step.fused_ffn_step_plain(*args))
        record("fused_ffn_step", what, err, LN_TOL,
               lambda: decode_step.fused_ffn_step(*args),
               lambda: decode_step.fused_ffn_step_plain(*args),
               4.0 * rows * hd * d_ff, tensor_bytes(args[:7], out))
        plans = decode_step.ffn_plans(rows, hd, d_ff)
        log(f"    plans {plans[0]}, {plans[1]}; "
            + launch_split(lambda: decode_step.fused_ffn_step(*args)))
        hidden = randn(rows, d_ff, dtype=bf16)
        cublas_reference(lambda: (x.to(bf16) @ w["w1"], hidden @ w["w2"]))

    # kernel F: the MMT context encode, then the TextBert question encode
    for what, w, s in ((f"MMT context {BATCH}x{c_len}", mmt_w, c_len),
                       (f"TextBert {BATCH}x{q_len}", text_w, q_len)):
        x = randn(BATCH, s, hd)
        kb = lengths_bias(BATCH, s, zero_first=True)
        args = (x, w["attention"], kb, scale, heads, LN_EPS)
        out = encoder_layer.fused_encoder_self_attention(*args)
        err = max_err(out, encoder_layer.fused_encoder_self_attention_plain(*args))
        rows = BATCH * s
        record("fused_encoder_self_attention", what, err, LN_TOL,
               lambda: encoder_layer.fused_encoder_self_attention(*args),
               lambda: encoder_layer.fused_encoder_self_attention_plain(*args),
               2.0 * rows * hd * 4 * hd + 4.0 * BATCH * s * s * hd, tensor_bytes(args[:3], out))
        plans = encoder_layer.encoder_attention_plans(rows, hd)
        log(f"    plans {plans[0]}, {plans[1]}, block B "
            f"{fused_attention.attention_block('encoder', s, s, hd // heads, hd // heads)}; "
            + launch_split(lambda: encoder_layer.fused_encoder_self_attention(*args)))
        a = w["attention"]
        context = randn(rows, hd, dtype=bf16)
        cublas_reference(lambda: (x.view(rows, hd).to(bf16) @ a["wqkv"], context @ a["wo"]))

    # packed: the MMT joint encode under its per-sample prefix-LM bias, then a
    # batch-shared bias
    q, k, v = randn(BATCH, joint, hd), randn(BATCH, joint, hd), randn(BATCH, joint, hd)
    full = lengths_bias(BATCH, joint, zero_first=False)[:, None, None, :].expand(
        BATCH, 1, joint, joint).clone()
    full[:, :, -t_len:, -t_len:] = torch.triu(
        torch.full((t_len, t_len), MASK_VALUE, device=dev), 1)
    shared = full[:1].contiguous()
    with torch.no_grad():
        for what, bias in ((f"joint {BATCH}x{joint} per-sample bias", full),
                           (f"joint {BATCH}x{joint} shared bias", shared)):
            args = (q, k, v, bias, scale, heads)
            out = fused_attention.fused_attention_packed(*args)
            err = max_err(out, fused_attention.fused_attention_packed_plain(*args))
            record("fused_attention_packed", what, err, ATTN_TOL,
                   lambda: fused_attention.fused_attention_packed(*args),
                   lambda: fused_attention.fused_attention_packed_plain(*args),
                   4.0 * BATCH * joint * joint * hd, tensor_bytes(q, k, v, bias, out),
                   sdpa_call(q, k, v, bias, n_heads=heads, sc=scale))
        # both sides of the single-query cut-over at the MMT geometry (Sq query rows
        # over the joint keys under a per-sample bias)
        for sq in CUT_OVER_ROWS:
            rows_q, rows_bias = q[:, :sq].contiguous(), full[:, :, :sq].contiguous()
            args = (rows_q, k, v, rows_bias, scale, heads)
            compare_blocks(
                f"packed {BATCH} x {sq} x {joint}, {heads} heads of {hd // heads}",
                lambda block, a=args: fused_attention._packed_kernel(*a, block=block),
                ("single", "resident"),
                fused_attention.fused_attention_packed_plain(*args),
                fused_attention.attention_block("packed", sq, joint, hd // heads, hd // heads),
                failures)

    # the dropout attention, forward and backward, at the training shapes: MMF_M4C's
    # MMT (joint sequence, per-sample bias) and TextBert (key-only bias), 8 heads of
    # 96; MMF_IterativeM4C's joint encoder and its decoder's cross-attention (5
    # queries), 8 heads of 64 (key-only biases)
    seed_t = torch.tensor([seed * 7919 + 1], dtype=torch.int64, device=dev)
    question_bias = lengths_bias(BATCH, q_len, zero_first=False)[:, None, None, :].contiguous()
    qs, ks, vs = randn(BATCH, q_len, hd), randn(BATCH, q_len, hd), randn(BATCH, q_len, hd)
    it_hd, it_heads = iterative.model.hidden_size, iterative.model.num_heads
    it_keys = lengths_bias(BATCH, c_len, zero_first=False)[:, None, None, :].contiguous()
    it_q, it_k, it_v = (randn(BATCH, c_len, it_hd) for _ in range(3))
    it_dec = randn(BATCH, t_len, it_hd)
    dropout_cases = (
        (f"MMT train {BATCH}x{joint} per-sample bias", (q, k, v, full), heads),
        (f"TextBert train {BATCH}x{q_len} key-only bias", (qs, ks, vs, question_bias), heads),
        (f"Iterative M4C encoder train {BATCH}x{c_len}, {it_heads} heads of "
         f"{it_hd // it_heads}, key-only bias", (it_q, it_k, it_v, it_keys), it_heads),
        (f"Iterative M4C decoder cross-attention train {BATCH}x{t_len}x{c_len}, {it_heads} "
         f"heads of {it_hd // it_heads}, key-only bias", (it_dec, it_k, it_v, it_keys),
         it_heads),
    )
    for what, (q_, k_, v_, bias), n_heads in dropout_cases:
        what = f"{what}, rate {DROPOUT_RATE}"
        sc = 1.0 / float(q_.shape[2] // n_heads) ** 0.5
        stats, bits = check_dropout_forward(
            what, (q_, k_, v_, bias, seed_t, sc, n_heads, DROPOUT_RATE), record, failures)
        check_dropout_backward(
            what, (q_, k_, v_, bias, stats, bits, randn(*q_.shape), sc, n_heads, DROPOUT_RATE),
            seed_t, record, failures)

    # kernel D: every decode step of one sequence, kernel and plain on their own
    # slot caches; then the time of one step
    w = mmt_w["attention"]
    ctx = (randn(BATCH, c_len, hd, dtype=bf16), randn(BATCH, c_len, hd, dtype=bf16))
    cb = lengths_bias(BATCH, c_len, zero_first=False)
    slots = {name: [torch.zeros(BATCH, t_len, hd, dtype=bf16, device=dev) for _ in range(2)]
             for name in ("kernel", "plain")}
    y_err = slot_err = 0.0
    for step in range(t_len + 1):  # one step past the last slot
        x = randn(BATCH, hd)
        yk, _, _ = decode_step.fused_bert_self_step(
            x, w, ctx, *slots["kernel"], step, cb, scale, heads, LN_EPS)
        yp, _, _ = decode_step.fused_bert_self_step_plain(
            x, w, ctx, *slots["plain"], step, cb, scale, heads, LN_EPS)
        y_err = max(y_err, max_err(yk, yp))
    for a, b in zip(slots["kernel"], slots["plain"]):
        slot_err = max(slot_err, max_err(a, b))
    log(f"  fused_bert_self_step [slots after {t_len + 1} steps]: max|kernel-plain| "
        f"{slot_err:.3e} (tol {SLOT_TOL:.0e})")
    if not slot_err <= SLOT_TOL:
        failures.append(f"fused_bert_self_step slots: max err {slot_err} > {SLOT_TOL}")
    step_args = (x, w, ctx, *slots["kernel"], t_len - 1, cb, scale, heads, LN_EPS)
    keys = c_len + t_len
    record("fused_bert_self_step", f"step {BATCH} x ctx {c_len} + {t_len} slots, "
           f"{heads} heads of {hd // heads} (library: none)", y_err, LN_TOL,
           lambda: decode_step.fused_bert_self_step(*step_args),
           lambda: decode_step.fused_bert_self_step_plain(*step_args),
           2.0 * BATCH * hd * 4 * hd + 4.0 * BATCH * keys * hd,
           tensor_bytes(x, w, ctx, slots["kernel"], cb, yk) + 2 * BATCH * hd * 2)
    by_launch(failures, (("fused_bert_self_step",
                          lambda: decode_step.fused_bert_self_step(*step_args)),))
    check_step_kernels(generative, gen, record, failures)
    check_layer_step_at(joint_task, gen, record, failures)
    check_streamed_cross(iterative, gen, record, failures)
    check_flat_and_streamed(joint_task, gen, record, failures)
    return results


def check_dropout_forward(what, args, record, failures):
    """The dropout forward kernel on args (q, k, v, bias, seed, scale, heads,
    rate) against its plain version within ATTN_TOL, its keep bits equal to
    ``dropout_mask_bits``, bit for bit (the mask the backward reads); returns
    the (stats, bits) it hands the backward."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention

    kernel = fused_attention._dropout_forward_kernel
    plain = fused_attention.fused_attention_packed_dropout_plain
    q, k, v, bias, seed, scale, heads, rate = args
    bs, sq, sk, hd = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
    with torch.no_grad():
        out, stats, bits = kernel(*args)
        if not torch.equal(bits, fused_attention.dropout_mask_bits(seed, bs, heads, sq, sk, rate)):
            failures.append(f"dropout forward [{what}]: keep bits differ from dropout_mask_bits")
        record("fused_attention_packed_dropout", what, max_err(out, plain(*args)), ATTN_TOL,
               lambda: kernel(*args), lambda: plain(*args),
               # the function's own traffic: the stats and keep bits the forward
               # hands the backward are this design's, not the function's
               4.0 * bs * sq * sk * hd, tensor_bytes(q, k, v, bias, seed, out),
               sdpa_call(q, k, v, bias, n_heads=heads, sc=scale, dropout_p=rate))
    return stats, bits


def check_dropout_backward(what, args, seed, record, failures):
    """The dropout backward kernel on args (q, k, v, bias, stats, bits, g,
    scale, heads, rate) against its plain version, which regenerates the mask
    from the forward's `seed`: max|kernel - plain| over dq, dk and dv within
    GRAD_RTOL of the largest plain gradient; then its device time by kernel
    beside one SDPA forward + backward."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention

    kernel = fused_attention._dropout_backward_kernel
    plain = fused_attention.fused_attention_packed_dropout_backward_plain
    q, k, v, bias, stats, bits, g, scale, heads, rate = args
    bs, sq, sk, hd = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
    plain_args = (q, k, v, bias, seed, g, scale, heads, rate)
    if not torch.equal(bits, fused_attention.dropout_mask_bits(seed, bs, heads, sq, sk, rate)):
        failures.append(f"dropout backward [{what}]: keep bits differ from dropout_mask_bits")
    grads, want = kernel(*args), plain(*plain_args)
    errs = [max_err(a, b) for a, b in zip(grads, want)]
    rel = max(e / float(b.abs().max()) for e, b in zip(errs, want))
    log(f"  fused_attention_packed_dropout_backward [{what}]: max|kernel-plain| / max|plain| "
        f"over dq, dk, dv {rel:.3e} (tol {GRAD_RTOL:.0e})")
    if not rel <= GRAD_RTOL:
        failures.append(f"dropout backward [{what}]: relative err {rel} > {GRAD_RTOL}")
    # SDPA's backward builds its graph: outside no_grad
    record("fused_attention_packed_dropout_backward",
           what + " (library: SDPA's backward alone)", max(errs), math.inf,
           lambda: kernel(*args), lambda: plain(*plain_args),
           10.0 * bs * sq * sk * hd, tensor_bytes(q, k, v, g, bias, grads),
           sdpa_backward_call(q, k, v, bias, rate, n_heads=heads, sc=scale))
    split = device_by_kernel(lambda: kernel(*args))
    both = sdpa_call(q, k, v, bias, n_heads=heads, sc=scale, dropout_p=rate, backward=True)
    log("    backward by kernel, device ms: "
        + ", ".join(f"{name} {us / 1e3:.4f}" for name, (us, _) in split.items())
        + f"; one SDPA forward + backward at this shape: call {median_ms(both):.4f} ms, "
        f"device {device_ms(both)[0]:.4f} ms")


def check_streamed_cross(task, gen, record, failures):
    """Kernel E at the Iterative M4C decode step's shapes: the dev batch's rows,
    the joint encoder's keys (question + regions + OCR tokens), the decoder's
    first layer's weights, bf16 encoder K/V, some keys masked, eps 1e-12.  It
    has no one-call library equivalent (q projection, attention, out
    projection, residual and LayerNorm)."""
    import torch

    from openvivqa_tpu_torch.models.modules.bert import LN_EPS
    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.ops import decode_step

    dev = task.device
    model = task.model
    w = model.decoder.layer[0].crossattention.cross_kernel_weights(torch.bfloat16)
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    rows = first["question_tokens"].shape[0]
    sk = sum(first[k].shape[1] for k in ("question_tokens", "region_features", "ocr_boxes"))
    hd, heads = model.hidden_size, model.num_heads
    scale = 1.0 / float(hd // heads) ** 0.5
    x = torch.randn((rows, hd), generator=gen, device=dev)
    kv = tuple(torch.randn((rows, sk, hd), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(2))
    lengths = torch.randint(sk // 2, sk + 1, (rows,), generator=gen, device=dev)
    bias = torch.where(torch.arange(sk, device=dev)[None] < lengths[:, None], 0.0,
                       MASK_VALUE).float().contiguous()
    args = (x, w, kv, bias, scale, heads, LN_EPS)
    y = decode_step.fused_cross_attention_streamed(*args)
    record("fused_cross_attention_streamed",
           f"{rows} rows, hd {hd}, S {sk}, bf16 encoder K/V, eps {LN_EPS:.0e} (library: none)",
           max_err(y, decode_step.fused_cross_attention_streamed_plain(*args)), LN_TOL,
           lambda: decode_step.fused_cross_attention_streamed(*args),
           lambda: decode_step.fused_cross_attention_streamed_plain(*args),
           2.0 * rows * hd * 2 * hd + 4.0 * rows * sk * hd, tensor_bytes(x, w, kv, bias, y))
    by_launch(failures, (("fused_cross_attention_streamed",
                          lambda: decode_step.fused_cross_attention_streamed(*args)),))


def check_step_kernels(task, gen, record, failures):
    """Kernels A, B and the decoder-layer step at the beam path's shapes: the
    dev loader's samples x beams rows, the decoder's widths, T ring slots and
    100 regions + the question length encoder keys.  T + 1 steps (the last
    clamps to the last slot), some tokens padding, the ring reordered between
    steps as beam search does; kernel and plain version start every step from
    one ring.  None of the three has a one-call library equivalent (each fuses
    projections, a cache write, an attention and a LayerNorm)."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.ops import decode_step

    dev = task.device
    bf16 = torch.bfloat16
    layer = task.model.decoder.layers[0]
    core = layer.self_attn.attention
    hd, heads, scale = core.d_model, core.h, core.scale
    self_w, cross_w = layer.self_attn.fused_weights(bf16), layer.enc_attn.fused_weights(bf16)
    f = layer.pwff.fused_weights(bf16)
    d_ff = f["w1"].shape[1]
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    rows = first["question_tokens"].shape[0] * task.evaluating_beam_size
    t_len = task.vocab.max_answer_length
    sk = first["region_features"].shape[1] + first["question_tokens"].shape[1]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def masked(*shape, share):
        return torch.where(torch.rand(shape, generator=gen, device=dev) < share,
                           MASK_VALUE, 0.0).float()

    def ffn(y):
        return decode_step.fused_ffn_step(
            y, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"])

    enc_k, enc_v = randn(rows, sk, hd, dtype=bf16), randn(rows, sk, hd, dtype=bf16)
    enc_bias = masked(rows, sk, share=0.2).contiguous()
    where = f"{rows} rows, hd {hd}, T {t_len}, Sk {sk}"

    def ring(dtype):
        return [torch.zeros(rows, t_len, hd, dtype=dtype, device=dev),
                torch.zeros(rows, t_len, hd, dtype=dtype, device=dev),
                torch.zeros(rows, t_len, device=dev)]

    def ring_err(a, b):
        """Max |a - b| over the ring; relative to max(|b|, 1) for a bf16 ring."""
        scale = (lambda y: y.float().abs().clamp(min=1.0)) if a[0].dtype == bf16 else (lambda y: 1.0)
        return max(float(((x.float() - y.float()).abs() / scale(y)).max()) for x, y in zip(a, b))

    # kernel A, float32 ring (the beam path's) and bf16 ring; the layer step on
    # its own float32 ring, bit for bit against the stage kernels chained
    errs = {"A f32": [0.0, 0.0], "A bf16": [0.0, 0.0], "layer": [0.0, 0.0]}
    layer_equals_stages = True
    rings = {"A f32": ring(torch.float32), "A bf16": ring(bf16), "layer": ring(torch.float32)}
    for step in range(t_len + 1):
        x, sb = randn(rows, hd), masked(rows, share=0.2).contiguous()
        for name in ("A f32", "A bf16"):
            plain_ring = [r.clone() for r in rings[name]]
            yk, *_ = decode_step.fused_self_attention_step(
                x, self_w, sb, step, *rings[name], scale, heads)
            yp, *_ = decode_step.fused_self_attention_step_plain(
                x, self_w, sb, step, *plain_ring, scale, heads)
            errs[name] = [max(errs[name][0], max_err(yk, yp)),
                          max(errs[name][1], ring_err(rings[name], plain_ring))]
        plain_ring = [r.clone() for r in rings["layer"]]
        stage_ring = [r.clone() for r in rings["layer"]]
        args = (enc_k, enc_v, enc_bias, scale, heads)
        yk, *_ = decode_step.fused_decoder_layer_step(
            x, self_w, cross_w, f, sb, step, *rings["layer"], *args)
        yp, *_ = decode_step.fused_decoder_layer_step_plain(
            x, self_w, cross_w, f, sb, step, *plain_ring, *args)
        ys, *_ = decode_step.fused_self_attention_step(
            x, self_w, sb, step, *stage_ring, scale, heads)
        ys = ffn(decode_step.fused_cross_attention_step(ys, cross_w, *args))
        layer_equals_stages &= torch.equal(yk, ys) and all(
            torch.equal(a, b) for a, b in zip(rings["layer"], stage_ring))
        errs["layer"] = [max(errs["layer"][0], max_err(yk, yp)),
                         max(errs["layer"][1], ring_err(rings["layer"], plain_ring))]
        perm = torch.randint(0, rows, (rows,), generator=gen, device=dev)
        rings = {name: [r.index_select(0, perm) for r in value] for name, value in rings.items()}
    for name, tol in (("A f32", RING_TOL), ("A bf16", BF16_ULP), ("layer", RING_TOL)):
        log(f"  ring caches [{name}, after each of {t_len + 1} steps]: max|kernel-plain|"
            f"{' / max(|plain|, 1)' if name == 'A bf16' else ''} {errs[name][1]:.3e} "
            f"(tol {tol:.1e})")
        if not errs[name][1] <= tol:
            failures.append(f"ring caches [{name}]: max err {errs[name][1]} > {tol}")
    if not errs["A bf16"][0] <= LN_TOL:
        failures.append(f"fused_self_attention_step [bf16 ring]: y err {errs['A bf16'][0]}")
    log(f"  fused_decoder_layer_step equals kernels A, B, C chained, bit for bit: "
        f"{layer_equals_stages}")
    if not layer_equals_stages:
        failures.append("fused_decoder_layer_step differs from its stage kernels chained")

    last = t_len - 1
    a_args = (x, self_w, sb, last, *rings["A f32"], scale, heads)
    attn_flops = lambda keys: 4.0 * rows * keys * hd  # noqa: E731
    a_flops = 2.0 * rows * hd * 4 * hd + attn_flops(t_len)
    a_bytes = tensor_bytes(x, self_w, sb, rings["A f32"], yk) + 2 * rows * hd * 4 + rows * 4
    record("fused_self_attention_step", where + ", f32 ring (library: none)", errs["A f32"][0],
           LN_TOL, lambda: decode_step.fused_self_attention_step(*a_args),
           lambda: decode_step.fused_self_attention_step_plain(*a_args),
           a_flops, a_bytes)

    b_args = (x, cross_w, enc_k, enc_v, enc_bias, scale, heads)
    yb = decode_step.fused_cross_attention_step(*b_args)
    b_flops = 2.0 * rows * hd * 2 * hd + attn_flops(sk)
    b_bytes = tensor_bytes(x, cross_w, enc_k, enc_v, enc_bias, yb)
    record("fused_cross_attention_step", where + ", bf16 encoder K/V (library: none)",
           max_err(yb, decode_step.fused_cross_attention_step_plain(*b_args)), LN_TOL,
           lambda: decode_step.fused_cross_attention_step(*b_args),
           lambda: decode_step.fused_cross_attention_step_plain(*b_args),
           b_flops, b_bytes)

    l_args = (x, self_w, cross_w, f, sb, last, *rings["layer"], enc_k, enc_v, enc_bias, scale,
              heads)
    record("fused_decoder_layer_step", where + f", d_ff {d_ff} (library: none)",
           errs["layer"][0], LAYER_TOL,
           lambda: decode_step.fused_decoder_layer_step(*l_args),
           lambda: decode_step.fused_decoder_layer_step_plain(*l_args),
           *layer_step_work(l_args))
    staged_ms = median_ms(lambda: ffn(decode_step.fused_cross_attention_step(
        decode_step.fused_self_attention_step(*a_args)[0], *b_args[1:])))
    log(f"  kernels A, B, C chained from Python at the same shapes: {staged_ms:.4f} ms")
    by_launch(failures, (
        ("fused_self_attention_step", lambda: decode_step.fused_self_attention_step(*a_args)),
        ("fused_cross_attention_step", lambda: decode_step.fused_cross_attention_step(*b_args)),
        ("fused_decoder_layer_step", lambda: decode_step.fused_decoder_layer_step(*l_args))))


def layer_step_work(l_args):
    """(FLOPs, bytes) of one decoder-layer step on these arguments: nine
    products, the two attentions over the ring's T slots and the Sk encoder
    keys; every weight, the ring, the encoder K/V and the biases read once,
    x read and y written once, the ring's slot t written."""
    x, self_w, cross_w, f, sb, _, cache_k, cache_v, cache_bias, enc_k, enc_v, enc_bias = l_args[:12]
    rows, hd = x.shape
    t_len, sk, d_ff = cache_k.shape[1], enc_k.shape[1], f["w1"].shape[1]
    flops = (2.0 * rows * hd * 4 * hd + 4.0 * rows * t_len * hd + 2.0 * rows * hd * 2 * hd
             + 4.0 * rows * sk * hd + 4.0 * rows * hd * d_ff)
    nbytes = (tensor_bytes(x, self_w, cross_w, f, sb, cache_k, cache_v, cache_bias, enc_k, enc_v,
                           enc_bias, x) + 2 * rows * hd * cache_k.element_size() + rows * 4)
    return flops, nbytes


def by_launch(failures, calls) -> None:
    """Each (name, call)'s device time by launch; every one of them must be one
    device launch a call: one kernel, seen at most once a call (a lost profiler
    event shows as less)."""
    for name, fn in calls:
        split = device_by_kernel(fn)
        log(f"    {name}: device ms by launch: " + ", ".join(
            f"{kernel} {us / 1e3:.4f} (x{n:g})" for kernel, (us, n) in split.items()))
        if len(split) != 1 or not 0 < next(iter(split.values()))[1] <= 1:
            failures.append(f"{name}: {sum(n for _, n in split.values()):g} device launches "
                            f"a call over {len(split)} kernels, not 1")


def check_layer_step_at(task, gen, record, failures, label="JointTransformer's step"):
    """The decoder-layer step at a generative task's beam-eval step (phase 3:
    JointTransformer's): the dev loader's samples x beams rows, the encoder
    output's keys (bf16 encoder K/V), the decoder's first layer's weights, a
    float32 ring filled by T steps; the last step against the plain version
    from the same ring.  Beside it, one SDPA call of its cross-attention
    alone, a yardstick (no library call computes the whole step)."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.ops import decode_step

    dev, bf16 = task.device, torch.bfloat16
    layer = task.model.decoder.layers[0]
    core = layer.self_attn.attention
    hd, heads, scale = core.d_model, core.h, core.scale
    self_w, cross_w = layer.self_attn.fused_weights(bf16), layer.enc_attn.fused_weights(bf16)
    f = layer.pwff.fused_weights(bf16)
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    rows = first["question_tokens"].shape[0] * task.evaluating_beam_size
    t_len = task.vocab.max_answer_length
    with torch.no_grad():
        sk = task.model.encode(first)[1].shape[-1]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    enc_k, enc_v = randn(rows, sk, hd, dtype=bf16), randn(rows, sk, hd, dtype=bf16)
    enc_bias = torch.where(torch.rand((rows, sk), generator=gen, device=dev) < 0.2, MASK_VALUE,
                           0.0).float().contiguous()
    ring = [torch.zeros(rows, t_len, hd, device=dev), torch.zeros(rows, t_len, hd, device=dev),
            torch.zeros(rows, t_len, device=dev)]
    sb = torch.zeros(rows, device=dev)
    for step in range(t_len - 1):
        decode_step.fused_decoder_layer_step(randn(rows, hd), self_w, cross_w, f, sb, step, *ring,
                                             enc_k, enc_v, enc_bias, scale, heads)
    l_args = (randn(rows, hd), self_w, cross_w, f, sb, t_len - 1, *ring, enc_k, enc_v, enc_bias,
              scale, heads)
    plain_ring = [r.clone() for r in ring]
    y = decode_step.fused_decoder_layer_step(*l_args)[0]
    want = decode_step.fused_decoder_layer_step_plain(*l_args[:6], *plain_ring, *l_args[9:])[0]
    record("fused_decoder_layer_step",
           f"{label}: {rows} rows, hd {hd}, T {t_len}, Sk {sk}, bf16 encoder "
           f"K/V, d_ff {f['w1'].shape[1]} (library: none)", max_err(y, want), LAYER_TOL,
           lambda: decode_step.fused_decoder_layer_step(*l_args),
           lambda: decode_step.fused_decoder_layer_step_plain(*l_args), *layer_step_work(l_args))
    by_launch(failures, (("fused_decoder_layer_step",
                          lambda: decode_step.fused_decoder_layer_step(*l_args)),))
    q = randn(rows, 1, hd)
    bias = enc_bias[:, None, None, :]
    cross = sdpa_library(q, enc_k.float(), enc_v.float(), bias, scale, heads)
    log(f"    [{label}] one float32 SDPA call of the step's cross-attention alone ({rows} x 1 "
        f"x {sk}): call {median_ms(cross):.4f} ms, device {device_ms(cross)[0]:.4f} ms")


def busy_us(events, device_type) -> float:
    """Length of the union of the intervals of `events` on `device_type`: time
    with at least one kernel running, counting overlapping kernels once."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == device_type)
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(fn, label):
    """torch.profiler over one call of `fn`: kernel time by name and the
    device's busy share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    busy = busy_us(prof.events(), torch.autograd.DeviceType.CUDA)
    log(f"  [{label}] profiler: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
        f"wall ({100 * busy / wall_us:.1f} %, kernel intervals merged)")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


def run_mode(task, mode, failures, expected, exact=None):
    """Phases 4 and 7 for one decode mode: the dev eval must launch every
    kernel in `expected`, the kernels in `exact` that many times, and no
    decode-step plain version."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.ops import _cuda

    n_valid = len(task.dev_dict_dataset)

    def timed_eval():
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = task.evaluate_metrics(task.dev_dict_dataloader)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    # the host loader alone, once: it also warms the page cache for the timed runs
    start = time.perf_counter()
    for _ in task.dev_dict_dataloader:
        pass
    log(f"  [{mode}] host loader alone: {time.perf_counter() - start:.3f} s for {n_valid} samples")

    # one decode first, so the allocator's first growth is not in the timed runs
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    task.greedy_ids(first)
    torch.cuda.synchronize()

    plain_calls = {}
    with count_plain_calls(plain_calls):
        _cuda.reset_launch_counts()
        scores, seconds = timed_eval()
        counts = counts_now()
    log(f"  [{mode}] scores: {json.dumps(scores, default=float)}")
    log(f"  [{mode}] launches: {json.dumps(counts)}; plain calls: {json.dumps(plain_calls)}"
        f"{rows_text()}")
    for name in expected:
        if counts[name] <= 0:
            failures.append(f"[{mode}] {name} was not launched by the main path")
    for name, n in (exact or {}).items():
        if counts[name] != n:
            failures.append(f"[{mode}] {name}: {counts[name]} launches, want {n}")
    if plain_calls:
        failures.append(f"[{mode}] plain versions were called: {plain_calls}")
    if "CIDEr" not in scores:
        failures.append(f"[{mode}] no CIDEr in the scores")

    # in turns: kernel (above), plain, plain, kernel
    with plain_versions():
        plain_seconds = [timed_eval()[1], timed_eval()[1]]
    kernel_seconds = [seconds, timed_eval()[1]]
    for name, runs in (("kernel", kernel_seconds), ("plain", plain_seconds)):
        log(f"  [{mode}] eval loop, {name} path: {n_valid} samples in "
            + ", ".join(f"{t:.3f} s ({n_valid / t:.2f} samples/s)" for t in runs))

    # kernel path vs plain path on the first dev batch
    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    valid = torch.from_numpy(host["sample_valid"]).to(batch["question_tokens"].device)
    model = task.model
    out_k = model.greedy_decode(batch)
    with plain_versions():
        out_p = model.greedy_decode(batch)
        tf_p = model.compute_scores(batch, out_k["prev_inds"])
    tf_k = model.compute_scores(batch, out_k["prev_inds"])
    expected_shape = (BATCH, task.vocab.max_answer_length,
                      len(task.vocab) + batch["ocr_boxes"].shape[1])
    for name, tensor in (("greedy", out_k["scores"]), ("teacher-forced", tf_k)):
        if tuple(tensor.shape) != expected_shape or not bool(torch.isfinite(tensor).all()):
            failures.append(f"[{mode}] {name} scores: shape {tuple(tensor.shape)} "
                            f"(want {expected_shape}) or non-finite values")
    # OCR slots past a sample's OCR tokens score ~MASK_VALUE on both paths,
    # where one float32 ulp is 7.8e-3: compare the unmasked scores
    unmasked = tf_p[valid] > MASK_VALUE / 2
    tf_err = max_err(tf_k[valid][unmasked], tf_p[valid][unmasked])
    ids_k = out_k["scores"].argmax(-1)[valid]
    ids_p = out_p["scores"].argmax(-1)[valid]
    agreement = float((ids_k == ids_p).float().mean())
    log(f"  [{mode}] teacher-forced max|score kernel-plain| {tf_err:.3e} (tol {SCORE_TOL:.0e}); "
        f"greedy token agreement {agreement * 100:.2f}% of {ids_k.numel()} tokens")
    if not tf_err <= SCORE_TOL:
        failures.append(f"[{mode}] teacher-forced score diff {tf_err} > {SCORE_TOL}")
    if agreement < 0.9:
        failures.append(f"[{mode}] greedy token agreement {agreement} < 0.9")

    # the greedy decode alone, one batch on the device, both paths
    decode_ms = median_ms(lambda: model.greedy_decode(batch), reps=5)
    with plain_versions():
        plain_decode_ms = median_ms(lambda: model.greedy_decode(batch), reps=5)
    log(f"  [{mode}] greedy decode of one batch of {BATCH} (CUDA-event median of 5): "
        f"kernel path {decode_ms:.3f} ms = {BATCH / decode_ms * 1e3:.1f} samples/s, "
        f"plain path {plain_decode_ms:.3f} ms = {BATCH / plain_decode_ms * 1e3:.1f} samples/s")
    profile(lambda: model.greedy_decode(batch), mode)
    return counts


def param_group(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("text_bert", "mmt") else parts[0]


MMF_TRAIN_KERNELS = ("fused_attention_packed_dropout", "fused_attention_packed_dropout_backward",
                     "fused_attention_packed", "fused_encoder_self_attention", "fused_ffn_step")


def run_training(task, failures, label="train", check_grads=False):
    """Phases 5 and 7: one epoch of start(), then get_predictions() from
    best_model.pth (run_epoch), then the train step on both paths
    (check_train_step); with `check_grads`, also the gradients of the whole
    train split (check_gradients)."""
    counts = run_epoch(task, failures, label)
    check_train_step(task, failures, label, check_grads)
    return counts


def run_epoch(task, failures, label="train", expected=MMF_TRAIN_KERNELS):
    """One epoch of start(), then get_predictions() from best_model.pth, which
    must launch each kernel in `expected`; returns the launch counts."""
    import torch

    from openvivqa_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    start = time.perf_counter()
    task.start()
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - start
    start = time.perf_counter()
    scores = task.get_predictions()
    torch.cuda.synchronize()
    predict_seconds = time.perf_counter() - start
    counts = counts_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        records = [json.loads(line) for line in handle]
    losses = [loss for r in records if r["phase"] == "train" for loss in r["step_losses"]]
    validation = [r for r in records if r["phase"] == "validation"]
    log(f"  [{label}] start(): {train_seconds:.2f} s, per-step losses {json.dumps(losses)}")
    log(f"  [{label}] dev scores after the epoch: "
        f"{json.dumps({k: v for k, v in validation[-1].items() if k not in ('time',)})}")
    log(f"  [{label}] get_predictions() from best_model.pth: {predict_seconds:.2f} s, "
        f"test scores {json.dumps(scores, default=float)}")
    log(f"  [{label}] launches: {json.dumps(counts)}; peak device memory {peak_gb:.2f} GB"
        f"{rows_text()}")
    n_train = len(task.train_dataset)
    want_steps = -(-n_train // task.train_dataloader.batch_size)
    if len(losses) != want_steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"[{label}] losses {losses}: want {want_steps} finite values")
    for name in expected:
        if counts[name] <= 0:
            failures.append(f"[{label}] {name} was not launched by the main path")
    for name in ("best_model.pth", "last_model.pth", "test_results.json"):
        if not (Path(task.checkpoint_path) / name).is_file():
            failures.append(f"[{label}] {name} was not written")
    if "CIDEr" not in scores or not math.isfinite(scores["CIDEr"]):
        failures.append(f"[{label}] no finite CIDEr from get_predictions()")
    return counts


def check_train_step(task, failures, label, check_grads=False):
    """One train batch: one step's gradients on both paths per parameter
    group, with `check_grads` the gradients of the whole train split, then the
    train step's time on both paths and a profiler table of one step."""
    import torch

    _, batch = next(task.device_batches(task.train_dataloader))

    # one step's gradients on both paths: same weights, batch and generator seed
    def grads(seed):
        task.generator.manual_seed(seed)
        task.optimizer.zero_grad(set_to_none=True)
        loss = task.compute_loss(batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone()
                                      for n, p in task.model.named_parameters()
                                      if p.grad is not None}

    loss_k, grads_k = grads(1234)
    with plain_versions():
        loss_p, grads_p = grads(1234)
    task.optimizer.zero_grad(set_to_none=True)
    groups = {}
    for name, g_k in grads_k.items():
        diff, scale = groups.get(param_group(name), (0.0, 0.0))
        groups[param_group(name)] = (max(diff, max_err(g_k, grads_p[name])),
                                     max(scale, float(grads_p[name].abs().max())))
    rel = {group: diff / scale if scale > 0 else 0.0 for group, (diff, scale) in groups.items()}
    log(f"  [{label}] one step, kernel vs plain path: loss {loss_k:.6f} vs {loss_p:.6f}; "
        "max|grad diff| / max|grad| per parameter group "
        + json.dumps({group: float(f"{value:.3e}") for group, value in rel.items()}))
    worst = max(rel.values())
    if not worst <= STEP_GRAD_RTOL:
        failures.append(f"[{label}] gradient difference {worst} > {STEP_GRAD_RTOL}")
    if check_grads:
        check_gradients(task, failures, label)

    # the train step's time on both paths, in turns (after the gradient checks:
    # these steps move the weights)
    step = lambda: task._train_step(batch)  # noqa: E731
    kernel_ms = [median_ms(step, reps=5)]
    with plain_versions():
        plain_ms = [median_ms(step, reps=5), median_ms(step, reps=5)]
    kernel_ms.append(median_ms(step, reps=5))
    rows = task.train_dataloader.batch_size
    log(f"  [{label}] one train step of {rows} (CUDA-event median of 5, in turns): kernel path "
        f"{kernel_ms[0]:.3f}, {kernel_ms[1]:.3f} ms; plain path {plain_ms[0]:.3f}, "
        f"{plain_ms[1]:.3f} ms")
    profile(step, f"{label} step")


def check_gradients(task, failures, label, no_gradient=()):
    """The gradients of the losses summed over the train split (every
    parameter then has the data it could get a gradient from, an OCR copy
    among the answers included): finite on every trainable parameter and
    non-zero except the key-projection biases; none, or zero, on a frozen
    parameter and on the parameters whose names start with one of
    `no_gradient` (those the model's output does not read)."""
    import torch

    task.optimizer.zero_grad(set_to_none=True)
    for _, batch in task.device_batches(task.train_dataloader):
        task.compute_loss(batch).backward()
    bad, frozen = [], 0
    for name, p in task.model.named_parameters():
        if not p.requires_grad or name.startswith(no_gradient):
            frozen += 1
            if p.grad is not None and bool(p.grad.any()):
                bad.append(name)
        elif (p.grad is None or not bool(torch.isfinite(p.grad).all())
              or not (name.endswith(GRADIENT_FREE) or float(p.grad.abs().max()) > 0.0)):
            bad.append(name)
    n_params = sum(1 for _ in task.model.parameters())
    log(f"  [{label}] gradients over the train split: {n_params - len(bad)} of {n_params} "
        f"parameter tensors as required ({frozen} frozen or unread: no gradient; the rest "
        "finite, non-zero except the gradient-free key biases)")
    if bad:
        failures.append(f"[{label}] missing, non-finite, zero or frozen-but-nonzero gradients: "
                        f"{bad[:8]}")
    task.optimizer.zero_grad(set_to_none=True)




def run_generative(task, failures):
    """Phase 6, eval: beam search over the dev split on the layer and staged
    routes, then one batch on the layer, staged and plain routes."""
    import torch

    from openvivqa_tpu_torch.ops import _cuda
    from openvivqa_tpu_torch.training.decode import generate

    beam = task.evaluating_beam_size
    n_valid = len(task.dev_dict_dataset)
    n_batches = len(task.dev_dict_dataloader)
    steps = task.vocab.max_answer_length
    n_layers = len(task.model.decoder.layers)
    launches = {name: 0 for name in _cuda.WRAPPERS}

    def timed_eval():
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = task.evaluate_metrics(task.dev_dict_dataloader)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    rows = batch["question_tokens"].shape[0] * beam
    generate(task.model, batch, beam)  # the allocator's first growth, outside the timed runs
    torch.cuda.synchronize()

    want = {"layer": {"fused_decoder_layer_step": steps * n_layers * n_batches},
            "staged": {name: steps * n_layers * n_batches for name in (
                "fused_self_attention_step", "fused_cross_attention_step", "fused_ffn_step")}}
    seconds = {}
    for route, parts in (("layer", "layer"), ("staged", "self,cross,ffn")):
        plain_calls = {}
        with decode_parts(parts), count_plain_calls(plain_calls):
            _cuda.reset_launch_counts()
            scores, seconds[route] = timed_eval()
            counts = counts_now()
        for name, n in counts.items():
            launches[name] += n
        log(f"  [beam, {route}] {n_valid} samples in {n_batches} batches of {rows} rows x {steps} "
            f"steps: {seconds[route]:.3f} s ({n_valid / seconds[route]:.2f} samples/s by the host "
            f"clock); scores {json.dumps(scores, default=float)}")
        log(f"  [beam, {route}] launches: {json.dumps(counts)}; plain calls: "
            f"{json.dumps(plain_calls)}{rows_text()}")
        for name, n in want[route].items():
            if counts[name] != n:
                failures.append(f"[beam, {route}] {name}: {counts[name]} launches, want {n}")
        if counts["fused_attention_packed"] <= 0:
            failures.append(f"[beam, {route}] the encoders did not launch the packed attention")
        if plain_calls:
            failures.append(f"[beam, {route}] plain versions were called: {plain_calls}")
        if "CIDEr" not in scores or not math.isfinite(scores["CIDEr"]):
            failures.append(f"[beam, {route}] no finite CIDEr")

    # one batch, all beams, on the three routes
    def decode(parts, plain=False):
        with decode_parts(parts), (plain_versions() if plain else contextlib.nullcontext()):
            return generate(task.model, batch, beam, out_size=beam)

    routes = {"layer": ("layer", False), "staged": ("self,cross,ffn", False),
              "plain": ("layer", True)}
    outs = {route: decode(*args) for route, args in routes.items()}
    valid = torch.from_numpy(host["sample_valid"]).to(batch["question_tokens"].device)
    tokens, logprobs = outs["layer"]
    expected = (valid.shape[0], beam, steps)
    if tuple(tokens.shape) != expected or not bool(torch.isfinite(logprobs).all()):
        failures.append(f"[beam] outputs {tuple(tokens.shape)} (want {expected}) or non-finite")
    for route in ("staged", "plain"):
        # a beam whose candidates lie closer than the routes' rounding may flip
        # and then holds another sequence: the log-probs are compared on the
        # beams whose tokens agree
        same = (outs[route][0] == tokens).all(dim=-1) & valid[:, None]
        agreement = float((outs[route][0][valid] == tokens[valid]).float().mean())
        token_diff = max_err(outs[route][1][same], logprobs[same])
        diff = max_err(outs[route][1][same].sum(-1), logprobs[same].sum(-1))
        log(f"  [beam] {route} vs layer route, one batch, all {beam} beams: token agreement "
            f"{agreement * 100:.2f}% of {tokens[valid].numel()} tokens, {int(same.sum())} of "
            f"{int(valid.sum()) * beam} beams equal; on those, max|log-prob diff| per token "
            f"{token_diff:.3e}, per beam (cumulative) {diff:.3e} (tol {LOGPROB_TOL:.0e})")
        if not diff <= LOGPROB_TOL:
            failures.append(f"[beam] {route} vs layer: log-prob diff {diff} > {LOGPROB_TOL}")
        if agreement < 0.9:
            failures.append(f"[beam] {route} vs layer: token agreement {agreement}")
    times = {route: median_ms(lambda a=args: decode(*a), reps=5) for route, args in routes.items()}
    log(f"  [beam] generate() of one batch of {valid.shape[0]} x beam {beam} (CUDA-event median "
        "of 5): " + ", ".join(f"{route} route {ms:.3f} ms = {valid.shape[0] / ms * 1e3:.1f} "
                              f"samples/s" for route, ms in times.items()))
    profile(lambda: generate(task.model, batch, beam), "beam decode, layer route")
    return launches


def run_generative_training(task, failures):
    """Phase 6, training: one epoch of start(), get_predictions(), then one
    batch's gradients and train-step time."""
    import torch

    from openvivqa_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    start = time.perf_counter()
    task.start()
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - start
    start = time.perf_counter()
    scores = task.get_predictions()
    torch.cuda.synchronize()
    predict_seconds = time.perf_counter() - start
    counts = counts_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        records = [json.loads(line) for line in handle]
    losses = [loss for r in records if r["phase"] == "train" for loss in r["step_losses"]]
    log(f"  [xe] start(): {train_seconds:.2f} s, per-step losses {json.dumps(losses)}")
    log(f"  [xe] get_predictions() from best_model.pth: {predict_seconds:.2f} s, "
        f"test scores {json.dumps(scores, default=float)}")
    log(f"  [xe] launches: {json.dumps(counts)}; peak device memory {peak_gb:.2f} GB{rows_text()}")
    want_steps = -(-len(task.train_dataset) // task.train_dataloader.batch_size)
    if len(losses) != want_steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"[xe] losses {losses}: want {want_steps} finite values")
    for name in ("fused_attention_packed", "fused_decoder_layer_step"):
        if counts[name] <= 0:
            failures.append(f"[xe] {name} was not launched by start() and get_predictions()")
    for name in ("best_model.pth", "last_model.pth", "test_results.json"):
        if not (Path(task.checkpoint_path) / name).is_file():
            failures.append(f"[xe] {name} was not written")
    if "CIDEr" not in scores or not math.isfinite(scores["CIDEr"]):
        failures.append("[xe] no finite CIDEr from get_predictions()")

    _, batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    task.compute_loss(batch).backward()
    bad = [name for name, p in task.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not (name.endswith(GRADIENT_FREE) or float(p.grad.abs().max()) > 0.0)]
    n_params = sum(1 for _ in task.model.parameters())
    log(f"  [xe] one gradient step: {n_params - len(bad)} of {n_params} parameter tensors with "
        f"finite gradients, non-zero except the gradient-free key biases")
    if bad:
        failures.append(f"[xe] missing, non-finite or zero gradients: {bad[:8]}")
    task.optimizer.zero_grad(set_to_none=True)

    step = lambda: task._train_step(batch)  # noqa: E731
    kernel_ms = [median_ms(step, reps=5)]
    with plain_versions():
        plain_ms = [median_ms(step, reps=5), median_ms(step, reps=5)]
    kernel_ms.append(median_ms(step, reps=5))
    log(f"  [xe] one train step of {task.train_dataloader.batch_size} (CUDA-event median of 5, "
        f"in turns): kernel path {kernel_ms[0]:.3f}, {kernel_ms[1]:.3f} ms; plain path "
        f"{plain_ms[0]:.3f}, {plain_ms[1]:.3f} ms")
    profile(step, "IterativeMCAN train step")
    return counts


def one_greedy_batch(task, label, failures, want):
    """One dev batch's greedy decode: finite scores of the right shape,
    `want[name]` launches of each kernel named there and no decode-step plain
    version called; the decode's CUDA-event time."""
    import torch

    from openvivqa_tpu_torch.ops import _cuda

    _, batch = next(task.device_batches(task.dev_dict_dataloader))
    model = task.model
    model.greedy_decode(batch)  # the allocator's first growth, outside the counted run
    torch.cuda.synchronize()
    plain_calls = {}
    with count_plain_calls(plain_calls):
        _cuda.reset_launch_counts()
        scores = model.greedy_decode(batch)["scores"]
        torch.cuda.synchronize()
        counts = counts_now()
    ms = median_ms(lambda: model.greedy_decode(batch), reps=5)
    rows = batch["question_tokens"].shape[0]
    shape = (rows, task.vocab.max_answer_length, len(task.vocab) + batch["ocr_boxes"].shape[1])
    log(f"  [{label}] {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters; greedy "
        f"decode of one batch of {rows}: {ms:.3f} ms (CUDA-event median of 5); launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; plain calls "
        f"{json.dumps(plain_calls)}{rows_text()}")
    if tuple(scores.shape) != shape or not bool(torch.isfinite(scores).all()):
        failures.append(f"[{label}] scores {tuple(scores.shape)} (want {shape}) or non-finite")
    for name, n in want.items():
        if counts[name] != n:
            failures.append(f"[{label}] {name}: {counts[name]} launches, want {n}")
    if plain_calls:
        failures.append(f"[{label}] plain versions were called: {plain_calls}")
    return counts


def compare_decode_modes(quadratic, incremental, failures, label="iterative"):
    """The incremental greedy against the quadratic one on one dev batch
    (the two tasks hold the same weights, drawn from one seed)."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE

    host, batch = next(incremental.device_batches(incremental.dev_dict_dataloader))
    valid = torch.from_numpy(host["sample_valid"]).to(batch["question_tokens"].device)
    out_q = quadratic.model.greedy_decode(batch)["scores"][valid]
    out_i = incremental.model.greedy_decode(batch)["scores"][valid]
    agreement = float((out_q.argmax(-1) == out_i.argmax(-1)).float().mean())
    unmasked = out_q > MASK_VALUE / 2
    diff = max_err(out_q[unmasked], out_i[unmasked])
    log(f"  [{label}] incremental vs quadratic greedy, one batch: token agreement "
        f"{agreement * 100:.2f}% of {out_q.shape[0] * out_q.shape[1]} tokens, max|score diff| "
        f"{diff:.3e} (unmasked scores)")
    if agreement < 0.9:
        failures.append(f"[{label}] incremental vs quadratic token agreement {agreement}")


def with_data(config_file, paths, seed, checkpoint, model=None, features_only=False):
    """`configs/<config_file>` on the synthetic data at `paths`, with `model`
    merged into its MODEL node."""
    from openvivqa_tpu_torch.config import get_config

    json_paths = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    if features_only:
        dataset = {"FEATURE_PATH": {"FEATURES": paths["features"]}}
    else:
        dataset = {"WORD_EMBEDDING": None, "FEATURE_PATH": {
            "FEATURES": paths["features"], "SCENE_TEXT": paths["scene_text"]}}
    return get_config(str(ROOT / "configs" / config_file)).merged({
        "DATASET": {
            "FEATURE_DATASET": dataset, "DICT_DATASET": dataset,
            "JSON_PATH": json_paths, "VOCAB": {"JSON_PATH": json_paths},
        },
        "MODEL": model or {},
        "TRAINING": {"SEED": seed, "CHECKPOINT_PATH": checkpoint},
    })


NO_PRETRAINED = {"TEXT_BERT": {"LOAD_PRETRAINED": False}}


def run_iterative(tasks, config, paths, tmp, seed, failures):
    """Phase 7: the Iterative M4C family and the other MMF_M4C variants.
    `tasks` holds the quadratic and incremental MMF_IterativeM4C tasks; it is
    emptied once they have run."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.data.synthetic import generate_synthetic_dataset
    from openvivqa_tpu_torch.ops import _cuda

    launches = {name: 0 for name in _cuda.WRAPPERS}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    incremental = tasks["incremental"]
    steps = incremental.vocab.max_answer_length
    n_layers = len(incremental.model.decoder.layer)
    per_batch = steps * n_layers
    want = per_batch * len(incremental.dev_dict_dataloader)
    add(run_mode(incremental, "iterative incremental", failures,
                 ["fused_ffn_step", "fused_encoder_self_attention"],
                 {"fused_self_attention_step": want, "fused_cross_attention_streamed": want}))
    add(run_mode(tasks["quadratic"], "iterative quadratic", failures,
                 ["fused_ffn_step", "fused_encoder_self_attention", "fused_attention_packed"]))
    compare_decode_modes(tasks["quadratic"], incremental, failures)
    tasks.clear()
    del incremental
    torch.cuda.empty_cache()

    incremental_mode = {**NO_PRETRAINED, "DECODING_MODE": "incremental"}
    multilevel = build_task(with_data("mmf_iterative_multilevel_m4c.yaml", paths, seed,
                                      str(Path(tmp) / "multilevel"), incremental_mode), "cuda")
    add(one_greedy_batch(multilevel, "multilevel incremental", failures, {
        "fused_self_attention_step": per_batch, "fused_cross_attention_streamed": per_batch}))
    del multilevel

    # the grid stream at the regional config's width: the generator's 49 x 2048 grids
    grid_paths = generate_synthetic_dataset(str(Path(tmp) / "grid_data"), n_images=60,
                                            n_regions=100, max_scene_text=100, seed=seed)
    for config_file, label in (("mmf_regional_m4c.yaml", "regional incremental"),
                               ("mmf_language_adaptive_m4c.yaml", "language-adaptive incremental")):
        task = build_task(with_data(config_file, grid_paths, seed, str(Path(tmp) / label),
                                    incremental_mode), "cuda")
        mmt_layers = len(task.model.mmt.encoder.layer)
        add(one_greedy_batch(task, label, failures, {
            "fused_bert_self_step": task.vocab.max_answer_length * mmt_layers}))
        del task
        torch.cuda.empty_cache()

    log("  Iterative M4C training: TrainingMMF.start() for one epoch, then get_predictions()")
    train_task = build_task(config.merged({"TRAINING": {
        "MAX_EPOCHS": 1, "CHECKPOINT_PATH": str(Path(tmp) / "iterative_train")}}), "cuda")
    add(run_training(train_task, failures, label="iterative train", check_grads=True))
    return launches


# the mT5 encoder's output, kernel route against plain, relative to its largest
# magnitude: each of the eight layers rounds q, k, v and the softmax weights to
# bf16 on both routes, where float32 sums that differ in their last bits round
# one bf16 ulp (2^-8 relative) apart; the flips compound through the residual
# stream, a few ulps by the final RMS norm
ENCODER_RTOL = 2.0 ** -5
BACKBONES = ("vision_encoder.backbone.", "text_embedding.backbone.")


def with_evjvqa(paths, seed, checkpoint):
    """``configs/vit_mt5.yaml`` on the synthetic EVJVQA set at `paths`, one epoch."""
    from openvivqa_tpu_torch.config import get_config

    dataset = {"FEATURE_PATH": {"IMAGE": paths["images"]}}
    return get_config(str(ROOT / "configs" / "vit_mt5.yaml")).merged({
        "DATASET": {
            "FEATURE_DATASET": dataset, "DICT_DATASET": dataset,
            "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                          "PUBLIC_TEST": paths["public_test"],
                          "PRIVATE_TEST": paths["private_test"]},
            "VOCAB": {"JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                                    "TEST": paths["public_test"]}},
        },
        "TRAINING": {"SEED": seed, "CHECKPOINT_PATH": checkpoint, "MAX_EPOCHS": 1},
    })


def check_two_bias(task, gen, record, failures):
    """The two-bias attention at the mT5 encoder's shapes (a train batch and
    an eval batch of question lengths; hd 384 over 6 heads; scale 1) against
    its plain version, in both head-bias forms: the padding bias head-shared
    beside the (1, h, L, L) position table the port passes, and the two added
    into one (b, h, L, L) head bias (the JAX package's form).  Sample 0 has
    every key masked and must stay finite.  The library call is one float32
    ``scaled_dot_product_attention`` with the combined bias as its mask."""
    import torch
    import torch.nn.functional as F

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE, padding_bias
    from openvivqa_tpu_torch.ops import fused_attention

    dev = task.device
    backbone = task.model.text_embedding.backbone
    attn = backbone.encoder.block[0].layer[0].SelfAttention
    heads, hd = attn.num_heads, attn.q.out_features
    d = hd // heads
    for what, loader in (("train batch", task.train_dataloader),
                         ("eval batch", task.dev_dict_dataloader)):
        _, first = next(task.device_batches(loader))
        tokens = first["question_tokens"]
        b, n = tokens.shape
        with torch.no_grad():
            table = backbone.position_bias(n, dev)
        padding = padding_bias(tokens, task.vocab.padding_idx).contiguous()
        padding[0] = MASK_VALUE  # a sample with every key masked
        summed = (table + padding).contiguous()
        q, k, v = (torch.randn((b, n, hd), generator=gen, device=dev) for _ in range(3))
        split = [x.view(b, n, heads, d).transpose(1, 2) for x in (q, k, v)]
        def library():
            return F.scaled_dot_product_attention(*split, attn_mask=summed, scale=1.0)

        for form, bias, head_bias in (("padding + shared table", padding, table),
                                      ("(b, h, L, L) head bias", None, summed)):
            args = (q, k, v, bias, head_bias, 1.0, heads)
            out = fused_attention.fused_attention_packed_2bias(*args)
            if not bool(torch.isfinite(out).all()):
                failures.append(f"fused_attention_packed_2bias [{what}, {form}]: non-finite")
            record("fused_attention_packed_2bias",
                   f"mT5 {what} {b} x {n}, hd {hd} over {heads} heads, {form}, sample 0 "
                   "fully masked", max_err(out, fused_attention.fused_attention_packed_2bias_plain(
                       *args)), ATTN_TOL,
                   lambda: fused_attention.fused_attention_packed_2bias(*args),
                   lambda: fused_attention.fused_attention_packed_2bias_plain(*args),
                   4.0 * b * heads * n * n * d, tensor_bytes(q, k, v, bias, head_bias, out),
                   library)
            by_launch(failures, ((f"fused_attention_packed_2bias [{what}, {form}]",
                                  lambda: fused_attention.fused_attention_packed_2bias(*args)),))


def run_vit_mt5(config, seed, failures):
    """Phase 8: ``configs/vit_mt5.yaml`` (ViTmT5 under VlspEvjVqaTask) at its
    full widths on the synthetic EVJVQA set.  Returns (launches, kernel
    results)."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.models.modules.masks import padding_bias
    from openvivqa_tpu_torch.ops import _cuda
    from openvivqa_tpu_torch.training.decode import generate

    start = time.perf_counter()
    task = build_task(config, "cuda")
    model = task.model
    vit = model.vision_encoder.backbone
    t5 = model.text_embedding.backbone
    t5_attn = t5.encoder.block[0].layer[0].SelfAttention
    n_vit, n_t5 = len(vit.encoder.layer), len(t5.encoder.block)
    n_dec = len(model.decoder.layers)
    beam = task.evaluating_beam_size
    steps = task.vocab.max_answer_length
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    q_len = first["question_tokens"].shape[1]
    keys = vit.embeddings.num_patches + 1 + q_len
    log(f"  ViTmT5: ViT {n_vit} x {vit.layernorm.normalized_shape[0]}, mT5 {n_t5} x "
        f"{t5.shared.embedding_dim} ({t5_attn.num_heads} heads, inner {t5_attn.q.out_features}, "
        f"{t5.shared.num_embeddings} rows), decoder {n_dec} x {model.decoder.d_model}; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters "
        f"({sum(p.numel() for n, p in model.named_parameters() if n.startswith(BACKBONES)) / 1e6:.2f}"
        f"M frozen); {len(task.train_dataset)} train / {len(task.dev_dict_dataset)} dev / "
        f"{len(task.public_test_dict_dataset)} public / {len(task.private_test_dict_dataset)} "
        f"private samples, questions of {q_len} tokens, {steps} answer steps, decoder "
        f"cross-attention over {keys} keys; set up in {time.perf_counter() - start:.1f} s")

    # 1. the two-bias kernel against its plain version
    results = {}
    check_two_bias(task, torch.Generator(device=task.device).manual_seed(seed),
                   make_recorder(results, failures), failures)

    # 2. the mT5 encoder of one batch, kernel route against plain
    tokens = first["question_tokens"]
    bias = padding_bias(tokens, task.vocab.padding_idx)
    blocks = {"kernel": [], "plain": []}
    route = "kernel"
    hooks = [block.register_forward_hook(lambda module, args, out: blocks[route].append(out))
             for block in t5.encoder.block]
    with torch.no_grad():
        encoded = t5(tokens, bias)
        route = "plain"
        with plain_versions():
            encoded_plain = t5(tokens, bias)
    for hook in hooks:
        hook.remove()
    err, top = max_err(encoded, encoded_plain), float(encoded_plain.abs().max())
    log(f"  [vit_mt5] mT5 encoder of one eval batch, kernel vs plain route: max|diff| "
        f"{err:.3e}, mean|diff| {float((encoded - encoded_plain).abs().mean()):.3e}, "
        f"max|output| {top:.3f}: max|diff| / max|output| {err / top:.3e} (tol 2^-5); "
        "max|diff| after each block "
        + ", ".join(f"{max_err(a, b):.1e}" for a, b in zip(blocks["kernel"], blocks["plain"])))
    if not err / top <= ENCODER_RTOL:
        failures.append(f"[vit_mt5] mT5 encoder kernel vs plain: {err / top} > {ENCODER_RTOL}")

    # 3. beam-3 evaluate_metrics over the dev split, with launch counts
    n_batches = len(task.dev_dict_dataloader)
    n_valid = len(task.dev_dict_dataset)
    generate(model, first, beam)  # the allocator's first growth, outside the counted run
    torch.cuda.synchronize()
    plain_calls = {}
    with count_plain_calls(plain_calls):
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        eval_start = time.perf_counter()
        scores = task.evaluate_metrics(task.dev_dict_dataloader)
        torch.cuda.synchronize()
        eval_seconds = time.perf_counter() - eval_start
        counts = counts_now()
    launches = dict(counts)
    log(f"  [vit_mt5 beam] {n_valid} samples in {n_batches} batches of {first['question_tokens'].shape[0]}"
        f" x beam {beam} rows x {steps} steps: {eval_seconds:.3f} s ({n_valid / eval_seconds:.2f} "
        f"samples/s by the host clock); scores {json.dumps(scores, default=float)}")
    log(f"  [vit_mt5 beam] launches: {json.dumps(counts)}; plain calls: {json.dumps(plain_calls)}"
        f"{rows_text()}")
    want = {"fused_attention_packed_2bias": n_t5 * n_batches,
            "fused_attention_packed": n_vit * n_batches,
            "fused_decoder_layer_step": steps * n_dec * n_batches}
    for name, n in want.items():
        if counts[name] != n:
            failures.append(f"[vit_mt5 beam] {name}: {counts[name]} launches, want {n}")
    if plain_calls:
        failures.append(f"[vit_mt5 beam] plain versions were called: {plain_calls}")
    if "CIDEr" not in scores or not math.isfinite(scores["CIDEr"]):
        failures.append("[vit_mt5 beam] no finite CIDEr")
    with plain_versions():
        torch.cuda.synchronize()
        plain_start = time.perf_counter()
        task.evaluate_metrics(task.dev_dict_dataloader)
        torch.cuda.synchronize()
    log(f"  [vit_mt5 beam] the same eval on the plain path: "
        f"{time.perf_counter() - plain_start:.3f} s")

    # 4. one batch, all beams, kernel route against plain
    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    valid = torch.from_numpy(host["sample_valid"]).to(task.device)
    tokens_k, logprobs_k = generate(model, batch, beam, out_size=beam)
    with plain_versions():
        tokens_p, logprobs_p = generate(model, batch, beam, out_size=beam)
    expected = (valid.shape[0], beam, steps)
    if tuple(tokens_k.shape) != expected or not bool(torch.isfinite(logprobs_k).all()):
        failures.append(f"[vit_mt5 beam] outputs {tuple(tokens_k.shape)} (want {expected}) or "
                        "non-finite log-probs")
    same = (tokens_p == tokens_k).all(dim=-1) & valid[:, None]
    agreement = float((tokens_p[valid] == tokens_k[valid]).float().mean())
    diff = max_err(logprobs_p[same].sum(-1), logprobs_k[same].sum(-1)) if bool(same.any()) else 0.0
    log(f"  [vit_mt5 beam] plain vs kernel route, one batch, all {beam} beams: token agreement "
        f"{agreement * 100:.2f}% of {tokens_k[valid].numel()} tokens, {int(same.sum())} of "
        f"{int(valid.sum()) * beam} beams equal; on those, max|cumulative log-prob diff| "
        f"{diff:.3e}")
    if agreement < 0.9:
        failures.append(f"[vit_mt5 beam] plain vs kernel token agreement {agreement} < 0.9")
    decode_ms = median_ms(lambda: generate(model, batch, beam), reps=5)
    with plain_versions():
        plain_decode_ms = median_ms(lambda: generate(model, batch, beam), reps=5)
    rows = valid.shape[0]
    log(f"  [vit_mt5 beam] generate() of one batch of {rows} x beam {beam} (CUDA-event median "
        f"of 5, encode included): kernel route {decode_ms:.3f} ms = "
        f"{rows / decode_ms * 1e3:.1f} samples/s, plain route {plain_decode_ms:.3f} ms")
    profile(lambda: generate(model, batch, beam), "vit_mt5 beam decode")

    # 5. XE training: start() for one epoch, then get_predictions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    train_start = time.perf_counter()
    task.start()
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - train_start
    predict_start = time.perf_counter()
    test_scores = task.get_predictions()
    torch.cuda.synchronize()
    predict_seconds = time.perf_counter() - predict_start
    counts = counts_now()
    for name, n in counts.items():
        launches[name] += n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        records = [json.loads(line) for line in handle]
    losses = [loss for r in records if r["phase"] == "train" for loss in r["step_losses"]]
    log(f"  [vit_mt5 xe] start(): {train_seconds:.2f} s, per-step losses {json.dumps(losses)}")
    log(f"  [vit_mt5 xe] get_predictions() from best_model.pth: {predict_seconds:.2f} s, "
        f"scores {json.dumps(test_scores, default=float)}")
    log(f"  [vit_mt5 xe] launches: {json.dumps(counts)}; peak device memory {peak_gb:.2f} GB"
        f"{rows_text()}")
    want_steps = -(-len(task.train_dataset) // task.train_dataloader.batch_size)
    if len(losses) != want_steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"[vit_mt5 xe] losses {losses}: want {want_steps} finite values")
    for name in ("fused_attention_packed_2bias", "fused_attention_packed",
                 "fused_decoder_layer_step"):
        if counts[name] <= 0:
            failures.append(f"[vit_mt5 xe] {name} was not launched by start() and "
                            "get_predictions()")
    for name in ("best_model.pth", "last_model.pth", "public_test_results.json",
                 "private_test_results.json"):
        if not (Path(task.checkpoint_path) / name).is_file():
            failures.append(f"[vit_mt5 xe] {name} was not written")
    for split in ("public_test", "private_test"):
        if not math.isfinite(test_scores.get(split, {}).get("CIDEr", math.nan)):
            failures.append(f"[vit_mt5 xe] no finite CIDEr on {split}")

    # 6. one batch's gradients: none on the frozen backbones, non-zero elsewhere
    _, train_batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    task.compute_loss(train_batch).backward()
    bad, frozen = [], 0
    for name, p in model.named_parameters():
        if name.startswith(BACKBONES):
            frozen += 1
            if p.requires_grad or (p.grad is not None and bool(p.grad.any())):
                bad.append(name)
        elif (p.grad is None or not bool(torch.isfinite(p.grad).all())
              or not (name.endswith(GRADIENT_FREE) or float(p.grad.abs().max()) > 0.0)):
            bad.append(name)
    n_params = sum(1 for _ in model.parameters())
    log(f"  [vit_mt5 xe] one gradient step: {n_params - len(bad)} of {n_params} parameter "
        f"tensors as required ({frozen} in the frozen ViT and mT5: no gradient; the rest "
        "finite, non-zero except the gradient-free key biases)")
    if bad or not frozen:
        failures.append(f"[vit_mt5 xe] wrong gradients: {bad[:8]}")
    task.optimizer.zero_grad(set_to_none=True)
    step = lambda: task._train_step(train_batch)  # noqa: E731
    kernel_ms = [median_ms(step, reps=5)]
    with plain_versions():
        plain_ms = [median_ms(step, reps=5), median_ms(step, reps=5)]
    kernel_ms.append(median_ms(step, reps=5))
    log(f"  [vit_mt5 xe] one train step of {task.train_dataloader.batch_size} (CUDA-event median "
        f"of 5, in turns): kernel path {kernel_ms[0]:.3f}, {kernel_ms[1]:.3f} ms; plain path "
        f"{plain_ms[0]:.3f}, {plain_ms[1]:.3f} ms")
    profile(step, "vit_mt5 train step")
    return launches, results


# the streamed attention's kernel rows: (samples, keys = queries) at (hd, heads), from
# where the JAX package leaves the packed kernel at hd 512 on, and a ragged 64-key
# chunk; phase 9's long stream (samples, length) through JointTransformer's Encoder
STREAMED_WIDTH = (512, 8)
STREAMED_SHAPES = ((64, 1536), (16, 1601))
LONG_STREAM = (16, 1536)


def with_joint(paths, seed, checkpoint, config_file="joint_transformer_vlsp.yaml"):
    """``configs/<config_file>`` (a VlspEvjVqaTask config; phase 9's
    JointTransformer by default) on the synthetic EVJVQA set at `paths` (its
    VinVL-shaped feature store), one epoch."""
    from openvivqa_tpu_torch.config import get_config

    dataset = {"FEATURE_PATH": {"FEATURES": paths["features"]}}
    return get_config(str(ROOT / "configs" / config_file)).merged({
        "DATASET": {
            "FEATURE_DATASET": dataset, "DICT_DATASET": dataset,
            "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                          "PUBLIC_TEST": paths["public_test"],
                          "PRIVATE_TEST": paths["private_test"]},
            "VOCAB": {"JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                                    "TEST": paths["public_test"]}},
        },
        "TRAINING": {"SEED": seed, "CHECKPOINT_PATH": checkpoint, "MAX_EPOCHS": 1},
    })


def check_flat_and_streamed(task, gen, record, failures):
    """The flat attention at JointTransformer's beam-eval cross step (the dev
    loader's samples x beams rows, 8 heads, one query, the joint stream's keys,
    d 64, float32 K/V as the module route stores them, head-split views of
    packed projections, a (rows, 1, 1, Sk) padding bias whose row 0 masks every
    key), then with a per-head (16, 8, 64, Sk) bias and at d_k 64 / d_v 32;
    the streamed attention at 64 x 1536 x 1536, hd 512 over 8 heads, with a
    per-sample padding bias, beside the packed kernel at the same shape, then
    at 1601 keys (a ragged 64-key chunk).  The library call is one float32
    ``scaled_dot_product_attention`` with the bias as its mask."""
    import torch
    import torch.nn.functional as F

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.ops import fused_attention

    dev = task.device
    core = task.model.decoder.layers[0].enc_attn.attention
    heads, d = core.h, core.d_k
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    rows = first["question_tokens"].shape[0] * task.evaluating_beam_size
    with torch.no_grad():
        sk = task.model.streams(first)[1].shape[-1]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def split(b, s, dh):
        """A (b, h, s, dh) head-split view of a packed (b, s, h * dh) tensor."""
        return randn(b, s, heads * dh).view(b, s, heads, dh).transpose(1, 2)

    def padding(b, n):
        bias = torch.where(torch.rand((b, 1, 1, n), generator=gen, device=dev) < 0.2,
                           MASK_VALUE, 0.0)
        bias[0] = MASK_VALUE  # a row with every key masked
        return bias

    cases = (
        (f"cross step {rows} rows x {heads} heads x 1 query x {sk} keys, d {d}, row 0 fully "
         "masked", rows, 1, d, d, padding(rows, sk)),
        (f"per-head bias 16 x {heads} x 64 x {sk}, d {d}", 16, 64, d, d,
         torch.where(torch.rand((16, heads, 64, sk), generator=gen, device=dev) < 0.2,
                     MASK_VALUE, 0.0)),
        (f"d_k {d} / d_v {d // 2}, 16 x {heads} x 64 x {sk}", 16, 64, d, d // 2, padding(16, sk)),
    )
    for what, b, sq, dk, dv, bias in cases:
        q, k, v = split(b, sq, dk), split(b, sk, dk), split(b, sk, dv)
        scale = dk ** -0.5
        args = (q, k, v, bias, scale)
        out = fused_attention.fused_attention(*args)
        if not bool(torch.isfinite(out).all()):
            failures.append(f"fused_attention [{what}]: non-finite output")
        record("fused_attention", what,
               max_err(out, fused_attention.fused_attention_plain(*args)), ATTN_TOL,
               lambda: fused_attention.fused_attention(*args),
               lambda: fused_attention.fused_attention_plain(*args),
               2.0 * b * heads * sq * sk * (dk + dv), tensor_bytes(q, k, v, bias, out),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale))

    with torch.no_grad():
        k, v, bias = split(rows, sk, d), split(rows, sk, d), padding(rows, sk)
        for sq in CUT_OVER_ROWS:
            q = split(rows, sq, d)
            compare_blocks(
                f"flat {rows} rows x {heads} heads x {sq} x {sk} keys, d {d}",
                lambda block, a=(q, k, v, bias, d ** -0.5): fused_attention._flat_kernel(
                    *a, block=block),
                ("single", "tile"), fused_attention.fused_attention_plain(q, k, v, bias, d ** -0.5),
                fused_attention.attention_block("flat", sq, sk, d, d), failures)
        # the packed block's key cut-over at hd 512 over 8 heads (d 64): resident
        # in shared memory up to 400 keys, streamed through its ring from 401
        hd, heads = STREAMED_WIDTH
        for n in (400, 401):
            q, k, v = randn(64, n, hd), randn(64, n, hd), randn(64, n, hd)
            args = (q, k, v, padding(64, n), (hd // heads) ** -0.5, heads)
            compare_blocks(
                f"packed 64 x {n} x {n}, {heads} heads of {hd // heads}",
                lambda block, a=args: fused_attention._packed_kernel(*a, block=block),
                ("resident", "ring"), fused_attention.fused_attention_packed_plain(*args),
                fused_attention.attention_block("packed", n, n, hd // heads, hd // heads),
                failures)

    hd, heads = STREAMED_WIDTH
    scale = (hd // heads) ** -0.5
    for b, n in STREAMED_SHAPES:
        q, k, v = randn(b, n, hd), randn(b, n, hd), randn(b, n, hd)
        lengths = torch.randint(n // 2, n + 1, (b,), generator=gen, device=dev)
        bias = torch.where(torch.arange(n, device=dev)[None] < lengths[:, None], 0.0,
                           MASK_VALUE)[:, None, None, :].contiguous()
        args = (q, k, v, bias, scale, heads)
        out = fused_attention.fused_attention_packed_streamed(*args)
        packed = lambda: fused_attention.fused_attention_packed(*args)  # noqa: E731
        block = fused_attention.attention_block("packed", n, n, hd // heads, hd // heads)
        split_heads = [x.view(b, n, heads, hd // heads).transpose(1, 2) for x in (q, k, v)]
        record("fused_attention_packed_streamed",
               f"{b} x {n} x {n}, hd {hd} over {heads} heads, per-sample padding (the packed "
               f"entry's block B ({block}) at this shape: call {median_ms(packed):.4f} ms, "
               f"device {device_ms(packed)[0]:.4f} ms)",
               max_err(out, fused_attention.fused_attention_packed_streamed_plain(*args)),
               ATTN_TOL, lambda: fused_attention.fused_attention_packed_streamed(*args),
               lambda: fused_attention.fused_attention_packed_streamed_plain(*args),
               4.0 * b * n * n * hd, tensor_bytes(q, k, v, bias, out),
               lambda: F.scaled_dot_product_attention(*split_heads, attn_mask=bias,
                                                      scale=scale))
        log("    fused_attention_packed_streamed: "
            + launch_split(lambda: fused_attention.fused_attention_packed_streamed(*args)))
        del q, k, v, out, split_heads
        torch.cuda.empty_cache()


def run_joint_transformer(task, seed, failures):
    """Phase 9: ``configs/joint_transformer_vlsp.yaml`` (JointTransformer under
    VlspEvjVqaTask) at its full widths on the synthetic EVJVQA set and its
    feature store.  Returns the launches of its main-path runs."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import padding_bias
    from openvivqa_tpu_torch.ops import _cuda
    from openvivqa_tpu_torch.training.decode import generate

    model = task.model
    beam = task.evaluating_beam_size
    steps = task.vocab.max_answer_length
    n_enc, n_dec = len(model.encoder.layers), len(model.decoder.layers)
    n_batches = len(task.dev_dict_dataloader)
    n_valid = len(task.dev_dict_dataset)
    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    with torch.no_grad():
        keys = model.streams(batch)[1].shape[-1]
    rows = batch["question_tokens"].shape[0] * beam
    log(f"  JointTransformer: d_model {model.decoder.d_model}, "
        f"{model.encoder.layers[0].mhatt.attention.h} heads, {n_enc} encoder + {n_dec} decoder "
        f"layers, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters; "
        f"{len(task.train_dataset)} train / {n_valid} dev / {len(task.public_test_dict_dataset)} "
        f"public / {len(task.private_test_dict_dataset)} private samples; joint stream of {keys} "
        f"keys (regions, region boxes, grids, grid boxes, question), {steps} answer steps, "
        f"{rows} decode rows")
    launches = {name: 0 for name in _cuda.WRAPPERS}
    generate(model, batch, beam)  # the allocator's first growth, outside the counted runs
    torch.cuda.synchronize()

    # 1. beam-3 evaluate_metrics over the dev split on the layer and module routes
    want = {
        "layer": {"fused_decoder_layer_step": steps * n_dec * n_batches, "fused_attention": 0,
                  "fused_attention_packed": n_enc * n_batches},
        "module": {"fused_attention": steps * n_dec * 2 * n_batches,
                   "fused_decoder_layer_step": 0, "fused_attention_packed": n_enc * n_batches},
    }
    for route, parts in (("layer", "layer"), ("module", "none")):
        plain_calls = {}
        with decode_parts(parts), count_plain_calls(plain_calls):
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            scores = task.evaluate_metrics(task.dev_dict_dataloader)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = counts_now()
        for name, n in counts.items():
            launches[name] += n
        log(f"  [joint beam, {route}] {n_valid} samples in {n_batches} batches: {seconds:.3f} s "
            f"({n_valid / seconds:.2f} samples/s by the host clock); scores "
            f"{json.dumps(scores, default=float)}")
        used = {k: v for k, v in counts.items() if v}
        log(f"  [joint beam, {route}] launches: {json.dumps(used)}; plain calls: "
            f"{json.dumps(plain_calls)}{rows_text()}")
        for name, n in want[route].items():
            if counts[name] != n:
                failures.append(f"[joint beam, {route}] {name}: {counts[name]} launches, want {n}")
        if plain_calls:
            failures.append(f"[joint beam, {route}] plain versions were called: {plain_calls}")
        if "CIDEr" not in scores or not math.isfinite(scores["CIDEr"]):
            failures.append(f"[joint beam, {route}] no finite CIDEr")

    # 2. one batch, all beams, on the layer, module and plain routes
    def decode(parts, plain=False):
        with decode_parts(parts), (plain_versions() if plain else contextlib.nullcontext()):
            return generate(model, batch, beam, out_size=beam)

    routes = {"layer": ("layer", False), "module": ("none", False), "plain": ("layer", True)}
    outs = {route: decode(*args) for route, args in routes.items()}
    valid = torch.from_numpy(host["sample_valid"]).to(task.device)
    expected = (valid.shape[0], beam, steps)
    for route, (tokens, logprobs) in outs.items():
        if tuple(tokens.shape) != expected or not bool(torch.isfinite(logprobs).all()):
            failures.append(f"[joint beam] {route} route: outputs {tuple(tokens.shape)} (want "
                            f"{expected}) or non-finite log-probs")
    for a, b in (("module", "layer"), ("layer", "plain"), ("module", "plain")):
        (tokens_a, logprobs_a), (tokens_b, logprobs_b) = outs[a], outs[b]
        same = (tokens_a == tokens_b).all(dim=-1) & valid[:, None]
        agreement = float((tokens_a[valid] == tokens_b[valid]).float().mean())
        diff = max_err(logprobs_a[same].sum(-1), logprobs_b[same].sum(-1)) if bool(
            same.any()) else 0.0
        log(f"  [joint beam] {a} vs {b} route, one batch, all {beam} beams: token agreement "
            f"{agreement * 100:.2f}% of {tokens_a[valid].numel()} tokens, {int(same.sum())} of "
            f"{int(valid.sum()) * beam} beams equal; on those, max|cumulative log-prob diff| "
            f"{diff:.3e}")
        if agreement < 0.9:
            failures.append(f"[joint beam] {a} vs {b} token agreement {agreement} < 0.9")
    times = {route: median_ms(lambda a=args: decode(*a), reps=5) for route, args in routes.items()}
    log(f"  [joint beam] generate() of one batch of {valid.shape[0]} x beam {beam} with its "
        "encode (CUDA-event median of 5): " + ", ".join(
            f"{route} route {ms:.3f} ms" for route, ms in times.items()))
    with decode_parts("layer"):
        profile(lambda: generate(model, batch, beam), "joint beam decode, layer route")
    with decode_parts("none"):
        profile(lambda: generate(model, batch, beam), "joint beam decode, module route")

    # 3. XE training: start() for one epoch, then get_predictions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    start = time.perf_counter()
    task.start()
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - start
    start = time.perf_counter()
    test_scores = task.get_predictions()
    torch.cuda.synchronize()
    predict_seconds = time.perf_counter() - start
    counts = counts_now()
    for name, n in counts.items():
        launches[name] += n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        records = [json.loads(line) for line in handle]
    losses = [loss for r in records if r["phase"] == "train" for loss in r["step_losses"]]
    log(f"  [joint xe] start(): {train_seconds:.2f} s, per-step losses {json.dumps(losses)}")
    log(f"  [joint xe] get_predictions() from best_model.pth: {predict_seconds:.2f} s, "
        f"scores {json.dumps(test_scores, default=float)}")
    log(f"  [joint xe] launches: {json.dumps({k: v for k, v in counts.items() if v})}; peak "
        f"device memory {peak_gb:.2f} GB{rows_text()}")
    want_steps = -(-len(task.train_dataset) // task.train_dataloader.batch_size)
    if len(losses) != want_steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"[joint xe] losses {losses}: want {want_steps} finite values")
    for name in ("fused_attention_packed", "fused_decoder_layer_step"):
        if counts[name] <= 0:
            failures.append(f"[joint xe] {name} was not launched by start() and get_predictions()")
    for name in ("best_model.pth", "last_model.pth", "public_test_results.json",
                 "private_test_results.json"):
        if not (Path(task.checkpoint_path) / name).is_file():
            failures.append(f"[joint xe] {name} was not written")
    for split in ("public_test", "private_test"):
        if not math.isfinite(test_scores.get(split, {}).get("CIDEr", math.nan)):
            failures.append(f"[joint xe] no finite CIDEr on {split}")

    _, train_batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    task.compute_loss(train_batch).backward()
    bad = [name for name, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not (name.endswith(GRADIENT_FREE) or float(p.grad.abs().max()) > 0.0)]
    n_params = sum(1 for _ in model.parameters())
    log(f"  [joint xe] one gradient step: {n_params - len(bad)} of {n_params} parameter tensors "
        "with finite gradients, non-zero except the gradient-free key biases")
    if bad:
        failures.append(f"[joint xe] missing, non-finite or zero gradients: {bad[:8]}")
    task.optimizer.zero_grad(set_to_none=True)
    step = lambda: task._train_step(train_batch)  # noqa: E731
    kernel_ms = [median_ms(step, reps=5)]
    with plain_versions():
        plain_ms = [median_ms(step, reps=5), median_ms(step, reps=5)]
    kernel_ms.append(median_ms(step, reps=5))
    log(f"  [joint xe] one train step of {task.train_dataloader.batch_size} (CUDA-event median "
        f"of 5, in turns): kernel path {kernel_ms[0]:.3f}, {kernel_ms[1]:.3f} ms; plain path "
        f"{plain_ms[0]:.3f}, {plain_ms[1]:.3f} ms")
    profile(step, "joint train step")

    # 4. a long stream through the model's own Encoder: the streamed kernel
    samples, length = LONG_STREAM
    width = model.decoder.d_model
    gen = torch.Generator(device=task.device).manual_seed(seed)
    features = torch.randn((samples, length, width), generator=gen, device=task.device)
    lengths = torch.randint(length // 2, length + 1, (samples,), generator=gen,
                            device=task.device)
    features[torch.arange(length, device=task.device)[None] >= lengths[:, None]] = 0.0
    bias = padding_bias(features, 0)
    encoder = model.encoder
    encoder.eval()
    with torch.no_grad():
        _cuda.reset_launch_counts()
        out = encoder(features, bias)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        with plain_versions():
            out_plain = encoder(features, bias)
        encode_ms = median_ms(lambda: encoder(features, bias), reps=5)
        with plain_versions():
            plain_encode_ms = median_ms(lambda: encoder(features, bias), reps=5)
    err, top = max_err(out, out_plain), float(out_plain.abs().max())
    _cuda.reset_launch_counts()
    encoder.train()
    leaf = features.clone().requires_grad_()
    encoder(leaf, bias, task.generator).sum().backward()
    torch.cuda.synchronize()
    train_counts = _cuda.launch_counts()
    encoder.eval()
    for name in ("fused_attention_packed_streamed",):
        launches[name] += counts[name] + train_counts[name]
    log(f"  [joint long stream] the Encoder on {samples} x {length} x {width} with a padding "
        "bias: "
        f"streamed launches {counts['fused_attention_packed_streamed']} in eval, "
        f"{train_counts['fused_attention_packed_streamed']} in training (packed "
        f"{counts['fused_attention_packed'] + train_counts['fused_attention_packed']}); kernel "
        f"vs plain route max|diff| {err:.3e} / max|output| {top:.3f} = {err / top:.3e} (tol "
        f"2^-5); eval {encode_ms:.3f} ms kernel route, {plain_encode_ms:.3f} ms plain route "
        "(CUDA-event medians of 5)")
    for name, n in (("eval", counts), ("training", train_counts)):
        if n["fused_attention_packed_streamed"] != n_enc or n["fused_attention_packed"]:
            failures.append(f"[joint long stream] {name}: streamed launches "
                            f"{n['fused_attention_packed_streamed']}, want {n_enc}, packed none")
    if not err / top <= ENCODER_RTOL:
        failures.append(f"[joint long stream] kernel vs plain: {err / top} > {ENCODER_RTOL}")
    if leaf.grad is None or not bool(torch.isfinite(leaf.grad).all()) or not bool(leaf.grad.any()):
        failures.append("[joint long stream] the training route's input gradient is missing, "
                        "non-finite or zero")
    return launches


# phase 10: the classification configs, each with the width of its region features
CLASSIFICATION_CONFIGS = (
    ("mcan.yaml", 1024), ("mcan_non_lstm.yaml", 1024), ("mcan_hierarchical.yaml", 1024),
    ("saaa.yaml", 1024), ("saaa_non_lstm.yaml", 1024), ("saaa_hierarchical.yaml", 1024),
    ("vanilla_transformer.yaml", 2048), ("parallel_attention_transformer.yaml", 2048),
    ("hierarchical_co_attention.yaml", 2048),
)
ARGMAX_AGREEMENT = 0.9  # the kernel path's answers against the plain path's


def with_classification(config_file, paths, seed, checkpoint):
    """`configs/<config_file>` (a ClassificationTask config) on the synthetic
    data at `paths`."""
    from openvivqa_tpu_torch.config import get_config

    json_paths = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    return get_config(str(ROOT / "configs" / config_file)).merged({
        "DATASET": {"FEATURE_DATASET": {"FEATURE_PATH": {"FEATURES": paths["features"]}},
                    "JSON_PATH": json_paths, "VOCAB": {"JSON_PATH": json_paths}},
        "TRAINING": {"SEED": seed, "CHECKPOINT_PATH": checkpoint},
    })


def packed_per_batch(model) -> int:
    """Packed-attention launches of one forward of a classification MODEL
    node (or of one encode of a generator's): one per encoder attention
    (MCAN, ExtendedMCAN: self layers + 2 x guided layers; an Encoder: its
    layers; a CoAttentionEncoder or CrossModalityEncoder: 4 x its layers;
    SAAA none)."""
    if model.get("SELF_ENCODER") is not None:
        return model.SELF_ENCODER.LAYERS + 2 * model.GUIDED_ENCODER.LAYERS
    if model.ARCHITECTURE == "SAAA":
        return 0
    encoder = model.ENCODER
    dual = encoder.ARCHITECTURE in ("CoAttentionEncoder", "CrossModalityEncoder")
    return (4 if dual else 1) * encoder.LAYERS


def classification_eval(task, label, failures, timed=False):
    """The dev split through ``evaluate_metrics`` on the kernel path: exactly
    packed_per_batch x batches packed launches, nothing else, and no plain
    version called (``exact_eval``).  With `timed`, eval samples/s on both
    paths (kernel, plain, plain, kernel)."""
    import torch

    n_valid, n_batches = len(task.dev_dataset), len(task.dev_dataloader)

    def timed_eval():
        torch.cuda.synchronize()
        start = time.perf_counter()
        task.evaluate_metrics(task.dev_dataloader)
        torch.cuda.synchronize()
        return time.perf_counter() - start

    # one batch first, so that the libraries' first-call set-up is not in the timed runs
    _, first = next(task.device_batches(task.dev_dataloader))
    task.predict(first)
    torch.cuda.synchronize()
    counts = exact_eval(task, label, failures, exact_launches(
        fused_attention_packed=packed_per_batch(task.config.MODEL) * n_batches))
    if timed:
        kernel_seconds = [timed_eval()]
        with plain_versions():
            plain_seconds = [timed_eval(), timed_eval()]
        kernel_seconds.append(timed_eval())
        for name, runs in (("kernel", kernel_seconds), ("plain", plain_seconds)):
            log(f"  [{label}] eval loop, {name} path: {n_valid} samples in "
                + ", ".join(f"{t:.3f} s ({n_valid / t:.2f} samples/s)" for t in runs))
    return counts


def compare_classification_paths(task, label, failures, relative=False):
    """The dev split's log-probs on the kernel and the plain path: the max
    |difference| (within LOGPROB_TOL) and the argmax agreement over the valid
    samples (at least ARGMAX_AGREEMENT).  With `relative` (ViTmBERTClassification,
    whose logits sum its fused features over every token and run to hundreds)
    each sample's difference is taken relative to its largest |log-prob| and
    held to BF16_ULP: one bf16 rounding of each token's features, carried
    through the sum and the classifier."""
    import torch

    err, rel, scale, agree, total = 0.0, 0.0, 0.0, 0, 0
    task.model.eval()
    with torch.no_grad():
        for host, batch in task.device_batches(task.dev_dataloader):
            valid = torch.from_numpy(host["sample_valid"]).to(batch["answer"].device)
            out_k = task.model(batch)
            with plain_versions():
                out_p = task.model(batch)
            if not bool(torch.isfinite(out_k).all()) or out_k.shape[-1] != task.vocab.total_answers:
                failures.append(f"[{label}] log-probs of shape {tuple(out_k.shape)} or "
                                "non-finite")
            err = max(err, max_err(out_k[valid], out_p[valid]))
            diff = (out_k - out_p).abs().max(-1).values / out_p.abs().max(-1).values
            rel = max(rel, float(diff[valid].max()))
            scale = max(scale, float(out_p[valid].abs().max()))
            agree += int((out_k.argmax(-1) == out_p.argmax(-1))[valid].sum())
            total += int(valid.sum())
    tol = f"relative tol {BF16_ULP:.1e}" if relative else f"tol {LOGPROB_TOL:.0e}"
    log(f"  [{label}] kernel vs plain path over the dev split: max|log-prob diff| {err:.3e}, "
        f"max|log-prob| {scale:.2f}, max over samples of |diff| / the sample's max|log-prob| "
        f"{rel:.3e} ({tol}), argmax agreement {100 * agree / total:.2f} % of {total} samples")
    if not (rel <= BF16_ULP if relative else err <= LOGPROB_TOL):
        failures.append(f"[{label}] kernel vs plain path: max|log-prob diff| {err}, relative "
                        f"{rel} ({tol})")
    if agree < ARGMAX_AGREEMENT * total:
        failures.append(f"[{label}] argmax agreement {agree} of {total} < {ARGMAX_AGREEMENT}")


def exact_launches(**given) -> dict:
    """Every kernel's launch count: those given, none of the others."""
    from openvivqa_tpu_torch.ops import _cuda

    return {name: given.get(name, 0) for name in _cuda.WRAPPERS}


def exact_eval(task, label, failures, want):
    """The dev split through ``evaluate_metrics`` with each kernel launched
    exactly `want[name]` times and no plain version called; returns the
    counts."""
    import torch

    from openvivqa_tpu_torch.ops import _cuda

    loader = task.dev_dict_dataloader if hasattr(task, "dev_dict_dataloader") else \
        task.dev_dataloader
    plain_calls = {}
    with count_plain_calls(plain_calls):
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        scores = task.evaluate_metrics(loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = counts_now()
    log(f"  [{label}] dev eval ({len(loader)} batches of {loader.batch_size}): {seconds:.3f} s, "
        f"scores {json.dumps(scores, default=float)}; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; plain calls "
        f"{json.dumps(plain_calls)}{rows_text()}")
    for name, n in want.items():
        if counts[name] != n:
            failures.append(f"[{label}] {name}: {counts[name]} launches, want {n}")
    if plain_calls:
        failures.append(f"[{label}] plain versions were called: {plain_calls}")
    if task.score_name not in scores or not math.isfinite(scores[task.score_name]):
        failures.append(f"[{label}] no finite {task.score_name} in the dev scores")
    return counts


def _clone_tree(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone_tree(v) for v in x)
    return x


@contextlib.contextmanager
def capture_calls(module, name: str, key, calls: dict):
    """Route `module.name` through a recorder that keeps, for each key(args)
    met, a copy of the first call's (args, kwargs) taken before the call."""
    original = getattr(module, name)

    def recording(*args, **kwargs):
        if key(args) not in calls:
            calls[key(args)] = (_clone_tree(args), _clone_tree(kwargs))
        return original(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, original)


def sdpa_args(q, k, v, bias, grad, n_heads):
    """Head-split views of the packed projections, for the library call."""
    def split(x):
        x = x.detach().requires_grad_(grad)
        return x, x.view(x.shape[0], x.shape[1], n_heads, -1).transpose(1, 2)

    (q0, qh), (k0, kh), (v0, vh) = split(q), split(k), split(v)
    return (q0, k0, v0), (qh, kh, vh), bias


def sdpa_call(q, k, v, bias, n_heads, sc, dropout_p=0.0, backward=False):
    """One library call on the head-split views, as a callable to time."""
    import torch
    import torch.nn.functional as F

    leaves, (qh, kh, vh), mask = sdpa_args(q, k, v, bias, grad=backward, n_heads=n_heads)
    g = torch.ones_like(qh)

    def call():
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=dropout_p,
                                             scale=sc)
        if backward:
            out.backward(g)

    return call


def sdpa_backward_call(q, k, v, bias, dropout_p, n_heads, sc):
    """SDPA's backward alone: the graph is built once, outside the timed
    callable, and each call runs its backward again (the gradients of the
    head-split views, returned, not accumulated into leaves)."""
    import torch
    import torch.nn.functional as F

    leaves, (qh, kh, vh), mask = sdpa_args(q, k, v, bias, grad=True, n_heads=n_heads)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=dropout_p,
                                         scale=sc)
    g = torch.ones_like(out)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)


def sdpa_library(q, k, v, bias, scale, heads):
    """One float32 scaled_dot_product_attention call on the head-split views
    of packed projections, as a callable to time (never called by the port)."""
    import torch.nn.functional as F

    bs = q.shape[0]
    qh, kh, vh = (x.reshape(bs, x.shape[1], heads, -1).transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=scale)


def check_packed_calls(calls, label, record):
    """The packed kernel against its plain version on each captured call."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention

    kernel, plain = fused_attention.fused_attention_packed, \
        fused_attention.fused_attention_packed_plain
    with torch.no_grad():
        for (bs, sq, sk, hd, heads, full), (args, _) in calls.items():
            q, k, v, bias = args[:4]
            out = kernel(*args)
            block = fused_attention.attention_block("packed", sq, sk, hd // heads, hd // heads)
            record("fused_attention_packed",
                   f"{label} {bs} x {sq} x {sk}, {heads} heads of {hd // heads}, "
                   f"{'full (b, 1, Sq, Sk)' if full else 'key-only'} bias, block {block}",
                   max_err(out, plain(*args)), ATTN_TOL, lambda a=args: kernel(*a),
                   lambda a=args: plain(*a), 4.0 * bs * sq * sk * hd,
                   tensor_bytes(q, k, v, bias, out), sdpa_library(*args))


def packed_key(args):
    """A packed call's shape: (b, Sq, Sk, hd, heads, whether the bias is per
    query row)."""
    q, k, bias, heads = args[0], args[1], args[3], args[5]
    full = bias is not None and bias.ndim == 4 and bias.shape[2] > 1
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], heads, full)


def check_packed_at_path_shapes(task, label, record, failures):
    """The packed kernel against its plain version at every shape one eval
    forward of the first dev batch gives it (MCAN: the regions'
    self-attention, the guided attention over the question, the question's
    self-attention; VanillaTransformer: [regions | question] over itself;
    the co-attention models also the question over the regions), on the
    inputs of that shape's first call there, beside one float32 SDPA call."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention

    calls = {}
    _, batch = next(task.device_batches(task.dev_dataloader))
    task.model.eval()
    with torch.no_grad(), capture_calls(fused_attention, "fused_attention_packed", packed_key,
                                        calls):
        task.model(batch)
    if not calls:
        failures.append(f"[{label}] no packed attention call in one eval forward")
    check_packed_calls(calls, label, record)


def check_dropout_at_path_shapes(task, label, record, failures):
    """The dropout pair against its plain versions at every shape one train
    step of the first train batch gives it: per shape, the first forward's
    inputs and the first backward's (the stats, keep bits and upstream
    gradient the step gave it, and the seed its forward drew, found through
    the bits), each held as phase 3 holds its cases."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention

    forward = fused_attention._dropout_forward_kernel
    backward = fused_attention._dropout_backward_kernel
    forwards, backwards, seeds = {}, {}, {}

    def key(q, k, bias, heads):
        return packed_key((q, k, None, bias, None, heads))

    def recording_forward(*args):
        q, k, _, bias, seed, _, heads = args[:7]
        forwards.setdefault(key(q, k, bias, heads), _clone_tree(args))
        out = forward(*args)
        seeds[out[2].data_ptr()] = seed.clone()  # the graph keeps each bits tensor alive
        return out

    def recording_backward(*args):
        q, k, _, bias, _, bits, _, _, heads = args[:9]
        backwards.setdefault(key(q, k, bias, heads),
                             (_clone_tree(args), seeds[bits.data_ptr()]))
        return backward(*args)

    _, batch = next(task.device_batches(task.train_dataloader))
    fused_attention._dropout_forward_kernel = recording_forward
    fused_attention._dropout_backward_kernel = recording_backward
    try:
        task.generator.manual_seed(1234)
        task.optimizer.zero_grad(set_to_none=True)
        task.compute_loss(batch).backward()
    finally:
        fused_attention._dropout_forward_kernel = forward
        fused_attention._dropout_backward_kernel = backward
        task.optimizer.zero_grad(set_to_none=True)
    if not forwards or sorted(forwards) != sorted(backwards):
        failures.append(f"[{label}] dropout pair: forward shapes {sorted(forwards)}, backward "
                        f"shapes {sorted(backwards)} in one train step")
    for (bs, sq, sk, hd, heads, full), args in sorted(forwards.items()):
        what = (f"{label} {bs} x {sq} x {sk}, {heads} heads of {hd // heads}, "
                f"{'full (b, 1, Sq, Sk)' if full else 'key-only'} bias, rate {args[7]}")
        check_dropout_forward(what, args, record, failures)
        if (bs, sq, sk, hd, heads, full) in backwards:
            bwd_args, seed = backwards[(bs, sq, sk, hd, heads, full)]
            check_dropout_backward(what, bwd_args, seed, record, failures)


def run_classification(paths, wide_paths, tmp, seed, failures, record):
    """Phase 10, each classification config at its own widths: dev eval on
    the kernel path with exact packed launches and no plain call; for the
    configs with an attention core, kernel vs plain log-probs and the packed
    kernel against its plain version at every shape the config gives it.
    configs/mcan.yaml (full widths) also gets eval samples/s on both paths, a
    profiler table of one eval batch, one step's gradients on both paths and
    train-step times, then start() for one epoch and get_predictions(); each
    other config one train step with a finite loss and finite gradients.
    `wide_paths` is the synthetic set with 2048-wide regions.  Returns the
    launch counts of the main-path runs."""
    import torch

    from openvivqa_tpu_torch.builders import build_task

    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    for config_file, width in CLASSIFICATION_CONFIGS:
        start = time.perf_counter()
        data = paths if width == 1024 else wide_paths
        name = config_file.removesuffix(".yaml")
        config = with_classification(config_file, data, seed, str(Path(tmp) / name))
        task = build_task(config, "cuda")
        model = config.MODEL
        log(f"  [{name}] {model.ARCHITECTURE}, d_model {model.D_MODEL}, "
            f"{sum(p.numel() for p in task.model.parameters()) / 1e6:.2f}M parameters, "
            f"{width}-wide regions, {len(task.train_dataset)} train / {len(task.dev_dataset)} "
            f"dev samples, {task.vocab.total_answers} classes, packed launches a forward "
            f"{packed_per_batch(model)}" + (" (SAAA has no attention core: it runs on "
                                            "nn.Linear and nn.LSTM only)"
                                            if model.ARCHITECTURE == "SAAA" else ""))
        add(classification_eval(task, name, failures, timed=name == "mcan"))
        if packed_per_batch(model):
            compare_classification_paths(task, name, failures)
            check_packed_at_path_shapes(task, name, record, failures)
        if name == "mcan":
            _, batch = next(task.device_batches(task.dev_dataloader))
            profile(lambda: task.predict(batch), f"{name} eval batch")
            # the step checks on the seeded weights: at the config's constant rate of
            # 1.0 (Adam at 1.0, the reference's), an epoch leaves weights that no
            # longer tell a missing gradient from a dead unit
            torch.cuda.reset_peak_memory_stats()
            check_train_step(task, failures, "mcan step", check_grads=True)
            log(f"  [mcan step] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            del task
            torch.cuda.empty_cache()
            train_task = build_task(config.merged({"TRAINING": {
                "MAX_EPOCHS": 1, "CHECKPOINT_PATH": str(Path(tmp) / "mcan_train")}}), "cuda")
            add(run_epoch(train_task, failures, "mcan train", expected=("fused_attention_packed",)))
            del train_task
        else:
            _, batch = next(task.device_batches(task.train_dataloader))
            loss = float(task._train_step(batch))
            bad = [n for n, p in task.model.named_parameters()
                   if p.requires_grad and (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
            log(f"  [{name}] one train step: loss {loss:.6f}, "
                f"{'all gradients finite' if not bad else f'missing or non-finite {bad[:4]}'}")
            if not math.isfinite(loss) or bad:
                failures.append(f"[{name}] train step: loss {loss}, bad gradients {bad[:4]}")
            del task
        torch.cuda.empty_cache()
        log(f"  [{name}] {time.perf_counter() - start:.1f} s")
    return launches


# -- phase 11: the rest of the M4C family ---------------------------------------------------
# MMF_LoRRA keeps only the *weights* of its spatial and context attentions:
# their value and out projections take no part in the scores, so get no gradient
LORRA_UNREAD = ("spatial_attn.fc_v.", "spatial_attn.fc_o.", "context_attn.fc_v.",
                "context_attn.fc_o.")


def bert_self_step_f64(x, w, ctx, slot_k, slot_v, step, ctx_bias, scale, heads, eps):
    """Kernel D's function in float64 on the operands both versions round
    alike (x to bf16 for the projection, the new k and v to the bf16 slots),
    with the attention's context left unrounded, where the kernel and the
    plain version each round it to bf16 for the out projection: (y, the rows'
    pre-LayerNorm spread sigma)."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE

    f64 = torch.float64
    bs, hd = x.shape
    n_slots = slot_k.shape[1]
    t = min(step, n_slots - 1)
    q, k_new, v_new = (x.to(torch.bfloat16).to(f64) @ w["wqkv"].to(f64)
                       + w["bqkv"].to(f64)).split(hd, dim=-1)
    keys, values = (torch.cat([c.to(f64), s.to(f64)], dim=1)
                    for c, s in zip(ctx, (slot_k, slot_v)))
    keys[:, ctx[0].shape[1] + t] = k_new.to(torch.bfloat16).to(f64)
    values[:, ctx[0].shape[1] + t] = v_new.to(torch.bfloat16).to(f64)
    slot_bias = torch.where(torch.arange(n_slots, device=x.device) <= t, 0.0, MASK_VALUE)
    bias = torch.cat([ctx_bias.to(f64), slot_bias.to(f64).expand(bs, n_slots)], dim=1)
    d = hd // heads
    logits = torch.einsum("bhd,bkhd->bhk", q.view(bs, heads, d), keys.view(bs, -1, heads, d))
    weights = torch.softmax(logits * scale + bias[:, None], dim=-1)
    context = torch.einsum("bhk,bkhd->bhd", weights,
                           values.view(bs, -1, heads, d)).reshape(bs, hd)
    h = x.to(f64) + context @ w["wo"].to(f64) + w["bo"].to(f64)
    sigma = (h.var(dim=-1, unbiased=False) + eps).sqrt()
    y = (h - h.mean(dim=-1, keepdim=True)) / sigma[:, None] * w["ln_scale"].to(f64) \
        + w["ln_bias"].to(f64)
    return y, sigma


def check_m4c_kernels(quadratic, incremental, record, failures):
    """Kernels C, D and the packed attention at the standalone M4C's own
    shapes: the inputs of their first calls (per row count; per step and
    layer; per shape) in one teacher-forced forward on the greedy prefix
    (quadratic) and one incremental greedy decode of the first dev batch, each
    against its plain version.  D's error is also taken apart: by step and
    layer, each version against a float64 evaluation, the rows' pre-LayerNorm
    spread (LayerNorm multiplies a difference in its input by 1 / sigma), and
    its time three times over."""
    import torch

    from openvivqa_tpu_torch.ops import decode_step, fused_attention

    _, batch = next(quadratic.device_batches(quadratic.dev_dict_dataloader))
    ffn, steps, packed, layer_of = {}, {}, {}, {}
    ffn_key = lambda a: (a[0].shape[0], a[1].shape[1])  # noqa: E731 (rows, d_ff)

    def step_key(a):  # (step, layer): the layers take their first step in order
        return a[5], layer_of.setdefault(a[1]["wo"].data_ptr(), len(layer_of))

    with torch.no_grad():
        prev_inds = quadratic.model.greedy_decode(batch)["prev_inds"]
        with capture_calls(decode_step, "fused_ffn_step", ffn_key, ffn), \
                capture_calls(fused_attention, "fused_attention_packed", packed_key, packed):
            quadratic.model.compute_scores(batch, prev_inds)
        with capture_calls(decode_step, "fused_ffn_step", ffn_key, ffn), \
                capture_calls(decode_step, "fused_bert_self_step", step_key, steps):
            incremental.model.greedy_decode(batch)
    if not (ffn and steps and packed):
        failures.append("[m4c kernels] a kernel was not called in the captured forward")
    hd = quadratic.model.encoder.layer[0].attention.hidden_size
    with torch.no_grad():
        for (rows, d_ff), (args, kwargs) in sorted(ffn.items()):
            out = decode_step.fused_ffn_step(*args, **kwargs)
            record("fused_ffn_step", f"m4c {rows} rows, {hd} -> {d_ff}",
                   max_err(out, decode_step.fused_ffn_step_plain(*args, **kwargs)), LN_TOL,
                   lambda a=args, k=kwargs: decode_step.fused_ffn_step(*a, **k),
                   lambda a=args, k=kwargs: decode_step.fused_ffn_step_plain(*a, **k),
                   4.0 * rows * hd * d_ff, tensor_bytes(args[:7], out))
        # kernel D at every step and layer of the decode, kernel and plain on
        # their own copies of the slot caches as they stood before the step
        y_err = slot_err = 0.0
        by_step, by_layer, worst = {}, {}, None
        to_f64 = {"kernel": 0.0, "plain": 0.0}
        sigmas, pre_ln_max = [], 0.0
        for (step, layer), (args, _) in sorted(steps.items()):
            runs = []
            for fn in (decode_step.fused_bert_self_step, decode_step.fused_bert_self_step_plain):
                a = _clone_tree(args)
                runs.append((fn(*a)[0], a[3], a[4]))
            y64, sigma = bert_self_step_f64(*_clone_tree(args))
            diff = (runs[0][0] - runs[1][0]).abs()
            err = float(diff.max())
            y_err = max(y_err, err)
            by_step[step] = max(by_step.get(step, 0.0), err)
            by_layer[layer] = max(by_layer.get(layer, 0.0), err)
            for name, (y, _, _) in zip(("kernel", "plain"), runs):
                to_f64[name] = max(to_f64[name], float((y.double() - y64).abs().max()))
            row = int(diff.max(dim=-1).values.argmax())
            # the difference before LayerNorm: each row's |dy| times its sigma
            pre_ln_max = max(pre_ln_max, float((diff.double().max(dim=-1).values * sigma).max()))
            if worst is None or err > worst[0]:
                worst = (err, step, layer, float(sigma[row]))
            sigmas.append(sigma)
            slot_err = max(slot_err, max_err(runs[0][1], runs[1][1]),
                           max_err(runs[0][2], runs[1][2]))
        sigma = torch.cat(sigmas)
        log(f"  fused_bert_self_step [m4c, {len(steps)} calls: {len(by_step)} steps x "
            f"{len(by_layer)} layers]: slots max|kernel-plain| {slot_err:.3e} (tol {SLOT_TOL:.0e})")
        # the worst call again with x eight times larger: a larger sigma, a
        # smaller LayerNorm gain on the same kind of rounding difference
        big = _clone_tree(steps[(worst[1], worst[2])][0])
        big = (big[0] * 8.0, *big[1:])
        scaled = max_err(decode_step.fused_bert_self_step(*_clone_tree(big))[0],
                         decode_step.fused_bert_self_step_plain(*_clone_tree(big))[0])
        def listed(errs):
            return json.dumps([float(f"{e:.3e}") for _, e in sorted(errs.items())])

        log(f"    max|kernel-plain| by step {listed(by_step)}, by layer {listed(by_layer)}; "
            f"against float64 with the context unrounded: kernel {to_f64['kernel']:.3e}, plain "
            f"{to_f64['plain']:.3e}; rows' pre-LayerNorm sigma min {float(sigma.min()):.4f}, "
            f"median {float(sigma.median()):.4f}, max {float(sigma.max()):.4f}; the worst "
            f"difference {worst[0]:.3e} at step {worst[1]}, layer {worst[2]}, in a row of sigma "
            f"{worst[3]:.4f}; max over rows of sigma x |dy| (the difference before LayerNorm) "
            f"{pre_ln_max:.3e}; that call with x x 8: {scaled:.3e}")
        if not slot_err <= SLOT_TOL:
            failures.append(f"[m4c kernels] fused_bert_self_step slots: max err {slot_err}")
        x, w, ctx, slot_k, slot_v, step, cb, scale, heads, eps = _clone_tree(args)
        bs, c_len, t_len = x.shape[0], ctx[0].shape[1], slot_k.shape[1]
        step_args = (x, w, ctx, slot_k, slot_v, step, cb, scale, heads, eps)
        y = decode_step.fused_bert_self_step(*_clone_tree(step_args))[0]
        kernel = lambda: decode_step.fused_bert_self_step(*step_args)  # noqa: E731
        record("fused_bert_self_step", f"m4c step {bs} x ctx {c_len} + {t_len} slots, "
               f"{heads} heads of {hd // heads} (library: none)", y_err, LN_TOL, kernel,
               lambda: decode_step.fused_bert_self_step_plain(*step_args),
               2.0 * bs * hd * 4 * hd + 4.0 * bs * (c_len + t_len) * hd,
               tensor_bytes(x, w, ctx, slot_k, slot_v, cb, y))
        # its time twice more, for the spread between measurements
        log("    fused_bert_self_step at this shape, twice more: " + "; ".join(
            f"call {median_ms(kernel):.4f} ms, device {device_ms(kernel)[0]:.4f} ms"
            for _ in range(2)))
    check_packed_calls(packed, "m4c", record)


def compare_scores(task, label, failures):
    """Teacher-forced scores of one dev batch on the kernel and the plain
    path, on the greedy prefix: the max |difference| over the unmasked
    scores within SCORE_TOL."""
    import torch

    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE

    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    valid = torch.from_numpy(host["sample_valid"]).to(batch["question_tokens"].device)
    model = task.model
    prev_inds = model.greedy_decode(batch)["prev_inds"]
    tf_k = model.compute_scores(batch, prev_inds)
    with plain_versions():
        tf_p = model.compute_scores(batch, prev_inds)
    unmasked = tf_p[valid] > MASK_VALUE / 2
    err = max_err(tf_k[valid][unmasked], tf_p[valid][unmasked])
    log(f"  [{label}] teacher-forced max|score kernel-plain| {err:.3e} (tol {SCORE_TOL:.0e})")
    if not bool(torch.isfinite(tf_k).all()) or not err <= SCORE_TOL:
        failures.append(f"[{label}] kernel vs plain scores: max diff {err} or non-finite")


def run_iterative_m4c(task, tmp, config, record, failures):
    """configs/iterative_m4c.yaml under OcrOpenEndedTask: the beam eval of the
    dev split (packed = 4 layers x T steps x batches, nothing else), one batch
    on the kernel and the plain route, the incremental mode against the
    context-blind quadratic one, the packed kernel at the path's shapes, then
    start() for one epoch and get_predictions()."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.ops import fused_attention
    from openvivqa_tpu_torch.training.decode import generate

    model, beam = task.model, task.evaluating_beam_size
    steps, n_layers = task.vocab.max_answer_length, len(model.encoder.layers)
    n_batches = len(task.dev_dict_dataloader)
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(exact_eval(task, "iterative_m4c beam", failures, exact_launches(
        fused_attention_packed=n_layers * steps * n_batches)))

    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    valid = torch.from_numpy(host["sample_valid"]).to(batch["question_tokens"].device)

    def run(**mode):
        """One batch's generate() under the mode's settings: (tokens,
        cumulative log-probs) of the valid samples and its ms."""
        saved = (model.decoding_mode, model.context_blind)
        model.decoding_mode = mode.get("decoding_mode", saved[0])
        model.context_blind = mode.get("context_blind", saved[1])
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            tokens, logprobs = generate(model, batch, beam)
            torch.cuda.synchronize()
            return tokens[valid], logprobs[valid].sum(-1), (time.perf_counter() - start) * 1e3
        finally:
            model.decoding_mode, model.context_blind = saved

    def agree(a, b, what):
        same = (a[0] == b[0]).all(-1)
        agreement = float((a[0] == b[0]).float().mean())
        diff = float((a[1] - b[1]).abs()[same].max()) if bool(same.any()) else 0.0
        log(f"  [iterative_m4c] {what}: token agreement {agreement * 100:.2f}% of "
            f"{a[0].numel()} tokens, max|cumulative log-prob diff| of the agreeing beams "
            f"{diff:.3e}; generate() {a[2]:.1f} ms vs {b[2]:.1f} ms")
        if agreement < 0.9:
            failures.append(f"[iterative_m4c] {what}: token agreement {agreement}")
        return diff

    packed = {}
    with capture_calls(fused_attention, "fused_attention_packed", packed_key, packed):
        kernel = run()
    with plain_versions():
        plain = run()
    diff = agree(kernel, plain, f"kernel vs plain route, one batch of {batch['question_tokens'].shape[0]}"
                 f" x beam {beam}")
    if not diff <= LOGPROB_TOL:
        failures.append(f"[iterative_m4c] kernel vs plain cumulative log-prob diff {diff}")
    with capture_calls(fused_attention, "fused_attention_packed", packed_key, packed):
        incremental = run(decoding_mode="incremental", context_blind=True)
    agree(incremental, run(context_blind=True),
          "incremental vs context-blind quadratic")
    check_packed_calls(packed, "iterative_m4c", record)

    train_task = build_task(config.merged({"TRAINING": {
        "MAX_EPOCHS": 1, "CHECKPOINT_PATH": str(Path(tmp) / "iterative_m4c_train")}}), "cuda")
    add(run_epoch(train_task, failures, "iterative_m4c train",
                  expected=("fused_attention_packed",)))
    return launches


def m4c_family_data(tmp, seed):
    """Phase 11's synthetic set: 120 images, 100 regions x 1024, 49 grids x
    2048, up to 100 OCR tokens."""
    from openvivqa_tpu_torch.data.synthetic import generate_synthetic_dataset

    return generate_synthetic_dataset(str(Path(tmp) / "m4c_family"), n_images=120,
                                      n_regions=100, n_grids=49, max_scene_text=100, seed=seed)


def m4c_family_task(paths, tmp, seed, config_file, label, model=None):
    """(config, task on the card) of one phase-11 config on `paths`."""
    from openvivqa_tpu_torch.builders import build_task

    config = with_data(config_file, paths, seed, str(Path(tmp) / label), model)
    if config.DATASET.VOCAB.TYPE == "OcrClassificationVocab":
        # mmf_lorra.yaml's vocab names FastText vectors that no module reads
        config = config.merged({"DATASET": {"VOCAB": {"WORD_EMBEDDING": None}}})
    return config, build_task(config, "cuda")


def run_m4c_family(tmp, seed, failures, record, paths=None):
    """Phase 11: m4c.yaml (standalone M4C, TrainingMMF) in both decode modes
    and trained, iterative_m4c.yaml (IterativeM4C, OcrOpenEndedTask), then
    small_mmf_improved_decoding_m4c, experimental_mmf_m4c, mmf_iterative_lorra
    (TrainingMMF) and mmf_lorra (MmfClassificationTask), each at its widths on
    one synthetic set (100 regions x 1024, 49 grids x 2048, up to 100 OCR
    tokens).  Returns the launch counts of the main-path runs."""
    import torch

    from openvivqa_tpu_torch.builders import build_task

    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    paths = paths or m4c_family_data(tmp, seed)

    def task_of(config_file, label, model=None):
        return m4c_family_task(paths, tmp, seed, config_file, label, model)

    # m4c.yaml: both decode modes, the kernels at its shapes, training
    start = time.perf_counter()
    config, quadratic = task_of("m4c.yaml", "m4c", NO_PRETRAINED)
    _, incremental = task_of("m4c.yaml", "m4c", {**NO_PRETRAINED, "DECODING_MODE": "incremental"})
    model = quadratic.model
    steps, n_batches = quadratic.vocab.max_answer_length, len(quadratic.dev_dict_dataloader)
    q_layers, layers = len(model.question_encoder.layer), len(model.encoder.layer)
    log(f"  [m4c] M4C, hidden {model.encoder.hidden_size}, {model.encoder.num_heads} heads, "
        f"{q_layers} question + {layers} joint layers, FFN "
        f"{model.encoder.layer[0].intermediate.dense.out_features}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters, "
        f"{len(quadratic.train_dataset)} train / {len(quadratic.dev_dict_dataset)} dev samples")
    add(run_mode(quadratic, "m4c quadratic", failures, [], exact_launches(
        fused_encoder_self_attention=q_layers * n_batches,
        fused_ffn_step=(q_layers + layers * steps) * n_batches,
        fused_attention_packed=layers * steps * n_batches)))
    add(run_mode(incremental, "m4c incremental", failures, [], exact_launches(
        fused_encoder_self_attention=(q_layers + layers) * n_batches,
        fused_ffn_step=(q_layers + layers + layers * steps) * n_batches,
        fused_bert_self_step=layers * steps * n_batches)))
    quadratic.model.context_blind = True
    compare_decode_modes(quadratic, incremental, failures, "m4c")
    quadratic.model.context_blind = False
    check_m4c_kernels(quadratic, incremental, record, failures)
    del quadratic, incremental, model
    torch.cuda.empty_cache()
    log("  m4c training: TrainingMMF.start() for one epoch, then get_predictions()")
    train_task = build_task(config.merged({"TRAINING": {
        "MAX_EPOCHS": 1, "CHECKPOINT_PATH": str(Path(tmp) / "m4c_train")}}), "cuda")
    add(run_training(train_task, failures, label="m4c train"))
    check_dropout_at_path_shapes(train_task, "m4c train", record, failures)
    del train_task
    torch.cuda.empty_cache()
    log(f"  [m4c] {time.perf_counter() - start:.1f} s")

    # iterative_m4c.yaml under OcrOpenEndedTask
    start = time.perf_counter()
    config, task = task_of("iterative_m4c.yaml", "iterative_m4c")
    log(f"  [iterative_m4c] IterativeM4C, d_model {task.model.vocab_proj.in_features}, "
        f"{len(task.model.encoder.layers)} layers, "
        f"{sum(p.numel() for p in task.model.parameters()) / 1e6:.2f}M parameters, beam "
        f"{task.evaluating_beam_size} over batches of {task.dev_dict_dataloader.batch_size}")
    add(run_iterative_m4c(task, tmp, config, record, failures))
    del task
    torch.cuda.empty_cache()
    log(f"  [iterative_m4c] {time.perf_counter() - start:.1f} s")

    # the other four: one dev eval with exact launches, the kernel vs plain
    # scores, the gradients of the train split
    for config_file, model_overrides in (
            ("small_mmf_improved_decoding_m4c.yaml", NO_PRETRAINED),
            ("experimental_mmf_m4c.yaml", NO_PRETRAINED),
            ("mmf_iterative_lorra.yaml", None), ("mmf_lorra.yaml", None)):
        start = time.perf_counter()
        name = config_file.removesuffix(".yaml")
        _, task = task_of(config_file, name, model_overrides)
        model = task.model
        arch = type(model).__name__
        log(f"  [{name}] {arch}, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
            "parameters")
        if arch == "MMF_LoRRA":
            # plain in the JAX package too: the registry attentions return their weights
            add(exact_eval(task, name, failures, exact_launches()))
            check_gradients(task, failures, name, no_gradient=LORRA_UNREAD)
        else:
            steps = task.vocab.max_answer_length
            n_batches = len(task.dev_dict_dataloader)
            mmt_layers = len(model.mmt.encoder.layer)
            text = 0 if arch == "MMF_IterativeLoRRA" else len(model.text_bert.encoder.layer)
            context = 1 if arch == "experimental_MMF_M4C" else 0  # txt_context_encoder
            add(exact_eval(task, name, failures, exact_launches(
                fused_encoder_self_attention=(text + context) * n_batches,
                fused_ffn_step=(text + context + mmt_layers * steps) * n_batches,
                fused_attention_packed=(context + mmt_layers * steps) * n_batches)))
            compare_scores(task, name, failures)
            check_gradients(task, failures, name)
        del task, model
        torch.cuda.empty_cache()
        log(f"  [{name}] {time.perf_counter() - start:.1f} s")
    return launches


# -- phase 12: the VLSP generative family, the cross-modality models, IterativeSAAA and
# ReadableIterativeMCAN ---------------------------------------------------------------------
VLSP_CONFIGS = ("unique_transformer.yaml", "cross_modality_transformer_vlsp.yaml",
                "visiolinguistic_transformer_vlsp.yaml", "extended_mcan_vlsp.yaml")
DUAL_CLASSIFIERS = ("cross_modality_transformer.yaml", "visiolinguistic_transformer.yaml")
TF_TOL = 1e-2  # teacher-forced log-probs of the generated tokens, kernel path vs plain path


def generative_launches(task) -> dict:
    """The exact launches of one beam dev eval of a phase-12 generator: each
    encoder attention once an encode (packed), the decoder's layer step
    once a layer and step; UniqueTransformer has no decoder and re-runs its
    encoder at every step instead (packed = layers x steps)."""
    model, config = task.model, task.config.MODEL
    steps, n_batches = task.vocab.max_answer_length, len(task.dev_dict_dataloader)
    if type(model).__name__ == "UniqueTransformer":
        return exact_launches(fused_attention_packed=len(model.encoder.layers) * steps * n_batches)
    encode = 0 if type(model).__name__ == "IterativeSAAA" else packed_per_batch(config)
    return exact_launches(fused_attention_packed=encode * n_batches,
                          fused_decoder_layer_step=steps * len(model.decoder.layers) * n_batches)


def one_train_step(task, label, failures):
    """One optimizer step on the first train batch (a finite loss), then the
    gradients of the train split (``check_gradients``)."""
    import torch

    _, batch = next(task.device_batches(task.train_dataloader))
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss = float(task._train_step(batch))
    seconds = time.perf_counter() - start
    log(f"  [{label}] one train step of {task.train_dataloader.batch_size}: loss {loss:.6f}, "
        f"{seconds * 1e3:.1f} ms by the host clock (first step)")
    if not math.isfinite(loss):
        failures.append(f"[{label}] train step: loss {loss}")
    check_gradients(task, failures, label)


def compare_generation(task, label, failures):
    """One dev batch through generate() on the kernel and the plain path:
    token agreement of the valid samples (at least 90 %), the cumulative
    log-probs of the beams that agree (within LOGPROB_TOL), both calls'
    times and a profiler table of the kernel path's; returns the packed
    kernel's calls captured on the kernel path, the batch and the kernel
    path's tokens."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention
    from openvivqa_tpu_torch.training.decode import generate

    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    valid = torch.from_numpy(host["sample_valid"]).to(task.device)
    beam = task.evaluating_beam_size
    packed = {}
    with capture_calls(fused_attention, "fused_attention_packed", packed_key, packed):
        tokens_k, logprobs_k = generate(task.model, batch, beam)
    with plain_versions():
        tokens_p, logprobs_p = generate(task.model, batch, beam)
    same = (tokens_k == tokens_p).all(-1) & valid
    agreement = float((tokens_k[valid] == tokens_p[valid]).float().mean())
    diff = max_err(logprobs_k[same].sum(-1), logprobs_p[same].sum(-1)) if bool(
        same.any()) else 0.0
    kernel_ms = median_ms(lambda: generate(task.model, batch, beam), reps=3)
    with plain_versions():
        plain_ms = median_ms(lambda: generate(task.model, batch, beam), reps=3)
    log(f"  [{label}] generate() of one batch of {valid.shape[0]} x beam {beam}, kernel vs "
        f"plain path: token agreement {agreement * 100:.2f}% of {tokens_k[valid].numel()} tokens, "
        f"{int(same.sum())} of {int(valid.sum())} samples equal; on those max|cumulative "
        f"log-prob diff| {diff:.3e} (tol {LOGPROB_TOL:.0e}); {kernel_ms:.2f} ms kernel path, "
        f"{plain_ms:.2f} ms plain path (CUDA-event medians of 3)")
    if agreement < 0.9:
        failures.append(f"[{label}] kernel vs plain token agreement {agreement} < 0.9")
    if not diff <= LOGPROB_TOL or not bool(torch.isfinite(logprobs_k).all()):
        failures.append(f"[{label}] kernel vs plain cumulative log-prob diff {diff} or non-finite")
    profile(lambda: generate(task.model, batch, beam), f"{label} beam decode")
    return packed, batch, tokens_k


def compare_teacher_forced(task, label, failures, batch, tokens):
    """Teacher forcing on a dev batch's generated `tokens` (after <bos>; a dev
    split holds no answer ids, and a train split's OCR copy ids are drawn at
    random) in eval, on the kernel and the plain path: the log-probs of the
    tokens themselves within TF_TOL.  Beside them, the whole (rows, T, V)
    distributions' max |difference|, the encoder output's, and the part the
    decoder adds on its own (both decoders on the plain path's encoder
    output): the bf16 attention's roundings compound through the encoder."""
    import torch

    model = task.model.eval()
    bos = torch.full_like(tokens[:, :1], task.vocab.bos_idx)
    answers = torch.cat([bos, tokens[:, :-1]], dim=1).long()
    with torch.no_grad():
        enc_k, bias = model.encode(batch)
        with plain_versions():
            enc_p, _ = model.encode(batch)
            out_p = model.decode_teacher_forced(answers, enc_p, bias)
        out_k = model.decode_teacher_forced(answers, enc_k, bias)
        decoder_only = max_err(model.decode_teacher_forced(answers, enc_p, bias), out_p)
    chosen = tokens.long()[..., None]
    err = max_err(out_k.gather(-1, chosen), out_p.gather(-1, chosen))
    log(f"  [{label}] teacher-forced log-probs of the {tuple(tokens.shape)} generated tokens, "
        f"kernel vs plain path: max|diff| {err:.3e} (tol {TF_TOL:.0e}); over the whole "
        f"{tuple(out_k.shape)} distributions {max_err(out_k, out_p):.3e}, of which the decoder "
        f"on one encoder output {decoder_only:.3e}; encoder output max|diff| "
        f"{max_err(enc_k, enc_p):.3e} (max|output| {float(enc_p.abs().max()):.2f})")
    if not err <= TF_TOL or not bool(torch.isfinite(out_k).all()):
        failures.append(f"[{label}] teacher-forced log-probs: max diff {err} or non-finite")


def run_phase12_generator(task, label, record, failures, unique=False):
    """One phase-12 generator: the beam dev eval with its exact launches and
    no plain call, kernel vs plain generate() and teacher-forced log-probs,
    the packed kernel at the shapes generate() gave it, the layer step at
    its beam rows and keys, then one train step and the train split's
    gradients (UniqueTransformer also one step's gradients on both paths,
    check_train_step).  Returns the eval's
    launches."""
    import torch

    from openvivqa_tpu_torch.training.decode import generate

    _, first = next(task.device_batches(task.dev_dict_dataloader))
    generate(task.model, first, task.evaluating_beam_size)  # first-call set-up, uncounted
    torch.cuda.synchronize()
    counts = exact_eval(task, label, failures, generative_launches(task))
    packed, batch, tokens = compare_generation(task, label, failures)
    compare_teacher_forced(task, label, failures, batch, tokens)
    check_packed_calls(packed, label, record)
    if not unique:
        check_layer_step_at(task, torch.Generator(device=task.device).manual_seed(12), record,
                            failures, f"{label}'s step")
    if unique:
        check_train_step(task, failures, label)
    one_train_step(task, label, failures)
    return counts


def run_phase12(evjvqa, main_paths, wide_paths, ocr_paths, tmp, seed, failures, record):
    """Phase 12, each config at its full widths: the four VLSP configs under
    VlspEvjVqaTask on the EVJVQA set, the two dual-stream classifiers on the
    2048-wide regions, iterative_saaa.yaml (TrainingSAAATask) on the main
    set, readable_iterative_mcan.yaml (OpenEndedTask) on the OCR set.
    Returns the launches of the dev evals."""
    import torch

    from openvivqa_tpu_torch.builders import build_task

    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    def describe(task, name):
        model = task.model
        core = next(m for m in model.modules()
                    if type(m).__name__ == "ScaledDotProductAttention")
        log(f"  [{name}] {type(model).__name__} under {type(task).__name__}, d_model "
            f"{core.d_model}, {core.h} heads of {core.d_k}, "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters, "
            f"{len(task.train_dataset)} train samples in batches of "
            f"{task.train_dataloader.batch_size}")

    for config_file in VLSP_CONFIGS:
        start = time.perf_counter()
        name = config_file.removesuffix(".yaml")
        task = build_task(with_joint(evjvqa, seed, str(Path(tmp) / name), config_file), "cuda")
        describe(task, name)
        add(run_phase12_generator(task, name, record, failures,
                                  unique=name == "unique_transformer"))
        del task
        torch.cuda.empty_cache()
        log(f"  [{name}] {time.perf_counter() - start:.1f} s")

    for config_file in DUAL_CLASSIFIERS:
        start = time.perf_counter()
        name = config_file.removesuffix(".yaml")
        task = build_task(with_classification(config_file, wide_paths, seed,
                                              str(Path(tmp) / name)), "cuda")
        describe(task, name)
        add(classification_eval(task, name, failures))
        compare_classification_paths(task, name, failures)
        check_packed_at_path_shapes(task, name, record, failures)
        one_train_step(task, name, failures)
        del task
        torch.cuda.empty_cache()
        log(f"  [{name}] {time.perf_counter() - start:.1f} s")

    for config_file, paths, features_only in (("iterative_saaa.yaml", main_paths, True),
                                              ("readable_iterative_mcan.yaml", ocr_paths, False)):
        start = time.perf_counter()
        name = config_file.removesuffix(".yaml")
        task = build_task(with_data(config_file, paths, seed, str(Path(tmp) / name),
                                    features_only=features_only), "cuda")
        describe(task, name)
        add(run_phase12_generator(task, name, record, failures))
        del task
        torch.cuda.empty_cache()
        log(f"  [{name}] {time.perf_counter() - start:.1f} s")
    return launches


# -- phase 13: the BERT-family backbones (vit_mbert_classification, vit_mbert_generation)
# and SCST ------------------------------------------------------------------------------------
def with_vit_mbert(config_file, paths, seed, checkpoint, **training):
    """``configs/<config_file>`` on the synthetic EVJVQA set at `paths`: its raw
    images for the classifier, its ViT-shaped store (``paths["vit"]``) for the
    generator; one epoch."""
    from openvivqa_tpu_torch.config import get_config

    classification = config_file == "vit_mbert_classification.yaml"
    features = {"FEATURES": None if classification else paths["vit"], "IMAGE": paths["images"]}
    sections = ("FEATURE_DATASET",) if classification else ("FEATURE_DATASET", "DICT_DATASET")
    dataset = {key: {"FEATURE_PATH": features} for key in sections}
    if classification:  # the flat schema's copy
        dataset["FEATURE_PATH"] = features
    test = paths["public_test"]
    return get_config(str(ROOT / "configs" / config_file)).merged({
        "DATASET": {**dataset,
                    "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": test,
                                  "PUBLIC_TEST": test, "PRIVATE_TEST": paths["private_test"]},
                    "VOCAB": {"JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                                            "TEST": test}}},
        "TRAINING": {"SEED": seed, "CHECKPOINT_PATH": checkpoint, "MAX_EPOCHS": 1, **training},
    })


def describe_vit_mbert(task, label, failures):
    """The model's shapes: mBERT's table, layers and heads, the frozen share;
    every backbone parameter frozen.  Returns mBERT's layer count."""
    model = task.model
    trainable = [n for n, p in model.named_parameters() if n.startswith(BACKBONES)
                 and p.requires_grad]
    if trainable or not any(n.startswith(BACKBONES) for n, _ in model.named_parameters()):
        failures.append(f"[{label}] backbone parameters missing or trainable: {trainable[:4]}")
    bert = model.text_embedding.backbone
    attention = bert.encoder.layer[0].attention
    frozen = sum(p.numel() for p in model.parameters() if not p.requires_grad)
    log(f"  [{label}] {type(model).__name__} under {type(task).__name__}: mBERT "
        f"{bert.embeddings.word_embeddings.num_embeddings} x {attention.hidden_size} x "
        f"{len(bert.encoder.layer)} layers, {attention.num_heads} heads of "
        f"{attention.hidden_size // attention.num_heads}, FFN "
        f"{bert.encoder.layer[0].intermediate.dense.out_features}; vision "
        f"{type(model.vision_encoder).__name__}; d_model {model.config.D_MODEL}; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters, "
        f"{frozen / 1e6:.2f}M frozen; {len(task.train_dataset)} train samples in batches of "
        f"{task.train_dataloader.batch_size}")
    return len(bert.encoder.layer)


def capture_kernel_calls(fn, calls):
    """Run `fn()` with kernels F's and C's and the packed entry's first call
    per shape captured into `calls` by kernel; returns fn's result."""
    from openvivqa_tpu_torch.ops import decode_step, encoder_layer, fused_attention

    with capture_calls(encoder_layer, "fused_encoder_self_attention",
                       lambda a: tuple(a[0].shape), calls.setdefault("F", {})), \
            capture_calls(decode_step, "fused_ffn_step", lambda a: (a[0].shape[0], a[1].shape[1]),
                          calls.setdefault("C", {})), \
            capture_calls(fused_attention, "fused_attention_packed", packed_key,
                          calls.setdefault("packed", {})):
        return fn()


# kernel F's out stage (out projection, bias, residual, LayerNorm on the kernel's
# own bf16 context) against float64: float32 sums of hd products in another
# order, scaled by the LayerNorm's 1 / std (2.8e-6 at most at ALBERT's weights)
F_OUT_TOL = 2e-5


def encoder_float64_stages(x, w, key_bias, scale, heads, eps):
    """Kernel F held stage by stage, each stage of the kernel against the
    float64 evaluation of that stage from the kernel's own input to it, with
    the kernel's bf16 roundings (x, q|k|v, the softmax weights, the context;
    only the sums exact), each within what its own roundings allow:
      qkv: the bf16 q|k|v against the exact products, within one bf16 ulp plus
        K 2^-23 times the sum of the products' magnitudes (the error bound of a
        K-term float32 sum under directed rounding: the tensor cores'
        accumulation);
      attention: the bf16 context against float64's from the kernel's q|k|v,
        within one ulp plus two softmax weights flipped by one bf16 ulp (2^-7
        of a weight) each, at the largest weight * |v| of the row;
      out: the output against float64's from the kernel's context, within
        F_OUT_TOL.
    Also counts the q|k|v elements that round to another bf16 value than the
    exact product (flips) for the kernel, the plain version (float32 SGEMM on
    the same bf16 operands) and cuBLAS's bf16 tensor-core product (the bias-free
    products), and what the kernel's and the plain version's q|k|v flips alone
    move the output (float64 from there on).  Returns (numbers by name,
    failures)."""
    import torch
    import torch.nn.functional as F

    from openvivqa_tpu_torch.ops import _cuda, encoder_layer
    from openvivqa_tpu_torch.ops.decode_step import _dot
    from openvivqa_tpu_torch.ops.fused_attention import attention_block

    b, s, hd = x.shape
    rows, d = b * s, hd // heads
    # kernel F's launch (encoder_layer._encoder_attention_launch) with its bf16
    # intermediates kept
    plans = encoder_layer.encoder_attention_plans(rows, hd)
    block = attention_block("encoder", s, s, d, d)
    floats = max(plans[0].partial_floats(rows, 3 * hd), plans[1].partial_floats(rows, hd), 1)
    xb, qkv, ctx = (torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
                    for n in (hd, 3 * hd, hd))
    partial = torch.empty(floats, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch("ovq_encoder_attention_forward", p(x), p(w["wqkv"]), p(w["bqkv"]), p(w["wo"]),
                 p(w["bo"]), p(w["ln_scale"]), p(w["ln_bias"]), p(key_bias), p(xb), p(qkv),
                 p(ctx), p(partial), p(y), b, s, hd, heads, int(block == "resident"),
                 *plans[0], *plans[1], scale, eps)
    torch.cuda.synchronize()

    def r(t):
        return t.to(torch.bfloat16).double()

    def ulp(t):
        """bf16's spacing at |t| (8 significant bits)."""
        return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs())[1] - 8)

    x64 = r(x.reshape(rows, hd))
    w64 = w["wqkv"].double()
    exact = x64 @ w64 + w["bqkv"].double()
    slack = hd * 2.0 ** -23 * (x64.abs() @ w64.abs() + w["bqkv"].double().abs())
    kernel_qkv = qkv.double()
    qkv_ratio = float(((kernel_qkv - exact).abs() / (ulp(exact.abs() + slack) + slack)).max())
    want_qkv = r(exact)

    def split(qkv64):
        return (part.reshape(b, s, heads, d) for part in qkv64.reshape(b, s, 3 * hd)
                .split(hd, dim=-1))

    def weights(q, k):
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                  + key_bias.double()[:, None, None])
        return r(torch.softmax(logits, dim=-1))

    def attend(qkv64):
        q, k, v = split(qkv64)
        return r(torch.einsum("bhqk,bkhd->bqhd", weights(q, k), v)).reshape(rows, hd)

    def finish(ctx64):
        out = ctx64 @ w["wo"].double() + w["bo"].double()
        return F.layer_norm(x.double().reshape(rows, hd) + out, (hd,),
                            w["ln_scale"].double(), w["ln_bias"].double(), eps)

    def err(a, b_):
        return float((a - b_).abs().max())

    q, k, v = split(kernel_qkv)
    probs = weights(q, k)
    from_kernel_qkv = r(torch.einsum("bhqk,bkhd->bqhd", probs, v)).reshape(rows, hd)
    top = (probs[..., None] * v.abs().permute(0, 2, 1, 3)[:, :, None]).amax(dim=3)
    top = top.permute(0, 2, 1, 3).reshape(rows, hd)  # (rows, hd): max_j p_j |v_j|
    context_ratio = float(((ctx.double() - from_kernel_qkv).abs()
                           / (ulp(from_kernel_qkv) + 2.0 ** -6 * top)).max())
    out_err = err(y.double().reshape(rows, hd), finish(ctx.double()))
    whole = finish(attend(want_qkv))
    plain_qkv = r(_dot(x.reshape(rows, hd), w["wqkv"]) + w["bqkv"])
    plain = encoder_layer.fused_encoder_self_attention_plain(x, w, key_bias, scale, heads, eps)
    cublas = torch.matmul(x.reshape(rows, hd).to(torch.bfloat16), w["wqkv"]).double()
    numbers = {
        "qkv elements": rows * 3 * hd,
        "qkv flips": int((kernel_qkv != want_qkv).sum()),
        "plain qkv flips": int((plain_qkv != want_qkv).sum()),
        "cuBLAS bf16 qkv flips": int((cublas != r(x64 @ w64)).sum()),
        # with a zero bias the kernel's q|k|v and cuBLAS's round the same sums
        "qkv unlike cuBLAS's": None if w["bqkv"].any() else int((kernel_qkv != cublas).sum()),
        "qkv / bound": qkv_ratio,
        "context flips": int((ctx.double() != from_kernel_qkv).sum()),
        "context / bound": context_ratio,
        "out": out_err,
        "carried": err(finish(from_kernel_qkv), whole),
        "plain carried": err(finish(attend(plain_qkv)), whole),
        "kernel": err(y.double().reshape(rows, hd), whole),
        "plain": err(plain.double().reshape(rows, hd), whole),
    }
    failures = [f"{stage} {value:.3e} past {bound}" for stage, value, bound in (
        ("q|k|v", qkv_ratio, "its bound"), ("context", context_ratio, "its bound"),
        ("out", out_err, f"F_OUT_TOL {F_OUT_TOL:.0e}")) if not value <= (
            F_OUT_TOL if stage == "out" else 1.0)]
    return numbers, failures


def check_backbone_calls(calls, label, record, failures, name="mBERT", attention=True,
                         ffn=True, by_stage=False):
    """Kernels F and C (the layers of the backbone `name`) and the packed entry
    against their plain versions on the captured calls' own inputs; the
    backbone's layers must have called F (`attention`) and C (`ffn`).  With
    `by_stage` (a backbone whose weights lie past BERT's 0.02 scale, where the
    tensor cores' q|k|v rounding flips move the output by more than LN_TOL) F
    is held stage by stage against float64 (``encoder_float64_stages``)."""
    import torch

    from openvivqa_tpu_torch.ops import decode_step, encoder_layer

    if (attention and not calls["F"]) or (ffn and not calls["C"]):
        failures.append(f"[{label}] kernel F or C was not called in the captured forward")
    with torch.no_grad():
        for (b, s, hd), (args, _) in sorted(calls["F"].items()):
            out = encoder_layer.fused_encoder_self_attention(*args)
            heads = args[4]
            plain = encoder_layer.fused_encoder_self_attention_plain(*args)
            what = f"{label} {name} {b} x {s}, {heads} heads of {hd // heads} (library: none)"
            record("fused_encoder_self_attention", what, max_err(out, plain),
                   None if by_stage else LN_TOL,
                   lambda a=args: encoder_layer.fused_encoder_self_attention(*a),
                   lambda a=args: encoder_layer.fused_encoder_self_attention_plain(*a),
                   2.0 * b * s * hd * 4 * hd + 4.0 * b * s * s * hd, tensor_bytes(args[:3], out))
            if by_stage:
                numbers, stage_failures = encoder_float64_stages(*args)
                log(f"    by stage against float64: {json.dumps(numbers)}")
                failures += [f"fused_encoder_self_attention [{what}]: {failure}"
                             for failure in stage_failures]
        for (rows, d_ff), (args, kwargs) in sorted(calls["C"].items()):
            out = decode_step.fused_ffn_step(*args, **kwargs)
            hd = args[0].shape[1]
            record("fused_ffn_step", f"{label} {name} {rows} rows, {hd} -> {d_ff}, eps "
                   f"{kwargs.get('eps', 1e-6):.0e} (library: none)",
                   max_err(out, decode_step.fused_ffn_step_plain(*args, **kwargs)), LN_TOL,
                   lambda a=args, k=kwargs: decode_step.fused_ffn_step(*a, **k),
                   lambda a=args, k=kwargs: decode_step.fused_ffn_step_plain(*a, **k),
                   4.0 * rows * hd * d_ff, tensor_bytes(args[:7], out))
    check_packed_calls(calls["packed"], label, record)


def counted_run(fn):
    """(result, launch counts, plain calls) of `fn()`, the counts set to 0
    just before it and read just after."""
    import torch

    from openvivqa_tpu_torch.ops import _cuda

    plain_calls = {}
    with count_plain_calls(plain_calls):
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = counts_now()
    return out, counts, plain_calls


def check_counts(label, counts, plain_calls, want, failures):
    """`want[name]` launches exactly, or, where want is None, at least one;
    no plain version called."""
    log(f"  [{label}] launches {json.dumps({k: v for k, v in counts.items() if v})}; plain "
        f"calls {json.dumps(plain_calls)}{rows_text()}")
    for name, n in want.items():
        if (counts[name] != n) if n is not None else counts[name] <= 0:
            failures.append(f"[{label}] {name}: {counts[name]} launches, want "
                            f"{'some' if n is None else n}")
    if plain_calls:
        failures.append(f"[{label}] plain versions were called: {plain_calls}")


def check_frozen_and_trainable(task, label, failures, before, frozen=True):
    """After optimizer steps from the weights `before`: every parameter with a
    gradient moved (the gradient-free biases excepted), the frozen backbones
    did not, and they have no gradient; with `frozen`, the model has some."""
    import torch

    moved, still, bad = 0, 0, []
    for name, p in task.model.named_parameters():
        same = bool(torch.equal(p.detach(), before[name]))
        if not p.requires_grad:
            still += 1
            if not same or p.grad is not None:
                bad.append(name)
        elif name.endswith(GRADIENT_FREE):
            continue
        elif same:
            bad.append(name)
        else:
            moved += 1
    log(f"  [{label}] after the steps: {moved} trainable parameter tensors moved, {still} frozen "
        "ones unchanged and without a gradient")
    if bad or (frozen and not still):
        failures.append(f"[{label}] unmoved trainable or moved frozen parameters: {bad[:8]}")


def run_vit_mbert_classification(evjvqa, tmp, seed, failures, record):
    """vit_mbert_classification.yaml under ClassificationTask at full widths:
    the dev eval with exact launches (per forward mBERT's F and C once a layer,
    the ViT's packed attention once a layer) and no plain call, kernel vs plain
    log-probs and argmax agreement, F, C and packed at the forward's shapes,
    one step's gradients on both paths, the train split's gradients, then
    start() for one epoch with exact launches and get_predictions()."""
    import torch

    from openvivqa_tpu_torch.builders import build_task

    label = "vit_mbert_classification"
    task = build_task(with_vit_mbert(f"{label}.yaml", evjvqa, seed, str(Path(tmp) / label)),
                      "cuda")
    layers = describe_vit_mbert(task, label, failures)
    vit_layers = len(task.model.vision_encoder.backbone.encoder.layer)

    def per_forward(n):
        return exact_launches(fused_encoder_self_attention=layers * n, fused_ffn_step=layers * n,
                              fused_attention_packed=vit_layers * n)

    _, first = next(task.device_batches(task.dev_dataloader))
    task.predict(first)  # first-call set-up, uncounted
    launches = dict(exact_eval(task, label, failures, per_forward(len(task.dev_dataloader))))
    compare_classification_paths(task, label, failures, relative=True)
    check_backbone_chains(label, text_backbone_chains(task.model, first), failures)
    calls = {}
    with torch.no_grad():
        capture_kernel_calls(lambda: task.model(first), calls)
    check_backbone_calls(calls, label, record, failures)
    check_train_step(task, failures, label)
    check_gradients(task, failures, label)

    _, train_counts, plain_calls = counted_run(task.start)
    check_counts(f"{label} start()", train_counts, plain_calls,
                 per_forward(len(task.train_dataloader) + len(task.dev_dataloader)), failures)
    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        losses = [x for r in map(json.loads, handle) if r["phase"] == "train"
                  for x in r["step_losses"]]
    log(f"  [{label}] start(), one epoch: per-step losses {json.dumps(losses)}")
    if len(losses) != len(task.train_dataloader) or not all(map(math.isfinite, losses)):
        failures.append(f"[{label}] epoch losses {losses}")
    scores = task.get_predictions()
    log(f"  [{label}] get_predictions(): {json.dumps(scores, default=float)}")
    if not math.isfinite(scores.get("CIDEr", math.nan)):
        failures.append(f"[{label}] no finite test CIDEr")
    for name, n in train_counts.items():
        launches[name] += n
    del task
    torch.cuda.empty_cache()
    return launches


def run_vit_mbert_generation(evjvqa, tmp, seed, failures, record):
    """vit_mbert_generation.yaml under VlspEvjVqaTask at full widths on the
    ViT-shaped store: the beam-3 dev eval with exact launches (mBERT's F and C
    once a layer a batch, the layer step steps x layers a batch) and no plain
    call, kernel vs plain generate() and teacher-forced log-probs, F, C and
    the layer step at the eval's shapes, one XE epoch and its dev eval
    (start()), the train split's gradients; then SCST (TRAINING.USE_SCST):
    ``_switch_to_scst()`` and one ``train_scst()`` epoch of 12 samples x 5
    beams with exact launches (mBERT twice a batch, the layer step in the beam
    draw, the packed entry in the teacher-forced re-run), finite losses and
    rewards, every parameter with a gradient moved and the frozen ones not,
    the re-run's kernels at its shapes, and a resume from last_model.pth with
    use_rl."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.training.decode import generate
    from openvivqa_tpu_torch.training.optim import make_optimizer, noam_lambda

    label = "vit_mbert_generation"
    config = with_vit_mbert(f"{label}.yaml", evjvqa, seed, str(Path(tmp) / label),
                            USE_SCST=True)
    task = build_task(config, "cuda")
    layers = describe_vit_mbert(task, label, failures)
    dec_layers, steps = len(task.model.decoder.layers), task.vocab.max_answer_length
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    generate(task.model, first, task.evaluating_beam_size)  # first-call set-up, uncounted
    n_eval = len(task.dev_dict_dataloader)
    launches = dict(exact_eval(task, label, failures, exact_launches(
        fused_encoder_self_attention=layers * n_eval, fused_ffn_step=layers * n_eval,
        fused_decoder_layer_step=steps * dec_layers * n_eval)))
    _, batch, tokens = compare_generation(task, label, failures)
    compare_teacher_forced(task, label, failures, batch, tokens)
    check_backbone_chains(label, text_backbone_chains(task.model, first), failures)
    calls = {}
    with torch.no_grad():
        capture_kernel_calls(lambda: task.model.encode(first), calls)
    check_backbone_calls(calls, f"{label} eval", record, failures)
    check_layer_step_at(task, torch.Generator(device=task.device).manual_seed(13), record,
                        failures, f"{label}'s step")

    # XE: one epoch and its dev eval, then the train split's gradients
    (_, xe_counts, plain_calls) = counted_run(task.start)
    check_counts(f"{label} xe start()", xe_counts, plain_calls,
                 {name: None for name in ("fused_encoder_self_attention", "fused_ffn_step",
                                          "fused_attention_packed", "fused_decoder_layer_step")},
                 failures)
    for name, n in xe_counts.items():
        launches[name] += n
    check_gradients(task, failures, label)

    # SCST: the switch, one epoch, its launches and the weights it moved
    task._switch_to_scst()
    lr = [g["lr"] for g in task.optimizer.param_groups]
    log(f"  [{label} scst] switched: best_model.pth reloaded, Adam afresh at {lr}, "
        f"{len(task.train_dict_dataloader)} batches of {task.train_dict_dataloader.batch_size} "
        f"samples x {task.training_beam_size} beams")
    if lr != [task.rl_learning_rate] * len(lr) or task.optimizer.state:
        failures.append(f"[{label} scst] the switch left lr {lr} or a used Adam state")
    # the beam draw's and the re-run's kernels at their shapes (zero
    # advantages: no update)
    calls = {}
    _, scst_first = next(task.device_batches(task.train_dict_dataloader))
    samples = capture_kernel_calls(lambda: task.scst_samples(scst_first), calls)
    capture_kernel_calls(lambda: task.scst_loss(scst_first, torch.zeros(
        samples.shape[:2], device=task.device), samples).backward(), calls)
    task.optimizer.zero_grad(set_to_none=True)
    check_backbone_calls(calls, f"{label} scst draw and re-run", record, failures)
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    n_scst = len(task.train_dict_dataloader)
    start = time.perf_counter()
    (loss, reward), scst_counts, plain_calls = counted_run(task.train_scst)
    seconds = time.perf_counter() - start
    check_counts(f"{label} scst epoch", scst_counts, plain_calls, exact_launches(
        fused_encoder_self_attention=2 * layers * n_scst, fused_ffn_step=2 * layers * n_scst,
        fused_decoder_layer_step=steps * dec_layers * n_scst,
        fused_attention_packed=2 * dec_layers * n_scst), failures)
    for name, n in scst_counts.items():
        launches[name] += n
    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        record_ = [r for r in map(json.loads, handle) if r["phase"] == "scst"][-1]
    log(f"  [{label} scst] one train_scst() epoch: {seconds:.2f} s by the host clock, mean loss "
        f"{loss:.6f}, mean reward {reward:.6f}; per step losses "
        f"{json.dumps(record_['step_losses'])}, rewards {json.dumps(record_['step_rewards'])}")
    values = record_["step_losses"] + record_["step_rewards"]
    if len(record_["step_losses"]) != n_scst or not all(map(math.isfinite, values)):
        failures.append(f"[{label} scst] step losses or rewards missing or non-finite")
    check_frozen_and_trainable(task, f"{label} scst", failures, before)

    # a resume with use_rl: Adam's step continues at the RL rate
    task.save_checkpoint({"best_val_score": 0.0, "patience": 0, "use_rl": True})
    steps_before = {int(s["step"]) for s in task.optimizer.state.values()}
    task.optimizer, task.scheduler = make_optimizer(
        task.model.parameters(), config.TRAINING.LEARNING_RATE,
        noam_lambda(config.MODEL.D_MODEL, config.TRAINING.WARMUP))
    meta = task.load_checkpoint(str(Path(task.checkpoint_path) / "last_model.pth"))
    task._switch_to_scst(resume=True)
    task.train_dict_dataloader = [next(iter(task.train_dict_dataloader))]
    task.train_scst()
    steps_after = {int(s["step"]) for s in task.optimizer.state.values()}
    lr = {g["lr"] for g in task.optimizer.param_groups}
    log(f"  [{label} scst] resumed from last_model.pth (use_rl {meta['use_rl']}): Adam steps "
        f"{sorted(steps_before)} -> {sorted(steps_after)} after one more step, lr {sorted(lr)}")
    if steps_after != {n + 1 for n in steps_before} or lr != {task.rl_learning_rate}:
        failures.append(f"[{label} scst] resume: steps {steps_before} -> {steps_after}, lr {lr}")
    del task
    torch.cuda.empty_cache()
    return launches


def run_phase13(evjvqa, tmp, seed, failures, record):
    """Phase 13: the BERT-family configs at full widths on the EVJVQA set (its
    images; a ViT-shaped store written beside them), and SCST on the
    generator.  Returns the launches of the counted runs."""
    from openvivqa_tpu_torch.data.synthetic import write_vit_features

    evjvqa = dict(evjvqa, vit=str(Path(tmp) / "evjvqa_vit"))
    write_vit_features(evjvqa["vit"], len(os.listdir(evjvqa["images"])), seed)
    launches = {}
    for run in (run_vit_mbert_classification, run_vit_mbert_generation):
        start = time.perf_counter()
        for name, n in run(evjvqa, tmp, seed, failures, record).items():
            launches[name] = launches.get(name, 0) + n
        log(f"  [{run.__name__}] {time.perf_counter() - start:.1f} s")
    return launches


# -- phase 14: ALBERT and DeBERTa, the AdaptiveDecoder with its frozen language model, the
# plain-torch modules -----------------------------------------------------------------------
TEXT_BACKBONES = {
    "albert": {"ARCHITECTURE": "AlbertEmbedding", "PRETRAINED_NAME": "albert-base-v2"},
    "deberta": {"ARCHITECTURE": "DebertaEmbedding",
                "PRETRAINED_NAME": "microsoft/deberta-v3-base"},
}
ADAPTIVE_LM = {"ARCHITECTURE": "BERTModel", "D_MODEL": 512, "D_PRETRAINED_FEATURE": 768,
               "PRETRAINED_LAYERS": 12, "PRETRAINED_NAME": "bert-base-uncased", "DROPOUT": 0.1}


def check_backbone_chains(label, chains, failures):
    """Each frozen backbone's own output, kernel vs plain path, relative to its
    magnitude and held to ENCODER_RTOL (2^-5, as phase 8 holds the mT5
    encoder): `chains` maps a name to (backbone module, a callable running
    the model part around it), the output taken by a forward hook."""
    import torch

    for name, (backbone, run) in chains.items():
        outs = []
        for plain in (False, True):
            captured = []
            handle = backbone.register_forward_hook(
                lambda m, i, o, c=captured: c.append(o.detach().float().clone()))
            try:
                with torch.no_grad(), plain_versions() if plain else contextlib.nullcontext():
                    run()
            finally:
                handle.remove()
            outs.append(captured[0])
        err, top = max_err(*outs), float(outs[1].abs().max())
        log(f"  [{label}] {name} backbone output {tuple(outs[0].shape)}, kernel vs plain path: "
            f"max|diff| {err:.3e}, max|output| {top:.3f}: max|diff| / max|output| "
            f"{err / top:.3e} (tol 2^-5)")
        if not err / top <= ENCODER_RTOL or not bool(torch.isfinite(outs[0]).all()):
            failures.append(f"[{label}] {name} backbone kernel vs plain: {err / top} > "
                            f"{ENCODER_RTOL} or non-finite")


def text_backbone_chains(model, batch):
    """The ViT (on pixels) and the text backbone of a ViT-backed model."""
    from openvivqa_tpu_torch.models.vit_models import _question_input

    tokens, pad, mask = _question_input(batch, model.config.TEXT_EMBEDDING)
    chains = {}
    if "pixel_values" in batch:
        chains["ViT"] = (model.vision_encoder.backbone,
                         lambda: model.vision_encoder(batch["pixel_values"]))
    chains[type(model.text_embedding.backbone).__name__] = (
        model.text_embedding.backbone, lambda: model.text_embedding(tokens, None, pad, mask))
    return chains


def capture_text_calls(fn, calls):
    """Run `fn()` with kernels F and C, the two-bias and the packed entries'
    first call per shape captured into `calls`; returns fn's result."""
    from openvivqa_tpu_torch.ops import decode_step, encoder_layer, fused_attention

    with capture_calls(fused_attention, "fused_attention_packed_2bias",
                       lambda a: (tuple(a[0].shape), tuple(a[4].shape)),
                       calls.setdefault("2bias", {})):
        return capture_kernel_calls(fn, calls)


def check_two_bias_calls(calls, label, record):
    """The two-bias entry against its plain version on each captured DeBERTa
    call (a (b, 1, 1, L) padding bias, the per-sample disentangled terms as
    the (b, h, L, L) head bias, hb = b), beside one float32 SDPA call with the
    two summed into its mask."""
    import torch

    from openvivqa_tpu_torch.ops import fused_attention

    kernel, plain = fused_attention.fused_attention_packed_2bias, \
        fused_attention.fused_attention_packed_2bias_plain
    with torch.no_grad():
        for ((b, n, hd), hb_shape), (args, _) in sorted(calls.items()):
            q, k, v, bias, head_bias, scale, heads = args
            out = kernel(*args)
            mask = (head_bias + bias).contiguous()
            record("fused_attention_packed_2bias",
                   f"{label} DeBERTa {b} x {n}, {heads} heads of {hd // heads}, head bias "
                   f"{hb_shape} (hb = b), padding bias {tuple(bias.shape)}",
                   max_err(out, plain(*args)), ATTN_TOL, lambda a=args: kernel(*a),
                   lambda a=args: plain(*a), 4.0 * b * heads * n * n * (hd // heads),
                   tensor_bytes(q, k, v, bias, head_bias, out),
                   sdpa_library(q, k, v, mask, scale, heads))


def run_text_backbone(evjvqa, tmp, seed, failures, record, family):
    """vit_mbert_classification.yaml with TEXT_EMBEDDING an ALBERT
    (albert-base-v2) or DeBERTa (deberta-v3-base) wrapper at full width: the
    dev eval with exact launches (ALBERT: F once a layer a forward; DeBERTa:
    the two-bias entry and C once a layer a forward; the ViT's packed
    attention once a layer) and no plain call, kernel vs plain log-probs and
    argmax agreement, each backbone chain within 2^-5, the text kernels at
    the forward's shapes, one step's gradients on both paths and the train
    split's (none on a frozen backbone)."""
    import torch

    from openvivqa_tpu_torch.builders import build_task

    label = f"vit_{family}_classification"
    config = with_vit_mbert("vit_mbert_classification.yaml", evjvqa, seed,
                            str(Path(tmp) / label)).merged(
        {"MODEL": {"TEXT_EMBEDDING": TEXT_BACKBONES[family]}})
    task = build_task(config, "cuda")
    model = task.model
    backbone = model.text_embedding.backbone
    layers = len(backbone.schedule()) if family == "albert" else len(backbone.encoder.layer)
    vit_layers = len(model.vision_encoder.backbone.encoder.layer)
    frozen = sum(p.numel() for p in model.parameters() if not p.requires_grad)
    trainable = [n for n, p in model.named_parameters()
                 if n.startswith(BACKBONES) and p.requires_grad]
    log(f"  [{label}] {type(model.text_embedding).__name__} ({type(backbone).__name__}: "
        f"{backbone.embeddings.word_embeddings.num_embeddings} rows x "
        f"{backbone.embeddings.word_embeddings.embedding_dim}, {layers} layers) beside ViT-base; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters, "
        f"{frozen / 1e6:.2f}M frozen; {len(task.train_dataset)} train samples")
    if trainable:
        failures.append(f"[{label}] trainable backbone parameters: {trainable[:4]}")

    def per_forward(n):
        text = ({"fused_encoder_self_attention": layers * n} if family == "albert" else
                {"fused_attention_packed_2bias": layers * n, "fused_ffn_step": layers * n})
        return exact_launches(fused_attention_packed=vit_layers * n, **text)

    _, first = next(task.device_batches(task.dev_dataloader))
    task.predict(first)  # first-call set-up, uncounted
    launches = dict(exact_eval(task, label, failures, per_forward(len(task.dev_dataloader))))
    compare_classification_paths(task, label, failures, relative=True)
    check_backbone_chains(label, text_backbone_chains(model, first), failures)
    calls = {}
    with torch.no_grad():
        capture_text_calls(lambda: model(first), calls)
    if family == "albert":
        # ALBERT's layers at the JAX package's lecun-normal law (std 0.036 at 768
        # in, 0.088 at the 128-wide mapping), past BERT's 0.02
        check_backbone_calls(calls, label, record, failures, name="ALBERT", ffn=False,
                             by_stage=True)
    else:
        check_two_bias_calls(calls["2bias"], label, record)
        check_backbone_calls(calls, label, record, failures, name="DeBERTa", attention=False)
    check_packed_calls(calls["packed"], label, record)
    check_train_step(task, failures, label)
    check_gradients(task, failures, label)
    del task, model
    torch.cuda.empty_cache()
    return launches


def adaptive_config(paths, seed, checkpoint):
    """configs/iterative_mcan.yaml with MODEL.DECODER an AdaptiveDecoder: the
    config's own decoder widths (512, 8 heads of 64), its adaptive layer's
    self-attention on AdaptiveScaledDotProductAttention, LANGUAGE_MODEL a
    BERTModel at bert-base widths (768, 12 layers)."""
    config = with_data("iterative_mcan.yaml", paths, seed, checkpoint, features_only=True)
    attention = config.MODEL.DECODER.ATTENTION.to_dict()
    adaptive = dict(attention, SELF_ATTENTION=dict(
        attention["SELF_ATTENTION"], ARCHITECTURE="AdaptiveScaledDotProductAttention"))
    return config.merged({"MODEL": {"DECODER": {
        "ARCHITECTURE": "AdaptiveDecoder", "ADAPTIVE_ATTENTION": adaptive,
        "LANGUAGE_MODEL": ADAPTIVE_LM}}, "TRAINING": {"MAX_EPOCHS": 1}})


def run_adaptive(paths, tmp, seed, failures, record):
    """IterativeMCAN with the AdaptiveDecoder at full widths: the beam-3 dev
    eval with exact decode launches (a step: the layer step per ordinary
    layer; the language model on the step's token, F and C per backbone layer
    and F and C in its own layer; kernels B and C in the adaptive layer) and
    no plain call; kernel vs plain generate() and teacher-forced log-probs;
    the LM backbone within 2^-5; F, C and the layer step at the decode's
    shapes; one XE epoch (start()) and the train split's gradients (none on
    the frozen backbone, none on the LM's unread head)."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.models.modules.masks import padding_bias
    from openvivqa_tpu_torch.training.decode import generate

    label = "adaptive"
    task = build_task(adaptive_config(paths, seed, str(Path(tmp) / label)), "cuda")
    decoder = task.model.decoder
    lm = decoder.language_model
    lm_layers = len(lm.backbone.encoder.layer)
    ordinary, steps = len(decoder.layers) - 1, task.vocab.max_answer_length
    log(f"  [{label}] IterativeMCAN + AdaptiveDecoder: {ordinary} + 1 adaptive layers of "
        f"{decoder.d_model}, {decoder.layers[-1].self_attn.attention.h} heads; {type(lm).__name__} "
        f"{lm.backbone.embeddings.word_embeddings.num_embeddings} rows x "
        f"{lm.backbone.embeddings.word_embeddings.embedding_dim} x {lm_layers} layers (frozen) + "
        f"one trainable layer of {lm.proj.out_features}; "
        f"{sum(p.numel() for p in task.model.parameters()) / 1e6:.2f}M parameters")
    _, first = next(task.device_batches(task.dev_dict_dataloader))
    generate(task.model, first, task.evaluating_beam_size)  # first-call set-up, uncounted
    n = len(task.dev_dict_dataloader)
    decode = steps * n
    want = exact_launches(
        fused_decoder_layer_step=ordinary * decode,
        fused_encoder_self_attention=(lm_layers + 1) * decode,
        fused_ffn_step=(lm_layers + 2) * decode, fused_cross_attention_step=decode)
    want["fused_attention_packed"] = None  # the encoders'
    (scores, counts, plain_calls) = counted_run(
        lambda: task.evaluate_metrics(task.dev_dict_dataloader))
    log(f"  [{label}] beam-{task.evaluating_beam_size} dev eval ({n} batches): scores "
        f"{json.dumps(scores, default=float)}")
    check_counts(f"{label} dev eval", counts, plain_calls, want, failures)
    if not math.isfinite(scores.get("CIDEr", math.nan)):
        failures.append(f"[{label}] no finite dev CIDEr")
    launches = dict(counts)
    _, batch, tokens = compare_generation(task, label, failures)
    compare_teacher_forced(task, label, failures, batch, tokens)
    answers = torch.cat([torch.full_like(tokens[:, :1], task.vocab.bos_idx),
                         tokens[:, :-1]], dim=1).long()
    check_backbone_chains(label, {"frozen LM (BERT-base)": (lm.backbone, lambda: lm(answers))},
                          failures)
    calls = {}
    with torch.no_grad():
        capture_kernel_calls(lambda: generate(task.model, first, task.evaluating_beam_size),
                             calls)
    check_backbone_calls(calls, f"{label} decode", record, failures, name="frozen LM")
    check_layer_step_at(task, torch.Generator(device=task.device).manual_seed(17), record,
                        failures, f"{label}'s step")

    (_, xe_counts, plain_calls) = counted_run(task.start)
    check_counts(f"{label} xe start()", xe_counts, plain_calls,
                 {name: None for name in ("fused_encoder_self_attention", "fused_ffn_step",
                                          "fused_attention_packed", "fused_decoder_layer_step",
                                          "fused_cross_attention_step")}, failures)
    with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
        losses = [x for r in map(json.loads, handle) if r["phase"] == "train"
                  for x in r["step_losses"]]
    log(f"  [{label}] start(), one XE epoch: per-step losses {json.dumps(losses)}")
    if len(losses) != len(task.train_dataloader) or not all(map(math.isfinite, losses)):
        failures.append(f"[{label}] epoch losses {losses}")
    for name, count in xe_counts.items():
        launches[name] += count
    check_gradients(task, failures, label, no_gradient=("decoder.language_model.head.",))
    del task, decoder, lm
    torch.cuda.empty_cache()
    return launches


def run_plain_modules(seed, failures):
    """The modules the JAX package runs without a kernel, one forward each on
    the card at d_model 512 with 8 heads (64 samples of 50 tokens with
    boxes), against the same module's float32 forward on the CPU: the
    geometry, memory and adaptive cores in MultiHeadAttention (the AoA gates
    on the adaptive one), the GeometricEncoder (two layers),
    SpatialCirclePosition and TextSemanticSeparate."""
    import torch

    from openvivqa_tpu_torch.builders import build_attention, build_encoder
    from openvivqa_tpu_torch.config import ConfigNode
    from openvivqa_tpu_torch.models.modules.attentions import MultiHeadAttention
    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.models.modules.scp_tss import TextSemanticSeparate

    gen = torch.Generator().manual_seed(seed)
    b, n, d = 64, 50, 512
    x = torch.randn((b, n, d), generator=gen)
    xy = torch.rand((b, n, 2), generator=gen) * 0.6
    boxes = torch.cat([xy, xy + 0.05 + 0.35 * torch.rand((b, n, 2), generator=gen)], dim=-1)
    bias = torch.where(torch.rand((b, 1, 1, n), generator=gen) < 0.2, MASK_VALUE, 0.0)
    bias[..., 0] = 0.0

    def attention(arch, **extra):
        return {"ARCHITECTURE": arch, "HEAD": 8, "D_MODEL": d, "D_KEY": 64, "D_VALUE": 64,
                "D_FF": 2048, "USE_AOA": False, "CAN_BE_STATEFUL": False, "DROPOUT": 0.1,
                **extra}

    cases = {
        "AugmentedGeometryScaledDotProductAttention": (MultiHeadAttention(ConfigNode(attention(
            "AugmentedGeometryScaledDotProductAttention", TRIGNOMETRIC_EMBEDDING=True))),
            (x, x, x, bias), {"boxes": boxes}),
        "AugmentedMemoryScaledDotProductAttention": (MultiHeadAttention(ConfigNode(attention(
            "AugmentedMemoryScaledDotProductAttention", MEMORY=40))), (x, x, x, bias), {}),
        "AdaptiveScaledDotProductAttention + AoA": (MultiHeadAttention(ConfigNode(attention(
            "AdaptiveScaledDotProductAttention", USE_AOA=True))), (x, x, x, bias),
            {"language_signals": torch.randn((b, n, d), generator=gen)}),
        "GeometricEncoder": (build_encoder(ConfigNode({
            "ARCHITECTURE": "GeometricEncoder", "D_MODEL": d, "LAYERS": 2,
            "SELF_ATTENTION": attention("AugmentedGeometryScaledDotProductAttention",
                                        TRIGNOMETRIC_EMBEDDING=True)})), (x, boxes, bias), {}),
        "SpatialCirclePosition": (build_attention(ConfigNode(attention(
            "SpatialCirclePosition", NUM_DISTANCE=16))), (x, boxes, bias), {}),
        "TextSemanticSeparate": (TextSemanticSeparate(ConfigNode({"D_MODEL": d})),
                                 (x, x.flip(1), x.roll(1, 1), x * 0.5), {}),
    }
    for name, (module, args, kwargs) in cases.items():
        module = module.eval()
        with torch.no_grad():
            want = module(*args, **kwargs)
            module.cuda()
            start = time.perf_counter()
            got = module(*(a.cuda() for a in args), **{k: v.cuda() for k, v in kwargs.items()})
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        err, top = max_err(got.cpu(), want), float(want.abs().max())
        log(f"  [plain modules] {name}: {tuple(got.shape)} on {got.device}, {seconds * 1e3:.2f} ms "
            f"(first call, host clock); max|card - CPU| {err:.3e} of max|x| {top:.2f}")
        if got.device.type != "cuda" or not err <= 1e-3 * max(top, 1.0):
            failures.append(f"[plain modules] {name}: on {got.device}, card vs CPU {err}")
        del module
    torch.cuda.empty_cache()


def run_phase14(evjvqa, paths, tmp, seed, failures, record):
    """Phase 14: ALBERT and DeBERTa under ViTmBERTClassification on the EVJVQA
    images, the AdaptiveDecoder under IterativeMCAN on phase 4's data, the
    plain-torch modules.  Returns the launches of the counted runs."""
    launches = {}
    runs = [(f"{family} classifier", lambda f=family: run_text_backbone(
        evjvqa, tmp, seed, failures, record, f)) for family in TEXT_BACKBONES]
    runs.append(("adaptive decoder", lambda: run_adaptive(paths, tmp, seed, failures, record)))
    runs.append(("plain modules", lambda: run_plain_modules(seed, failures) or {}))
    for name, run in runs:
        start = time.perf_counter()
        for kernel, n in run().items():
            launches[kernel] = launches.get(kernel, 0) + n
        log(f"  [phase 14, {name}] {time.perf_counter() - start:.1f} s")
    return launches


# -- small_mmf_m4c beside phase 4, the SCST epochs of phase 13 --------------------------------
def run_small_mmf_m4c(paths, tmp, seed, failures):
    """configs/small_mmf_m4c.yaml (TextBert and MMT of 4 layers at 512, 8 heads)
    on phase 4's data: the dev eval in both decode modes with exact launches
    (quadratic: F once a TextBert layer, C once a TextBert layer and once an
    MMT layer a step, packed once an MMT layer a step; incremental: F and C
    over the MMT context once a layer too, D once an MMT layer a step) and the
    kernel vs plain checks of phase 4, then one step's gradients on both paths
    and the train split's."""
    import torch

    from openvivqa_tpu_torch.builders import build_task

    config = with_data("small_mmf_m4c.yaml", paths, seed, str(Path(tmp) / "small_mmf_m4c"))
    launches = {}
    for mode in ("quadratic", "incremental"):
        task = build_task(config.merged({"MODEL": {"DECODING_MODE": "incremental"}})
                          if mode == "incremental" else config, "cuda")
        model = task.model
        text, mmt = len(model.text_bert.encoder.layer), len(model.mmt.encoder.layer)
        steps, n = task.vocab.max_answer_length, len(task.dev_dict_dataloader)
        if mode == "quadratic":
            exact = {"fused_encoder_self_attention": n * text,
                     "fused_ffn_step": n * (text + mmt * steps),
                     "fused_attention_packed": n * mmt * steps}
            log(f"  [small_mmf_m4c] hidden {model.hidden_size}, {model.num_heads} heads, {text} "
                f"TextBert + {mmt} MMT layers, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
                f"M parameters; {n} dev batches x {steps} steps")
        else:
            exact = {"fused_encoder_self_attention": n * (text + mmt),
                     "fused_ffn_step": n * (text + mmt + mmt * steps),
                     "fused_bert_self_step": n * mmt * steps}
        counts = run_mode(task, f"small_mmf_m4c {mode}", failures, list(exact), exact)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        if mode == "quadratic":
            check_train_step(task, failures, "small_mmf_m4c", check_grads=True)
        del task, model
        torch.cuda.empty_cache()
    return launches


SCST_RUNS = (  # config, data set, features only, the kernels its beam draw and re-run launch
    ("iterative_mcan.yaml", "main", True, ("fused_attention_packed", "fused_decoder_layer_step")),
    ("iterative_m4c.yaml", "ocr", False, ("fused_attention_packed",)),
    ("iterative_saaa.yaml", "main", True, ("fused_decoder_layer_step",)),
)


def run_scst_epochs(datasets, tmp, seed, failures):
    """One short train_scst() epoch (two batches of the train split, 12 samples
    x 5 beams each) under OpenEndedTask (IterativeMCAN), OcrOpenEndedTask
    (IterativeM4C) and TrainingSAAATask (IterativeSAAA), with the checks of
    ViTmBERTGeneration's: the switch (Adam afresh at the RL rate), the epoch's
    launches and no plain call, finite losses and rewards, every trainable
    parameter with a gradient moved and no frozen one, a resume with use_rl."""
    import itertools

    import torch

    from openvivqa_tpu_torch.builders import build_task

    launches = {}
    for config_file, data, features_only, kernels in SCST_RUNS:
        start = time.perf_counter()
        name = config_file.removesuffix(".yaml")
        label = f"{name} scst"
        config = with_data(config_file, datasets[data], seed, str(Path(tmp) / label),
                           features_only=features_only).merged({"TRAINING": {"USE_SCST": True}})
        task = build_task(config, "cuda")
        task._switch_to_scst()
        lr = [g["lr"] for g in task.optimizer.param_groups]
        if lr != [task.rl_learning_rate] * len(lr) or task.optimizer.state:
            failures.append(f"[{label}] the switch left lr {lr} or a used Adam state")
        task.train_dict_dataloader = list(itertools.islice(task.train_dict_dataloader, 2))
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        (loss, reward), counts, plain_calls = counted_run(task.train_scst)
        check_counts(label, counts, plain_calls, {k: None for k in kernels}, failures)
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
        with open(Path(task.checkpoint_path) / "metrics.jsonl") as handle:
            record_ = [r for r in map(json.loads, handle) if r["phase"] == "scst"][-1]
        log(f"  [{label}] {type(task.model).__name__} under {type(task).__name__}, "
            f"{len(task.train_dict_dataloader)} batches of "
            f"{task.train_dict_dataloader[0]['question_tokens'].shape[0]} samples x "
            f"{task.training_beam_size} beams at lr {lr[0]}: mean loss {loss:.6f}, mean reward "
            f"{reward:.6f}; per step losses {json.dumps(record_['step_losses'])}, rewards "
            f"{json.dumps(record_['step_rewards'])}")
        values = record_["step_losses"] + record_["step_rewards"]
        if len(record_["step_losses"]) != 2 or not all(map(math.isfinite, values)):
            failures.append(f"[{label}] step losses or rewards missing or non-finite")
        check_frozen_and_trainable(task, label, failures, before, frozen=False)
        task.save_checkpoint({"best_val_score": 0.0, "patience": 0, "use_rl": True})
        steps_before = {int(s["step"]) for s in task.optimizer.state.values()}
        meta = task.load_checkpoint(str(Path(task.checkpoint_path) / "last_model.pth"))
        task._switch_to_scst(resume=True)
        task.train_dict_dataloader = task.train_dict_dataloader[:1]
        task.train_scst()
        steps_after = {int(s["step"]) for s in task.optimizer.state.values()}
        lr = {g["lr"] for g in task.optimizer.param_groups}
        log(f"  [{label}] resumed (use_rl {meta['use_rl']}): Adam steps {sorted(steps_before)} -> "
            f"{sorted(steps_after)}, lr {sorted(lr)}; {time.perf_counter() - start:.1f} s")
        if steps_after != {n + 1 for n in steps_before} or lr != {task.rl_learning_rate}:
            failures.append(f"[{label}] resume: steps {steps_before} -> {steps_after}, lr {lr}")
        del task
        torch.cuda.empty_cache()
    return launches

# -- phase 15: scale-out ---------------------------------------------------------------------
DROPOUT_PAIR = ("fused_attention_packed_dropout", "fused_attention_packed_dropout_backward")
RANK_JOIN_SECONDS = 300  # phase 15 (d): the two ranks' own time limit


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def seed_samples_by_index(task) -> None:
    """Each sample of the task's datasets draws numpy's global generator (an
    answer word both in the vocab and among the OCR tokens takes either index,
    the reference's rule) from a seed of its own index, so that a sample is
    the same whichever process and batch read it (with one loader worker: the
    generator is global to the process)."""
    import numpy as np

    def seeded(getitem):
        def draw(index):
            np.random.seed(int(index))
            return getitem(index)
        return draw

    for name, dataset in vars(task).items():
        if name.endswith("_dataset") and dataset is not None:
            dataset.__getitem__ = seeded(dataset.__getitem__)


def set_dropout(task, rate: float) -> None:
    """Every module dropout rate of the task's model (the BERT layers' fixed
    0.1 and the embeddings' configured ones)."""
    for module in task.model.modules():
        if isinstance(getattr(module, "dropout", None), float):
            module.dropout = rate


def full_tensor(tensor):
    return tensor.full_tensor() if hasattr(tensor, "full_tensor") else tensor


def step_backward(task, batch, seed=1234):
    """One step's loss and backward (no optimizer step), the generator seeded
    with `seed` unless it is None: (loss, {name: whole gradient}, peak GB, the
    step's own GB above what was allocated before it)."""
    import torch

    if seed is not None:
        task.generator.manual_seed(seed)
    task.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = task.train_forward(task.compute_loss, batch)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    grads = {name: full_tensor(p.grad).detach().clone()
             for name, p in task.model.named_parameters() if p.grad is not None}
    task.optimizer.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, peak / 1e9, (peak - before) / 1e9


def grad_rel(got, want) -> dict:
    """max |got - want| / max |want| per parameter group (phase 5's measure)."""
    groups = {}
    for name, g_want in want.items():
        diff, scale = groups.get(param_group(name), (0.0, 0.0))
        groups[param_group(name)] = (max(diff, max_err(got[name], g_want)),
                                     max(scale, float(g_want.abs().max())))
    return {group: diff / scale if scale > 0 else 0.0 for group, (diff, scale) in groups.items()}


@contextlib.contextmanager
def keep_bits(bits: list, seeds: list = None):
    """Record the keep bits (and seed) of every dropout-forward launch."""
    from openvivqa_tpu_torch.ops import fused_attention

    original = fused_attention._dropout_forward_kernel

    def recording(*args):
        out = original(*args)
        bits.append(out[2].clone())
        if seeds is not None:
            seeds.append(int(args[4].reshape(-1)[0]))
        return out

    fused_attention._dropout_forward_kernel = recording
    try:
        yield
    finally:
        fused_attention._dropout_forward_kernel = original


def greedy_scores(task, batch):
    """(greedy prev_inds, teacher-forced scores on them) of one dev batch, on
    the eval route, inside the task's eval_weights."""
    import torch

    with task.eval_weights(), torch.no_grad():
        prev_inds = task.model.greedy_decode(batch)["prev_inds"]
        return prev_inds, task.model.compute_scores(batch, prev_inds)


def run_phase15(config, paths, tmp, seed, failures, smi):
    """Phase 15: ``configs/mmf_m4c.yaml``'s train step under REMAT, FSDP and
    DDP at world size 1 over NCCL against the unwrapped step, then two gloo
    ranks of ``small_mmf_m4c.yaml`` on the one card; returns the launch
    counts of the three wrapped runs."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
    from openvivqa_tpu_torch.parallel import multihost

    def variant(name, **training):
        # every variant runs on the unwrapped task's batches
        return build_task(config.merged({"TRAINING": {
            "CHECKPOINT_PATH": str(Path(tmp) / f"phase15_{name}"), **training}}), "cuda")

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    multihost.initialize("cuda", required=True)
    launches = {}
    plain = variant("plain")
    _, batch = next(plain.device_batches(plain.train_dataloader))
    dev_host, dev = next(plain.device_batches(plain.dev_dict_dataloader))
    rows = batch["question_tokens"].shape[0]
    want_prev, want_tf = greedy_scores(plain, dev)
    plain_bits = []
    with keep_bits(plain_bits):
        plain_loss, plain_grads, plain_peak, plain_own = step_backward(plain, batch)
    plain_state = plain.generator.get_state()
    log(f"  [{smi}] unwrapped mmf_m4c step of {rows}: loss {plain_loss:.6f}, "
        f"{len(plain_bits)} dropout-forward launches, peak device memory {plain_peak:.3f} GB "
        f"({plain_own:.3f} GB of it the step's own)")

    # (b) TRAINING.REMAT: the same backward with every layer recomputed
    remat = variant("remat", REMAT=True)
    remat_bits = []
    _cuda_reset()
    with keep_bits(remat_bits):
        remat_loss, remat_grads, remat_peak, remat_own = step_backward(remat, batch)
    counts = counts_now()
    n = len(plain_bits)
    bits_equal = (len(remat_bits) == 2 * n
                  and all(torch.equal(a, b) for a, b in zip(remat_bits[:n], plain_bits))
                  and all(any(torch.equal(r, p) for p in plain_bits) for r in remat_bits[n:]))
    rel = grad_rel(remat_grads, plain_grads)
    exact = all(torch.equal(remat_grads[k], plain_grads[k]) for k in plain_grads)
    same_stream = torch.equal(remat.generator.get_state(), plain_state)
    log(f"  [{smi}] (b) REMAT: loss {remat_loss:.6f}; {len(remat_bits)} dropout-forward launches "
        f"({n} forward + {len(remat_bits) - n} recomputed), keep bits equal to the unwrapped "
        f"step's: {bits_equal}; gradients bit-equal: {exact}, max|diff|/max|grad| per group "
        + json.dumps({g: float(f"{v:.3e}") for g, v in rel.items()})
        + f"; generator state after the step equal: {same_stream}; peak device memory "
        f"{remat_peak:.3f} GB ({remat_own:.3f} GB the step's own) vs {plain_peak:.3f} GB "
        f"({plain_own:.3f} GB) unwrapped; launches {json.dumps(counts)}")
    if not bits_equal or not same_stream or not max(rel.values()) <= STEP_GRAD_RTOL:
        failures.append(f"[phase 15 (b) REMAT] bits equal {bits_equal}, generator state equal "
                        f"{same_stream}, gradient difference {max(rel.values())}")
    if remat_own >= plain_own:
        log(f"  [{smi}] (b) REMAT's step did not take less device memory than the unwrapped one")
    for name in DROPOUT_PAIR:
        launches[name] = launches.get(name, 0) + counts[name]
        if counts[name] <= 0:
            failures.append(f"[phase 15 (b) REMAT] {name} was not launched")
    del remat, remat_grads, remat_bits
    torch.cuda.empty_cache()

    # (c) FSDP at world size 1: one eval batch on whole weights, one step's gradients
    fsdp = variant("fsdp", MESH={"FSDP": True})
    _cuda_reset()
    got_prev, got_tf = greedy_scores(fsdp, dev)
    eval_counts = counts_now()
    valid = torch.from_numpy(dev_host["sample_valid"]).to(dev["question_tokens"].device)
    unmasked = want_tf[valid] > MASK_VALUE / 2
    err = max_err(got_tf[valid][unmasked], want_tf[valid][unmasked])
    agree = float((got_prev[valid] == want_prev[valid]).float().mean())
    _cuda_reset()
    fsdp_loss, fsdp_grads, fsdp_peak, fsdp_own = step_backward(fsdp, batch)
    fsdp.optimizer.step()
    counts = counts_now()
    rel = grad_rel(fsdp_grads, plain_grads)
    sharded = sum(1 for p in fsdp.model.parameters() if hasattr(p, "placements"))
    log(f"  [{smi}] (c) FSDP (world 1, NCCL; {sharded} DTensor parameters): greedy dev batch "
        f"inside eval_weights, teacher-forced max|score FSDP-unwrapped| {err:.3e} (tol "
        f"{SCORE_TOL:.0e}), greedy-token agreement {100 * agree:.1f} %, eval launches "
        f"{json.dumps({k: v for k, v in eval_counts.items() if v})}; train step loss "
        f"{fsdp_loss:.6f} vs {plain_loss:.6f}, max|grad diff|/max|grad| per group "
        + json.dumps({g: float(f"{v:.3e}") for g, v in rel.items()})
        + f"; peak device memory {fsdp_peak:.3f} GB ({fsdp_own:.3f} GB the step's own); "
        f"launches {json.dumps(counts)}")
    if not err <= SCORE_TOL or not max(rel.values()) <= STEP_GRAD_RTOL or sharded == 0:
        failures.append(f"[phase 15 (c) FSDP] score diff {err}, gradient difference "
                        f"{max(rel.values())}, {sharded} sharded parameters")
    for name in DROPOUT_PAIR + ("fused_encoder_self_attention", "fused_ffn_step"):
        source = counts if name in DROPOUT_PAIR else eval_counts
        if source[name] <= 0:
            failures.append(f"[phase 15 (c) FSDP] {name} was not launched")
    for name in DROPOUT_PAIR:
        launches[name] += counts[name]
    del fsdp, fsdp_grads
    torch.cuda.empty_cache()

    # (a) DDP at world size 1: the same first step as the unwrapped task, then times
    ddp = variant("ddp", MESH={"MODEL_PARALLEL": 1})

    def first_step(task):
        task.generator.manual_seed(1234)
        _cuda_reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = task._train_step(batch)
        end.record()
        end.synchronize()
        return float(loss), counts_now(), start.elapsed_time(end)

    plain_loss, _, plain_ms = first_step(plain)
    ddp_loss, counts, ddp_ms = first_step(ddp)
    pairs = list(zip(plain.model.parameters(), ddp.model.parameters()))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    worst = max(max_err(a.detach(), b.detach()) for a, b in pairs)
    step = {"plain": lambda: plain._train_step(batch), "ddp": lambda: ddp._train_step(batch)}
    times = [(name, median_ms(step[name], reps=5)) for name in ("plain", "ddp", "ddp", "plain")]
    log(f"  [{smi}] (a) DDP (world 1, NCCL; {type(ddp.wrapper).__name__}, find_unused_parameters "
        f"{ddp.wrapper.find_unused_parameters}): first step loss {ddp_loss:.6f} vs {plain_loss:.6f},"
        f" parameters after the step bit-equal: {bit_equal} (max|diff| {worst:.3e}); first step "
        f"{ddp_ms:.3f} ms (with DDP's probe forward and construction) vs {plain_ms:.3f} ms "
        f"unwrapped (CUDA events); later steps of {rows} (median of 5, in turns): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in times)
        + f"; launches {json.dumps(counts)}")
    if not bit_equal:
        failures.append(f"[phase 15 (a) DDP] parameters after one step differ by {worst}")
    for name in DROPOUT_PAIR:
        launches[name] += counts[name]
        if counts[name] <= 0:
            failures.append(f"[phase 15 (a) DDP] {name} was not launched")
    del ddp, plain, step
    torch.cuda.empty_cache()
    multihost.finalize()

    # (d) two gloo ranks on the one card, each half of a global batch of 64
    run_two_ranks(paths, tmp, seed, failures, smi)
    return launches


def _cuda_reset():
    from openvivqa_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()


def small_config(paths, tmp, seed, batch_size, name):
    """small_mmf_m4c.yaml at `batch_size` rows a step, its embedding dropout 0,
    one loader worker (``seed_samples_by_index`` seeds numpy's global
    generator, which two worker threads would share)."""
    return with_data("small_mmf_m4c.yaml", paths, seed, str(Path(tmp) / name), {
        "OBJECT_EMBEDDING": {"DROPOUT": 0.0}, "OCR_EMBEDDING": {"DROPOUT": 0.0}}).merged({
            "DATASET": {"FEATURE_DATASET": {"BATCH_SIZE": batch_size, "WORKERS": 1}}})


def phase15_rank(rank, port, config_dict, reference, results):
    """One of phase 15 (d)'s two gloo ranks on cuda:0: its half of the global
    batch through DDP with dropout 0 (gradients against the one-process
    reference, then the Adam step's parameter checksum), then a step with
    dropout 0.1 (the seed and keep bits of its first dropout-forward
    launch)."""
    import traceback

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK="0")
    try:
        import torch

        sys.path.insert(0, str(ROOT))
        from openvivqa_tpu_torch.builders import build_task, populate
        from openvivqa_tpu_torch.config import ConfigNode
        from openvivqa_tpu_torch.parallel import multihost

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        multihost.initialize("cuda", backend="gloo")
        populate()
        task = build_task(ConfigNode(config_dict), "cuda")
        seed_samples_by_index(task)
        set_dropout(task, 0.0)
        _, batch = next(task.device_batches(task.train_dataloader))
        # the generator keeps its rank-folded seed throughout
        loss, grads, _, _ = step_backward(task, batch, seed=None)
        want = torch.load(reference, map_location="cuda", weights_only=True)
        rel = grad_rel(grads, want["grads"])
        del want
        task._train_step(batch)
        checksum = float(sum(p.detach().double().sum() for p in task.model.parameters()))
        set_dropout(task, DROPOUT_RATE)
        bits, seeds = [], []
        with keep_bits(bits, seeds):
            task.train_forward(task.compute_loss, batch).backward()
        results.put((rank, "ok", {
            "loss": loss, "rel": rel, "checksum": checksum, "seed": seeds[0],
            "bits": int(bits[0].to(torch.int64).sum()), "wrapper": type(task.wrapper).__name__,
        }))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))  # reported by the parent
        raise
    finally:
        from openvivqa_tpu_torch.parallel import multihost

        multihost.finalize()


def run_two_ranks(paths, tmp, seed, failures, smi):
    """Phase 15 (d): the one-process full-batch reference (64 rows, dropout
    0), then two spawned gloo ranks on cuda:0 with 32 rows each."""
    import multiprocessing
    import queue

    import torch

    from openvivqa_tpu_torch.builders import build_task

    start = time.perf_counter()
    single = build_task(small_config(paths, tmp, seed, 64, "phase15_single"), "cuda")
    seed_samples_by_index(single)
    set_dropout(single, 0.0)
    _, batch = next(single.device_batches(single.train_dataloader))
    loss, grads, _, _ = step_backward(single, batch)
    reference = Path(tmp) / "phase15_reference.pt"
    torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()}}, reference)
    n_params = sum(p.numel() for p in single.model.parameters())
    del single, grads
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    config = small_config(paths, tmp, seed, 32, "phase15_ranks").to_dict()
    procs = [ctx.Process(target=phase15_rank, args=(rank, port, config, str(reference), results))
             for rank in range(2)]
    for proc in procs:
        proc.start()
    out, errors = {}, []
    deadline = time.monotonic() + RANK_JOIN_SECONDS
    try:
        while len(out) + len(errors) < 2:
            try:
                rank, status, value = results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                errors.append(f"no result within {RANK_JOIN_SECONDS} s")
                break
            if status == "error":
                errors.append(f"rank {rank}: {value}")
                break
            out[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=30 if not errors else 5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
    if errors:
        failures.append("[phase 15 (d)] " + " | ".join(errors))
        return
    worst = max(max(r["rel"].values()) for r in out.values())
    log(f"  [{smi}] (d) two gloo ranks on cuda:0, small_mmf_m4c ({n_params / 1e6:.2f}M "
        f"parameters), 32 rows each, dropout 0: losses {out[0]['loss']:.6f} / "
        f"{out[1]['loss']:.6f} vs {loss:.6f} one process at 64; DDP gradients vs the full-batch "
        f"step, max|diff|/max|grad| per group (rank 0) "
        + json.dumps({g: float(f"{v:.3e}") for g, v in out[0]["rel"].items()})
        + f"; parameter checksums after the Adam step {out[0]['checksum']!r} / "
        f"{out[1]['checksum']!r}; dropout 0.1: kernel seeds {out[0]['seed']} / {out[1]['seed']}, "
        f"keep-bit sums {out[0]['bits']} / {out[1]['bits']}; "
        f"{time.perf_counter() - start:.1f} s")
    if not worst <= STEP_GRAD_RTOL or out[0]["checksum"] != out[1]["checksum"]:
        failures.append(f"[phase 15 (d)] gradient difference {worst}, checksums "
                        f"{out[0]['checksum']} / {out[1]['checksum']}")
    if out[0]["seed"] == out[1]["seed"] or out[0]["bits"] == out[1]["bits"]:
        failures.append("[phase 15 (d)] the two ranks drew the same dropout seed or keep bits")


# -- phase 16: tensor parallelism ------------------------------------------------------------
# one train step's gradients at two model ranks against one, relative to each parameter
# group's largest gradient: the split Linears' column blocks are the same float32 products
# over half the columns, and the input gradients of a split Linear are summed over the two
# ranks in another order; the bf16 kernels see the same whole weights and inputs, so the
# steps differ by float32 rounding carried through 16 layers and back
TP_GRAD_RTOL = 1e-3
TP_RANKS = 2


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device, reps: int = 1):
    """(the last result of fn(), its median seconds over `reps` calls by the
    host clock, each ending in a synchronize)."""
    out, seconds = None, []
    for _ in range(reps):
        _sync(device)
        start = time.perf_counter()
        out = fn()
        _sync(device)
        seconds.append(time.perf_counter() - start)
    return out, statistics.median(seconds)


def tp_greedy(task, batch, device):
    """Inside eval_weights (its gather timed apart): the incremental greedy
    prev_inds and the teacher-forced scores on them, with their seconds."""
    import torch

    context = task.eval_weights()
    _, gather_s = timed(context.__enter__, device)
    try:
        with torch.no_grad():
            (prev, scores), decode_s = timed(lambda: (
                lambda p: (p, task.model.compute_scores(batch, p)))(
                    task.model.greedy_decode(batch)["prev_inds"]), device)
    finally:
        context.__exit__(None, None, None)
    return prev, scores, gather_s, decode_s


def tp_step(task, batch):
    """One training loss and backward at generator seed 1234 (no optimizer
    step): (loss, {name: whole gradient})."""
    from openvivqa_tpu_torch.parallel.mesh import whole

    task.generator.manual_seed(1234)
    task.optimizer.zero_grad(set_to_none=True)
    loss = task.train_forward(task.compute_loss, batch)
    loss.backward()
    grads = {name: whole(p.grad).detach().clone()
             for name, p in task.model.named_parameters() if p.grad is not None}
    task.optimizer.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def tp_beam(task, batch):
    """IterativeMCAN's beam eval of one batch inside eval_weights on the layer
    route (the layer step) and the staged route (kernels A, B and C), each
    with its launch counts."""
    import torch

    from openvivqa_tpu_torch.training.decode import generate

    out = {}
    for route, parts in (("layer", "layer"), ("staged", "self,cross,ffn")):
        _cuda_reset()
        with decode_parts(parts), task.eval_weights(), torch.no_grad():
            tokens, _ = generate(task.model, batch, task.evaluating_beam_size)
        out[route] = (tokens, counts_now())
    return out


def phase16_work(mmf_dict, beam_dict, device):
    """What phase 16 runs at one model rank and at two: MMF_M4C's greedy dev
    batch and train step, then IterativeMCAN's beam batch, each with its
    launch counts and seconds."""
    import torch

    from openvivqa_tpu_torch.builders import build_task
    from openvivqa_tpu_torch.config import ConfigNode

    task = build_task(ConfigNode(mmf_dict), device)
    seed_samples_by_index(task)
    _, dev = next(task.device_batches(task.dev_dict_dataloader))
    _, batch = next(task.device_batches(task.train_dataloader))
    tp_greedy(task, dev, device)  # the allocator's first growth, outside the counted run
    _cuda_reset()
    prev, scores, gather_s, decode_s = tp_greedy(task, dev, device)
    out = {"prev": prev, "scores": scores, "eval_counts": counts_now(), "gather_s": gather_s,
           "decode_s": decode_s}
    _cuda_reset()
    out["loss"], out["grads"] = tp_step(task, batch)
    out["step_counts"] = counts_now()
    task.generator.manual_seed(1234)
    _, out["train_step_s"] = timed(lambda: task._train_step(batch), device, reps=3)
    out["generator"] = task.generator.get_state()
    out["checksum"] = float(sum(p.detach().double().sum() for p in task.model.parameters()
                                if not hasattr(p, "placements")))
    out["split"] = sum(hasattr(p, "placements") for p in task.model.parameters())
    out["n_params"] = sum(p.numel() for p in task.model.parameters())
    del task
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    beam_task = build_task(ConfigNode(beam_dict), device)
    seed_samples_by_index(beam_task)
    _, beam_batch = next(beam_task.device_batches(beam_task.dev_dict_dataloader))
    out["beam"] = tp_beam(beam_task, beam_batch)
    out["beam_split"] = sum(hasattr(p, "placements") for p in beam_task.model.parameters())
    return out


def phase16_rank(rank, port, mmf_dict, beam_dict, reference, device, results):
    """One of phase 16's two gloo ranks at (data 1, model 2) on one device:
    phase16_work, then its results against the one-rank reference."""
    import traceback

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(TP_RANKS), LOCAL_RANK="0")
    try:
        import torch

        sys.path.insert(0, str(ROOT))
        from openvivqa_tpu_torch.builders import populate
        from openvivqa_tpu_torch.parallel import multihost

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        multihost.initialize(device, backend="gloo")
        populate()
        got = phase16_work(mmf_dict, beam_dict, device)
        want = torch.load(reference, map_location=device, weights_only=True)
        result = {
            "tokens_equal": torch.equal(got["prev"], want["prev"]),
            "scores_equal": torch.equal(got["scores"], want["scores"]),
            "loss": got["loss"], "rel": grad_rel(got["grads"], want["grads"]),
            "grad_names_equal": sorted(got["grads"]) == sorted(want["grads"]),
            "beam_agreement": {route: float((tokens == want["beam"][route]).float().mean())
                               for route, (tokens, _) in got["beam"].items()},
            "beam_counts": {route: counts for route, (_, counts) in got["beam"].items()},
            "generator": got["generator"].tolist(),
        }
        result.update({key: got[key] for key in (
            "eval_counts", "step_counts", "gather_s", "decode_s", "train_step_s", "checksum",
            "split", "beam_split")})
        results.put((rank, "ok", result))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))  # reported by the parent
        raise
    finally:
        from openvivqa_tpu_torch.parallel import multihost

        multihost.finalize()


def run_phase16(config, beam_config, tmp, failures, smi, device="cuda"):
    """Phase 16: ``configs/mmf_m4c.yaml`` (incremental greedy, dropout on) and
    ``configs/iterative_mcan.yaml`` (beam) at one model rank in this process,
    then at TRAINING.MESH.MODEL_PARALLEL 2 in two spawned gloo ranks on the one
    device; returns the two ranks' launch counts."""
    import multiprocessing
    import queue

    import torch

    from openvivqa_tpu_torch.ops import _cuda

    start = time.perf_counter()
    # one loader worker: seed_samples_by_index seeds numpy's global generator, which
    # two worker threads would share, and every rank must read the same samples
    one_worker = {"FEATURE_DATASET": {"WORKERS": 1}, "DICT_DATASET": {"WORKERS": 1}}
    mmf = config.merged({"DATASET": one_worker, "MODEL": {"DECODING_MODE": "incremental"},
                         "TRAINING": {"CHECKPOINT_PATH": str(Path(tmp) / "phase16_mp1")}})
    beam = beam_config.merged({"DATASET": one_worker, "TRAINING": {
        "CHECKPOINT_PATH": str(Path(tmp) / "phase16_beam")}})
    one = phase16_work(mmf.to_dict(), beam.to_dict(), device)
    reference = Path(tmp) / "phase16_reference.pt"
    torch.save({"prev": one["prev"], "scores": one["scores"], "grads": one["grads"],
                "beam": {route: tokens for route, (tokens, _) in one["beam"].items()}}, reference)
    counts = {"eval": one["eval_counts"], "step": one["step_counts"],
              "beam": {route: c for route, (_, c) in one["beam"].items()}}
    times = {key: one[key] for key in ("decode_s", "train_step_s", "loss")}
    log(f"  [{smi}] one model rank: mmf_m4c ({one['n_params'] / 1e6:.2f}M parameters), greedy "
        f"dev batch of {one['prev'].shape[0]} in {one['decode_s'] * 1e3:.3f} ms, train step "
        f"{one['train_step_s'] * 1e3:.3f} ms (median of 3), loss {one['loss']:.6f}; launches: "
        f"eval {json.dumps(nonzero(counts['eval']))}, step {json.dumps(nonzero(counts['step']))}, "
        f"beam {json.dumps({r: nonzero(c) for r, c in counts['beam'].items()})}")
    del one
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    tp = {"TRAINING": {"MESH": {"MODEL_PARALLEL": TP_RANKS}}}
    procs = [ctx.Process(target=phase16_rank, args=(
        rank, port, mmf.merged(tp).to_dict(), beam.merged(tp).to_dict(), str(reference),
        device, results)) for rank in range(TP_RANKS)]
    for proc in procs:
        proc.start()
    out, errors = {}, []
    deadline = time.monotonic() + RANK_JOIN_SECONDS
    try:
        while len(out) + len(errors) < TP_RANKS:
            try:
                rank, status, value = results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                errors.append(f"no result within {RANK_JOIN_SECONDS} s")
                break
            if status == "error":
                errors.append(f"rank {rank}: {value}")
                break
            out[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=30 if not errors else 5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
    launches = {name: 0 for name in _cuda.WRAPPERS}
    if errors:
        failures.append("[phase 16] " + " | ".join(errors))
        return launches

    for rank, r in sorted(out.items()):
        label = f"[phase 16, rank {rank}]"
        worst = max(r["rel"].values())
        log(f"  [{smi}] (a) rank {rank} of (data 1, model 2), gloo on one card: {r['split']} "
            f"DTensor parameters; greedy dev batch inside eval_weights: tokens equal "
            f"{r['tokens_equal']}, teacher-forced scores bit-equal {r['scores_equal']}; gather "
            f"of the whole weights (entering eval_weights) {r['gather_s'] * 1e3:.3f} ms, decode "
            f"{r['decode_s'] * 1e3:.3f} ms vs {times['decode_s'] * 1e3:.3f} ms at one rank; "
            f"train step loss {r['loss']:.6f} vs {times['loss']:.6f}, max|grad diff|/max|grad| "
            f"per group " + json.dumps({g: float(f"{v:.3e}") for g, v in r["rel"].items()})
            + f" (tol {TP_GRAD_RTOL:.0e}); train step {r['train_step_s'] * 1e3:.3f} ms vs "
            f"{times['train_step_s'] * 1e3:.3f} ms at one rank (median of 3; host clock)")
        log(f"  [{smi}] (a) rank {rank} launches: eval {json.dumps(nonzero(r['eval_counts']))}, "
            f"step {json.dumps(nonzero(r['step_counts']))}")
        log(f"  [{smi}] (b) rank {rank}: iterative_mcan beam-{beam.TRAINING.EVALUATING_BEAM_SIZE} "
            f"dev batch, {r['beam_split']} DTensor parameters, token agreement with one rank "
            + json.dumps({k: f"{100 * v:.2f} %" for k, v in r["beam_agreement"].items()})
            + "; launches " + json.dumps({k: nonzero(c) for k, c in r["beam_counts"].items()}))
        if not (r["tokens_equal"] and r["scores_equal"]):
            failures.append(f"{label} greedy tokens equal {r['tokens_equal']}, scores bit-equal "
                            f"{r['scores_equal']}")
        if not r["grad_names_equal"] or not worst <= TP_GRAD_RTOL:
            failures.append(f"{label} gradient difference {worst} (tol {TP_GRAD_RTOL})")
        if not math.isclose(r["loss"], times["loss"], rel_tol=1e-5):
            failures.append(f"{label} loss {r['loss']} vs {times['loss']}")
        if r["split"] == 0 or r["beam_split"] == 0:
            failures.append(f"{label} no parameter was placed on the model axis")
        if any(v != 1.0 for v in r["beam_agreement"].values()):
            failures.append(f"{label} beam token agreement {r['beam_agreement']}")
        for kind, got, want in (("eval", r["eval_counts"], counts["eval"]),
                                ("step", r["step_counts"], counts["step"]),
                                *(("beam " + route, r["beam_counts"][route], counts["beam"][route])
                                  for route in counts["beam"])):
            if got != want:
                failures.append(f"{label} {kind} launches {nonzero(got)}, one rank's "
                                f"{nonzero(want)}")
            for name, n in got.items():
                launches[name] += n
        for name in ("fused_ffn_step", "fused_encoder_self_attention", "fused_bert_self_step"):
            if r["eval_counts"][name] <= 0:
                failures.append(f"{label} {name} was not launched by the greedy eval")
        for name in DROPOUT_PAIR:
            if r["step_counts"][name] <= 0:
                failures.append(f"{label} {name} was not launched by the train step")
        for route, name in (("layer", "fused_decoder_layer_step"),
                            ("staged", "fused_self_attention_step"),
                            ("staged", "fused_cross_attention_step")):
            if r["beam_counts"][route][name] <= 0:
                failures.append(f"{label} {name} was not launched by the {route} beam")
    first, second = out[0], out[1]
    log(f"  [{smi}] (a) the two model ranks after the Adam steps: replicated-parameter checksums "
        f"{first['checksum']!r} / {second['checksum']!r}, generator states equal "
        f"{first['generator'] == second['generator']}")
    if first["checksum"] != second["checksum"] or first["generator"] != second["generator"]:
        failures.append("[phase 16] the model ranks' replicated parameters or generator "
                        "states differ")
    log(f"  [{smi}] phase 16's times are of two gloo processes sharing one card, whose "
        "collectives pass through host memory: they bound nothing of NCCL's speed across cards")
    log(f"  phase 16 ranks and reference: {time.perf_counter() - start:.1f} s")
    return launches


def nonzero(counts: dict) -> dict:
    return {name: n for name, n in counts.items() if n}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from openvivqa_tpu_torch.builders import build_task, populate
    from openvivqa_tpu_torch.data.synthetic import (
        generate_evjvqa_dataset,
        generate_synthetic_dataset,
    )
    from openvivqa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    # the configs name checkpoints that no file here holds: every backbone is random
    os.environ["OPENVIVQA_ALLOW_RANDOM_BACKBONE"] = "1"
    log("OPENVIVQA_ALLOW_RANDOM_BACKBONE=1 (set here): the pretrained-weights policy lets the "
        "configs that name checkpoints build random frozen backbones")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)} of {torch.cuda.device_count()}")

    # 2. the kernel build
    start = time.perf_counter()
    library = _cuda.build()
    _cuda.lib()
    log(f"kernels: {library.relative_to(ROOT)} ready in {time.perf_counter() - start:.1f} s "
        f"(nvcc {_cuda.build_seconds:.1f} s; ptxas report in {library.name}.log)")
    ptxas_report(library.with_name(f"{library.name}.log"))
    failures += sass_report(library)

    # 4's inputs first: phase 3 takes its shapes and weights from the task
    populate()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        start = time.perf_counter()
        paths = generate_synthetic_dataset(
            tmp, n_images=240, n_regions=100, n_grids=1, d_grid_feature=8,
            max_scene_text=100, seed=args.seed,
        )
        config = with_data("mmf_m4c.yaml", paths, args.seed, str(Path(tmp) / "eval"),
                           NO_PRETRAINED)
        tasks = {
            "quadratic": build_task(config, "cuda"),
            "incremental": build_task(
                config.merged({"MODEL": {"DECODING_MODE": "incremental"}}), "cuda"),
        }
        generative_config = with_data("iterative_mcan.yaml", paths, args.seed,
                                      str(Path(tmp) / "beam_eval"), features_only=True)
        generative = build_task(generative_config, "cuda")
        iterative_config = with_data("mmf_iterative_m4c.yaml", paths, args.seed,
                                     str(Path(tmp) / "iterative"), NO_PRETRAINED)
        iterative = {
            "quadratic": build_task(iterative_config, "cuda"),
            "incremental": build_task(
                iterative_config.merged({"MODEL": {"DECODING_MODE": "incremental"}}), "cuda"),
        }
        evjvqa = generate_evjvqa_dataset(str(Path(tmp) / "evjvqa"), n_images=80,
                                         n_questions_per_image=3, ja_share=0.3, seed=args.seed)
        joint = build_task(with_joint(evjvqa, args.seed, str(Path(tmp) / "joint")), "cuda")
        task = tasks["quadratic"]
        _, first = next(task.device_batches(task.dev_dict_dataloader))
        shapes = {
            "question": first["question_tokens"].shape[1],
            "ctx": first["question_tokens"].shape[1] + first["region_features"].shape[1]
            + first["ocr_boxes"].shape[1],
            "dec": task.vocab.max_answer_length,
        }
        log(f"slice: configs/mmf_m4c.yaml, hidden {task.model.hidden_size}, "
            f"{task.model.num_heads} heads, {len(task.model.text_bert.encoder.layer)} TextBert "
            f"+ {len(task.model.mmt.encoder.layer)} MMT layers, batch {BATCH}, "
            f"{len(task.train_dataset)} train / {len(task.dev_dict_dataset)} dev samples, "
            f"shapes {json.dumps(shapes)}, set up in {time.perf_counter() - start:.1f} s")

        # 3. the kernels against their plain versions
        start = time.perf_counter()
        log("kernels vs plain (CUDA-event medians of 20):")
        results = check_kernels(task, shapes, args.seed, failures, generative,
                                iterative["incremental"], joint)
        log(f"phase 3: {time.perf_counter() - start:.1f} s")

        # 4. the eval path in both decode modes
        start = time.perf_counter()
        log("main path, eval: TrainingMMF.evaluate_metrics over the dev split")
        launches = {name: 0 for name in _cuda.WRAPPERS}
        for mode, mode_task in tasks.items():
            expected = ["fused_ffn_step", "fused_encoder_self_attention",
                        "fused_bert_self_step" if mode == "incremental" else "fused_attention_packed"]
            for name, n in run_mode(mode_task, mode, failures, expected).items():
                launches[name] += n
        del tasks, task, mode_task
        torch.cuda.empty_cache()
        log("main path, configs/small_mmf_m4c.yaml: the dev eval in both decode modes, one "
            "step's gradients")
        for name, n in run_small_mmf_m4c(paths, tmp, args.seed, failures).items():
            launches[name] += n
        log(f"phase 4: {time.perf_counter() - start:.1f} s")

        # 5. the training path
        start = time.perf_counter()
        log("main path, training: TrainingMMF.start() for one epoch, then get_predictions()")
        train_task = build_task(config.merged({"TRAINING": {
            "MAX_EPOCHS": 1, "CHECKPOINT_PATH": str(Path(tmp) / "train")}}), "cuda")
        for name, n in run_training(train_task, failures).items():
            launches[name] += n
        del train_task
        torch.cuda.empty_cache()
        log(f"phase 5: {time.perf_counter() - start:.1f} s")

        # 6. the beam-searched generative path
        start = time.perf_counter()
        decoder = generative.model.decoder
        log(f"main path, beam search: configs/iterative_mcan.yaml, d_model {decoder.d_model}, "
            f"{decoder.layers[0].self_attn.attention.h} heads, "
            f"{len(generative.model.self_encoder.layers)} + "
            f"{len(generative.model.guided_encoder.guided_attn_layers)} + {len(decoder.layers)} "
            f"layers, {sum(p.numel() for p in generative.model.parameters()) / 1e6:.2f}M "
            f"parameters; OpenEndedTask.evaluate_metrics over the dev split, beam "
            f"{generative.evaluating_beam_size}")
        for name, n in run_generative(generative, failures).items():
            launches[name] += n
        del generative
        torch.cuda.empty_cache()
        log("main path, XE training: OpenEndedTask.start() for one epoch, then get_predictions()")
        xe_task = build_task(generative_config.merged({"TRAINING": {
            "MAX_EPOCHS": 1, "CHECKPOINT_PATH": str(Path(tmp) / "beam_train")}}), "cuda")
        for name, n in run_generative_training(xe_task, failures).items():
            launches[name] += n
        del xe_task
        torch.cuda.empty_cache()
        log(f"phase 6: {time.perf_counter() - start:.1f} s")

        # 7. the Iterative M4C family and the other MMF_M4C variants
        start = time.perf_counter()
        model = iterative["incremental"].model
        log(f"main path, Iterative M4C: configs/mmf_iterative_m4c.yaml, hidden "
            f"{model.hidden_size}, {model.num_heads} heads, {len(model.text_bert.encoder.layer)} "
            f"TextBert + {len(model.encoder.layer)} encoder + {len(model.decoder.layer)} "
            f"cross-attention decoder layers, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
            f"parameters; TrainingMMF.evaluate_metrics over the dev split in both decode modes")
        del model
        for name, n in run_iterative(iterative, iterative_config, paths, tmp, args.seed,
                                     failures).items():
            launches[name] += n
        del iterative
        torch.cuda.empty_cache()
        log(f"phase 7: {time.perf_counter() - start:.1f} s")

        # 8. ViTmT5 under VlspEvjVqaTask
        start = time.perf_counter()
        log("main path, ViTmT5: configs/vit_mt5.yaml under VlspEvjVqaTask, beam-3 "
            "evaluate_metrics over the dev split, one XE epoch, get_predictions()")
        vit_launches, vit_results = run_vit_mt5(
            with_evjvqa(evjvqa, args.seed, str(Path(tmp) / "vit_mt5")), args.seed, failures)
        for name, n in vit_launches.items():
            launches[name] += n
        results.update(vit_results)
        torch.cuda.empty_cache()
        log(f"phase 8: {time.perf_counter() - start:.1f} s")

        # 9. JointTransformer under VlspEvjVqaTask
        start = time.perf_counter()
        log("main path, JointTransformer: configs/joint_transformer_vlsp.yaml under "
            "VlspEvjVqaTask, beam-3 evaluate_metrics over the dev split on the layer and module "
            "routes, one XE epoch, get_predictions(), a long stream through its Encoder")
        for name, n in run_joint_transformer(joint, args.seed, failures).items():
            launches[name] += n
        del joint
        torch.cuda.empty_cache()
        log(f"phase 9: {time.perf_counter() - start:.1f} s")

        # 10. the ClassificationTask configs
        start = time.perf_counter()
        log("main path, classification: configs/mcan.yaml at full widths (dev eval on both "
            "paths, one epoch, predictions), then the 8 other ClassificationTask configs")
        wide = generate_synthetic_dataset(
            str(Path(tmp) / "wide"), n_images=240, n_regions=100, n_grids=1, d_grid_feature=8,
            d_feature=2048, max_scene_text=1, seed=args.seed,
        )
        for name, n in run_classification(paths, wide, tmp, args.seed, failures,
                                          make_recorder(results, failures)).items():
            launches[name] += n
        log(f"phase 10: {time.perf_counter() - start:.1f} s")

        # 11. the rest of the M4C family
        start = time.perf_counter()
        log("main path, the rest of the M4C family: configs/m4c.yaml (both decode modes, one "
            "epoch), configs/iterative_m4c.yaml (beam 3, one epoch), then "
            "small_mmf_improved_decoding_m4c, experimental_mmf_m4c, mmf_iterative_lorra and "
            "mmf_lorra")
        m4c_paths = m4c_family_data(tmp, args.seed)
        for name, n in run_m4c_family(tmp, args.seed, failures, make_recorder(results, failures),
                                      m4c_paths).items():
            launches[name] += n
        log(f"phase 11: {time.perf_counter() - start:.1f} s")

        # 12. the VLSP generative family, the cross-modality models, IterativeSAAA and
        # ReadableIterativeMCAN
        start = time.perf_counter()
        log("main path, phase 12: unique_transformer, cross_modality_transformer_vlsp, "
            "visiolinguistic_transformer_vlsp and extended_mcan_vlsp (VlspEvjVqaTask, beam 3), "
            "cross_modality_transformer and visiolinguistic_transformer (ClassificationTask), "
            "iterative_saaa (TrainingSAAATask) and readable_iterative_mcan (OpenEndedTask)")
        for name, n in run_phase12(evjvqa, paths, wide, m4c_paths, tmp, args.seed, failures,
                                   make_recorder(results, failures)).items():
            launches[name] += n
        log(f"phase 12: {time.perf_counter() - start:.1f} s")

        # 13. the BERT-family backbones, the last two configs, SCST
        start = time.perf_counter()
        log("main path, phase 13: vit_mbert_classification (ClassificationTask) and "
            "vit_mbert_generation (VlspEvjVqaTask, beam 3, then SCST at 12 x 5 beams)")
        for name, n in run_phase13(evjvqa, tmp, args.seed, failures,
                                   make_recorder(results, failures)).items():
            launches[name] += n
        log("main path, phase 13: one short SCST epoch each of iterative_mcan (OpenEndedTask), "
            "iterative_m4c (OcrOpenEndedTask) and iterative_saaa (TrainingSAAATask)")
        for name, n in run_scst_epochs({"main": paths, "ocr": m4c_paths}, tmp, args.seed,
                                       failures).items():
            launches[name] += n
        log(f"phase 13: {time.perf_counter() - start:.1f} s")

        # 14. ALBERT, DeBERTa, the AdaptiveDecoder and its frozen LM, the plain-torch modules
        start = time.perf_counter()
        log("main path, phase 14: vit_mbert_classification with ALBERT (albert-base-v2) and "
            "DeBERTa (deberta-v3-base) text backbones, iterative_mcan with the AdaptiveDecoder "
            "(BERTModel at bert-base widths; beam 3, one XE epoch), the plain-torch modules")
        for name, n in run_phase14(evjvqa, paths, tmp, args.seed, failures,
                                   make_recorder(results, failures)).items():
            launches[name] += n
        log(f"phase 14: {time.perf_counter() - start:.1f} s")

        # 15. scale-out: REMAT, FSDP and DDP, then two ranks on the one card
        start = time.perf_counter()
        log("main path, phase 15: configs/mmf_m4c.yaml's train step of 64 under "
            "TRAINING.REMAT, FSDP and DDP (world size 1, NCCL) against the unwrapped step; "
            "two gloo ranks of small_mmf_m4c.yaml on the one card")
        phase15 = run_phase15(config, paths, tmp, args.seed, failures, smi)
        log(f"phase 15: dropout-pair launches of its REMAT, FSDP and DDP steps "
            f"{json.dumps(phase15)}; {time.perf_counter() - start:.1f} s")

        # 16. tensor parallelism: two model ranks on the one card
        start = time.perf_counter()
        log("main path, phase 16: configs/mmf_m4c.yaml (incremental greedy dev batch, one train "
            "step at dropout 0.1) and configs/iterative_mcan.yaml (beam dev batch) at one model "
            "rank, then at TRAINING.MESH.MODEL_PARALLEL 2 in two gloo ranks on the one card")
        for name, n in run_phase16(config, generative_config, tmp, failures, smi).items():
            launches[name] += n
        log(f"phase 16: {time.perf_counter() - start:.1f} s")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        if launches[name] <= 0:
            failures.append(f"{name} was not launched by the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": f"openvivqa_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], **results[name],
        })
    if failures:
        for failure in failures:
            log(f"FAILED: {failure}")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
