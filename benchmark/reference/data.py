"""The benchmark's split read again, for the references: the vocabulary, the
question and answer ids and the feature arrays of a batch's samples, worked
out from the annotation JSONs and ``.npy`` files alone.

A batch is named by its samples (image id and question text, or question id);
which samples the loader put together is the loader's choice.  The only
answer the program makes that is taken over is the one the data leaves open:
an answer word that is both a vocabulary word and an OCR token may be encoded
as either (the port's OcrVocab draws one), so the program's target ids are
checked to be one of the encodings and then used.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>", "<img>", "<feat>", "<box>", "<ocr>",
            "<ocr_det>", "<ocr_rec>", "<question>", "<answer>"]
PAD, BOS, EOS, UNK = 0, 1, 2, 3


def words(text: str) -> List[str]:
    """The generator's sentences are lower-case words and a final "?"."""
    return text.lower().replace("?", " ? ").split()


class Split:
    def __init__(self, paths: Dict[str, str], max_scene_text: int = 100,
                 max_regions: int = 100):
        self.paths = paths
        self.max_scene_text, self.max_regions = max_scene_text, max_regions
        counts: Counter = Counter()
        self.max_question = self.max_answer = 0
        self.by_id: Dict[int, dict] = {}
        for split in ("train", "dev", "test"):
            with open(paths[split], encoding="utf-8") as handle:
                for ann in json.load(handle)["annotations"]:
                    self.by_id[ann["id"]] = ann
                    question = words(ann["question"])
                    for answer in ann["answers"]:
                        counts.update(question)
                        counts.update(words(answer))
                        self.max_question = max(self.max_question, len(question) + 2)
                        self.max_answer = max(self.max_answer, len(words(answer)) + 2)
        ranked = sorted(counts.items(), key=lambda t: t[0])
        ranked.sort(key=lambda t: t[1], reverse=True)
        self.itos = SPECIALS + [w for w, _ in ranked if w not in SPECIALS]
        self.stoi = {w: i for i, w in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    def question_ids(self, tokens: Sequence[str]) -> np.ndarray:
        ids = [BOS] + [self.stoi.get(t, UNK) for t in tokens] + [EOS]
        out = np.full((self.max_question,), PAD, np.int64)
        out[:len(ids)] = ids[:self.max_question]
        return out

    def features(self, image_id: int) -> Dict[str, np.ndarray]:
        raw = np.load(os.path.join(self.paths["features"], f"{image_id}.npy"),
                      allow_pickle=True)[()]
        ocr = np.load(os.path.join(self.paths["scene_text"], f"{image_id}.npy"),
                      allow_pickle=True)[()]
        k = self.max_scene_text

        def pad(a, rows):
            out = np.zeros((rows,) + a.shape[1:], np.float32)
            out[:min(rows, len(a))] = a[:rows]
            return out

        n = min(len(ocr["texts"]), k)
        return {
            "region_features": pad(raw["region_features"], self.max_regions),
            "region_boxes": pad(raw["region_boxes"], self.max_regions),
            "ocr_det_features": pad(ocr["det_features"], k),
            "ocr_rec_features": pad(ocr["rec_features"], k),
            "ocr_fasttext_features": pad(ocr["fasttext_features"], k),
            "ocr_boxes": pad(ocr["boxes"], k),
            "ocr_texts": list(ocr["texts"][:n]) + ["<pad>"] * (k - n),
        }

    def _stack(self, image_ids: Sequence[int], rows: int) -> Dict[str, np.ndarray]:
        per = [self.features(int(i)) for i in image_ids]
        per += [per[-1]] * (rows - len(per))  # the loader repeats the last row
        return {key: np.stack([p[key] for p in per]) for key in per[0] if key != "ocr_texts"}

    def eval_batch(self, host: Dict, device):
        """A dev batch: the samples of `host` by question id.  Returns (arrays,
        mismatches): mismatches counts the samples whose question ids in the
        program's batch differ from these."""
        valid = np.asarray(host["sample_valid"])
        n_real = int(valid.sum())
        anns = [self.by_id[int(q)] for q in np.asarray(host["question_id"])[:n_real]]
        questions = [self.question_ids(words(a["question"])) for a in anns]
        mismatches = sum(not np.array_equal(q, np.asarray(p))
                         for q, p in zip(questions, host["question_tokens"]))
        questions += [questions[-1]] * (len(valid) - n_real)
        out = self._stack([a["image_id"] for a in anns], len(valid))
        out["question_tokens"] = np.stack(questions)
        out["sample_valid"] = valid.astype(np.float32)
        return {k: torch.as_tensor(v, device=device) for k, v in out.items()}, mismatches

    def train_batch(self, host: Dict, device):
        """A train batch: the samples of `host` by image id and question text,
        and the program's answer ids where they are one of the answer's
        encodings.  Returns (arrays, mismatches): mismatches counts the
        samples whose question or answer ids are none of the encodings."""
        valid = np.asarray(host["sample_valid"])
        n_real = int(valid.sum())
        image_ids = np.asarray(host["image_id"])[:n_real]
        out = self._stack(image_ids, len(valid))
        questions = []
        mismatches = 0
        program_answers = np.asarray(host["answer_tokens"])
        program_targets = np.asarray(host["shifted_right_answer_tokens"])
        answers, targets = program_answers.astype(np.int64), program_targets.astype(np.int64)
        for row in range(n_real):
            question = words(host["question"][row])
            mine = self.question_ids(question)
            questions.append(mine)
            if not np.array_equal(mine, np.asarray(host["question_tokens"][row])):
                mismatches += 1
            texts = self.features(int(image_ids[row]))["ocr_texts"]
            if not self._is_encoding(host["answer"][row], texts, program_answers[row],
                                     program_targets[row]):
                mismatches += 1
        questions += [questions[-1]] * (len(valid) - n_real)
        out["question_tokens"] = np.stack(questions)
        out["answer_tokens"] = answers
        out["shifted_right_answer_tokens"] = targets
        out["sample_valid"] = valid.astype(np.float32)
        return {k: torch.as_tensor(v, device=device) for k, v in out.items()}, mismatches

    def annotations(self, split: str) -> List[dict]:
        with open(self.paths[split], encoding="utf-8") as handle:
            return json.load(handle)["annotations"]

    def host_train_batches(self, rows: int, count: int) -> List[Dict]:
        """`count` train batches of `rows` samples in file order, named as a
        host batch of the program names them (the controls' inputs)."""
        anns = self.annotations("train")
        out = []
        for b in range(count):
            chunk = anns[b * rows:(b + 1) * rows]
            answers, targets = [], []
            for ann in chunk:
                ids = [BOS] + [self.stoi[w] for w in words(ann["answers"][0])] + [EOS]
                full = np.full((self.max_answer,), PAD, np.int64)
                full[:len(ids)] = ids
                shifted = np.full_like(full, PAD)
                shifted[:-1] = full[1:]
                answers.append(np.where(full == EOS, PAD, full))
                targets.append(shifted)
            out.append({
                "image_id": np.asarray([a["image_id"] for a in chunk]),
                "question": [" ".join(words(a["question"])) for a in chunk],
                "answer": [words(a["answers"][0]) for a in chunk],
                "question_tokens": np.stack([self.question_ids(words(a["question"]))
                                             for a in chunk]),
                "answer_tokens": np.stack(answers),
                "shifted_right_answer_tokens": np.stack(targets),
                "sample_valid": np.ones(len(chunk), bool),
            })
        return out

    def host_dev_batches(self, rows: int, count: int) -> List[Dict]:
        """`count` dev batches of `rows` samples in file order, named as a host
        batch of the program names them."""
        anns = self.annotations("dev")
        return [{"question_id": np.asarray([a["id"] for a in chunk]),
                 "question_tokens": [self.question_ids(words(a["question"])) for a in chunk],
                 "sample_valid": np.ones(len(chunk), bool)}
                for chunk in (anns[b * rows:(b + 1) * rows] for b in range(count))]

    def _is_encoding(self, answer: Sequence[str], ocr_texts: List[str], inputs: np.ndarray,
                     targets: np.ndarray) -> bool:
        """Whether (inputs, targets) encode `answer`: <bos>, each word as its
        vocabulary id or an OCR slot (vocabulary size + slot) that holds it,
        <eos>, then padding; the decoder inputs carry <pad> where <eos> is."""
        base = len(self.itos)
        seq = [BOS] + [None] * len(answer) + [EOS]
        seq = seq[:self.max_answer]
        full = np.full((self.max_answer,), PAD, np.int64)
        for i, word in enumerate(list(answer)[:self.max_answer - 1]):
            got = int(targets[i])  # target i is token i + 1
            allowed = {base + s for s, t in enumerate(ocr_texts) if t == word}
            if word in self.stoi:
                allowed.add(self.stoi[word])
            if not allowed:
                allowed = {UNK}
            if got not in allowed:
                return False
            seq[i + 1] = got
        for i, idx in enumerate(seq):
            full[i] = idx
        want_targets = np.full_like(full, PAD)
        want_targets[:-1] = full[1:]
        want_inputs = np.where(full == EOS, PAD, full)
        return (np.array_equal(want_targets, np.asarray(targets, np.int64))
                and np.array_equal(want_inputs, np.asarray(inputs, np.int64)))
