"""The vocab of the single-stream models: Vocab plus the modality special tokens.

The port's copy of ``openvivqa_tpu/data/multimodal_vocab.py``: the special tokens
in the reference's order pad/bos/eos/unk/img/feat/box/question/answer, their
names read from the VOCAB node, or from a whole config's ``VOCAB`` section (the
reference reads ``config.VOCAB.*`` although its builder passes the VOCAB node;
both layouts are taken).
"""

from __future__ import annotations

from typing import List

from ..builders import META_VOCAB
from .vocab import Vocab


def _vocab_section(config):
    nested = config.get("VOCAB")
    return nested if nested is not None else config


@META_VOCAB.register()
class MultiModalVocab(Vocab):
    def __init__(self, config):
        section = _vocab_section(config)
        self.img_token = section.get("IMG_TOKEN", "<img>")
        self.feat_token = section.get("FEAT_TOKEN", "<feat>")
        self.box_token = section.get("BOX_TOKEN", "<box>")
        self.question_token = section.get("QUESTION_TOKEN", "<question>")
        self.answer_token = section.get("ANSWER_TOKEN", "<answer>")
        # the base vocab reads TOKENIZER, JSON_PATH and the specials from the
        # same section as the modality tokens
        super().__init__(section)

    def special_tokens(self) -> List[str]:
        return [
            self.padding_token, self.bos_token, self.eos_token, self.unk_token,
            self.img_token, self.feat_token, self.box_token,
            self.question_token, self.answer_token,
        ]

    def register_special_indices(self) -> None:
        self.img_idx = self.stoi[self.img_token]
        self.feat_idx = self.stoi[self.feat_token]
        self.box_idx = self.stoi[self.box_token]
        self.question_idx = self.stoi[self.question_token]
        self.answer_idx = self.stoi[self.answer_token]
