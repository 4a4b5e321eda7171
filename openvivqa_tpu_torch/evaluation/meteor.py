"""METEOR (1.5 semantics, pure Python): the port's copy of
``openvivqa_tpu/evaluation/meteor.py``.

The reference shells out to the METEOR-1.5 Java jar with `-l en -norm`;
the jar is not in this repository.  This implementation follows the METEOR 1.5
scoring model (Denkowski & Lavie 2014) directly:

* matcher stages: exact (weight 1.0), stem (0.6, Snowball English — the
  stemmer family the jar uses), synonym (0.8, WordNet — engages when the
  nltk wordnet corpus is installed locally, mirroring the jar's bundled
  synonym data; silently absent otherwise), paraphrase (0.6, phrase-level
  span matching — engages when a paraphrase table file is present, see
  `_paraphrase_table`; the jar ships its table inside the jar file, which
  is stripped from this checkout, so the stage is data-gated exactly like
  synonyms).  Divergence while data is absent is quantified in
  docs/METEOR_DIVERGENCE.md.
  Vietnamese (the primary OpenViVQA language) has no stem/synonym/
  paraphrase resources in METEOR 1.5 at all, so vi scores match the jar's
  matcher semantics exactly;
* content/function-word weighting (delta) with the standard English
  function-word list;
* en task parameters: alpha 0.85, beta 0.2, gamma 0.6, delta 0.75;
  Fmean = P*R / (alpha*P + (1-alpha)*R),
  Pen = gamma * (chunks / avg_matches)^beta,  score = (1-Pen) * Fmean;
* alignment: EXACT search over one-to-one matchings with the jar's
  comparator — maximise matches, then minimise chunks, then minimise the
  sum of absolute position distances (Aligner semantics) — via a
  budget-bounded branch-and-bound (answers are short; the budget only
  trips on adversarial repeated-token inputs, which fall back to the
  chunk-continuing greedy).  Optimality is property-tested against brute
  force in tests/test_meteor_alignment.py.

tests/test_evaluation.py pins hand-computed values for each piece.
"""

from __future__ import annotations

import functools
import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
# exact, stem, synonym, paraphrase (METEOR 1.5 en module weights)
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)

_SEARCH_BUDGET = 200_000  # branch-and-bound node limit per sentence pair

# METEOR's English function-word list is frequency-derived; this is the
# standard closed-class inventory (articles, prepositions, conjunctions,
# pronouns, auxiliaries, punctuation) used for the delta weighting.
_FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no
    i you he she it we they me him her us them my your his its our their
    mine yours hers ours theirs myself yourself himself herself itself
    ourselves themselves who whom whose which what
    and or but nor so yet for although because since unless while whereas
    if then than as of in on at by with from to into onto over under
    above below between among through during before after about against
    up down out off near
    is are was were be been being am do does did done doing have has had
    having will would shall should may might must can could
    not n't there here when where why how all both few more most other
    such only own same too very s t just don now
    . , ! ? ; : ' " ` ( ) [ ] { } -""".split()
)


def _stemmer():
    try:
        from nltk.stem.snowball import SnowballStemmer

        return SnowballStemmer("english").stem
    except Exception:  # noqa: BLE001 — nltk absent: exact-only matching
        return None


_STEM = _stemmer()
if _STEM is not None:
    # corpus scoring calls the stemmer O(samples x refs x tokens) times;
    # per-token memoization makes it O(vocab)
    _STEM = functools.lru_cache(maxsize=1 << 16)(_STEM)


def _synonym_lookup():
    """WordNet synset-ids per word, or None when the corpus is absent
    (offline images).  Same gating as the jar: the stage only exists when
    its data does."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("dog")  # force the data load / fail fast

        def synsets(token: str) -> frozenset:
            return frozenset(s.name() for s in wordnet.synsets(token.lower()))

        return synsets
    except Exception:  # noqa: BLE001
        return None


_SYNSETS = _synonym_lookup()
if _SYNSETS is not None:
    _SYNSETS = functools.lru_cache(maxsize=1 << 16)(_SYNSETS)


def _paraphrase_table() -> Optional[Dict[str, frozenset]]:
    """Phrase -> set-of-paraphrase-phrases, or None when no table file is
    present (this offline image).  Same gating as the jar, whose table
    ships inside the jar file.  Accepted locations: the path in
    $METEOR_PARAPHRASE_TABLE, else ~/nltk_data/meteor/paraphrase-en.gz or
    .txt.  Line format (jar-compatible): `phrase1 ||| phrase2`, optionally
    with a leading probability field (`p ||| phrase1 ||| phrase2`, the
    probability is ignored — the 1.5 scorer weights the stage, not the
    pair).  The table is symmetrised on load."""
    candidates = [
        os.environ.get("METEOR_PARAPHRASE_TABLE"),
        os.path.expanduser("~/nltk_data/meteor/paraphrase-en.gz"),
        os.path.expanduser("~/nltk_data/meteor/paraphrase-en.txt"),
    ]
    for path in candidates:
        if not path or not os.path.exists(path):
            continue
        opener = gzip.open if path.endswith(".gz") else open
        raw: Dict[str, set] = {}
        try:
            with opener(path, "rt", encoding="utf-8") as handle:
                for line in handle:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = [p.strip() for p in line.split("|||")]
                    if len(parts) == 3:
                        parts = parts[1:]
                    if len(parts) != 2 or not parts[0] or not parts[1]:
                        continue
                    a, b = parts
                    if a == b:
                        continue
                    raw.setdefault(a, set()).add(b)
                    raw.setdefault(b, set()).add(a)
        except Exception:  # noqa: BLE001 — corrupt table: same gating as
            continue  # _stemmer/_synonym_lookup, degrade to no-table
        return {k: frozenset(v) for k, v in raw.items()}
    return None


# lazily loaded on first paraphrase-stage use: a jar-scale table is tens of
# millions of lines, and eager loading would block import (and pin the
# symmetrised table in RAM) for every process that merely imports the
# evaluation package — train-only steps included.  Tests/studies may still
# assign _PARAPHRASES directly (None or a dict) to override.
_UNLOADED = object()
_PARAPHRASES: object = _UNLOADED


def _paraphrases() -> Optional[Dict[str, frozenset]]:
    global _PARAPHRASES
    if _PARAPHRASES is _UNLOADED:
        _PARAPHRASES = _paraphrase_table()
    return _PARAPHRASES  # type: ignore[return-value]


_PARAPHRASE_STAGE = 3

# identity-keyed memo: real tables have millions of keys; scan once per
# table object, not once per sentence pair
_MAX_LEN_MEMO: Tuple[Optional[Dict], int] = (None, 1)


def _max_phrase_len(table: Dict[str, frozenset]) -> int:
    global _MAX_LEN_MEMO
    if _MAX_LEN_MEMO[0] is not table:
        _MAX_LEN_MEMO = (
            table,
            max((phrase.count(" ") + 1 for phrase in table), default=1),
        )
    return _MAX_LEN_MEMO[1]


def _is_function(token: str) -> bool:
    return token.lower() in _FUNCTION_WORDS


def _candidate_edges(
    hypo: List[str], ref: List[str]
) -> List[List[Tuple[int, int]]]:
    """cands[i] = [(ref_idx, stage), ...] with the LOWEST matching stage
    per (i, j) pair (exact supersedes stem supersedes synonym)."""
    h_stems = [_STEM(t) for t in hypo] if _STEM else None
    r_stems = [_STEM(t) for t in ref] if _STEM else None
    h_syn = [_SYNSETS(t) for t in hypo] if _SYNSETS else None
    r_syn = [_SYNSETS(t) for t in ref] if _SYNSETS else None
    cands: List[List[Tuple[int, int]]] = []
    for i, h_tok in enumerate(hypo):
        row: List[Tuple[int, int]] = []
        for j, r_tok in enumerate(ref):
            if h_tok == r_tok:
                row.append((j, 0))
            elif h_stems is not None and h_stems[i] == r_stems[j]:
                row.append((j, 1))
            elif h_syn is not None and h_syn[i] & r_syn[j]:
                row.append((j, 2))
        cands.append(row)
    return cands


class _BudgetExceeded(Exception):
    pass


def _search_alignment(
    cands: List[List[Tuple[int, int]]], budget: int = _SEARCH_BUDGET
) -> Optional[List[Tuple[int, int, int]]]:
    """Exact one-to-one alignment under the jar comparator:
    (matches desc, chunks asc, sum |i-j| asc).  Returns the optimal pairs
    or None when the node budget trips (caller falls back to greedy)."""
    n_hypo = len(cands)
    suffix = [0] * (n_hypo + 1)
    for i in reversed(range(n_hypo)):
        suffix[i] = suffix[i + 1] + (1 if cands[i] else 0)

    best_key: Optional[Tuple[int, int, int]] = None
    best_pairs: Optional[List[Tuple[int, int, int]]] = None
    nodes = 0

    def dfs(i, mask, prev_h, prev_r, matches, chunks, dist, pairs):
        nonlocal best_key, best_pairs, nodes
        nodes += 1
        if nodes > budget:
            raise _BudgetExceeded
        if best_key is not None and matches + suffix[i] < best_key[0]:
            return  # cannot reach the incumbent's cardinality
        if i == n_hypo:
            key = (matches, -chunks, -dist)
            if best_key is None or key > best_key:
                best_key, best_pairs = key, list(pairs)
            return
        options = [(j, s) for j, s in cands[i] if not (mask >> j) & 1]
        # chunk-continuing candidate first: reaches good incumbents early,
        # which tightens the cardinality bound
        options.sort(
            key=lambda js: (
                0 if (prev_h == i - 1 and js[0] == prev_r + 1) else 1,
                abs(js[0] - i),
            )
        )
        for j, stage in options:
            cont = prev_h == i - 1 and j == prev_r + 1
            pairs.append((i, j, stage))
            dfs(
                i + 1, mask | (1 << j), i, j, matches + 1,
                chunks + (0 if cont else 1), dist + abs(i - j), pairs,
            )
            pairs.pop()
        dfs(i + 1, mask, prev_h, prev_r, matches, chunks, dist, pairs)

    try:
        dfs(0, 0, -2, -2, 0, 0, 0, [])
    except _BudgetExceeded:
        return None
    return best_pairs or []


def _greedy_alignment(
    cands: List[List[Tuple[int, int]]]
) -> List[Tuple[int, int, int]]:
    """Stage-priority greedy fallback: lowest stage wins; reference-slot
    ties prefer continuing the previous chunk, then the earliest slot."""
    n_ref = 1 + max(
        (j for row in cands for j, _ in row), default=-1
    )
    taken = [False] * n_ref
    pairs: List[Tuple[int, int, int]] = []
    for stage in (0, 1, 2):  # token stages; paraphrase spans never reach here
        matched_ref = {i: j for i, j, _ in pairs}
        prev_r = -2
        for i, row in enumerate(cands):
            if i in matched_ref:
                # cross-stage chunk continuation: a later-stage match right
                # after an earlier-stage one at ref slot r must still
                # prefer r+1 (the pre-round-3 greedy did this)
                prev_r = matched_ref[i]
                continue
            free = [j for j, s in row if s == stage and not taken[j]]
            if not free:
                continue
            j = prev_r + 1 if prev_r + 1 in free else free[0]
            taken[j] = True
            pairs.append((i, j, stage))
            matched_ref[i] = j
            prev_r = j
    pairs.sort()
    return pairs


def _count_chunks(pairs: List[Tuple[int, int, int]]) -> int:
    if not pairs:
        return 0
    chunks = 1
    for (h_prev, r_prev, _), (h_cur, r_cur, _) in zip(pairs, pairs[1:]):
        if h_cur != h_prev + 1 or r_cur != r_prev + 1:
            chunks += 1
    return chunks


def _align(
    hypo: List[str],
    ref: List[str],
    cands: Optional[List[List[Tuple[int, int]]]] = None,
) -> Tuple[List[Tuple[int, int, int]], int]:
    """Optimal (jar-comparator) alignment with greedy fallback.

    Returns (pairs, chunks) where pairs are (hypo_idx, ref_idx, stage)."""
    if cands is None:
        cands = _candidate_edges(hypo, ref)
    pairs = None
    if len(ref) <= 62:  # mask width guard; answers are far shorter
        pairs = _search_alignment(cands)
    if pairs is None:
        pairs = _greedy_alignment(cands)
    return pairs, _count_chunks(pairs)


def _phrase_candidates(
    hypo: List[str], ref: List[str]
) -> List[Tuple[int, int, int, int, int]]:
    """Paraphrase-stage span matches (h_start, h_len, r_start, r_len, stage)
    from the loaded table.  1x1 spans that duplicate a token-stage pair are
    dropped (the lower stage weight always dominates there)."""
    table = _paraphrases()
    if not table:
        return []
    max_len = _max_phrase_len(table)
    ref_spans: Dict[str, List[Tuple[int, int]]] = {}
    for j in range(len(ref)):
        for rl in range(1, min(max_len, len(ref) - j) + 1):
            phrase = " ".join(ref[j : j + rl])
            if phrase in table:
                ref_spans.setdefault(phrase, []).append((j, rl))
    out: List[Tuple[int, int, int, int, int]] = []
    for i in range(len(hypo)):
        for hl in range(1, min(max_len, len(hypo) - i) + 1):
            targets = table.get(" ".join(hypo[i : i + hl]))
            if not targets:
                continue
            for phrase in targets:
                for j, rl in ref_spans.get(phrase, ()):
                    if hl == 1 and rl == 1 and (
                        hypo[i] == ref[j]
                        or (
                            _STEM is not None
                            and _STEM(hypo[i]) == _STEM(ref[j])
                        )
                    ):
                        continue  # exact/stem already covers this pair
                    out.append((i, hl, j, rl, _PARAPHRASE_STAGE))
    return out


def _token_spans(
    cands: List[List[Tuple[int, int]]]
) -> List[Tuple[int, int, int, int, int]]:
    return [
        (i, 1, j, 1, stage)
        for i, row in enumerate(cands)
        for j, stage in row
    ]


def _search_alignment_spans(
    matches: List[Tuple[int, int, int, int, int]],
    n_hypo: int,
    n_ref: int,
    budget: int = _SEARCH_BUDGET,
) -> Optional[List[Tuple[int, int, int, int, int]]]:
    """Exact span-level alignment under the jar comparator generalised to
    phrases: maximise covered words (both sides), then minimise chunks,
    then minimise summed |h_start - r_start|.  For token-only inputs this
    reduces to `_search_alignment`'s ordering (coverage = 2x matches).
    Returns the chosen span matches or None when the budget trips."""
    by_start: List[List[Tuple[int, int, int, int, int]]] = [
        [] for _ in range(n_hypo)
    ]
    for m in matches:
        by_start[m[0]].append(m)

    # admissible bound: every match starts at exactly one hypo position,
    # so future coverage <= sum over remaining starts of the best match
    suffix = [0] * (n_hypo + 1)
    for i in reversed(range(n_hypo)):
        best_here = max((m[1] + m[3] for m in by_start[i]), default=0)
        suffix[i] = suffix[i + 1] + best_here

    best_key: Optional[Tuple[int, int, int]] = None
    best_pick: Optional[List[Tuple[int, int, int, int, int]]] = None
    nodes = 0

    def dfs(i, mask, prev_h_end, prev_r_end, cover, chunks, dist, pick):
        nonlocal best_key, best_pick, nodes
        nodes += 1
        if nodes > budget:
            raise _BudgetExceeded
        if best_key is not None and cover + suffix[i] < best_key[0]:
            return
        if i == n_hypo:
            key = (cover, -chunks, -dist)
            if best_key is None or key > best_key:
                best_key, best_pick = key, list(pick)
            return
        options = []
        for m in by_start[i]:
            _, hl, j, rl, _ = m
            span_bits = ((1 << rl) - 1) << j
            if mask & span_bits:
                continue
            options.append((m, span_bits))
        options.sort(
            key=lambda o: (
                0
                if (prev_h_end == i and o[0][2] == prev_r_end)
                else 1,
                abs(o[0][2] - i),
                -(o[0][1] + o[0][3]),
            )
        )
        for m, span_bits in options:
            _, hl, j, rl, _ = m
            cont = prev_h_end == i and j == prev_r_end
            pick.append(m)
            dfs(
                i + hl, mask | span_bits, i + hl, j + rl,
                cover + hl + rl, chunks + (0 if cont else 1),
                dist + abs(i - j), pick,
            )
            pick.pop()
        dfs(i + 1, mask, prev_h_end, prev_r_end, cover, chunks, dist, pick)

    try:
        dfs(0, 0, -2, -2, 0, 0, 0, [])
    except _BudgetExceeded:
        return None
    return best_pick or []


def _count_span_chunks(
    picks: List[Tuple[int, int, int, int, int]]
) -> int:
    if not picks:
        return 0
    picks = sorted(picks)
    chunks = 1
    for (h0, hl0, r0, rl0, _), (h1, _, r1, _, _) in zip(picks, picks[1:]):
        if h1 != h0 + hl0 or r1 != r0 + rl0:
            chunks += 1
    return chunks


def _align_full(
    h_tokens: List[str], r_tokens: List[str]
) -> Tuple[Dict[int, int], Dict[int, int], int, int, int]:
    """Alignment result as (h_stage, r_stage, chunks, covered_h, covered_r).

    Token-only path (no paraphrase table / no phrase candidates) delegates
    to the pinned-optimal `_align`; span path runs the generalised search,
    falling back to the token path when the budget trips."""
    cands = None
    if len(r_tokens) <= 62:  # mask width guard, same as _align's
        phrase_cands = _phrase_candidates(h_tokens, r_tokens)
        if phrase_cands:
            cands = _candidate_edges(h_tokens, r_tokens)
            picks = _search_alignment_spans(
                _token_spans(cands) + phrase_cands,
                len(h_tokens),
                len(r_tokens),
            )
            if picks is not None:
                h_stage: Dict[int, int] = {}
                r_stage: Dict[int, int] = {}
                for h0, hl, r0, rl, stage in picks:
                    for i in range(h0, h0 + hl):
                        h_stage[i] = stage
                    for j in range(r0, r0 + rl):
                        r_stage[j] = stage
                return (
                    h_stage,
                    r_stage,
                    _count_span_chunks(picks),
                    len(h_stage),
                    len(r_stage),
                )
    pairs, chunks = _align(h_tokens, r_tokens, cands)
    return (
        {i: s for i, _, s in pairs},
        {j: s for _, j, s in pairs},
        chunks,
        len(pairs),
        len(pairs),
    )


def _weighted_counts(tokens: List[str], matched_stages: Dict[int, int]):
    """(weighted matched, weighted total) with delta content weighting."""
    matched = total = 0.0
    for idx, token in enumerate(tokens):
        w = (1.0 - DELTA) if _is_function(token) else DELTA
        total += w
        stage = matched_stages.get(idx)
        if stage is not None:
            matched += w * STAGE_WEIGHTS[stage]
    return matched, total


def _sentence_meteor(hypo: str, refs: List[str]) -> float:
    h_tokens = hypo.split()
    best = 0.0
    for ref in refs:
        r_tokens = ref.split()
        if not h_tokens or not r_tokens:
            best = max(best, float(h_tokens == r_tokens))
            continue
        h_stage, r_stage, chunks, covered_h, covered_r = _align_full(
            h_tokens, r_tokens
        )
        if not covered_h:
            continue
        wm_h, wt_h = _weighted_counts(h_tokens, h_stage)
        wm_r, wt_r = _weighted_counts(r_tokens, r_stage)
        precision = wm_h / wt_h if wt_h else 0.0
        recall = wm_r / wt_r if wt_r else 0.0
        if precision + recall == 0.0:
            continue
        f_mean = precision * recall / (
            ALPHA * precision + (1.0 - ALPHA) * recall
        )
        # phrase matches cover unequal word counts per side; the 1.5
        # fragmentation denominator is the per-side average
        avg_matches = (covered_h + covered_r) / 2.0
        # the jar zeroes fragmentation only when ONE chunk covers both
        # sides completely; any partial alignment pays gamma*(ch/m)^beta
        full_cover = (
            chunks == 1
            and covered_h == len(h_tokens)
            and covered_r == len(r_tokens)
        )
        penalty = (
            0.0 if full_cover else GAMMA * (chunks / avg_matches) ** BETA
        )
        best = max(best, (1.0 - penalty) * f_mean)
    return best


class Meteor:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys()
        scores = [_sentence_meteor(res[key][0], gts[key]) for key in gts]
        arr = np.asarray(scores)
        return float(arr.mean()), arr

    def __str__(self) -> str:
        return "METEOR"
