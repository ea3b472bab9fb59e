r"""Whisper tokenizer for the port, without tiktoken.

Reads the byte-level BPE rank table (``assets/multilingual.tiktoken``: one
base64 token and its rank per line) itself:

- decoding is a bytes lookup per id, joined and UTF-8 decoded with
  replacement, as tiktoken does; timestamp ids are dropped by ``decode`` and
  rendered as ``<|t.tt|>`` by ``decode_with_timestamps``;
- special ids follow the rank table in the same order as the JAX package's
  tokenizer (eot, sot, the language tokens, task and control tokens, then
  1501 timestamps);
- encoding splits the text as the GPT-2 pattern
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+``
  does (:func:`pretokenize`, a scanner over ``unicodedata`` categories:
  stdlib ``re`` has no ``\p{L}``/``\p{N}``), then merges each piece's bytes
  in rank order, as tiktoken does.
"""

from __future__ import annotations

import base64
import os
import string
import unicodedata
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from .config import LANGUAGES, TO_LANGUAGE_CODE

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets")


def find_vocab_file(explicit: Optional[str] = None) -> str:
    """Locate ``multilingual.tiktoken``: an explicit path, else
    ``<repo>/assets/``."""
    for c in (explicit, os.path.join(_ASSETS, "multilingual.tiktoken")):
        if c and os.path.exists(c):
            return os.path.abspath(c)
    raise FileNotFoundError(
        "multilingual.tiktoken not found in the repository's assets/ "
        "directory; pass vocab_path")


@lru_cache(maxsize=2)
def _load_ranks(path: str) -> Dict[bytes, int]:
    ranks = {}
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            tok, rank = line.split()
            ranks[base64.b64decode(tok)] = int(rank)
    return ranks


def special_token_names(num_languages: int) -> List[str]:
    """Special tokens in id order after the rank table."""
    names = ["<|endoftext|>", "<|startoftranscript|>"]
    names += [f"<|{code}|>" for code in list(LANGUAGES)[:num_languages]]
    names += ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
              "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"]
    names += [f"<|{i * 0.02:.2f}|>" for i in range(1501)]
    return names


def bpe_encode(data: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Byte-pair merge ``data``: repeatedly merge the adjacent pair whose
    concatenation has the lowest rank, until no pair is in the table."""
    parts = [data[i:i + 1] for i in range(len(data))]
    while len(parts) > 1:
        best, best_rank = -1, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best < 0:
            break
        parts[best:best + 2] = [parts[best] + parts[best + 1]]
    return [ranks[p] for p in parts]


# Unicode White_Space, the regex engines' \s (str.isspace also takes the
# separators U+001C..U+001F, which \s does not)
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(chr(c) for c in range(0x2000, 0x200B)))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _kind(ch: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'o' anything else."""
    if ch in _WHITESPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def pretokenize(text: str) -> List[str]:
    """Split ``text`` as the GPT-2 pattern above does: at each position the
    first alternative that matches, each run taken greedily."""
    kinds = [_kind(c) for c in text]
    n, i, out = len(text), 0, []

    def run(j: int, kind: str) -> int:
        while j < n and kinds[j] == kind:
            j += 1
        return j

    while i < n:
        if text[i] == "'":
            tail = next((c for c in _CONTRACTIONS if text.startswith(c, i + 1)), None)
            if tail is not None:
                out.append(text[i:i + 1 + len(tail)])
                i += 1 + len(tail)
                continue
        k = kinds[i]
        # " ?X+": an optional space, then a run of one kind (letters,
        # numbers, or the rest: not space, letter or number)
        lead = 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "s" else 0
        if k != "s" or lead:
            j = run(i + lead, kinds[i + lead])
        else:
            j = run(i, "s")
            # \s+(?!\S): the run short of its last space when a non-space
            # follows; a lone space before a non-space falls to \s+
            if j < n and j - i > 1:
                j -= 1
        out.append(text[i:j])
        i = j
    return out


@dataclass
class Tokenizer:
    """Whisper tokenizer with task/language context (multilingual vocab)."""

    ranks: Dict[bytes, int] = field(repr=False)
    num_languages: int = 99
    language: Optional[str] = None
    task: Optional[str] = None

    @cached_property
    def _specials(self) -> Dict[str, int]:
        base = len(self.ranks)
        return {name: base + i
                for i, name in enumerate(special_token_names(self.num_languages))}

    @cached_property
    def _id_bytes(self) -> Dict[int, bytes]:
        out = {r: b for b, r in self.ranks.items()}
        out.update({i: name.encode() for name, i in self._specials.items()})
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in pretokenize(text):
            data = piece.encode("utf-8")
            rank = self.ranks.get(data)
            ids += [rank] if rank is not None else bpe_encode(data, self.ranks)
        return ids

    def _decode_bytes(self, ids: Sequence[int]) -> str:
        table = self._id_bytes
        return b"".join(table[int(t)] for t in ids).decode("utf-8", errors="replace")

    def decode(self, token_ids: Sequence[int]) -> str:
        return self._decode_bytes(
            [int(t) for t in token_ids if int(t) < self.timestamp_begin])

    def decode_with_timestamps(self, token_ids: Sequence[int]) -> str:
        parts: List[str] = []
        run: List[int] = []
        for t in token_ids:
            t = int(t)
            if t >= self.timestamp_begin:
                if run:
                    parts.append(self._decode_bytes(run))
                    run = []
                parts.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                run.append(t)
        if run:
            parts.append(self._decode_bytes(run))
        return "".join(parts)

    # ---- special-token accessors ----
    @property
    def eot(self) -> int:
        return self._specials["<|endoftext|>"]

    @property
    def sot(self) -> int:
        return self._specials["<|startoftranscript|>"]

    @property
    def transcribe(self) -> int:
        return self._specials["<|transcribe|>"]

    @property
    def translate(self) -> int:
        return self._specials["<|translate|>"]

    @property
    def sot_lm(self) -> int:
        return self._specials["<|startoflm|>"]

    @property
    def sot_prev(self) -> int:
        return self._specials["<|startofprev|>"]

    @property
    def no_speech(self) -> int:
        return self._specials["<|nospeech|>"]

    @property
    def no_timestamps(self) -> int:
        return self._specials["<|notimestamps|>"]

    @property
    def timestamp_begin(self) -> int:
        return self._specials["<|0.00|>"]

    def to_language_token(self, language: str) -> int:
        return self._specials[f"<|{language}|>"]

    @cached_property
    def sot_sequence(self) -> Tuple[int, ...]:
        seq = [self.sot]
        if self.language is not None:
            seq.append(self.to_language_token(self.language))
        if self.task is not None:
            seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        return tuple(seq)

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids to suppress so decoding never emits bracketed/markup
        non-speech annotations (OpenAI Whisper's public symbol list): a
        symbol is suppressed in bare and space-prefixed form when it is one
        token, and musical notes by their first token even when multi-token.
        """
        single_chars = '"#()*+/:;<=>@[\\]^_`{|}~「」『』'
        multi_chars = (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
        ).split()
        notes = "♩♪♫♬♭♮♯"
        ids = {self.encode(" -")[0], self.encode(" '")[0]}
        for sym in [*single_chars, *multi_chars, *notes]:
            for variant in (sym, " " + sym):
                toks = self.encode(variant)
                if len(toks) == 1 or sym in notes:
                    ids.add(toks[0])
        return tuple(sorted(ids))

    # ---- word splitting (OpenAI Whisper's algorithm, as the JAX package's)
    def split_to_word_tokens(self, tokens: Sequence[int]):
        """(words, token groups) of ``tokens``: per codepoint run in the
        scripts without spaces between words (zh, ja, th, lo, my, yue), by
        spaces otherwise."""
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: Sequence[int]):
        """Group tokens into the shortest runs that decode to whole
        codepoints. Byte-level BPE can split a multi-byte UTF-8 character
        across tokens; a run is complete once its decode holds no U+FFFD,
        unless the whole text has U+FFFD at that offset."""
        full_text = self.decode_with_timestamps(tokens)
        bad = "\ufffd"
        words: List[str] = []
        groups: List[List[int]] = []
        pending: List[int] = []
        done_len = 0
        for tok in map(int, tokens):
            pending.append(tok)
            text = self.decode_with_timestamps(pending)
            i = text.find(bad)
            if i < 0 or full_text[done_len + i] == bad:
                words.append(text)
                groups.append(pending)
                pending = []
                done_len += len(text)
        return words, groups

    def split_tokens_on_spaces(self, tokens: Sequence[int]):
        """Merge codepoint runs into space-delimited words: a run starts a
        word after a space, as a special token or as punctuation."""
        words: List[str] = []
        groups: List[List[int]] = []
        for piece, toks in zip(*self.split_tokens_on_unicode(tokens)):
            if (not words or toks[0] >= self.eot or piece.startswith(" ")
                    or piece.strip() in string.punctuation):
                words.append(piece)
                groups.append(list(toks))
            else:
                words[-1] += piece
                groups[-1] += toks
        return words, groups


def get_tokenizer(
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
    vocab_path: Optional[str] = None,
) -> Tokenizer:
    """Multilingual tokenizer (the English-only ``.en`` vocab is not ported)."""
    if language is not None:
        language = language.lower()
        if language not in LANGUAGES:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            else:
                raise ValueError(f"unsupported language: {language}")
    ranks = _load_ranks(find_vocab_file(vocab_path))
    return Tokenizer(ranks=ranks, num_languages=num_languages,
                     language=language, task=task)
