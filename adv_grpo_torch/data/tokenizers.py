"""The tokenizers in plain Python: the SD3 ones (CLIP's byte-pair encoder and
T5's unigram model, read from a diffusers directory's ``tokenizer/``,
``tokenizer_2/`` and ``tokenizer_3/``) and ImageReward's BERT WordPiece,
with no ``transformers``, ``tokenizers``, ``regex``, ``ftfy`` or
``sentencepiece``.

The JAX package tokenizes with ``transformers.CLIPTokenizer``,
``transformers.T5TokenizerFast`` (adv_grpo_tpu/cli/common.py:274-276, :382)
and ``transformers.BertTokenizer`` (adv_grpo_tpu/rewards/vlm.py:612); each
class here gives those ids, id for id (tests/test_torch_tokenizers.py,
tests/test_torch_blip.py):

* :class:`CLIPTokenizer` reads ``vocab.json`` and ``merges.txt`` (its first
  line is ``#version``, and at most 48,894 merges count, as in
  ``transformers``), splits the added and special tokens out of the text
  first, cleans each piece as ``CLIPTokenizer`` does where ``ftfy`` is
  absent (``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``:
  control characters dropped, whitespace normalised, spaces around CJK
  characters, NFC, lower case), splits it into words by CLIP's pattern
  (``<|startoftext|>``, ``<|endoftext|>``, the contractions, letter runs,
  single digits, runs of other characters, case-insensitive) with a scanner
  over ``unicodedata.category``, maps each word's UTF-8 bytes to unicode,
  and merges by rank with the ``</w>`` word end. Its output is BOS, at most
  ``max_length - 2`` ids, EOS, padded with the directory's own pad token
  (``<|endoftext|>`` in SD3's ``tokenizer/``, ``!`` in bigG's
  ``tokenizer_2/``).
* :class:`T5Tokenizer` reads ``tokenizer.json``: added tokens split out
  first; the normalizers ``Precompiled`` (a SentencePiece charsmap: a
  darts-clone double array over the keys and their NUL-ended replacements,
  applied per grapheme cluster as the ``tokenizers`` crate applies it),
  ``Replace`` (string or regex pattern), ``Strip``, ``NFKC`` and
  ``Sequence``; the pre-tokenizers ``Metaspace`` (``prepend_scheme``
  always or never, ``split``), ``WhitespaceSplit`` and ``Sequence``; the
  ``Unigram`` model (the best-scoring path, an unknown character scoring
  the lowest piece score minus 10, consecutive unknowns fused, optional
  byte fallback); the ``TemplateProcessing`` post-processor (``$A </s>``).
  It truncates so that the template's special tokens are kept and pads with
  the directory's pad token. Any other component type raises, naming it.
* :class:`BertTokenizer` reads ``vocab.txt`` and ``tokenizer_config.json``
  (``do_lower_case``, ``strip_accents``, ``tokenize_chinese_chars``, the
  special tokens and ``added_tokens_decoder``; without the last, as
  ``transformers`` does, ``special_tokens_map.json`` and the
  ``added_tokens`` of a ``tokenizer.json``). With ``do_lower_case`` the text
  but the special tokens is lower-cased one character at a time (newlines
  kept); the added tokens (all special: ImageReward adds ``[DEC]`` and
  ``[ENC]``) are split out; each other piece goes through BERT's
  BasicTokenizer (control characters dropped, whitespace normalised, spaces
  around CJK ideographs, NFC, lower case and accents stripped (NFD, marks
  Mn dropped), split on punctuation) and the greedy longest-match-first
  WordPiece (``##`` continuations, a word over 100 characters or with no
  match is ``[UNK]``). Its output is ``[CLS]``, at most ``max_length - 2``
  ids, ``[SEP]``, the pad id to ``max_length``, and the attention mask. A
  non-special added token, an added token that strips or is single-word,
  ``do_basic_tokenize`` off, ``never_split`` or a legacy
  ``added_tokens.json`` raise, naming it.
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BertTokenizer", "CLIPTokenizer", "T5Tokenizer", "Precompiled"]


def _read_json(path: str, default=None):
    if not os.path.isfile(path):
        return default
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(token) -> Optional[str]:
    """A special token as ``tokenizer_config.json`` writes it: a string or an
    ``AddedToken`` dict."""
    return token["content"] if isinstance(token, dict) else token


class _AddedTokens:
    """Tokens matched in the raw text before anything else (leftmost, then
    longest), each with its id."""

    def __init__(self, ids: Dict[str, int]):
        self.ids = ids
        # alternatives longest first: at the leftmost match, the longest wins
        self._pattern = re.compile("|".join(map(re.escape, sorted(ids, key=len, reverse=True))))

    @staticmethod
    def check_flags(token: dict, where: str) -> None:
        for flag in ("lstrip", "rstrip", "single_word"):
            if token.get(flag):
                raise NotImplementedError(f"{where}: added token {token['content']!r} sets "
                                          f"{flag}, which is not implemented")

    def split(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """``text`` as (piece, None) and (added token, its id) in order;
        empty pieces left out."""
        out, start = [], 0
        for m in self._pattern.finditer(text):
            if m.start() > start:
                out.append((text[start:m.start()], None))
            out.append((m.group(), self.ids[m.group()]))
            start = m.end()
        if start < len(text):
            out.append((text[start:], None))
        return out


def _pad_rows(rows: Sequence[List[int]], max_length: int, pad_id: int) -> np.ndarray:
    out = np.full((len(rows), max_length), pad_id, np.int64)
    for r, ids in enumerate(rows):
        out[r, :len(ids)] = ids
    return out


# ── CLIP ─────────────────────────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _bytes_to_unicode() -> Dict[int, str]:
    """CLIP's (and GPT-2's) reversible map of the 256 bytes to printable
    characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clip_clean(text: str) -> str:
    """``transformers``' ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False)`` joined by spaces (``CLIPTokenizer``'s cleaning
    where ``ftfy`` is absent): NUL, U+FFFD and control characters (category
    C*, but tab and newlines) dropped, whitespace to spaces, spaces around
    CJK ideographs, NFC, split on whitespace, each word lower-cased."""
    out = []
    for ch in text:
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif ch == "\ufffd" or unicodedata.category(ch)[0] == "C":
            continue
        elif _is_cjk(ord(ch)):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


_CLIP_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll",
                  "'d")


def _kind(ch: str) -> str:
    """"L" (letter), "N" (number), " " (matched by no alternative of the word
    pattern: whitespace, and U+0345, whose upper case is a letter, so that
    the case-insensitive negated class leaves it out too) or "O"."""
    if ch.isspace() or ch == "\u0345":
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def clip_words(text: str) -> List[str]:
    """``re.findall`` of CLIP's word pattern
    ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    with IGNORECASE, as a scanner (the standard library's ``re`` has no
    ``\\p{...}``): at each position the first alternative that matches; the
    literals compare by case folding (``ſ`` matches ``s``)."""
    words, i, n = [], 0, len(text)
    while i < n:
        lit = None
        if text[i] in "<'":  # no other character folds to a literal's first
            lit = next((t for t in _CLIP_LITERALS if len(text) - i >= len(t) and all(
                c.casefold() == p for c, p in zip(text[i:i + len(t)], t))), None)
        if lit is not None:
            words.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


class CLIPTokenizer:
    """The byte-pair tokenizer of a CLIP ``tokenizer/`` directory
    (``vocab.json``, ``merges.txt``, ``tokenizer_config.json`` and / or
    ``special_tokens_map.json``); ``tokenizer(prompts, max_length)`` -> int64
    ids (B, max_length)."""

    def __init__(self, directory: str):
        self.encoder = _read_json(os.path.join(directory, "vocab.json"))
        with open(os.path.join(directory, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.ranks = {tuple(m.split()): r for r, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        config = _read_json(os.path.join(directory, "tokenizer_config.json"), {})
        special = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
        special.update({k: v for k, v in config.items() if k in special})
        added = {}
        if "added_tokens_decoder" in config:
            for idx, tok in config["added_tokens_decoder"].items():
                _AddedTokens.check_flags(tok, "CLIPTokenizer")
                added[tok["content"]] = int(idx)
        else:  # the legacy layout: special_tokens_map.json wins
            stm = _read_json(os.path.join(directory, "special_tokens_map.json"), {})
            special.update({k: v for k, v in stm.items() if k in special})
        special = {k: _content(v) for k, v in special.items()}
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        for tok in list(special.values()) + extra:
            if tok not in added:
                added[tok] = self.encoder.get(tok, len(set(self.encoder) | set(added)))
        self.added = _AddedTokens(added)
        self.unk_id = self.encoder[special["unk_token"]]
        self.bos_id, self.eos_id, self.pad_id = (added[special[k]]
                                                 for k in ("bos_token", "eos_token", "pad_token"))

    def bpe(self, token: str) -> str:
        """``transformers``' ``CLIPTokenizer.bpe``: the word's symbols, the last
        with ``</w>``, merged lowest rank first; space-separated."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        while True:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _id(self, token: str) -> int:
        if token in self.added.ids:
            return self.added.ids[token]
        return self.encoder.get(token, self.unk_id)

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without BOS and EOS."""
        ids: List[int] = []
        for piece, added_id in self.added.split(text):
            if added_id is not None:
                ids.append(added_id)
                continue
            for word in clip_words(clip_clean(piece)):
                word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                ids.extend(self._id(t) for t in self.bpe(word).split(" "))
        return ids

    def __call__(self, prompts: Sequence[str], max_length: int = 77) -> np.ndarray:
        """BOS, at most ``max_length - 2`` ids, EOS, then the pad id to
        ``max_length`` (``padding="max_length", truncation=True``)."""
        rows = [[self.bos_id] + self.encode(p)[:max_length - 2] + [self.eos_id]
                for p in prompts]
        return _pad_rows(rows, max_length, self.pad_id)


# ── grapheme clusters (UAX #29, for the Precompiled normalizer) ──────────────

_OTHER_GRAPHEME_EXTEND = frozenset(
    [0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6, 0x0D3E, 0x0D57,
     0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E, 0x302F, 0xFF9E, 0xFF9F, 0x1133E, 0x11357,
     0x114B0, 0x114BD, 0x115AF, 0x11930, 0x1D165] + list(range(0x1D16E, 0x1D173))
    + list(range(0xE0020, 0xE0080)) + list(range(0x1F3FB, 0x1F400)))
_PREPEND = frozenset(
    [0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x0D4E, 0x110BD, 0x110CD, 0x111C2, 0x111C3,
     0x1193F, 0x11941, 0x11A3A, 0x11D46, 0x11F02] + list(range(0x0600, 0x0606))
    + list(range(0x11A84, 0x11A8A)))
_NOT_SPACING = frozenset(
    [0x102B, 0x102C, 0x1038, 0x1083, 0x108F, 0x1A61, 0x1A63, 0x1A64, 0xAA7B, 0xAA7D, 0x11720,
     0x11721] + list(range(0x1062, 0x1065)) + list(range(0x1067, 0x106E))
    + list(range(0x1087, 0x108D)) + list(range(0x109A, 0x109D)))
# Extended_Pictographic (emoji-data.txt), as ranges
_PICTOGRAPHIC = (
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
    (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328),
    (0x2388, 0x2388), (0x23CF, 0x23CF), (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
    (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712), (0x2714, 0x2714),
    (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
    (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755),
    (0x2757, 0x2757), (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
    (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3297), (0x3299, 0x3299),
    (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A),
    (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F),
    (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF),
    (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _pictographic(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _PICTOGRAPHIC)


@functools.lru_cache(maxsize=65536)
def _gcb(ch: str) -> str:
    """The Grapheme_Cluster_Break class of ``ch``, from its general category
    and the lists above; "XP" for Extended_Pictographic."""
    cp = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if cp in _PREPEND:
        return "Prepend"
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me") or cp in _OTHER_GRAPHEME_EXTEND:
        return "Extend"
    if cat in ("Zl", "Zp", "Cc", "Cf", "Cs"):
        return "Control"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if (cat == "Mc" and cp not in _NOT_SPACING) or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return "XP" if _pictographic(cp) else "Other"


def graphemes(text: str) -> List[str]:
    """``text`` split into extended grapheme clusters (UAX #29 rules GB3-GB13)."""
    out: List[str] = []
    prev = None
    ri_run = 0  # regional indicators in a row before the boundary
    emoji_zwj = False  # XP Extend* ZWJ just before the boundary (GB11)
    after_xp = False  # XP Extend* so far
    for ch in text:
        cls = _gcb(ch)
        if prev is None:
            join = False
        elif prev == "CR" and cls == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or cls in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and cls in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cls in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cls == "T":
            join = True
        elif cls in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif emoji_zwj and cls == "XP":
            join = True
        elif prev == "RI" and cls == "RI":
            join = ri_run % 2 == 1
        else:
            join = False
        if join:
            out[-1] += ch
        else:
            out.append(ch)
        ri_run = ri_run + 1 if cls == "RI" else 0
        emoji_zwj = after_xp and cls == "ZWJ"
        after_xp = cls == "XP" or (after_xp and cls == "Extend")
        prev = cls
    return out


# ── T5 (a tokenizers-library tokenizer.json) ─────────────────────────────────


class Precompiled:
    """A SentencePiece ``precompiled_charsmap``: a little-endian uint32 byte
    size of the double array, the darts-clone double array (uint32 units),
    then the replacement strings, each ended by NUL."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = blob[4 + size:]

    def _prefix_values(self, key: bytes) -> List[int]:
        """darts-clone's common prefix search: the values of the keys that
        are prefixes of ``key``, shortest first."""
        units, out = self.units, []
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for byte in key:
            if byte == 0:
                break
            pos ^= byte
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != byte:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append(units[pos] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of the shortest key that prefixes ``chunk``, as the
        ``tokenizers`` crate takes it (SentencePiece would take the
        longest), or None."""
        hits = self._prefix_values(chunk.encode("utf-8"))
        if not hits:
            return None
        end = self.normalized.find(b"\0", hits[0])
        return self.normalized[hits[0]:end if end >= 0 else None].decode("utf-8")

    def __call__(self, text: str) -> str:
        """The ``tokenizers`` crate's ``Precompiled.normalize``: a grapheme
        cluster under 6 bytes that a key prefixes is replaced whole; else
        each of its characters that is a key is replaced."""
        out = []
        for cluster in graphemes(text):
            if len(cluster.encode("utf-8")) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in cluster:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
                        "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


def _normalizer(spec):
    """A ``tokenizer.json`` normalizer as a function str -> str."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]
        return lambda s: functools.reduce(lambda acc, f: f(acc), parts, s)
    if kind == "Precompiled":
        return Precompiled(base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "NFKC":
        return lambda s: unicodedata.normalize("NFKC", s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            i, j = 0, len(s)
            while left and i < j and s[i] in _WHITESPACE:
                i += 1
            while right and j > i and s[j - 1] in _WHITESPACE:
                j -= 1
            return s[i:j]
        return strip
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" in pattern:
            return lambda s: s.replace(pattern["String"], spec["content"])
        regex, content = re.compile(pattern["Regex"]), spec["content"]
        return lambda s: regex.sub(lambda _: content, s)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r} is not implemented")


def _pre_tokenizer(spec):
    """A ``tokenizer.json`` pre-tokenizer as a function str -> [str] (empty
    pieces dropped)."""
    if spec is None:
        return lambda s: [s]
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(s):
            pieces = [s]
            for f in parts:
                pieces = [q for p in pieces for q in f(p) if q]
            return pieces
        return seq
    if kind == "WhitespaceSplit":
        return lambda s: "".join(" " if c in _WHITESPACE else c for c in s).split(" ")
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # the older spelling
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r} is not implemented")
        split = spec.get("split", True)

        def metaspace(s):
            s = s.replace(" ", rep)
            if scheme == "always" and not s.startswith(rep):
                s = rep + s
            if not split:
                return [s]
            return [p for p in re.split(f"(?={re.escape(rep)})", s) if p]
        return metaspace
    raise NotImplementedError(f"tokenizer.json pre_tokenizer {kind!r} is not implemented")


class _Unigram:
    """The ``tokenizers`` crate's Unigram model (its optimised Viterbi)."""

    def __init__(self, spec):
        self.pieces = {piece: i for i, (piece, _) in enumerate(spec["vocab"])}
        self.scores = [float(s) for _, s in spec["vocab"]]
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.unk_score = min(self.scores) - 10.0
        self.max_len = max(len(p) for p in self.pieces)
        self.encode = functools.lru_cache(maxsize=65536)(self.encode)

    def encode(self, text: str) -> Tuple[str, ...]:
        """The best-scoring split of ``text`` into pieces: on a tie the
        earliest start wins; runs of unknown characters are fused."""
        n = len(text)
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)  # score, start, id
        best[0] = (0.0, 0, -1)
        for s in range(n):
            base = best[s][0]
            single = False
            for length in range(1, min(self.max_len, n - s) + 1):
                pid = self.pieces.get(text[s:s + length])
                if pid is None:
                    continue
                single = single or length == 1
                cand = self.scores[pid] + base
                if best[s + length] is None or cand > best[s + length][0]:
                    best[s + length] = (cand, s, pid)
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram has no unk_id for {text[s]!r}")
                cand = self.unk_score + base
                if best[s + 1] is None or cand > best[s + 1][0]:
                    best[s + 1] = (cand, s, self.unk_id)
        out: List[str] = []
        unk: List[str] = []
        end = n
        while end > 0:
            _, start, pid = best[end]
            if pid == self.unk_id:
                unk.append(text[start:end])
            else:
                if unk:
                    out.append("".join(reversed(unk)))
                    unk = []
                out.append(text[start:end])
            end = start
        if unk:
            out.append("".join(reversed(unk)))
        return tuple(reversed(out))

    def ids(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in self.encode(text):
            pid = self.pieces.get(piece)
            if pid is None and self.byte_fallback:
                fb = [self.pieces.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                if all(i is not None for i in fb):
                    out.extend(fb)
                    continue
            out.append(self.unk_id if pid is None else pid)
        return out


class T5Tokenizer:
    """The tokenizer of a T5 ``tokenizer_3/`` directory (``tokenizer.json``,
    and ``tokenizer_config.json`` / ``special_tokens_map.json`` for the
    special tokens, as ``T5TokenizerFast`` reads them); ``tokenizer(prompts,
    max_length)`` -> int64 ids (B, max_length)."""

    def __init__(self, directory: str):
        spec = _read_json(os.path.join(directory, "tokenizer.json"))
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise NotImplementedError(f"tokenizer.json model {model.get('type')!r} is not "
                                      "implemented")
        self.model = _Unigram(model)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        added: Dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            _AddedTokens.check_flags(tok, "T5Tokenizer")
            if tok.get("normalized"):
                raise NotImplementedError(f"T5Tokenizer: normalized added token "
                                          f"{tok['content']!r} is not implemented")
            added[tok["content"]] = int(tok["id"])
        config = _read_json(os.path.join(directory, "tokenizer_config.json"), {})
        if "added_tokens_decoder" not in config:
            config.update(_read_json(os.path.join(directory, "special_tokens_map.json"), {}))
        special = {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}
        special.update({k: _content(v) for k, v in config.items() if k in special})
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        if not any("<extra_id_" in t for t in extra):  # T5TokenizerFast's extra_ids
            extra += [f"<extra_id_{i}>" for i in range(int(config.get("extra_ids", 100)))]
        for tok in list(special.values()) + extra:
            if tok not in added:
                pid = self.model.pieces.get(tok)
                if pid is None:
                    top = max(added.values(), default=-1)
                    n = len(self.model.scores)
                    pid = top + 1 if top >= n else n
                added[tok] = pid
        self.added = _AddedTokens(added)
        self.pad_id = added[special["pad_token"]]
        self.prefix, self.suffix = self._template(spec.get("post_processor"))

    @staticmethod
    def _template(spec) -> Tuple[List[int], List[int]]:
        """(ids before, ids after) ``$A`` in a ``TemplateProcessing``'s
        single-sequence template."""
        if spec is None:
            return [], []
        if spec["type"] != "TemplateProcessing":
            raise NotImplementedError(f"tokenizer.json post_processor {spec['type']!r} is not "
                                      "implemented")
        before, after, seen = [], [], False
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise NotImplementedError(f"TemplateProcessing sequence {item!r}")
                seen = True
                continue
            ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
            (after if seen else before).extend(ids)
        return before, after

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the template's special tokens."""
        ids: List[int] = []
        for piece, added_id in self.added.split(text):
            if added_id is not None:
                ids.append(added_id)
                continue
            normalized = self.normalize(piece)
            if not normalized:
                continue
            for word in self.pre_tokenize(normalized):
                if word:
                    ids.extend(self.model.ids(word))
        return ids

    def __call__(self, prompts: Sequence[str], max_length: int) -> np.ndarray:
        """The template around at most ``max_length`` minus its special
        tokens ids, padded to ``max_length``."""
        keep = max_length - len(self.prefix) - len(self.suffix)
        rows = [self.prefix + self.encode(p)[:keep] + self.suffix for p in prompts]
        return _pad_rows(rows, max_length, self.pad_id)


# ── BERT WordPiece ───────────────────────────────────────────────────────────


def _bert_punctuation(ch: str) -> bool:
    """Non-letter / number ASCII, and Unicode category P*."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


class BertTokenizer:
    """The WordPiece tokenizer of a BERT tokenizer directory (``vocab.txt``,
    ``tokenizer_config.json``, ...; ImageReward's ``BERT_TOKENIZER_DIR``);
    ``tokenizer(prompts, max_length)`` -> (int64 ids, int64 attention mask),
    each (B, max_length): ``padding="max_length", truncation=True``."""

    _SPECIAL = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                "mask_token")

    def __init__(self, directory: str):
        self.vocab: Dict[str, int] = {}
        with open(os.path.join(directory, "vocab.txt"), encoding="utf-8") as f:
            for idx, line in enumerate(f.readlines()):
                self.vocab[line.rstrip("\n")] = idx
        config = _read_json(os.path.join(directory, "tokenizer_config.json"), {})
        for key, default in (("do_basic_tokenize", True), ("never_split", None)):
            if config.get(key, default) != default:
                raise NotImplementedError(f"BertTokenizer: {key}={config[key]!r} is not "
                                          "implemented")
        self.do_lower_case = bool(config.get("do_lower_case", True))
        self.strip_accents = config.get("strip_accents", None)
        self.chinese_chars = bool(config.get("tokenize_chinese_chars", True))
        special = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                   "cls_token": "[CLS]", "mask_token": "[MASK]"}
        added: Dict[str, int] = {}
        if "added_tokens_decoder" in config:
            decoded = [dict(tok, id=int(idx)) for idx, tok in config["added_tokens_decoder"].items()]
        else:  # transformers' legacy path
            if os.path.isfile(os.path.join(directory, "added_tokens.json")):
                raise NotImplementedError("BertTokenizer: a legacy added_tokens.json is not "
                                          "implemented")
            config.update(_read_json(os.path.join(directory, "special_tokens_map.json"), {}))
            decoded = _read_json(os.path.join(directory, "tokenizer.json"),
                                 {}).get("added_tokens", [])
        for tok in decoded:
            _AddedTokens.check_flags(tok, "BertTokenizer")
            if not tok.get("special"):
                raise NotImplementedError(f"BertTokenizer: the non-special added token "
                                          f"{tok['content']!r} is not implemented")
            added[tok["content"]] = int(tok["id"])
        special.update({k: _content(v) for k, v in config.items() if k in self._SPECIAL and v})
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        for tok in list(special.values()) + extra:
            if tok not in added:
                added[tok] = self.vocab.get(tok, len(set(self.vocab) | set(added)))
        self.added = _AddedTokens(added)
        # the lower-casing pass leaves the special tokens as they are
        protect = "|".join(re.escape(t) for t in list(special.values()) + extra)
        self._lower = re.compile(f"({protect})|(.+?)")
        self.unk_token = special["unk_token"]
        self.cls_id, self.sep_id, self.pad_id = (self._id(special[k])
                                                 for k in ("cls_token", "sep_token", "pad_token"))

    def _id(self, token: str) -> int:
        if token in self.added.ids:
            return self.added.ids[token]
        return self.vocab.get(token, self.vocab.get(self.unk_token))

    def basic(self, text: str) -> List[str]:
        """BERT's BasicTokenizer on a piece without added tokens."""
        out = []
        for ch in text:
            if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
                out.append(" ")
            elif ord(ch) == 0 or ch == "\ufffd" or unicodedata.category(ch)[0] == "C":
                continue
            elif self.chinese_chars and _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        words = []
        for word in unicodedata.normalize("NFC", "".join(out)).split():
            if self.do_lower_case:
                word = word.lower()
                if self.strip_accents is not False:
                    word = _strip_accents(word)
            elif self.strip_accents:
                word = _strip_accents(word)
            piece = ""
            for ch in word:
                if _bert_punctuation(ch):
                    words += [piece, ch] if piece else [ch]
                    piece = ""
                else:
                    piece += ch
            if piece:
                words.append(piece)
        return " ".join(words).split()

    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first WordPiece of one word."""
        if len(word) > 100:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            if end == start:
                return [self.unk_token]
            pieces.append(sub)
            start = end
        return pieces

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without ``[CLS]`` and ``[SEP]``."""
        if self.do_lower_case:
            text = self._lower.sub(lambda m: m.group(1) or m.group(2).lower(), text)
        ids: List[int] = []
        for piece, added_id in self.added.split(text):
            if added_id is not None:
                ids.append(added_id)
                continue
            for word in self.basic(piece):
                ids.extend(self._id(t) for t in self.wordpiece(word))
        return ids

    def __call__(self, prompts: Sequence[str], max_length: int = 35):
        rows = [[self.cls_id] + self.encode(p)[:max_length - 2] + [self.sep_id] for p in prompts]
        mask = np.zeros((len(rows), max_length), np.int64)
        for r, ids in enumerate(rows):
            mask[r, :len(ids)] = 1
        return _pad_rows(rows, max_length, self.pad_id), mask
