"""The port's plain-Python tokenizers (``adv_grpo_torch.data.tokenizers``)
against ``transformers``, id for id, on vocabularies this file writes.

CLIP: ``transformers.CLIPTokenizer`` (the class the JAX package calls; here
without ``ftfy``, on its ``BasicTokenizer`` path) on byte-pair vocabularies
in the published layout (``chip_smoke.clip_vocab``: the 256 byte symbols,
their ``</w>`` forms, merges, the two specials), written as SD3's
``tokenizer/`` (pad ``<|endoftext|>``) and bigG's ``tokenizer_2/`` (pad
``!``, an added token), and on the letters-only vocabulary of
tests/test_torch_loaders.py (no config: unknown symbols map to
``<|endoftext|>``). T5: ``transformers.T5TokenizerFast`` on
``tokenizer.json`` files: SD3's layout (``chip_smoke.write_t5_tokenizer``: a
``Precompiled`` charsmap built here, the collapse of space runs,
``WhitespaceSplit`` + ``Metaspace``, the 100 extra ids), one with ``NFKC``,
``Strip``, a string ``Replace``, a non-splitting ``Metaspace`` and a
byte-fallback vocabulary, one with ``prepend_scheme`` never, and the
unigram file of tests/test_torch_loaders.py. Prompts: fixed edge cases and
``hypothesis`` draws (derandomized, bounded ``max_examples``) of accents
(composed and combining), CJK, Hangul, emoji (ZWJ sequences, modifiers,
flags), control characters, contractions, digits, runs of spaces, the
added tokens, the empty string and prompts over 75 words or ``t5_len``
pieces. Ids are compared whole, padding included, at 77 and at a short
length that truncates.
"""

import base64
import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from adv_grpo_torch.data import tokenizers as T
from chip_smoke import T5_CHARSMAP, clip_vocab, precompiled_charsmap, t5_pieces
from chip_smoke import write_clip_tokenizer, write_t5_tokenizer

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

WORDS = ("a photo of the flower, red zebra in the city at night; cat's painting 4k hdr 8 "
         "bit tokyo caf\u00e9 na\u00efve \u00fcber \u6771\u4eac \u30bf\u30ef\u30fc "
         "\uc11c\uc6b8").split()
FRAGMENTS = (
    list("abcxyzABCXYZ0123456789 .,!?'\"-:;()[]/&") + WORDS
    + ["'s", "'T", "'re", "'VE", "'m", "'ll", "'D", "\u017f", "\u0130", "\u00df", "\u01c5",
       "\u0345", "\u00e9", "e\u0301", "\u00f1", "\uff21", "\uff22\u0301", "\uff5a", "\ufb01",
       "\ufb00", "\ufb03", "\u4e2d\u6587", "\u65e5\u672c\u8a9e", "\ud55c\uad6d\uc5b4",
       "\u1100", "\u1161", "\u11a8", "\U0001f600", "\U0001f44d\U0001f3fd",
       "\U0001f469\u200d\U0001f52c", "\U0001f1ef\U0001f1f5", "\U0001f1ef", "\u2665", "\u00a9",
       "\t", "\n", "\r\n", "\x07", "\x00", "\x1f", "\x7f", "\u200b", "\u200d", "\ufeff",
       "\xa0", "\u3000", "\u2003", "\ufffd", "  ", "   ", "\u2581", "\u2581a", "<|endoftext|>",
       "<|startoftext|>", "<|EndOfText|>", "</s>", "<pad>", "<unk>", "<extra_id_0>",
       "<extra_id_99>", "<0x41>", "e", "\u0301", "x" * 30])
EDGE = ["", " ", "a flower", "A FLOWER!!", "zebra " * 90, "x" * 300, "<|endoftext|>!",
        "hello!world", "it's", "IT'S", "\u017ftart", "<|\u017ftartoftext|>", "caf\u00e9 cafe\u0301",
        "\u6771\u4eac\u30bf\u30ef\u30fc", "\U0001f469\u200d\U0001f52c\U0001f44d\U0001f3fd",
        "\uff21\uff42\uff43 \ufb01ne", "tab\there", "a\x07b", "   spaced   out   ",
        "e\u0301" * 10, "</s>x</s>", "<extra_id_5>flower", "\u2581\u2581a"]
TEXT = st.one_of(st.lists(st.sampled_from(FRAGMENTS), max_size=40).map("".join),
                 st.lists(st.sampled_from(WORDS), min_size=70, max_size=120).map(" ".join))
HYP = settings(max_examples=60, derandomize=True, deadline=None,
               suppress_health_check=[HealthCheck.function_scoped_fixture])


def _hf_ids(tok, prompts, max_length):
    return tok(list(prompts), padding="max_length", max_length=max_length, truncation=True,
               return_tensors="np").input_ids


def _same(ours, theirs, prompts, max_length):
    got, want = ours(list(prompts), max_length), _hf_ids(theirs, prompts, max_length)
    assert got.dtype == np.int64 and got.shape == want.shape == (len(prompts), max_length)
    bad = [(p, got[i].tolist(), want[i].tolist()) for i, p in enumerate(prompts)
           if not np.array_equal(got[i], want[i])]
    assert not bad, bad[:2]


# ── CLIP ─────────────────────────────────────────────────────────────────────


@pytest.fixture(scope="module", params=["tokenizer", "tokenizer_2", "letters"])
def clip_pair(request, tmp_path_factory):
    """(the port's, transformers') CLIP tokenizer of one directory."""
    d = str(tmp_path_factory.mktemp("clip") / request.param)
    if request.param == "letters":
        from tests.test_torch_loaders import _write_tokenizers

        _write_tokenizers(os.path.dirname(d))
        d = os.path.join(os.path.dirname(d), "tokenizer")
    else:
        words = [w for p in WORDS for w in T.clip_words(T.clip_clean(p))]
        vocab, merges = clip_vocab(words, 400)
        write_clip_tokenizer(d, vocab, merges,
                             "!" if request.param == "tokenizer_2" else "<|endoftext|>")
    return T.CLIPTokenizer(d), transformers.CLIPTokenizer.from_pretrained(d)


def test_clip_edge_cases_match_transformers(clip_pair):
    for max_length in (77, 8):
        _same(*clip_pair, EDGE, max_length)


@HYP
@given(prompts=st.lists(TEXT, min_size=1, max_size=4))
def test_clip_prompts_match_transformers(clip_pair, prompts):
    _same(*clip_pair, prompts, 77)


@HYP
@given(text=st.text(st.characters(exclude_categories=("Cs",)), max_size=30))
def test_clip_any_unicode_matches_transformers(clip_pair, text):
    """Any code point: CLIP's cleaning drops what this Python's Unicode does
    not assign, and the categories of the rest agree with ``regex``'s."""
    _same(*clip_pair, [text], 77)


def test_clip_pads_with_the_directorys_own_token(tmp_path):
    """``tokenizer/`` pads with ``<|endoftext|>``, bigG's ``tokenizer_2/``
    with ``!`` (id 0); both end the prompt with ``<|endoftext|>``."""
    vocab, merges = clip_vocab(["flower"], 10)
    ids = {}
    for sub, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        write_clip_tokenizer(str(tmp_path / sub), vocab, merges, pad)
        ids[sub] = T.CLIPTokenizer(str(tmp_path / sub))(["flower"], 6)[0].tolist()
    eot, sot = vocab["<|endoftext|>"], vocab["<|startoftext|>"]
    assert ids == {"tokenizer": [sot, vocab["flower</w>"], eot, eot, eot, eot],
                   "tokenizer_2": [sot, vocab["flower</w>"], eot, 0, 0, 0]}


# ── T5 ───────────────────────────────────────────────────────────────────────

T5_WORDS = sorted({w for p in WORDS for w in p.split()} | {"flower", "the", "er"})
# full-width letters, ligatures, controls (T5_CHARSMAP), and a key that is a
# prefix of another inside one grapheme cluster ("e" and "e" + U+0301): the
# tokenizers crate takes the shortest key there
TEST_CHARSMAP = {**T5_CHARSMAP, "e\u0301": "\u00e9", "e": "e", "\u200b": ""}


def _t5_variant(d, variant):
    """Write the ``variant`` tokenizer_3/ directory into ``d``."""
    pieces = t5_pieces(T5_WORDS, 600)
    if variant == "sd3":
        write_t5_tokenizer(d, pieces, TEST_CHARSMAP)
        return
    if variant == "loaders":
        from tests.test_torch_loaders import _write_tokenizers

        _write_tokenizers(os.path.dirname(d))
        return
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    if variant == "bytes":
        pieces = pieces[:-100] + [[f"<0x{b:02X}>", -20.0] for b in range(256)]
    tok = Tokenizer(models.Unigram([tuple(p) for p in pieces], unk_id=2,
                                   byte_fallback=variant == "bytes"))
    if variant == "bytes":
        tok.normalizer = normalizers.Sequence([
            normalizers.NFKC(), normalizers.Strip(), normalizers.Replace("  ", " ")])
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always",
                                                     split=False)
    else:  # "never": no prepended metaspace, a Precompiled normaliser alone
        tok.normalizer = normalizers.Precompiled(precompiled_charsmap(TEST_CHARSMAP))
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never")
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    os.makedirs(d)
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>",
                   "extra_ids": 0 if variant == "bytes" else 100}, f)


@pytest.fixture(scope="module", params=["sd3", "bytes", "never", "loaders"])
def t5_pair(request, tmp_path_factory):
    """(the port's, transformers') T5 tokenizer of one ``tokenizer_3/``."""
    d = str(tmp_path_factory.mktemp("t5") / "tokenizer_3")
    _t5_variant(d, request.param)
    return T.T5Tokenizer(d), transformers.T5TokenizerFast.from_pretrained(d)


def test_t5_edge_cases_match_transformers(t5_pair):
    for max_length in (77, 6):
        _same(*t5_pair, EDGE, max_length)


@HYP
@given(prompts=st.lists(TEXT, min_size=1, max_size=4))
def test_t5_prompts_match_transformers(t5_pair, prompts):
    _same(*t5_pair, prompts, 77)


@HYP
@given(text=st.lists(st.sampled_from(FRAGMENTS), max_size=30).map("".join))
def test_precompiled_matches_tokenizers(text):
    """The charsmap's normaliser against ``tokenizers.normalizers.Precompiled``
    on the same bytes (grapheme clusters, the shortest key, 6-byte
    clusters taken character by character)."""
    blob = precompiled_charsmap(TEST_CHARSMAP)
    assert T.Precompiled(blob)(text) == tokenizers.normalizers.Precompiled(blob).normalize_str(
        text)


@pytest.mark.parametrize("where, spec, name", [
    ("normalizer", {"type": "Lowercase"}, "Lowercase"),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False}, "ByteLevel"),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                       "split": True}, "first"),
    ("post_processor", {"type": "RobertaProcessing"}, "RobertaProcessing"),
    ("model", {"type": "BPE"}, "BPE")])
def test_t5_refuses_what_it_does_not_implement(tmp_path, where, spec, name):
    """A component type (or Metaspace scheme) the port does not implement
    raises with its name; none is skipped."""
    d = str(tmp_path / "tokenizer_3")
    write_t5_tokenizer(d, t5_pieces(T5_WORDS, 300), T5_CHARSMAP)
    path = os.path.join(d, "tokenizer.json")
    with open(path) as f:
        tj = json.load(f)
    tj[where] = spec
    with open(path, "w") as f:
        json.dump(tj, f)
    with pytest.raises(NotImplementedError, match=name):
        T.T5Tokenizer(d)


def test_the_charsmap_is_the_sentencepiece_layout():
    """The blob: a little-endian uint32 byte size of the double array, the
    array, then the NUL-ended replacements; each key found by the
    common-prefix search, shortest first."""
    blob = precompiled_charsmap({"ab": "X", "a": "Y", "ｂ": "b"})
    size = int.from_bytes(blob[:4], "little")
    assert size % 1024 == 0 and blob[4 + size:] == b"Y\0X\0b\0"
    pc = T.Precompiled(blob)
    assert [pc.normalized[v:].split(b"\0")[0] for v in pc._prefix_values(b"abc")] == [b"Y", b"X"]
    assert pc.transform("ｂ") == "b" and pc.transform("c") is None
    assert base64.b64decode(base64.b64encode(blob)) == blob
