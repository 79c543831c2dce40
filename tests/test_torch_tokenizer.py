"""The port's plain-Python tokenizer (dynamo_tpu_torch/llm/tokenizer.py)
against the JAX package's `HuggingFaceTokenizer` over the `tokenizers`
runtime, on the tokenizer kinds the repo holds: the vendored checkpoint's
WordLevel (Lowercase normalizer, Whitespace pre-tokenizer, no decoder) and
the fixture's ByteLevel BPE (tests/fixtures.py's, built by
tests/torch_fixtures.py; no unk token), each also
with added tokens that are lstrip/rstrip and normalized. Encode ids,
`decode` with skip_special_tokens True and False (ids past the vocabulary
included), the lookups, `eos_token_ids` and `DecodeStream`'s increments
over whole streams must be equal, over hypothesis strings from the corpus,
unicode, digits, punctuation and special tokens; the BPE also with
`add_prefix_space` (and the ByteLevel post-processor), without the split
regex and with `ignore_merges`, and with an unk token fused. Kinds the
port does not read raise NotImplementedError."""

from __future__ import annotations

import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.tokenizer import HuggingFaceTokenizer as JaxTokenizer
from dynamo_tpu_torch.llm.tokenizer import HuggingFaceTokenizer

from .fixtures import _CORPUS
from .torch_fixtures import bpe_model_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")
KINDS = ["wordlevel", "bpe", "wordlevel_added", "bpe_added", "bpe_prefix_space",
         "bpe_no_regex", "bpe_unk"]

# variants of the fixture BPE for the ByteLevel and BPE options it leaves
# at one value: (path, value) pairs set on its spec
BPE_VARIANTS = {
    "bpe_prefix_space": [("pre_tokenizer.add_prefix_space", True),
                         ("post_processor", {"type": "ByteLevel", "add_prefix_space": True,
                                             "trim_offsets": True, "use_regex": True})],
    "bpe_no_regex": [("pre_tokenizer.use_regex", False), ("model.ignore_merges", True)],
    "bpe_unk": [("model.unk_token", "<|eos|>"), ("model.fuse_unk", True)],
}
SETTINGS = settings(max_examples=150, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])

# characters where Python's re classes differ from the Rust engines', and
# ByteLevel's regex alternatives
TRICKY = ["½", "²", "é", "é", "☃", "ǅ", "ⓐ", "Ⅻ", "٣", "_", "\x1c", " ", "　",
          "'s", "'ll", "'t", "  ", "\n\n", "\t", " the ", "123", "$%!", "日本", "🙂"]


def _added(spec: dict, base: int) -> dict:
    """The spec with added tokens that exercise lstrip, rstrip and
    normalized matching (one of them special)."""
    spec = json.loads(json.dumps(spec))
    spec["added_tokens"] += [
        {"id": base, "content": "[SEP]", "single_word": False, "lstrip": True,
         "rstrip": True, "normalized": False, "special": True},
        {"id": base + 1, "content": "Capital", "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": True, "special": False},
        {"id": base + 2, "content": "<é x>", "single_word": False, "lstrip": False,
         "rstrip": True, "normalized": False, "special": False},
    ]
    return spec


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    return bpe_model_dir(str(tmp_path_factory.mktemp("bpe")))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, bpe_dir):
    out = {}
    for kind, path in (("wordlevel", CKPT), ("bpe", bpe_dir)):
        out[kind] = (JaxTokenizer.from_file(path), HuggingFaceTokenizer.from_file(path))
        with open(os.path.join(path, "tokenizer.json")) as f:
            spec = json.load(f)
        d = tmp_path_factory.mktemp(kind + "_added")
        with open(d / "tokenizer.json", "w") as f:
            json.dump(_added(spec, len(spec["model"]["vocab"])), f)
        with open(d / "tokenizer_config.json", "w") as f:
            json.dump({"eos_token": {"content": "[SEP]"}}, f)
        out[kind + "_added"] = (JaxTokenizer.from_file(str(d)),
                                HuggingFaceTokenizer.from_file(str(d)))
    with open(os.path.join(bpe_dir, "tokenizer.json")) as f:
        bpe = json.load(f)
    for kind, changes in BPE_VARIANTS.items():
        spec = json.loads(json.dumps(bpe))
        for path, value in changes:
            node, *keys = path.split(".")
            if keys:
                spec[node][keys[0]] = value
            else:
                spec[node] = value
        d = tmp_path_factory.mktemp(kind)
        with open(d / "tokenizer.json", "w") as f:
            json.dump(spec, f)
        out[kind] = (JaxTokenizer.from_file(str(d)), HuggingFaceTokenizer.from_file(str(d)))
    return out


def _specials(tok) -> list[str]:
    return [tok.id_to_token(i) for i in range(8)] + ["[SEP]", "Capital", "<é x>", "CAPITAL"]


texts = st.lists(
    st.one_of(
        st.sampled_from(_CORPUS),
        st.sampled_from(" ".join(_CORPUS).split() + ["the capital of france is paris ."]),
        st.text(max_size=8),
        st.text(alphabet="0123456789 .,;:!?'\"-()[]{}<>|/\\@#$%^&*_+=~`", max_size=8),
        st.sampled_from(TRICKY),
        st.sampled_from(["<s>", "</s>", "<unk>", "<|eot|>", "<|user|>", "<|bos|>",
                         "[SEP]", " [SEP] ", "Capital", "capital", "CAPITAL", "<é x>  "]),
    ),
    max_size=10,
).map("".join)


@pytest.mark.parametrize("kind", KINDS)
def test_encode_ids_equal(pairs, kind):
    ref, mine = pairs[kind]

    @SETTINGS
    @given(texts)
    def check(text):
        assert mine.encode(text) == ref.encode(text), text
        assert mine.encode(text, add_special_tokens=False) == ref.encode(
            text, add_special_tokens=False)

    check()


@pytest.mark.parametrize("kind", KINDS)
def test_decode_equal(pairs, kind):
    ref, mine = pairs[kind]
    n = ref.vocab_size

    @SETTINGS
    @given(st.lists(st.one_of(st.integers(0, n - 1), st.integers(0, n + 50)), max_size=24),
           texts)
    def check(ids, text):
        ids = ref.encode(text) + ids
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), (ids, skip)

    check()


def _stream(tok, ids, skip):
    ds = tok.decode_stream(skip_special_tokens=skip)
    return [ds.step(t) for t in ids]


@pytest.mark.parametrize("kind", KINDS)
def test_decode_stream_increments_equal(pairs, kind):
    ref, mine = pairs[kind]
    n = ref.vocab_size

    @SETTINGS
    @given(texts, st.lists(st.integers(0, n - 1), max_size=16))
    def check(text, extra):
        ids = ref.encode(text) + extra
        for skip in (True, False):
            assert _stream(mine, ids, skip) == _stream(ref, ids, skip), (ids, skip)

    check()


@pytest.mark.parametrize("kind", KINDS)
def test_vocab_lookups_and_eos(pairs, kind):
    ref, mine = pairs[kind]
    assert mine.vocab_size == ref.vocab_size
    for i in range(ref.vocab_size + 3):
        tok = ref.id_to_token(i)
        assert mine.id_to_token(i) == tok, i
        if tok is not None:
            assert mine.token_to_id(tok) == ref.token_to_id(tok), tok
    for tok in _specials(ref) + ["nope", "Ġthe", "the"]:
        if tok is not None:
            assert mine.token_to_id(tok) == ref.token_to_id(tok), tok
    assert mine.eos_token_ids() == ref.eos_token_ids()


def test_known_edges(pairs):
    """What the runtime does with no decoder, with no unk token and with
    incomplete UTF-8, held as values."""
    ref, mine = pairs["wordlevel"]
    assert mine.decode([5, 100000, 6]) == ref.decode([5, 100000, 6]) == "the of"
    ref, mine = pairs["bpe"]
    ids = mine.encode("123 ½ ² é")
    assert ids == ref.encode("123 ½ ² é")
    assert mine.decode(ids) == ref.decode(ids) != "123 ½ ² é"  # no unk: characters vanish
    e_bytes = mine.encode("é")  # two byte tokens
    assert len(e_bytes) == 2
    assert mine.decode(e_bytes[:1]) == ref.decode(e_bytes[:1]) == "�"
    assert _stream(mine, e_bytes, True) == _stream(ref, e_bytes, True) == [None, "é"]


def _spec_with(**kw) -> dict:
    with open(os.path.join(CKPT, "tokenizer.json")) as f:
        spec = json.load(f)
    for path, value in kw.items():
        node = spec
        *head, last = path.split("__")
        for key in head:
            node = node[key]
        node[last] = value
    return spec


@pytest.mark.parametrize("change, named", [
    (dict(model__type="Unigram"), "Unigram"),
    (dict(model__type="WordPiece"), "WordPiece"),
    (dict(normalizer={"type": "NFC"}), "NFC"),
    (dict(pre_tokenizer={"type": "Metaspace"}), "Metaspace"),
    (dict(decoder={"type": "WordPiece"}), "WordPiece"),
    (dict(post_processor={"type": "TemplateProcessing"}), "TemplateProcessing"),
    (dict(truncation={"max_length": 8}), "truncation"),
])
def test_unsupported_kinds_raise(change, named):
    with pytest.raises(NotImplementedError, match=named):
        HuggingFaceTokenizer(_spec_with(**change))


def test_unsupported_sources_raise(tmp_path, bpe_dir):
    with pytest.raises(NotImplementedError, match="gguf"):
        HuggingFaceTokenizer.from_file(str(tmp_path / "model.gguf"))
    (tmp_path / "model.gguf").write_bytes(b"GGUF")
    with pytest.raises(NotImplementedError, match="gguf"):
        HuggingFaceTokenizer.from_file(str(tmp_path))
    spec = _spec_with()
    spec["added_tokens"].append({"id": 99, "content": "x", "single_word": True,
                                 "special": False})
    with pytest.raises(NotImplementedError, match="single_word"):
        HuggingFaceTokenizer(spec)
    with open(os.path.join(bpe_dir, "tokenizer.json")) as f:
        bpe = json.load(f)
    bpe["model"]["byte_fallback"] = True
    with pytest.raises(NotImplementedError, match="byte_fallback"):
        HuggingFaceTokenizer(bpe)
