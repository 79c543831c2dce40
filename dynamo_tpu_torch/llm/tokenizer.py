"""Tokenizer read from a HuggingFace `tokenizer.json`, in plain Python.

The JAX package wraps the `tokenizers` runtime (`dynamo_tpu/llm/
tokenizer.py`); the card's machine does not promise that package, so the
port reads the file itself, with the same API (`from_file`, `encode`,
`decode`, `token_to_id`, `id_to_token`, `vocab_size`, `eos_token_ids`,
`decode_stream`) and the same ids and text, for the kinds the repo's
checkpoints use:

- a WordLevel model, with the `Lowercase` normalizer and the `Whitespace`
  pre-tokenizer (`\\w+|[^\\w\\s]+`), and no decoder (tokens joined by " ");
- a BPE model with the `ByteLevel` pre-tokenizer (`add_prefix_space`,
  `use_regex`) and decoder;
- added tokens, split out of the text before normalization (or after it,
  for `normalized` ones), leftmost-longest, honouring `lstrip`/`rstrip`.

Anything else in the file (Unigram, WordPiece, other normalizers,
pre-tokenizers, decoders or post-processors, truncation, padding, BPE
dropout or byte fallback, `single_word` added tokens, a `.gguf` file)
raises `NotImplementedError` naming it: nothing is tokenized silently in
another way than the `tokenizers` runtime would.

Python's `re` has no `\\p{L}`/`\\p{N}` and its `\\w`/`\\s` differ from the
Rust engines' (`\\w` takes `½` and `²` but not combining marks, `\\s`
takes U+001C-U+001F), so the character classes are built once from
`unicodedata` to the Unicode definitions those engines use.

`DecodeStream` is the JAX package's incremental detokenizer, copied.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import unicodedata
from typing import Optional, Sequence

# Unicode White_Space (what the Rust regex engines and `char::is_whitespace` use)
_WHITE_SPACE = (
    [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
     (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
     (0x3000, 0x3000)]
)
# Alphabetic characters outside the letter, mark and Nl categories
# (Other_Alphabetic symbols: circled and squared Latin letters)
_OTHER_ALPHABETIC_SO = [(0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                        (0x1F170, 0x1F189)]
# ZWNJ and ZWJ (Join_Control), part of the regex crate's \w
_JOIN_CONTROL = [(0x200C, 0x200D)]

_CLASSES: Optional[dict] = None


def _cls(ranges) -> str:
    return "".join(
        "\\U%08x" % a if a == b else "\\U%08x-\\U%08x" % (a, b) for a, b in ranges
    )


def _classes() -> dict:
    """Character-class bodies (for `[...]`): letters (\\p{L}), numbers
    (\\p{N}), word characters (the regex crate's Unicode \\w) and white
    space (\\s). Built once from the runs of equal general category
    (~0.4 s)."""
    global _CLASSES
    if _CLASSES is None:
        runs, cp = [], 0
        cats = map(unicodedata.category, map(chr, range(0x110000)))
        for cat, grp in itertools.groupby(cats):
            n = sum(1 for _ in grp)
            runs.append((cat, cp, cp + n - 1))
            cp += n

        def ranges(pred) -> list:
            out: list = []
            for cat, a, b in runs:
                if pred(cat):
                    if out and out[-1][1] == a - 1:
                        out[-1] = (out[-1][0], b)
                    else:
                        out.append((a, b))
            return out

        word = {"Mn", "Mc", "Me", "Nd", "Nl", "Pc"}
        _CLASSES = {
            "L": _cls(ranges(lambda c: c[0] == "L")),
            "N": _cls(ranges(lambda c: c[0] == "N")),
            "W": _cls(ranges(lambda c: c[0] == "L" or c in word)
                      + _OTHER_ALPHABETIC_SO + _JOIN_CONTROL),
            "S": _cls(_WHITE_SPACE),
        }
    return _CLASSES


def _is_space(ch: str) -> bool:
    cp = ord(ch)
    return any(a <= cp <= b for a, b in _WHITE_SPACE)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map (the ByteLevel alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _refuse(what: str, value) -> None:
    raise NotImplementedError(
        f"tokenizer.json {what} {value!r} is not supported by dynamo_tpu_torch's "
        "tokenizer (WordLevel and ByteLevel BPE only; see ROADMAP.md)"
    )


# ---------------------------------------------------------------- models


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> list[int]:
        tid = self.vocab.get(word)
        if tid is not None:
            return [tid]
        if self.unk is None or self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocabulary and there is "
                             "no unk token")
        return [self.vocab[self.unk]]


class _BPE:
    def __init__(self, spec: dict):
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix",
                    "byte_fallback"):
            if spec.get(key):
                _refuse(f"BPE {key}", spec[key])
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.ranks: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, merge in enumerate(spec.get("merges") or []):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            try:
                pair = (self.vocab[a], self.vocab[b])
                new = self.vocab[a + b]
            except KeyError as exc:
                raise ValueError(f"BPE merge {a!r} {b!r}: {exc} not in the vocabulary") from None
            self.ranks.setdefault(pair, (rank, new))
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        unk = self.vocab.get(self.unk) if self.unk is not None else None
        syms: list[int] = []
        last_unk = False
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is None:
                if unk is None:
                    continue  # no unk token: the character is dropped
                if self.fuse_unk and last_unk:
                    continue
                tid, last_unk = unk, True
            else:
                last_unk = False
            syms.append(tid)
        # merge the lowest-ranked adjacent pair, leftmost first, until none
        while len(syms) > 1:
            best = None
            for i in range(len(syms) - 1):
                r = self.ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best is None or r[0] < best[0]):
                    best = (r[0], i, r[1])
            if best is None:
                break
            _, i, new = best
            syms[i:i + 2] = [new]
        if len(self._cache) < 100_000:
            self._cache[word] = syms
        return syms


# ---------------------------------------------------------- the pipeline


class _Added:
    """The added vocabulary: tokens split out of the text before the model
    sees it (special ones are dropped by `decode(skip_special_tokens)`)."""

    def __init__(self, entries: list[dict], normalize):
        self.by_id: dict[int, str] = {}
        self.by_token: dict[str, int] = {}
        self.special: set[str] = set()
        self.strip: dict[str, tuple[bool, bool]] = {}
        raw, norm = [], []
        for e in entries:
            if e.get("single_word"):
                _refuse("single_word added token", e["content"])
            tok, tid = e["content"], int(e["id"])
            self.by_id[tid] = tok
            self.by_token[tok] = tid
            if e.get("special"):
                self.special.add(tok)
            self.strip[tok] = (bool(e.get("lstrip")), bool(e.get("rstrip")))
            (norm if e.get("normalized", not e.get("special")) else raw).append(tok)
        self.raw = self._pattern({t: t for t in raw})
        # a normalized token matches the normalized text, in its normalized form
        self.norm_of = {normalize(t): t for t in norm}
        self.norm = self._pattern(self.norm_of)

    @staticmethod
    def _pattern(forms: dict[str, str]):
        keys = sorted((k for k in forms if k), key=len, reverse=True)
        # longest first: at each position the first alternative that matches
        # is the longest, so the scan is leftmost-longest
        return re.compile("|".join(map(re.escape, keys))) if keys else None

    def split(self, text: str, pattern, forms=None):
        """Yield (piece, None) for text between matches and (None, id) for
        each added token, honouring lstrip/rstrip (the stripped white space
        goes with the token)."""
        if pattern is None:
            yield text, None
            return
        spans = []
        for m in pattern.finditer(text):
            tok = forms[m.group()] if forms else m.group()
            start, stop = m.start(), m.end()
            prev = spans[-1][1] if spans else 0
            lstrip, rstrip = self.strip[tok]
            if lstrip:
                while start > prev and _is_space(text[start - 1]):
                    start -= 1
            if rstrip:
                while stop < len(text) and _is_space(text[stop]):
                    stop += 1
            if start < prev:
                continue  # inside the previous token's stripped span
            spans.append((start, stop, self.by_token[tok]))
        pos = 0
        for start, stop, tid in spans:
            if start > pos:
                yield text[pos:start], None
            yield None, tid
            pos = stop
        if pos < len(text):
            yield text[pos:], None


class HuggingFaceTokenizer:
    """Reads `tokenizer.json` (see the module docstring for the kinds)."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        self.config = config or {}
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                _refuse(key, spec[key])
        model = spec.get("model") or {}
        kind = model.get("type") or ("BPE" if "merges" in model else "WordLevel")
        if kind == "WordLevel":
            self._model = _WordLevel(model)
        elif kind == "BPE":
            self._model = _BPE(model)
        else:
            _refuse("model", kind)

        norm = spec.get("normalizer")
        if norm is None:
            self._normalize = lambda s: s
        elif norm.get("type") == "Lowercase":
            self._normalize = str.lower
        else:
            _refuse("normalizer", norm.get("type"))

        pre = spec.get("pre_tokenizer")
        self._prefix_space = False
        if pre is None:
            self._split = None
        elif pre.get("type") == "Whitespace":
            c = _classes()
            self._split = re.compile(f"[{c['W']}]+|[^{c['W']}{c['S']}]+").findall
        elif pre.get("type") == "ByteLevel":
            self._prefix_space = bool(pre.get("add_prefix_space", True))
            if pre.get("use_regex", True):
                c = _classes()
                L, N, S = c["L"], c["N"], c["S"]
                self._split = re.compile(
                    rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
                    rf"|[{S}]+(?![^{S}])|[{S}]+"
                ).findall
            else:
                self._split = None
        else:
            _refuse("pre_tokenizer", pre.get("type"))
        self._byte_level = bool(pre and pre.get("type") == "ByteLevel")

        dec = spec.get("decoder")
        if dec is None:
            self._decoder = " ".join
        elif dec.get("type") == "ByteLevel":
            self._decoder = _byte_level_decode
        else:
            _refuse("decoder", dec.get("type"))

        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":
            # ByteLevel post-processing only trims offsets; ids are unchanged
            _refuse("post_processor", post.get("type"))

        self._added = _Added(spec.get("added_tokens") or [], self._normalize)
        self._id_to_token = {i: t for t, i in self._model.vocab.items()}

    # ------------------------------------------------------------ loading

    @classmethod
    def from_file(cls, path: str) -> "HuggingFaceTokenizer":
        """`path` is a tokenizer.json file or a model dir holding one (and
        maybe a tokenizer_config.json). A `.gguf` file is not supported."""
        config: dict = {}
        if os.path.isdir(path):
            cfg_path = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    config = json.load(f)
            tok_json = os.path.join(path, "tokenizer.json")
            if not os.path.exists(tok_json):
                if any(f.endswith(".gguf") for f in os.listdir(path)):
                    _refuse("source", "gguf")
                raise FileNotFoundError(f"{path}: no tokenizer.json or *.gguf")
            path = tok_json
        elif path.endswith(".gguf"):
            _refuse("source", "gguf")
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), config)

    # ------------------------------------------------------------- encode

    def _words(self, piece: str) -> list[str]:
        if self._byte_level and self._prefix_space and not piece.startswith(" "):
            piece = " " + piece
        words = self._split(piece) if self._split is not None else [piece]
        if self._byte_level:
            words = ["".join(_BYTE_CHAR[b] for b in w.encode("utf-8")) for w in words]
        return words

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        # no post-processor adds tokens, so add_special_tokens changes nothing
        ids: list[int] = []
        added = self._added
        for raw, tid in added.split(text, added.raw):
            if tid is not None:
                ids.append(tid)
                continue
            norm = self._normalize(raw)
            for piece, ntid in added.split(norm, added.norm, added.norm_of):
                if ntid is not None:
                    ids.append(ntid)
                    continue
                for word in self._words(piece):
                    if word:
                        ids.extend(self._model.tokenize(word))
        return ids

    # ------------------------------------------------------------- decode

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None:
                continue  # outside the vocabulary: dropped, as the runtime does
            if skip_special_tokens and tok in self._added.special:
                continue
            tokens.append(tok)
        return self._decoder(tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.by_token.get(token)
        return tid if tid is not None else self._model.vocab.get(token)

    def id_to_token(self, token_id: int) -> Optional[str]:
        tok = self._added.by_id.get(token_id)
        return tok if tok is not None else self._id_to_token.get(token_id)

    @property
    def vocab_size(self) -> int:
        return len(set(self._model.vocab) | set(self._added.by_token))

    def eos_token_ids(self) -> list[int]:
        """Collect eos ids from tokenizer_config (eos_token) if present."""
        ids = []
        eos = self.config.get("eos_token")
        if isinstance(eos, dict):
            eos = eos.get("content")
        if isinstance(eos, str):
            tid = self.token_to_id(eos)
            if tid is not None:
                ids.append(tid)
        return ids

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)


def _byte_level_decode(tokens: list[str]) -> str:
    """ByteLevel decoding: a token made only of alphabet characters becomes
    its bytes, any other token its UTF-8; the whole is decoded with U+FFFD
    for each maximal invalid subsequence (Rust's `from_utf8_lossy`)."""
    out = bytearray()
    for tok in tokens:
        try:
            out.extend(_CHAR_BYTE[c] for c in tok)
        except KeyError:
            out.extend(tok.encode("utf-8"))
    return out.decode("utf-8", errors="replace")


class DecodeStream:
    """Incremental detokenizer (reference: tokenizers.rs DecodeStream)."""

    def __init__(self, tokenizer: HuggingFaceTokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self._ids: list[int] = []
        self._prefix_offset = 0  # start of the comparison window
        self._read_offset = 0  # ids before this are already emitted

    def step(self, token_id: int) -> Optional[str]:
        """Feed one token id; returns newly-decodable text or None (e.g. the
        id is part of an incomplete multi-token unicode character)."""
        self._ids.append(token_id)
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip,
        )
        new_text = self._tok.decode(
            self._ids[self._prefix_offset :], skip_special_tokens=self._skip
        )
        if new_text.endswith("�"):
            # incomplete utf-8 sequence; wait for more ids
            return None
        if len(new_text) <= len(prefix_text):
            # nothing new materialized (e.g. pure special token)
            self._read_offset = len(self._ids)
            return None
        text = new_text[len(prefix_text) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return text
