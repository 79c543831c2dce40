"""Token sequences, fixed-size blocks, and chained block hashing.

Equivalent of the reference's tokens/blocks machinery (reference:
lib/llm/src/tokens.rs:30-201, lib/tokens/src/lib.rs:44-369): token sequences
are chunked into fixed-size blocks; each *complete* block gets

- a **local hash**: xxh3_64 over the block's token ids (+ optional salt), and
- a **sequence hash**: xxh3_64 chained over `[parent_sequence_hash,
  local_hash]`, uniquely identifying the block *in its prefix context*.

Sequence hashes are the currency of the KV plane: the engine's prefix cache
keys blocks by them, KV events carry them, and the radix indexer matches
routed requests against them. Only full blocks are hashed — a trailing
partial block has no identity yet.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Sequence

from dynamo_tpu_torch.llm._xxh3 import xxh3_64_intdigest

_U64X2 = struct.Struct("<QQ")


def hash_block_tokens(tokens: Sequence[int], salt: Optional[bytes] = None) -> int:
    """Local block hash: xxh3_64 of little-endian u32 token ids."""
    data = struct.pack(f"<{len(tokens)}I", *tokens)
    return xxh3_64_intdigest(salt + data if salt else data)


def chain_hash(parent_sequence_hash: int, local_hash: int) -> int:
    """Sequence hash: xxh3_64 over [parent_seq_hash, local_hash]
    (reference: indexer.rs:87-137 compute_block_hash chaining)."""
    return xxh3_64_intdigest(_U64X2.pack(parent_sequence_hash, local_hash))


ROOT_PARENT_HASH = 0  # parentless first block chains from 0


@dataclass(frozen=True)
class TokenBlock:
    tokens: tuple[int, ...]
    local_hash: int
    sequence_hash: int
    parent_sequence_hash: int


class TokenBlockSequence:
    """Token ids chunked into hashed fixed-size blocks with an unhashed
    partial tail (reference: tokens.rs TokenBlockSequence)."""

    def __init__(
        self,
        tokens: Sequence[int],
        block_size: int,
        salt: Optional[bytes] = None,
    ):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.salt = salt
        self.blocks: list[TokenBlock] = []
        self.partial: list[int] = []
        self._parent = ROOT_PARENT_HASH
        self.extend(tokens)

    def extend(self, tokens: Sequence[int]) -> list[TokenBlock]:
        """Append tokens; returns any newly completed blocks."""
        new_blocks: list[TokenBlock] = []
        self.partial.extend(tokens)
        while len(self.partial) >= self.block_size:
            chunk = tuple(self.partial[: self.block_size])
            del self.partial[: self.block_size]
            local = hash_block_tokens(chunk, self.salt)
            seq = chain_hash(self._parent, local)
            block = TokenBlock(chunk, local, seq, self._parent)
            self.blocks.append(block)
            new_blocks.append(block)
            self._parent = seq
        return new_blocks

    @classmethod
    def with_hashes(
        cls,
        tokens: Sequence[int],
        block_size: int,
        sequence_hashes: Sequence[int],
        local_hashes: Sequence[int],
    ) -> "TokenBlockSequence":
        """Rebuild a block sequence from PRECOMPUTED hashes — the far end
        of a hop that already hashed the prompt (the KV router hashes
        once to score workers and ships the chain in request metadata),
        so the serving engine skips the O(prompt) re-hash on its hot
        path. Both hash lists must cover exactly the full blocks of
        `tokens`; mismatched lengths raise (callers fall back to
        hashing). Later `extend` calls chain from the last provided
        sequence hash, exactly as if computed locally."""
        n_full = len(tokens) // block_size
        if len(sequence_hashes) != n_full or len(local_hashes) != n_full:
            raise ValueError(
                f"precomputed hash chain covers {len(sequence_hashes)} "
                f"blocks; prompt has {n_full}"
            )
        seq = cls.__new__(cls)
        seq.block_size = block_size
        seq.salt = None
        seq.blocks = []
        seq.partial = list(tokens[n_full * block_size:])
        parent = ROOT_PARENT_HASH
        for i in range(n_full):
            chunk = tuple(tokens[i * block_size:(i + 1) * block_size])
            seq.blocks.append(
                TokenBlock(chunk, local_hashes[i], sequence_hashes[i], parent)
            )
            parent = sequence_hashes[i]
        seq._parent = parent
        return seq

    @property
    def total_tokens(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial)

    def sequence_hashes(self) -> list[int]:
        return [b.sequence_hash for b in self.blocks]

    def all_tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial)
        return out


def compute_block_hashes(
    tokens: Sequence[int], block_size: int, salt: Optional[bytes] = None
) -> list[int]:
    """Sequence hashes of all complete blocks of `tokens` — what the KV
    router feeds to the indexer (reference: kv_router.rs:152-157)."""
    return TokenBlockSequence(tokens, block_size, salt).sequence_hashes()
