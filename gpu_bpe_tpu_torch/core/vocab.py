"""BPE vocabulary registry.

Token registry with byte-sequence entries and human-readable display strings.
Capability parity with the reference's vocabulary module
(src/bpe/vocab.js:92-144): 256 single-byte base tokens at ids
0-255, merged tokens appended starting at id 256, display strings with
``▁`` for space / ``\\n`` for newline / ``<0xHH>`` for non-printable or invalid
bytes, and the tab-separated text export.
"""

from __future__ import annotations


def _format_hex_byte(b: int) -> str:
    return f"<0x{b:02X}>"


def _format_ascii_byte(b: int) -> str:
    if b == 0x20:
        return "▁"  # ▁
    if b == 0x0A:
        return "\\n"
    if 0x21 <= b <= 0x7E:
        return chr(b)
    return _format_hex_byte(b)


def _try_decode_utf8(data: bytes, offset: int, length: int) -> str | None:
    if offset + length > len(data):
        return None
    for j in range(1, length):
        if (data[offset + j] & 0xC0) != 0x80:
            return None
    try:
        return data[offset : offset + length].decode("utf-8", errors="strict")
    except UnicodeDecodeError:
        return None


def bytes_to_display_string(data: bytes | list[int]) -> str:
    """Human-readable rendering of a token's byte sequence.

    Mirrors the display rules of the reference vocab module
    (src/bpe/vocab.js:18-88): UTF-8 decode where valid, space shown as ▁,
    newline as \\n, everything non-printable as <0xHH>.
    """
    data = bytes(data)
    parts: list[str] = []
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if b < 0x80:
            parts.append(_format_ascii_byte(b))
            i += 1
            continue
        if b < 0xC0:  # orphan continuation byte
            parts.append(_format_hex_byte(b))
            i += 1
            continue
        seq_len = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
        decoded = _try_decode_utf8(data, i, seq_len)
        if decoded is not None:
            parts.append(decoded)
            i += seq_len
        else:
            parts.append(_format_hex_byte(b))
            i += 1
    return "".join(parts)


class Vocab:
    """Growing token registry: 256 byte tokens + learned merges.

    Parity: src/bpe/vocab.js:92-144.
    """

    __slots__ = ("entries", "strings", "next_token_id")

    def __init__(self) -> None:
        self.entries: list[bytes] = [bytes([i]) for i in range(256)]
        self.strings: list[str] = [bytes_to_display_string(e) for e in self.entries]
        self.next_token_id: int = 256

    @property
    def size(self) -> int:
        return len(self.entries)

    def add_merge(self, symbol_a: int, symbol_b: int) -> int:
        """Register the merged token ``entries[a] + entries[b]``; returns its id."""
        new_token_id = self.next_token_id
        self.next_token_id += 1
        merged = self.entries[symbol_a] + self.entries[symbol_b]
        self.entries.append(merged)
        self.strings.append(bytes_to_display_string(merged))
        return new_token_id

    def export_text(self) -> str:
        """Tab-separated text dump: ``id\\tdisplay\\t[b0,b1,...]``.

        Parity: src/bpe/vocab.js:130-143.
        """
        lines = [
            "# GPU BPE Vocabulary (TPU Trainer)",
            f"# Total tokens: {len(self.entries)}",
            "",
        ]
        for i, entry in enumerate(self.entries):
            byte_list = ",".join(str(b) for b in entry)
            lines.append(f"{i}\t{self.strings[i]}\t[{byte_list}]")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_entries(cls, entries: list[bytes | list[int]]) -> "Vocab":
        """Rebuild a Vocab from raw byte-sequence entries (model import)."""
        v = cls.__new__(cls)
        v.entries = [bytes(e) for e in entries]
        v.strings = [bytes_to_display_string(e) for e in v.entries]
        v.next_token_id = len(v.entries)
        return v
