"""Host-side Huffman table construction.

Tables are built on host from device-computed symbol histograms (the
histograms are the only thing that crosses the device->host boundary for
table construction, and they are psum-reduced across shards so every shard
agrees on one global table — the device equivalent of the reference's
whole-image tables, reference: src/image/writer/jpeg/transformer.rs:201-214).
"""

from .package_merge import package_merge_lengths
from .spec import SymbolCodeLength, code_lengths_from_histogram, symbol_frequencies
from .canonical import CodeWord, canonical_codes, dht_payload
from .decoder import HuffmanDecoder

__all__ = [
    "package_merge_lengths",
    "SymbolCodeLength",
    "code_lengths_from_histogram",
    "symbol_frequencies",
    "CodeWord",
    "canonical_codes",
    "dht_payload",
    "HuffmanDecoder",
]
