"""BitWriter stress demo (reference: src/bin/bit_writer_example.rs):
writes a 10-bit pattern 1,000,000 times and self-checks the 5-byte-periodic
output."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import time

from dmmt_jpeg_encoder.bitstream.bitwriter import BitWriter


def main() -> int:
    pattern, bits, n = 0b1010110011, 10, 1_000_000
    w = BitWriter()
    t0 = time.perf_counter()
    for _ in range(n):
        w.write_bits(pattern, bits)
    w.flush()
    dt = time.perf_counter() - t0
    out = w.getvalue()
    expected_len = (n * bits + 7) // 8
    assert len(out) == expected_len, (len(out), expected_len)
    period = out[:5]
    for i in range(0, 5 * (len(out) // 5), 5):
        assert out[i : i + 5] == period, f"period broken at byte {i}"
    print(
        f"wrote {n} x {bits} bits in {dt*1e3:.1f} ms "
        f"({n*bits/dt/1e6:.1f} Mbit/s), output {len(out)} bytes, periodic OK"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
