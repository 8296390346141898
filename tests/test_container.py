"""JFIF container goldens (reference test strategy: encoder.rs:407-578
asserts exact segment bytes)."""

import numpy as np

from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset
from dmmt_jpeg_encoder.container import (
    app0_jfif,
    dqt,
    sof0,
    sos,
)
from dmmt_jpeg_encoder.tables import ZIGZAG


def test_app0_golden():
    assert app0_jfif() == bytes(
        [
            0xFF, 0xE0, 0x00, 0x10,
            0x4A, 0x46, 0x49, 0x46, 0x00,
            0x01, 0x02,
            0x00,
            0x00, 0x48, 0x00, 0x48,
            0x00, 0x00,
        ]
    )


def test_sof0_golden_p420():
    seg = sof0(500, 300, 8, ChromaSubsamplingPreset.P420)
    assert seg == bytes(
        [
            0xFF, 0xC0, 0x00, 0x11,
            0x08,
            0x01, 0x2C,  # height 300
            0x01, 0xF4,  # width 500
            0x03,
            0x01, 0x22, 0x00,
            0x02, 0x11, 0x01,
            0x03, 0x11, 0x01,
        ]
    )


def test_sof0_sampling_factors():
    for preset, ratio in [
        (ChromaSubsamplingPreset.P444, 0x11),
        (ChromaSubsamplingPreset.P422, 0x21),
        (ChromaSubsamplingPreset.P420, 0x22),
    ]:
        seg = sof0(16, 16, 8, preset)
        assert seg[11] == ratio


def test_sos_golden():
    assert sos() == bytes(
        [
            0xFF, 0xDA, 0x00, 0x0C,
            0x03,
            0x01, 0x01,
            0x02, 0x23,
            0x03, 0x23,
            0x00, 0x3F, 0x00,
        ]
    )


def test_dqt_zigzag_order():
    table = np.arange(64, dtype=np.uint8)  # raster values = raster index
    seg = dqt(0, table)
    assert seg[:4] == bytes([0xFF, 0xDB, 0x00, 0x43])
    assert seg[4] == 0
    np.testing.assert_array_equal(
        np.frombuffer(seg[5:], dtype=np.uint8), ZIGZAG.astype(np.uint8)
    )
