"""The port's JPEG layers (libjxl_tpu_torch/{jpeg, jpegli}, with the JPEG
scan coder and decoder in libjxl_tpu_torch/native) against the JAX
package's, which they were copied from. Host code on both sides, so the
tolerance is none: equal bytes, equal arrays, and reconstruction gives back
the original JPEG byte for byte.

The JPEG inputs are made by the port's own jpegli encoder from seeded
numpy photos, so no test needs PIL.
"""

import pathlib

import numpy as np
import pytest

from libjxl_tpu import jpeg as jjpeg
from libjxl_tpu import jpegli as jjpegli
from libjxl_tpu.jpeg import recompress as jrec
from libjxl_tpu_torch import jpeg as tjpeg
from libjxl_tpu_torch import jpegli as tjpegli
from libjxl_tpu_torch import native_ext
from libjxl_tpu_torch.jpeg import recompress as trec

CONFORMANCE = pathlib.Path(__file__).resolve().parent / "data" / \
    "conformance"


def photo(h, w, seed, gray=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(xx / 13.0) * np.cos(yy / 11.0)
    img = np.stack([base + rng.normal(0, 6, (h, w)) for _ in range(3)],
                   axis=-1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[:, :, 0] if gray else img


# (distance, subsampling, progressive level, gray); odd sizes so that the
# 4:2:0 MCUs are ragged at both edges
JPEG_CASES = {
    "d1-444": (1.0, "444", 0, False),
    "d1-420": (1.0, "420", 0, False),
    "d3-444": (3.0, "444", 0, False),
    "d3-420": (3.0, "420", 0, False),
    "d1-420-progressive": (1.0, "420", 2, False),
    "d2-gray": (2.0, "444", 0, True),
}


def _jpeg(case, seed=0, shape=(120, 152)):
    distance, ss, level, gray = JPEG_CASES[case]
    return tjpegli.encode_jpegli(photo(*shape, seed, gray), distance=distance,
                                 subsampling=ss, progressive=level)


def test_the_native_jpeg_scan_code_is_built():
    lib = native_ext.get_lib()
    assert lib is not None
    for sym in ("jpegli_encode_scan", "jpeg_decode_baseline_scan",
                "lz77_find_matches", "lz77_optimal"):
        assert hasattr(lib, sym), sym


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_encode_jpegli_bytes_equal(case):
    distance, ss, level, gray = JPEG_CASES[case]
    img = photo(120, 152, 1, gray)
    got = tjpegli.encode_jpegli(img, distance=distance, subsampling=ss,
                                progressive=level)
    assert got == jjpegli.encode_jpegli(img, distance=distance,
                                        subsampling=ss, progressive=level)
    assert got[:2] == b"\xff\xd8"


def test_encode_jpegli_quality_bytes_equal():
    img = photo(64, 80, 2)
    assert tjpegli.encode_jpegli_quality(img, quality=85) \
        == jjpegli.encode_jpegli_quality(img, quality=85)


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_recompress_vardct_bytes_equal_and_reconstruct_exactly(case):
    """The VarDCT transcode of a grayscale JPEG does not give back the
    original bytes in the JAX package either (its reconstruction rewrites
    the header's tables): there the port is held to the reference's own
    reconstruction."""
    jpg = _jpeg(case, seed=3)
    got = trec.recompress_jpeg_vardct(jpg)
    assert got == jrec.recompress_jpeg_vardct(jpg)
    back = trec.reconstruct_jpeg(got)
    assert back == jrec.reconstruct_jpeg(got)
    if not JPEG_CASES[case][3]:
        assert back == jpg


@pytest.mark.parametrize("case", ["d1-444", "d1-420", "d2-gray"])
def test_recompress_token_model_bytes_equal_and_reconstruct_exactly(case):
    jpg = _jpeg(case, seed=4, shape=(72, 96))
    got = trec.recompress_jpeg(jpg)
    assert got == jrec.recompress_jpeg(jpg)
    assert trec.reconstruct_jpeg(got) == jpg


def test_reconstruct_the_corpus_pair():
    """tests/data/conformance/jpeg_recon.jxl gives back jpeg_recon.jpg."""
    jxl = (CONFORMANCE / "jpeg_recon.jxl").read_bytes()
    jpg = (CONFORMANCE / "jpeg_recon.jpg").read_bytes()
    assert trec.reconstruct_jpeg(jxl) == jpg
    assert trec.recompress_jpeg_vardct(jpg) \
        == jrec.recompress_jpeg_vardct(jpg)


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_parse_and_pixels_equal(case):
    jpg = _jpeg(case, seed=5)
    tj, jj = tjpeg.parse_jpeg(jpg), jjpeg.parse_jpeg(jpg)
    assert (tj.width, tj.height) == (jj.width, jj.height)
    assert len(tj.components) == len(jj.components)
    for a, b in zip(tj.components, jj.components):
        assert (a.h_samp, a.v_samp) == (b.h_samp, b.v_samp)
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
    if not JPEG_CASES[case][2]:  # the writer emits sequential scans
        assert tjpeg.write_jpeg(tj) == jpg
    np.testing.assert_array_equal(tjpeg.jpeg_to_pixels(tj),
                                  jjpeg.jpeg_to_pixels(jj))


@pytest.mark.parametrize("bitdepth", [8, 16])
@pytest.mark.parametrize("case", ["d1-420", "d1-420-progressive", "d2-gray"])
def test_decode_jpegli_equal(case, bitdepth):
    jpg = _jpeg(case, seed=6)
    got = tjpegli.decode_jpegli(jpg, bitdepth=bitdepth)
    np.testing.assert_array_equal(got, jjpegli.decode_jpegli(
        jpg, bitdepth=bitdepth))
