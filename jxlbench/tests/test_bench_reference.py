"""The frozen reference (jxlbench/refcodec) against the port's host codec
on small seeded streams: the same bytes from the encoder, the same image
from the decoder, byte for byte."""

import numpy as np
import pytest

from jxlbench.makers import vardct_photo as photo


@pytest.mark.parametrize("effort,size", [(3, 256), (3, 512), (5, 256),
                                         (5, 320)])
def test_frozen_codec_equals_the_ports_host_codec(effort, size):
    from libjxl_tpu_torch.api import codestream

    cfg = {"height": size, "width": size, "distance": 1.0,
           "effort": effort}
    img = photo.image_for(cfg, 2 ** 31 + 11, effort)
    stream = photo.encode(cfg, img)
    port = codestream.encode_lossy(img, distance=1.0, effort=effort,
                                   device=None)
    assert stream == port
    ref, _ = photo.reference(stream)
    host = codestream.decode(stream, device=None)[0][:, :, :3]
    assert ref.dtype == np.uint8 and ref.shape == (size, size, 3)
    assert np.array_equal(ref, host)


def test_seeds_give_the_same_sizes_other_noise():
    cfg = {"height": 64, "width": 96}
    a = photo.image_for(cfg, 1, 0)
    assert np.array_equal(a, photo.image_for(cfg, 1, 0))
    for other in (photo.image_for(cfg, 2, 0), photo.image_for(cfg, 1, 1),
                  photo.image_for(cfg, 2 ** 40 + 1, 0)):
        assert other.shape == a.shape and not np.array_equal(other, a)
