"""jpegli: the sibling JPEG codec (lib/jpegli analog).

A psychovisually tuned standard-JPEG encoder and float decoder:
distance-scaled quant tables, adaptive dead-zone quantization, optimal
Huffman coding on encode; batched float IDCT on decode.  Output is
plain baseline JPEG readable by any libjpeg.
"""

from .decode import decode_jpegli
from .encode import encode_jpegli, encode_jpegli_quality
from .quant import quality_to_distance

__all__ = [
    "decode_jpegli",
    "encode_jpegli",
    "encode_jpegli_quality",
    "quality_to_distance",
]
