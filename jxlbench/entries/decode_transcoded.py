"""api/codestream.decode of a losslessly recompressed JPEG, one stream a
call: the host parse, the native subsampled AC decode with num_threads
threads, then the "dec_sub" render on the card; the path it took from
decode_info. start raises where the port lacks its native subsampled AC
decode (native_ext.decode_ac_image_sub_native and the C library's
decode_ac_image_sub), so that such a program ends at set-up instead of
decoding every symbol in Python, about a minute a 12 MP frame."""


def start(devices, traffic):
    from libjxl_tpu_torch import native_ext
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.native_ext import (  # noqa: F401
        decode_ac_image_sub_native)

    lib = native_ext.get_lib()
    if lib is None or not hasattr(lib, "decode_ac_image_sub"):
        raise RuntimeError("the port's host library has no "
                           "decode_ac_image_sub")
    return codestream, devices[0], dict(traffic["args"])


def call(handle, streams):
    codestream, dev, args = handle
    images, path = [], None
    for s in streams:
        info = {}
        img, _ = codestream.decode(s, device=dev, decode_info=info, **args)
        images.append(img)
        path = info.get("path")
    return images, path
