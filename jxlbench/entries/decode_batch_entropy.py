"""api/tpu_codec.decode_batch_entropy: one batch a call, the AC entropy
decode on the card (ans_decode and its placement, then the render)."""


def start(devices, traffic):
    from libjxl_tpu_torch.api import tpu_codec

    return tpu_codec, devices[0]


def call(handle, streams):
    tpu_codec, dev = handle
    images, info = tpu_codec.decode_batch_entropy(streams, device=dev)
    return images, info["path"]
