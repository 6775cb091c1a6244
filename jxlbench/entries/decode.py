"""api/codestream.decode: one stream a call, the single-image decode (the
host parse and entropy decode with num_threads threads, then the frame's
render on the card, make_device_render); the path it took from
decode_info."""


def start(devices, traffic):
    from libjxl_tpu_torch.api import codestream

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
